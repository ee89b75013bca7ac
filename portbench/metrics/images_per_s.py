"""Images whose logits came back inside the window, over its seconds."""


def read(art):
    return art.images_in_window / art.seconds
