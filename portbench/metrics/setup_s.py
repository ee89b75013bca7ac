"""Process start to the first timed request."""


def read(art):
    return art.setup_s
