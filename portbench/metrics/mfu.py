"""The whole step's share of the card's peak, on the host clock: the
images whose logits came back inside the window, times the
configuration's FLOPs an image (the benchmark's own count), over the
window's seconds, over the peak at the configuration's precision, in
percent.  A traced run's window runs before the profiler first starts, so
the tracer does not slow what this reads."""


def read(art):
    if art.peak_flops is None:
        return None
    return (100.0 * art.images_in_window / art.seconds
            * art.flops_per_image / art.peak_flops)
