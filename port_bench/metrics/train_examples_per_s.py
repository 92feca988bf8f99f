"""Training examples of the whole graphed calls the window ran, over the
window's seconds (host clock, the card waited for after each call); on
several cards the global batch's examples."""


def read(run):
    return run.rate if run.window_s > 0 else None
