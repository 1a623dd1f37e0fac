"""Process start to the window's opening (weights, documents, engine,
warm-up and the ramp of arrivals)."""


def read(run):
    return run.setup_s
