"""model_builds (builds a call): how many times a call builds the model
(``grid.make_model``)."""


def read(run):
    return run.mean("builds", span=False)
