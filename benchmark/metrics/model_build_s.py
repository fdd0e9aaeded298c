"""model_build_s (s a call): the seconds in ``grid.make_model`` (the
host numpy build of the model and its copy to the card), summed over a
call's builds."""


def read(run):
    return run.mean("make_model")
