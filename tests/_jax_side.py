"""A second process for a port test module's JAX references.

The port's CPU tests of the sharded solves spend their time in two places
that do not depend on each other: the port's plain twins, and JAX tracing
and compiling the reference.  ``references(jobs)`` starts one process,
runs ``jobs`` (module-level functions of the test module, each computing
one JAX reference from the module's seeded inputs and returning numpy) in
it one after another, in the order given, and yields their futures: the
test process runs the port meanwhile and takes each reference when its
test needs it.  The jobs share the process's compiled programs, as they
would in the test process.

The process is spawned, so it imports JAX afresh; it inherits
tests/conftest.py's environment (the CPU platform, eight virtual devices,
x64) and takes the same compile cache."""

import concurrent.futures
import contextlib
import multiprocessing

import jax


def _init(cache_dir, min_secs):
    import jax as jax_

    jax_.config.update("jax_platforms", "cpu")
    jax_.config.update("jax_enable_x64", True)
    if cache_dir:
        jax_.config.update("jax_compilation_cache_dir", cache_dir)
    jax_.config.update("jax_persistent_cache_min_compile_time_secs", min_secs)


@contextlib.contextmanager
def references(jobs):
    """{name: future} of ``jobs`` ({name: function}) run in a second
    process; leaving the context waits for every job."""
    cfg = jax.config
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"),
        initializer=_init,
        initargs=(cfg.jax_compilation_cache_dir,
                  cfg.jax_persistent_cache_min_compile_time_secs))
    with pool:
        yield {name: pool.submit(fn) for name, fn in jobs.items()}


def port_seed_sign(mp):
    """Under the monkeypatch ``mp``, the JAX package's first patch stage
    seeds with the port's effective angle (``alifmm_tpu_torch.solver.
    _SEED_SIGN``: veln - angle, on both paths).  The JAX package seeds its
    fine path with veln + angle, as the reference's travel_finer_grid does,
    and the port departs from it there; a job that holds the port's fine
    fields to JAX's calls this first."""
    from alifmm_tpu import solver as jsolver
    from alifmm_tpu_torch import solver as tsolver

    stage_first = jsolver._stage_first

    def first(model, scx, scz, half, factor, seed_side, seed_sign, cfg,
              **kw):
        return stage_first(model, scx, scz, half, factor, seed_side,
                           tsolver._SEED_SIGN, cfg, **kw)

    mp.setattr(jsolver, "_stage_first", first)
