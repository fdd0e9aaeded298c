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
