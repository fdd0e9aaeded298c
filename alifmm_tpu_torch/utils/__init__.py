"""Host-side helpers: model sanity checks, progress bars, saving and
loading fields and rays, named profiler ranges and device traces."""
