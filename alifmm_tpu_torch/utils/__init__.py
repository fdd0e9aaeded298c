"""Host-side helpers: model sanity checks, progress bars, saving and
loading fields and rays, timing and device traces."""
