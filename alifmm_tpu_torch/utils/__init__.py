"""Host-side helpers of the facade: model sanity checks and progress bars."""
