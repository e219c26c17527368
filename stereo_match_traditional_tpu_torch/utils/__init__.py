"""Host-side helpers: NumPy <-> tensor and config carry-across, synthetic
pairs, image I/O, stage checkpoints, the PGM/PPM pair loader, trace scopes
and stage timers."""
