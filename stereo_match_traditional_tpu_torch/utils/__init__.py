"""Host-side helpers: NumPy <-> tensor and config carry-across, synthetic
pairs, trace scopes, kernel timing."""
