"""Stereo ops on torch tensors: cost volumes, WTA, post-processing."""
