"""Causal or full GQA attention forward (twin of
:mod:`repro.kernels.flash_attention`)."""
