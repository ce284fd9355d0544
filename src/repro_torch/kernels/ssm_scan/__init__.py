"""Mamba-1 selective scan (twin of :mod:`repro.kernels.ssm_scan`)."""
