"""Scripts of the port: kernel sweeps for a machine with a CUDA device
(``gj_sweep``, ``pb_sweep``) and the multi-process launcher
(``multiproc_smoke``, on the CPU or the card)."""
