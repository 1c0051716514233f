"""Tools of the port, run as modules
(``python -m wayverb_tpu_torch.tools.<name>``): the counterparts of the
reference's ``tools/`` scripts (validation, the ray tools, the long run,
the fits, the HRTF bake, the pictures and the GUI) and of its
``tools/bench/`` measurements, and the port's own kernel timers."""
