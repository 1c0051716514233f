"""Measurement tools of the port: the counterparts of the reference's
``tools/bench/`` scripts, run as modules
(``python -m wayverb_tpu_torch.tools.probe_resident``)."""
