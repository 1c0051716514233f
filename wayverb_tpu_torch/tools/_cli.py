"""What the validation tools share: the device ``--cpu`` chooses."""

import torch


def device_for(cpu: bool) -> torch.device:
    """The CPU with ``--cpu``, else the card; raises when there is none."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")
    return torch.device("cuda")
