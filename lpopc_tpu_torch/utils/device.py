"""Device rule of the port: ``None`` means the GPU, and nothing falls back."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device=None`` -> ``cuda``. A CUDA device that is not present raises
    (the port never carries on on the CPU unasked); ``"cpu"`` is honoured
    only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lpopc_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain PyTorch versions"
        )
    return dev


def device_mesh(device, ranks, names):
    """A ``torch.distributed`` ``DeviceMesh`` of the ranks ``ranks`` (a
    nested list: one level per name in ``names``) on ``device``'s type
    (resolved by :func:`resolve_device`). One rank drives one device, so a
    mesh of n ranks is n processes; every rank of the default process group
    builds it together."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(resolve_device(device).type, torch.as_tensor(ranks, dtype=torch.int64),
                      mesh_dim_names=tuple(names))
