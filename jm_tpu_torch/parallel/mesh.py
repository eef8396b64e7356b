"""Device meshes (jm_tpu/parallel/mesh.py).

jm_tpu's mesh is a single controller: one process and an array of
devices with the axes dp (closed GOPs; the DPB resets at an IDR,
lencod mbuffer.c:1727) and sp (MB rows within a picture). Here a mesh
is that array as nested lists of torch.devices: row d holds the sp
devices of GOP row d. A device may appear more than once; the work given
to it then runs one part after another.
"""

from __future__ import annotations

import torch


def default_devices(device_type: str = "cuda") -> list:
    """The devices of one type, as jax.devices() gives the default
    backend's: every CUDA card torch sees, or the one CPU."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if device_type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"device type {device_type!r} is neither cuda nor cpu")


def take_devices(n: int, devices=None, device_type: str = "cuda") -> list:
    """The first n of devices (default_devices(device_type) when None) as
    torch.devices; fewer raise ValueError."""
    devices = list(devices) if devices is not None \
        else default_devices(device_type)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return [torch.device(d) for d in devices[:n]]


def make_mesh(n_dp: int, n_sp: int, devices=None,
              device_type: str = "cuda") -> list:
    """The (n_dp, n_sp) mesh: n_dp rows of n_sp torch.devices."""
    flat = take_devices(n_dp * n_sp, devices, device_type)
    return [flat[r * n_sp:(r + 1) * n_sp] for r in range(n_dp)]
