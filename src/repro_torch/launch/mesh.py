"""Production meshes of the port (``repro.launch.mesh``).

Functions, not module constants: importing this module reads no device
state.  The meshes are the single-controller meshes of
``parallel/mesh.py`` over the logical devices (``parallel.mesh.devices``,
set by ``logical_devices(n)``); a mesh larger than the logical device
count raises, as the reference's ``make_mesh`` does on fewer devices.
"""

from __future__ import annotations

import numpy as np

from repro_torch.parallel import mesh as pm


def make_production_mesh(*, multi_pod: bool = False,
                         devices_list=None) -> pm.Mesh:
    """16x16 single-pod (256 devices) or 2x16x16 multi-pod (512), over
    ``devices_list`` (default the logical devices)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return pm.make_mesh(shape, axes, devices_list)


def make_mesh_from_devices(devices, *, model_parallel: int = 16) -> pm.Mesh:
    """Elastic path: the largest (data, model) mesh over a live device
    list (the survivors after failures): the model axis halved until it
    divides the count, data = n // model."""
    n = len(devices)
    model = model_parallel
    while n % model and model > 1:
        model //= 2
    data = n // model
    arr = np.empty(data * model, dtype=object)
    for i, dev in enumerate(devices[:data * model]):
        arr[i] = dev
    return pm.Mesh(arr.reshape(data, model), ("data", "model"))
