"""Single-transfer host→device movement for parameter pytrees.

Every host→device transfer pays a fixed latency, so moving a ~200-leaf
parameter bundle leaf-by-leaf pays it ~200 times.  ``device_put_tree`` groups
leaves by dtype, concatenates each group into ONE flat buffer on host,
transfers one buffer per dtype (2-3 transfers total), and slices + reshapes
them back into the tree in one jitted program per geometry (persistently
cached).  No bitcasts: each dtype keeps its own buffer.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


def device_put_tree(tree: Any, device=None) -> Any:
    leaves, treedef = jax.tree.flatten(tree)
    if not leaves:
        return tree
    if device is None:
        device = jax.devices()[0]

    host = []
    for l in leaves:
        arr = np.ascontiguousarray(np.asarray(l))
        # jax canonicalizes 64-bit dtypes to 32-bit (x64 disabled)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        elif arr.dtype == np.int64:
            arr = arr.astype(np.int32)
        host.append(arr)

    groups = defaultdict(list)  # dtype -> [leaf index]
    for i, arr in enumerate(host):
        groups[arr.dtype.str].append(i)

    # per-dtype flat buffers + (leaf -> (group, offset, size, shape)) specs
    buffers = {}
    specs = [None] * len(host)
    for dt, idxs in groups.items():
        offset = 0
        parts = []
        for i in idxs:
            arr = host[i]
            specs[i] = (dt, offset, arr.size, arr.shape)
            parts.append(arr.ravel())
            offset += arr.size
        buffers[dt] = np.concatenate(parts) if len(parts) > 1 else parts[0]

    dtype_order = tuple(sorted(buffers))
    specs_t = tuple(specs)

    @jax.jit
    def unpack(*bufs):
        by_dt = dict(zip(dtype_order, bufs))
        out = []
        for dt, off, size, shape in specs_t:
            seg = jax.lax.slice(by_dt[dt], (off,), (off + size,))
            out.append(seg.reshape(shape))
        return out

    dev_bufs = [jax.device_put(buffers[dt], device) for dt in dtype_order]
    return jax.tree.unflatten(treedef, unpack(*dev_bufs))
