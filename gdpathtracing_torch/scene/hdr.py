"""Radiance RGBE (.hdr) decoder — for HDRI environment maps
(``SceneBuilder.set_environment``) — port of gdpathtracing_tpu/scene/hdr.py
(host-side NumPy, the same code; the port keeps its own copy so that it
never imports the JAX package)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def load_hdr(path: str | Path) -> np.ndarray:
    """→ (H, W, 3) float32 linear radiance."""
    data = Path(path).read_bytes()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance .hdr file")
    # header ends at blank line; then resolution line
    pos = data.index(b"\n\n") + 2
    nl = data.index(b"\n", pos)
    res = data[pos:nl].decode().split()
    if res[0] != "-Y" or res[2] != "+X":
        raise ValueError(f"unsupported orientation {res}")
    h, w = int(res[1]), int(res[3])
    pos = nl + 1

    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)
    for y in range(h):
        if pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2 \
                and (data[pos + 2] << 8 | data[pos + 3]) == w:
            # new-style RLE scanline
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = buf[pos]
                    pos += 1
                    if count > 128:  # run
                        rgbe[y, x:x + count - 128, c] = buf[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x:x + count, c] = buf[pos:pos + count]
                        pos += count
                        x += count
        else:  # flat scanline
            row = buf[pos:pos + w * 4].reshape(w, 4)
            rgbe[y] = row
            pos += w * 4

    exp = rgbe[:, :, 3].astype(np.int32)
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 136), 0.0)
    return (rgbe[:, :, :3].astype(np.float32) + 0.5) * scale[:, :, None] \
        .astype(np.float32)
