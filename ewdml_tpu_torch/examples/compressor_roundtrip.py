"""Compressor round trip (``examples/compressor_roundtrip.py`` of the JAX
package): the reference notebook ``QSGD and topk Sparsification.ipynb``
(cells 0-4) as a script. A known tensor goes through QSGD (quantum 64, the
notebook's variant), Top-k and Top-k -> QSGD; the script prints each
payload, its decompressed values and its exact wire bytes (the notebook's
``sys.getsizeof(tensor.storage())`` probe measured Python objects, not the
wire).

    python -m ewdml_tpu_torch.examples.compressor_roundtrip
    python -m ewdml_tpu_torch.examples.compressor_roundtrip --platform cpu

Runs on the card unless ``--platform cpu`` is given; the draws are the JAX
script's (``utils/prng``), so the levels and indices are its own.
"""

from __future__ import annotations

import argparse
import sys

#: The notebook's test vector (cell 0): floats of a large dynamic range.
VECTOR = [655665860.0, 3.0, -1.5e7, 0.25, 42.0, -7.0, 1e-3, 0.0]
COMPRESSORS = [("qsgd", dict(quantum_num=64)),
               ("topk", dict(topk_ratio=0.5)),
               ("topk_qsgd", dict(quantum_num=64, topk_ratio=0.5))]


def roundtrips(device) -> list:
    """``[(name, kwargs, input, payload, decompressed)]`` of the vector on
    ``device`` under key 0, the JAX script's."""
    import torch

    from ewdml_tpu_torch.ops import make_compressor
    from ewdml_tpu_torch.utils import prng

    g = torch.tensor(VECTOR, dtype=torch.float32, device=device)
    # ewdml: allow[prng] -- the JAX script's fixed key, so that the printed
    # levels and indices are the reference's own
    key = prng.key(0)
    out = []
    for name, kw in COMPRESSORS:
        comp = make_compressor(name, **kw)
        payload = comp.compress(key, g)
        out.append((name, kw, g, payload, comp.decompress(payload)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--platform", default=None)
    ns = p.parse_args(argv)

    from ewdml_tpu_torch.core.world import resolve_device
    from ewdml_tpu_torch.ops import make_compressor

    device = resolve_device(ns.platform)
    for name, kw, g, payload, dec in roundtrips(device):
        print(f"\n== {name} {kw}")
        print("input      :", [float(v) for v in g.cpu()])
        if hasattr(payload, "levels"):
            print("levels     :", payload.levels.tolist(),
                  f"(dtype {str(payload.levels.dtype).replace('torch.', '')})")
            print("norm       :", float(payload.norm))
        if hasattr(payload, "indices"):
            print("indices    :", payload.indices.tolist())
        print("decompressed:", [round(float(v), 3) for v in dec])
        print("wire bytes :", make_compressor(name, **kw).wire_bytes(
            (len(VECTOR),)), "(dense f32:", len(VECTOR) * 4, ")", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
