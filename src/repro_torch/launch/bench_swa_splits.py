"""Device time of the ``swa_decode`` CUDA kernel against its split count S.

    python -m repro_torch.launch.bench_swa_splits [--splits 4,8,16,32]
        [--shape 8,12,2,4096,128] [--seed 0]

At one (B, H, Kv, W, Dh) shape in bf16 with every slot valid (the serve
shape of qwen2-1.5b by default) it launches the kernel's C entry point with
each S in turn and prints one JSON line: the card and its power limit, the
S that the wrapper picks (``swa_attention._num_splits``) and, per S, the
device time per launch (``repro_torch.device.device_ms``, the inputs
rotated over four copies so that each launch finds them outside the L2
cache) and the largest difference from the plain version.  It needs the
card.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.device import card_name_and_power_limit, device_ms
from repro_torch.kernels import _build, ref
from repro_torch.kernels.swa_attention import (_MAX_REP, _num_splits,
                                               _sm_count, _zeroed_counters)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--splits", default="4,8,16,32")
    ap.add_argument("--shape", default="8,12,2,4096,128")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    b, h, kv, w, dh = (int(x) for x in args.shape.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("bench_swa_splits times the CUDA kernel: it needs "
                         "a card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    sets = [tuple(torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
                  for s in ((b, h, dh), (b, kv, w, dh), (b, kv, w, dh)))
            for _ in range(4)]
    length = torch.full((b,), w, dtype=torch.int32, device=dev)
    groups = b * kv * -(-(h // kv) // _MAX_REP)
    lib = _build.lib()

    def run(q, k, v, splits: int) -> torch.Tensor:
        out = torch.empty_like(q)
        part = torch.empty(b * h * splits * (dh + 2), dtype=torch.float32,
                           device=dev)
        counters = _zeroed_counters("swa_decode", dev, groups)
        _build.check(lib.lgc_swa_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
            out.data_ptr(), part.data_ptr(), counters.data_ptr(), b, h, kv,
            w, dh, 1, splits, torch.cuda.current_stream().cuda_stream),
            "swa_decode")
        return out

    want = ref.swa_decode_ref(*sets[0], length).float()
    rows = {}
    for splits in (int(x) for x in args.splits.split(",")):
        err = float((run(*sets[0], splits).float() - want).abs().max())
        turn = iter(range(1 << 30))
        rows[splits] = {"device_ms": device_ms(
            lambda s=splits: run(*sets[next(turn) % len(sets)], s)),
            "max_abs_err": err}
    result = {"card": card_name_and_power_limit(),
              "shape": [b, h, kv, w, dh], "dtype": "bfloat16",
              "groups": groups,
              "wrapper_splits": _num_splits(groups, w, _sm_count(dev)),
              "by_splits": rows}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
