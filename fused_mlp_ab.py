#!/usr/bin/env python3
"""The port's fused-MLP forward against another build of it, on one NVIDIA
GPU, timed in turns within one process.

    python3 fused_mlp_ab.py --old OTHER/dpivae_tpu_torch/csrc/fused_mlp.cu \\
        [--out FILE]
    python3 fused_mlp_ab.py --ablate [--out FILE]

``--old`` is the kernel source of another tree (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists). Both sources are built with the port's nvcc flags
(``ops.fused_mlp.build_library``) and launched through the same ctypes
call, so only the kernels differ. At each shape of ``SHAPES`` the two
outputs are held against the plain PyTorch version (rtol/atol 1e-5), then
timed by CUDA events (``chip_smoke._device_ms``) in the order old, new,
new, old, beside the plain version, the cuBLASLt pair
(``torch._addmm_activation`` then ``torch.addmm``; for member-batched
shapes the batched plain version, ``torch.baddbmm`` twice, is that pair)
and the least-time bound of ``chip_smoke._bound_ms``. Prints one line a
shape and, with ``--out``, writes the readings as JSON. Exits 1 if the new
build disagrees with plain anywhere.

``--ablate`` times the port's staged (wgmma) path against copies of its
source with one part taken out (``ABLATIONS``: the three products of a k
step, layer 1, the output's staging and bulk copies, the staging of W1),
at the staged path's shapes of ``SHAPES``, in turns (the source, each
copy, then in reverse): what the time falls by without a part is what
that part costs where nothing else hides it. The copies compute wrong
outputs by design; their errors are printed, not checked. Needs CUDA;
imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# (members, rows, d_in, d_hidden, d_out): the forward's shapes on the main
# paths (chip_smoke.py's SHAPES and its member-batched sweep shapes).
SHAPES = {
    "serving": (1, 262_144, 4, 128, 32),
    "validation": (1, 32_768, 4, 128, 32),
    "training": (1, 1_024, 4, 128, 32),
    "serving8": (1, 262_144, 8, 128, 64),
    "validation8": (1, 32_768, 8, 128, 64),
    "figures": (1, 2_000, 4, 128, 32),
    "figures8": (1, 2_000, 8, 128, 64),
    "hidden256": (1, 65_536, 4, 256, 32),
    "batched_training": (66, 1_024, 8, 128, 64),
    "batched_validation": (66, 32_768, 8, 128, 64),
}


# name -> (start, end, replacement): the copy of the source replaces the text
# from start up to end (end kept) with replacement. Each marker must occur
# once in the source.
ABLATIONS = {
    "no_products": (
        "    wgmma_tf32(small, al, bh, chain);", "    wgmma_commit();\n  };",
        "    small[0] += __uint_as_float(al[0] ^ al[1] ^ al[2] ^ al[3] ^\n"
        "                                (uint32_t)bh);\n"
        "    big[0] += __uint_as_float(ah[0] ^ ah[1] ^ ah[2] ^ ah[3] ^\n"
        "                              (uint32_t)bl);\n"),
    "no_layer1": (
        "    float h[4];\n    h[0] = h[1] = b0s[ka];", "  };\n  float small[kRegs]",
        "    const float hv = b0s[ka] + xa[0] + xb[0];\n"
        "#pragma unroll\n"
        "    for (int i = 0; i < 4; ++i) ah[i] = al[i] = __float_as_uint(hv) + i;\n"),
    "no_epilogue": (
        "    float* st = my_stage",
        "#pragma unroll\n    for (int j = 0; j < DINB; ++j) xa[j] = na[j]",
        "    float sum = 0.f;\n"
        "#pragma unroll\n"
        "    for (int i = 0; i < kRegs; ++i) sum += acc[i];\n"
        "    if (sum == 12345.f) out[tile] = sum;\n"),
    "no_w1_staging": (
        "  for (int i0 = threadIdx.x; i0 < N * kp;",
        "  for (int i = threadIdx.x; i < kp * DINB;", ""),
}
ABLATION_SHAPES = ("serving", "validation", "serving8", "batched_validation")


def _ablated(source, out_dir):
    """Write a copy of ``source`` per ABLATIONS entry into out_dir; returns
    {name: path}."""
    text = open(source).read()
    paths = {}
    for name, (start, end, repl) in ABLATIONS.items():
        if text.count(start) != 1 or text.count(end) != 1:
            raise ValueError(f"ablation {name}: its markers are not unique "
                             f"in {source}")
        a, b = text.index(start), text.index(end)
        path = os.path.join(out_dir, f"fused_mlp_{name}.cu")
        with open(path, "w") as fh:
            fh.write(text[:a] + repl + text[b:])
        paths[name] = path
    return paths


def _launcher(lib):
    """fused_mlp_fwd of ``lib`` on (x, w0, b0, w1, b1) -> out, single or
    stacked over a leading member axis, as ops.fused_mlp launches it."""
    def run(x, w0, b0, w1, b1, out):
        batched = w0.dim() == 3
        tensors = (x, w0, b0, w1, b1, out)
        strides = [t[0].numel() if batched else 0 for t in tensors]
        err = lib.fused_mlp_fwd(
            *(t.data_ptr() for t in tensors), x.shape[-2], x.shape[-1],
            w0.shape[-2], w1.shape[-2], w0.shape[0] if batched else 1,
            *strides, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(lib.fused_mlp_error_string(err).decode())
        return out
    return run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", default=None,
                        help="the other tree's csrc/fused_mlp.cu")
    parser.add_argument("--ablate", action="store_true",
                        help="time the source against its ABLATIONS")
    parser.add_argument("--out", default=None, help="JSON readings here")
    args = parser.parse_args(argv)
    if (args.old is None) == (not args.ablate):
        parser.error("give --old or --ablate")
    if not torch.cuda.is_available():
        print("fused_mlp_ab: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from dpivae_tpu_torch.ops import fused_mlp as ops

    card = cs._card()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    new = str(ops.SOURCE)
    if args.ablate:
        out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "ablations")
        os.makedirs(out_dir, exist_ok=True)
        sources = [("new", new), *_ablated(new, out_dir).items()]
        shapes = {k: SHAPES[k] for k in ABLATION_SHAPES}
        order = [k for k, _ in sources]
        order += order[::-1]
    else:
        sources = [("old", args.old), ("new", new)]
        shapes = SHAPES
        order = ["old", "new", "new", "old"]
    runs = {}
    for name, source in sources:
        path, log = ops.build_library(source)
        runs[name] = _launcher(ops.bind_library(path))
        print(f"{name}: {source} -> {os.path.relpath(path)}")
        for line in log.splitlines():
            if ("registers" in line or "spill" in line or "wgmma" in line
                    or "Compiling entry" in line):
                print(f"  ptxas: {line.strip()}")

    readings, failed = {}, False
    for i, (name, (m, rows, d_in, d_hidden, d_out)) in enumerate(
            shapes.items()):
        f = cs._randn(cs.SEED + 60 + i)
        lead = (m,) if m > 1 else ()
        w_args = (f(*lead, rows, d_in), f(*lead, d_hidden, d_in) * 0.3,
                  f(*lead, d_hidden) * 0.1,
                  f(*lead, d_out, d_hidden) * cs._w1_scale(d_hidden),
                  f(*lead, d_out) * 0.1)
        out = {k: torch.empty((*lead, rows, d_out), device="cuda")
               for k in runs}
        r = {}
        with torch.inference_mode():
            want = ops.fused_mlp_reference(*w_args)
            for k, run in runs.items():
                got = run(*w_args, out[k])
                torch.cuda.synchronize()
                r[f"{k}_max_abs_err"] = float((got - want).abs().max())
                ok = bool(torch.allclose(got, want, rtol=cs.RTOL,
                                         atol=cs.ATOL))
                r[f"{k}_ok"] = ok
                failed |= k == "new" and not ok
            times = {k: [] for k in runs}
            for k in order:
                times[k].append(cs._device_ms(
                    lambda k=k: runs[k](*w_args, out[k]), reps=10))
            r.update({f"{k}_ms": v for k, v in times.items()})
            r["plain_ms"] = cs._device_ms(
                lambda: ops.fused_mlp_reference(*w_args), reps=10)
            r["library_ms"] = (r["plain_ms"] if m > 1 else cs._device_ms(
                lambda: cs._forward_library(*w_args), reps=10))
        if m > 1:
            bound_ms, bound_by = cs._batched_bound_ms(m, rows, d_in, d_hidden,
                                                      d_out)
        else:
            bound_ms, bound_by = cs._bound_ms(rows, d_in, d_hidden, d_out)[1]
        r.update(bound_ms=bound_ms, bound_by=bound_by)
        readings[name] = r
        new_ms = min(r["new_ms"])
        line = ", ".join(
            f"{k} {' / '.join(f'{t:.4f}' for t in r[f'{k}_ms'])} ms "
            f"({r[f'{k}_max_abs_err']:.1e})" for k in runs)
        print(f"{name} {m} x {rows} x ({d_in}->{d_hidden}->{d_out}): {line}"
              f"{'' if r['new_ok'] else ' MISMATCH'}; plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}; new reaches "
              f"{100 * bound_ms / new_ms:.1f} % of it)")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "shapes": readings}, fh, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
