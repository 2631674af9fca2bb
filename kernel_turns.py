"""The GDR kernels of two checkouts of the port, timed in turns on one card.

    python3 kernel_turns.py OTHER_TREE

OTHER_TREE is another checkout of this repository (for example the parent
commit, unpacked by ``git archive`` into a git-ignored directory).  Four
processes take turns (other, this, this, other).  Each imports one tree's
``gdkvm_tpu_torch``, builds that tree's kernels from its own sources, and
times them on the same seeded inputs with the same clock
(``chip_smoke._times_ms``: CUDA events behind a spin of the stream, so the
device alone):

- the residual-free forward (``gdr_fwd_cuda``) at the streaming shape
  (B=8 H=4 T=32 N=49 d=64, bf16 q/k/v) and at the serving shape (T=16);
- the forward with S_{t-1}, U, W (``gdr_fwd_cuda_residuals``) and the
  backward kernel (``gdr_bwd_cuda``) at the training shape (T=10 N=256);
- the chain kernel (``gdr_chain_cuda``) at the serving shape without
  S_{t-1} and at the training shape with it;
- beside them the plain versions (``gdr_chunked``, ``gdr_chunked_residuals``,
  ``gdr_chain``, ``gdr_bwd_ref``), the stored backward ``gdr_bwd_stored``
  and the batched solve ``_wy``: plain PyTorch in either tree, so they
  show how far the clock moves between turns.

Each process prints one line of medians (ms); the last line is one JSON
object with, for each entry, the median over both turns of each tree and
the ratio other / this.  Needs one CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
STREAM_SHAPE = (8, 4, 32, 49, 64, 64)


def _child(tree: Path) -> dict:
    """Medians (ms) of ``tree``'s kernels and of the plain versions."""
    import chip_smoke as cs          # this checkout's clock and inputs
    sys.path.insert(0, str(tree))
    import torch
    import gdkvm_tpu_torch
    if Path(gdkvm_tpu_torch.__file__).resolve().parent.parent != tree:
        raise SystemExit(f"imported {gdkvm_tpu_torch.__file__}, not {tree}'s")
    from gdkvm_tpu_torch.core import gdr
    from gdkvm_tpu_torch.ops import _build, gdr_cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = sorted(p.stem for p in (tree / "gdkvm_tpu_torch" / "csrc").glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(_build.build, names))

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(11)
    inputs = lambda shape: cs._gdr_inputs(gen, *shape, torch.bfloat16, dev)
    med = lambda fn, iters=20: statistics.median(cs._times_ms(fn, iters))
    out = {}
    q, k, v, beta, alpha, s0 = inputs(STREAM_SHAPE)
    out["fwd stream"] = med(lambda: gdr_cuda.gdr_fwd_cuda(q, k, v, beta, alpha, s0))
    out["plain fwd stream"] = med(lambda: gdr.gdr_chunked(q, k, v, beta, alpha, s0))

    q, k, v, beta, alpha, s0 = inputs(cs.SERVE_SHAPE)
    u, w = gdr_cuda._wy(k, v, beta, None)
    out["fwd serve"] = med(lambda: gdr_cuda.gdr_fwd_cuda(q, k, v, beta, alpha, s0))
    out["plain fwd serve"] = med(lambda: gdr.gdr_chunked(q, k, v, beta, alpha, s0))
    out["chain serve"] = med(lambda: gdr_cuda.gdr_chain_cuda(
        q, k, u, w, alpha, s0, save_states=False))
    out["plain chain serve"] = med(lambda: gdr.gdr_chain(
        q, k, u, w, alpha, s0, save_states=False))
    out["_wy serve"] = med(lambda: gdr_cuda._wy(k, v, beta, None))

    q, k, v, beta, alpha, s0 = inputs(cs.TRAIN_SHAPE)
    u, w = gdr_cuda._wy(k, v, beta, None)
    out["fwd+residuals train"] = med(lambda: gdr_cuda.gdr_fwd_cuda_residuals(
        q, k, v, beta, alpha, s0))
    out["plain fwd+residuals train"] = med(lambda: gdr.gdr_chunked_residuals(
        q, k, v, beta, alpha, s0))
    out["chain train"] = med(lambda: gdr_cuda.gdr_chain_cuda(
        q, k, u, w, alpha, s0, save_states=True))
    out["plain chain train"] = med(lambda: gdr.gdr_chain(
        q, k, u, w, alpha, s0, save_states=True))
    out["_wy train"] = med(lambda: gdr_cuda._wy(k, v, beta, None))
    states = gdr.gdr_chunked_residuals(q, k, v, beta, alpha, s0)[2]
    do = torch.randn(cs.TRAIN_SHAPE[:4] + (cs.TRAIN_SHAPE[5],), device=dev, generator=gen)
    ds_t = torch.randn(s0.shape, device=dev, generator=gen)
    args = (q, k, v, beta, beta, alpha, states, do, ds_t)
    out["bwd train"] = med(lambda: gdr_cuda.gdr_bwd_cuda(*args), iters=10)
    out["plain bwd train"] = med(lambda: gdr.gdr_bwd_ref(*args), iters=10)
    out["stored bwd train"] = med(lambda: gdr.gdr_bwd_stored(
        q, k, v, beta, beta, alpha, states, u, w, do, ds_t), iters=10)
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[1] == "--child":
        print(json.dumps(_child(Path(argv[2]).resolve())))
        return 0
    if len(argv) != 2:
        raise SystemExit(__doc__)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_turns: torch.cuda.is_available() is False")
    trees = {"other": Path(argv[1]).resolve(), "this": HERE}
    runs: dict[str, list[dict]] = {"other": [], "this": []}
    for which in ("other", "this", "this", "other"):
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                              str(trees[which])], capture_output=True, text=True,
                             timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            raise SystemExit(f"kernel_turns: the {which} tree's turn failed")
        runs[which].append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(f"{which} ({trees[which]}): " + json.dumps(runs[which][-1]))
    summary = {}
    for key in runs["this"][0]:
        if key in runs["other"][0]:
            o, t = (statistics.median(r[key] for r in runs[w]) for w in ("other", "this"))
            summary[key] = {"other": o, "this": t, "other/this": o / t}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
