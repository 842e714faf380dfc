"""GPU smoke of the PyTorch/CUDA port (cxxnet_tpu_torch) on one card.

    python3 chip_smoke.py            # every phase, on cuda:0

Phases (any failure raises and exits non-zero):

1. environment: the card's name and power limit, torch / CUDA versions,
   and the build of the hand-written kernels from ops/csrc (timed);
2. kernel parity: each CUDA kernel against its plain PyTorch version on
   the card at the served model's shapes, with its median time, the plain
   version's, one PyTorch library call's (a yardstick only: the port
   never calls it) and the least time the card could take (bound);
3. main path: the port's ``task = serve`` / ``serve_gen = 1`` CLI serves
   the d2048 / 12-layer / s4096 / bf16 transformer LM (random weights
   from a seed, written as a ``.model``) to concurrent clients, twice
   over the same 8 prompts of seeded lengths in 64..1024 (one document
   each, ``serve_gen_prompt_doc = 1``); the kernels' launch counters
   must show that every prefill and every step went through them;
4. on-card consistency: the decode engine's prefill and incremental step
   logits against a cache-free full forward, through the kernels and
   through the plain torch path (``flash_attn = 0``, ``pallas_ln = 0``).

The last two lines are a ``{"kernels": [...]}`` JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or run
outside a checkout of the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

#: the JAX package's serving envelope (cxxnet_tpu/serve/engine.py SERVE_TOL),
#: for the logits of the whole bf16 net
SERVE_TOL_BF16 = 2e-2
#: float32 kernel outputs (and the float32 lse / mean / rstd of bf16 runs):
#: max |got - ref| / max |ref|
F32_TOL = 1e-4
#: bf16 kernel outputs: max |got - ref| per row within two bf16 ulps of
#: the row's largest element (one ulp of a value is at most 2^-7 of it)
BF16_ROW_TOL = 2.0 ** -6

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, and FLOP/s
# of the tensor cores in bf16 and of the CUDA cores in float32
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# the served model: bench.py's LM flagship width
VOCAB, SEQ, DIM, NLAYER, NHEAD = 8192, 4096, 2048, 12, 16
N_PROMPTS, GEN_TOKENS, SLOTS, CLIENTS = 8, 32, 4, 4
PROMPT_LENS = (64, 1024)    # prompt lengths drawn uniformly from this range
MAIN_REPS = 2               # CLI runs over the same prompts
DEV = "gpu"

ALL_PHASES = {"env", "kernels", "serve", "consistency"}

REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref| (the SERVE_TOL metric)."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-6))


def row_rel_err(got, ref) -> float:
    """max over rows of max |got - ref| / max |ref| within the row."""
    got = got.float().reshape(-1, got.shape[-1])
    ref = ref.float().reshape(-1, ref.shape[-1])
    return float(((got - ref).abs().amax(1)
                  / ref.abs().amax(1).clamp_min(1e-6)).max())


# ------------------------------------------------------------------ phases
def phase_env():
    import torch
    from cxxnet_tpu_torch.ops import build
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    # float32 products in full float32 (the reference precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("matmul.allow_tf32 = False, cudnn.allow_tf32 = False")
    t0 = time.perf_counter()
    build.LIBRARY.get()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.LIBRARY.build_sec:.2f} s)")
    for line in build.LIBRARY.build_log.splitlines():
        if "registers" in line or line.startswith("=="):
            log(f"  ptxas: {line.strip()}")


def phase_kernels():
    """Kernel vs plain version at the served shapes; returns the
    per-kernel numbers of the served (bf16) shape."""
    import torch
    import torch.nn.functional as F
    from cxxnet_tpu_torch.ops import flash_attention as fa
    from cxxnet_tpu_torch.ops import layernorm as ln
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {}
    bh, s, d = NHEAD, SEQ, DIM // NHEAD
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        q, k, v = (torch.randn((bh, s, d), generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, True)
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        err = row_rel_err(o, o_ref) if bf16 else rel_err(o, o_ref)
        lerr = rel_err(lse, lse_ref)
        abs_err = float((o.float() - o_ref.float()).abs().max())
        tol = BF16_ROW_TOL if bf16 else F32_TOL
        ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, True))
        plain = time_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, True),
                        reps=3)
        q4, k4, v4 = (t.view(1, bh, s, d) for t in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True))
        flops = 4.0 * d * bh * s * (s + 1) / 2
        nbytes = 4 * bh * s * d * q.element_size() + bh * s * 4
        t_ops = flops / PEAK_FLOPS[name] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"flash_attention_fwd ({bh},{s},{d}) causal {name}: "
            f"{'per-row ' if bf16 else ''}rel err o {err:.3e} (tol {tol:g}),"
            f" lse {lerr:.3e} (tol {F32_TOL:g}); abs err {abs_err:.3e};"
            f" kernel {ms:.3f} ms, plain {plain:.3f} ms, sdpa {lib:.3f} ms,"
            f" bound {max(t_ops, t_bytes):.4f} ms")
        if not (err <= tol and lerr <= F32_TOL):
            raise AssertionError(f"flash_attention_fwd {name} disagrees "
                                 f"with its plain version: {err}, {lerr}")
        if dtype == torch.bfloat16:
            out["flash_attention_fwd"] = dict(
                max_abs_err=abs_err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")
    for rows in (SEQ, SLOTS):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            x = (torch.randn((rows, DIM), generator=gen, device=dev) * 2 + 3
                 ).to(dtype)
            g = (torch.rand((DIM,), generator=gen, device=dev) + 0.5).to(dtype)
            b = (torch.randn((DIM,), generator=gen, device=dev) * .5).to(dtype)
            y, mean, rstd = ln.layernorm_fwd(x, g, b, 1e-5)
            y_ref, m_ref, r_ref = ln.layernorm_fwd_plain(x, g, b, 1e-5)
            torch.cuda.synchronize()
            bf16 = dtype == torch.bfloat16
            err = row_rel_err(y, y_ref) if bf16 else rel_err(y, y_ref)
            serr = max(rel_err(mean, m_ref), rel_err(rstd, r_ref))
            abs_err = float((y.float() - y_ref.float()).abs().max())
            tol = BF16_ROW_TOL if bf16 else F32_TOL
            ms = time_ms(lambda: ln.layernorm_fwd(x, g, b, 1e-5), reps=20)
            plain = time_ms(lambda: ln.layernorm_fwd_plain(x, g, b, 1e-5),
                            reps=20)
            lib = time_ms(lambda: F.layer_norm(x, (DIM,), g, b, 1e-5),
                          reps=20)
            nbytes = (2 * rows * DIM * x.element_size()
                      + 2 * DIM * g.element_size() + 2 * rows * 4)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 8.0 * rows * DIM / PEAK_FLOPS["float32"] * 1e3
            log(f"layernorm_fwd ({rows},{DIM}) {name}: "
                f"{'per-row ' if bf16 else ''}rel err y {err:.3e} (tol "
                f"{tol:g}), mean/rstd {serr:.3e} (tol {F32_TOL:g}); abs err "
                f"{abs_err:.3e}; kernel {ms:.4f} ms, "
                f"plain {plain:.4f} ms, F.layer_norm {lib:.4f} ms, bound "
                f"{max(t_ops, t_bytes):.5f} ms")
            if not (err <= tol and serr <= F32_TOL):
                raise AssertionError(f"layernorm_fwd {name} ({rows} rows) "
                                     f"disagrees with its plain version: "
                                     f"{err}, {serr}")
            if dtype == torch.bfloat16 and rows == SEQ:
                out["layernorm_fwd"] = dict(
                    max_abs_err=abs_err, ms=ms, plain_ms=plain,
                    library_ms=lib, bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes")
    return out


def write_inputs(tmp: str) -> str:
    """A seeded flagship ``.model``, a shard of N_PROMPTS prompt
    documents of seeded lengths and the serve conf (one request per
    document); returns the conf path."""
    import torch
    from cxxnet_tpu_torch.io.text import write_token_shard
    from cxxnet_tpu_torch.models import transformer
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    net = transformer(vocab=VOCAB, seq=SEQ, dim=DIM, nlayer=NLAYER,
                      nhead=NHEAD)
    t0 = time.perf_counter()
    tr = NetTrainer()
    for k, v in parse_config_string(net):
        tr.set_param(k, v)
    for k, v in (("batch_size", str(SLOTS)), ("dtype", "bfloat16"),
                 ("dev", DEV), ("seed", "7"), ("silent", "1")):
        tr.set_param(k, v)
    tr.init_model()
    nparam = sum(t.numel() for g in tr.params.values() for t in g.values())
    model = os.path.join(tmp, "lm.model")
    tr.save_model(model)
    del tr
    torch.cuda.empty_cache()
    log(f"model: {nparam / 1e9:.3f} B parameters (bf16), seeded init + save "
        f"in {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(11)
    lens = rng.randint(PROMPT_LENS[0], PROMPT_LENS[1] + 1, N_PROMPTS)
    log(f"prompt lengths: {lens.tolist()}")
    write_token_shard(os.path.join(tmp, "prompts.tok"),
                      [rng.randint(0, VOCAB, n) for n in lens], itemsize=2)
    conf = os.path.join(tmp, "serve.conf")
    with open(conf, "w") as f:
        f.write(f"""dev = {DEV}
task = serve
model_in = {model}
pred = {tmp}/gen_out.txt
iter = text
  path_tok = {tmp}/prompts.tok
iter = packseq
  seqlen = {PROMPT_LENS[1]}
  pack_split = 0
iter = end
{net}
batch_size = 1
dtype = bfloat16
serve_gen = 1
decode_slots = {SLOTS}
decode_max_seqlen = {SEQ}
serve_gen_tokens = {GEN_TOKENS}
serve_gen_prompt = {PROMPT_LENS[1]}
serve_gen_prompt_doc = 1
serve_gen_sample = greedy
serve_gen_batching = continuous
serve_clients = {CLIENTS}
metrics_sink = jsonl:{tmp}/serve_metrics.jsonl
""")
    return conf


def phase_serve(tmp: str):
    """MAIN_REPS runs of the serve CLI over the same conf; the launch
    counters are zeroed before the first and read after the last."""
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.ops import flash_attention as fa
    from cxxnet_tpu_torch.ops import layernorm as ln
    conf = write_inputs(tmp)
    prefills = steps = 0
    fa.flash_attention_fwd.launches = 0
    ln.layernorm_fwd.launches = 0
    for rep in range(MAIN_REPS):
        task = LearnTask()
        t0 = time.perf_counter()
        rc = task.run([conf])
        wall = time.perf_counter() - t0
        st = task.last_serve
        if rc != 0 or st is None:
            raise AssertionError(f"serve CLI returned {rc}")
        prefills += st["prefill_calls"]
        steps += st["step_calls"]
        log(f"main path run {rep + 1}/{MAIN_REPS}: {st['requests']} "
            f"requests, {st['tokens']} tokens in {st['duration_sec']:.3f} s"
            f" = {st['tokens_per_sec']:.1f} tok/s; prefill p50 "
            f"{st['prefill_p50_ms']:.2f} ms, step p50 {st['tok_p50_ms']:.2f}"
            f" ms, mean occupancy {st['mean_occupancy']}; CLI wall "
            f"{wall:.1f} s")
        if st["requests"] != N_PROMPTS:
            raise AssertionError(f"{st['requests']} requests for "
                                 f"{N_PROMPTS} prompts")
        lines = open(os.path.join(tmp, "gen_out.txt")).read().splitlines()
        if len(lines) != N_PROMPTS:
            raise AssertionError(f"{len(lines)} generations for "
                                 f"{N_PROMPTS} prompts")
        for ln_ in lines:
            toks = [int(t) for t in ln_.split()]
            if len(toks) != GEN_TOKENS or not all(0 <= t < VOCAB
                                                  for t in toks):
                raise AssertionError(f"bad generation row: {ln_[:80]}")
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "layernorm_fwd": ln.layernorm_fwd.launches}
    log(f"main path launches: {launches} for {prefills} prefills and "
        f"{steps} steps (plus one warmup prefill and step per run)")
    if launches["flash_attention_fwd"] < NLAYER * prefills or prefills < 1:
        raise AssertionError("prefills did not all run the flash kernel")
    if launches["layernorm_fwd"] < (2 * NLAYER + 1) * (prefills + steps):
        raise AssertionError("forwards did not all run the layernorm kernel")
    return task, launches


def phase_consistency(task):
    """Prefill + 8 greedy step logits vs the cache-free full forward,
    kernel path and plain path."""
    import torch
    from cxxnet_tpu_torch.serve.decode import DecodeEngine
    tr = task.net
    eng = DecodeEngine(tr, slots=SLOTS)
    prompt = np.random.RandomState(5).randint(0, VOCAB, 200).astype(np.int32)
    seq = list(prompt)
    rows = [eng.prefill(2, prompt)]
    for _ in range(8):
        seq.append(int(np.argmax(rows[-1])))
        tokens = np.zeros((SLOTS,), np.int32)
        positions = np.zeros((SLOTS,), np.int32)
        tokens[2], positions[2] = seq[-1], len(seq) - 1
        rows.append(eng.step(tokens, positions)[2])
    got = torch.from_numpy(np.stack(rows))
    idx = np.arange(len(prompt) - 1, len(seq))
    full = torch.from_numpy(eng.full_logits(np.asarray(seq))[idx])
    tr.opts.set("flash_attn", "0")
    tr.opts.set("pallas_ln", "0")
    plain = torch.from_numpy(eng.full_logits(np.asarray(seq))[idx])
    tr.opts.set("flash_attn", "1")
    tr.opts.set("pallas_ln", "1")
    e1, e2 = rel_err(got, full), rel_err(got, plain)
    e3 = rel_err(full, plain)
    log(f"consistency (bf16, tol {SERVE_TOL_BF16}): engine vs full forward "
        f"{e1:.3e}, engine vs plain path {e2:.3e}, kernel vs plain full "
        f"forward {e3:.3e}")
    if max(e1, e2, e3) > SERVE_TOL_BF16 or not torch.isfinite(got).all():
        raise AssertionError("decode logits leave the bf16 envelope")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(sorted(ALL_PHASES)),
                    help="comma-separated subset of the phases")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    phases = set(args.phases.split(","))
    torch.cuda.set_device(0)
    phase_env()
    numbers = phase_kernels() if "kernels" in phases else {}
    launches = {}
    if "serve" in phases:
        with tempfile.TemporaryDirectory(prefix="cxn_smoke_") as tmp:
            task, launches = phase_serve(tmp)
            if "consistency" in phases:
                phase_consistency(task)
    replaces = {
        "flash_attention_fwd": ("cxxnet_tpu_torch/ops/csrc/flash_attn_fwd.cu",
                                "cxxnet_tpu/ops/pallas_kernels.py:1259"),
        "layernorm_fwd": ("cxxnet_tpu_torch/ops/csrc/layernorm_fwd.cu",
                          "cxxnet_tpu/ops/pallas_kernels.py:1736")}
    kernels = [dict(name=n, route="cuda", source=src, replaces=rep,
                    launches=launches.get(n, 0), **numbers.get(n, {}))
               for n, (src, rep) in replaces.items()]
    if phases != ALL_PHASES:
        log(f"ran phases {sorted(phases)} only: no result")
        return 1
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
