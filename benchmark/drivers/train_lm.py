"""Packed LM training: the program's ``text`` + ``packseq`` chain over a
token shard of the seed's documents, staged by ``DevicePrefetcher``, and
``NetTrainer.update`` a batch at a time.

Set-up writes the shard, builds the trainer, installs the benchmark's
weights and drives the first ``CHECK_STEPS`` steps through the window's
own call and feed (they warm every shape and are what the reference
follows).  The window takes steps until ``run.seconds`` have passed,
then waits for the card: ``train_tokens_per_s`` is every valid target of
those steps over that time.  The judge frees the program and trains the
plain reference over the same documents from the same weights.
"""

from __future__ import annotations

import gc
import math
import os
import time


from benchmark.core import corpus, judge as judgelib, program, weights as W

CHECK_STEPS = 3


def _adam(cfg: dict) -> dict:
    k = cfg["keys"]
    return {"d1": float(k.get("beta1", 0.1)), "d2": float(k.get("beta2", 0.001)),
            "eta": float(k["eta"]), "eps": 1e-8}


def _next(pf):
    """The next staged batch; a finished epoch starts the next."""
    item = pf.next()
    if item is None:
        pf.before_first()
        item = pf.next()
    return item[0]


def setup(run) -> None:
    from cxxnet_tpu_torch.io.device_prefetch import DevicePrefetcher
    cfg, tf, ref = run.config, run.traffic, run.reference
    rows, seq = tf["rows"], cfg["model"]["n_positions"]
    steps_max = CHECK_STEPS + math.ceil(run.seconds / tf["min_step_s"])
    docs = corpus.documents(tf, run.seed, steps_max * rows * seq + 1,
                            cfg["model"]["vocab_size"])
    shard = os.path.join(run.tmp, f"bench_lm_{os.getpid()}.tok")
    corpus.write_shard(shard, docs)
    run.mark("corpus")
    run.info.update(docs=docs, shard=shard, rows=rows, seq=seq)
    dev = "gpu" if run.device.type == "cuda" else "cpu"
    text = program.conf_text(
        cfg, {"dev": dev, "batch_size": rows, "seed": W.program_seed(run.seed),
              "silent": 1, "eval_train": 0, "save_model": 0},
        data=[("iter", "text"), ("path_tok", shard), ("iter", "packseq"),
              ("seqlen", seq), ("pack_split", tf["pack_split"])])
    tr, chain = program.build(text)
    run.mark("program_build")
    specs = ref.leaf_specs(cfg)
    W.install(tr, W.make(specs, run.seed, run.device, tr.dtype))
    run.mark("weights")
    pf = DevicePrefetcher(chain, tr, depth=tf["prefetch_depth"])
    pf.before_first()
    run.info.update(trainer=tr, prefetcher=pf, chain=chain)
    d1 = _adam(cfg)["d1"]
    losses = []
    for k in range(CHECK_STEPS):
        tr.update(_next(pf))
        losses.append(float(tr.last_loss))
        if k == 0:
            grads = judgelib.leaf_norms(
                tr, lambda pk, t, p: tr.opt_state[pk][t]["m1"],
                ref.part_norms, 1.0 / d1)
    run.mark("check_steps")
    w0 = W.make(specs, run.seed, run.device, tr.dtype)
    change = judgelib.leaf_norms(
        tr, lambda pk, t, p: judgelib.master(tr, pk, t, p)
        - w0[f"{pk.split('-', 1)[1]}/{t}"].float(), ref.part_norms)
    del w0
    run.mark("norms")
    run.info["prog"] = {"losses": losses, "grad_norms": grads,
                        "change": change}


def window(run) -> None:
    import torch
    tr, pf = run.info["trainer"], run.info["prefetcher"]
    seq = run.info["seq"]
    spans = run.spans
    labels, losses = [], []
    steps = 0
    t0 = time.perf_counter()
    end = t0 + run.seconds
    while True:
        with spans.span("input_wait"):
            sb = _next(pf)
        with spans.span("update"):
            tr.update(sb)
        labels.append(sb.label_host)
        losses.append(tr.last_loss)
        steps += 1
        if time.perf_counter() >= end:
            break
    tr.sync()
    dt = time.perf_counter() - t0
    targets = sum(int((lab[:, :seq] >= 0).sum()) for lab in labels)
    run.e2e["train_tokens_per_s"] = targets / dt
    run.attempted = steps
    run.failed = int((~torch.isfinite(torch.stack(losses))).sum())
    run.info.update(labels=labels, window_s=dt, targets=targets)


def judge(run) -> None:
    import torch
    pf = run.info.pop("prefetcher")
    pf.close()
    for k in ("trainer", "chain"):
        run.info.pop(k, None)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    os.remove(run.info["shard"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, ref = run.config, run.reference
    specs = ref.leaf_specs(cfg)
    w = W.make(specs, run.seed, run.device,
               getattr(torch, cfg["keys"]["dtype"]))
    batches = ref.pack(run.info["docs"], run.info["rows"], run.info["seq"],
                       CHECK_STEPS)
    r = ref.train(w, batches, cfg, _adam(cfg),
                  block=run.traffic["reference_rows"])
    judgelib.training_checks(run, run.info["prog"], r)
