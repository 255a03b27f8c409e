"""One real fine-tune on one device, end to end: the twin of ``tools/finetune_demo.py``.

The task is the reference's (``finetune_demo.py:60-104``, copied here:
:data:`FAMILIES`, :data:`FILLER`, :func:`make_dataset`, :func:`macro_f1`;
the same seed gives the same texts and labels): synthetic keyword
sentiment, where each text mixes neutral filler with keywords of up to
three of the six tracked emotion families and the multi-hot label marks
which appear.  The loop:

1. the encoder (``--config tiny``: TINY_TEST; ``roberta``:
   ROBERTA_GO_EMOTIONS, bf16 matmuls over float32 parameters) with
   ``--attention dense`` (the reference's default) or ``flash`` (the
   forward kernel B1 and the backward kernels B4 and B5 on the card),
   trained by :func:`svoc_torch.train.trainer.make_train_step` with
   AdamW to a target macro-F1 over the six tracked labels;
2. a mid-run :func:`svoc_torch.utils.checkpoint.save_train_state`; the
   checkpoint restored into a fresh state on the same device and the
   remaining steps replayed must give the uninterrupted run's final
   parameters exactly (``same_mesh_replay_max_abs_param_delta`` 0.0).

The reference trains on a GSPMD ``data × model`` mesh and also restores
onto a changed mesh; the port has one device, and the changed-mesh
restore (``--changed-mesh``) and ZeRO-1 (``--zero1``) raise
``NotImplementedError`` (ROADMAP A12e part 2).  Their report keys stay, as None.

Usage::

    python -m svoc_torch.tools.finetune_demo [--steps 240] [--batch 32] [--target-f1 0.9]
        [--config tiny|roberta] [--attention dense|flash] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Callable, Optional

import numpy as np

#: keyword families for the 6 tracked labels (order = TRACKED_LABELS).
FAMILIES = {
    "optimism": ["hopeful", "promising", "bright", "improving", "upbeat"],
    "anger": ["furious", "outraged", "livid", "seething", "enraged"],
    "annoyance": ["irritating", "tedious", "nagging", "grating", "bothersome"],
    "excitement": ["thrilled", "stoked", "electrifying", "exhilarating"],
    "nervousness": ["anxious", "jittery", "uneasy", "worried", "tense"],
    "remorse": ["sorry", "regretful", "ashamed", "apologetic", "guilty"],
}
FILLER = (
    "the build system compiles modules into artifacts and the scheduler "
    "queues jobs across nodes while the database commits transactions to "
    "replicated logs and the parser emits tokens for the compiler backend"
).split()


def make_dataset(rng, n, tracked_indices, n_labels):
    """(texts, labels [n, n_labels] multi-hot) for the keyword task."""
    fams = list(FAMILIES.values())
    texts, labels = [], np.zeros((n, n_labels), np.float32)
    for i in range(n):
        k = int(rng.integers(1, 4))  # 1..3 families present
        present = rng.choice(len(fams), size=k, replace=False)
        words = list(rng.choice(FILLER, size=int(rng.integers(4, 9))))
        for f in present:
            words += list(rng.choice(fams[f], size=int(rng.integers(2, 5))))
            labels[i, tracked_indices[f]] = 1.0
        rng.shuffle(words)
        texts.append(" ".join(words))
    return texts, labels


def macro_f1(pred: np.ndarray, truth: np.ndarray) -> float:
    """Macro-F1 over label columns (pred/truth multi-hot)."""
    f1s = []
    for j in range(pred.shape[1]):
        tp = float(np.sum((pred[:, j] == 1) & (truth[:, j] == 1)))
        fp = float(np.sum((pred[:, j] == 1) & (truth[:, j] == 0)))
        fn = float(np.sum((pred[:, j] == 0) & (truth[:, j] == 1)))
        if tp + fp + fn == 0:
            continue  # label absent from eval slice
        f1s.append(2 * tp / max(2 * tp + fp + fn, 1e-9))
    return float(np.mean(f1s)) if f1s else 0.0


def max_abs_param_delta(a, b) -> float:
    """Largest absolute difference between two models' parameters."""
    return max(float((x.detach() - y.detach()).abs().max())
               for x, y in zip(a.parameters(), b.parameters()))


def encoder_config(config: str, attention: str):
    from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS, TINY_TEST

    configs = {"tiny": TINY_TEST, "roberta": ROBERTA_GO_EMOTIONS}
    if config not in configs:
        raise ValueError(f"config must be one of {sorted(configs)} (got {config!r})")
    return dataclasses.replace(configs[config], attention=attention)


def run(
    *,
    steps: int = 240,
    batch: int = 32,
    seq: int = 32,
    lr: float = 3e-3,
    target_f1: float = 0.9,
    eval_n: int = 128,
    config: str = "tiny",
    attention: str = "dense",
    device=None,
    zero1: bool = False,
    changed_mesh: bool = False,
    on_step: Optional[Callable[[int], None]] = None,
) -> dict:
    """The fine-tune, its mid-run checkpoint and the same-device replay;
    returns the report (the reference's keys, plus the device, the
    attention and the timing).  The weights are ``init_params(cfg,
    seed=0)``; ``on_step(i)`` runs before each step of the uninterrupted
    run."""
    if zero1:
        raise NotImplementedError("--zero1: the sharded optimizer state needs the mesh trainer (ROADMAP A12e part 2)")
    if changed_mesh:
        raise NotImplementedError("--changed-mesh: a restore onto another mesh needs the mesh trainer "
                                  "(ROADMAP A12e part 2)")
    import torch

    from svoc_torch.device import resolve_device
    from svoc_torch.models.encoder import SentimentEncoder, init_params
    from svoc_torch.models.sentiment import TRACKED_INDICES
    from svoc_torch.models.tokenizer import load_tokenizer
    from svoc_torch.train.trainer import Batch, adamw, init_state, make_train_step
    from svoc_torch.utils.checkpoint import restore_train_state, save_train_state

    device = resolve_device(device)
    cfg = encoder_config(config, attention)
    tok = load_tokenizer(cfg.vocab_size, pad_id=cfg.pad_id, max_len=seq)
    rng = np.random.default_rng(0)
    eval_texts, eval_labels = make_dataset(rng, eval_n, TRACKED_INDICES, cfg.n_labels)
    eval_ids, eval_mask = (torch.from_numpy(a).to(device) for a in tok(eval_texts, seq))

    def batches(seed):
        brng = np.random.default_rng(seed)
        while True:
            texts, labels = make_dataset(brng, batch, TRACKED_INDICES, cfg.n_labels)
            ids, mask = tok(texts, seq)
            yield Batch(ids=torch.from_numpy(ids).to(device), mask=torch.from_numpy(mask).to(device),
                        labels=torch.from_numpy(labels).to(device))

    params = init_params(cfg, seed=0, device=device)

    def fresh_state():
        with torch.device("meta"):
            model = SentimentEncoder(cfg)
        return init_state(model, params, adamw(lr), device=device)

    def evaluate(model) -> float:
        with torch.no_grad():
            logits = model(eval_ids, eval_mask)
        pred = (torch.sigmoid(logits.float()) > 0.5).float().cpu().numpy()
        idx = list(TRACKED_INDICES)
        return macro_f1(pred[:, idx], eval_labels[:, idx])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    step_fn = make_train_step()
    state = fresh_state()
    f1_before = evaluate(state.model)
    half = steps // 2
    losses = []
    # The mid-run checkpoint (parameters and AdamW moments: about 1.5 GB
    # at ROBERTA_GO_EMOTIONS width) lives only until it is restored.
    with tempfile.TemporaryDirectory(prefix="svoc_ft_") as ckpt_dir:
        ckpt = os.path.join(ckpt_dir, "mid.pt")
        gen = batches(seed=1)
        sync()
        t0 = time.perf_counter()
        for i in range(steps):
            if on_step is not None:
                on_step(i)
            state, metrics = step_fn(state, next(gen))
            losses.append(float(metrics["loss"]))
            if i + 1 == half:
                save_train_state(ckpt, state)
        sync()
        train_s = time.perf_counter() - t0
        f1_after = evaluate(state.model)

        # Same-device restore and replay: bit-identical final parameters.
        restored = restore_train_state(ckpt, fresh_state())
    gen2 = batches(seed=1)
    for _ in range(half):
        next(gen2)  # the first half's batches
    for _ in range(half, steps):
        restored, _ = step_fn(restored, next(gen2))
    replay_delta = max_abs_param_delta(restored.model, state.model)
    finite = bool(np.isfinite(losses).all())
    ok = f1_after >= target_f1 and replay_delta == 0.0 and finite
    return {
        "task": "synthetic keyword sentiment (6 tracked families)",
        "config": f"{config} encoder ({cfg.n_layers}L/{cfg.hidden}H, {cfg.attention} attention), "
                  f"one device ({device})",
        "zero1_opt_sharding": False,
        "steps": steps,
        "batch": batch,
        "loss_curve": [round(x, 4) for x in losses],
        "macro_f1_before": round(f1_before, 4),
        "macro_f1_after": round(f1_after, 4),
        "target_f1": target_f1,
        "same_mesh_replay_max_abs_param_delta": replay_delta,
        "changed_mesh_restore_max_abs_param_delta": None,
        "changed_mesh_continued_losses": None,
        "device": str(device),
        "attention": cfg.attention,
        "losses_finite": finite,
        "train_s": train_s,
        "step_ms": train_s / max(steps, 1) * 1e3,
        "comments_per_s": steps * batch / train_s if train_s > 0 else None,
        "ok": bool(ok),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=240)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--target-f1", type=float, default=0.9)
    p.add_argument("--eval-n", type=int, default=128)
    p.add_argument("--config", choices=("tiny", "roberta"), default="tiny")
    p.add_argument("--attention", choices=("dense", "flash"), default="dense")
    p.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    p.add_argument("--out", default="FINETUNE_torch.json")
    p.add_argument("--zero1", action="store_true", help="(ROADMAP A12e part 2) raises")
    p.add_argument("--changed-mesh", action="store_true", help="(ROADMAP A12e part 2) raises")
    args = p.parse_args(argv)
    report = run(steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr, target_f1=args.target_f1,
                 eval_n=args.eval_n, config=args.config, attention=args.attention, device=args.device,
                 zero1=args.zero1, changed_mesh=args.changed_mesh)
    losses = report["loss_curve"]
    print(f"[finetune] loss {losses[0]:.3f} -> {losses[-1]:.3f}; macro-F1 {report['macro_f1_before']:.3f} "
          f"-> {report['macro_f1_after']:.3f}; same-device replay max|dparams| = "
          f"{report['same_mesh_replay_max_abs_param_delta']:.2e}", flush=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[finetune] wrote {args.out}; ok={report['ok']}", flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
