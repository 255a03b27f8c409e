"""One real fine-tune on a device mesh, end to end: the twin of ``tools/finetune_demo.py``.

The task is the reference's (``finetune_demo.py:60-104``, copied here:
:data:`FAMILIES`, :data:`FILLER`, :func:`make_dataset`, :func:`macro_f1`;
the same seed gives the same texts and labels): synthetic keyword
sentiment, where each text mixes neutral filler with keywords of up to
three of the six tracked emotion families and the multi-hot label marks
which appear.  The loop, as the reference's (``:164-240``):

1. the encoder (``--config tiny``: TINY_TEST; ``roberta``:
   ROBERTA_GO_EMOTIONS, bf16 matmuls over float32 parameters) with
   ``--attention dense`` (the reference's default) or ``flash`` (B1, B4
   and B5 on each model shard's heads on the card), trained by
   :func:`svoc_torch.train.trainer.make_sharded_train_step` on a
   ``data(4) × model(2)`` mesh of slots of the device
   (:func:`svoc_torch.parallel.mesh.make_mesh`), with AdamW, to a target
   macro-F1 over the six tracked labels; ``--zero1`` also splits the
   optimizer state over the data axis;
2. a mid-run :func:`svoc_torch.utils.checkpoint.save_train_state`
   (written whole); (a) restored onto the same mesh, the remaining steps
   replayed must give the uninterrupted run's final parameters exactly
   (``same_mesh_replay_max_abs_param_delta`` 0.0); (b) restored onto a
   ``data(2) × model(4)`` mesh, the parameters must equal the
   checkpointed ones exactly (``changed_mesh_restore_max_abs_param_delta``
   0.0), and five more steps train from them.

Usage::

    python -m svoc_torch.tools.finetune_demo [--steps 240] [--batch 32] [--target-f1 0.9] [--zero1]
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
    """Largest absolute difference between two dicts of whole tensors."""
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def encoder_config(config: str, attention: str):
    from svoc_torch.models.configs import ROBERTA_GO_EMOTIONS, TINY_TEST

    configs = {"tiny": TINY_TEST, "roberta": ROBERTA_GO_EMOTIONS}
    if config not in configs:
        raise ValueError(f"config must be one of {sorted(configs)} (got {config!r})")
    return dataclasses.replace(configs[config], attention=attention)


#: The two layouts of the reference's demo: the training mesh and the
#: changed mesh of the restore (``finetune_demo.py:172, 221``).
TRAIN_MESH, CHANGED_MESH = (4, 2), (2, 4)


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
    on_step: Optional[Callable[[int], None]] = None,
) -> dict:
    """The fine-tune on a ``data(4) × model(2)`` mesh, its mid-run
    checkpoint, the same-mesh replay and the changed-mesh restore;
    returns the report (the reference's keys, plus the device, the
    attention and the timing).  The weights are ``init_params(cfg,
    seed=0)``; ``on_step(i)`` runs before each step of the uninterrupted
    run."""
    import torch

    from svoc_torch.device import resolve_device
    from svoc_torch.models.encoder import SentimentEncoder, init_params, load_encoder
    from svoc_torch.models.sentiment import TRACKED_INDICES
    from svoc_torch.models.tokenizer import load_tokenizer
    from svoc_torch.parallel.mesh import MeshSpec, make_mesh
    from svoc_torch.train.trainer import Batch, adamw, init_state, make_sharded_train_step
    from svoc_torch.utils.checkpoint import restore_train_state, save_train_state

    device = resolve_device(device)
    if steps < 2:
        raise ValueError(f"the mid-run checkpoint needs at least 2 steps (got {steps})")
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

    def build(shape):
        mesh = make_mesh(MeshSpec(("data", "model"), shape), device=device)
        step_fn, shard_state, _ = make_sharded_train_step(cfg, mesh, params_template=params, zero1=zero1)
        return step_fn, shard_state

    def fresh_state():
        with torch.device("meta"):
            model = SentimentEncoder(cfg)
        return init_state(model, params, adamw(lr), device=device)

    def whole(state):
        return {name: arr.gather() for name, arr in state.params.items()}

    def evaluate(state) -> float:
        model = load_encoder(SentimentEncoder, cfg, whole(state))
        with torch.no_grad():
            logits = model(eval_ids, eval_mask)
        pred = (torch.sigmoid(logits.float()) > 0.5).float().cpu().numpy()
        idx = list(TRACKED_INDICES)
        return macro_f1(pred[:, idx], eval_labels[:, idx])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    step_fn, shard_state = build(TRAIN_MESH)
    state = shard_state(fresh_state())
    f1_before = evaluate(state)
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
                mid_params = {k: v.clone() for k, v in whole(state).items()}
        sync()
        train_s = time.perf_counter() - t0
        f1_after = evaluate(state)

        # (a) Same-mesh restore and replay: bit-identical final parameters.
        restored = shard_state(restore_train_state(ckpt, fresh_state()))
        gen2 = batches(seed=1)
        for _ in range(half):
            next(gen2)  # the first half's batches
        for _ in range(half, steps):
            restored, _ = step_fn(restored, next(gen2))
        replay_delta = max_abs_param_delta(whole(restored), whole(state))
        del restored

        # (b) Changed-mesh restore, 4x2 -> 2x4: the values re-sharded
        # exactly, and training continues from them.
        step_b, shard_b = build(CHANGED_MESH)
        restored_b = shard_b(restore_train_state(ckpt, fresh_state()))
    mesh_delta = max_abs_param_delta(whole(restored_b), mid_params)
    cont_losses = []
    gen3 = batches(seed=3)
    for _ in range(5):
        restored_b, m = step_b(restored_b, next(gen3))
        cont_losses.append(float(m["loss"]))
    finite = bool(np.isfinite(losses).all() and np.isfinite(cont_losses).all())
    ok = (f1_after >= target_f1 and replay_delta == 0.0 and mesh_delta == 0.0
          and cont_losses[-1] < losses[half - 1] * 1.5 and finite)
    return {
        "task": "synthetic keyword sentiment (6 tracked families)",
        "config": f"{config} encoder ({cfg.n_layers}L/{cfg.hidden}H, {cfg.attention} attention), "
                  f"data({TRAIN_MESH[0]})xmodel({TRAIN_MESH[1]}) mesh of slots of {device}",
        "zero1_opt_sharding": bool(zero1),
        "steps": steps,
        "batch": batch,
        "loss_curve": [round(x, 4) for x in losses],
        "macro_f1_before": round(f1_before, 4),
        "macro_f1_after": round(f1_after, 4),
        "target_f1": target_f1,
        "same_mesh_replay_max_abs_param_delta": replay_delta,
        "changed_mesh_restore_max_abs_param_delta": mesh_delta,
        "changed_mesh_continued_losses": [round(x, 4) for x in cont_losses],
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
    p.add_argument("--zero1", action="store_true",
                   help="shard the optimizer state over the data axis (ZeRO-1): the same update math, "
                        "about 1/D of the optimizer state a slot at rest")
    args = p.parse_args(argv)
    report = run(steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr, target_f1=args.target_f1,
                 eval_n=args.eval_n, config=args.config, attention=args.attention, device=args.device,
                 zero1=args.zero1)
    losses = report["loss_curve"]
    print(f"[finetune] loss {losses[0]:.3f} -> {losses[-1]:.3f}; macro-F1 {report['macro_f1_before']:.3f} "
          f"-> {report['macro_f1_after']:.3f}", flush=True)
    print(f"[finetune] same-mesh replay max|dparams| = {report['same_mesh_replay_max_abs_param_delta']:.2e}",
          flush=True)
    print(f"[finetune] changed-mesh restore max|dparams| = "
          f"{report['changed_mesh_restore_max_abs_param_delta']:.2e}; continued losses "
          f"{report['changed_mesh_continued_losses']}", flush=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[finetune] wrote {args.out}; ok={report['ok']}", flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
