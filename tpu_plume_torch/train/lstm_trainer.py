"""Stop-LSTM training (port of ``tpu_plume/train/lstm_trainer.py``).

The reference's pipelines:

  - ``train_threshold_lstm``, V2.0 (PPOV2.0/train_lstm.py:52-99): last-10
    windows, a global MinMaxScaler, SmoothL1(beta=2), AdamW lr 3e-4,
    ReduceLROnPlateau(factor .5, patience 5), grad-clip 1.0, 150 epochs;
    saves the model and the scaler's params;
  - ``train_sequence_lstm``, V1.2 (PPOV1.2/new.LSTM.py:18-116): the source
    concentration from the whole variable-length episode sequence;
  - ``train_peak_stop_lstm``, V2.1 (PPOV2.1/train_lstm.py:76-125): pos/neg
    20-step windows, MSE(peak) + BCE(stop), AdamW lr 1e-3 wd 1e-4,
    best-loss checkpointing, 100 epochs;
  - ``train_source_lstm``: the ``GaussianParamPredictor`` as a source
    localizer on flight windows.

Each keeps the JAX trainer's seeds, batch sizes, weight decays, schedule,
best-loss selection and reports.  The optimizer is JAX's chain written out:
global-norm clip, Adam (eps 1e-8), then ``p -= lr * (u + wd * p)``.  Every
minibatch step runs on the trainer's device; the host reads the loss once
an epoch, as JAX does.  The init is drawn on the CPU from ``seed``
(``reset_parameters``), so it is the same on every device; the threshold
net's dropout draws from a ``torch.Generator`` on the device seeded from
``seed``.  A ``torch.save`` of the model's state_dict (``<name>.pt``, the
reference layout) takes the place of each Orbax checkpoint of the JAX
package; the ``.pth`` files, ``scaler_params.npy`` and
``localizer_meta.npz`` are written where JAX writes them.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from tpu_plume_torch.core.device import resolve_device
from tpu_plume_torch.data.datasets import (
    peak_stop_dataset,
    read_variables,
    source_windows,
    tail_window_dataset,
)
from tpu_plume_torch.data.scaler import MinMaxScaler
from tpu_plume_torch.models.lstm_zoo import (
    ConcentrationThresholdPredictor,
    GaussianParamPredictor,
    LSTMModel,
    PeakAndStopPredictor,
)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float) -> torch.Tensor:
    """torch.nn.SmoothL1Loss(beta): 0.5 x^2/beta for |x|<beta else |x|-beta/2."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff**2 / beta,
                       diff - 0.5 * beta).mean()


def bce(prob: torch.Tensor, target: torch.Tensor,
        eps: float = 1e-7) -> torch.Tensor:
    p = prob.clamp(eps, 1.0 - eps)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p)).mean()


class ReduceLROnPlateau:
    """JAX's host-side scheduler (mode=min, no relative threshold: torch's
    own cuts on other epochs)."""

    def __init__(self, lr: float, factor: float = 0.5, patience: int = 5):
        self.lr, self.factor, self.patience = lr, factor, patience
        self.best = float("inf")
        self.bad = 0

    def step(self, loss: float) -> float:
        if loss < self.best:
            self.best, self.bad = loss, 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.lr *= self.factor
                self.bad = 0
        return self.lr


class ClippedAdamW:
    """JAX's ``_make_optimizer``: ``clip_by_global_norm(clip)`` (gradients
    scaled by ``clip / norm`` when the norm reaches ``clip``; ``clip=None``
    skips it, ``optax.adamw`` alone), optax's ``scale_by_adam`` (b1 .9, b2
    .999, eps 1e-8), then ``p -= lr * (u + wd * p)``, over the trainable
    parameters, in foreach launches with no host read."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, weight_decay: float, clip: float | None):
        self.params = [p for p in params if p.requires_grad]
        self.weight_decay, self.clip = weight_decay, clip
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, lr: float):
        # a parameter the loss does not reach steps on a zero gradient, as
        # in optax (its weight decay still applies)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.clip is not None:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            torch._foreach_mul_(grads, torch.where(norm < self.clip, 1.0,
                                                   self.clip / norm))
        self.count += 1
        torch._foreach_lerp_(self.mu, grads, 1.0 - self.B1)
        torch._foreach_mul_(self.nu, self.B2)
        torch._foreach_addcmul_(self.nu, grads, grads, 1.0 - self.B2)
        c1 = 1.0 - self.B1 ** self.count
        c2 = 1.0 - self.B2 ** self.count
        mu_hat = torch._foreach_div(self.mu, c1)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, c2))
        torch._foreach_add_(denom, self.EPS)
        u = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(u, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, u, alpha=-lr)


@dataclasses.dataclass
class LSTMTrainResult:
    state_dict: dict        # the selected model's, on the CPU
    losses: list
    out_dir: str
    extra: dict


def _shuffle_batches(rng: np.random.Generator, n: int, batch: int):
    perm = rng.permutation(n)
    usable = (n // batch) * batch
    if usable == 0:
        raise ValueError(f"dataset of {n} samples smaller than batch {batch}")
    return perm[:usable].reshape(-1, batch)


def _init(model, seed: int, device):
    return model.reset_parameters(torch.Generator().manual_seed(seed)).to(device)


def _run_epoch(model, opt, lr: float, idx: np.ndarray, loss_fn, *tensors):
    """One epoch over the minibatches ``idx`` [S, B] of ``tensors``; the
    mean of the S minibatch losses, as a device scalar."""
    model.train()
    idx = torch.from_numpy(idx).to(tensors[0].device)
    losses = []
    for rows in idx:
        opt.zero_grad()
        loss = loss_fn(*(t[rows] for t in tensors))
        loss.backward()
        opt.step(lr)
        losses.append(loss.detach())
    return torch.stack(losses).mean()


def _cpu_state(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _save(state_dict: dict, *parts):
    path = os.path.join(*parts)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(state_dict, path)


def _r2(pred: np.ndarray, y: np.ndarray) -> float:
    ss_tot = float(((y - y.mean()) ** 2).sum())
    return 1.0 - float(((pred - y) ** 2).sum()) / ss_tot if ss_tot > 0 else float("nan")


def train_threshold_lstm(
    sequences,
    source_concs,
    out_dir: str,
    *,
    window: int = 10,
    epochs: int = 150,
    batch_size: int = 64,
    lr: float = 3e-4,
    seed: int = 0,
    verbose: bool = False,
    device=None,
) -> LSTMTrainResult:
    """V2.0 pipeline from raw sequences (as ``load_raw_sequences`` returns
    them)."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    # the reference drops short sequences (train_lstm.py:57-61)
    pairs = [(s, c) for s, c in zip(sequences, source_concs) if len(s) >= window]
    feats, targs = tail_window_dataset(
        [p[0] for p in pairs], np.array([p[1] for p in pairs]), window)
    scaler = MinMaxScaler().fit(feats.reshape(-1, 1))
    feats = scaler.transform(feats.reshape(-1, 1)).reshape(feats.shape).astype(np.float32)

    model = _init(ConcentrationThresholdPredictor(), seed, device)
    opt = ClippedAdamW(model.parameters(), weight_decay=1e-2, clip=1.0)
    gen = torch.Generator(device=device).manual_seed(seed)

    def loss_fn(x, y):
        return smooth_l1(model(x, generator=gen), y, beta=2.0)

    rng = np.random.default_rng(seed)
    sched = ReduceLROnPlateau(lr)
    x_dev = torch.from_numpy(feats).to(device)
    y_dev = torch.from_numpy(targs).to(device)
    losses, cur_lr = [], lr
    for epoch in range(epochs):
        idx = _shuffle_batches(rng, len(feats), min(batch_size, len(feats)))
        loss = float(_run_epoch(model, opt, cur_lr, idx, loss_fn, x_dev, y_dev))
        losses.append(loss)
        cur_lr = sched.step(loss)
        if verbose and (epoch + 1) % 10 == 0:
            print(f"epoch {epoch + 1}, loss {loss:.4f}, lr {cur_lr:.2e}")

    state = _cpu_state(model)
    _save(state, out_dir, "lstm_threshold_predictor.pt")
    scaler.save(os.path.join(out_dir, "scaler_params.npy"))
    # the reference's artifact (PPOV2.0/train_lstm.py:98)
    _save(state, out_dir, "model", "lstm_threshold_predictor.pth")

    # R^2 of the training fit (the reference README claims 0.82 on test)
    model.eval()
    with torch.no_grad():
        pred = model(x_dev).cpu().numpy()
    return LSTMTrainResult(state_dict=state, losses=losses, out_dir=out_dir,
                           extra={"r2": _r2(pred, targs), "scaler": scaler})


def train_sequence_lstm(
    sequences,
    source_concs,
    out_dir: str,
    *,
    epochs: int = 50,
    batch_size: int = 32,
    lr: float = 1e-3,
    test_fraction: float = 0.2,
    seed: int = 42,
    verbose: bool = False,
    device=None,
) -> LSTMTrainResult:
    """V1.2 prototype pipeline (PPOV1.2/new.LSTM.py:18-116): the source
    concentration from the whole (variable-length) episode sequence; inputs
    min-max scaled, a train/test split, MSE; reports the test set's R^2 (the
    reference README claims 0.82, README.md:37)."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    lengths = np.array([len(s) for s in sequences], np.int32)
    max_len = int(lengths.max())
    scaler = MinMaxScaler().fit(np.concatenate([np.asarray(s) for s in sequences]))
    padded = np.zeros((len(sequences), max_len), np.float32)
    for i, s in enumerate(sequences):
        padded[i, : len(s)] = scaler.transform(np.asarray(s))
    targets = np.asarray(source_concs, np.float32)

    rng = np.random.default_rng(seed)
    order = rng.permutation(len(sequences))
    n_test = max(1, int(len(sequences) * test_fraction))
    test_idx, train_idx = order[:n_test], order[n_test:]

    model = _init(LSTMModel(), seed, device)
    opt = ClippedAdamW(model.parameters(), weight_decay=0.0, clip=1.0)

    def loss_fn(x, ln, y):
        return ((model(x, ln) - y) ** 2).mean()

    train = [torch.from_numpy(a[train_idx]).to(device)
             for a in (padded, lengths, targets)]
    bs = min(batch_size, len(train_idx))
    losses = []
    for epoch in range(epochs):
        idx = _shuffle_batches(rng, len(train_idx), bs)
        losses.append(float(_run_epoch(model, opt, lr, idx, loss_fn, *train)))
        if verbose and (epoch + 1) % 10 == 0:
            print(f"epoch {epoch + 1}, loss {losses[-1]:.4f}")

    model.eval()
    with torch.no_grad():
        pred = model(torch.from_numpy(padded[test_idx]).to(device),
                     torch.from_numpy(lengths[test_idx]).to(device))
    pred = pred.cpu().numpy()
    y = targets[test_idx]
    state = _cpu_state(model)
    _save(state, out_dir, "lstm_v12.pt")
    scaler.save(os.path.join(out_dir, "scaler_params_v12.npy"))
    return LSTMTrainResult(state_dict=state, losses=losses, out_dir=out_dir,
                           extra={"test_r2": _r2(pred, y),
                                  "test_mse": float(((pred - y) ** 2).mean())})


def _train_best(model, opt, lr, epochs, bs, rng, loss_fn, verbose, fmt,
                *tensors):
    """The plateau-scheduled epochs with best-loss selection of the V2.1
    trainers: (losses, best loss, the best epoch's state on the CPU; it is
    kept on the device until the end)."""
    sched = ReduceLROnPlateau(lr)
    losses, best_loss = [], float("inf")
    best = {k: v.detach().clone() for k, v in model.state_dict().items()}
    cur_lr = lr
    for epoch in range(epochs):
        idx = _shuffle_batches(rng, len(tensors[0]), bs)
        loss = float(_run_epoch(model, opt, cur_lr, idx, loss_fn, *tensors))
        losses.append(loss)
        cur_lr = sched.step(loss)
        if loss < best_loss:  # best-loss checkpointing (train_lstm.py:122-124)
            best_loss = loss
            for k, v in model.state_dict().items():
                best[k].copy_(v)
        if verbose and (epoch + 1) % 10 == 0:
            print(f"epoch {epoch + 1}, loss {loss:{fmt}}, lr {cur_lr:.2e}")
    return losses, best_loss, {k: v.cpu() for k, v in best.items()}


def train_peak_stop_lstm(
    segments,
    out_dir: str,
    *,
    window: int = 20,
    epochs: int = 100,
    batch_size: int = 64,
    lr: float = 1e-3,
    seed: int = 0,
    verbose: bool = False,
    bug_compat_dataset: bool = False,
    device=None,
) -> LSTMTrainResult:
    """V2.1 pipeline from trajectory segments (as
    ``load_trajectory_segments`` returns them)."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    feats, labels = peak_stop_dataset(
        segments, window_size=window, rng=np.random.default_rng(seed),
        bug_compat=bug_compat_dataset)
    if len(feats) == 0:
        raise ValueError("no training samples collected — check window_size / data")

    model = _init(PeakAndStopPredictor(), seed, device)
    opt = ClippedAdamW(model.parameters(), weight_decay=1e-4, clip=1.0)

    def loss_fn(x, y):
        peak, stop = model(x)
        return ((peak - y[:, 0]) ** 2).mean() + bce(stop, y[:, 1])

    losses, best_loss, best = _train_best(
        model, opt, lr, epochs, min(batch_size, len(feats)),
        np.random.default_rng(seed), loss_fn, verbose, ".4f",
        torch.from_numpy(feats).to(device), torch.from_numpy(labels).to(device))
    _save(best, out_dir, "best_peak_and_stop.pt")
    # the reference's artifact (PPOV2.1/train_lstm.py:122-124)
    _save(best, out_dir, "model", "best_peak_and_stop.pth")
    return LSTMTrainResult(state_dict=best, losses=losses, out_dir=out_dir,
                           extra={"best_loss": best_loss})


def _flight_tail_dataset(
    flights_path: str,
    window: int,
    grid_size: float,
    conc_peak: float,
    rng: np.random.Generator,
    augment: int = 2,
    features: str = "xyc",
):
    """Tail windows from ``eval --save-flights`` npz files ([K, T, 3]
    trajectories and [K, 2] sources, several joined by ':'), the
    distribution the localizer sees at eval time.  ``features`` "xyc" is
    normalized (x, y, conc), the reference layout; "xycd" appends the
    per-step deltas (dx, dy, dconc), taken over the whole flight before the
    tail is cut."""
    parts = [np.load(p) for p in flights_path.split(":")]
    trajs = np.concatenate([p["trajectories"] for p in parts], axis=0)
    srcs = np.concatenate([p["sources"] for p in parts], axis=0)
    dim = 6 if features == "xycd" else 3
    feats, lens, targets, groups = [], [], [], []
    for i in range(trajs.shape[0]):
        valid = np.isfinite(trajs[i, :, 0])
        rows = trajs[i, valid]
        if len(rows) < 8:
            continue
        tgt = (srcs[i] / grid_size).astype(np.float32)
        norm = rows / np.array([grid_size, grid_size, conc_peak])
        dn = np.zeros_like(norm)
        dn[1:] = norm[1:] - norm[:-1]
        cand = [min(len(rows), window)]
        cand += [int(rng.integers(8, min(len(rows), window) + 1))
                 for _ in range(augment)]
        for length in cand:
            start = len(rows) - length
            w = np.zeros((window, dim), np.float32)
            w[:length, :3] = norm[start:]
            if dim == 6:
                w[:length, 3:] = dn[start:]
            feats.append(w)
            lens.append(length)
            targets.append(tgt)
            groups.append(i)
    if not feats:
        return (np.zeros((0, window, dim), np.float32),
                np.zeros((0,), np.int32), np.zeros((0, 2), np.float32),
                np.zeros((0,), np.int32))
    return (np.stack(feats), np.asarray(lens, np.int32), np.stack(targets),
            np.asarray(groups, np.int32))


def train_source_lstm(
    nc,
    out_dir: str,
    *,
    flights_path: str | None = None,
    window: int = 64,
    per_episode: int = 6,
    epochs: int = 100,
    batch_size: int = 256,
    lr: float = 1e-3,
    seed: int = 0,
    grid_size: float = 500.0,
    conc_peak: float = 100.0,
    val_frac: float = 0.1,
    verbose: bool = False,
    features: str = "xyc",
    hidden: int = 32,
    device=None,
) -> LSTMTrainResult:
    """The ``GaussianParamPredictor`` (PPOV2.1/model.py:308-322, untrained
    in the reference) as a source localizer: windows of normalized (x, y,
    conc) flight samples -> (mu_x, mu_y), position MSE on the first two
    outputs; reports the held-out localization error in grid units.

    Data: a trajectory capture ``nc`` (a ``training_data.nc`` path, or a
    mapping of its variables) or the evaluated policy's own flights
    (``flights_path``, from ``eval --save-flights``)."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    rng0 = np.random.default_rng(seed)
    if flights_path is not None:
        feats, lens, targets, groups = _flight_tail_dataset(
            flights_path, window, grid_size, conc_peak, rng0,
            features=features)
    else:
        if features != "xyc":
            raise ValueError("--features xycd needs --flights data")
        if isinstance(nc, str):
            nc = read_variables(nc, ("x", "y", "concentration", "source_x",
                                     "source_y"))
        feats, lens, targets, groups = source_windows(
            nc, window_size=window, per_episode=per_episode,
            grid_size=grid_size, conc_peak=conc_peak, rng=rng0)
    if len(feats) == 0:
        raise ValueError("no training windows — check the NC file / window size")
    rng = np.random.default_rng(seed)
    # Split by flight: a flight's windows overlap, so a window-level split
    # would leak every val flight into train.
    uniq = np.unique(groups)
    gperm = rng.permutation(len(uniq))
    n_val_groups = min(len(uniq) - 1, max(1, int(len(uniq) * val_frac))) or 1
    val_mask = np.isin(groups, uniq[gperm[:n_val_groups]])
    val_idx = np.where(val_mask)[0]
    train_idx = np.where(~val_mask)[0]
    if len(train_idx) == 0:  # one flight: a window-level split
        perm = rng.permutation(len(feats))
        n_val = max(1, int(len(feats) * val_frac))
        val_idx, train_idx = perm[:n_val], perm[n_val:]

    model = _init(GaussianParamPredictor(hidden_size=hidden,
                                         input_size=feats.shape[-1]),
                  seed, device)
    opt = ClippedAdamW(model.parameters(), weight_decay=1e-4, clip=1.0)

    def loss_fn(x, ln, y):
        return ((model(x, ln)[:, :2] - y) ** 2).mean()

    losses, best_loss, best = _train_best(
        model, opt, lr, epochs, min(batch_size, len(train_idx)), rng,
        loss_fn, verbose, ".5f",
        *(torch.from_numpy(a[train_idx]).to(device)
          for a in (feats, lens, targets)))
    model.load_state_dict(best)
    model.eval()
    with torch.no_grad():
        pred = model(torch.from_numpy(feats[val_idx]).to(device),
                     torch.from_numpy(lens[val_idx]).to(device))
    pred = pred[:, :2].cpu().numpy()
    val_err = np.linalg.norm((pred - targets[val_idx]) * grid_size, axis=-1)

    _save(best, out_dir, "gaussian_params.pt")
    # The measured validation error beside the checkpoint: the learned
    # guide derives its stability gate from it at eval time.
    np.savez(
        os.path.join(out_dir, "localizer_meta.npz"),
        val_mean_err_px=float(val_err.mean()),
        val_median_err_px=float(np.median(val_err)),
        window=window,
        grid_size=grid_size,
        conc_peak=conc_peak,
        features=features,
        hidden=hidden,
    )
    return LSTMTrainResult(
        state_dict=best, losses=losses, out_dir=out_dir,
        extra={"best_loss": best_loss,
               "val_mean_err_px": float(val_err.mean()),
               "val_median_err_px": float(np.median(val_err))})
