"""Trajectory-field plots and training dashboards (port of
``tpu_plume/viz/plots.py``), headless (Agg backend, PNG output).
matplotlib, and pandas for the curves, are imported when a plot is drawn,
so that importing the port needs neither.

Reference components reproduced:

  - ``plot_gaussian_field`` — PPOV2.1/check_gaussian.py:5-29: render an
    episode's trajectory, the source marker, and optional stop position over
    the reconstructed concentration field.
  - ``training_dashboard`` — the V1.0 live 2-pane matplotlib dashboard
    (PPOV1.0/ppo0.0.py:299-301, 410-462): reward scatter + field/trajectory/
    radius overlay, emitted as a snapshot PNG instead of an interactive
    window (this framework trains headless at thousands of envs).
  - ``plot_training_curves`` — reward / success-rate / radius curves from the
    training_results CSV.
"""

from __future__ import annotations

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _episode_field(nc_data: dict, episode: int, grid_size: int):
    """Reconstruct the episode's mean concentration field from the NetCDF
    per-episode Gaussian parameters (falls back to sigma=15, peak=100)."""
    sx = float(nc_data["source_x"][episode])
    sy = float(nc_data["source_y"][episode])
    sigma = float(nc_data.get("gaussian_sigma", [15.0] * (episode + 1))[episode])
    peak = float(nc_data.get("peak_concentration", [100.0] * (episode + 1))[episode])
    ix, iy = np.mgrid[:grid_size, :grid_size]
    d2 = (ix - sx) ** 2 + (iy - sy) ** 2
    return peak * np.exp(-d2 / (2 * sigma**2)), (sx, sy)


def plot_gaussian_field(
    nc_file: str,
    episode: int,
    stop_pos=None,
    traj_xy=None,
    save_path: str = "gaussian_field.png",
):
    """Reference check_gaussian.plot_gaussian_field signature
    (PPOV2.1/check_gaussian.py:5-29, called from evaluate_with_lstm.py:101-107)."""
    from tpu_plume_torch.data.netcdf import read_nc

    plt = _mpl()
    data = read_nc(nc_file)
    grid = int(data["__attrs__"].get("GRID_SIZE", 500))
    field, (sx, sy) = _episode_field(data, episode, grid)

    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(field.T, origin="lower", cmap="viridis", extent=[0, grid, 0, grid])
    fig.colorbar(im, ax=ax, label="concentration")
    if traj_xy is None:
        x = data["x"][episode]
        y = data["y"][episode]
        valid = ~np.isnan(x)
        traj_xy = np.stack([x[valid], y[valid]], axis=-1)
    if len(traj_xy):
        ax.plot(traj_xy[:, 0], traj_xy[:, 1], "w-", lw=0.8, alpha=0.8, label="trajectory")
        ax.plot(traj_xy[0, 0], traj_xy[0, 1], "go", ms=6, label="start")
    ax.plot(sx, sy, "r*", ms=14, label="source")
    if stop_pos is not None:
        ax.plot(stop_pos[0], stop_pos[1], "ws", ms=8, label="stop")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title(f"episode {episode}")
    fig.savefig(save_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return save_path


def plot_training_curves(csv_path: str, save_path: str = "training_curves.png", window: int = 100):
    """Reward / success-rate / radius / steps curves from the reference-schema
    training_results CSV."""
    import pandas as pd

    plt = _mpl()
    df = pd.read_csv(csv_path)
    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    ax = axes[0, 0]
    ax.plot(df.Episode, df.Total_Reward, lw=0.3, alpha=0.4)
    ax.plot(df.Episode, df.Total_Reward.rolling(window, min_periods=1).mean(), lw=1.5)
    ax.set_title("total reward / episode")
    ax = axes[0, 1]
    ax.plot(df.Episode, df.Success.rolling(window, min_periods=1).mean(), lw=1.5, color="tab:green")
    ax.axhline(0.6, ls="--", lw=0.8, color="gray")
    ax.set_title(f"success rate (rolling {window})")
    ax.set_ylim(0, 1)
    ax = axes[1, 0]
    ax.plot(df.Episode, df.Current_Radius, lw=1.2, color="tab:red")
    ax.set_title("curriculum radius")
    ax = axes[1, 1]
    ax.plot(df.Episode, df.Steps.rolling(window, min_periods=1).mean(), lw=1.2, color="tab:purple")
    ax.set_title(f"steps / episode (rolling {window})")
    for a in axes.flat:
        a.set_xlabel("episode")
    fig.tight_layout()
    fig.savefig(save_path, dpi=110)
    plt.close(fig)
    return save_path


def training_dashboard(
    episode_rewards,
    conc_field: np.ndarray,
    trajectory: np.ndarray,
    source_pos,
    radius: float,
    save_path: str = "dashboard.png",
):
    """V1.0-style 2-pane dashboard snapshot (PPOV1.0/ppo0.0.py:410-462):
    left = reward scatter, right = field + trajectory + curriculum circle."""
    plt = _mpl()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    rewards = np.asarray(episode_rewards)
    ax1.scatter(np.arange(len(rewards)), rewards, s=4, alpha=0.5)
    if len(rewards) > 10:
        k = max(len(rewards) // 50, 1)
        smooth = np.convolve(rewards, np.ones(k) / k, mode="valid")
        ax1.plot(np.arange(len(smooth)) + k - 1, smooth, "r-", lw=1.2)
    ax1.set_title("episode rewards")
    ax1.set_xlabel("episode")

    g = conc_field.shape[0]
    im = ax2.imshow(conc_field.T, origin="lower", cmap="viridis", extent=[0, g, 0, g])
    fig.colorbar(im, ax=ax2, label="concentration")
    if len(trajectory):
        ax2.plot(trajectory[:, 0], trajectory[:, 1], "w-", lw=0.8)
    ax2.plot(source_pos[0], source_pos[1], "r*", ms=14)
    circle = plt.Circle(source_pos, radius, fill=False, color="red", ls="--", lw=1.0)
    ax2.add_patch(circle)
    ax2.set_title(f"field + trajectory (radius {radius:.1f})")
    fig.tight_layout()
    fig.savefig(save_path, dpi=110)
    plt.close(fig)
    return save_path
