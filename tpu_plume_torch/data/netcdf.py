"""NetCDF-4 trajectory dataset writer and reader (the port's copy of
``tpu_plume/data/netcdf.py``, h5py backend), and the same episodes held in
memory.

Schema of the reference ``NetCDFWriter`` (PPOV2.0/netcdf_writer.py:4-118;
V2.1's gaussian_sigma / peak_concentration, PPOV2.1/model.py:351-422;
PPOV2.1/nc_info.txt:1-48):

    dims:  episode (max_episodes), step (max_steps)
    vars:  episode i32[episode]; step i32[step];
           x, y, concentration f32[episode, step]  (_FillValue NaN, gzip 4);
           is_source i8[episode, step]             (_FillValue 0, gzip 4);
           source_concentration, source_x, source_y f32[episode] (_FillValue NaN);
           gaussian_sigma, peak_concentration f32[episode]        (V2.1)
    attrs: GRID_SIZE (global); units/long_name per variable.

NetCDF-4 is HDF5: the file is written through h5py with HDF5 dimension
scales and gzip.  h5py is imported where a file is opened, so the port
imports without it; ``EpisodeArrays`` keeps the same episodes as numpy
arrays for a machine that has no h5py.
"""

from __future__ import annotations

import numpy as np

VAR_META = {
    "episode": dict(long_name="Training episode index"),
    "step": dict(long_name="Step index within episode"),
    "x": dict(units="grid unit", long_name="Agent x-coordinate"),
    "y": dict(units="grid unit", long_name="Agent y-coordinate"),
    "concentration": dict(long_name="Methane concentration"),
    "is_source": dict(long_name="Source position flag"),
    "source_concentration": dict(long_name="Actual source concentration in each episode"),
    "source_x": dict(long_name="Actual source x-coordinate"),
    "source_y": dict(long_name="Actual source y-coordinate"),
    "gaussian_sigma": dict(long_name="Gaussian distribution standard deviation"),
    "peak_concentration": dict(units="ppm", long_name="Source peak concentration"),
}
# sigma and peak of a V2.1 episode written without them
DEFAULT_SIGMA, DEFAULT_PEAK = 15.0, 100.0


def require_h5py(what: str):
    """The h5py module; without it a ``RuntimeError`` that names ``what``,
    as the JAX package's writer raises."""
    try:
        import h5py
    except ImportError:
        raise RuntimeError(f"h5py is required for {what}") from None
    return h5py


class NetCDFWriter:
    """The reference writer.  ``with_gaussian_params=True`` adds the V2.1
    per-episode sigma and peak variables (PPOV2.1/model.py:394-403)."""

    def __init__(
        self,
        filename: str,
        grid_size: int,
        max_episodes: int = 2000,
        max_steps: int = 1000,
        with_gaussian_params: bool = False,
    ):
        h5py = require_h5py("NetCDF output")
        self.filename = filename
        self.max_episodes = max_episodes
        self.max_steps = max_steps
        self.with_gaussian_params = with_gaussian_params

        f = h5py.File(filename, "w")
        self._f = f
        f.attrs["GRID_SIZE"] = np.int64(grid_size)

        # Coordinate variables double as NetCDF dimensions (HDF5 dim scales).
        ep = f.create_dataset("episode", data=np.arange(max_episodes, dtype=np.int32))
        st = f.create_dataset("step", data=np.arange(max_steps, dtype=np.int32))
        ep.make_scale("episode")
        st.make_scale("step")
        self._scales = {"episode": ep, "step": st}

        for name in ("x", "y", "concentration"):
            self._create(name, ("episode", "step"), np.float32, np.nan)
        self._create("is_source", ("episode", "step"), np.int8, np.int8(0))
        for name in ("source_concentration", "source_x", "source_y"):
            self._create(name, ("episode",), np.float32, np.nan)
        if with_gaussian_params:
            self._create("gaussian_sigma", ("episode",), np.float32, None)
            self._create("peak_concentration", ("episode",), np.float32, None)
        for name, meta in VAR_META.items():
            if name in f:
                for k, v in meta.items():
                    f[name].attrs[k] = v

    def _create(self, name, dims, dtype, fill):
        shape = tuple(len(self._scales[d]) for d in dims)
        ds = self._f.create_dataset(name, shape=shape, dtype=dtype,
                                    fillvalue=fill, compression="gzip",
                                    compression_opts=4, chunks=True)
        if fill is not None:
            ds.attrs["_FillValue"] = np.array(fill, dtype=dtype)
        for i, d in enumerate(dims):
            ds.dims[i].attach_scale(self._scales[d])

    def write_episode_data(
        self,
        episode_idx: int,
        steps: int,
        x: np.ndarray,
        y: np.ndarray,
        conc: np.ndarray,
        source_x: float,
        source_y: float,
        source_conc: float,
        sigma: float | None = None,
        peak: float | None = None,
    ):
        """The reference's write_episode_data (netcdf_writer.py:89-114):
        the per-step arrays up to ``steps``, the final step overwritten with
        the source coordinates and flagged in ``is_source``."""
        f = self._f
        f["x"][episode_idx, :steps] = np.asarray(x, np.float32)
        f["y"][episode_idx, :steps] = np.asarray(y, np.float32)
        f["concentration"][episode_idx, :steps] = np.asarray(conc, np.float32)
        f["is_source"][episode_idx, steps - 1] = 1
        f["x"][episode_idx, steps - 1] = source_x
        f["y"][episode_idx, steps - 1] = source_y
        f["source_concentration"][episode_idx] = source_conc
        f["source_x"][episode_idx] = source_x
        f["source_y"][episode_idx] = source_y
        if self.with_gaussian_params:
            f["gaussian_sigma"][episode_idx] = DEFAULT_SIGMA if sigma is None else sigma
            f["peak_concentration"][episode_idx] = DEFAULT_PEAK if peak is None else peak

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class EpisodeArrays:
    """The episodes a ``NetCDFWriter`` writes, kept as numpy arrays: the
    same ``write_episode_data`` calls, and ``arrays()`` gives the file's
    variables over the episodes written so far, as ``read_nc`` reads them
    (rows past the last written episode, all fill values, left out)."""

    def __init__(self, max_steps: int, with_gaussian_params: bool = False):
        self.max_steps = max_steps
        self.with_gaussian_params = with_gaussian_params
        self._rows: dict[int, tuple] = {}

    def __len__(self) -> int:
        return len(self._rows)

    def write_episode_data(self, episode_idx: int, steps: int, x, y, conc,
                           source_x: float, source_y: float,
                           source_conc: float, sigma: float | None = None,
                           peak: float | None = None):
        self._rows[episode_idx] = (
            steps, np.array(x, np.float32), np.array(y, np.float32),
            np.array(conc, np.float32), source_x, source_y, source_conc,
            DEFAULT_SIGMA if sigma is None else sigma,
            DEFAULT_PEAK if peak is None else peak)

    def arrays(self) -> dict[str, np.ndarray]:
        e = max(self._rows, default=-1) + 1
        shape = (e, self.max_steps)
        out = {"x": np.full(shape, np.nan, np.float32),
               "y": np.full(shape, np.nan, np.float32),
               "concentration": np.full(shape, np.nan, np.float32),
               "is_source": np.zeros(shape, np.int8)}
        for name in ("source_concentration", "source_x", "source_y",
                     "gaussian_sigma", "peak_concentration"):
            out[name] = np.full(e, np.nan, np.float32)
        for i, (steps, x, y, c, sx, sy, sc, sig, pk) in self._rows.items():
            out["x"][i, :steps] = x
            out["y"][i, :steps] = y
            out["concentration"][i, :steps] = c
            out["is_source"][i, steps - 1] = 1
            out["x"][i, steps - 1] = sx
            out["y"][i, steps - 1] = sy
            out["source_concentration"][i] = sc
            out["source_x"][i] = sx
            out["source_y"][i] = sy
            out["gaussian_sigma"][i] = sig
            out["peak_concentration"][i] = pk
        if not self.with_gaussian_params:
            del out["gaussian_sigma"], out["peak_concentration"]
        return out


def read_nc(path: str) -> dict[str, np.ndarray]:
    """Load every variable of a trajectory file into memory."""
    h5py = require_h5py("reading NetCDF files")
    out = {}
    with h5py.File(path, "r") as f:
        for name in f:
            out[name] = np.asarray(f[name])
        out["__attrs__"] = dict(f.attrs)
    return out


def describe_nc(path: str) -> str:
    """Text dump of dims, variables, attributes and min/max: the
    reference's ``check_nc_info.py`` inspector (PPOV2.1/check_nc_info.py:
    1-23, in nc_info.txt's format)."""
    h5py = require_h5py("reading NetCDF files")
    lines = []
    with h5py.File(path, "r") as f:
        lines.append("dims:")
        lines.append(f"  episode: {f['episode'].shape[0]}")
        lines.append(f"  step: {f['step'].shape[0]}")
        lines.append("")
        lines.append("variables:")
        for name in f:
            ds = f[name]
            lines.append(f"  {name}: shape={ds.shape}, dtype={ds.dtype}")
            for k, v in ds.attrs.items():
                if k in ("DIMENSION_LIST", "CLASS", "NAME", "REFERENCE_LIST"):
                    continue
                lines.append(f"    {k}: {v}")
            data = np.asarray(ds)
            if np.issubdtype(data.dtype, np.floating):
                valid = data[~np.isnan(data)]
            else:
                valid = data[data != 0] if name == "is_source" else data
            if valid.size:
                lines.append(f"    min={valid.min()}, max={valid.max()}")
        lines.append("")
        lines.append("file check complete.")
    return "\n".join(lines)
