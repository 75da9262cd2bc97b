"""Parameters between the flax ``ActorCritic`` / ``RecurrentActorCritic``,
stop-LSTM and ``Discriminator`` layouts and the port's modules, and field
banks from the JAX package's arrays into the port.

Works on plain numpy arrays, so neither side needs the other's framework:
flax ``{"params": {"Dense_0": {"kernel", "bias"}, "LayerNorm_0": {"scale",
"bias"}, ...}}`` against the torch state_dict names of
``tpu_plume_torch.models.ActorCritic``.  Dense kernels are [in, out] in flax
and [out, in] in torch, so they are transposed; LayerNorm ``scale`` is
torch's ``weight``.
"""

from __future__ import annotations

import numpy as np
import torch


def _mapping(num_hidden: int):
    """(torch prefix, flax module, is_layernorm) for a trunk of
    ``num_hidden`` Dense+LayerNorm+ReLU layers."""
    out = []
    for i in range(num_hidden):
        out.append((f"feature.{3 * i}", f"Dense_{i}", False))
        out.append((f"feature.{3 * i + 1}", f"LayerNorm_{i}", True))
    out.append(("actor", f"Dense_{num_hidden}", False))
    out.append(("critic", f"Dense_{num_hidden + 1}", False))
    return out


def actor_critic_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> a state_dict for ``ActorCritic``."""
    p = params["params"] if "params" in params else params
    num_hidden = sum(1 for k in p if k.startswith("LayerNorm_"))
    sd = {}
    for torch_name, flax_name, is_ln in _mapping(num_hidden):
        mod = p[flax_name]
        w = np.asarray(mod["scale"] if is_ln else mod["kernel"], np.float32)
        sd[f"{torch_name}.weight"] = torch.from_numpy(
            np.array(w if is_ln else w.T, np.float32, order="C"))
        sd[f"{torch_name}.bias"] = torch.from_numpy(
            np.array(mod["bias"], np.float32))
    return sd


def actor_critic_to_flax(state_dict: dict) -> dict:
    """``ActorCritic`` state_dict -> flax param tree with numpy leaves."""
    def arr(t):
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().numpy()
        return np.asarray(t, np.float32)

    num_hidden = sum(1 for k in state_dict
                     if k.startswith("feature.") and k.endswith(".weight")) // 2
    p = {}
    for torch_name, flax_name, is_ln in _mapping(num_hidden):
        w = arr(state_dict[f"{torch_name}.weight"])
        b = arr(state_dict[f"{torch_name}.bias"]).copy()
        if is_ln:
            p[flax_name] = {"scale": w.copy(), "bias": b}
        else:
            p[flax_name] = {"kernel": np.ascontiguousarray(w.T), "bias": b}
    return {"params": p}


def _arr(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.array(t, np.float32, order="C")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(_arr(a))


_GATES = ("i", "f", "g", "o")
# (torch prefix, flax module, is_layernorm) of the recurrent model's layers
# outside the cell.
_RECURRENT_OUTER = (("encoder", "encoder", False),
                    ("encoder_norm", "encoder_norm", True),
                    ("actor", "actor", False), ("critic", "critic", False))


def recurrent_actor_critic_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax ``RecurrentActorCritic`` param tree (numpy leaves) -> a
    state_dict for the port's ``RecurrentActorCritic``, either cell.  The
    plain cell's per-gate kernels stack in the order (i, f, g, o), the flax
    biases of the hidden side into ``cell.hh.bias``, as
    ``tpu_plume/data/torch_export.py`` maps them."""
    p = params["params"] if "params" in params else params
    sd = {}
    for torch_name, flax_name, is_ln in _RECURRENT_OUTER:
        mod = p[flax_name]
        w = _arr(mod["scale"] if is_ln else mod["kernel"])
        sd[f"{torch_name}.weight"] = _tensor(w if is_ln else w.T)
        sd[f"{torch_name}.bias"] = _tensor(mod["bias"])
    cell = p["cell"]
    if "ln_gates" in cell:
        sd["cell.ih.weight"] = _tensor(_arr(cell["ih"]["kernel"]).T)
        sd["cell.hh.weight"] = _tensor(_arr(cell["hh"]["kernel"]).T)
        for name in ("ln_gates", "ln_cell"):
            sd[f"cell.{name}.weight"] = _tensor(cell[name]["scale"])
            sd[f"cell.{name}.bias"] = _tensor(cell[name]["bias"])
    else:
        for side in ("i", "h"):
            sd[f"cell.{side}h.weight"] = _tensor(np.concatenate(
                [_arr(cell[f"{side}{g}"]["kernel"]).T for g in _GATES]))
        sd["cell.hh.bias"] = _tensor(np.concatenate(
            [_arr(cell[f"h{g}"]["bias"]) for g in _GATES]))
    return sd


def recurrent_actor_critic_to_flax(state_dict: dict) -> dict:
    """The port's ``RecurrentActorCritic`` state_dict -> flax param tree
    with numpy leaves (the inverse of ``recurrent_actor_critic_from_flax``)."""
    sd = {k: _arr(v) for k, v in state_dict.items()}
    p = {}
    for torch_name, flax_name, is_ln in _RECURRENT_OUTER:
        w, b = sd[f"{torch_name}.weight"], sd[f"{torch_name}.bias"]
        p[flax_name] = ({"scale": w, "bias": b} if is_ln else
                        {"kernel": np.ascontiguousarray(w.T), "bias": b})
    if "cell.ln_gates.weight" in sd:
        cell = {name: {"kernel": np.ascontiguousarray(
            sd[f"cell.{name}.weight"].T)} for name in ("ih", "hh")}
        for name in ("ln_gates", "ln_cell"):
            cell[name] = {"scale": sd[f"cell.{name}.weight"],
                          "bias": sd[f"cell.{name}.bias"]}
    else:
        cell = {}
        w_i = np.split(sd["cell.ih.weight"], len(_GATES))
        w_h = np.split(sd["cell.hh.weight"], len(_GATES))
        b_h = np.split(sd["cell.hh.bias"], len(_GATES))
        for g, wi, wh, bh in zip(_GATES, w_i, w_h, b_h):
            cell[f"i{g}"] = {"kernel": np.ascontiguousarray(wi.T)}
            cell[f"h{g}"] = {"kernel": np.ascontiguousarray(wh.T),
                             "bias": bh.copy()}
    p["cell"] = cell
    return {"params": p}


def _cells(p: dict) -> list[str]:
    return sorted((k for k in p if k.startswith("OptimizedLSTMCell_")),
                  key=lambda k: int(k.rsplit("_", 1)[1]))


def lstm_zoo_from_flax(model, params: dict) -> dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) of a stop-LSTM model of
    ``tpu_plume/models/lstm_zoo.py`` -> a state_dict for the port's model
    of the same name (``model``, the class or an instance).  Cell ``k``
    (``OptimizedLSTMCell_k``) becomes ``lstm`` layer ``k`` as
    ``tpu_plume/data/torch_export.py`` maps it: per-gate kernels stacked in
    the order (i, f, g, o), the flax bias into ``bias_hh``, ``bias_ih``
    zero.  The Dense and LayerNorm layers map by ``model.FLAX_LAYERS``."""
    p = params["params"] if "params" in params else params
    sd = {}
    for k, name in enumerate(_cells(p)):
        cell = p[name]
        for side, torch_side in (("i", "ih"), ("h", "hh")):
            sd[f"lstm.weight_{torch_side}_l{k}"] = _tensor(np.concatenate(
                [_arr(cell[f"{side}{g}"]["kernel"]).T for g in _GATES]))
        b = np.concatenate([_arr(cell[f"h{g}"]["bias"]) for g in _GATES])
        sd[f"lstm.bias_ih_l{k}"] = _tensor(np.zeros_like(b))
        sd[f"lstm.bias_hh_l{k}"] = _tensor(b)
    for torch_name, flax_name in model.FLAX_LAYERS:
        mod = p[flax_name]
        w = _arr(mod["scale"] if "scale" in mod else mod["kernel"])
        sd[f"{torch_name}.weight"] = _tensor(w if "scale" in mod else w.T)
        sd[f"{torch_name}.bias"] = _tensor(mod["bias"])
    return sd


def lstm_zoo_to_flax(model, state_dict: dict) -> dict:
    """The port's stop-LSTM state_dict -> the flax param tree with numpy
    leaves (the inverse of ``lstm_zoo_from_flax``; a cell's bias is
    ``bias_ih + bias_hh``, so a reference ``.pth`` with both biases maps
    exactly)."""
    sd = {k: _arr(v) for k, v in state_dict.items()}
    p = {}
    layers = sum(1 for k in sd if k.startswith("lstm.weight_ih_l"))
    for k in range(layers):
        w_i = np.split(sd[f"lstm.weight_ih_l{k}"], len(_GATES))
        w_h = np.split(sd[f"lstm.weight_hh_l{k}"], len(_GATES))
        b = np.split(sd[f"lstm.bias_ih_l{k}"] + sd[f"lstm.bias_hh_l{k}"],
                     len(_GATES))
        cell = {}
        for g, wi, wh, bg in zip(_GATES, w_i, w_h, b):
            cell[f"i{g}"] = {"kernel": np.ascontiguousarray(wi.T)}
            cell[f"h{g}"] = {"kernel": np.ascontiguousarray(wh.T),
                             "bias": bg.copy()}
        p[f"OptimizedLSTMCell_{k}"] = cell
    for torch_name, flax_name in model.FLAX_LAYERS:
        w, b = sd[f"{torch_name}.weight"], sd[f"{torch_name}.bias"]
        p[flax_name] = ({"scale": w, "bias": b}
                        if flax_name.startswith("LayerNorm_") else
                        {"kernel": np.ascontiguousarray(w.T), "bias": b})
    return {"params": p}


# (torch prefix, flax module) of the GAIL discriminator, the reference
# ``discriminator.pth`` layout.
_DISCRIMINATOR = (("net.0", "Dense_0"), ("net.2", "Dense_1"))


def discriminator_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax ``Discriminator`` param tree (numpy leaves) -> a state_dict for
    the port's ``Discriminator``."""
    p = params["params"] if "params" in params else params
    return {**{f"{t}.weight": _tensor(_arr(p[f]["kernel"]).T)
               for t, f in _DISCRIMINATOR},
            **{f"{t}.bias": _tensor(p[f]["bias"]) for t, f in _DISCRIMINATOR}}


def discriminator_to_flax(state_dict: dict) -> dict:
    """The port's ``Discriminator`` state_dict -> flax param tree with
    numpy leaves."""
    sd = {k: _arr(v) for k, v in state_dict.items()}
    return {"params": {f: {"kernel": np.ascontiguousarray(
        sd[f"{t}.weight"].T), "bias": sd[f"{t}.bias"]}
        for t, f in _DISCRIMINATOR}}


def field_bank_from_numpy(conc, source, wind=None, steps_per_frame=1.0,
                          z_extent=0.0, device="cpu"):
    """A ``FieldBank`` of the port on ``device`` from a bank's arrays (the
    fields of the JAX package's ``FieldBank``, as numpy arrays)."""
    from tpu_plume_torch.fields.gridded import FieldBank

    def tensor(a):
        return torch.from_numpy(np.array(a, np.float32, order="C")).to(device)

    return FieldBank(conc=tensor(conc), source=tensor(source),
                     wind=None if wind is None else tensor(wind),
                     steps_per_frame=float(steps_per_frame),
                     z_extent=float(z_extent))
