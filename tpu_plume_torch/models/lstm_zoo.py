"""The LSTM stop-predictor family (port of ``tpu_plume/models/lstm_zoo.py``).

===============================  ==========================  =========================================
Model                            input                       reference
===============================  ==========================  =========================================
LSTMModel                        padded conc sequence        PPOV1.2/new.LSTM.py:49-81
ConcentrationThresholdPredictor  last-10 scaled conc window  PPOV2.0/model.py:203-240
ConcentrationPredictor           (B, T, 6)                   PPOV2.1/model.py:260-276
GaussianLSTM                     conc sequence               PPOV2.1/model.py:281-303
GaussianParamPredictor           (B, T, 6)                   PPOV2.1/model.py:308-322
GaussianParamAndStopPredictor    conc sequence               PPOV2.1/model.py:327-346
PeakAndStopPredictor             last-20 conc window / 100   PPOV2.1/train_lstm.py:84-100
===============================  ==========================  =========================================

Each recurrence is a ``torch.nn.LSTM`` named ``lstm`` (batch first), so a
state_dict holds the reference's ``lstm.weight_ih_l{k}`` ... layout, gates
(i, f, g, o).  flax's ``OptimizedLSTMCell`` has one bias, on the hidden
side: ``lstm.bias_ih_l{k}`` starts at zero and is frozen, so that training
moves one bias as flax does, while a reference ``.pth`` with both biases
loads and runs as it was trained.  ``lengths`` (flax's ``seq_lengths``)
picks each sequence's output at its last valid step; a deeper layer reads
the padded outputs of the one below, as in flax, which cannot reach an
earlier step.  2-D inputs are promoted as in JAX: [B, T] -> [B, T, 1] for
the concentration nets, [B, F] -> [B, 1, F] for the feature nets.

Init (``reset_parameters``) draws flax's distributions from a
``torch.Generator``: Dense layers xavier-uniform, the cells' input kernels
lecun-normal, their recurrent kernels orthogonal per gate, biases zero,
LayerNorms scale 1 and bias 0.  In training mode the threshold net's
dropout (between its LSTM layers, and in its head) draws its masks from
the generator passed to ``forward``.  Each model's ``FLAX_LAYERS`` names
its flax modules beside the torch ones (``tpu_plume_torch.convert``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from tpu_plume_torch.models.recurrent import GATES, _lecun_normal_


def _lstm(input_size: int, hidden: int, num_layers: int = 1) -> nn.LSTM:
    lstm = nn.LSTM(input_size, hidden, num_layers, batch_first=True)
    for k in range(num_layers):
        getattr(lstm, f"bias_ih_l{k}").requires_grad_(False)
    return lstm


def _conc_input(x: torch.Tensor) -> torch.Tensor:
    return x[..., None] if x.dim() == 2 else x


def _feature_input(x: torch.Tensor) -> torch.Tensor:
    return x[:, None, :] if x.dim() == 2 else x


def _at_lengths(out: torch.Tensor, lengths) -> torch.Tensor:
    """out [B, T, H] at each sequence's last valid step (the last step when
    ``lengths`` is None)."""
    if lengths is None:
        return out[:, -1]
    idx = torch.as_tensor(lengths, device=out.device).long() - 1
    return out[torch.arange(out.shape[0], device=out.device), idx]


def dropout(x: torch.Tensor, p: float, generator) -> torch.Tensor:
    """flax's ``nn.Dropout``: keep each element with probability 1 - p,
    scaled by 1 / (1 - p); the mask from ``generator``."""
    if p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


class _Zoo(nn.Module):
    # (torch module, flax module) of the Dense and LayerNorm layers
    FLAX_LAYERS: tuple = ()

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    nn.init.xavier_uniform_(m.weight, generator=generator)
                    nn.init.zeros_(m.bias)
                elif isinstance(m, nn.LayerNorm):
                    nn.init.ones_(m.weight)
                    nn.init.zeros_(m.bias)
                elif isinstance(m, nn.LSTM):
                    h = m.hidden_size
                    for k in range(m.num_layers):
                        _lecun_normal_(getattr(m, f"weight_ih_l{k}"),
                                       generator)
                        w_hh = getattr(m, f"weight_hh_l{k}")
                        for g in range(GATES):
                            nn.init.orthogonal_(w_hh[g * h:(g + 1) * h],
                                                generator=generator)
                        nn.init.zeros_(getattr(m, f"bias_ih_l{k}"))
                        nn.init.zeros_(getattr(m, f"bias_hh_l{k}"))
        return self

    def last_hidden(self, x, lengths):
        out, _ = self.lstm(x)
        return _at_lengths(out, lengths)


class LSTMModel(_Zoo):
    """V1.2 prototype: the source concentration from a (padded) episode
    concentration sequence (PPOV1.2/new.LSTM.py:49-81)."""

    FLAX_LAYERS = (("fc", "Dense_0"),)

    def __init__(self, hidden_size: int = 64, num_layers: int = 2,
                 output_size: int = 1):
        super().__init__()
        self.lstm = _lstm(1, hidden_size, num_layers)
        self.fc = nn.Linear(hidden_size, output_size)

    def forward(self, x, lengths=None):
        return self.fc(self.last_hidden(_conc_input(x), lengths)).squeeze(-1)


class ConcentrationThresholdPredictor(_Zoo):
    """V2.0 dynamic stop-threshold net: a 3-layer LSTM(128) with dropout .3
    between layers and an MLP head on the last valid output
    (PPOV2.0/model.py:203-240).  The head's LayerNorm has torch's eps 1e-5,
    as the JAX model's does."""

    FLAX_LAYERS = (("fc.0", "Dense_0"), ("fc.1", "LayerNorm_0"),
                   ("fc.4", "Dense_1"))

    def __init__(self, hidden_size: int = 128, num_layers: int = 3,
                 dropout: float = 0.3, head_dropout: float = 0.1):
        super().__init__()
        self.lstm = _lstm(1, hidden_size, num_layers)
        self.dropout, self.head_dropout = dropout, head_dropout
        self.fc = nn.Sequential(nn.Linear(hidden_size, 64),
                                nn.LayerNorm(64, eps=1e-5), nn.ReLU(),
                                nn.Dropout(head_dropout), nn.Linear(64, 1))

    def _lstm_dropout(self, x, generator):
        """The layers one by one, dropout on each output but the last's:
        ``nn.LSTM``'s own dropout draws from the global generator (cuDNN's
        state on the card), so each layer is run here through the call
        ``nn.LSTM.forward`` makes, ``torch._VF.lstm``, over its own
        weights."""
        lstm = self.lstm
        h0 = x.new_zeros(1, x.shape[0], lstm.hidden_size)
        for k in range(lstm.num_layers):
            if k:
                x = dropout(x, self.dropout, generator)
            weights = [getattr(lstm, f"{name}_l{k}") for name in
                       ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
            x = torch._VF.lstm(x, (h0, h0), weights, True, 1, 0.0, True,
                               False, True)[0]
        return x

    def forward(self, x, lengths=None, generator=None):
        x = _conc_input(x)
        drop = self.training and (self.dropout > 0 or self.head_dropout > 0)
        if drop:
            h = _at_lengths(self._lstm_dropout(x, generator), lengths)
        else:
            h = self.last_hidden(x, lengths)
        y = torch.relu(self.fc[1](self.fc[0](h)))
        if drop:
            y = dropout(y, self.head_dropout, generator)
        return self.fc[4](y).squeeze(-1)


class ConcentrationPredictor(_Zoo):
    """V2.1 stop-probability head on a 6-feature observation sequence
    (PPOV2.1/model.py:260-276)."""

    FLAX_LAYERS = (("fc.0", "Dense_0"), ("fc.2", "Dense_1"))

    def __init__(self, hidden_size: int = 32, input_size: int = 6):
        super().__init__()
        self.lstm = _lstm(input_size, hidden_size)
        self.fc = nn.Sequential(nn.Linear(hidden_size, 16), nn.ReLU(),
                                nn.Linear(16, 1))

    def forward(self, x, lengths=None):
        h = self.last_hidden(_feature_input(x), lengths)
        return torch.sigmoid(self.fc(h).squeeze(-1))


class GaussianLSTM(_Zoo):
    """V2.1 Gaussian-field regressor -> (mu_x, mu_y, sigma, peak)
    (PPOV2.1/model.py:281-303)."""

    FLAX_LAYERS = (("mu_head", "mu_head"), ("sigma_head.0", "Dense_0"),
                   ("sigma_head.2", "Dense_1"), ("peak_head", "peak_head"))

    def __init__(self, hidden_size: int = 64):
        super().__init__()
        self.lstm = _lstm(1, hidden_size)
        self.mu_head = nn.Linear(hidden_size, 2)
        self.sigma_head = nn.Sequential(nn.Linear(hidden_size, 16), nn.ReLU(),
                                        nn.Linear(16, 1))
        self.peak_head = nn.Linear(hidden_size, 1)

    def forward(self, x, lengths=None):
        h = self.last_hidden(_conc_input(x), lengths)
        return torch.cat([self.mu_head(h), F.softplus(self.sigma_head(h)),
                          torch.relu(self.peak_head(h))], dim=-1)


class GaussianParamPredictor(_Zoo):
    """V2.1 (mu_x, mu_y, sigma, peak) from feature windows
    (PPOV2.1/model.py:308-322); the source localizer of ``train_source_lstm``
    on (x, y, conc) or (x, y, conc, dx, dy, dconc) windows.  The head's
    width follows the cell (32 is the reference layout)."""

    FLAX_LAYERS = (("fc.0", "Dense_0"), ("fc.2", "Dense_1"))

    def __init__(self, hidden_size: int = 32, input_size: int = 6):
        super().__init__()
        self.lstm = _lstm(input_size, hidden_size)
        self.fc = nn.Sequential(nn.Linear(hidden_size, hidden_size),
                                nn.ReLU(), nn.Linear(hidden_size, 4))

    def forward(self, x, lengths=None):
        return self.fc(self.last_hidden(_feature_input(x), lengths))


class GaussianParamAndStopPredictor(_Zoo):
    """V2.1 joint (sigma, peak, stop_prob) head (PPOV2.1/model.py:327-346)."""

    FLAX_LAYERS = (("fc_sigma", "fc_sigma"), ("fc_peak", "fc_peak"),
                   ("fc_stop.0", "fc_stop"))

    def __init__(self, hidden_size: int = 32):
        super().__init__()
        self.lstm = _lstm(1, hidden_size)
        self.fc_sigma = nn.Linear(hidden_size, 1)
        self.fc_peak = nn.Linear(hidden_size, 1)
        self.fc_stop = nn.Sequential(nn.Linear(hidden_size, 1), nn.Sigmoid())

    def forward(self, x, lengths=None):
        h = self.last_hidden(_conc_input(x), lengths)
        return (self.fc_sigma(h).squeeze(-1), self.fc_peak(h).squeeze(-1),
                self.fc_stop(h).squeeze(-1))


class PeakAndStopPredictor(_Zoo):
    """V2.1 joint peak and stop gate, the variant the reference trains and
    evaluates with (PPOV2.1/train_lstm.py:84-100,
    PPOV2.1/evaluate_with_lstm.py:11-27)."""

    FLAX_LAYERS = (("fc_peak", "fc_peak"), ("fc_stop.0", "fc_stop"))

    def __init__(self, hidden_size: int = 32):
        super().__init__()
        self.lstm = _lstm(1, hidden_size)
        self.fc_peak = nn.Linear(hidden_size, 1)
        self.fc_stop = nn.Sequential(nn.Linear(hidden_size, 1), nn.Sigmoid())

    def forward(self, x, lengths=None):
        h = self.last_hidden(_conc_input(x), lengths)
        return self.fc_peak(h).squeeze(-1), self.fc_stop(h).squeeze(-1)
