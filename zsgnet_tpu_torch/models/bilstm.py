"""BiLSTM query encoder — torch port of ``zsgnet_tpu/models/bilstm.py``.

Token ids → embedding → one bidirectional ``nn.LSTM`` over
``pack_padded_sequence`` → [h_fwd, h_bwd] (B, 2H): the forward state after
the last valid token and the backward state after token 0, which is what
the JAX masked scan returns. Gate order is torch's (i, f, g, o), the JAX
package's too. ``nn.LSTM`` runs on cuDNN on the card.

``encode_query_masked`` computes the same function as the JAX package
does: a fixed-``T`` loop of LSTM cells, forward then backward, that keeps
``h`` where ``t ≥ len``. Its shapes do not depend on the lengths' values,
so ``torch.export`` traces it (``export.py``); the live path keeps cuDNN's
packed LSTM.

The embedding and the LSTM are separate modules so that ``ZSGNet`` holds
them as ``embedding`` and ``lstm``, the reference checkpoint's names.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence

Tensor = torch.Tensor


def make_encoder(vocab_size: int, emb_dim: int = 300, hidden: int = 256) -> tuple[nn.Embedding, nn.LSTM]:
    """The embedding and the BiLSTM. The JAX encoder has one bias per
    direction, the sum of torch's ``bias_ih`` and ``bias_hh``; ``bias_hh``
    is frozen so that the optimizer updates that sum once per step, as it
    does in the JAX package, and not twice."""
    lstm = nn.LSTM(emb_dim, hidden, bidirectional=True, batch_first=True)
    lstm.bias_hh_l0.requires_grad_(False)
    lstm.bias_hh_l0_reverse.requires_grad_(False)
    return nn.Embedding(vocab_size, emb_dim), lstm


def fold_lstm_bias_(state_dict: dict[str, Tensor], prefix: str = "lstm.") -> dict[str, Tensor]:
    """Move each direction's ``bias_hh`` into its ``bias_ih`` and zero it,
    in place; returns ``state_dict``. The sum, and so the encoder's output,
    is unchanged. With ``bias_hh`` at 0 the trainable ``bias_ih`` is the JAX
    encoder's one bias, so AdamW decays the same tensor as optax does."""
    for sfx in ("l0", "l0_reverse"):
        hh, ih = f"{prefix}bias_hh_{sfx}", f"{prefix}bias_ih_{sfx}"
        if hh in state_dict and ih in state_dict:
            state_dict[ih] = state_dict[ih] + state_dict[hh]
            state_dict[hh] = torch.zeros_like(state_dict[hh])
    return state_dict


def encode_query(embedding: nn.Embedding, lstm: nn.LSTM, qvec: Tensor, qlens: Tensor) -> Tensor:
    """qvec (B, T) int token ids (0 = pad), qlens (B,) int each ≥ 1 → (B, 2H)."""
    # pack_padded_sequence takes its lengths on the CPU.
    lengths = qlens.detach().to("cpu", torch.int64)
    packed = pack_padded_sequence(
        embedding(qvec.long()), lengths, batch_first=True, enforce_sorted=False
    )
    _, (h_n, _) = lstm(packed)
    return torch.cat([h_n[0], h_n[1]], dim=-1)


def encode_query_masked(embedding: nn.Embedding, lstm: nn.LSTM, qvec: Tensor, qlens: Tensor) -> Tensor:
    """``encode_query`` as a masked scan over all ``T`` steps: (B, T), (B,) → (B, 2H)."""
    x = embedding(qvec.long())
    b, t = qvec.shape
    steps = torch.arange(t, device=qvec.device)
    valid = (steps[None, :] < qlens.to(qvec.device).long()[:, None])[..., None]  # (B, T, 1)
    hs = []
    for sfx, order in (("l0", range(t)), ("l0_reverse", reversed(range(t)))):
        w_hh = getattr(lstm, f"weight_hh_{sfx}")
        gx = x @ getattr(lstm, f"weight_ih_{sfx}").t() + getattr(lstm, f"bias_ih_{sfx}") + getattr(lstm, f"bias_hh_{sfx}")
        h = x.new_zeros((b, lstm.hidden_size))
        c = torch.zeros_like(h)
        for i in order:
            gi, gf, gg, go = (gx[:, i] + h @ w_hh.t()).chunk(4, dim=-1)
            c_new = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            h_new = torch.sigmoid(go) * torch.tanh(c_new)
            c = torch.where(valid[:, i], c_new, c)
            h = torch.where(valid[:, i], h_new, h)
        hs.append(h)
    return torch.cat(hs, dim=-1)
