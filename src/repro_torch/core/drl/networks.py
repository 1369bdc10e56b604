"""Actor-critic networks (paper §3.1.3, §5.4): the port of the JAX
package's ``core/drl/networks.py``.

Both nets are 3-layer MLPs, hidden 128 → 64 with leaky-ReLU (slope 0.01);
the actor head gives a logit per candidate slot (masked slots at −1e9
before the softmax), the critic head a scalar value — the architecture
reported in §5.4.  Layers are ``nn.Linear``, whose weight is the
reference's ``w`` transposed.

Initialisation draws each weight from N(0, 2/din) (biases zero), actor
then critic, from a CPU ``torch.Generator`` seeded with ``seed``, and
moves the result to ``device``: the same seed gives the same weights on
the CPU and on the card.  The bits differ from ``jax.random``'s (as the
RANDOM partitioner's do); :func:`params_from_jax` carries the reference's
``init_actor_critic`` weights across where the same weights are needed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

HIDDEN = (128, 64)
MASKED_LOGIT = -1e9


def _mlp(sizes: List[int], gen: torch.Generator) -> nn.Sequential:
    layers: List[nn.Module] = []
    for i, (din, dout) in enumerate(zip(sizes[:-1], sizes[1:])):
        lin = nn.Linear(din, dout)
        with torch.no_grad():
            w = torch.randn((din, dout), generator=gen) * np.sqrt(2.0 / din)
            lin.weight.copy_(w.T)
            lin.bias.zero_()
        layers.append(lin)
        if i < len(sizes) - 2:
            layers.append(nn.LeakyReLU(0.01))
    return nn.Sequential(*layers)


class ActorCritic(nn.Module):
    def __init__(self, state_dim: int, num_actions: int, seed: int = 0,
                 device=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.actor = _mlp([state_dim, *HIDDEN, num_actions], gen)
        self.critic = _mlp([state_dim, *HIDDEN, 1], gen)
        self.to(device or "cpu")

    def forward(self, state: torch.Tensor,
                action_mask: Optional[torch.Tensor] = None):
        """(masked logits, value)."""
        return policy_logits(self, state, action_mask), value(self, state)


def policy_logits(net: ActorCritic, state: torch.Tensor,
                  action_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    logits = net.actor(state)
    if action_mask is not None:
        logits = logits.masked_fill(~action_mask, MASKED_LOGIT)
    return logits


def policy(net: ActorCritic, state: torch.Tensor,
           action_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return torch.softmax(policy_logits(net, state, action_mask), dim=-1)


def value(net: ActorCritic, state: torch.Tensor) -> torch.Tensor:
    return net.critic(state)[..., 0]


def params_from_jax(tree_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's ``init_actor_critic`` tree (numpy leaves: ``{"actor":
    [{"w": (din, dout), "b": (dout,)}, ...], "critic": [...]}``) as a state
    dict for :class:`ActorCritic` (``load_state_dict``)."""
    out: Dict[str, torch.Tensor] = {}
    for head in ("actor", "critic"):
        for i, layer in enumerate(tree_np[head]):
            # Linear layers sit at 0, 2, 4 of the Sequential (activations
            # between them)
            out[f"{head}.{2 * i}.weight"] = torch.from_numpy(
                np.array(np.asarray(layer["w"], np.float32).T, order="C"))
            out[f"{head}.{2 * i}.bias"] = torch.from_numpy(
                np.array(layer["b"], np.float32))
    return out
