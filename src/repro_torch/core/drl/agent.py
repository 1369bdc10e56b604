"""A3C-style advantage actor-critic agent (paper §3.1.3): the port of the
JAX package's ``core/drl/agent.py``.

Update rule (paper):
    θ ← θ + α ∇θ log πθ(s,a) A(s,a) + β ∇θ H(π(·|s))
with A(s,a) = R − V(s) from the critic and an entropy bonus β for
exploration.  The loss is the reference's (policy-gradient term with the
advantage detached, entropy over the unmasked slots, value MSE), taken
through autograd; the step is the port's :class:`AdamW` (weight decay 0,
clip 5.0).  The advisor calls only ``select`` and ``train_batch``.

The agent runs on the card unless the caller passes ``device="cpu"``; with
no card and no such request it raises.  ``select`` turns the policy into
float32 numpy probabilities, renormalises them as the reference does and
draws from ``np.random.default_rng(seed)``, so the same probabilities draw
the same action in both packages.  The initial weights come from a
``torch.Generator`` (:mod:`.networks`) and differ from the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...optimizer.adamw import AdamW
from ..backends import resolve_device
from . import networks


class Transition(NamedTuple):
    state: np.ndarray
    action: int
    reward: float
    mask: np.ndarray


@dataclass
class A3CConfig:
    state_dim: int
    num_actions: int
    lr: float = 3e-4
    gamma: float = 0.9
    entropy_beta: float = 0.05
    value_coef: float = 0.5
    seed: int = 0


class A3CAgent:
    def __init__(self, cfg: A3CConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device or "cuda")
        self.net = networks.ActorCritic(cfg.state_dim, cfg.num_actions,
                                        seed=cfg.seed, device=self.device)
        self.opt = AdamW(lr=cfg.lr, weight_decay=0.0, grad_clip_norm=5.0)
        self.opt_state = self.opt.init(self.params)
        self._rng = np.random.default_rng(cfg.seed)

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self.net.parameters())

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device,
                               dtype=dtype)

    # -- acting ------------------------------------------------------------------
    def select(self, state: np.ndarray, mask: Optional[np.ndarray] = None,
               greedy: bool = False) -> int:
        mask_t = (self._tensor(mask, torch.bool) if mask is not None
                  else torch.ones((self.cfg.num_actions,), dtype=torch.bool,
                                  device=self.device))
        with torch.no_grad():
            probs = networks.policy(self.net,
                                    self._tensor(state, torch.float32),
                                    mask_t).cpu().numpy()
        probs = probs / probs.sum()
        if greedy:
            return int(np.argmax(probs))
        return int(self._rng.choice(len(probs), p=probs))

    # -- learning -----------------------------------------------------------------
    def loss(self, states: torch.Tensor, actions: torch.Tensor,
             returns: torch.Tensor, masks: torch.Tensor):
        """(total, (policy loss, value loss, entropy)) on a batch."""
        logits = networks.policy_logits(self.net, states, masks)
        logp = torch.log_softmax(logits, dim=-1)
        probs = torch.exp(logp)
        v = networks.value(self.net, states)
        adv = returns - v
        taken = logp[torch.arange(actions.shape[0], device=logp.device),
                     actions]
        pg = -torch.mean(taken * adv.detach())
        ent = -torch.mean(torch.sum(
            torch.where(masks, probs * logp, torch.zeros_like(logp)), dim=-1))
        vloss = torch.mean(torch.square(adv))
        total = (pg + self.cfg.value_coef * vloss
                 - self.cfg.entropy_beta * ent)
        return total, (pg, vloss, ent)

    def train_batch(self, batch: List[Transition]) -> Tuple[float, dict]:
        """One gradient step on a batch of transitions.  Rewards here are the
        immediate rewards of one-shot partitioning decisions; with γ we fold
        in the discounted future return within an episode trace."""
        states = self._tensor(np.stack([t.state for t in batch]),
                              torch.float32)
        actions = self._tensor(np.array([t.action for t in batch],
                                        np.int64))
        masks = self._tensor(np.stack([t.mask for t in batch]), torch.bool)
        # discounted returns per-episode suffix (batch arrives episode-ordered)
        returns = np.zeros(len(batch), np.float32)
        run = 0.0
        for i in reversed(range(len(batch))):
            run = batch[i].reward + self.cfg.gamma * run
            returns[i] = run
        params = self.params
        total, (pg, vl, ent) = self.loss(states, actions,
                                         self._tensor(returns), masks)
        grads = torch.autograd.grad(total, params)
        new_params, self.opt_state = self.opt.update(list(grads),
                                                     self.opt_state, params)
        with torch.no_grad():
            for p, new in zip(params, new_params):
                p.copy_(new)
        total, pg, vl, ent = (float(t.detach()) for t in (total, pg, vl, ent))
        return total, {"policy_loss": pg, "value_loss": vl, "entropy": ent}
