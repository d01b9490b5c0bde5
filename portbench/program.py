"""The program under test as the harness holds it: its state, its train step,
the networks it trains, their Adams, and the modules whose outputs are
compared. The harness reads from it only what the check needs."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping

import torch
from torch import nn


def materialise(net: nn.Module, weights: Mapping[str, torch.Tensor], device: torch.device) -> nn.Module:
    """A meta-built network on ``device`` holding ``weights`` (every parameter, by name)."""
    net.to_empty(device=device)
    net.load_state_dict(dict(weights))
    return net


@dataclass
class Program:
    state: object
    step: Callable[[Mapping[str, torch.Tensor]], Dict[str, torch.Tensor]]
    nets: Dict[str, nn.Module]
    opts: Dict[str, torch.optim.Optimizer]
    outputs: Dict[str, nn.Module]
    captured: Dict[str, torch.Tensor] = field(default_factory=dict)

    def wrapped(self) -> list:
        """The DDP wrappers the step trains through (none in one process)."""
        found = [getattr(self.state, k, None) for k in ("g_dp", "gen_dp", "d_dp")]
        return [w for w in found if isinstance(w, nn.parallel.DistributedDataParallel)]

    def leaves(self) -> Dict[str, torch.Tensor]:
        return {f"{n}.{k}": v for n, net in self.nets.items() for k, v in net.named_parameters()}

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """Each leaf's gradient as Adam got it at its first step, from its first
        moment, m = (1 - beta1) g, in fp32 on the host; a leaf Adam holds no
        state for got none (zeros)."""
        out = {}
        for n, net in self.nets.items():
            opt = self.opts[n]
            beta1 = opt.param_groups[0]["betas"][0]
            for k, v in net.named_parameters():
                st = opt.state.get(v)
                g = st["exp_avg"].float() / (1.0 - beta1) if st else torch.zeros(v.shape, device=v.device)
                out[f"{n}.{k}"] = g.cpu()
        return out

    def capture(self):
        """Arm forward hooks that keep each compared module's next output (fp32,
        on the CPU); returns the handles to remove."""
        def hook(name):
            def keep(_module, _args, out):
                if name not in self.captured:
                    self.captured[name] = out.detach().float().cpu()
            return keep
        return [m.register_forward_hook(hook(name)) for name, m in self.outputs.items()]
