"""The weights of a run, made from the seed on the device in a few large
calls: one truncated-normal draw for every tensor the configuration's
initialiser fills, one uniform draw for the glorot-uniform recurrent
kernels, constants for the rest.  The same dict goes to the program
(`load_state_dict`) and to the plain reference."""

from __future__ import annotations

from typing import Dict

import torch

from harness.gen import generator
from reference import model as M


def make_weights(cfg: dict, tables: dict, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    specs = M.param_specs(cfg, tables["n_users"], tables["n_items"],
                          tables["n_cates"])
    g = generator(seed, "weights", device)
    std = cfg["init_value"]
    out: Dict[str, torch.Tensor] = {}
    for kind in ("tnormal", "glorot"):
        group = [(n, s) for n, s, k in specs if k == kind]
        total = sum(torch.Size(s).numel() for _, s in group)
        flat = torch.empty(total, dtype=torch.float32, device=device)
        if kind == "tnormal":
            torch.nn.init.trunc_normal_(flat, 0.0, std, -2 * std, 2 * std,
                                        generator=g)
        else:
            flat.uniform_(-1.0, 1.0, generator=g)
        at = 0
        for name, shape in group:
            k = torch.Size(shape).numel()
            t = flat[at:at + k].view(shape)
            out[name] = t * M.glorot_limit(shape) if kind == "glorot" else t
            at += k
    for name, shape, kind in specs:
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
    return {name: out[name] for name, _, _ in specs}
