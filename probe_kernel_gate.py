"""How data-sensitive the first-batch gradient gate is, on the card.

    python3 probe_kernel_gate.py

`training.kernel_check.compare_steps` holds the kernel train step (K1,
K2 forward and backward, K3a, K3b, K5) against the plain step, each
gradient within 1e-4 of its max abs (`chip_smoke.py` phases 8, 10, 11,
13 and 14).  This probe runs it at the Taobao sizes and weights of
phase 10 (lazyadam, every kernel gate on) on the first batch of four
seeds (8 is phase 10's) for f32 tables, bf16 tables and the legacy
lazy path, and for f32 tables that hold the bf16 tables' values (the
f32 code path on the bf16 configuration's numbers), and prints for
each the four gradients furthest from the plain step (error / max abs;
dense, then the compact table rows) and the gates missed.
It needs one card and exits non-zero without one.
"""

import os
import sys

import torch

import chip_smoke as cs


def main():
    smi = cs.card_check()
    sys.path.insert(0, cs.ROOT)
    from clsr_tpu_torch.config import CONFIG_DIR, load_config
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.training import kernel_check as kc

    sizes = (cs.USERS, cs.ITEMS, cs.CATES)
    base = load_config(os.path.join(CONFIG_DIR, "clsr.yaml"),
                       user_vocab="u", item_vocab="i", cate_vocab="c", seed=0,
                       optimizer="lazyadam", use_pallas_train_attention="on",
                       use_pallas_scan=True)
    model = get_model_class("clsr")(base, *sizes)
    g = torch.Generator(device="cuda").manual_seed(6)
    with torch.no_grad():          # phase 10's weights
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g, device="cuda") * 0.1)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    max_rel = kc._max_rel

    def worst(got, want):
        rows = sorted(
            ((((got[n].float() - w.float()).abs().max()
               / w.float().abs().max().clamp_min(1e-30)).item(), n)
             for n, w in want.items()
             if n in got and not kc.zero_by_construction(n)),
            reverse=True)
        cs.log("  furthest: " + ", ".join(f"{n} {r:.3e}"
                                          for r, n in rows[:4]))
        return max_rel(got, want)

    kc._max_rel = worst
    # f32 tables holding the bf16 tables' values: the f32 code path on
    # the bf16 configuration's numbers
    rounded = {k: (v.bfloat16().float() if k.endswith("_embedding") else v)
               for k, v in weights.items()}
    configs = (("f32", base, weights),
               ("bf16 tables", base.replace(embedding_dtype="bfloat16"),
                weights),
               ("f32 tables, bf16 values", base, rounded),
               ("legacy f32", base.replace(compact_rows="off"), weights))
    for seed in (8, 14, 11, 3):
        batch = cs.train_batches(1, seed, *sizes)[0]
        test_batch = cs.eval_batch_from(batch, 100, 8, 15)
        for run, cfg, w in configs:
            res = kc.compare_steps(cfg, w, sizes, batch, test_batch)
            cs.log(f"seed {seed} [{run}]: gradients max err / max abs "
                   f"{res['grad_rel_err']:.3e}, table rows "
                   f"{res['table_grad_rel_err']}, gates missed "
                   f"{kc.failures(res)} | {smi}")
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
