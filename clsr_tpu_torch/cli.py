"""Experiment driver: train, evaluate and predict from the command line.

Counterpart of clsr_tpu/cli.py:25-380 (itself after the reference's
examples/00_quick_start/sequential.py:1-381): the same flags, per-dataset
settings (taobao: max_seq 50, time unit 's', ndcg@2;4;6 + hit; kuaishou:
250, 'ms', ndcg@1;2, sequential.py:77-87), the config from the YAML of
`configs/` with the flags over it, then parse -> batch -> `Trainer.fit`
(valid eval each epoch, early stop on wauc, a checkpoint on improvement)
-> restore the best epoch -> the test eval on 1 + test_num_ngs groups ->
optionally the prediction file.  One flag more: `--device` (default
cuda; without a card that raises, `--device cpu` runs on the CPU).

A raw log (`--raw_data`, Taobao's UserBehavior.csv or a Kuaishou log)
goes through the ETL (data/etl.py) when the data directory holds
neither TSVs nor a pack: `--etl_format tsv` writes the expanding-history
TSVs (`--etl_native` in C++, `--etl_processes N` in worker processes),
`--etl_format packed` writes `packed.npz` (data/packed.py).
`--data_format auto` trains on `packed.npz` when it is there (and no
`--shuffle_history_seed` asks for the TSVs).

A (data, model) mesh (`--data_parallel D --model_parallel M`, with
`--mesh_flat_batch`, `--mesh_row_layout` and a `--dist_backend` nccl or
gloo, which must be given: parallel/mesh.py) runs one process a rank:
under torchrun each process joins from torchrun's environment (rank 0
prepares the data, the others wait), else the CLI prepares the data and
spawns D*M local ranks (`parallel.distributed.run_local_world`; gloo
may put every rank on one card or the CPU, nccl needs a GPU a rank).
Every rank runs the same fit and eval on its share; rank 0 prints and
writes.  The owner-routed merge (`--mesh_update_routing owner`,
`--mesh_owner_capacity`, `--mesh_owner_overflow`), resident data
(`--resident_data`, 'auto' resident when the set fits), length
buckets, every model (LGN with its graph on every rank), kill and
resume and histograms run on a mesh as on one device.  Kill and resume
(`--autosave_every_calls N`, `--resume`), `--write_histograms`,
`--write_tfevents` and `--attention_block_size` run as in JAX; with
`--attention_block_size` the config must set `enable_bn: False`, which
clsr.yaml does not, so there, as in the JAX CLI, the config refuses it.

Usage:
    python -m clsr_tpu_torch.cli --dataset synthetic --model CLSR --epochs 2
    python -m clsr_tpu_torch.cli --dataset synthetic --model CLSR --only_test
    python -m clsr_tpu_torch.cli --dataset synthetic --model DIN --epochs 2
    python -m clsr_tpu_torch.cli --dataset synthetic --model LGN --epochs 2
    python -m clsr_tpu_torch.cli --dataset taobao --model CLSR \
        --raw_data UserBehavior.csv --etl_format packed --epochs 1

Every model of the registry runs; for LGN the CLI builds the interaction
graph from the train file or the pack (data/graph.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs")


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="clsr_tpu_torch experiment "
                                            "driver")
    # sequential.py:36-68
    p.add_argument("--dataset", default="taobao",
                   choices=["taobao", "kuaishou", "synthetic"])
    p.add_argument("--val_num_ngs", type=int, default=4)
    p.add_argument("--test_num_ngs", type=int, default=99)
    p.add_argument("--batch_size", type=int, default=500)
    p.add_argument("--save_path", default="")
    p.add_argument("--contrastive_loss", default="triplet",
                   choices=["bpr", "triplet"])
    p.add_argument("--contrastive_length_threshold", type=int, default=5)
    p.add_argument("--contrastive_recent_k", type=int, default=3)
    p.add_argument("--name", default=None,
                   help="experiment name (default: <dataset>-<model>); "
                        "keys the checkpoint/summary dirs")
    p.add_argument("--model", default="CLSR")
    p.add_argument("--only_test", action="store_true")
    p.add_argument("--write_prediction_to_file", action="store_true")
    p.add_argument("--manual_alpha", action="store_true")
    p.add_argument("--manual_alpha_value", type=float, default=0.5)
    p.add_argument("--no_interest_evolve", dest="interest_evolve",
                   action="store_false")
    p.add_argument("--no_predict_long_short", dest="predict_long_short",
                   action="store_false")
    p.add_argument("--is_clip_norm", type=int, default=1)
    p.add_argument("--sequential_model", default="time4lstm",
                   choices=["gru", "lstm", "time4lstm"])
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--early_stop", type=int, default=5)
    p.add_argument("--data_path", default=os.path.join(
        "tests", "resources", "deeprec", "sequential"))
    p.add_argument("--train_num_ngs", type=int, default=4)
    p.add_argument("--sample_rate", type=float, default=1.0)
    p.add_argument("--embed_l2", type=float, default=1e-6)
    p.add_argument("--layer_l2", type=float, default=1e-6)
    p.add_argument("--attn_loss_weight", type=float, default=0.001)
    p.add_argument("--triplet_margin", type=float, default=1.0)
    p.add_argument("--discrepancy_loss_weight", type=float, default=0.01)
    p.add_argument("--contrastive_loss_weight", type=float, default=0.1)
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument("--show_step", type=int, default=500)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--raw_data", default=None,
                   help="raw interaction CSV for on-demand preprocessing")
    p.add_argument("--no_history_expanding", dest="is_history_expanding",
                   action="store_false",
                   help="one line per user instead of expanding prefixes "
                        "(the ETL's option)")
    # ablation iterator variants (sequential_iterator.py:735-793)
    p.add_argument("--counterfactual_recent_k", type=int, default=None,
                   help="keep only the last k history events (RecentSA)")
    p.add_argument("--shuffle_history_seed", type=int, default=None,
                   help="fixed per-user history shuffle (ShuffleSA)")
    # the JAX package's extras; those not ported raise after parsing
    p.add_argument("--data_parallel", type=int, default=1)
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--mesh_flat_batch", default="auto",
                   choices=("auto", "on", "off"))
    p.add_argument("--mesh_update_routing", default="broadcast",
                   choices=("broadcast", "owner"))
    p.add_argument("--mesh_owner_capacity", type=float, default=4.0)
    p.add_argument("--mesh_owner_overflow", default="fallback",
                   choices=("fallback", "drop"))
    p.add_argument("--mesh_row_layout", default="auto",
                   choices=("auto", "interleaved", "contiguous"))
    p.add_argument("--dist_backend", default=None, choices=("nccl", "gloo"),
                   help="the mesh's torch.distributed backend (required "
                        "when data_parallel * model_parallel > 1)")
    p.add_argument("--optimizer", default=None,
                   help="override the YAML optimizer (adam, lazyadam, "
                        "adadelta, adagrad, sgd, gd, pgd, rmsprop, ftrl, "
                        "padagrad; any other name runs sgd)")
    p.add_argument("--train_steps_per_call", type=int, default=None,
                   help="K train steps a host call (on the card, replays "
                        "of one captured step)")
    p.add_argument("--autosave_every_calls", type=int, default=0,
                   help="every N train calls persist the full run state "
                        "to <model_dir>/autosave for an exact mid-epoch "
                        "resume")
    p.add_argument("--resume", action="store_true",
                   help="resume a killed run from <model_dir>/autosave "
                        "(bit-identical continuation)")
    p.add_argument("--length_buckets", default=None,
                   help="length-aware batching on the resident path: "
                        "off | auto | comma edges (data/resident.py)")
    p.add_argument("--resident_round_rows", type=int, default=None,
                   help="round resident row counts up to this multiple")
    p.add_argument("--resident_data", default="auto",
                   choices=["auto", "on", "off"],
                   help="device-resident train data (data/resident.py); "
                        "auto = on when it fits resident_max_bytes")
    p.add_argument("--compute_dtype", default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--embedding_dtype", default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--use_pallas_train_attention", default=None,
                   choices=["auto", "on", "off"],
                   help="K3a + K3b + K1 in the train step (auto = on for "
                        "CUDA tensors)")
    p.add_argument("--use_pallas_eval_attention", default=None,
                   choices=["auto", "on", "off"],
                   help="K1 in eval at G >= 8 (auto = on for CUDA "
                        "tensors)")
    p.add_argument("--attention_block_size", type=int, default=None,
                   help="> 0: blockwise long-context target attention "
                        "(needs enable_bn: False)")
    p.add_argument("--write_histograms", action="store_true",
                   help="activation and embedding histograms computed on "
                        "the device at the show_step cadence (JSONL, and "
                        "TensorBoard with --write_tfevents)")
    p.add_argument("--write_tfevents", action="store_true",
                   help="TensorBoard event files beside scalars.jsonl")
    p.add_argument("--etl_processes", type=int, default=1,
                   help="worker processes of the expanding-history lines")
    p.add_argument("--etl_native", action="store_true",
                   help="the expanding-history lines in C++ (integer ids; "
                        "text ids run the Python engine)")
    p.add_argument("--etl_format", default="tsv", choices=["tsv", "packed"],
                   help="ETL output: the expanding-history TSVs or the "
                        "O(events) packed.npz (data/packed.py)")
    p.add_argument("--data_format", default="auto",
                   choices=["auto", "tsv", "packed"],
                   help="training input: auto = packed.npz when present "
                        "(unless --shuffle_history_seed needs the TSVs)")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (the default) raises without "
                        "a card, cpu runs on the host")
    return p


def _mesh_size(args) -> int:
    return args.data_parallel * args.model_parallel


def refuse_unported(args) -> None:
    """Raise before any work for parsed flags the CLI cannot run: a mesh
    without a backend, an unknown model (no flag waits for a ROADMAP
    item any more)."""
    from clsr_tpu_torch.models.registry import get_model_class

    if _mesh_size(args) > 1 and args.dist_backend is None:
        raise ValueError("a mesh (data_parallel * model_parallel > 1) "
                         "needs --dist_backend nccl or gloo")
    get_model_class(args.model)


def dataset_settings(dataset: str):
    """sequential.py:77-87."""
    if dataset == "kuaishou":
        return dict(pairwise_metrics=("mean_mrr", "ndcg@1;2"),
                    weighted_metrics=("wauc",), max_seq_length=250,
                    time_unit="ms")
    return dict(pairwise_metrics=("mean_mrr", "ndcg@2;4;6", "hit@2;4;6"),
                weighted_metrics=("wauc",), max_seq_length=50, time_unit="s")


def make_config(args):
    from clsr_tpu_torch.config import load_config

    model_key = args.model.lower()
    yaml_name = {"slirec": "sli_rec", "a2svd": "asvd"}.get(model_key,
                                                           model_key)
    yaml_file = os.path.join(CONFIG_DIR, f"{yaml_name}.yaml")
    if not os.path.exists(yaml_file):
        yaml_file = None

    ds = dataset_settings(args.dataset)
    data_dir = os.path.join(args.data_path, args.dataset)
    name = args.name or f"{args.dataset}-{args.model.lower()}"
    return load_config(
        yaml_file,
        model_type=model_key,
        user_vocab=os.path.join(data_dir, "user_vocab.pkl"),
        item_vocab=os.path.join(data_dir, "item_vocab.pkl"),
        cate_vocab=os.path.join(data_dir, "category_vocab.pkl"),
        batch_size=args.batch_size,
        epochs=args.epochs,
        early_stop=args.early_stop,
        train_num_ngs=args.train_num_ngs,
        valid_num_ngs=args.val_num_ngs,
        test_num_ngs=args.test_num_ngs,
        embed_l2=args.embed_l2,
        layer_l2=args.layer_l2,
        learning_rate=args.learning_rate,
        show_step=args.show_step,
        contrastive_loss=args.contrastive_loss,
        contrastive_length_threshold=args.contrastive_length_threshold,
        contrastive_recent_k=args.contrastive_recent_k,
        triplet_margin=args.triplet_margin,
        discrepancy_loss_weight=args.discrepancy_loss_weight,
        contrastive_loss_weight=args.contrastive_loss_weight,
        attn_loss_weight=args.attn_loss_weight,
        manual_alpha=args.manual_alpha,
        manual_alpha_value=args.manual_alpha_value,
        interest_evolve=args.interest_evolve,
        predict_long_short=args.predict_long_short,
        is_clip_norm=bool(args.is_clip_norm),
        sequential_model=args.sequential_model,
        seed=args.seed,
        model_dir=os.path.join(args.data_path, "model", name),
        summaries_dir=os.path.join(args.data_path, "summary", name),
        data_parallel=args.data_parallel,
        model_parallel=args.model_parallel,
        mesh_flat_batch=args.mesh_flat_batch,
        mesh_update_routing=args.mesh_update_routing,
        mesh_owner_capacity=args.mesh_owner_capacity,
        mesh_owner_overflow=args.mesh_owner_overflow,
        mesh_row_layout=args.mesh_row_layout,
        resident_data=args.resident_data,
        autosave_every_calls=args.autosave_every_calls,
        write_histograms=args.write_histograms,
        write_tfevents=args.write_tfevents,
        **{k: getattr(args, k) for k in
           ("optimizer", "train_steps_per_call", "compute_dtype",
            "embedding_dtype", "attention_block_size", "length_buckets",
            "resident_round_rows")
           if getattr(args, k) is not None},
        **({"use_pallas_eval_attention": args.use_pallas_eval_attention}
           if args.use_pallas_eval_attention is not None else {}),
        **({"use_pallas_train_attention": args.use_pallas_train_attention}
           if args.use_pallas_train_attention is not None else {}),
        **ds,
    )


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    refuse_unported(args)

    from clsr_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = make_config(args)
    if _mesh_size(args) <= 1:
        prepare_data(args, cfg)
        return run(args, cfg, device)

    import torch.distributed as dist

    from clsr_tpu_torch.parallel import distributed
    if "WORLD_SIZE" in os.environ:      # one process a rank, by torchrun
        distributed.init_process_group(args.dist_backend,
                                       timeout_s=WORLD_TIMEOUT_S)
        try:
            if dist.get_rank() == 0:
                prepare_data(args, cfg)
            dist.barrier()
            return run(args, cfg,
                       distributed.rank_device(args.dist_backend, device),
                       rank=dist.get_rank())
        finally:
            dist.destroy_process_group()
    prepare_data(args, cfg)
    codes = distributed.run_local_world(
        _rank_run, _mesh_size(args), args.dist_backend, device,
        args=(list(sys.argv[1:] if argv is None else argv),),
        timeout_s=WORLD_TIMEOUT_S)
    return max(codes)


# a spawned mesh's (and a torchrun group's) limit: a fit's length, and
# how long a collective may wait before it fails
WORLD_TIMEOUT_S = 7 * 24 * 3600.0


def _rank_run(rank: int, device, argv) -> int:
    """One rank of a spawned mesh: the CLI's run on this rank's device."""
    args = build_arg_parser().parse_args(argv)
    return run(args, make_config(args), device, rank=rank)


def prepare_data(args, cfg) -> None:
    """Write the synthetic set, or run the ETL on --raw_data, when the
    data directory holds neither the TSVs nor a pack."""
    from clsr_tpu_torch.data.etl import data_preprocessing
    from clsr_tpu_torch.data.packed import PACKED_FILENAME
    from clsr_tpu_torch.data.synthetic import write_synthetic_dataset

    data_dir = os.path.join(args.data_path, args.dataset)
    files = {name: os.path.join(data_dir, f"{name}_data")
             for name in ("train", "valid", "test")}
    packed_file = os.path.join(data_dir, PACKED_FILENAME)
    if not os.path.exists(files["train"]) and not os.path.exists(
            packed_file):
        os.makedirs(data_dir, exist_ok=True)
        if args.dataset == "synthetic":
            write_synthetic_dataset(data_dir,
                                    valid_num_ngs=args.val_num_ngs,
                                    test_num_ngs=args.test_num_ngs)
            os.replace(os.path.join(data_dir, "cate_vocab.pkl"),
                       os.path.join(data_dir, "category_vocab.pkl"))
        elif args.raw_data:
            t0 = time.perf_counter()
            stages = data_preprocessing(
                args.raw_data, files["train"], files["valid"],
                files["test"], cfg.user_vocab, cfg.item_vocab,
                cfg.cate_vocab, sample_rate=args.sample_rate,
                valid_num_ngs=args.val_num_ngs,
                test_num_ngs=args.test_num_ngs, dataset=args.dataset,
                is_history_expanding=args.is_history_expanding,
                seed=args.seed, processes=args.etl_processes,
                engine="native" if args.etl_native else "python",
                output_format=args.etl_format)
            print(f"etl {args.etl_format}: "
                  f"{time.perf_counter() - t0:.3f}s (" + ", ".join(
                      f"{k} {v:.3f}s" for k, v in stages.items()) + ")",
                  flush=True)
        else:
            raise SystemExit(
                f"{files['train']} missing; pass --raw_data to preprocess")


def run(args, cfg, device, rank: int = 0) -> int:
    """Load the data, fit, test and predict on `device`; on a mesh every
    rank runs it and rank 0 alone prints and writes."""
    from clsr_tpu_torch.data.graph import build_interaction_graph
    from clsr_tpu_torch.data.loader import SequenceLoader
    from clsr_tpu_torch.data.packed import (PACKED_FILENAME,
                                            build_interaction_graph_packed,
                                            load_packed, make_loader)
    from clsr_tpu_torch.data.parser import parse_file, time_range_for_unit
    from clsr_tpu_torch.data.vocab import load_vocab
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.training.evaluator import (predict_to_file,
                                                   run_weighted_eval)
    from clsr_tpu_torch.training.trainer import Trainer

    say = print if rank == 0 else (lambda *a, **k: None)
    data_dir = os.path.join(args.data_path, args.dataset)
    files = {name: os.path.join(data_dir, f"{name}_data")
             for name in ("train", "valid", "test")}
    packed_file = os.path.join(data_dir, PACKED_FILENAME)
    use_packed = args.data_format == "packed" or (
        args.data_format == "auto" and os.path.exists(packed_file)
        and args.shuffle_history_seed is None)
    if use_packed and not os.path.exists(packed_file):
        raise SystemExit(f"{packed_file} missing; rerun the ETL with "
                         f"--etl_format packed")
    if use_packed and args.shuffle_history_seed is not None:
        raise SystemExit("--shuffle_history_seed needs the TSV path "
                         "(--data_format tsv)")

    uv = load_vocab(cfg.user_vocab)
    iv = load_vocab(cfg.item_vocab)
    cv = load_vocab(cfg.cate_vocab)
    loaders = {}
    if use_packed:
        t0 = time.perf_counter()
        pack = load_packed(packed_file)
        say(f"load {PACKED_FILENAME}: {pack.n_events} events in "
            f"{time.perf_counter() - t0:.3f}s", flush=True)
        for name, ngs in (("train", 0), ("valid", cfg.valid_num_ngs),
                          ("test", cfg.test_num_ngs)):
            stored = pack.splits[name].num_ngs
            if ngs and stored != ngs:
                raise SystemExit(
                    f"packed {name} split has {stored} negatives per line "
                    f"but the run asks for {ngs}; regenerate the pack")
            t0 = time.perf_counter()
            loaders[name] = make_loader(
                pack, name, cfg.max_seq_length,
                time_range_for_unit(cfg.time_unit),
                recent_k=args.counterfactual_recent_k,
                min_batch_rows=cfg.drop_remainder_min)
            say(f"view {name}: {loaders[name].view.n_rows} lines in "
                f"{time.perf_counter() - t0:.3f}s", flush=True)
    else:
        for name, path in files.items():
            t0 = time.perf_counter()
            ds = parse_file(path, uv, iv, cv, time_unit=cfg.time_unit,
                            recent_k=args.counterfactual_recent_k,
                            shuffle_seed=args.shuffle_history_seed)
            loaders[name] = SequenceLoader(
                ds, cfg.max_seq_length,
                min_batch_rows=cfg.drop_remainder_min)
            say(f"parse {name}: {len(ds)} lines in "
                f"{time.perf_counter() - t0:.3f}s", flush=True)

    kw = {}
    if cfg.model_type == "lgn":
        # the interaction graph of the train file or the pack (JAX
        # cli.py:343-347)
        t0 = time.perf_counter()
        kw["graph"] = (
            build_interaction_graph_packed(pack, len(uv), len(iv))
            if use_packed else
            build_interaction_graph(files["train"], uv, iv, cv))
        say(f"graph: {len(kw['graph'].src)} edges in "
            f"{time.perf_counter() - t0:.3f}s", flush=True)
    model = get_model_class(cfg.model_type)(cfg, len(uv), len(iv), len(cv),
                                            device=device, **kw)
    trainer = Trainer(model, cfg)

    def test_eval(**kw):
        t0 = time.perf_counter()
        res = run_weighted_eval(trainer.eval_step, trainer.state.model,
                                loaders["test"], cfg,
                                num_ngs=cfg.test_num_ngs, **kw)
        say(f"test eval time {time.perf_counter() - t0:.3f}s", flush=True)
        say(res, flush=True)
        return res

    if args.only_test:
        trainer.load_latest(cfg.model_dir)
        test_eval(calc_mean_alpha=cfg.model_type in ("clsr", "sli_rec"))
        return 0

    trainer.fit(loaders["train"], loaders["valid"],
                valid_num_ngs=cfg.valid_num_ngs, resume=args.resume)
    if trainer.best_epoch and cfg.model_dir:
        try:
            trainer.load_latest(cfg.model_dir)
        except IOError:
            pass
    test_eval()
    if args.write_prediction_to_file:
        predict_to_file(trainer.eval_step, trainer.state.model,
                        loaders["test"], cfg,
                        os.path.join(args.data_path, "output.txt")
                        if rank == 0 else os.devnull)
    return 0


if __name__ == "__main__":
    sys.exit(main())
