"""Smoke run of the PyTorch port on one NVIDIA GPU (no CPU mode).

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card check: CUDA present, `nvidia-smi` name and power limit, TF32 off;
  2. build every CUDA kernel from csrc/ and the C++ host library from
     native/ (the TSV parser, the ETL's expanding-history writer and CSV
     reader; nvcc and g++, one per source, all at once) and print the
     build seconds and ptxas' register/spill lines;
  3. K1 (fused eval scorer) against its plain PyTorch version at the
     two serving buckets B=64 x G=128 and B=8 x G=16, L=50, D=80, Dk=40,
     H0=80, H1=40, with history lengths 1..50, one all-masked row and BN
     folds from random running statistics: max abs error <= 1e-4, kernel
     and plain times (a call, and on the device alone by CUDA graph
     replay), the FP32 bound and the bound at the rate of the
     kernel's 3xTF32 tensor-core products, each with its achieved share;
     once, the error one TF32 pass would give (emulated in PyTorch);
  4. K2's forward (three-cell recurrence) against its plain version at
     U=H=40 with history lengths 1..L: at the serving buckets B=64 and
     B=8 (L=50, no carries) and at the Kuaishou length (B=400, L=250,
     with and without the carries): outs, h1, h2 within 1e-5 abs of the
     plain recurrence, the carries within 1e-5 abs of the plain ones, a
     second call bit-identical; ms a call and on the device by CUDA graph
     replay, also with each rows-a-block R forced (1, 4), us per
     dependent step, the plain version's ms and the byte bound with its
     share;
  5. serving at the clsr.yaml widths with Taobao UserBehavior-sized
     tables (987,995 users, 4,162,025 items, 9,440 categories, plus the
     OOV row), seeded random weights plus N(0, 0.1) noise: 64 requests
     x 100 candidates (bucket 128), 8 x 10 (bucket 16), 16 submits
     through AsyncScoringService; run with the default config (K1) and
     with use_pallas_scan (K1 + K2), the kernel launch counts set to 0
     just before each run and read just after.  Scores
     must be finite, in [0, 1], one per candidate; the two runs agree to
     1e-5; the kernel path equals use_pallas_eval_attention='off' to 1e-4
     and the CPU port on the 8 x 10 requests to 1e-4.  Prints the median
     dispatch latency and candidates/s of the 64 x 100 batch and the peak
     device memory;
  6. K3a and K3b (train-mode BN statistics) against their plain version
     at the two train shapes of the clsr.yaml scorers, B=400, L=50 and
     (G, D) = (5, 80) short-term, (1, 40) long-term, and at the Kuaishou
     history length L=250 (B=400, G=5, D=80): batch mean and var within
     1e-4 relative or 1e-6 abs (summation order), a second call
     bit-identical to the first; kernel times (a call, and on the device
     alone by CUDA graph replay) and plain times, the FP32 bound and the
     bound at the rate of the kernels' 3xTF32 tensor-core products, each
     with its achieved share;
  7. the train-mode scorer `fused_train_attention` (K3a, K3b, K1 with the
     batch folds; recompute backward) against `train_scorer_math` at the
     same shapes: output within 1e-4 abs, the four statistics as in 6,
     the gradient of every differentiable input within 1e-4 of its max
     abs; K1's time and bounds at G=5 and G=1, the forward and
     backward-recompute times; then K2 at the train shape B=400
     (lengths 1..50): the forward's carries against the plain ones (1e-5
     abs), the backward kernel plus its five weight products against the
     plain backward on the same carries and against autograd of the
     plain recurrence (each gradient within 1e-4 of its max abs); the
     forward with and without carries (each as a phase 4 case), the
     backward kernel alone, the weight products, the whole backward, the
     plain backward and the old route (the plain recurrence recomputed
     under autograd), and both bounds; then K2's backward at
     (B, L) = (400, 50), (500, 50) and (400, 250): each kernel gradient
     within 1e-5 of its max abs of `scan_backward_reference` in float64 on
     the same carries (the float32 plain version's own error beside it),
     the kernel, the weight products and the whole backward a call and
     on the device by CUDA graph replay, the kernel also with each rows a
     block R forced, and the byte bounds;
  8. training at the clsr.yaml widths with the Taobao-sized tables:
     seeded numpy batches of B=400, L=50, lengths 1..50, in-batch
     negatives drawn on the card from a seeded torch.Generator (G=5).
     The first batch with the kernel configuration
     (use_pallas_train_attention='on', use_pallas_scan) and with both
     gates off, from the same weights and generator seed: loss parts
     within 1e-4 relative, every gradient within 1e-4 of its max abs
     (1e-6 abs more where the gradient is zero up to rounding: a dense
     bias under train-mode BN, an output bias under a softmax), BN
     running statistics within 1e-5.  Then 6 steps with the kernels in
     turns with 6 plain steps on the same batches, the counts read
     around each: K3a 2, K3b 2, K1 2, K2 1 and K2's backward 1 per
     kernel step, none per plain step; finite losses; per path the
     median step ms (CUDA events), examples/s and peak device memory.  Last, torch.profiler
     over two steps of each path: host ms and device span per
     `train_step.<phase>` range, the device's busy share of the window,
     kernel launches per step and the kernels with the most device time.
     Then the cost of the reproducible gradient: 6 steps of each path
     with the sorted segment sums (`ops.segment_sum`) in turns with 6
     steps with the sums they replaced (`F.embedding`'s backward), the
     median step ms of each;
  9. K5 (row scatter) and K4 (row sweep) against their plain version at
     the bench shape (N=500,000, W=40, 58,000 unique sorted ids with the
     bench's skew, slabs of 2,048 rows) and at the compact update's
     item-pmn shape (N=4,162,026, W=96, Mc=22,000 ending in dropped ids
     >= N): bit-identical (the kernels only copy), and index_copy_ on the
     valid ids too; kernel, plain, index_copy_ and bound times, each
     timed call on fresh ids and rows (the bound is the function's
     bytes), and the host us per call of the K5/K4 wrappers and of
     index_copy_ (per call and host: medians of 5 rounds in turns).  K5
     also at the other widths of the lazy paths' entries (cate and user
     pmn, the legacy split layout with duplicate ids), bit-identical.
     Then the compact step's K5 group at Taobao sizes (item, cate and two
     user pmn entries, and with the four param entries beside them) in
     one launch against the same entries by index_copy_: bit-identical,
     per call, on the device and on the host.  Then the bench entry point
     `clsr_tpu_torch.bench_row_update` (K4's path) at 10 applications x
     3 calls, the counts set to 0 before it;
 10. lazyadam training at the clsr.yaml widths with the Taobao-sized
     tables and every kernel gate of phase 8: the first batch with the
     compact row engine (compact_rows auto, pmn layout) and with the
     legacy lazy path (off), from the same weights and generator seed:
     loss parts within 1e-4 relative, updated tables and moments within
     1e-5 abs (the two paths sum a repeated row's gradient in different
     orders), rows no batch id touches
     bit-identical to before, the table Parameters equal to pmn[:, :D]
     after the step (the update writes them; no sync).  Then 6 compact
     steps in turns with 6 legacy steps and 6 dense-Adam steps from
     the same weights, the counts read around each: K5 1 per lazy step,
     compact and legacy, and none per dense step, K3a 2, K3b 2, K1 2,
     K2 1 and its backward 1; finite losses; per path
     the median step ms, examples/s, device memory kept between steps
     and its peak, and torch.profiler over two steps (host ms of
     `train_step.row_update`); the reproducible sums' cost as in phase 8
     (compact: `segment_sum` against `index_add_`; legacy: the lookups).  In phase 9, K4/K5 and index_copy_ are
     also timed on the device alone (one call per fresh set captured in
     a CUDA graph and replayed), beside their per-call time.
     Then the reproducible gradient's sums (`ops/segment_sum.py`) alone:
     `table_grad` on a 41-row table with 25,000 ids and on the item table
     with 20,000 ids half of them the padding id 0: three calls
     bit-identical, no host sync (sync debug mode "error"), within 1e-5
     of the largest entry of an f64 sum (F.embedding's gradient beside
     it, and its three calls apart), the ms a call of `segment_sum` and
     `table_grad`;
 11. train and evaluate end to end: the port's `write_synthetic_dataset`
     (5,000 users, 50,000 items, 1,000 categories, seed 0; valid 1 + 4,
     test 1 + 99, cut to its first 400 groups, 3,500 in phase 13) in a
     temporary directory; each split parsed by the C++
     parser and by the Python loop, both timed, ids, offsets and labels
     equal and the time features within 1e-6 abs.  Run A drives
     `clsr_tpu_torch.cli.main` as a user does (the CLI's defaults: batch
     500, L = 50, clsr.yaml widths, K = 32 train steps a host call, each
     call replays a CUDA graph of the train step, the train set resident
     on the card, as `resident_data: auto` resolves; 2 epochs, seed 7, with
     --write_prediction_to_file): epoch s and examples/s, valid and test
     eval s, the test dict; the last valid auc above 0.5, one finite score
     per test line; then --only_test must print the same test dict
     (every key; it adds mean_alpha, as the JAX CLI does), and
     `ScoringService.load_latest` on run A's model_dir must score 64 test
     groups as the eval step does, within 1e-6.  Then run A's config with
     K = 1 (eager single steps) for one epoch of the train set's first
     20 batches in the same run, and
     torch.profiler over 1 streamed eager step and one streamed graphed
     call of 4 steps (a K = 4 `make_multi_train_step`: the device's idle
     share, kernels on the device and host launch calls a step).  Run B: the same config
     with use_pallas_scan, use_pallas_train_attention 'on', lazyadam and
     resident_data 'off' (streamed, as phase 13 compares),
     `Trainer.fit` for one epoch through the graph (capture s, graph
     pool, peak and kept device memory) and the test eval, the counts read
     around each (K5 and K2's backward once a step, K3a, K3b and K1 twice,
     K2's forward once a step and once a valid dispatch; K1 and K2 once a
     test dispatch); every test prediction with K1 off on the same
     weights within 1e-4 abs; at the fit's shapes (run B's first train
     batch, B = 500, and one test batch of 5 x 100) on run B's weights,
     the kernel-gated train and eval steps against the plain ones
     (`training.kernel_check`: scores 1e-4 abs, loss parts 1e-4 rel,
     gradients 1e-4 of their max abs, BN statistics 1e-5, K5's group bit
     for bit against its plain version); torch.profiler over 4 eager
     and 4 graphed streamed steps (one call of 4); run B's config with
     K = 1 for the train set's first 20 batches (a depth cut of its
     epoch); fits of 20 batches with prefetch_batches 2 and 0 (dense
     Adam, kernels on) and two lazyadam fits, each pair bit-identical
     (every model and optimizer tensor, the valid metrics) with
     deterministic algorithms off;
 12. (inside phase 11, on its data) for the run A and run B configs,
     from one state and one generator seed: one call of
     `make_multi_train_step` at K = 32 (its first step the eager
     warm-up, 31 replays of the captured step) and a replayed tail step
     against 33 eager single steps on the same batches: every weight, BN
     buffer, Adam and lazy tensor and every loss part bit-identical,
     the generator's state equal (what an autosave keeps; so too in
     phases 14-17's graphed checks), deterministic algorithms off;
     the call's launch counts 32 times the eager step's.
 13. (inside phase 11, on its data) device-resident data and length
     buckets.  (1) Run B's configuration resident and streamed, and a
     dense-Adam pair, one graphed epoch each from one seed: every model,
     optimizer and BN tensor and the valid metrics bit-identical; each
     fit's epoch examples/s, the upload's MB and s; a resident call of 8
     steps under `torch.cuda.set_sync_debug_mode("error")`, and
     torch.profiler over two more (idle share, host launch calls a
     step).  (2) Run C: run B's configuration with length_buckets 'auto'
     (edges 16,32 if auto picks none; masked BN statistics, 64 refresh
     batches): Lb x rows, each graph's capture s and pool, epoch
     examples/s against (1)'s resident run B, the refresh's s; launches K5
     and K2's backward once a step, K3a/K3b/K1 none in training, K2's
     forward once a step, a refresh batch and a valid dispatch; the valid
     auc above 0.5.  (3) On run C's weights the test eval with buckets
     against without: every prediction and metric within 1e-4 abs, both
     timed, K1 and K2 once a bucketed dispatch; K1 and K2 against their
     plain versions on the inputs the eval gives them at every eval Lb
     (1e-4 abs), and the kernel train and eval steps against the plain
     ones at every train Lb (`training.kernel_check` with `same_kinks`:
     the plain step on the kernel step's side of each ReLU, the inputs
     that changed sign counted and each within 1e-4 of zero on both
     sides: among the logit head's 250,000 ReLU inputs one may sit
     within K2's forward's rounding of zero, and its flip moves the
     gradients by ~1e-3 of their max abs).  (4) On the
     bucket with the most rows, one graphed resident call of 32 steps and
     a replayed tail against 33 eager steps on the same gathered batches:
     every state tensor and loss part bit for bit, the call's launches 32
     times the eager step's.
 14. the other optimizers, bf16 tables and compute, int8 serving tables.
     After phase 10, on the Taobao-sized tables: (a) K5 on bf16 rows at
     phase 9's bench shape (500,000 x 40, 58,000 skewed ids) bit-
     identical to its plain version and to index_copy_, a call, on the
     device by graph replay and on the host, the bound the function's
     bytes; the compact step's group of 8 with the four tables in bf16
     beside their f32 pmn rows, one launch, bit-identical; (b) the
     lazyadam compact step at B = 400 in f32, with bf16 tables, and with
     bf16 tables and compute: each configuration's kernel step against
     its plain step on phase 10's first batch (f32: phase 8/10's gates;
     bf16 tables: the errors the f32 code gives on the same values, the
     table rows no further off than there, one bf16 step aside; bf16
     compute: scores 2e-2 abs, loss parts 1e-2 rel; K5 bit-identical;
     K2 not launched under bf16 compute), then a graphed call of 8 steps
     timed: ms a step, memory kept and peak, table MB; (e) int8 serving:
     the f32 service's weights saved and loaded by `ScoringService(...,
     checkpoint=..., int8_tables=True)`, 64 x 100 and 8 x 10: one K1
     launch a dispatch, scores within 0.03 of the f32 service and 1e-4
     of the CPU port's int8 service, table MB, dispatch ms, peak.
     Inside phase 11, after phase 13, on its data: (c) run B resident
     and graphed with bf16 tables and compute for one epoch (finite
     loss, valid auc > 0.5, K2 never, K1/K3a/K3b twice and K5 once a
     step, examples/s beside phase 13's f32 run B, the trainer's note
     that K2 gives way) and 32 graphed steps + a tail against 33 eager
     ones bit for bit; (d) each other optimizer (adadelta, adagrad,
     sgd, pgd, rmsprop, ftrl, padagrad, and "momentum", which runs sgd)
     with dense tables: 4 graphed steps + a tail against 5 eager ones
     bit for bit, finite loss, examples/s of a call of 4 replays.
 15. the model zoo (GRU4Rec, A2SVD, DIN, DIEN, SLI-Rec at their yaml
     widths, and CLSR with use_fused_encoders false and sequential_model
     time4lstm and gru) with phase 5's Taobao-sized tables, seeded
     weights plus N(0, 0.1) noise and BN statistics away from 0 / 1.
     After phase 14: (a) each model served, 64 x 100 (bucket 128) and
     8 x 10 (bucket 16) through ScoringService, the counts read around
     the two dispatches: K1 once a dispatch for DIN, SLI-Rec and CLSR
     (the short-term scorer), none for the rest, K2 never; scores finite
     in [0, 1], one per candidate; DIN and SLI-Rec with K1 against
     use_pallas_eval_attention 'off' and every model against the CPU
     port on the 8 x 10 requests, 1e-4 abs; the median 64 x 100 dispatch
     ms and candidates/s.  (b) each model trained at B = 400, L = 50,
     lengths 1..50, G = 5, use_pallas_train_attention 'on': for DIN and
     SLI-Rec the kernel steps against the plain ones on the first batch
     (`kernel_check.compare_steps`, lazyadam compact, phase 8's gates;
     past them the per-tensor numbers are printed and the phase stops);
     then dense Adam and lazyadam compact, each as one call of 4
     graphed steps (the first the eager warm-up) and a replayed tail
     against 5 eager steps, every state tensor and loss part bit for
     bit, the launches a step K3a = K3b = K1 = 1 (DIN, SLI-Rec), 2
     (CLSR), 0 (the rest), K2 0, K5 1 a lazyadam step; one more call of
     4 replays timed by CUDA events (ms a step, examples/s, peak
     memory), beside CLSR's fused lazyadam step (phase 10's
     configuration) in the same run; torch.profiler over one eager
     lazyadam step of each (kernels a step, device busy ms, the kernels
     with the most device time).  Inside phase 11, after phase 14,
     on its data: (c) one epoch of `clsr_tpu_torch.cli` with --model DIN
     and --model DIEN (the CLI's defaults): epoch examples/s, test eval
     s, valid auc above 0.5, K1 in DIN's evals only, K2 never.
 16. the rest of the zoo (Caser, NCF, NextItNet at their yaml widths;
     NextItNet trains per position) with phase 5's Taobao-sized tables,
     seeded weights as in phase 15.  After phase 15: (a) each served as
     in 15 (a): 64 x 100 and 8 x 10, scores finite in [0, 1], one per
     candidate, card = CPU port on the 8 x 10 to 1e-4, K1 = K2 = 0, the
     median 64 x 100 dispatch ms and candidates/s; (b) each trained at
     B = 400, L = 50, lengths 1..50, G = 5 with dense Adam and with
     lazyadam (Caser compact; NCF and per-position NextItNet on the
     legacy path): one call of 8 graphed steps and a replayed tail
     against 9 eager steps, every state tensor and loss part bit for
     bit, K5 once a lazyadam step and no other kernel; one more call of
     16 replays timed (ms a step, examples/s, peak memory) beside phase
     15's CLSR fused lazyadam step; torch.profiler over one eager step;
     then LGN with dense Adam on the interaction graph of a seeded
     history of 1..50 items and a target for each of the 987,995 users
     (E, the host build s), the same graphed gate, its step ms and peak
     memory against the card's 80 GB (its timed call 4 replays).
     Inside phase 11, after phase 15 (c): (c) the CLI with --model
     NEXTITNET for three epochs (its first two score at chance on this
     set, as JAX's do) and --model LGN for one (the CLI builds LGN's
     graph from the train file): epoch examples/s, test eval s, the
     restored epoch's valid auc above 0.5, no kernel launched.
 17. long-context attention and the host remainder.  After phase 16:
     (a) clsr.yaml's widths with enable_bn False and
     attention_block_size 256 (both attentions blockwise,
     `ops/long_context.py`), phase 5's Taobao-sized tables, B = 400,
     G = 5, L = 1,000 with lengths 1..1,000, lazyadam, K2 on: the
     blocked attention against the port's unblocked TargetAttention (BN
     off, the same parameters) at the short-term shape, output within
     1e-5 and every gradient within 1e-4 of its max abs, both timed;
     K2's forward (with the carries) and backward at (400, 1,000)
     against their plain versions, each plain version run once, the
     kernels by graph replay; one call of 16 graphed steps and a
     replayed tail against 17 eager steps, every state tensor, loss
     part and the generator's state bit for bit, K2, its backward and
     K5 once a step and K1, K3a, K3b never; the graphed step ms;
     torch.profiler over one eager step; 64 x 100 and 8 x 10 requests
     with histories of 1..1,000 served (K2 once a dispatch, card = CPU
     on the 8 x 10 to 1e-4, the 64 x 100 dispatch ms); one eager step's
     peak memory and ms, blocked and unblocked, at L = 1,000 and 4,000.
     Inside phase 11, right after run B's epoch and test eval: (b) run
     B's configuration with an autosave every call, killed after call
     2, then resumed by a fresh trainer: every state tensor, the valid
     and the test metrics bit-identical to run B's; (c) both fits write
     histograms and TensorBoard events at show_step 32: the histogram
     step on the card against the CPU on the resumed weights and probe
     batch (the tables' counts equal; the card's activations bucketed
     on both sides equal; from each side's own forward no more values
     in another bucket than lie within 1e-3 of a bucket edge), and the
     event files read back by `utils/summaries.py` `read_events`.
 18. the ETL and the packed format, from a raw log to a fit.  After
     phase 17: (a) a seeded raw log in the public UserBehavior.csv
     schema (uid,iid,category,behavior,ts), 2,000,000 rows (a depth cut
     of the public file's 100,150,807) of ~20,000 users at its ~101 rows
     a user, Zipf-like item popularity over 4,162,024 item ids of 9,439
     categories (0.5% of items show a second category), each user's 1-5
     favoured categories taking 80% of their rows, pv 89.5% and cart /
     fav / buy, times over 2017-11-25 .. 12-03 with 0.1% outside;
     (b) `data/etl.py` `data_preprocessing` four times from it (seed 18,
     valid 1 + 4, test 1 + 99): packed, then the TSVs by the Python
     engine, by C++ (`engine="native"`) and by 4 worker processes; each
     stage's seconds (read, filters, instances, split, expand or pack,
     vocab, negatives); the three vocabs equal across the four runs, the
     three train TSVs byte-identical, the packed train view equal to the
     parsed train TSV's field for field; the TSVs' MB against
     packed.npz's, the TSV parse s against the pack's load + views s,
     the process's peak RSS; (c) run B's configuration (K2 and its
     backward, K3a/K3b, K1, lazyadam with K5, K = 32 graphed) at B =
     400: 1 graphed call fed from the packed loader and from the TSV
     loader, every state tensor bit for bit; then one epoch and the
     1 + 99 test eval from the pack, the counts read around each (as run
     B's), the valid and test metrics (test auc above 0.5) and
     examples/s; (d) `clsr_tpu_torch.cli` as a user runs it from the
     raw log with --etl_format packed (the defaults, one epoch), then
     --only_test on its directory: no new ETL, the same test dict, the
     valid auc above 0.5.
 19. the (data, model) mesh.  After phase 18: the one-rank port on the
     card first (clsr.yaml, Taobao-count tables, seeded spread weights,
     B = 400, every kernel gate), then a 4-rank gloo world at (2, 2) on
     the one card (`parallel.distributed.run_local_world`; gloo stages
     each collective through host memory: a transport, not NCCL), each
     rank: (a) lazyadam compact, flat batch (100 rows a rank), 8 eager
     steps, the launch counts zeroed before and read after: K1, K2, K2
     bwd, K3a, K3b and K5 above 0 on every rank; the loss parts within
     1e-4 relative of one rank's, every parameter, BN statistic and
     touched table row within 1e-4 (the zero-by-construction biases and
     the BN means they shift within Adam's sign-flip bound, 2.1 lr a
     step), run twice, bit for bit; (b) dense Adam, mesh_flat_batch off
     (200 rows a rank), 4 steps, the same gates but K5; (c) the mesh
     `ScoringService` on 64 x 100 requests within 1e-5 of the
     one-device scores; (d) a lazyadam checkpoint at phase 11's table
     counts (10,000 users, 50,000 items, 1,001 cates: the checkpoint
     stays small) saved on the mesh, loaded on one device, its eval
     within 1e-5 of the mesh's.
 20. the rest of the mesh's training path, inside phase 19's world (no
     second spawn), clsr.yaml, phases 5-10's tables, B = 400, each rank:
     (a) lazyadam compact, flat, `mesh_update_routing: owner` (capacity
     4, the interleaved rows 'auto' then takes), phase 19's 8 steps,
     twice: the loss parts within 1e-4 relative of phase 19 (a)'s
     broadcast run on the rank and of the one-rank run, the state held to
     the one-rank run with phase 19's gates, route_overflow 0, the two
     runs bit for bit, K5 once a step; the collective bytes a step a
     rank (parallel/collectives.py `count_collectives`) of the owner and
     of phase 19 (a)'s broadcast merge; (b) a capacity of one slot a
     bucket (every step overflows) under `fallback`, 4 steps: bit for
     bit a broadcast run on the same interleaved rows, route_overflow
     above 0 after each step; (c) the same capacity under `drop`: the
     same overflow counts a step as (b), and no float all_gather or
     all_to_all carrying the item table's [Mi, D] gradient stream, which
     the broadcast merge all_gathers; (d) on phase 11's synthetic set
     (its first 16 x 400 train rows, 200 valid groups, 64 test groups;
     the tables at its vocab counts rounded up to even, each sharded):
     a fit of 16 lazyadam steps, 4 a call, every kernel gate, streamed
     and with `resident_data: auto` (resident on the mesh), the eval
     history and every state tensor bit for bit, K1, K2, K2 bwd, K3a,
     K3b and K5 launched on the resident path; then `length_buckets:
     auto` (8 refresh batches), K1 and K2 against their plain versions
     at every Lb on the mesh (1e-4, 1e-5); (e) the sequence-parallel
     merge of long-context attention, L = 1,000 keys over the 4 ranks
     (B = 100, clsr.yaml's scorer, block 64): the output and the keys'
     and parameters' gradients against the one-rank blocked attention
     (1e-5, 1e-4 of max abs); (f) GRU4Rec and DIN (their yaml widths,
     the train kernels on) 4 lazyadam steps each, held to one rank with
     phase 19's gates.
 21. the settings the mesh refused until this slice, inside phase 19's
     world, each against the one-rank port from the same seed: (a) LGN
     (lgn.yaml's widths) on phase 20 (d)'s rows of phase 11's set, its
     graph from those train rows (each user's last row) and its tables
     at phase 20's counts (5,002 x 40, 50,002 x 32, 1,002 x 8, every one
     row-sharded), 4 dense-Adam steps of B = 400, twice: the losses
     within 1e-4 relative, phase 19's state gates, the two runs bit for
     bit, and the tables' all_gathers over the model row exactly one
     block each a step a rank (`count_collectives`); (b) phase 20 (d)'s
     streamed and resident fits with an autosave after every call,
     killed after call 3 and 2, resumed by a fresh Trainer: the state's
     digest and the eval history equal phase 20 (d)'s uninterrupted
     fits', K1, K2, K2 bwd, K3a, K3b and K5 launched on every rank; (c)
     the histogram step of phase 19 (d)'s model at its table counts on a
     seeded batch of 400: JAX's tags, lo and hi within 1e-5 relative and
     the counts within 1% of the one-rank step's; (d) the async
     frontend on the mesh service (phase 19 (d)'s table counts): 64 x
     100 requests submitted from 16 threads on rank 0, equal to the
     synchronous mesh service's scores of the same dispatches bit for
     bit, every rank the same dispatches and eval steps, K1 and K2
     launched on every rank, submit refused on the others; (e) the mesh
     service's save and load, f32 and int8: its logical file loaded on
     one rank and a one-rank file loaded on the mesh, each bit for bit
     the scores of a service of the same seed on that topology, and the
     mesh's scores within 1e-5 of one rank's.
 22. graphed mesh steps over NCCL and the port's scaling model.  After
     phase 21: (a) on any card count, the one-rank graphed lazyadam
     compact step (clsr.yaml's widths and kernel gates) at the scaling
     model's two configurations (clsr_tpu_torch/scaling_model.py):
     Taobao at b = 512, L = 50, tables of 8,000 / 100,000 / 5,000 rows,
     and Kuaishou at b = 256, L = 250, 100,000 / 500,000 / 2,000: a call
     of 8 steps, then 8 replays each between CUDA events, the median;
     and the scaling model's table from those times (its bytes counted
     meanwhile in gloo worlds of 2, 4 and 8 ranks on the host's CPU).
     (b) When the host has 4 cards or more: `mesh_phase(smi, "nccl")`,
     phases 19-21 over NCCL a card a rank (phase 20 (d)'s fits then
     replay graphs), and in that world each check's steps eagerly (K =
     1) against one graphed call of the same steps: phase 19 (a) (the
     broadcast merge, flat) and (b) (dense Adam, replicated: the static
     `reduce_grads`), 20 (a) (the owner merge, capacity 4), 20 (b) (one
     slot, every step the broadcast tail), the owner merge at capacity
     1.1 (the user tables' branch differs from the item table's on some
     steps), 21 (a) (LGN): the loss parts and a digest of every state
     tensor bit for bit, the collectives (kind, group, shape, dtype,
     bytes) call for call, the branch patterns read; K1, K2, K2 bwd, K3a,
     K3b and K5 launched in the graphed calls; phase 20 (d)'s streamed,
     resident and bucketed fits with every call's steps forced eager
     against the graphed ones (phase 21 (b)'s resumed fits equal those);
     the CLI at (2, 2) over NCCL on phase 11's synthetic set, one epoch,
     the default K = 32 and K = 1: the same test dict.  Prints the step
     ms a rank graphed and eager beside one rank's graphed step at 100
     and 400 rows, capture s and pool MB a rank, `nvidia-smi topo -m`,
     and the scaling model's predicted step at (2, 2) and (4, 1) (one
     rank's step at 100 rows plus the counted bytes over NVLink) beside
     the graphed NCCL steps measured there.  On fewer cards one line
     says that (b) was not run and how to run it.
Then one JSON line of the kernels (`launches_by_path` with the phase-11
paths `fit_cli`, run A and its --only_test, and `fit_kernels`, run B's
graphed epoch and test eval, the phase-13 paths `fit_resident`, the
resident run B epoch, and `fit_buckets`, run C's epoch and bucketed test
eval, and the phase-14 paths `p14_bf16_train` (the timed bf16 calls),
`p14_int8_serve`, `p14_bf16_fit` and `p14_optimizers` (the graphed
calls), the phase-15 paths `p15_zoo_serve` (the served dispatches),
`p15_zoo_train` (the graphed calls) and `p15_zoo_fit` (the CLI epochs
and their evals), and phase 16's `p16_zoo_serve`, `p16_zoo_train` and
`p16_zoo_fit` likewise, phase 17's `p17_long_train` (the graphed
call), `p17_long_serve` and `p17_resume_fit` (the resumed fit), and
phase 18's `p18_etl_fit` (the epoch and test eval from the pack) and
`p18_cli` (the CLI run from the raw log and its --only_test), and
phase 19's `p19_mesh_train` (run (a)'s first 8 steps, summed over the
4 ranks), and phase 20's `p20_owner_train` ((a)'s first run),
`p20_mesh_resident` ((d)'s resident fit) and `p20_zoo_mesh` ((f)), and
phase 21's `p21_mesh_resume` ((b)'s killed and resumed fits) and
`p21_mesh_async` ((d)'s async dispatches), each summed over the 4
ranks, and on a host of 4 cards phase 22's `p22_mesh_graphed` ((b)'s
graphed calls, summed over the ranks)), the
card's name and power limit, and the final status line.
A copy of all numbers goes to
chiprun_out/chip_smoke.json.
"""

import ast
import contextlib
import filecmp
import io
import itertools
import json
import os
import re
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import datetime

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_FP32_FLOPS = 67e12        # FP32 outside the tensor cores (data sheet)
H100_HBM_BYTES = 3.35e12       # HBM3 bytes/s (data sheet)
H100_TF32_FLOPS = 495e12       # TF32 on the tensor cores, dense (data sheet)
K1_TOL, K2_TOL, SERVE_TOL = 1e-4, 1e-5, 1e-4
# Taobao UserBehavior's users, items and categories, plus the OOV row
USERS, ITEMS, CATES = 987_995 + 1, 4_162_025 + 1, 9_440 + 1


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device ms per call of fn, by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def self_device_us(e):
    """A profiler event's own device time in us (name by torch version)."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def kernel_events(prof):
    """The device kernels of a profile, annotations left out."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("train_step.")]


def graph_ms(fn, calls, reps=5):
    """Device ms per call of fn: `calls` calls captured in one CUDA graph
    and replayed `reps` times between CUDA events, so the host's launch
    cost is left out (the device's gap between graph nodes stays in)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def bound(n_bytes, n_flops):
    t_bytes = n_bytes / H100_HBM_BYTES * 1e3
    t_ops = n_flops / H100_FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def card_check():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs only on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    return smi


def build_kernels():
    from clsr_tpu_torch.ops import _build
    secs = _build.build(_build.LIBRARIES)
    log(f"build: {secs:.2f} s for {', '.join(_build.LIBRARIES)}")
    for name in _build.KERNELS:
        logf = _build.library_path(name).with_suffix(".log")
        for line in logf.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return secs


def tf32(x):
    """x rounded to TF32 (10 mantissa bits, ties away), as the kernel
    rounds the high parts of its tensor-core operands."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def one_pass_tf32_scorer(keys, kp, q, mask, wk, wq, wm, a0, c0, w1, a1, c1,
                         w2):
    """K1's function with both products taken once in TF32 (operands
    rounded, f32 sums): what a one-pass TF32 kernel would give."""
    from clsr_tpu_torch.ops import fused_attention as fa
    x0 = tf32(kp[:, :, None, :] * q[:, None, :, :]) @ tf32(wm)
    x0 = x0 + (tf32(kp) @ tf32(wk))[:, :, None, :] + (q @ wq)[:, None]
    y0 = torch.relu(x0 * a0 + c0)
    logits = torch.relu((tf32(y0) @ tf32(w1)) * a1 + c1) @ w2
    logits = torch.where(mask[:, :, None] > 0, logits,
                         torch.full_like(logits, fa.MASK_PADDING_VALUE))
    return torch.einsum("blg,bld->bgd", torch.softmax(logits, dim=1), keys)


def k1_cost(args):
    """K1's work on these inputs (masked positions skip the MLP, so only
    the valid ones count): flops, the FP32 bound (every multiply-add at
    the FP32 rate, K1's `bound_ms`) and the bound at the rate of the
    instructions the kernel issues (its two products 3xTF32 on the tensor
    cores, three products each at the TF32 rate, the rest at FP32)."""
    keys, kp, q, mask = args[:4]
    B, L, Dk = keys.shape
    G, D = q.shape[1:]
    h0, h1 = args[9].shape
    n = int(mask.sum().item())
    mlp = 2 * n * G * (D * h0 + h0 * h1) + 2 * n * D * h0
    rest = 2 * B * G * D * h0 + 2 * B * L * G * Dk
    n_bytes = 4 * (sum(t.numel() for t in args) + B * G * Dk)
    fp32_ms, fp32_by = bound(n_bytes, mlp + rest)
    tc_ms = max(n_bytes / H100_HBM_BYTES,
                3 * mlp / H100_TF32_FLOPS + rest / H100_FP32_FLOPS) * 1e3
    return dict(flops=mlp + rest, bytes=n_bytes, n_valid=n,
                bound_ms=fp32_ms, bound_by=fp32_by, tc_bound_ms=tc_ms)


def k1_line(cost, ms, device_ms, plain_ms, err):
    return (f"kernel {ms:.4f} ms a call ({device_ms:.4f} ms on the device "
            f"by CUDA graph replay), plain {plain_ms:.4f} ms, "
            f"max_abs_err {err:.3e} (tol {K1_TOL}) | "
            f"{cost['flops'] / 1e9:.3f} GFLOP over {cost['n_valid']} valid "
            f"positions, {cost['bytes'] / 1e6:.2f} MB | FP32 bound "
            f"{cost['bound_ms']:.4f} ms ({cost['bound_by']}, "
            f"{cost['bound_ms'] / ms:.1%} achieved), 3xTF32 bound "
            f"{cost['tc_bound_ms']:.4f} ms ({cost['tc_bound_ms'] / ms:.1%} "
            f"achieved)")


def check_k1(smi):
    """K1 at the two serving buckets: B=64 x G=128 (the 64 x 100 batch)
    and B=8 x G=16 (the 8 x 10 batch), with the one-pass TF32 error once
    as a finding."""
    from clsr_tpu_torch.ops import fused_attention as fa
    from clsr_tpu_torch.ops.initializers import get_initializer
    from clsr_tpu_torch.ops.mlp import FcnNet
    dev = torch.device("cuda")
    L, D, Dk, H0, H1 = 50, 80, 40, 80, 40
    out = {}
    for shape, B, G in (("serve", 64, 128), ("serve_small", 8, 16)):
        g = torch.Generator(device=dev).manual_seed(0)
        fcn = FcnNet(D, (H0, H1), ("relu",), get_initializer("tnormal", 0.3),
                     g, dev, enable_bn=True, out_dim=1,
                     split_first=True).eval()
        with torch.no_grad():
            for i in range(2):
                bn = getattr(fcn, f"bn{i}")
                bn.mean.normal_(0.0, 0.3, generator=g)
                bn.var.uniform_(0.5, 1.5, generator=g)
                bn.scale.uniform_(0.5, 1.5, generator=g)
                bn.bias.normal_(0.0, 0.3, generator=g)
        lengths = torch.randint(1, L + 1, (B,), generator=g, device=dev)
        lengths[0] = 0                                   # all-masked row
        mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).float()
        r = lambda *s: torch.randn(*s, generator=g, device=dev)
        args = (r(B, L, Dk), r(B, L, D), r(B, G, D), mask) + \
            fa.fold_scorer_params(fcn, D, True)
        got = fa.fused_eval_attention(*args)
        torch.cuda.synchronize()
        want = fa.eval_scorer_reference(*args)
        err = (got - want).abs().max().item()
        rel = ((got - want).abs() / want.abs().clamp_min(1e-3)).max().item()
        ms = cuda_ms(lambda: fa.fused_eval_attention(*args))
        device_ms = graph_ms(lambda: fa.fused_eval_attention(*args), 20)
        plain_ms = cuda_ms(lambda: fa.eval_scorer_reference(*args))
        cost = k1_cost(args)
        log(f"K1 eval_scorer [{shape}: B={B} L={L} G={G} D={D}] "
            + k1_line(cost, ms, device_ms, plain_ms, err) + f" | {smi}")
        if not err <= K1_TOL:
            raise AssertionError(f"K1 [{shape}] disagrees with its plain "
                                 f"version: {err}")
        out[shape] = dict(max_abs_err=err, max_rel_err=rel, ms=ms,
                          device_ms=device_ms, plain_ms=plain_ms, **cost)
        if shape == "serve":
            one_pass = (one_pass_tf32_scorer(*args) - want).abs().max().item()
            log(f"finding: K1's products in one TF32 pass (operands rounded "
                f"to TF32, emulated in PyTorch) give max_abs_err "
                f"{one_pass:.3e} against the plain version (tol {K1_TOL}); "
                f"the kernel's 3xTF32 split gives {err:.3e}")
            out[shape]["one_pass_tf32_err"] = one_pass
    return dict(out["serve"], serve_small=out["serve_small"])


def k2_inputs(B, L, seed, U=40, H=40):
    """K2's inputs on the card: history lengths uniform in 1..L, inputs
    at std 0.7 and recurrent weights at about the model's glorot scale
    (with std 0.7 the GRUs turn chaotic and f32 itself drifts from f64 by
    ~0.1 over 50 steps, which would test rounding, not the kernel)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.7
    w = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.15
    lengths = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).float()
    return (r(B, L, 2 * U), r(B, L, U), r(B, L, 4 * H), r(B, L, H),
            r(B, L, H), r(B, L, H), r(B, L, 2 * H), r(B, L, H), mask,
            r(B, U), w(U, 2 * U), w(U, U), w(H, 4 * H), w(H, 2 * H),
            w(H, H))


def k2_forward_case(shape, args, keep, smi, graph_calls=20, plain_iters=5):
    """K2's forward on `args`, with the carries if `keep`: outs, h1f, h2f
    against `scan_reference` and the carries against
    `scan_forward_reference` (1e-5 abs), a second call bit-identical; ms
    a call (CUDA events), on the device (CUDA graph replay) with the
    wrapper's rows a block and with each of ROWS forced, the
    plain version's ms, the byte bound, us per dependent step and the
    bound's share of the device time."""
    from clsr_tpu_torch.ops import fused_scan as fs
    B, L = args[2].shape[:2]
    U, H = args[9].shape[-1], args[14].shape[-1]
    run = lambda: fs._forward(*args, keep_carries=keep)
    first, second = run(), run()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(first, second)
               if x is not None)
    plain = ((lambda: fs.scan_forward_reference(*args)) if keep
             else (lambda: fs.scan_reference(*args)))
    want = plain()
    err = max((x - y).abs().max().item() for x, y in zip(first, want))
    ms = cuda_ms(run)
    device_ms = graph_ms(run, graph_calls)
    rows = fs.rows_per_block(B, fs._sm_count(args[2].device))
    pick = fs.rows_per_block
    rows_device_ms = {}
    try:
        for forced in fs.ROWS:
            fs.rows_per_block = lambda *_, r=forced: r
            rows_device_ms[forced] = graph_ms(run, graph_calls)
    finally:
        fs.rows_per_block = pick
    plain_ms = cuda_ms(plain, iters=plain_iters, warmup=1)
    n_valid = int(args[8].sum().item())
    macs = U * 2 * U + U * U + H * 4 * H + H * 2 * H + H * H
    flops = 2 * n_valid * macs
    n_out = B * L * H + B * U + B * H + (B * L * (U + 3 * H) if keep else 0)
    n_bytes = 4 * (sum(t.numel() for t in args) + n_out)
    bound_ms, bound_by = bound(n_bytes, flops)
    us_step = device_ms * 1e3 / L
    log(f"K2 clsr_scan [{shape}: B={B} L={L} U={U} H={H}"
        f"{', carries' if keep else ''}, R={rows} rows a block]: "
        f"max_abs_err "
        f"{err:.3e} (tol {K2_TOL} abs), second call "
        f"{'bit-identical' if same else 'DIFFERS'} | {ms:.4f} ms a call, "
        f"{device_ms:.4f} ms on the device by CUDA graph replay "
        f"({us_step:.3f} us per dependent step), device ms by R "
        + ", ".join(f"{r}: {t:.4f}" for r, t in rows_device_ms.items())
        + f" | plain {plain_ms:.4f} ms | {n_bytes / 1e6:.2f} MB, "
        f"{flops / 1e6:.1f} MFLOP, bound {bound_ms:.5f} ms ({bound_by}, "
        f"{bound_ms / device_ms:.1%} of the device time; the floor is the "
        f"{L} dependent steps) | {smi}")
    if not (err <= K2_TOL and same):
        raise AssertionError(f"K2 [{shape}] disagrees with its plain "
                             f"version ({err}) or with itself ({same})")
    return dict(max_abs_err=err, bit_identical=same, ms=ms,
                device_ms=device_ms, rows=rows,
                rows_device_ms=rows_device_ms, us_per_step=us_step,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                flops=flops, bytes=n_bytes, n_valid=n_valid, B=B, L=L)


def check_k2(smi):
    """K2's forward at the two serving buckets (B = 64 and 8, L = 50, no
    carries, as serving runs it) and at the Kuaishou length (B = 400,
    L = 250, with and without the carries); the train shape is phase 7's."""
    out = {}
    for shape, B, L, keep, seed in (("serve", 64, 50, False, 1),
                                    ("serve_small", 8, 50, False, 2),
                                    ("kuaishou", 400, 250, False, 3),
                                    ("kuaishou_carries", 400, 250, True, 3)):
        out[shape] = k2_forward_case(shape, k2_inputs(B, L, seed), keep, smi,
                                     graph_calls=10 if L > 50 else 20,
                                     plain_iters=2 if L > 50 else 5)
    return dict(out["serve"], name="clsr_scan",
                **{k: v for k, v in out.items() if k != "serve"})


def make_requests(rng, n_req, n_cands, n_users, n_items, n_cates,
                  max_hist=80):
    from clsr_tpu_torch.serving import ScoreRequest
    reqs = []
    t0 = 1_512_000_000.0                  # Dec 2017, inside UserBehavior
    for _ in range(n_req):
        # history lengths 1..max_hist; some longer than L at L = 50
        n = int(rng.randint(1, max_hist + 1))
        hist = rng.randint(1, n_items, n)
        cands = rng.randint(1, n_items, n_cands)
        reqs.append(ScoreRequest(
            user=f"u{rng.randint(1, n_users)}",
            hist_items=[f"i{i}" for i in hist],
            hist_cates=[f"c{1 + i % (n_cates - 1)}" for i in hist],
            hist_times=sorted(t0 - rng.randint(60, 8 * 86400, n)),
            current_time=t0,
            cand_items=[f"i{i}" for i in cands],
            cand_cates=[f"c{1 + i % (n_cates - 1)}" for i in cands]))
    return reqs


def vocab_for(reqs):
    from clsr_tpu_torch.data.vocab import Vocab
    ids = lambda toks: {t: int(t[1:]) for t in toks}
    users, items, cates = {}, {}, {}
    for r in reqs:
        users.update(ids([r.user]))
        items.update(ids(list(r.hist_items) + list(r.cand_items)))
        cates.update(ids(list(r.hist_cates) + list(r.cand_cates)))
    return [Vocab(dict(m, default=0)) for m in (users, items, cates)]


def spread(model, seed):
    """Seeded N(0, 0.1) noise on every parameter and BN running
    statistics away from 0 / 1 (phase 5's), in place."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g, device="cuda") * 0.1)
        for name, buf in model.named_buffers():
            if name.endswith(".mean"):
                buf.normal_(0.0, 0.05, generator=g)
            elif name.endswith(".var"):
                buf.uniform_(0.5, 1.5, generator=g)


def serve(smi):
    from clsr_tpu_torch.config import CONFIG_DIR, load_config
    from clsr_tpu_torch.ops.fused_attention import fused_eval_attention
    from clsr_tpu_torch.ops.fused_scan import fused_scan
    from clsr_tpu_torch.serving import AsyncScoringService, ScoringService

    n_users, n_items, n_cates = 987_995 + 1, 4_162_025 + 1, 9_440 + 1
    cfg = load_config(os.path.join(CONFIG_DIR, "clsr.yaml"),
                      user_vocab="u", item_vocab="i", cate_vocab="c", seed=0)
    rng = np.random.RandomState(0)
    big = make_requests(rng, 64, 100, n_users, n_items, n_cates)
    small = make_requests(rng, 8, 10, n_users, n_items, n_cates)
    async_reqs = make_requests(rng, 16, 30, n_users, n_items, n_cates)
    vocabs = vocab_for(big + small + async_reqs)
    sizes = (n_users, n_items, n_cates)

    t0 = time.perf_counter()
    base = ScoringService(cfg, *sizes, *vocabs)
    spread(base.model, 5)      # spread the scores; BN stats away from 0/1
    state = base.model.state_dict()
    torch.cuda.synchronize()
    table_mb = sum(p.numel() for n, p in state.items()
                   if n.endswith("_embedding")) * 4 / 1e6
    log(f"serve: model at clsr.yaml widths, tables {table_mb:.1f} MB, "
        f"built in {time.perf_counter() - t0:.2f} s")

    def service(**kw):
        svc = ScoringService(cfg.replace(**kw), *sizes, *vocabs)
        svc.model.load_state_dict(state)
        return svc

    def drive(svc):
        """The main path: 64x100, 8x10, 16 async submits."""
        out_big = svc.score(big)
        out_small = svc.score(small)
        asvc = AsyncScoringService(svc, max_wait_ms=5.0)
        try:
            out_async = [f.result(timeout=300)
                         for f in [asvc.submit(r) for r in async_reqs]]
        finally:
            asvc.close()
        return out_big + out_small + out_async, asvc.dispatches

    def check_scores(scores, reqs):
        for s, r in zip(scores, reqs):
            if s.shape != (len(r.cand_items),) or not np.isfinite(s).all() \
                    or s.min() < 0 or s.max() > 1:
                raise AssertionError("scores not finite in [0, 1], one per "
                                     "candidate")

    def latency(svc, reps=10):
        """Medians over `reps` 64x100 dispatches: the whole dispatch (host
        clock; it ends in a device-to-host copy), its host batch assembly
        alone, and its eval step alone (CUDA events)."""
        svc.score(big)
        total, host, step = [], [], []
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        for _ in range(reps):
            t = time.perf_counter()
            svc.score(big)
            total.append(time.perf_counter() - t)
            t = time.perf_counter()
            batch = svc._empty_batch(64, 128)
            for row, req in enumerate(big):
                svc._fill_row(batch, row, req, 128)
            host.append(time.perf_counter() - t)
            batch = batch.to("cuda")
            torch.cuda.synchronize()
            start.record()
            svc._eval_step(svc.model, batch)
            end.record()
            torch.cuda.synchronize()
            step.append(start.elapsed_time(end))
        med = statistics.median(total)
        return dict(latency_ms=med * 1e3, cands_per_s=64 * 100 / med,
                    host_ms=statistics.median(host) * 1e3,
                    step_ms=statistics.median(step))

    runs = {}
    all_reqs = big + small + async_reqs
    for run, kw in (("k1", {}), ("k1k2", dict(use_pallas_scan=True))):
        svc = base if run == "k1" else service(**kw)
        svc.score(big[:2])          # build and warm the kernels
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident_mb = torch.cuda.memory_allocated() / 1e6
        fused_eval_attention.launches = 0
        fused_scan.launches = 0
        scores, dispatches = drive(svc)
        torch.cuda.synchronize()
        counts = {"eval_scorer": fused_eval_attention.launches,
                  "clsr_scan": fused_scan.launches}
        peak_mb = torch.cuda.max_memory_allocated() / 1e6
        check_scores(scores, all_reqs)
        need = ["eval_scorer"] + (["clsr_scan"] if run == "k1k2" else [])
        for k in need:
            if counts[k] <= 0:
                raise AssertionError(f"{run}: kernel {k} never launched on "
                                     f"the serving path")
        lat = latency(svc)
        runs[run] = dict(scores=scores, launches=counts, peak_mb=peak_mb,
                         resident_mb=resident_mb,
                         async_dispatches=dispatches, **lat)
        log(f"serve[{run}]: launches {counts} | 64x100 dispatch median "
            f"{lat['latency_ms']:.3f} ms ({lat['host_ms']:.3f} ms host "
            f"assembly, {lat['step_ms']:.3f} ms eval step), "
            f"{lat['cands_per_s']:,.0f} candidates/s | peak "
            f"{peak_mb:.1f} MB of which {resident_mb:.1f} MB resident "
            f"before the run | async dispatches {dispatches} | {smi}")
        if run == "k1k2":
            del svc

    off = service(use_pallas_eval_attention="off")
    off_scores, _ = drive(off)
    plain = latency(off)
    log(f"serve[plain]: 64x100 dispatch median {plain['latency_ms']:.3f} ms "
        f"({plain['host_ms']:.3f} ms host assembly, {plain['step_ms']:.3f} "
        f"ms eval step), {plain['cands_per_s']:,.0f} candidates/s "
        f"(no kernels) | {smi}")
    del off
    d_runs = max(float(np.abs(a - b).max()) for a, b in
                 zip(runs["k1"]["scores"], runs["k1k2"]["scores"]))
    d_off = max(float(np.abs(a - b).max()) for a, b in
                zip(runs["k1"]["scores"], off_scores))

    cpu = ScoringService(cfg, *sizes, *vocabs, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in state.items()})
    cpu_small = cpu.score(small)
    del cpu
    d_cpu = max(float(np.abs(a - b).max()) for a, b in
                zip(runs["k1"]["scores"][64:72], cpu_small))
    log(f"serve: |k1 - k1k2| {d_runs:.3e} (tol {K2_TOL}), |k1 - plain| "
        f"{d_off:.3e} (tol {SERVE_TOL}), |cuda - cpu| on 8x10 "
        f"{d_cpu:.3e} (tol {SERVE_TOL})")
    if not (d_runs <= K2_TOL and d_off <= SERVE_TOL and d_cpu <= SERVE_TOL):
        raise AssertionError("served scores disagree across paths")
    return dict(table_mb=table_mb, plain=plain, d_runs=d_runs, d_off=d_off,
                d_cpu=d_cpu,
                runs={k: {kk: vv for kk, vv in v.items() if kk != "scores"}
                      for k, v in runs.items()})


P8_STEPS = 6        # phases 8 and 10: timed steps a path, in turns
TRAIN_SHAPES = (("short", 5, 80), ("long", 1, 40))   # (name, G, D)
TRAIN_B, TRAIN_L, H0, H1, DK = 400, 50, 80, 40, 40
# K3a/K3b's shapes: the two train scorers, and the short-term one at the
# Kuaishou history length of tests/test_kuaishou_shape.py;
# (name, G, D, L, seed)
STATS_SHAPES = (("short", 5, 80, TRAIN_L, 15), ("long", 1, 40, TRAIN_L, 11),
                ("kuaishou", 5, 80, 250, 16))
STATS_REL, STATS_ABS, GRAD_REL = 1e-4, 1e-6, 1e-4


def stats_err(got, want):
    """Worst excess of |got - want| over max(1e-4 |want|, 1e-6), <= 0
    when within tolerance, and the max abs error."""
    d = (got - want).abs()
    lim = torch.clamp(STATS_REL * want.abs(), min=STATS_ABS)
    return (d - lim).max().item(), d.max().item()


def mean_var(s, q, n):
    mean = s / n
    return mean, q / n - mean * mean


def train_inputs(g, G, D, B=TRAIN_B, L=TRAIN_L):
    """Scorer inputs at a train shape: history lengths 1..L, weights at
    about the model's scale, BN scales and shifts away from 1 and 0."""
    dev = torch.device("cuda")
    r = lambda *s, std=1.0: torch.randn(*s, generator=g, device=dev) * std
    u = lambda *s: torch.rand(*s, generator=g, device=dev) + 0.5
    lengths = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).float()
    return [r(B, L, DK), r(B, L, D), r(B, G, D), mask,
            r(4 * D, H0, std=0.1), r(H0, std=0.1), u(H0), r(H0, std=0.3),
            r(H0, H1, std=0.1), r(H1, std=0.1), u(H1), r(H1, std=0.3),
            r(H1, std=0.3)]


def stats_cost(B, L, G, D, second):
    """K3a's (second False) or K3b's work on these shapes, inputs read
    once and the per-channel sums written once: flops, the FP32 bound
    (every multiply-add at the FP32 rate, `bound_ms`) and, as k1_cost
    counts K1's, the bound at the rate of the instructions the kernel
    issues (its products 3xTF32 on the tensor cores, three products each
    at the TF32 rate, the rest at FP32)."""
    rows = B * L * G
    mlp = 2 * rows * D * H0 + 2 * B * L * D * H0
    rest = 2 * B * G * D * H0 + rows * D + 2 * rows * H0 + 3 * rows * H0
    n_in = B * G * D + B * L * D + 3 * D * H0
    if second:
        mlp += 2 * rows * H0 * H1
        rest += 3 * rows * H1
        n_in += 2 * H0 + H0 * H1
        n_out = 2 * H1
    else:
        n_out = 2 * H0
    n_bytes = 4 * (n_in + n_out)
    fp32_ms, fp32_by = bound(n_bytes, mlp + rest)
    tc_ms = max(n_bytes / H100_HBM_BYTES,
                3 * mlp / H100_TF32_FLOPS + rest / H100_FP32_FLOPS) * 1e3
    return dict(flops=mlp + rest, bytes=n_bytes, bound_ms=fp32_ms,
                bound_by=fp32_by, tc_bound_ms=tc_ms)


def check_k3(smi):
    from clsr_tpu_torch.ops import fused_train_attention as fta
    out = {}
    for shape, G, D, L, seed in STATS_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(seed)
        _, kp, q, _, k0 = train_inputs(g, G, D, L=L)[:5]
        wk, wq, wd, wm = k0.split(D)
        w = [(wk + wd).contiguous(), (wq - wd).contiguous(),
             wm.contiguous()]
        n = TRAIN_B * L * G
        p0 = fta.train_stats_reference(q, kp, *w)
        mean0, var0 = mean_var(*p0, n)
        a0 = torch.rsqrt(var0 + 1e-4).contiguous()
        fold = (a0, (-a0 * mean0).contiguous(),
                (torch.randn(H0, H1, generator=g, device="cuda")
                 * 0.1).contiguous())
        for name, second, call, plain in (
                ("train_stats0", False,
                 lambda: fta.train_stats0(q, kp, *w),
                 lambda: fta.train_stats_reference(q, kp, *w)),
                ("train_stats1", True,
                 lambda: fta.train_stats1(q, kp, *w, *fold),
                 lambda: fta.train_stats_reference(q, kp, *w, fold))):
            got, again = call(), call()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            errs = [stats_err(a, b) for a, b in
                    zip(mean_var(*got, n), mean_var(*plain(), n))]
            excess = max(e[0] for e in errs)
            err = max(e[1] for e in errs)
            ms, plain_ms = cuda_ms(call), cuda_ms(plain)
            device_ms = graph_ms(call, 20)
            cost = stats_cost(TRAIN_B, L, G, D, second)
            fp32, tc = cost["bound_ms"], cost["tc_bound_ms"]
            log(f"{'K3b' if second else 'K3a'} {name} [{shape}: B={TRAIN_B} "
                f"L={L} G={G} D={D}]: mean/var max_abs_err {err:.3e} "
                f"(tol {STATS_REL} rel or {STATS_ABS} abs), repeat "
                f"{'bit-identical' if same else 'DIFFERS'} | kernel "
                f"{ms:.4f} ms a call ({device_ms:.4f} ms on the device by "
                f"CUDA graph replay), plain {plain_ms:.4f} ms | "
                f"{cost['flops'] / 1e9:.3f} GFLOP, {cost['bytes'] / 1e6:.2f}"
                f" MB | FP32 bound {fp32:.4f} ms ({cost['bound_by']}, "
                f"{fp32 / ms:.1%} a call, {fp32 / device_ms:.1%} on the "
                f"device), 3xTF32 bound {tc:.4f} ms ({tc / ms:.1%}, "
                f"{tc / device_ms:.1%}) | {smi}")
            if not (excess <= 0 and same):
                raise AssertionError(f"{name} [{shape}] disagrees with its "
                                     f"plain version ({err}) or with "
                                     f"itself (bit-identical: {same})")
            out[f"{name}/{shape}"] = dict(
                max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, repeat_identical=same, **cost)
    return out


def check_train_scorer(smi):
    """fused_train_attention (kernels + recompute backward) against the
    plain train-mode scorer math, at both train shapes; then K2's
    recompute backward at the train shape."""
    from clsr_tpu_torch.ops import fused_attention as fa
    from clsr_tpu_torch.ops import fused_train_attention as fta
    out = {}
    for shape, G, D in TRAIN_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(20 + G)
        args = train_inputs(g, G, D)
        diff = [i for i in range(13) if i != 3]
        cot = torch.randn(TRAIN_B, G, DK, generator=g, device="cuda")

        def run(fn):
            t = [a.detach().requires_grad_(i in diff)
                 for i, a in enumerate(args)]
            outs = fn(*t)
            grads = torch.autograd.grad(outs[0], [t[i] for i in diff], cot)
            return [o.detach() for o in outs], grads

        (got, g_got), (want, g_want) = run(fta.fused_train_attention), \
            run(fta.train_scorer_math)
        torch.cuda.synchronize()
        att_err = (got[0] - want[0]).abs().max().item()
        st = [stats_err(a, b) for a, b in zip(got[1:], want[1:])]
        grad_rel = max(((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)).item() for a, b in zip(g_got, g_want))
        log(f"train scorer [{shape}: G={G} D={D}]: att max_abs_err "
            f"{att_err:.3e} (tol 1e-4), stats max_abs_err "
            f"{max(e[1] for e in st):.3e}, gradients max err / max abs "
            f"{grad_rel:.3e} (tol {GRAD_REL}) | {smi}")
        if not (att_err <= 1e-4 and max(e[0] for e in st) <= 0
                and grad_rel <= GRAD_REL):
            raise AssertionError(f"train scorer [{shape}] disagrees with "
                                 f"its plain math")
        # K1 alone at this shape, with the batch folds
        keys, kp, q, mask, k0, b0, s0, sh0, w1, b1, s1, sh1, w2 = args
        wk, wq, wd, wm = k0.split(D)
        m0, v0, m1, v1 = (t - b for t, b in
                          zip(want[1:], (b0, 0.0, b1, 0.0)))
        a0 = s0 * torch.rsqrt(v0 + 1e-4)
        a1 = s1 * torch.rsqrt(v1 + 1e-4)
        k1_args = [t.contiguous() for t in (
            keys, kp, q, mask, wk + wd, wq - wd, wm, a0, sh0 - a0 * m0, w1,
            a1, sh1 - a1 * m1, w2)]
        k1_ms = cuda_ms(lambda: fa.fused_eval_attention(*k1_args))
        k1_dev = graph_ms(lambda: fa.fused_eval_attention(*k1_args), 20)
        k1_plain = cuda_ms(lambda: fa.eval_scorer_reference(*k1_args))
        k1_err = (fa.fused_eval_attention(*k1_args)
                  - fa.eval_scorer_reference(*k1_args)).abs().max().item()
        k1_c = k1_cost(k1_args)
        # forward and backward-recompute times of the Function
        t = [a.detach().requires_grad_(i in diff)
             for i, a in enumerate(args)]
        fwd_ms = cuda_ms(lambda: fta.fused_train_attention(*t), iters=10)
        plain_fwd_ms = cuda_ms(lambda: fta.train_scorer_math(*t), iters=10)
        att = fta.fused_train_attention(*t)[0]
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            att, [t[i] for i in diff], cot, retain_graph=True), iters=10)
        att_p = fta.train_scorer_math(*t)[0]
        plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            att_p, [t[i] for i in diff], cot, retain_graph=True), iters=10)
        del att, att_p
        log(f"train scorer [{shape}]: K1 at G={G} D={D} (batch folds) "
            + k1_line(k1_c, k1_ms, k1_dev, k1_plain, k1_err))
        log(f"train scorer [{shape}]: Function forward "
            f"(K3a+K3b+K1) {fwd_ms:.4f} ms, plain math forward "
            f"{plain_fwd_ms:.4f} ms | backward (recompute + autograd) "
            f"{bwd_ms:.4f} ms, plain backward {plain_bwd_ms:.4f} ms | {smi}")
        if not k1_err <= K1_TOL:
            raise AssertionError(f"K1 at the {shape} train shape: {k1_err}")
        out[shape] = dict(att_err=att_err, grad_rel=grad_rel, k1_ms=k1_ms,
                          k1_device_ms=k1_dev,
                          k1_plain_ms=k1_plain, k1_bound_ms=k1_c["bound_ms"],
                          k1_tc_bound_ms=k1_c["tc_bound_ms"],
                          k1_err=k1_err, fwd_ms=fwd_ms,
                          plain_fwd_ms=plain_fwd_ms, bwd_ms=bwd_ms,
                          plain_bwd_ms=plain_bwd_ms)
    out["clsr_scan"] = check_k2_backward(smi)
    return out


def check_k2_backward(smi):
    from clsr_tpu_torch.ops import fused_scan as fs
    dev = torch.device("cuda")
    B, L, U, H = TRAIN_B, TRAIN_L, 40, 40
    args = k2_inputs(B, L, 30)
    mask = args[8]
    g = torch.Generator(device=dev).manual_seed(31)
    cots = tuple(torch.randn(*shape, generator=g, device=dev)
                 for shape in ((B, U), (B, L, H), (B, H)))
    *_, carries = fs._forward(*args, keep_carries=True)
    *_, plain_carries = fs.scan_forward_reference(*args)
    got = fs.scan_backward(args, carries, *cots)
    plain = fs.scan_backward_reference(args, carries, *cots)
    t = [a.detach().requires_grad_(i != 8) for i, a in enumerate(args)]
    auto = torch.autograd.grad(fs.scan_reference(*t),
                               [x for i, x in enumerate(t) if i != 8], cots)
    torch.cuda.synchronize()
    drop_mask = lambda gs: [x for i, x in enumerate(gs) if i != 8]
    got, plain = drop_mask(got), drop_mask(plain)
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    carry_err = (carries - plain_carries).abs().max().item()
    err = max((a - b).abs().max().item() for a, b in zip(got, plain))
    rel_plain = max(rel(a, b) for a, b in zip(got, plain))
    rel_auto = max(rel(a, b) for a, b in zip(got, auto))
    del t, auto, plain_carries
    fwd = {keep: k2_forward_case("train" + ("_carries" if keep else ""),
                                 args, keep, smi) for keep in (False, True)}
    fwd_ms, fwd_carries_ms = fwd[False]["ms"], fwd[True]["ms"]
    kernel_ms = cuda_ms(lambda: fs._backward_kernel(args, carries, *cots))
    dx = fs._backward_kernel(args, carries, *cots)
    gemm_ms = cuda_ms(lambda: fs.scan_weight_grads(
        carries, dx[9], dx[0], dx[1], dx[2], dx[6], dx[7]))
    ms = cuda_ms(lambda: fs.scan_backward(args, carries, *cots))
    plain_ms = cuda_ms(lambda: fs.scan_backward_reference(args, carries,
                                                          *cots), iters=3)
    need = [i != 8 for i in range(15)]
    recompute_ms = cuda_ms(lambda: fs.recompute_grads(
        fs.scan_reference, args, need, cots), iters=3, warmup=1)
    n_valid = int(mask.sum().item())
    # forward: 2U^2 + 6H^2 gate and U^2 + H^2 candidate multiply-adds a
    # valid step; the backward recomputes those and does as many again
    # for the adjoints, and its weight products take the forward's count
    # over every step
    macs = 3 * U * U + 7 * H * H
    n_in = sum(a.numel() for a in args)
    fwd_bound = bound(4 * (n_in + B * L * H + B * U + B * H),
                      2 * n_valid * macs)
    # backward: the inputs but ushort, the carries and the cotangents
    # read once; the 8 input gradients, d ushort and the 5 weight
    # gradients written once
    n_weights = sum(a.numel() for a in args[10:])
    n_bwd = (n_in - B * U + carries.numel() + sum(c.numel() for c in cots)
             + sum(a.numel() for a in args[:8]) + B * U + n_weights)
    bwd_bound = bound(4 * n_bwd, 2 * (2 * n_valid * macs + B * L * macs))
    log(f"K2 clsr_scan [train: B={B} L={L} U=H={U}, {n_valid}/{B * L} "
        f"valid steps]: forward {fwd_ms:.4f} ms, with carries "
        f"{fwd_carries_ms:.4f} ms (carries max_abs_err {carry_err:.3e}, "
        f"tol 1e-5), bound {fwd_bound[0]:.5f} ms ({fwd_bound[1]}) | "
        f"backward kernel {kernel_ms:.4f} ms, weight "
        f"products {gemm_ms:.4f} ms, whole backward {ms:.4f} ms, bound "
        f"{bwd_bound[0]:.5f} ms ({bwd_bound[1]}; the real floor is the {L} "
        f"dependent steps), plain backward {plain_ms:.4f} ms, old route "
        f"(recompute under autograd) {recompute_ms:.4f} ms | gradients max "
        f"err / max abs {rel_plain:.3e} against the plain backward, "
        f"{rel_auto:.3e} against autograd (tol {GRAD_REL}) | {smi}")
    if not (carry_err <= K2_TOL and rel_plain <= GRAD_REL
            and rel_auto <= GRAD_REL):
        raise AssertionError(f"K2's backward disagrees with its plain "
                             f"version or autograd: {rel_plain}, {rel_auto}")
    del got, plain, dx
    shapes = {"train": k2_backward_case("train", args, cots, carries, smi)}
    for shape, B_, L_, seed in (("cli", 500, 50, 32),
                                ("kuaishou", 400, 250, 34)):
        a = k2_inputs(B_, L_, seed)
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        c = tuple(torch.randn(*shape_, generator=g, device=dev)
                  for shape_ in ((B_, U), (B_, L_, H), (B_, H)))
        *_, cy = fs._forward(*a, keep_carries=True)
        shapes[shape] = k2_backward_case(shape, a, c, cy, smi)
    return dict(max_abs_err=err, grad_rel_plain=rel_plain,
                grad_rel_autograd=rel_auto, carry_err=carry_err, ms=ms,
                kernel_ms=kernel_ms, gemm_ms=gemm_ms, plain_ms=plain_ms,
                recompute_ms=recompute_ms, bound_ms=bwd_bound[0],
                bound_by=bwd_bound[1], fwd_ms=fwd_ms,
                fwd_carries_ms=fwd_carries_ms, fwd_bound_ms=fwd_bound[0],
                fwd_bound_by=fwd_bound[1], n_valid=n_valid,
                forward=fwd[False], forward_carries=fwd[True],
                shapes=shapes)


K2_BWD_F64_REL = 1e-5   # each kernel gradient against float64, of max abs


def k2_backward_case(shape, args, cots, carries, smi, graph_calls=20):
    """K2's backward on `args` from the forward's `carries`: each kernel
    gradient (those of xg1 .. xc2 and ushort) against
    `scan_backward_reference` in float64 on the same carries, within
    K2_BWD_F64_REL of its max abs, the float32 plain version's error
    beside it (and the weight products' errors, not gated); the kernel
    alone, the five weight products and the whole backward a call (CUDA
    events) and on the device (CUDA graph replay), the kernel with each
    of ROWS forced; the plain backward's ms; the byte bounds of
    the kernel and of the whole backward."""
    from clsr_tpu_torch.ops import fused_scan as fs
    B, L = args[2].shape[:2]
    U, H = args[9].shape[-1], args[14].shape[-1]
    f64 = lambda ts: tuple(t.double() for t in ts)
    want = fs.scan_backward_reference(f64(args), carries.double(),
                                      *f64(cots))
    got = fs.scan_backward(args, carries, *cots)
    plain = fs.scan_backward_reference(args, carries, *cots)
    torch.cuda.synchronize()
    rel = lambda a, b: ((a.double() - b).abs().max()
                        / b.abs().max()).item()
    kernel_idx = (0, 1, 2, 3, 4, 5, 6, 7, 9)
    weight_idx = (10, 11, 12, 13, 14)
    f64_rel = max(rel(got[i], want[i]) for i in kernel_idx)
    plain_f64_rel = max(rel(plain[i], want[i]) for i in kernel_idx)
    weights_f64_rel = max(rel(got[i], want[i]) for i in weight_idx)
    plain_weights_f64_rel = max(rel(plain[i], want[i]) for i in weight_idx)
    del want, got, plain
    kernel = lambda: fs._backward_kernel(args, carries, *cots)
    dx = kernel()
    gemms = lambda: fs.scan_weight_grads(carries, dx[9], dx[0], dx[1],
                                         dx[2], dx[6], dx[7])
    whole = lambda: fs.scan_backward(args, carries, *cots)
    ms = {name: cuda_ms(fn) for name, fn in
          (("kernel", kernel), ("gemms", gemms), ("whole", whole))}
    device_ms = {name: graph_ms(fn, graph_calls) for name, fn in
                 (("kernel", kernel), ("gemms", gemms), ("whole", whole))}
    rows = fs.rows_per_block(B, fs._sm_count(args[2].device))
    pick = fs.rows_per_block
    rows_device_ms = {}
    try:
        for forced in fs.ROWS:
            fs.rows_per_block = lambda *_, r=forced: r
            rows_device_ms[forced] = graph_ms(kernel, graph_calls)
    finally:
        fs.rows_per_block = pick
    plain_ms = cuda_ms(lambda: fs.scan_backward_reference(args, carries,
                                                          *cots),
                       iters=2, warmup=1)
    # bytes: the kernel reads the inputs but ushort, the carries and the
    # cotangents once and writes the 8 input gradients, d ushort and zc
    # once; the whole backward reads the same and writes the 8 input
    # gradients, d ushort and the 5 weight gradients once
    n_read = (sum(a.numel() for a in args) - B * U + carries.numel()
              + sum(c.numel() for c in cots))
    n_grads = sum(a.numel() for a in args[:8]) + B * U
    n_weights = sum(a.numel() for a in args[10:])
    kernel_bound, _ = bound(4 * (n_read + n_grads + B * L * (U + H)), 0)
    whole_bound, _ = bound(4 * (n_read + n_grads + n_weights), 0)
    n_valid = int(args[8].sum().item())
    us_step = device_ms["kernel"] * 1e3 / L
    log(f"K2 clsr_scan_backward [{shape}: B={B} L={L} U={U} H={H}, "
        f"{n_valid}/{B * L} valid steps, R={rows} rows a block]: kernel "
        f"gradients max err / max abs {f64_rel:.3e} against float64 (tol "
        f"{K2_BWD_F64_REL}; the float32 plain backward {plain_f64_rel:.3e};"
        f" weight gradients {weights_f64_rel:.3e}, plain "
        f"{plain_weights_f64_rel:.3e}) | a call: kernel "
        f"{ms['kernel']:.4f} ms, weight products {ms['gemms']:.4f} ms, "
        f"whole {ms['whole']:.4f} ms | on the device by CUDA graph "
        f"replay: kernel {device_ms['kernel']:.4f} ms ({us_step:.3f} us per"
        f" dependent step), weight products {device_ms['gemms']:.4f} ms, "
        f"whole {device_ms['whole']:.4f} ms; kernel device ms by R "
        + ", ".join(f"{r}: {t:.4f}" for r, t in rows_device_ms.items())
        + f" | plain {plain_ms:.4f} ms | byte bound: kernel "
        f"{kernel_bound:.5f} ms ({kernel_bound / device_ms['kernel']:.1%} "
        f"of its device time), whole {whole_bound:.5f} ms; the floor is "
        f"the {L} dependent steps | {smi}")
    if not f64_rel <= K2_BWD_F64_REL:
        raise AssertionError(f"K2's backward [{shape}] is {f64_rel} of max "
                             f"abs off the float64 backward")
    return dict(f64_rel=f64_rel, plain_f64_rel=plain_f64_rel,
                weights_f64_rel=weights_f64_rel,
                plain_weights_f64_rel=plain_weights_f64_rel,
                ms=ms, device_ms=device_ms, rows=rows,
                rows_device_ms=rows_device_ms, us_per_step=us_step,
                plain_ms=plain_ms, kernel_bound_ms=kernel_bound,
                whole_bound_ms=whole_bound, n_valid=n_valid, B=B, L=L)


def train_batches(n, seed, n_users, n_items, n_cates, L=TRAIN_L,
                  B=TRAIN_B):
    """Seeded numpy positives-only batches (G = 1) of B rows on the card,
    history lengths 1..L."""
    from clsr_tpu_torch.data.batch import Batch
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lengths = rng.randint(1, L + 1, B)
        mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
        ages = np.sort(rng.randint(60, 8 * 86400, (B, L)), 1)[:, ::-1]
        f32 = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, np.float32))
        i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
        out.append(Batch(
            users=i32(rng.randint(1, n_users, B)),
            items=i32(rng.randint(1, n_items, (B, 1))),
            cates=i32(rng.randint(1, n_cates, (B, 1))),
            labels=f32(np.ones((B, 1))),
            item_hist=i32(rng.randint(1, n_items, (B, L)) * mask),
            cate_hist=i32(rng.randint(1, n_cates, (B, L)) * mask),
            mask=f32(mask),
            time_diff=f32(np.log1p(rng.rand(B, L) * 3600) * mask),
            time_from_first=f32(np.log1p(ages[:, ::-1] / 60.0) * mask),
            time_to_now=f32(np.log1p(ages / 60.0) * mask),
            valid=f32(np.ones(B))).to("cuda"))
    return out


def zero_by_construction(name):
    """Gradients that are zero up to rounding: a dense bias under
    train-mode BN, and an output bias under a softmax (the scorers' over
    L, the logit head's over the G candidates)."""
    return ((".w_nn_layer" in name and name.endswith(".bias"))
            or name.endswith("w_nn_output.bias"))


def train(smi):
    from clsr_tpu_torch.config import CONFIG_DIR, load_config
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.ops import fused_attention as fa
    from clsr_tpu_torch.ops import fused_scan as fs
    from clsr_tpu_torch.ops import fused_train_attention as fta
    from clsr_tpu_torch.training.state import create_train_state
    from clsr_tpu_torch.training.steps import make_train_step

    sizes = (USERS, ITEMS, CATES)
    base = load_config(os.path.join(CONFIG_DIR, "clsr.yaml"),
                       user_vocab="u", item_vocab="i", cate_vocab="c", seed=0)
    cfgs = {"kernel": base.replace(use_pallas_train_attention="on",
                                   use_pallas_scan=True),
            "plain": base.replace(use_pallas_train_attention="off",
                                  use_pallas_scan=False)}
    counters = (fta.train_stats0, fta.train_stats1, fa.fused_eval_attention,
                fs.fused_scan, fs.scan_backward)
    names = ("train_stats0", "train_stats1", "eval_scorer", "clsr_scan",
             "clsr_scan_backward")
    per_step = (2, 2, 2, 1, 1)
    none = (0,) * len(names)

    def reset():
        for c in counters:
            c.launches = 0

    def counts():
        return tuple(c.launches for c in counters)

    t0 = time.perf_counter()
    models, states, steps = {}, {}, {}
    for run, cfg in cfgs.items():
        models[run] = get_model_class("clsr")(cfg, *sizes)
        if run == "kernel":
            g = torch.Generator(device="cuda").manual_seed(6)
            with torch.no_grad():      # weights and BN away from init
                for p in models[run].parameters():
                    p.add_(torch.randn(p.shape, generator=g,
                                       device="cuda") * 0.1)
        else:
            models[run].load_state_dict(models["kernel"].state_dict())
        states[run] = create_train_state(models[run], cfg)
        steps[run] = make_train_step(models[run], cfg)
    batches = train_batches(1 + P8_STEPS, 7, *sizes)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in models["kernel"].parameters())
    log(f"train: two models at clsr.yaml widths, {n_params:,} parameters "
        f"each ({n_params * 4 / 1e6:.1f} MB f32), built in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- first batch: kernel path against the plain path ----------------
    first = {}
    for run in ("kernel", "plain"):
        reset()
        gen = torch.Generator(device="cuda").manual_seed(11)
        _, parts = steps[run](states[run], batches[0], gen)
        torch.cuda.synchronize()
        first[run] = (parts, {n: p.grad.clone() for n, p in
                              models[run].named_parameters()},
                      {n: b.clone() for n, b in models[run].named_buffers()},
                      counts())
    (pk, gk, bk, ck), (pp, gp, bp, cp) = first["kernel"], first["plain"]
    loss_err = max(abs(getattr(pk, f).item() - getattr(pp, f).item())
                   / max(abs(getattr(pp, f).item()), 1e-30)
                   for f in ("loss", "data_loss", "regular_loss",
                             "contrastive_loss", "discrepancy_loss"))
    grad_bad, grad_rel, zero_abs = [], 0.0, 0.0
    for n, g in gp.items():
        d = (gk[n] - g).abs().max().item()
        mx = g.abs().max().item()
        if zero_by_construction(n):
            zero_abs = max(zero_abs, d)
            ok = d <= GRAD_REL * mx + 1e-6
        else:
            grad_rel = max(grad_rel, d / max(mx, 1e-30))
            ok = d <= GRAD_REL * mx
        if not ok:
            grad_bad.append((n, d, mx))
    bn_err = max((bk[n] - b).abs().max().item() for n, b in bp.items())
    log(f"train first batch, kernel vs plain: loss parts max rel err "
        f"{loss_err:.3e} (tol 1e-4), gradients max err / max abs "
        f"{grad_rel:.3e} (tol {GRAD_REL}; zero-by-construction biases max "
        f"abs err {zero_abs:.3e}), BN running stats max abs err "
        f"{bn_err:.3e} (tol 1e-5) | launches kernel {dict(zip(names, ck))}, "
        f"plain {dict(zip(names, cp))} | loss {pk.loss.item():.6f} | {smi}")
    if not (loss_err <= 1e-4 and not grad_bad and bn_err <= 1e-5
            and ck == per_step and cp == none):
        raise AssertionError(f"train kernel path disagrees with the plain "
                             f"path: {grad_bad[:5]}")

    # ---- the main train path: P8_STEPS kernel steps, in turns with plain --
    del first, gk, gp, bk, bp
    torch.cuda.synchronize()
    resident_mb = torch.cuda.memory_allocated() / 1e6
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    timing = {run: dict(ms=[], losses=[], peak_mb=0.0) for run in cfgs}

    def timed_step(run, i, b):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        torch.cuda.reset_peak_memory_stats()
        start.record()
        _, parts = steps[run](states[run], b, gen)
        end.record()
        torch.cuda.synchronize()
        t = timing[run]
        t["ms"].append(start.elapsed_time(end))
        t["losses"].append(parts.loss.item())
        t["peak_mb"] = max(t["peak_mb"],
                           torch.cuda.max_memory_allocated() / 1e6)

    reset()
    for i, b in enumerate(batches[1:]):
        # plain, kernel, kernel, plain, ...: both see the same drift
        for run in (("plain", "kernel") if i % 2 == 0 else
                    ("kernel", "plain")):
            before = counts()
            timed_step(run, i, b)
            step_counts = tuple(a - c for a, c in zip(counts(), before))
            want = per_step if run == "kernel" else none
            if step_counts != want:
                raise AssertionError(
                    f"{run} step {i}: launches "
                    f"{dict(zip(names, step_counts))}, want "
                    f"{dict(zip(names, want))}")
    main_counts = dict(zip(names, counts()))
    for run, t in timing.items():
        if not np.isfinite(t["losses"]).all():
            raise AssertionError(f"{run}: non-finite losses {t['losses']}")
        t["median_ms"] = statistics.median(t["ms"])
        t["examples_per_s"] = TRAIN_B / t["median_ms"] * 1e3
        log(f"train[{run}]: {len(t['ms'])} steps"
            + (f", launches {main_counts}" if run == "kernel" else "")
            + f" | median step {t['median_ms']:.3f} ms (min "
            f"{min(t['ms']):.3f}, max {max(t['ms']):.3f}), "
            f"{t['examples_per_s']:,.0f} examples/s | peak device memory "
            f"{t['peak_mb']:.1f} MB, of which {resident_mb:.1f} MB resident "
            f"before the run (both models with their Adam states) | losses "
            f"{t['losses'][0]:.5f} .. {t['losses'][-1]:.5f} | {smi}")
    if min(main_counts.values()) <= 0:
        raise AssertionError("a kernel never launched on the train path")
    out = dict(launches=main_counts, resident_mb=resident_mb, timing=timing,
               loss_rel_err=loss_err, grad_rel_err=grad_rel,
               zero_grad_abs_err=zero_abs, bn_err=bn_err)
    out["repair_cost"] = {run: repair_cost(f"train[{run}]", models[run],
                                           cfgs[run], states[run],
                                           batches[1:], smi)
                          for run in cfgs}
    out["profile"] = {run: profile_steps(steps[run], states[run],
                                         batches[1:3], run, smi)
                      for run in cfgs}
    return out


def profile_steps(step, state, batch_list, run, smi):
    """torch.profiler over a few train steps: per `train_step.<phase>`
    range its host ms and its span on the device, the device's busy
    share of the window (kernel time, annotations left out), the kernel
    launches per step, and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev_self = self_device_us
    step(state, batch_list[0], torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, b in enumerate(batch_list):
            step(state, b, torch.Generator(device="cuda").manual_seed(i))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = len(batch_list)
    events = prof.key_averages()
    kernels = kernel_events(prof)
    busy_ms = sum(dev_self(e) for e in kernels) / 1e3 / n
    launches = sum(e.count for e in kernels) / n
    phases = {}
    for e in events:
        if e.key.startswith("train_step."):
            ph = phases.setdefault(e.key[len("train_step."):], {})
            if e.device_type == DeviceType.CPU:
                ph["host_ms"] = e.cpu_time_total / 1e3 / n
            else:
                ph["device_span_ms"] = e.device_time_total / 1e3 / n
    top = [(e.key[:90], dev_self(e) / 1e3 / n, e.count / n) for e in
           sorted(kernels, key=dev_self, reverse=True)[:10]]
    log(f"profile[{run}]: {n} steps, {wall_ms / n:.3f} ms each under the "
        f"profiler; device busy {busy_ms:.3f} ms per step "
        f"({100 * busy_ms * n / wall_ms:.1f}% of the window, idle "
        f"{100 - 100 * busy_ms * n / wall_ms:.1f}%), {launches:,.0f} kernel "
        f"launches per step | {smi}")
    for name, ph in sorted(phases.items()):
        log(f"  profile[{run}] phase {name}: host "
            f"{ph.get('host_ms', 0.0):.3f} ms, device span "
            f"{ph.get('device_span_ms', 0.0):.3f} ms per step")
    for name, ms, calls in top:
        log(f"  profile[{run}] kernel {ms:8.3f} ms/step {calls:7.0f} "
            f"launches/step  {name}")
    return dict(wall_ms_per_step=wall_ms / n, busy_ms_per_step=busy_ms,
                launches_per_step=launches, phases=phases, top_kernels=top)


# kind "bench": M unique sorted ids with the bench's skew; "compact": the
# unique ids of M draws, then dropped ids >= N up to Mc = min(M, N), as the
# compact update hands K5 its targets; "legacy": M sorted draws with their
# duplicates, each duplicate carrying one row, as the legacy path's ids
BENCH_SHAPE = dict(name="bench", kind="bench", N=500_000, W=40, M=58_000)
ITEM_PMN_SHAPE = dict(name="item_pmn", kind="compact", N=ITEMS, W=3 * 32,
                      M=22_000)
# the other widths of the lazy paths' K5 launches at B = 400, held to the
# plain version only (each W gives its own threads-per-row split)
K5_PATH_SHAPES = (
    dict(name="cate_pmn", kind="compact", N=CATES, W=3 * 8, M=22_000),
    dict(name="user_pmn", kind="compact", N=USERS, W=3 * 40, M=400),
    dict(name="item_legacy_param", kind="legacy", N=ITEMS, W=32, M=22_000),
    dict(name="item_legacy_mn", kind="legacy", N=ITEMS, W=64, M=22_000),
    dict(name="user_legacy_param", kind="legacy", N=USERS, W=40, M=400),
    dict(name="user_legacy_mn", kind="legacy", N=USERS, W=80, M=400),
    dict(name="cate_legacy_param", kind="legacy", N=CATES, W=8, M=22_000),
    dict(name="cate_legacy_mn", kind="legacy", N=CATES, W=16, M=22_000))
SWEEP_BLOCK = 2048
TIMED_SETS = 24     # fresh (ids, rows) per timed call: no reuse out of L2


def row_update_ids(shape, g):
    """(ids int32, rows, n_valid) at a row-update shape (see
    BENCH_SHAPE): ids sorted, the n_valid ids < N first."""
    from clsr_tpu_torch.bench_row_update import fresh_ids
    dev = torch.device("cuda")
    N, W, M = shape["N"], shape["W"], shape["M"]
    if shape["kind"] == "bench":
        ids = fresh_ids(g, N, M)
        rows = torch.randn(M, W, generator=g, device=dev)
    elif shape["kind"] == "compact":
        Mc = min(M, N)
        valid = torch.unique(torch.randint(1, N, (M,), generator=g,
                                           device=dev))
        ids = torch.cat([valid, N + torch.arange(Mc - valid.numel(),
                                                 device=dev)])
        rows = torch.randn(Mc, W, generator=g, device=dev)
    else:
        ids = torch.sort(torch.randint(0, N, (M,), generator=g,
                                       device=dev)).values
        uniq, inv = torch.unique(ids, return_inverse=True)
        rows = torch.randn(uniq.numel(), W, generator=g, device=dev)[inv]
    return ids.to(torch.int32), rows, int((ids < N).sum().item())


def cycling(sets, fn):
    """A call that applies fn to the next of `sets` in turn, so a timing
    loop writes fresh rows to fresh places, as a train step does."""
    turn = itertools.cycle(sets)
    return lambda: fn(*next(turn))


def host_us(fn, calls=200):
    """Host us per call of fn: the time to issue `calls` calls back to
    back (the device runs them behind), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


TURNS = 5     # rounds of the per-call and host timings, taken in turns


def in_turns(calls):
    """Per call ms (CUDA events, launch included) and host us per call of
    each of `calls`, medians of TURNS rounds in turns, the order rotating
    each round: the host's speed drifts within a run."""
    names = list(calls)
    ms, us = ({k: [] for k in names} for _ in range(2))
    for r in range(TURNS):
        for k in names[r % len(names):] + names[:r % len(names)]:
            ms[k].append(cuda_ms(calls[k]))
            us[k].append(host_us(calls[k]))
    return ({k: statistics.median(v) for k, v in ms.items()},
            {k: statistics.median(v) for k, v in us.items()})


# the compact step's K5 group at B = 400 with Taobao-sized tables: the pmn
# rows of the item, cate and two user tables; the step launches them with
# each table's param rows (same ids, the first D columns) beside them
STEP_TABLES = (ITEM_PMN_SHAPE, K5_PATH_SHAPES[0], K5_PATH_SHAPES[1],
               dict(K5_PATH_SHAPES[1], name="user_short_pmn"))


def check_step_group(smi, param_dtype=torch.float32,
                     variants=(("pmn", False), ("pmn+params", True))):
    """The compact step's group, the four pmn entries alone ("pmn") and
    with the four param entries ("pmn+params", what the step launches;
    the tables in `param_dtype`, bf16 under embedding_dtype bfloat16,
    beside the f32 pmn rows): K5 in one launch bit-identical to its
    plain version and to the same entries by index_copy_, then per call,
    on the device (CUDA graph) and on the host, each call on the next of
    TIMED_SETS fresh id and row sets."""
    from clsr_tpu_torch.ops import row_update as ru
    g = torch.Generator(device="cuda").manual_seed(42)
    tables = [(torch.randn(s["N"], s["W"], generator=g, device="cuda"),
               torch.randn(s["N"], s["W"] // 3, generator=g, device="cuda"
                           ).to(param_dtype))
              for s in STEP_TABLES]

    def draw(with_params):
        """[(table, ids, rows, n_valid)] of one step's group."""
        entries = []
        for (pmn, param), shape in zip(tables, STEP_TABLES):
            ids, rows, n = row_update_ids(shape, g)
            entries.append((pmn, ids, rows, n))
            if with_params:
                entries.append((param, ids, rows[:, :param.shape[1]].to(
                    param_dtype).contiguous(), n))
        return entries

    out = {}
    for name, with_params in variants:
        group = draw(with_params)
        work = {id(t): t.clone() for t, _, _, _ in group}

        def run(fn, entries):
            """Clones of the group's tables after fn on them."""
            copies = {id(t): t.clone() for t, _, _, _ in entries}
            fn([(copies[id(t)], i, r, n) for t, i, r, n in entries])
            return copies

        lib = lambda es: [t.index_copy_(0, i[:n].long(), r[:n])
                          for t, i, r, n in es]
        want = run(lambda es: ru.scatter_rows_group_reference(
            [(t, i, r) for t, i, r, _ in es]), group)
        got = {"K5": run(lambda es: ru.scatter_rows_group(
                   [(t, i, r) for t, i, r, _ in es]), group),
               "index_copy_": run(lib, group)}
        torch.cuda.synchronize()
        same = {k: all(torch.equal(v[key], want[key]) for key in want)
                for k, v in got.items()}
        del got, want
        sets = [[(work[id(t)], i, r, n) for t, i, r, n in
                 (group if k == 0 else draw(with_params))]
                for k in range(TIMED_SETS)]
        lib_sets = [[(t, i[:n].long(), r[:n]) for t, i, r, n in es]
                    for es in sets]
        calls = {
            "K5": cycling([(es,) for es in sets], lambda es:
                          ru.scatter_rows_group(
                              [(t, i, r) for t, i, r, _ in es])),
            "index_copy_": cycling([(es,) for es in lib_sets], lambda es: [
                t.index_copy_(0, i, r) for t, i, r in es])}
        n_bytes = sum(4 * i.numel() + r.element_size() * (
            r.numel() + n * r.shape[1]) for _, i, r, n in group)
        bound_ms, bound_by = bound(n_bytes, 0)
        per_call, host = in_turns(calls)
        res = {k: dict(ms=per_call[k], device_ms=graph_ms(c, TIMED_SETS),
                       host_us=host[k]) for k, c in calls.items()}
        out[f"step_group/{name}"] = dict(
            entries=len(group), bit_identical=same, bound_ms=bound_ms,
            bound_by=bound_by, bytes=n_bytes, timed_sets=TIMED_SETS, **res)
        log(f"K5 step group [{name}: {len(group)} entries, "
            f"{', '.join(s['name'] for s in STEP_TABLES)}; {TIMED_SETS} "
            f"fresh sets]: bit-identical to the plain version: K5 "
            f"{same['K5']}, index_copy_ {same['index_copy_']} | per call "
            f"(CUDA events, median of {TURNS} in turns): "
            + ", ".join(f"{k} {v['ms']:.4f} ms" for k, v in res.items())
            + " | on the device (CUDA graph): "
            + ", ".join(f"{k} {v['device_ms']:.4f} ms" for k, v in
                        res.items())
            + " | host per call (medians): "
            + ", ".join(f"{k} {v['host_us']:.2f} us" for k, v in res.items())
            + f" | the function's {n_bytes / 1e6:.2f} MB, bound "
            f"{bound_ms:.4f} ms ({bound_by}) | {smi}")
        if not all(same.values()):
            raise AssertionError(f"step group [{name}] differs from its "
                                 f"plain version: {same}")
        del sets, lib_sets, work
        torch.cuda.empty_cache()
    del tables
    torch.cuda.empty_cache()
    return out


def check_row_update(smi):
    """Phase 9: K5 and K4 bit-identical to their plain version (and to
    index_copy_) at the bench and item-pmn shapes, with kernel, plain,
    library and bound times over fresh id sets; K5 at the other widths of
    the lazy paths; then the bench entry point, K4's path."""
    from clsr_tpu_torch import bench_row_update
    from clsr_tpu_torch.ops import row_update as ru
    out = {}
    for shape in (BENCH_SHAPE, ITEM_PMN_SHAPE) + K5_PATH_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(40)
        N, W = shape["N"], shape["W"]
        table = torch.randn(N, W, generator=g, device="cuda")
        ids, rows, n_valid = row_update_ids(shape, g)
        M = ids.numel()
        valid_ids = ids[:n_valid].long()
        want = ru.scatter_rows_reference(table.clone(), ids, rows)
        got = {"row_scatter": ru.scatter_rows(table.clone(), ids, rows)}
        if shape in (BENCH_SHAPE, ITEM_PMN_SHAPE):
            got.update({
                "row_sweep": ru.sweep_rows(table.clone(), ids, rows,
                                           SWEEP_BLOCK),
                "index_copy_": table.clone().index_copy_(0, valid_ids,
                                                         rows[:n_valid]),
                "sweep plain": ru.sweep_rows_reference(
                    table.clone(), ids, rows, SWEEP_BLOCK)})
        torch.cuda.synchronize()
        errs = {k: (v - want).abs().max().item() for k, v in got.items()}
        same = {k: torch.equal(v, want) for k, v in got.items()}
        del got, want
        if shape in K5_PATH_SHAPES:
            out[f"row_scatter/{shape['name']}"] = dict(
                max_abs_err=errs["row_scatter"],
                bit_identical=same["row_scatter"], N=N, W=W, M=M,
                n_valid=n_valid)
            log(f"K5 row_scatter [{shape['name']}: N={N} W={W} M={M}, "
                f"{n_valid} valid]: bit-identical to the plain version "
                f"{same['row_scatter']} (max_abs_err "
                f"{errs['row_scatter']:.3e})")
        else:
            out.update(time_row_update(shape, table, errs, same, smi))
        if not all(same.values()):
            raise AssertionError(f"row update [{shape['name']}] differs from "
                                 f"its plain version: {errs}")
        del table, rows
        torch.cuda.empty_cache()
    out.update(check_step_group(smi))
    # K4's path (and K5's second): the bench entry point
    ru.scatter_rows.launches = ru.sweep_rows.launches = 0
    bench = bench_row_update.main(["--reps", "10", "--calls", "3"])
    torch.cuda.synchronize()
    out["bench"] = dict(results=bench, launches={
        "row_scatter": ru.scatter_rows.launches,
        "row_sweep": ru.sweep_rows.launches})
    log(f"bench_row_update path: launches {out['bench']['launches']}")
    if min(out["bench"]["launches"].values()) <= 0:
        raise AssertionError("a row-update kernel never launched on the "
                             "bench path")
    torch.cuda.empty_cache()
    return out


def time_row_update(shape, table, errs, same, smi):
    """K5, K4, their plain versions and index_copy_ per call
    (CUDA events) and on the host (medians of TURNS rounds in turns), and
    on the device (a CUDA graph of one call per set), each call on the
    next of TIMED_SETS fresh (ids, rows) drawn before the timing.  The
    bound of both kernels is the function's bytes: the ids, the rows
    read, the valid rows written."""
    from clsr_tpu_torch.ops import row_update as ru
    g = torch.Generator(device="cuda").manual_seed(41)
    sets = [row_update_ids(shape, g) for _ in range(TIMED_SETS)]
    N, W = shape["N"], shape["W"]
    M = sets[0][0].numel()
    n_valid = statistics.mean(n for _, _, n in sets)
    lib_sets = [(ids[:n].long(), rows[:n]) for ids, rows, n in sets]
    work = table.clone()
    row_bytes = 4 * (M + M * W + n_valid * W)   # ids, rows in, rows out
    plain_ms = cuda_ms(cycling(sets, lambda i, r, n:
                               ru.scatter_rows_reference(work, i, r)))
    sweep_plain_ms = cuda_ms(cycling(sets, lambda i, r, n:
                                     ru.sweep_rows_reference(work, i, r,
                                                             SWEEP_BLOCK)))
    calls = {
        "index_copy_": cycling(lib_sets, lambda i, r:
                               work.index_copy_(0, i, r)),
        "row_scatter": cycling(sets, lambda i, r, n:
                               ru.scatter_rows(work, i, r)),
        "row_sweep": cycling(sets, lambda i, r, n:
                             ru.sweep_rows(work, i, r, SWEEP_BLOCK))}
    per_call, host = in_turns(calls)
    device = {k: graph_ms(c, TIMED_SETS) for k, c in calls.items()}
    lib_ms, lib_dev_ms, lib_host = (per_call["index_copy_"],
                                    device["index_copy_"],
                                    host["index_copy_"])
    bound_ms, bound_by = bound(row_bytes, 0)
    out = {}
    for name in ("row_scatter", "row_sweep"):
        ms, dev_ms, call_us = per_call[name], device[name], host[name]
        plain = sweep_plain_ms if name == "row_sweep" else plain_ms
        out[f"{name}/{shape['name']}"] = dict(
            max_abs_err=errs[name], bit_identical=same[name], ms=ms,
            device_ms=dev_ms, host_us=call_us, plain_ms=plain,
            library_ms=lib_ms, library_device_ms=lib_dev_ms,
            library_host_us=lib_host, bound_ms=bound_ms, bound_by=bound_by,
            bytes=row_bytes, N=N, W=W, M=M, n_valid=n_valid,
            timed_sets=TIMED_SETS, turns=TURNS)
        log(f"{'K4' if name == 'row_sweep' else 'K5'} {name} "
            f"[{shape['name']}: N={N} W={W} M={M}, {n_valid:.1f} valid, "
            f"{TIMED_SETS} fresh sets]: bit-identical to the plain version "
            f"{same[name]} (max_abs_err {errs[name]:.3e}) | per call (CUDA "
            f"events, launch included, median of {TURNS} in turns): "
            f"kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, index_copy_ {lib_ms:.4f} ms | on the "
            f"device (CUDA graph): kernel {dev_ms:.4f} ms "
            f"({100 * bound_ms / dev_ms:.1f}% of bound), index_copy_ "
            f"{lib_dev_ms:.4f} ms | host per call: wrapper {call_us:.2f} "
            f"us, index_copy_ {lib_host:.2f} us (medians) | the function's "
            f"{row_bytes / 1e6:.2f} MB, bound {bound_ms:.4f} ms "
            f"({bound_by}) | {smi}")
    log(f"row update [{shape['name']}]: index_copy_ on the valid prefix "
        f"bit-identical {same['index_copy_']}, plain sweep "
        f"{same['sweep plain']}")
    del work
    return out


def path_resident_mb(model, opt):
    """MB of device tensors a train path keeps between steps: parameters,
    buffers, the gradients left in place, and the optimizer state."""
    from clsr_tpu_torch.training.lazy_adam import LazyAdamState
    tensors = (list(model.parameters()) + list(model.buffers())
               + [p.grad for p in model.parameters() if p.grad is not None])
    adam = opt
    if isinstance(opt, LazyAdamState):
        tensors += list(opt.moments.values())
        adam = opt.dense_opt
    tensors += [t for st in adam.state.values() for t in st.values()
                if torch.is_tensor(t) and t.is_cuda]
    return sum(t.numel() * t.element_size() for t in tensors) / 1e6


def train_lazy(smi):
    """Phase 10: lazyadam at clsr.yaml widths with Taobao-sized tables,
    compact rows against the legacy path, every kernel gate on; dense
    Adam from the same weights timed in the same turns."""
    from clsr_tpu_torch.config import CONFIG_DIR, load_config
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.ops import fused_attention as fa
    from clsr_tpu_torch.ops import fused_scan as fs
    from clsr_tpu_torch.ops import fused_train_attention as fta
    from clsr_tpu_torch.ops import row_update as ru
    from clsr_tpu_torch.training.lazy_adam import batch_table_ids
    from clsr_tpu_torch.training.state import create_train_state
    from clsr_tpu_torch.training.steps import make_train_step

    sizes = (USERS, ITEMS, CATES)
    base = load_config(os.path.join(CONFIG_DIR, "clsr.yaml"),
                       user_vocab="u", item_vocab="i", cate_vocab="c", seed=0,
                       optimizer="lazyadam", use_pallas_train_attention="on",
                       use_pallas_scan=True)
    cfgs = {"compact": base.replace(compact_rows="auto"),
            "legacy": base.replace(compact_rows="off"),
            "dense": base.replace(optimizer="adam")}
    counters = (fta.train_stats0, fta.train_stats1, fa.fused_eval_attention,
                fs.fused_scan, ru.scatter_rows, fs.scan_backward)
    names = ("train_stats0", "train_stats1", "eval_scorer", "clsr_scan",
             "row_scatter", "clsr_scan_backward")
    per_step = {"compact": (2, 2, 2, 1, 1, 1), "legacy": (2, 2, 2, 1, 1, 1),
                "dense": (2, 2, 2, 1, 0, 1)}

    def counts():
        return tuple(c.launches for c in counters)

    t0 = time.perf_counter()
    models, states, steps = {}, {}, {}
    for run, cfg in cfgs.items():
        models[run] = get_model_class("clsr")(cfg, *sizes)
        if run == "compact":
            g = torch.Generator(device="cuda").manual_seed(6)
            with torch.no_grad():      # weights and BN away from init
                for p in models[run].parameters():
                    p.add_(torch.randn(p.shape, generator=g,
                                       device="cuda") * 0.1)
        else:
            models[run].load_state_dict(models["compact"].state_dict())
        states[run] = create_train_state(models[run], cfg)
        steps[run] = make_train_step(models[run], cfg)
    batches = train_batches(1 + P8_STEPS, 8, *sizes)
    torch.cuda.synchronize()
    log(f"train lazy: three models at clsr.yaml widths (lazyadam compact, "
        f"lazyadam legacy, dense adam), built in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- first batch: compact against legacy -----------------------------
    table_names = ("item_embedding", "cate_embedding", "user_long_embedding",
                   "user_short_embedding")
    ids = batch_table_ids(batches[0])      # negatives come from positives
    first = {}
    for run in ("compact", "legacy"):
        params = dict(models[run].named_parameters())
        before = {n: (params[n].detach().clone(),
                      states[run].optimizer.moments[n].clone())
                  for n in table_names}
        c0 = counts()
        gen = torch.Generator(device="cuda").manual_seed(11)
        _, parts = steps[run](states[run], batches[0], gen)
        torch.cuda.synchronize()
        step_counts = tuple(a - b for a, b in zip(counts(), c0))
        untouched_ok = True
        for n in table_names:
            touched = torch.zeros(params[n].shape[0], dtype=torch.bool,
                                  device="cuda")
            touched[ids[n].long()] = True
            for now, was in ((params[n], before[n][0]),
                             (states[run].optimizer.moments[n],
                              before[n][1])):
                changed = (now != was).any(dim=1)
                untouched_ok &= not bool((changed & ~touched).any())
        del before
        first[run] = (parts, step_counts, untouched_ok)
    (pc, cc, uc), (pl, cl, ul) = first["compact"], first["legacy"]
    loss_err = max(abs(getattr(pc, f).item() - getattr(pl, f).item())
                   / max(abs(getattr(pl, f).item()), 1e-30)
                   for f in ("loss", "data_loss", "regular_loss",
                             "contrastive_loss", "discrepancy_loss"))
    pcm, plm = (dict(models[r].named_parameters())
                for r in ("compact", "legacy"))
    table_err = max((pcm[n] - plm[n]).abs().max().item() for n in table_names)
    moment_err, synced = 0.0, True
    for n in table_names:
        D = pcm[n].shape[1]
        mc = states["compact"].optimizer.moments[n]
        moment_err = max(moment_err, (mc[:, D:] - states["legacy"].optimizer
                                      .moments[n]).abs().max().item())
        synced &= torch.equal(pcm[n], mc[:, :D])
    del pcm, plm
    log(f"train lazy first batch, compact vs legacy: loss parts max rel err "
        f"{loss_err:.3e} (tol 1e-4), tables max abs err {table_err:.3e}, "
        f"moments {moment_err:.3e} (tol 1e-5 abs: the two paths sum a "
        f"repeated row's gradient in different orders) | "
        f"untouched rows bit-identical: compact {uc}, legacy {ul} | tables "
        f"== pmn[:, :D] after the step {synced} | launches compact "
        f"{dict(zip(names, cc))}, legacy {dict(zip(names, cl))} | loss "
        f"{pc.loss.item():.6f} | {smi}")
    if not (loss_err <= 1e-4 and table_err <= 1e-5 and moment_err <= 1e-5
            and uc and ul and synced and cc == per_step["compact"]
            and cl == per_step["legacy"]):
        raise AssertionError("lazyadam: the compact path disagrees with the "
                             "legacy path")

    # ---- the main path: 6 compact steps in turns with 6 legacy ones ----
    # (and 6 dense-Adam steps, after its own first step on batch 0)
    steps["dense"](states["dense"], batches[0],
                   torch.Generator(device="cuda").manual_seed(11))
    torch.cuda.synchronize()
    total_mb = torch.cuda.memory_allocated() / 1e6
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    timing = {run: dict(ms=[], losses=[], extra_mb=0.0) for run in cfgs}
    for c in counters:
        c.launches = 0
    order = ("legacy", "compact", "dense")
    for i, b in enumerate(batches[1:]):
        for run in order[i % 3:] + order[:i % 3]:
            before = counts()
            gen = torch.Generator(device="cuda").manual_seed(100 + i)
            torch.cuda.reset_peak_memory_stats()
            base_mb = torch.cuda.memory_allocated() / 1e6
            start.record()
            _, parts = steps[run](states[run], b, gen)
            end.record()
            torch.cuda.synchronize()
            t = timing[run]
            t["ms"].append(start.elapsed_time(end))
            t["losses"].append(parts.loss.item())
            t["extra_mb"] = max(t["extra_mb"],
                                torch.cuda.max_memory_allocated() / 1e6
                                - base_mb)
            step_counts = tuple(a - c for a, c in zip(counts(), before))
            if step_counts != per_step[run]:
                raise AssertionError(
                    f"lazy {run} step {i}: launches "
                    f"{dict(zip(names, step_counts))}, want "
                    f"{dict(zip(names, per_step[run]))}")
    main_counts = dict(zip(names, counts()))
    for run, t in timing.items():
        if not np.isfinite(t["losses"]).all():
            raise AssertionError(f"lazy {run}: non-finite losses "
                                 f"{t['losses']}")
        t["median_ms"] = statistics.median(t["ms"])
        t["examples_per_s"] = TRAIN_B / t["median_ms"] * 1e3
        t["resident_mb"] = path_resident_mb(models[run],
                                            states[run].optimizer)
        t["peak_mb"] = t["resident_mb"] + t["extra_mb"]
        log(f"train lazy[{run}]: {len(t['ms'])} steps | median step "
            f"{t['median_ms']:.3f} ms (min {min(t['ms']):.3f}, max "
            f"{max(t['ms']):.3f}), {t['examples_per_s']:,.0f} examples/s | "
            f"resident {t['resident_mb']:.1f} MB between steps, peak "
            f"{t['peak_mb']:.1f} MB for this path alone "
            f"(+{t['extra_mb']:.1f} MB during a step; {total_mb:.1f} MB of "
            f"the three paths allocated) | "
            f"losses {t['losses'][0]:.5f} .. {t['losses'][-1]:.5f} | {smi}")
    log(f"train lazy path: launches {main_counts}")
    if min(main_counts.values()) <= 0:
        raise AssertionError("a kernel never launched on the lazy train path")
    out = dict(launches=main_counts, total_resident_mb=total_mb,
               timing=timing, loss_rel_err=loss_err, table_err=table_err,
               moment_err=moment_err, untouched_bit_identical=uc and ul)
    out["repair_cost"] = {
        run: repair_cost(f"train lazy[{run}]", models[run], cfgs[run],
                         states[run], batches[1:], smi)
        for run in ("compact", "legacy")}
    out["profile"] = {run: profile_steps(steps[run], states[run],
                                         batches[1:3], f"lazy {run}", smi)
                      for run in cfgs}
    return out


# the reproducible gradient's shapes: the 41-row table of the PR 10
# finding, and a history block whose masked positions are the padding id
# 0 (half of 20,000, as at B = 400, L = 50), in one long run
SEGMENT_CASES = (("41 rows", 41, 25_000, 8, 0.0),
                 ("padding run", 4_162_026, 20_000, 32, 0.5))


def check_segment_sum(smi):
    """The sorted sums on the card: `table_grad` three times
    bit-identical, no host sync (`torch.cuda.set_sync_debug_mode("error")`
    raises on one), and within 1e-5 of the largest entry of an f64 sum
    (an f32 sum over a run of n rows rounds by ~sqrt(n) ulps of its
    partial sums; F.embedding's backward, which adds in another order,
    is held to the same sum for comparison); the ms of `segment_sum` and
    `table_grad` a call."""
    import torch.nn.functional as F
    from clsr_tpu_torch.ops.segment_sum import (run_lengths, segment_sum,
                                                sorted_runs, table_grad)
    out = {}
    for name, N, M, D, pad in SEGMENT_CASES:
        rng = np.random.RandomState(M)
        ids = rng.randint(1, N, M)
        ids[rng.rand(M) < pad] = 0
        ids = torch.from_numpy(ids).to("cuda")
        g = torch.from_numpy(rng.randn(M, D).astype(np.float32)).to("cuda")
        torch.cuda.set_sync_debug_mode("error")
        try:
            grads = [table_grad(ids, g, N) for _ in range(3)]
            srt = torch.sort(ids).values
            lengths = run_lengths(sorted_runs(srt)[2], min(M, N))
            sums = segment_sum(g, lengths)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        same = all(torch.equal(grads[0], x) for x in grads[1:])
        t = torch.zeros(N, D, device="cuda", requires_grad=True)
        emb = []
        for _ in range(3):
            t.grad = None
            F.embedding(ids, t).backward(g)
            emb.append(t.grad)
        emb_apart = max((emb[0] - x).abs().max().item() for x in emb[1:])
        ref = torch.zeros(N, D, dtype=torch.float64, device="cuda")
        ref.index_add_(0, ids, g.double())
        scale = ref.abs().max().item()
        err = (grads[0].double() - ref).abs().max().item()
        emb_err = (emb[0].double() - ref).abs().max().item()
        del emb, t, ref
        row = dict(bit_identical=same, embedding_apart=emb_apart,
                   err_vs_f64=err, embedding_err_vs_f64=emb_err,
                   f64_max_abs=scale, no_sync=True,
                   segment_sum_ms=cuda_ms(lambda: segment_sum(g, lengths)),
                   table_grad_ms=cuda_ms(lambda: table_grad(ids, g, N)))
        log(f"segment sums [{name}: N={N:,} M={M:,} D={D}, "
            f"{int((lengths > 0).sum()):,} runs, the longest "
            f"{int(lengths.max()):,}]: table_grad 3 calls bit-identical "
            f"{same}, no host sync, max abs err against an f64 sum "
            f"{err:.3e} (tol 1e-5 x {scale:.3e}); F.embedding's backward: 3 "
            f"calls up to {emb_apart:.3e} apart, {emb_err:.3e} from the f64 "
            f"sum | "
            f"segment_sum {row['segment_sum_ms']:.4f} ms, table_grad "
            f"{row['table_grad_ms']:.4f} ms a call | {smi}")
        if not (same and err <= 1e-5 * scale
                and sums.shape == (min(M, N), D)):
            raise AssertionError(f"segment sums [{name}] are not "
                                 f"reproducible or disagree")
        out[name] = row
    return out


# ------------------------------------------------------------- phase 11
# train and evaluate end to end: the synthetic set at the size of a small
# Taobao-shaped deployment, the CLI's defaults (batch 500, L = 50, valid
# 1 + 4, test 1 + 99), the clsr.yaml widths
P11_DATA = dict(n_users=5_000, n_items=50_000, n_cates=1_000, seed=0)
# the test split cut to its first 400 groups of 1 + 99 (of 5,000) for
# every test eval but phase 13's: its bucketed eval keeps 3,500
# (P13_TEST_GROUPS), a count at which 'auto' still picks three eval
# buckets (each but the top needs 1,024 groups)
P11_TEST_GROUPS = 400
# run A's eager epoch (K = 1) over the train set's first 20 batches
P11_EAGER_ROWS = 10_000
P11_ARGV = ["--dataset", "synthetic", "--model", "CLSR", "--epochs", "2",
            "--seed", "7"]
P11_PROFILE_K = 4              # steps a graphed call while profiling
P11_PREFETCH_ROWS = 10_000     # the prefetch on/off fits: 20 batches
P11_SERVE_GROUPS = 64
K1_ONOFF_TOL, SERVE_CKPT_TOL = 1e-4, 1e-6
EPOCH_RE = re.compile(
    r"^epoch (\d+) train time ([\d.]+)s \((\d+) steps, (\d+) examples, "
    r"([\d.]+) examples/s\), eval time ([\d.]+)s$", re.M)
VALID_RE = re.compile(r"^eval valid at epoch (\d+): (.*)$", re.M)
TEST_RE = re.compile(r"^test eval time ([\d.]+)s$", re.M)
BEST_RE = re.compile(r"^best epoch: (\d+)$", re.M)
PARSE_RE = re.compile(r"^parse (\w+): (\d+) lines in ([\d.]+)s$", re.M)


def recording(step, out):
    """`step` that also keeps each batch's (predictions, valid) in out,
    on the device."""
    def run(model, batch):
        preds, alpha = step(model, batch)
        out.append((preds, batch.valid))
        return preds, alpha
    return run


def valid_preds(out):
    """The predictions of the valid rows that `recording` kept."""
    return torch.cat([p[v > 0] for p, v in out])


class _Tee(io.TextIOBase):
    """stdout to the console and to a buffer."""

    def __init__(self):
        self.buf = io.StringIO()

    def write(self, text):
        sys.__stdout__.write(text)
        self.buf.write(text)
        return len(text)

    def flush(self):
        sys.__stdout__.flush()


def run_cli(argv):
    """`clsr_tpu_torch.cli.main(argv)` as a user runs it: (its printed
    text, wall s, launches)."""
    from clsr_tpu_torch import cli
    from clsr_tpu_torch.training.kernel_check import counted
    tee = _Tee()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc, launches = counted(lambda: cli.main(argv))
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli.main({argv}) returned {rc}")
    return tee.buf.getvalue(), wall, launches


def cli_numbers(text):
    """The epochs, valid metrics, test eval s and the test dict that the
    CLI printed."""
    epochs = [dict(epoch=int(m[0]), train_s=float(m[1]), steps=int(m[2]),
                   examples=int(m[3]), examples_per_s=float(m[4]),
                   valid_eval_s=float(m[5]))
              for m in EPOCH_RE.findall(text)]
    valid = {int(ep): {k: float(v) for k, v in
                       (kv.split(":") for kv in body.split(","))}
             for ep, body in VALID_RE.findall(text)}
    test_s = [float(t) for t in TEST_RE.findall(text)]
    parse_s = {name: float(t) for name, _, t in PARSE_RE.findall(text)}
    res = ast.literal_eval(text.strip().splitlines()[-1])
    return dict(epochs=epochs, valid=valid, test_eval_s=test_s,
                parse_s=parse_s, test=res)


def head(ds, n):
    """The first n rows of a ParsedDataset."""
    from clsr_tpu_torch.data.parser import ParsedDataset
    end = ds.offsets[n]
    return ParsedDataset(
        labels=ds.labels[:n], users=ds.users[:n], items=ds.items[:n],
        cates=ds.cates[:n], times=ds.times[:n], offsets=ds.offsets[:n + 1],
        hist_items=ds.hist_items[:end], hist_cates=ds.hist_cates[:end],
        time_diff=ds.time_diff[:end], time_from_first=ds.time_from_first[:end],
        time_to_now=ds.time_to_now[:end])


def keep_groups(path, groups, size):
    """Cut the TSV at `path` to its first `groups` groups of `size`
    lines (a group: a line and its negatives)."""
    with open(path) as f:
        lines = list(itertools.islice(f, groups * size))
    if len(lines) != groups * size:
        raise AssertionError(f"{path}: {len(lines)} lines, fewer than "
                             f"{groups} groups of {size}")
    with open(path, "w") as f:
        f.writelines(lines)


def parse_both(paths, vocabs):
    """Each split by the C++ parser and by the Python loop, timed, and
    held to the test bounds: ids, offsets and labels exact, the time
    features 1e-6 abs."""
    from clsr_tpu_torch.data.parser import parse_file
    out, native = {}, {}
    for split in ("train", "valid", "test"):
        row = {}
        for route, use_native in (("native", True), ("python", False)):
            t0 = time.perf_counter()
            row[route] = parse_file(paths[split], *vocabs,
                                    use_native=use_native)
            row[f"{route}_s"] = time.perf_counter() - t0
        a, b = row["native"], row["python"]
        exact = all(np.array_equal(getattr(a, f), getattr(b, f)) for f in (
            "labels", "users", "items", "cates", "times", "offsets",
            "hist_items", "hist_cates"))
        err = max(float(np.abs(getattr(a, f) - getattr(b, f)).max())
                  for f in ("time_diff", "time_from_first", "time_to_now"))
        log(f"parse {split}: {len(a):,} lines, {len(a.hist_items):,} history "
            f"events | C++ {row['native_s']:.3f} s, Python "
            f"{row['python_s']:.3f} s ({row['python_s'] / row['native_s']:.1f}"
            f"x) | ids/offsets/labels equal: {exact}, time features max abs "
            f"err {err:.3e} (tol 1e-6)")
        if not (exact and err <= 1e-6):
            raise AssertionError(f"C++ and Python parses of {split} differ")
        native[split] = a
        out[split] = dict(lines=len(a), events=len(a.hist_items),
                          native_s=row["native_s"],
                          python_s=row["python_s"], time_feature_err=err)
    return native, out


HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def host_launches(prof):
    """The host's launch calls in a profile: kernels, graphs, copies and
    sets (the CUDA runtime and driver calls by name)."""
    from torch.autograd import DeviceType
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CPU
               and e.key.startswith(HOST_LAUNCH_CALLS))


def profile_fit(trainer, loader, smi, graphed, n):
    """torch.profiler over n train steps streamed as the fit streams them
    (host batches, prefetch, the step): eager, n single steps of
    `trainer.train_step`; graphed, n // P11_PROFILE_K stacked calls of a
    `make_multi_train_step` of K = P11_PROFILE_K on the trainer's model
    (replays of one captured step, as the fit's K = 32 calls), after one
    call outside the window that warms up and captures.  The device's
    busy and idle share of the window, kernels run on the device and the
    host's launch calls per step."""
    from torch.profiler import ProfilerActivity, profile
    from clsr_tpu_torch.data.prefetch import device_batches
    from clsr_tpu_torch.training.steps import make_multi_train_step
    cfg = trainer.cfg
    rng = np.random.RandomState(1)
    gen = torch.Generator(device="cuda").manual_seed(5)
    if graphed:
        K = P11_PROFILE_K
        calls = n // K
        n = calls * K
        multi = make_multi_train_step(trainer.model, cfg, K)
        items = (b for b in loader.train_batches_stacked(cfg.batch_size, K,
                                                         rng)
                 if b.users.ndim == 2)
        run = lambda item: multi(trainer.state, item, gen)
    else:
        calls = n
        items = loader.train_batches(cfg.batch_size, rng)
        run = lambda item: trainer.train_step(trainer.state, item, gen)
    it = device_batches(items, trainer.device, cfg.prefetch_batches)
    trainer.state, _ = run(next(it))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _, b in zip(range(calls), it):
            trainer.state, parts = run(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    it.close()
    kernels = kernel_events(prof)
    busy_ms = sum(self_device_us(e) for e in kernels) / 1e3
    idle = 100 - 100 * busy_ms / wall_ms
    out = dict(steps=n, calls=calls, wall_ms_per_step=wall_ms / n,
               busy_ms_per_step=busy_ms / n, idle_pct=idle,
               device_kernels_per_step=sum(e.count for e in kernels) / n,
               host_launches_per_step=host_launches(prof) / n)
    log(f"profile[fit, {'graphed' if graphed else 'eager'}]: {n} streamed "
        f"steps in {calls} calls, {out['wall_ms_per_step']:.3f} ms a step "
        f"under the profiler; device busy {out['busy_ms_per_step']:.3f} ms "
        f"a step ({100 - idle:.1f}% of the window, idle {idle:.1f}%), "
        f"{out['device_kernels_per_step']:,.1f} kernels on the device and "
        f"{out['host_launches_per_step']:,.1f} host launch calls a step | "
        f"{smi}")
    return out


def state_tensors(state):
    """Every tensor of a TrainState: the model's (weights, BN buffers),
    the lazy rows and count, and the dense Adam state."""
    from clsr_tpu_torch.training.lazy_adam import LazyAdamState
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    opt = state.optimizer
    if isinstance(opt, LazyAdamState):
        out.update({f"moments/{k}": v for k, v in opt.moments.items()})
        out["count"] = opt.count
        opt = opt.dense_opt
    for i, st in enumerate(opt.state_dict()["state"].values()):
        out.update({f"adam/{i}/{k}": v for k, v in st.items()})
    return out


def differing(a, b):
    """The names of the tensors of two state_tensors dicts that are not
    bit-identical."""
    return sorted(k for k in a if not torch.equal(a[k], b[k]))


def graph_against_eager(what, cfg, sizes, loader, smi, timed_call=False,
                        weights=None, model_kw=None, timed_steps=None):
    """Phase 12: from one state and one generator seed, one call of the
    graphed K-step train step (its first step the eager warm-up, the
    other K - 1 replays) and a tail step (a replay) against K + 1 eager
    single steps on the same batches: every model, optimizer and lazy
    tensor and every loss part bit for bit, deterministic algorithms off;
    the launch counts of the call are K times the eager step's.
    `loader` gives the batches (or is a list of K + 1 device batches);
    `weights`, a state_dict, replaces both models' seeded init, and
    `model_kw` goes to their constructor (LGN's graph).  With
    `timed_call`, one more call of K replays on the same batches (or
    `timed_steps` replays, one a step) is timed: examples/s by the host clock to a sync, ms a step by CUDA
    events, and the call's peak device memory.  The generator's state
    after the graphed call and tail must equal its state after the eager
    steps (what an autosave keeps)."""
    from clsr_tpu_torch.data.prefetch import to_device
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.training.kernel_check import counted
    from clsr_tpu_torch.training.state import create_train_state
    from clsr_tpu_torch.training.steps import (LOSS_FIELDS,
                                               make_multi_train_step,
                                               make_train_step,
                                               stack_batches)
    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError("deterministic algorithms are on")
    K = cfg.train_steps_per_call
    if isinstance(loader, list):
        batches = loader[:K + 1]
    else:
        host = loader.train_batches(cfg.batch_size,
                                    np.random.RandomState(2))
        batches = [to_device(b, "cuda") for _, b in zip(range(K + 1), host)]
    if len(batches) != K + 1:
        raise AssertionError("the loader gave too few batches")
    rows = lambda p: torch.stack([getattr(p, f) for f in LOSS_FIELDS], -1)
    runs, counts, gen_states = {}, {}, {}
    for run in ("eager", "graph"):
        model = get_model_class(cfg.model_type)(cfg, *sizes,
                                                **(model_kw or {}))
        if weights is not None:
            model.load_state_dict(weights)
        state = create_train_state(model, cfg)
        gen = torch.Generator(device="cuda").manual_seed(21)
        if run == "eager":
            step = make_train_step(model, cfg)
            parts, counts[run] = counted(
                lambda: [step(state, b, gen)[1] for b in batches])
            losses = torch.stack([rows(p) for p in parts])
        else:
            multi = make_multi_train_step(model, cfg, K)
            (_, stacked), counts[run] = counted(
                lambda: multi(state, stack_batches(batches[:K]), gen))
            _, tail = multi.step(state, batches[K], gen)
            losses = torch.cat([rows(stacked), rows(tail)[None]])
        runs[run] = (state_tensors(state), losses)
        gen_states[run] = gen.get_state()
    (te, le), (tg, lg) = runs["eager"], runs["graph"]
    bad = differing(te, tg)
    same_losses = torch.equal(le, lg)
    want = {k: n // (K + 1) * K for k, n in counts["eager"].items()}
    log(f"phase 12 [{what}]: {K} graphed steps (1 eager warm-up, {K - 1} "
        f"replays) + 1 replayed tail against {K + 1} eager steps, B = "
        f"{cfg.batch_size}: {len(te)} state tensors, bit-identical "
        f"{len(te) - len(bad)} (differ: {bad[:5]}), loss parts bit-identical "
        f"{same_losses} | launches eager {counts['eager']}, graphed call "
        f"{counts['graph']} (want K x the eager step's: {want}) | capture {multi.capture_stats['capture_s']:.3f} s, graph pool "
        f"{multi.capture_stats['pool_bytes'] / 1e6:.1f} MB | {smi}")
    same_gen = torch.equal(gen_states["eager"], gen_states["graph"])
    log(f"phase 12 [{what}]: the generator's state after the graphed "
        f"call and tail equals its state after the eager steps: "
        f"{same_gen}")
    if bad or not same_losses or counts["graph"] != want or not same_gen:
        raise AssertionError(f"phase 12 [{what}]: the graphed steps differ "
                             f"from the eager ones")
    out = dict(steps=K + 1, tensors=len(te), differ=bad,
               losses_identical=same_losses, launches=counts,
               generator_identical=same_gen,
               capture=multi.capture_stats,
               loss=float(losses[-1, 0]))
    if timed_call:
        del runs, te, tg, step, parts    # the eager model's memory
        n = timed_steps or K
        stack = stack_batches(batches[:K])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        if n == K:
            multi(state, stack, gen)
        else:                          # n replays, one a step
            for b in batches[:n]:
                multi.step(state, b, gen)
        end.record()
        torch.cuda.synchronize()
        out["examples_per_s"] = n * cfg.batch_size / (
            time.perf_counter() - t0)
        out["step_ms"] = start.elapsed_time(end) / n
        out["timed_steps"] = n
        out["peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
    return out


@contextlib.contextmanager
def old_sums():
    """For timing only: the sums the reproducible gradient replaced, in
    place while the block runs: `F.embedding` (whose backward adds a
    repeated row with atomics) at the train lookups, and `index_add_`
    over the run index (got back from the run lengths with one
    `repeat_interleave`) in the compact update."""
    import torch.nn.functional as F
    from clsr_tpu_torch.models import base
    from clsr_tpu_torch.training import lazy_adam

    def index_add_sum(values, lengths):
        seg = torch.repeat_interleave(
            torch.arange(lengths.shape[0], device=values.device), lengths,
            output_size=values.shape[0])
        out = torch.zeros((lengths.shape[0],) + values.shape[1:],
                          dtype=values.dtype, device=values.device)
        return out.index_add_(0, seg, values)

    saved = base.lookup, lazy_adam.segment_sum
    base.lookup = lambda table, ids: F.embedding(ids, table)
    lazy_adam.segment_sum = index_add_sum
    try:
        yield
    finally:
        base.lookup, lazy_adam.segment_sum = saved


def repair_cost(what, model, cfg, state, batches, smi, rounds=3):
    """The cost of the reproducible sums in a train step, against the
    sums they replaced (`old_sums`), on the same state and batches:
    eager, the step ms by CUDA events (host launches included), median of
    len(batches) steps each in turns; graphed, the device ms a step of
    one captured step replayed len(batches) times a call (each variant
    captured with its own sums), median of `rounds` calls each in turns."""
    from contextlib import nullcontext
    from clsr_tpu_torch.training.steps import (make_multi_train_step,
                                               make_train_step,
                                               stack_batches)
    variants = ("sorted sums", "old sums")
    patch = lambda run: old_sums() if run == "old sums" else nullcontext()
    step = make_train_step(model, cfg)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    gen = torch.Generator(device="cuda").manual_seed(300)

    def timed(fn):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    eager = {run: [] for run in variants}
    for i, b in enumerate(batches):
        for run in variants[::1 if i % 2 else -1]:
            with patch(run):
                eager[run].append(timed(lambda: step(state, b, gen)))
    K = len(batches)
    stacked = stack_batches(batches)
    multi = {run: make_multi_train_step(model, cfg, K) for run in variants}
    for run in variants:                 # warm-up, capture, replays
        with patch(run):
            multi[run](state, stacked, gen)
    graphed = {run: [] for run in variants}
    for i in range(rounds):
        for run in variants[::1 if i % 2 else -1]:
            graphed[run].append(timed(lambda: multi[run](state, stacked,
                                                         gen)) / K)
    del multi
    med = {mode: {run: statistics.median(v) for run, v in ms.items()}
           for mode, ms in (("eager", eager), ("graphed", graphed))}
    cost = {mode: 100 * (m["sorted sums"] / m["old sums"] - 1)
            for mode, m in med.items()}
    log(f"{what}: the reproducible sums cost {cost['eager']:+.2f}% of an "
        f"eager step (median {med['eager']['sorted sums']:.3f} ms against "
        f"{med['eager']['old sums']:.3f} ms with F.embedding's backward and "
        f"index_add_, {K} steps each in turns) and {cost['graphed']:+.2f}% "
        f"of the graphed step's device time ({med['graphed']['sorted sums']:.3f}"
        f" ms against {med['graphed']['old sums']:.3f} ms a replayed step, "
        f"median of {rounds} calls of {K}) | {smi}")
    return dict(median_ms=med, eager_ms=eager, graphed_ms=graphed,
                cost_pct=cost)


def eager_epoch(what, cfg, sizes, loaders, smi):
    """One epoch of `Trainer.fit` with cfg's weights and gates but K = 1,
    the eager single steps the graph replaces, in the same run as the
    graphed fits: epoch s and examples/s, and the trainer."""
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.training.trainer import Trainer
    cfg = cfg.replace(train_steps_per_call=1, epochs=1, model_dir=None,
                      save_model=False, summaries_dir=None)
    trainer = Trainer(get_model_class("clsr")(cfg, *sizes), cfg,
                      log=lambda *_: None)
    trainer.fit(loaders["train"], loaders["valid"])
    e = trainer.epoch_stats[0]
    out = dict(e, examples_per_s=e["examples"] / e["train_s"],
               trainer=trainer)
    log(f"{what} eager epoch (K = 1): {e['train_s']:.3f} s, {e['steps']} "
        f"steps, {out['examples_per_s']:,.1f} examples/s, mean loss "
        f"{e['mean_loss']:.5f} | {smi}")
    return out


def check_counts(what, got, want):
    if {k: got[k] for k in want} != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")


# ------------------------------------------------------------- phase 13
# device-resident data and length buckets, on phase 11's data
P13_EDGES = "16,32"            # the edges when 'auto' picks no buckets
P13_TEST_GROUPS = 3_500        # the bucketed test eval's groups, of 5,000:
#                                a depth cut at which 'auto' still picks
#                                the three eval buckets 16, 24, 32
P13_PROFILE_K = 8              # steps a resident call while profiling
P13_TOL = 1e-4                 # bucketed / unbucketed predictions, and
                               # K1 and K2 against their plain versions


def p13_fit(cfg, sizes, loaders, **kw):
    """A one-epoch `Trainer.fit` of cfg with kw over it, counted: (the
    trainer, its launches, its log lines)."""
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.training.kernel_check import counted
    from clsr_tpu_torch.training.trainer import Trainer
    cfg = cfg.replace(epochs=1, model_dir=None, save_model=False,
                      summaries_dir=None, **kw)
    lines = []
    t = Trainer(get_model_class("clsr")(cfg, *sizes), cfg, log=lines.append)
    _, counts = counted(lambda: t.fit(loaders["train"], loaders["valid"]))
    return t, counts, lines


def examples_per_s(trainer):
    e = trainer.epoch_stats[0]
    return e["examples"] / e["train_s"]


def profile_resident(trainer, smi):
    """A K = P13_PROFILE_K `make_resident_multi_step` on the trainer's
    model and first feed: one call warms up and captures, one call runs
    under `torch.cuda.set_sync_debug_mode("error")` (a host sync in it
    raises), then torch.profiler over two calls: the device's idle share
    of the window, kernels on the device and host launch calls a step."""
    from torch.profiler import ProfilerActivity, profile
    from clsr_tpu_torch.training.steps import make_resident_multi_step
    cfg, K = trainer.cfg, P13_PROFILE_K
    B = cfg.batch_size
    feed = trainer.feeds[0][0]
    multi = make_resident_multi_step(trainer.model, cfg, K)
    gen = torch.Generator(device="cuda").manual_seed(5)
    state = trainer.state
    multi(state, feed, 0, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        multi(state, feed, K * B, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for c in (2, 3):
            multi(state, feed, c * K * B, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = 2 * K
    kernels = kernel_events(prof)
    busy_ms = sum(self_device_us(e) for e in kernels) / 1e3
    idle = 100 - 100 * busy_ms / wall_ms
    out = dict(steps=n, calls=2, wall_ms_per_step=wall_ms / n,
               busy_ms_per_step=busy_ms / n, idle_pct=idle,
               device_kernels_per_step=sum(e.count for e in kernels) / n,
               host_launches_per_step=host_launches(prof) / n,
               no_sync_call=True)
    log(f"profile[resident, graphed]: {n} steps in 2 calls of {K}, "
        f"{out['wall_ms_per_step']:.3f} ms a step under the profiler; "
        f"device busy {out['busy_ms_per_step']:.3f} ms a step (idle "
        f"{idle:.1f}%), {out['device_kernels_per_step']:,.1f} kernels on "
        f"the device and {out['host_launches_per_step']:,.1f} host launch "
        f"calls a step; a call of {K} under sync debug mode 'error': no "
        f"host sync | {smi}")
    return out


def resident_against_streamed(cfg_b, sizes, loaders, smi):
    """Phase 13.1: run B's configuration (lazyadam) and a dense-Adam one,
    each resident and streamed from one seed, one graphed epoch each:
    every model, optimizer and BN tensor and the valid metrics
    bit-identical, deterministic algorithms off."""
    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError("deterministic algorithms are on")
    out, keep = {}, None
    for opt in ("lazyadam", "adam"):
        fits = {}
        for r in ("on", "off"):
            t, counts, _ = p13_fit(cfg_b, sizes, loaders, optimizer=opt,
                                   resident_data=r, seed=3)
            fits[r] = dict(state=state_tensors(t.state),
                           valid=t.eval_history, epoch=t.epoch_stats[0],
                           examples_per_s=examples_per_s(t),
                           launches=counts, upload=t.upload,
                           capture=(t.resident_step.capture_stats
                                    if r == "on" else
                                    t.multi_step.capture_stats))
            if opt == "lazyadam" and r == "on":
                keep = t
            else:
                del t
        bad = differing(fits["on"]["state"], fits["off"]["state"])
        same_valid = fits["on"]["valid"] == fits["off"]["valid"]
        up = fits["on"]["upload"]
        log(f"phase 13 [{opt}]: resident against streamed, one graphed "
            f"epoch each (K = {cfg_b.train_steps_per_call}): "
            f"{len(fits['on']['state'])} state tensors, differ {bad[:5]}, "
            f"valid metrics bit-identical {same_valid} | epoch examples/s "
            f"resident {fits['on']['examples_per_s']:,.1f}, streamed "
            f"{fits['off']['examples_per_s']:,.1f} | upload "
            f"{up['bytes'] / 1e6:.1f} MB in {up['s']:.3f} s | {smi}")
        if bad or not same_valid:
            raise AssertionError(f"phase 13 [{opt}]: the resident fit "
                                 f"differs from the streamed one")
        for f in fits.values():
            del f["state"]
        out[opt] = fits
    out["profile"] = profile_resident(keep, smi)
    out["fit_launches"] = out["lazyadam"]["on"]["launches"]
    out["examples_per_s"] = out["lazyadam"]["on"]["examples_per_s"]
    del keep
    return out


def eval_order(loader, group, paddings):
    """The anchor rows of `run_weighted_eval`'s groups in the order it
    scores them (by bucket under `paddings`)."""
    from clsr_tpu_torch.data.resident import bucket_rows
    v = loader.view
    anchors = np.arange(0, len(v.labels), group)
    if not paddings:
        return anchors
    return np.concatenate([anchors[local] for _, local in bucket_rows(
        v.lengths[anchors], v.item_hist.shape[1], paddings)])


def kernels_at(cfg, model, batch):
    """K1 and K2 against their plain versions on the inputs the kernel
    eval step gives them on `batch`: (K1 max abs err, K2 max abs err)."""
    from clsr_tpu_torch.ops import fused_attention as fa
    from clsr_tpu_torch.ops import fused_scan as fs
    from clsr_tpu_torch.training.steps import make_eval_step_fn
    seen = {}
    k1, k2 = fa.fused_eval_attention, fs._forward

    def rec1(*args):
        out = k1(*args)
        seen.setdefault("k1", (args, out))
        return out

    def rec2(*args, **kw):
        out = k2(*args, **kw)
        seen.setdefault("k2", (args, out))
        return out

    rec1.launches = 0     # the wrapper ticks its module name's counter
    fa.fused_eval_attention, fs._forward = rec1, rec2
    try:
        make_eval_step_fn(cfg)(model, batch)
    finally:
        fa.fused_eval_attention, fs._forward = k1, k2
    if set(seen) != {"k1", "k2"}:
        raise AssertionError(f"the eval step launched {sorted(seen)}")
    with torch.inference_mode():   # the eval step's tensors
        args, got = seen["k1"]
        e1 = (got - fa.eval_scorer_reference(*args)).abs().max().item()
        args, got = seen["k2"]
        want = fs.scan_reference(*args)
        e2 = max((g - w).abs().max().item() for g, w in zip(got[:3], want))
    return e1, e2


def buckets_fit_and_eval(cfg_b, sizes, loaders, resident_eps, smi):
    """Phase 13.2-13.3: run C (run B's configuration with length_buckets
    'auto', so masked BN statistics and the epoch-end refresh), its
    launches and graphs; then on its weights the test eval with buckets
    against without them, and K1 and K2 against their plain versions at
    every Lb the eval runs."""
    from clsr_tpu_torch.data.prefetch import to_device
    from clsr_tpu_torch.data.resident import resolve_bucket_paddings
    from clsr_tpu_torch.training import kernel_check
    from clsr_tpu_torch.training.evaluator import run_weighted_eval
    from clsr_tpu_torch.training.kernel_check import counted
    cfg_c = cfg_b.replace(length_buckets="auto", resident_data="auto")
    auto = resolve_bucket_paddings(cfg_c, loaders["train"].view.lengths)
    if not auto:
        log(f"phase 13: length_buckets 'auto' picks no buckets on this "
            f"data; run C uses the edges {P13_EDGES}")
        cfg_c = cfg_c.replace(length_buckets=P13_EDGES)
    t, counts, lines = p13_fit(cfg_c, sizes, loaders)
    e = t.epoch_stats[0]
    steps, refresh = e["steps"], cfg_c.bn_refresh_batches
    valid = loaders["valid"]
    vpads = resolve_bucket_paddings(cfg_c, valid.view.lengths[
        np.arange(0, len(valid.view.labels), 5)])
    n_valid = sum(1 for _ in valid.eval_batches(
        5, cfg_c.batch_size // 5, paddings=vpads))
    graphs = {lb: dict(capture_s=st["capture_s"],
                       pool_mb=st["pool_bytes"] / 1e6)
              for lb, st in t.resident_step.capture_stats.items()}
    lb_rows = [(f.res.seq_len, f.res.n_rows) for f, _ in t.feeds]
    last = t.eval_history[-1][1]
    eps = examples_per_s(t)
    log(f"run C (length_buckets {cfg_c.length_buckets!r}, masked BN "
        f"statistics, {refresh} refresh batches): Lb x rows "
        f"{', '.join(f'{lb}x{n}' for lb, n in lb_rows)}; graphs (one "
        f"memory pool each) {graphs}; epoch {e['train_s']:.3f} s, {steps} "
        f"steps, {eps:,.1f} examples/s against run B resident "
        f"{resident_eps:,.1f} ({eps / resident_eps:.2f}x); refresh "
        f"{e['refresh_s']:.3f} s; valid {last} | launches {counts} | {smi}")
    check_counts("run C epoch", counts, dict(
        row_scatter=steps, clsr_scan_backward=steps, train_stats0=0,
        train_stats1=0, eval_scorer=0,
        clsr_scan=steps + refresh + n_valid))
    if not (t.bucketed and last["auc"] > 0.5
            and np.isfinite(e["mean_loss"])):
        raise AssertionError(f"run C failed its gates: {last}, "
                             f"{e['mean_loss']}")

    # ---- 13.3: the test eval with buckets against without them ---------
    test, G = loaders["test"], cfg_c.test_num_ngs + 1
    runs = {}
    for run, cfg in (("buckets", cfg_c),
                     ("no buckets", cfg_c.replace(length_buckets="off"))):
        kept = []
        t0 = time.perf_counter()
        res, c = counted(lambda: run_weighted_eval(
            recording(t.eval_step, kept), t.state.model, test, cfg,
            cfg.test_num_ngs))
        secs = time.perf_counter() - t0
        pads = (resolve_bucket_paddings(cfg, test.view.lengths[
            np.arange(0, len(test.view.labels), G)]) if run == "buckets"
            else [])
        order = eval_order(test, G, pads)
        preds = valid_preds(kept).cpu().numpy()
        runs[run] = dict(res=res, s=secs, launches=c, pads=pads,
                         preds=preds[np.argsort(order, kind="stable")])
    # the dispatches and one copy back without the host's metrics, once
    # each (a depth cut, to make room for phase 19): the timed evals above
    # paid their shapes' first calls
    bare = {"buckets": [], "no buckets": []}
    for run in ("no buckets", "buckets"):
        cfg = cfg_c.replace(metrics=(), pairwise_metrics=(),
                            weighted_metrics=(),
                            length_buckets=("off" if run == "no buckets"
                                            else cfg_c.length_buckets))
        t0 = time.perf_counter()
        run_weighted_eval(t.eval_step, t.state.model, test, cfg,
                          cfg.test_num_ngs)
        bare[run].append(time.perf_counter() - t0)
    for run, r in runs.items():
        r["bare_s"] = bare[run]
    pb, pu = runs["buckets"]["preds"], runs["no buckets"]["preds"]
    pred_err = float(np.abs(pb - pu).max())
    rb, ru_ = runs["buckets"]["res"], runs["no buckets"]["res"]
    metric_err = max(abs(rb[k] - ru_[k]) for k in ru_)
    n_calls = sum(1 for _ in test.eval_batches(
        G, cfg_c.batch_size // G, paddings=runs["buckets"]["pads"]))
    log(f"test eval with buckets {runs['buckets']['pads']} against "
        f"without: {pb.size:,} predictions, max abs err {pred_err:.3e}, "
        f"metrics {metric_err:.3e} apart (tol {P13_TOL}) | "
        f"{runs['buckets']['s']:.3f} s ({n_calls} dispatches) against "
        f"{runs['no buckets']['s']:.3f} s, without the metrics (in turns) "
        f"{bare['buckets']} s against {bare['no buckets']} s | launches "
        f"{runs['buckets']['launches']} | {smi}")
    check_counts("run C bucketed test eval", runs["buckets"]["launches"],
                 dict(eval_scorer=n_calls, clsr_scan=n_calls))
    if not (rb.keys() == ru_.keys() and pb.shape == pu.shape
            and pred_err <= P13_TOL and metric_err <= P13_TOL):
        raise AssertionError("the bucketed test eval differs from the "
                             "unbucketed one")

    # ---- K1 and K2 against their plain versions at every Lb ------------
    per_lb = {}
    for Lb, batch in first_batches(test, G, cfg_c.batch_size,
                                   runs["buckets"]["pads"]).items():
        e1, e2 = kernels_at(cfg_c, t.state.model, to_device(batch, "cuda"))
        per_lb[Lb] = dict(k1_err=e1, k2_err=e2)
    # and the kernel train and eval steps against the plain ones at each
    # train Lb (kernel_check: scores 1e-4 abs, loss parts 1e-4 rel,
    # gradients 1e-4 of max abs, BN statistics 1e-5, K5 bit for bit), the
    # plain step on the kernel step's side of each ReLU, whose inputs may
    # change sign only within 1e-4 of zero (same_kinks: both steps' ReLUs
    # run in PyTorch here, K1 and K3 being off in run C's train steps)
    train_lb = {}
    tests = first_batches(test, G, cfg_c.batch_size,
                          [f.res.seq_len for f, _ in t.feeds])
    for feed, _ in t.feeds:
        Lb = feed.res.seq_len
        res_ = kernel_check.compare_steps(
            cfg_c, t.state.model.state_dict(), sizes,
            gathered(feed, cfg_c.batch_size),
            to_device(tests.get(Lb, next(iter(tests.values()))), "cuda"),
            same_kinks=True)
        train_lb[Lb] = dict(
            score_err=res_["score_err"], loss_rel_err=res_["loss_rel_err"],
            grad_rel_err=res_["grad_rel_err"], bn_err=res_["bn_err"],
            k5_identical=res_["k5_identical"], relus=res_["relus"],
            kinks=res_["kinks"], kink_abs=res_["kink_abs"],
            failures=kernel_check.failures(res_),
            launches=res_["launches"]["train/kernel"])
    log(f"K1 and K2 against their plain versions at each eval Lb: "
        f"{per_lb} (tol {P13_TOL}); the kernel train steps against the "
        f"plain ones at each train Lb: {train_lb} | {smi}")
    if any(v["k1_err"] > P13_TOL or v["k2_err"] > P13_TOL
           for v in per_lb.values()):
        raise AssertionError(f"K1 / K2 disagree at a bucket: {per_lb}")
    for lb, v in train_lb.items():
        check_counts(f"train step at Lb {lb}", v["launches"], dict(
            clsr_scan=1, clsr_scan_backward=1, row_scatter=1,
            train_stats0=0, train_stats1=0, eval_scorer=0))
        if v["failures"] or v["k5_identical"] is not True:
            raise AssertionError(f"the kernel train step at Lb {lb}: "
                                 f"{v['failures']}")
    for r in runs.values():
        del r["preds"]
    return dict(
        length_buckets=cfg_c.length_buckets, lb_rows=lb_rows, graphs=graphs,
        epoch=e, examples_per_s=eps, resident_b_examples_per_s=resident_eps,
        launches=counts, valid=last, test=runs, pred_err=pred_err,
        metric_err=metric_err, test_dispatches=n_calls, kernels_by_lb=per_lb,
        steps_by_lb=train_lb, cfg=cfg_c), t


def first_batches(loader, G, B, pads):
    """{Lb: the first eval batch of each bucket} under `pads`."""
    out = {}
    for b in loader.eval_batches(G, B // G, paddings=pads):
        out.setdefault(b.item_hist.shape[1], b)
    return out


def gathered(feed, B):
    """The batch at the start of a feed's permutation."""
    feed.offset.fill_(0)
    return feed.batch(B)


def bucket_graph_against_eager(cfg_c, sizes, loader, smi):
    """Phase 13.4: on the bucket with the most rows, from one state and
    one generator seed, one graphed resident call of K steps (its first
    the eager warm-up) and a replayed tail step against K + 1 eager steps
    on the same gathered batches: every state tensor and loss part bit
    for bit; the call's launch counts K times the eager step's."""
    from clsr_tpu_torch.data.resident import (EpochFeed, build_resident_buckets,
                                              epoch_permutation, perm_length,
                                              resolve_bucket_paddings)
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.training.kernel_check import counted
    from clsr_tpu_torch.training.state import create_train_state
    from clsr_tpu_torch.training.steps import (LOSS_FIELDS,
                                               make_resident_multi_step,
                                               make_train_step)
    B = cfg_c.batch_size
    pads = resolve_bucket_paddings(cfg_c, loader.view.lengths)
    res, rows = max(build_resident_buckets(loader.view, pads, "cuda"),
                    key=lambda b: len(b[1]))
    elig = np.flatnonzero(loader.view.lengths[rows] >= cfg_c.min_seq_length)
    perm, n_use, _, _ = epoch_permutation(elig, np.random.RandomState(2),
                                          B, 1, cfg_c.drop_remainder_min)
    K = min(cfg_c.train_steps_per_call, -(-n_use // B) - 1)
    rows_of = lambda p: torch.stack([getattr(p, f) for f in LOSS_FIELDS], -1)
    runs, counts = {}, {}
    for run in ("eager", "graph"):
        model = get_model_class("clsr")(cfg_c, *sizes)
        state = create_train_state(model, cfg_c)
        gen = torch.Generator(device="cuda").manual_seed(21)
        feed = EpochFeed(res, perm_length(len(elig), B,
                                          cfg_c.drop_remainder_min))
        feed.set_epoch(perm, n_use)
        if run == "eager":
            step = make_train_step(model, cfg_c)

            def eager():
                out = []
                for i in range(K + 1):
                    feed.offset.fill_(i * B)
                    out.append(step(state, feed.batch(B), gen)[1])
                return out
            parts, counts[run] = counted(eager)
            losses = torch.stack([rows_of(p) for p in parts])
        else:
            multi = make_resident_multi_step(model, cfg_c, K)
            (_, stacked), counts[run] = counted(
                lambda: multi(state, feed, 0, gen))
            _, tail = multi(state, feed, K * B, gen, 1)
            losses = torch.cat([rows_of(stacked), rows_of(tail)])
        runs[run] = (state_tensors(state), losses)
    (te, le), (tg, lg) = runs["eager"], runs["graph"]
    bad = differing(te, tg)
    same_losses = torch.equal(le, lg)
    want = {k: n // (K + 1) * K for k, n in counts["eager"].items()}
    cap = multi.capture_stats[res.seq_len]
    log(f"phase 13 [bucket Lb = {res.seq_len}, {res.n_rows} rows]: {K} "
        f"graphed resident steps (1 eager warm-up, {K - 1} replays) + 1 "
        f"replayed tail against {K + 1} eager steps on the same gathered "
        f"batches, B = {B}: {len(te)} state tensors, bit-identical "
        f"{len(te) - len(bad)} (differ: {bad[:5]}), loss parts "
        f"bit-identical {same_losses} | launches eager {counts['eager']}, "
        f"graphed call {counts['graph']} (want {want}) | capture "
        f"{cap['capture_s']:.3f} s, pool {cap['pool_bytes'] / 1e6:.1f} MB "
        f"| {smi}")
    if bad or not same_losses or counts["graph"] != want:
        raise AssertionError("phase 13: the bucketed graph differs from "
                             "the eager steps")
    return dict(Lb=res.seq_len, rows=res.n_rows, steps=K + 1,
                tensors=len(te), differ=bad, losses_identical=same_losses,
                launches=counts, capture=cap)


def resident_and_buckets(cfg_b, sizes, loaders, smi):
    """Phase 13: resident against streamed, the bucketed fit, the
    bucketed test eval, and a bucketed graph against eager steps."""
    t13, marks = time.perf_counter(), {}

    def mark(label):
        marks[label] = time.perf_counter() - t13
        log(f"[phase 13: {label} done at {marks[label]:.1f} s]")

    pair = resident_against_streamed(cfg_b, sizes, loaders, smi)
    mark("resident against streamed")
    bucketed, trainer = buckets_fit_and_eval(
        cfg_b, sizes, loaders, pair["examples_per_s"], smi)
    del trainer
    mark("run C and its test eval")
    graph = bucket_graph_against_eager(bucketed.pop("cfg"), sizes,
                                       loaders["train"], smi)
    mark("bucketed graph against eager")
    return dict(resident=pair, buckets=bucketed, graph=graph, marks_s=marks,
                launches={"fit_resident": pair["fit_launches"],
                          "fit_buckets": {
                              k: bucketed["launches"][k]
                              + bucketed["test"]["buckets"]["launches"][k]
                              for k in bucketed["launches"]}})


# ------------------------------------------------------------- phase 14
# the other optimizers, bf16 tables and compute, int8 serving tables
P14_BF16 = dict(embedding_dtype="bfloat16", compute_dtype="bfloat16")
# the seven other rules, and a name the JAX package runs as sgd
P14_RULES = ("adadelta", "adagrad", "sgd", "pgd", "rmsprop", "ftrl",
             "padagrad", "momentum")
P14_OPT_K = 4                  # graphed steps a rule (then a tail)
P14_TRAIN_K = 8                # graphed steps a timed call at Taobao size
P14_SCORE_TOL, P14_LOSS_REL = 2e-2, 1e-2   # bf16 compute: kernel / plain
INT8_F32_TOL = 0.03            # int8 / f32 scores (JAX's own test)
INT8_CPU_TOL = 1e-4            # the card's int8 service / the CPU port's


def table_mb(model):
    """MB of the model's embedding tables (and int8 scales)."""
    return sum(p.numel() * p.element_size()
               for n, p in model.named_parameters()
               if "_embedding" in n) / 1e6


def check_row_update_bf16(smi):
    """Phase 14 (a): K5 on bf16 rows at phase 9's bench shape (500,000
    x 40, 58,000 skewed ids) bit-identical to its plain version and to
    index_copy_, timed as phase 9 times it (a call, on the device by
    graph replay, the host, index_copy_ and the plain version, fresh ids
    and rows a call), its bound the function's bytes (ids, bf16 rows
    read and written); then the compact step's group of 8 entries, the
    four tables in bf16 beside their f32 pmn rows, in one launch."""
    from clsr_tpu_torch.ops import row_update as ru
    shape = BENCH_SHAPE
    N, W = shape["N"], shape["W"]
    g = torch.Generator(device="cuda").manual_seed(43)
    table = torch.randn(N, W, generator=g, device="cuda").bfloat16()

    def draw():
        ids, rows, n = row_update_ids(shape, g)
        return ids, rows.bfloat16(), n

    ids, rows, n_valid = draw()
    want = ru.scatter_rows_reference(table.clone(), ids, rows)
    got = ru.scatter_rows(table.clone(), ids, rows)
    lib = table.clone().index_copy_(0, ids[:n_valid].long(), rows[:n_valid])
    torch.cuda.synchronize()
    same = dict(plain=torch.equal(got, want),
                index_copy_=torch.equal(got, lib))
    err = (got.float() - want.float()).abs().max().item()
    del got, want, lib
    sets = [draw() for _ in range(TIMED_SETS)]
    lib_sets = [(i[:n].long(), r[:n]) for i, r, n in sets]
    work = table.clone()
    M = ids.numel()
    n_mean = statistics.mean(n for _, _, n in sets)
    n_bytes = 4 * M + 2 * (M * W + n_mean * W)
    bound_ms, bound_by = bound(n_bytes, 0)
    plain_ms = cuda_ms(cycling(sets, lambda i, r, n:
                               ru.scatter_rows_reference(work, i, r)))
    calls = {"row_scatter": cycling(sets, lambda i, r, n:
                                    ru.scatter_rows(work, i, r)),
             "index_copy_": cycling(lib_sets, lambda i, r:
                                    work.index_copy_(0, i, r))}
    per_call, host = in_turns(calls)
    device = {k: graph_ms(c, TIMED_SETS) for k, c in calls.items()}
    res = dict(bit_identical=same, max_abs_err=err,
               ms=per_call["row_scatter"], device_ms=device["row_scatter"],
               host_us=host["row_scatter"], plain_ms=plain_ms,
               library_ms=per_call["index_copy_"],
               library_device_ms=device["index_copy_"],
               library_host_us=host["index_copy_"], bound_ms=bound_ms,
               bound_by=bound_by, bytes=n_bytes, N=N, W=W, M=M,
               n_valid=n_mean, timed_sets=TIMED_SETS, turns=TURNS)
    log(f"phase 14 (a) K5 row_scatter [bf16 bench: N={N} W={W} M={M}, "
        f"{n_mean:.1f} valid, {TIMED_SETS} fresh sets]: bit-identical to "
        f"the plain version {same['plain']}, to index_copy_ "
        f"{same['index_copy_']} | per call (median of {TURNS} in turns): "
        f"kernel {res['ms']:.4f} ms, plain {plain_ms:.4f} ms, index_copy_ "
        f"{res['library_ms']:.4f} ms | on the device (CUDA graph): kernel "
        f"{res['device_ms']:.4f} ms ({100 * bound_ms / res['device_ms']:.1f}"
        f"% of bound), index_copy_ {res['library_device_ms']:.4f} ms | "
        f"host per call: wrapper {res['host_us']:.2f} us | the function's "
        f"{n_bytes / 1e6:.2f} MB, bound {bound_ms:.4f} ms ({bound_by}) | "
        f"{smi}")
    if not all(same.values()):
        raise AssertionError(f"K5 on bf16 rows differs: {same}")
    del work, sets, lib_sets, table
    torch.cuda.empty_cache()
    out = {"row_scatter_bf16/bench": res}
    out.update(check_step_group(smi, torch.bfloat16,
                                (("bf16 tables+pmn", True),)))
    return out


def eval_batch_from(batch, G, rows, seed):
    """The first `rows` rows of a train batch with G random candidates
    each: an eval batch at a K1 shape (G >= 8)."""
    import dataclasses
    g = torch.Generator(device="cuda").manual_seed(seed)
    cut = {f.name: getattr(batch, f.name)[:rows].clone()
           for f in dataclasses.fields(batch)}
    cut["items"] = torch.randint(1, ITEMS, (rows, G), generator=g,
                                 device="cuda", dtype=torch.int32)
    cut["cates"] = torch.randint(1, CATES, (rows, G), generator=g,
                                 device="cuda", dtype=torch.int32)
    cut["labels"] = torch.zeros(rows, G, device="cuda")
    return type(batch)(**cut)


def train_bf16(smi):
    """Phase 14 (b): the lazyadam compact train step at Taobao size (B =
    400, G = 5, L = 50, every kernel gate on) in f32, with bf16 tables
    under f32 compute, and with bf16 tables and compute, from the same
    weights (phase 10's).  Each configuration's kernel step against its
    plain step on phase 10's first batch (`training.kernel_check`): f32,
    phase 8/10's gates; bf16 tables under f32 compute, the same scores,
    loss parts, dense gradient and BN errors as the f32 code gives on
    the same values (f32 tables holding the bf16 ones; phase 8/10's
    gradient gate is data-sensitive on the kernel path itself,
    `probe_kernel_gate.py`) and table-row gradients no further from the
    plain step than there (or than the gate), one bf16 rounding aside;
    bf16 compute, scores 2e-2 abs and loss parts 1e-2 relative; K5
    bit-identical to its plain version everywhere; the launches (K2
    none under bf16 compute).  Then per configuration a graphed call of
    P14_TRAIN_K steps (warm-up and capture) and a timed one: ms a step,
    examples/s, device memory kept between steps and peak, table MB."""
    from clsr_tpu_torch.config import CONFIG_DIR, load_config
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.training import kernel_check
    from clsr_tpu_torch.training.kernel_check import counted
    from clsr_tpu_torch.training.state import create_train_state
    from clsr_tpu_torch.training.steps import (make_multi_train_step,
                                               stack_batches)
    sizes = (USERS, ITEMS, CATES)
    K = P14_TRAIN_K
    base = load_config(os.path.join(CONFIG_DIR, "clsr.yaml"),
                       user_vocab="u", item_vocab="i", cate_vocab="c", seed=0,
                       optimizer="lazyadam", use_pallas_train_attention="on",
                       use_pallas_scan=True, train_steps_per_call=K)
    cfgs = {"f32": base,
            "bf16 tables": base.replace(embedding_dtype="bfloat16"),
            "bf16 tables+compute": base.replace(**P14_BF16)}
    # phase 10's batches (its first batch is where phase 8/10's gates
    # were set; the gradient gate is data-sensitive, PERF.md PR 13)
    batches = train_batches(2 * K + 1, 8, *sizes)
    test_batch = eval_batch_from(batches[0], 100, 8, 15)
    weights, out, path_counts = None, {}, {}
    for run, cfg in cfgs.items():
        model = get_model_class("clsr")(cfg, *sizes)
        if weights is None:
            g = torch.Generator(device="cuda").manual_seed(6)
            with torch.no_grad():      # weights and BN away from init
                for p in model.parameters():
                    p.add_(torch.randn(p.shape, generator=g,
                                       device="cuda") * 0.1)
            weights = {k: v.detach().clone()
                       for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(weights)   # bf16 tables: rounded
        res = {"table_mb": table_mb(model)}
        bf16_compute = cfg.compute_dtype == "bfloat16"
        shapes = kernel_check.compare_steps(cfg, model.state_dict(),
                                            sizes, batches[0],
                                            test_batch)
        lc = shapes["launches"]
        k2 = 0 if bf16_compute else 1
        check_counts(f"phase 14 (b) [{run}] kernel train step",
                     lc["train/kernel"], dict(
                         train_stats0=2, train_stats1=2, eval_scorer=2,
                         clsr_scan=k2, clsr_scan_backward=k2,
                         row_scatter=1))
        check_counts(f"phase 14 (b) [{run}] kernel eval step",
                     lc["eval/kernel"], dict(eval_scorer=1,
                                             clsr_scan=k2))
        if bf16_compute:
            bad = ([] if shapes["score_err"] <= P14_SCORE_TOL else
                   [f"scores {shapes['score_err']:.3e}"]) + (
                [] if shapes["loss_rel_err"] <= P14_LOSS_REL else
                [f"loss parts {shapes['loss_rel_err']:.3e}"])
        elif cfg.embedding_dtype == "bfloat16":
            # the f32 code on the same numbers (f32 tables that hold the
            # bf16 values) gives the yardstick: the phase 8/10 gradient
            # gate is data-sensitive on the kernel path itself
            # (probe_kernel_gate.py), so bf16 tables must reproduce its
            # dense results exactly and pass the table-row gate
            ref = kernel_check.compare_steps(
                base, {k: (v.bfloat16().float()
                           if k.endswith("_embedding") else v)
                       for k, v in weights.items()},
                sizes, batches[0], test_batch)
            same = {k: shapes[k] == ref[k] for k in (
                "score_err", "loss_rel_err", "grad_rel_err",
                "zero_grad_abs_err", "bn_err")}
            rows_ok = shapes["table_grad_rel_err"] <= max(
                kernel_check.GRAD_REL, ref["table_grad_rel_err"])
            bad = ([f"differs from the f32 code on the same values: "
                    f"{same}"] if not all(same.values()) else []) + (
                [] if rows_ok else [
                    f"table rows {shapes['table_grad_rel_err']:.3e} past "
                    f"the f32 code's {ref['table_grad_rel_err']:.3e}"])
            res["f32_code_same_values"] = {
                k: v for k, v in ref.items() if k != "launches"}
            log(f"phase 14 (b) [{run}]: the f32 code on the same values "
                f"(f32 tables holding the bf16 ones): scores, loss parts, "
                f"dense gradients, BN stats equal {same}; table rows "
                f"{shapes['table_grad_rel_err']:.3e} here (one bf16 step "
                f"allowed), {ref['table_grad_rel_err']:.3e} there; phase "
                f"8/10's gates missed there {kernel_check.failures(ref)} "
                f"and here {kernel_check.failures(shapes)} | {smi}")
        else:
            bad = kernel_check.failures(shapes)
        if shapes["k5_identical"] is not True:
            bad.append("K5 differs from its plain version")
        log(f"phase 14 (b) [{run}] kernel step against plain step, "
            f"first batch (B = {TRAIN_B}, eval 8 x 100): scores max abs "
            f"err {shapes['score_err']:.3e}, loss parts max rel err "
            f"{shapes['loss_rel_err']:.3e} (tol "
            + (f"{P14_SCORE_TOL} / {P14_LOSS_REL}" if bf16_compute
               else "1e-4 / 1e-4") + f"), gradients max err / max abs "
            f"{shapes['grad_rel_err']:.3e}, table row gradients "
            f"{shapes['table_grad_rel_err']:.3e}, BN stats "
            f"{shapes['bn_err']:.3e}, K5 bit-identical "
            f"{shapes['k5_identical']} | launches kernel train "
            f"{ {k: n for k, n in lc['train/kernel'].items() if n} } | "
            f"{smi}")
        if bad:
            raise AssertionError(f"phase 14 (b) [{run}]: {bad}")
        res["kernel_check"] = {k: v for k, v in shapes.items()
                               if k != "launches"}
        res["kernel_check_launches"] = lc
        state = create_train_state(model, cfg)
        multi = make_multi_train_step(model, cfg, K)
        gen = torch.Generator(device="cuda").manual_seed(16)
        multi(state, stack_batches(batches[1:K + 1]), gen)   # capture
        stack = stack_batches(batches[K + 1:2 * K + 1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 1e6
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        (_, parts), counts = counted(lambda: multi(state, stack, gen))
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / K
        losses = parts.loss.cpu().numpy()
        kept = path_resident_mb(model, state.optimizer)
        res.update(ms_per_step=ms, examples_per_s=TRAIN_B / ms * 1e3,
                   kept_mb=kept, peak_mb=kept + torch.cuda.
                   max_memory_allocated() / 1e6 - base_mb,
                   losses=losses.tolist(), launches=counts,
                   capture=multi.capture_stats)
        path_counts[run] = counts
        log(f"phase 14 (b) [{run}]: tables {res['table_mb']:.1f} MB | a "
            f"graphed call of {K} steps: {ms:.3f} ms a step, "
            f"{res['examples_per_s']:,.0f} examples/s | device memory kept "
            f"{kept:.1f} MB, peak {res['peak_mb']:.1f} MB | losses "
            f"{losses[0]:.5f} .. {losses[-1]:.5f} | launches "
            f"{ {k: n for k, n in counts.items() if n} } | {smi}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"phase 14 (b) [{run}]: losses {losses}")
        out[run] = res
        del model, state, multi, stack
        torch.cuda.empty_cache()
    k2_16 = path_counts["bf16 tables+compute"]
    if k2_16["clsr_scan"] or k2_16["clsr_scan_backward"]:
        raise AssertionError(f"K2 launched under bf16 compute: {k2_16}")
    out["launches"] = {k: path_counts["bf16 tables"][k] + k2_16[k]
                       for k in k2_16}
    return out


def dispatch_ms(svc, reqs, reps=10):
    """Median ms of one `score(reqs)` dispatch (host clock; it ends in a
    device-to-host copy)."""
    svc.score(reqs)
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        svc.score(reqs)
        times.append(time.perf_counter() - t)
    return statistics.median(times) * 1e3


def serve_int8(smi):
    """Phase 14 (e): int8 serving tables at phase 5's Taobao sizes: a
    service with seeded random weights (phase 5's noise), its float
    weights saved and given to `ScoringService(..., checkpoint=...,
    int8_tables=True)`; 64 x 100 and 8 x 10 requests, one K1 launch a
    dispatch, scores within INT8_F32_TOL of the f32 service and within
    INT8_CPU_TOL of the CPU port's int8 service on the 8 x 10 requests;
    table MB (f32 against int8 + scales), median dispatch ms and peak
    device memory."""
    from clsr_tpu_torch.config import CONFIG_DIR, load_config
    from clsr_tpu_torch.ops.fused_attention import fused_eval_attention
    from clsr_tpu_torch.serving import ScoringService
    cfg = load_config(os.path.join(CONFIG_DIR, "clsr.yaml"),
                      user_vocab="u", item_vocab="i", cate_vocab="c", seed=0)
    sizes = (USERS, ITEMS, CATES)
    rng = np.random.RandomState(14)
    big = make_requests(rng, 64, 100, *sizes)
    small = make_requests(rng, 8, 10, *sizes)
    vocabs = vocab_for(big + small)
    f32 = ScoringService(cfg, *sizes, *vocabs)
    spread(f32.model, 5)       # phase 5's noise: spread the scores
    root = tempfile.mkdtemp(prefix="clsr_phase14_")
    try:
        path = os.path.join(root, "f32.pt")
        f32.save(path)
        want = f32.score(big) + f32.score(small)
        f32_ms = dispatch_ms(f32, big)
        f32_mb = table_mb(f32.model)
        del f32
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        svc = ScoringService(cfg, *sizes, *vocabs, checkpoint=path,
                             int8_tables=True)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        resident_mb = torch.cuda.memory_allocated() / 1e6
        torch.cuda.reset_peak_memory_stats()
        got, counts = [], []
        for reqs in (big, small):
            fused_eval_attention.launches = 0
            got += svc.score(reqs)
            torch.cuda.synchronize()
            counts.append(fused_eval_attention.launches)
        peak_mb = torch.cuda.max_memory_allocated() / 1e6
        int8_ms = dispatch_ms(svc, big)
        int8_mb = table_mb(svc.model)
        cpu = ScoringService(cfg, *sizes, *vocabs, checkpoint=path,
                             int8_tables=True, device="cpu")
        cpu_small = cpu.score(small)
        del cpu
    finally:
        shutil.rmtree(root, ignore_errors=True)
    d_f32 = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    d_cpu = max(float(np.abs(a - b).max())
                for a, b in zip(got[64:], cpu_small))
    finite = all(np.isfinite(s).all() and s.shape == (len(r.cand_items),)
                 for s, r in zip(got, big + small))
    log(f"phase 14 (e) int8 serving at Taobao sizes: tables {f32_mb:.1f} MB "
        f"f32, {int8_mb:.1f} MB int8 + scales | 64x100 dispatch median "
        f"{int8_ms:.3f} ms int8, {f32_ms:.3f} ms f32 | K1 launches a "
        f"dispatch {counts} | |int8 - f32| {d_f32:.3e} (tol {INT8_F32_TOL}), "
        f"|card - cpu| int8 on 8x10 {d_cpu:.3e} (tol {INT8_CPU_TOL}) | "
        f"device memory {resident_mb:.1f} MB after the build, peak "
        f"{peak_mb:.1f} MB over the two dispatches (service built in "
        f"{build_s:.2f} s) | {smi}")
    if not (finite and counts == [1, 1] and d_f32 <= INT8_F32_TOL
            and d_cpu <= INT8_CPU_TOL):
        raise AssertionError("phase 14 (e): int8 serving failed its gates")
    del svc
    torch.cuda.empty_cache()
    return dict(f32_table_mb=f32_mb, int8_table_mb=int8_mb,
                f32_dispatch_ms=f32_ms, int8_dispatch_ms=int8_ms,
                resident_mb=resident_mb, peak_mb=peak_mb,
                k1_per_dispatch=counts, d_f32=d_f32, build_s=build_s,
                d_cpu=d_cpu, launches={"eval_scorer": sum(counts)})


def mixed_precision(smi):
    """Phase 14 (a), (b) and (e), on phase 5/8's Taobao-sized tables;
    (c) and (d) run inside phase 11 (`mixed_on_p11_data`)."""
    t14, marks = time.perf_counter(), {}

    def mark(label):
        marks[label] = time.perf_counter() - t14
        log(f"[phase 14: {label} done at {marks[label]:.1f} s]")

    rows = check_row_update_bf16(smi)
    mark("(a) K5 on bf16 rows")
    trained = train_bf16(smi)
    mark("(b) bf16 train steps")
    served = serve_int8(smi)
    mark("(e) int8 serving")
    return dict(row_update=rows, train=trained, serve=served, marks_s=marks)


def mixed_on_p11_data(cfg_b, sizes, loaders, f32_examples_per_s, smi):
    """Phase 14 (c) and (d), on phase 11's data: run B's configuration
    resident and graphed with bf16 tables and compute for one epoch
    (finite loss, valid auc > 0.5, K2 never launched, K1, K3a, K3b and
    K5 as in run B, examples/s beside run B's resident f32 epoch of
    phase 13, the trainer's note that K2 gives way) and its graphed
    steps against eager ones bit for bit; then each of the other
    optimizers with dense tables, P14_OPT_K graphed steps and a tail
    against eager ones bit for bit, finite losses, examples/s."""
    t, counts, lines = p13_fit(cfg_b, sizes, loaders, resident_data="on",
                               seed=3, **P14_BF16)
    steps = t.epoch_stats[0]["steps"]
    auc = t.eval_history[-1][1]["auc"]
    loss = t.epoch_stats[0]["mean_loss"]
    eps = examples_per_s(t)
    note = [line for line in lines if "not K2" in line]
    log(f"phase 14 (c) run B resident, graphed, bf16 tables and compute: "
        f"{steps} steps, {eps:,.1f} examples/s against "
        f"{f32_examples_per_s:,.1f} "
        f"in f32 (phase 13) | mean loss {loss:.5f}, valid auc {auc:.4f} | "
        f"launches {counts} | the trainer's note: {note} | {smi}")
    check_counts("phase 14 (c) bf16 epoch", counts, dict(
        row_scatter=steps, train_stats0=2 * steps, train_stats1=2 * steps,
        eval_scorer=2 * steps, clsr_scan=0, clsr_scan_backward=0,
        row_sweep=0))
    if not (np.isfinite(loss) and auc > 0.5 and note):
        raise AssertionError(f"phase 14 (c): loss {loss}, auc {auc}, note "
                             f"{note}")
    fit = dict(steps=steps, examples_per_s=eps,
               f32_examples_per_s=f32_examples_per_s, mean_loss=loss,
               valid_auc=auc, launches=counts, upload=t.upload)
    del t
    cfg16 = cfg_b.replace(**P14_BF16)
    fit["graph"] = graph_against_eager("phase 14 bf16", cfg16, sizes,
                                       loaders["train"], smi)
    rules = {}
    for name in P14_RULES:
        cfg = cfg_b.replace(optimizer=name, train_steps_per_call=P14_OPT_K)
        r = graph_against_eager(f"phase 14 {name}", cfg, sizes,
                                loaders["train"], smi, timed_call=True)
        if not np.isfinite(r["loss"]):
            raise AssertionError(f"phase 14 (d) {name}: loss {r['loss']}")
        log(f"phase 14 (d) [{name}]: {r['steps']} graphed steps equal the "
            f"eager ones bit for bit, loss {r['loss']:.5f}, "
            f"{r['examples_per_s']:,.1f} examples/s (a call of "
            f"{P14_OPT_K} replays) | {smi}")
        rules[name] = r
    opt_counts = {}
    for r in rules.values():
        for k, n in r["launches"]["graph"].items():
            opt_counts[k] = opt_counts.get(k, 0) + n
    return dict(fit=fit, rules=rules,
                launches={"p14_bf16_fit": counts,
                          "p14_optimizers": opt_counts})


# ------------------------------------------------------------- phase 15
# the model zoo at its yaml widths with phase 5's Taobao-sized tables:
# (name, yaml, overrides); the last row is CLSR's fused reference (timed
# beside the zoo in training only)
ZOO = (("gru4rec", "gru4rec", {}), ("a2svd", "asvd", {}),
       ("din", "din", {}), ("dien", "dien", {}), ("sli_rec", "sli_rec", {}),
       ("clsr_time4lstm", "clsr", dict(use_fused_encoders=False)),
       ("clsr_gru", "clsr", dict(sequential_model="gru")))
ZOO_REFERENCE = ("clsr_fused", "clsr", dict(use_pallas_scan=True))
ZOO_K = 32                     # graphed steps a call, as phase 12
P15_K = 4                      # phase 15's: its depth cut to keep the
                               # script in its time limit
P16_K = 8                      # phase 16's, likewise
ZOO_TOL = 1e-4                 # K1 on / off and card / CPU scores
# K1 launches a serving dispatch and, per train step with
# use_pallas_train_attention 'on', K3a = K3b = K1: the scorers of each
# model that the kernels take (relu, no weights returned)
ZOO_SCORERS = {"gru4rec": 0, "a2svd": 0, "din": 1, "dien": 0, "sli_rec": 1,
               "clsr_time4lstm": 2, "clsr_gru": 2, "clsr_fused": 2}
ZOO_SERVE_K1 = {"din", "sli_rec", "clsr_time4lstm", "clsr_gru"}
ZOO_FITS = (("DIN", 1), ("DIEN", 1))   # (c): the CLI on phase 11's data


def zoo_cfg(yaml, kw):
    from clsr_tpu_torch.config import CONFIG_DIR, load_config
    return load_config(os.path.join(CONFIG_DIR, f"{yaml}.yaml"),
                       user_vocab="u", item_vocab="i", cate_vocab="c",
                       seed=0, **kw)


def zoo_serve(name, cfg, big, small, vocabs, smi, phase="15"):
    """Phase 15 (a) (and 16 (a)) for one model: 64 x 100 and 8 x 10
    requests through ScoringService, the counts read around them; K1 on
    against off; the card against the CPU port on the 8 x 10; the
    dispatch latency."""
    from clsr_tpu_torch.serving import ScoringService
    from clsr_tpu_torch.training.kernel_check import counted
    sizes = (USERS, ITEMS, CATES)
    svc = ScoringService(cfg, *sizes, *vocabs)
    spread(svc.model, 5)
    state = svc.model.state_dict()
    svc.score(big[:2])                        # build and warm the kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scores, counts = counted(lambda: svc.score(big) + svc.score(small))
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    for s, r in zip(scores, big + small):
        if s.shape != (len(r.cand_items),) or not np.isfinite(s).all() \
                or s.min() < 0 or s.max() > 1:
            raise AssertionError(f"phase {phase} (a) {name}: scores not finite in [0, 1], "
                                 f"one per candidate")
    check_counts(f"phase {phase} (a) {name}, two dispatches", counts,
                 dict(eval_scorer=2 if name in ZOO_SERVE_K1 else 0,
                      clsr_scan=0))
    d_off = None
    if name in ("din", "sli_rec"):
        off = ScoringService(cfg.replace(use_pallas_eval_attention="off"),
                             *sizes, *vocabs)
        off.model.load_state_dict(state)
        d_off = max(float(np.abs(a - b).max()) for a, b in
                    zip(scores, off.score(big) + off.score(small)))
        del off
    cpu = ScoringService(cfg, *sizes, *vocabs, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in state.items()})
    d_cpu = max(float(np.abs(a - b).max()) for a, b in
                zip(scores[len(big):], cpu.score(small)))
    del cpu
    ms = dispatch_ms(svc, big)
    log(f"phase {phase} (a) [{name}]: launches {counts} | |K1 on - off| "
        f"{d_off if d_off is None else f'{d_off:.3e}'} (tol {ZOO_TOL}), "
        f"|cuda - cpu| on 8x10 {d_cpu:.3e} (tol {ZOO_TOL}) | 64x100 "
        f"dispatch median {ms:.3f} ms, {64 * 100 / ms * 1e3:,.0f} "
        f"candidates/s | peak {peak_mb:.1f} MB | {smi}")
    if not (d_cpu <= ZOO_TOL and (d_off is None or d_off <= ZOO_TOL)):
        raise AssertionError(f"phase {phase} (a) {name}: served scores "
                             f"disagree")
    del svc
    torch.cuda.empty_cache()
    return dict(launches=counts, k1_onoff_err=d_off, cpu_err=d_cpu,
                dispatch_ms=ms, cands_per_s=64 * 100 / ms * 1e3,
                peak_mb=peak_mb)


def zoo_train(name, cfg, batches, smi, phase="15", opts=("adam", "lazyadam"),
              model_kw=None, timed_steps=None, K=ZOO_K):
    """Phase 15 (b) (and 16 (b)) for one model: seeded weights; for DIN
    and SLI-Rec the kernel steps against the plain ones on the first
    batch (`kernel_check.compare_steps`, phase 8's gates); then each
    optimizer of `opts` (dense Adam, lazyadam) as graphed replays against
    eager steps; last, torch.profiler over one eager step of the last.
    `model_kw` goes to the model's constructor (LGN's graph);
    `timed_steps` cuts the timed call's replays; K graphed steps a
    call (batches holds K + 1)."""
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.training import kernel_check
    from clsr_tpu_torch.training.state import create_train_state
    from clsr_tpu_torch.training.steps import make_train_step
    cfg = cfg.replace(use_pallas_train_attention="on", batch_size=TRAIN_B,
                      train_steps_per_call=K)
    model_kw = model_kw or {}
    model = get_model_class(cfg.model_type)(cfg, USERS, ITEMS, CATES,
                                            **model_kw)
    spread(model, 6)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    out = {}
    n = ZOO_SCORERS.get(name, 0)
    if name in ("din", "sli_rec"):
        res = kernel_check.compare_steps(
            cfg.replace(optimizer="lazyadam"), weights,
            (USERS, ITEMS, CATES), batches[0],
            eval_batch_from(batches[0], 100, 64, 3))
        lc = res.pop("launches")
        log(f"phase 15 (b) [{name}] first batch, kernel steps against plain "
            f"(lazyadam compact; eval 64 x 100): scores max abs err "
            f"{res['score_err']:.3e} (tol 1e-4), loss parts max rel err "
            f"{res['loss_rel_err']:.3e} (tol 1e-4), gradients max err / max "
            f"abs {res['grad_rel_err']:.3e}, table row gradients "
            f"{res['table_grad_rel_err']:.3e} (tol 1e-4; zero-by-"
            f"construction biases max abs err {res['zero_grad_abs_err']:.3e}"
            f"), BN running stats {res['bn_err']:.3e} (tol 1e-5), K5 "
            f"bit-identical {res['k5_identical']} | launches {lc} | {smi}")
        check_counts(f"phase 15 (b) {name} kernel eval", lc["eval/kernel"],
                     dict(eval_scorer=1, clsr_scan=0))
        check_counts(f"phase 15 (b) {name} kernel step", lc["train/kernel"],
                     dict(train_stats0=n, train_stats1=n, eval_scorer=n,
                          clsr_scan=0, clsr_scan_backward=0, row_scatter=1))
        for side in ("eval/plain", "train/plain"):
            check_counts(f"phase 15 (b) {name} {side}", lc[side],
                         {k: 0 for k in lc[side]})
        bad = kernel_check.failures(res)
        if bad or res["k5_identical"] is not True:
            # the per-tensor numbers, as probe_kernel_gate.py prints them
            for line in res["bad_grads"]:
                log(f"  phase 15 (b) [{name}] past the gate: {line}")
            raise AssertionError(f"phase 15 (b) {name}: the kernel step "
                                 f"disagrees with the plain one: {bad}")
        out["first_batch"] = dict(res, launches=lc)
    k2 = 1 if name == "clsr_fused" else 0
    for opt in opts:
        if name == "clsr_fused" and opt == "adam":
            continue           # the reference: lazyadam, as phase 10
        res = graph_against_eager(f"phase {phase} (b) {name} {opt}",
                                  cfg.replace(optimizer=opt),
                                  (USERS, ITEMS, CATES), batches, smi,
                                  timed_call=True, weights=weights,
                                  model_kw=model_kw,
                                  timed_steps=timed_steps)
        torch.cuda.empty_cache()
        per_step = {k: v // (K + 1)
                    for k, v in res["launches"]["eager"].items()}
        check_counts(f"phase {phase} (b) {name} {opt} step", per_step,
                     dict(train_stats0=n, train_stats1=n, eval_scorer=n,
                          clsr_scan=k2, clsr_scan_backward=k2,
                          row_scatter=int(opt == "lazyadam")))
        if not np.isfinite(res["loss"]):
            raise AssertionError(f"phase {phase} (b) {name} {opt}: loss "
                                 f"{res['loss']}")
        log(f"phase {phase} (b) [{name}, {opt}]: launches a step {per_step} | "
            f"graphed step {res['step_ms']:.3f} ms (CUDA events over "
            f"{res['timed_steps']} replays), "
            f"{TRAIN_B / res['step_ms'] * 1e3:,.0f} "
            f"examples/s, peak {res['peak_mb']:.1f} MB | loss "
            f"{res['loss']:.5f} | {smi}")
        out[opt] = dict(res, per_step=per_step)
    # where the graphed step's device time goes: one eager step (of the
    # last optimizer) under torch.profiler (kernels a step, device busy
    # ms, top kernels)
    last = cfg.replace(optimizer=opts[-1])
    model = get_model_class(cfg.model_type)(last, USERS, ITEMS, CATES,
                                            **model_kw)
    model.load_state_dict(weights)
    out["profile"] = profile_steps(
        make_train_step(model, last), create_train_state(model, last),
        batches[1:2], f"phase {phase} {name} {opts[-1]} eager", smi)
    del model
    torch.cuda.empty_cache()
    return out


def model_zoo(smi):
    """Phase 15 (a) and (b): every zoo model served and trained."""
    rng = np.random.RandomState(15)
    big = make_requests(rng, 64, 100, USERS, ITEMS, CATES)
    small = make_requests(rng, 8, 10, USERS, ITEMS, CATES)
    vocabs = vocab_for(big + small)
    batches = train_batches(P15_K + 1, 15, USERS, ITEMS, CATES)
    served, trained = {}, {}
    launches = {"p15_zoo_serve": {}, "p15_zoo_train": {}}

    def add(path, counts):
        for k, v in counts.items():
            launches[path][k] = launches[path].get(k, 0) + v

    for name, yaml, kw in ZOO:
        t0 = time.perf_counter()
        served[name] = zoo_serve(name, zoo_cfg(yaml, kw), big, small,
                                 vocabs, smi)
        add("p15_zoo_serve", served[name]["launches"])
        served[name]["s"] = time.perf_counter() - t0
    for name, yaml, kw in ZOO + (ZOO_REFERENCE,):
        t0 = time.perf_counter()
        trained[name] = zoo_train(name, zoo_cfg(yaml, kw), batches, smi,
                                  K=P15_K)
        for opt in ("adam", "lazyadam"):
            if opt in trained[name]:
                add("p15_zoo_train",
                    trained[name][opt]["launches"]["graph"])
        trained[name]["s"] = time.perf_counter() - t0
    ref = trained["clsr_fused"]["lazyadam"]["step_ms"]
    for name, t in trained.items():
        log(f"phase 15 (b) graphed step ms at B = {TRAIN_B}: {name} adam "
            f"{t['adam']['step_ms'] if 'adam' in t else float('nan'):.3f}, "
            f"lazyadam {t['lazyadam']['step_ms']:.3f} "
            f"({t['lazyadam']['step_ms'] / ref:.2f}x CLSR fused lazyadam "
            f"{ref:.3f}) | {smi}")
    return dict(serve=served, train=trained, launches=launches)


def zoo_fits(root, smi, models=ZOO_FITS, phase="15"):
    """Phase 15 (c) (and 16 (c)), inside phase 11 on its data: the CLI
    for each (model, epochs) of `models`, as a user runs it; the first
    epoch's examples/s, the test eval s, the valid auc of the epoch the
    CLI restores (> 0.5), the counts read around each: K1 in DIN's evals
    only, no other kernel (the yaml files' optimizer is adam, so no
    K5)."""
    out = {}
    for model, epochs in models:
        argv = ["--dataset", "synthetic", "--model", model, "--epochs",
                str(epochs), "--seed", "7", "--data_path", root]
        text, wall, launches = run_cli(argv)
        nums = cli_numbers(text)
        epoch = nums["epochs"][0]
        best = int(BEST_RE.findall(text)[-1])
        auc = nums["valid"][best]["auc"]
        log(f"phase {phase} (c) [{model} through the CLI, {epochs} "
            f"epoch(s)]: epoch 1 {epoch['train_s']:.3f} s, "
            f"{epoch['steps']} steps, {epoch['examples_per_s']:,.1f} "
            f"examples/s, valid auc by epoch "
            f"{[nums['valid'][e]['auc'] for e in sorted(nums['valid'])]}, "
            f"restored epoch {best}: {auc} (> 0.5), test eval "
            f"{nums['test_eval_s'][0]:.3f} s, test "
            f"{nums['test']} | wall {wall:.3f} s | launches {launches} | "
            f"{smi}")
        want_k1 = model == "DIN"
        others = {k: n for k, n in launches.items() if k != "eval_scorer"}
        if not (auc > 0.5 and (launches["eval_scorer"] > 0) == want_k1
                and not any(others.values())):
            raise AssertionError(f"phase {phase} (c) {model}: auc {auc}, "
                                 f"launches {launches}")
        out[model] = dict(nums, wall_s=wall, launches=launches,
                          best_epoch=best)
    return out


# ------------------------------------------------------------- phase 16
# the rest of the zoo at its yaml widths with phase 5's Taobao-sized
# tables (NextItNet trains per position, the yaml default); LGN with
# dense Adam on a graph of every user's seeded history
ZOO_REST = (("caser", "caser", {}), ("ncf", "ncf", {}),
            ("nextitnet", "nextitnet", {}))
# (c): the CLI on phase 11's data, epochs a model: per-position
# NextItNet scores at chance for its first two epochs there, in JAX too
# (its unmasked padded positions teach the padding id first; PERF.md
# §6), so it runs three
ZOO_REST_FITS = (("NEXTITNET", 3), ("LGN", 1))
CARD_MB = 80e3                         # the H100's device memory, MB
LGN_TIMED_STEPS = 4                    # LGN's timed replays (~0.3 s each)


def lgn_graph(seed):
    """LGN's interaction graph at the Taobao node count: every real user
    (ids 1..USERS - 1) a seeded history of 1..TRAIN_L items and a target,
    each item's cate 1 + item % (CATES - 1); (graph, host build s)."""
    from clsr_tpu_torch.data.graph import build_graph_from_arrays
    rng = np.random.RandomState(seed)
    users = np.arange(1, USERS, dtype=np.int64)
    lens = rng.randint(1, TRAIN_L + 1, len(users)) + 1
    offsets = np.concatenate([[0], np.cumsum(lens)])
    items = rng.randint(1, ITEMS, offsets[-1]).astype(np.int64)
    cates = 1 + items % (CATES - 1)
    t0 = time.perf_counter()
    graph = build_graph_from_arrays(users, offsets, items, cates, USERS,
                                    ITEMS)
    return graph, time.perf_counter() - t0


def zoo_rest(smi, ref_step_ms):
    """Phase 16 (a) and (b): Caser, NCF and NextItNet served and trained
    as phase 15 serves and trains the zoo, and LGN trained with dense
    Adam on its Taobao-sized graph; each graphed step beside CLSR's fused
    lazyadam step of phase 15 (`ref_step_ms`, the same run)."""
    rng = np.random.RandomState(16)
    big = make_requests(rng, 64, 100, USERS, ITEMS, CATES)
    small = make_requests(rng, 8, 10, USERS, ITEMS, CATES)
    vocabs = vocab_for(big + small)
    batches = train_batches(P16_K + 1, 16, USERS, ITEMS, CATES)
    served, trained = {}, {}
    launches = {"p16_zoo_serve": {}, "p16_zoo_train": {}}

    def add(path, counts):
        for k, v in counts.items():
            launches[path][k] = launches[path].get(k, 0) + v

    for name, yaml, kw in ZOO_REST:
        t0 = time.perf_counter()
        served[name] = zoo_serve(name, zoo_cfg(yaml, kw), big, small,
                                 vocabs, smi, phase="16")
        add("p16_zoo_serve", served[name]["launches"])
        served[name]["s"] = time.perf_counter() - t0
    for name, yaml, kw in ZOO_REST:
        t0 = time.perf_counter()
        trained[name] = zoo_train(name, zoo_cfg(yaml, kw), batches, smi,
                                  phase="16", K=P16_K)
        for opt in ("adam", "lazyadam"):
            add("p16_zoo_train", trained[name][opt]["launches"]["graph"])
        trained[name]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph, build_s = lgn_graph(16)
    n_edges = len(graph.src)
    log(f"phase 16 (b) [lgn]: graph of {USERS - 1:,} users' histories "
        f"(1..{TRAIN_L} items + a target): E = {n_edges:,} edges over "
        f"{graph.n_nodes:,} nodes, host build {build_s:.3f} s")
    lgn = zoo_train("lgn", zoo_cfg("lgn", {}), batches, smi, phase="16",
                    opts=("adam",), model_kw={"graph": graph},
                    timed_steps=LGN_TIMED_STEPS, K=P16_K)
    del graph
    add("p16_zoo_train", lgn["adam"]["launches"]["graph"])
    lgn.update(edges=n_edges, graph_build_s=build_s,
               s=time.perf_counter() - t0)
    trained["lgn"] = lgn
    log(f"phase 16 (b) [lgn, adam]: E = {n_edges:,}, host build "
        f"{build_s:.3f} s, graphed step {lgn['adam']['step_ms']:.3f} ms, "
        f"peak {lgn['adam']['peak_mb']:,.1f} MB of the card's "
        f"{CARD_MB:,.0f} | {smi}")
    for name, t in trained.items():
        lazy = (f"{t['lazyadam']['step_ms']:.3f} "
                f"({t['lazyadam']['step_ms'] / ref_step_ms:.2f}x)"
                if "lazyadam" in t else "refused (LGN)")
        log(f"phase 16 (b) graphed step ms at B = {TRAIN_B}: {name} adam "
            f"{t['adam']['step_ms']:.3f} "
            f"({t['adam']['step_ms'] / ref_step_ms:.2f}x), lazyadam {lazy}; "
            f"CLSR fused lazyadam {ref_step_ms:.3f} | {smi}")
    return dict(serve=served, train=trained, launches=launches,
                ref_step_ms=ref_step_ms)


# ------------------------------------------------------------- phase 17
# long-context blockwise attention, kill and resume, histograms and events
P17_L = 1_000                  # long histories, lengths 1..1,000
P17_LONG_L = 4_000             # the reference's longest bench length at
                               # B = 512 (scripts/bench_long_context.py:49)
P17_BLOCK = 256
P17_K = 16                     # graphed steps a call, against as many eager
P17_ATT_REL = 1e-5             # blocked / unblocked output, of its max abs
P17_AUTOSAVE, P17_KILL = 1, 2  # (b): autosave every call, killed after
                               # call 2 of run B's 23 (step 64 of 147):
                               # the resumed fit starts with graphed
                               # calls and writes histograms at 96, 128
P17_HIST_EDGE = 1e-3           # (c): bucket units about an edge where the
                               # card's and the CPU's rounding may part


def p17_cfg(**kw):
    """clsr.yaml's widths, BN off, blockwise attention, L = 1,000, K2 and
    the train scorer gates on (K1 and K3 must not run), lazyadam."""
    return zoo_cfg("clsr", {}).replace(**{**dict(
        enable_bn=False, attention_block_size=P17_BLOCK,
        max_seq_length=P17_L, use_pallas_scan=True,
        use_pallas_train_attention="on", optimizer="lazyadam",
        batch_size=TRAIN_B, train_steps_per_call=P17_K), **kw})


def rel_err(got, want):
    """max |got - want| / max |want|."""
    return ((got - want).abs().max() / want.abs().max()).item()


def p17_attention(smi):
    """Phase 17 (a): the blocked attention against the port's unblocked
    TargetAttention (BN off, the same parameters) at the short-term
    scorer's shape, B = 400, G = 5, L = 1,000 with lengths 1..1,000 (no
    row fully masked): the output within P17_ATT_REL and every gradient
    (query, keys, each parameter; the output bias's, zero up to
    rounding, of its layer's weight gradient) within GRAD_REL of its
    max abs; no
    kernel launched; forward + backward ms of each."""
    from clsr_tpu_torch.ops.attention import TargetAttention
    from clsr_tpu_torch.ops.initializers import get_initializer
    from clsr_tpu_torch.ops.long_context import LongTargetAttention
    from clsr_tpu_torch.training.kernel_check import counted
    dev = torch.device("cuda")
    B, G, L = TRAIN_B, 5, P17_L
    g = torch.Generator(device=dev).manual_seed(170)
    init = get_initializer("tnormal", 0.3)
    full = TargetAttention(H0, DK, (H0, H1), ("relu", "relu"), init, g,
                           dev, use_kernel="off", use_train_kernel="off")
    long = LongTargetAttention(H0, DK, (H0, H1), init, g, dev,
                               block_size=P17_BLOCK)
    fcn = full.att_fcn
    full_params = lambda: [full.attention_mat, fcn.w_nn_layer0.kernel,
                           fcn.w_nn_layer0.bias, fcn.w_nn_layer1.weight,
                           fcn.w_nn_layer1.bias, fcn.w_nn_output.weight,
                           fcn.w_nn_output.bias]
    flax_layout = (False, False, False, True, False, True, False)
    with torch.no_grad():
        for dst, src, t in zip([long.attention_mat] + [
                x for kb in long.layers() for x in kb], full_params(),
                flax_layout):
            dst.copy_(src.t() if t else src)
    r = lambda *shape: torch.randn(*shape, generator=g, device=dev) * 0.5
    query, keys, cot = r(B, G, H0), r(B, L, DK), r(B, G, DK)
    lengths = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).float()

    def run(mod, params, layout):
        q = query.clone().requires_grad_()
        k = keys.clone().requires_grad_()
        for p in mod.parameters():
            p.grad = None
        out = mod(q, k, mask)
        (out * cot).sum().backward()
        return out.detach(), [q.grad, k.grad] + [
            p.grad.t() if t else p.grad for p, t in zip(params(), layout)]

    long_params = lambda: [long.attention_mat] + [
        x for kb in long.layers() for x in kb]
    long_layout = (False,) * len(flax_layout)
    (want, want_g), c_full = counted(lambda: run(full, full_params,
                                                 flax_layout))
    (got, got_g), c_long = counted(lambda: run(long, long_params,
                                               long_layout))
    out_err = rel_err(got, want)
    # the output bias's gradient is zero up to rounding (the softmax
    # over L does not see a shift): held to GRAD_REL of its layer's
    # weight gradient, as training/kernel_check.py holds such biases
    grad_err = max(rel_err(a, b) for a, b in zip(got_g[:-1], want_g[:-1]))
    zero_err = ((got_g[-1] - want_g[-1]).abs().max()
                / want_g[-2].abs().max()).item()
    grad_err = max(grad_err, zero_err)
    ms = {name: cuda_ms(lambda a=a: run(*a), iters=3, warmup=1)
          for name, a in (("blocked", (long, long_params, long_layout)),
                          ("unblocked", (full, full_params, flax_layout)))}
    log(f"phase 17 (a) attention [B={B} G={G} L={L} Dq={H0} Dk={DK}, "
        f"block {P17_BLOCK}, lengths 1..{L}]: blocked against unblocked "
        f"output max err / max abs {out_err:.3e} (tol {P17_ATT_REL}), "
        f"gradients {grad_err:.3e} (tol {GRAD_REL}) | forward + backward "
        f"{ms['blocked']:.3f} ms blocked, {ms['unblocked']:.3f} ms "
        f"unblocked | launches {c_long} / {c_full} | {smi}")
    if not (out_err <= P17_ATT_REL and grad_err <= GRAD_REL
            and not any(c_long.values()) and not any(c_full.values())):
        raise AssertionError("phase 17 (a): the blocked attention "
                             "disagrees with the unblocked one")
    return dict(out_err=out_err, grad_err=grad_err, ms=ms)


def p17_k2(smi):
    """Phase 17 (a): K2's forward (with the carries) and backward at
    (B, L) = (400, 1,000) against their plain versions, each plain
    version run once: the forward's outputs and carries within K2_TOL
    abs, each backward gradient within GRAD_REL of its max abs; the
    kernels on the device by CUDA graph replay, the plain ms, the byte
    bounds."""
    from clsr_tpu_torch.ops import fused_scan as fs
    dev = torch.device("cuda")
    B, L, U, H = TRAIN_B, P17_L, 40, 40
    args = k2_inputs(B, L, 171)
    g = torch.Generator(device=dev).manual_seed(172)
    cots = tuple(torch.randn(*shape, generator=g, device=dev)
                 for shape in ((B, U), (B, L, H), (B, H)))

    def once(fn):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    want, plain_fwd_ms = once(lambda: fs.scan_forward_reference(*args))
    got = fs._forward(*args, keep_carries=True)
    fwd_err = max((x - y).abs().max().item() for x, y in zip(got, want))
    carries = got[-1]
    del want
    fwd_ms = graph_ms(lambda: fs._forward(*args, keep_carries=True), 3)
    plain, plain_bwd_ms = once(lambda: fs.scan_backward_reference(
        args, carries, *cots))
    bwd = fs.scan_backward(args, carries, *cots)
    idx = [i for i in range(15) if i != 8]
    bwd_err = max(rel_err(bwd[i], plain[i]) for i in idx)
    del plain, bwd
    kernel_ms = graph_ms(lambda: fs._backward_kernel(args, carries, *cots), 3)
    whole_ms = graph_ms(lambda: fs.scan_backward(args, carries, *cots), 3)
    n_in = sum(a.numel() for a in args)
    fwd_bound, _ = bound(4 * (n_in + B * L * H + B * U + B * H
                              + carries.numel()), 0)
    n_read = n_in - B * U + carries.numel() + sum(c.numel() for c in cots)
    n_grads = sum(a.numel() for a in args[:8]) + B * U
    n_weights = sum(a.numel() for a in args[10:])
    whole_bound, _ = bound(4 * (n_read + n_grads + n_weights), 0)
    log(f"phase 17 (a) K2 [B={B} L={L} U=H={U}]: forward with carries max "
        f"abs err {fwd_err:.3e} (tol {K2_TOL}), {fwd_ms:.4f} ms on the "
        f"device ({fwd_ms * 1e3 / L:.3f} us per dependent step), plain "
        f"{plain_fwd_ms:.3f} ms, byte bound {fwd_bound:.5f} ms | backward "
        f"gradients max err / max abs {bwd_err:.3e} against the plain "
        f"backward (tol {GRAD_REL}), kernel {kernel_ms:.4f} ms, whole "
        f"{whole_ms:.4f} ms on the device, plain {plain_bwd_ms:.3f} ms, "
        f"byte bound {whole_bound:.5f} ms | {smi}")
    if not (fwd_err <= K2_TOL and bwd_err <= GRAD_REL):
        raise AssertionError("phase 17 (a): K2 at L = 1,000 disagrees "
                             "with its plain version")
    return dict(fwd_err=fwd_err, fwd_device_ms=fwd_ms,
                plain_fwd_ms=plain_fwd_ms, fwd_bound_ms=fwd_bound,
                bwd_rel_err=bwd_err, bwd_kernel_device_ms=kernel_ms,
                bwd_whole_device_ms=whole_ms, plain_bwd_ms=plain_bwd_ms,
                bwd_bound_ms=whole_bound, B=B, L=L)


def p17_serve(cfg, weights, smi):
    """Phase 17 (a): 64 x 100 and 8 x 10 requests with histories of
    1..1,000 through ScoringService: scores finite in [0, 1], one per
    candidate, K2 once a dispatch, K1 never; the card against the CPU
    port on the 8 x 10 (SERVE_TOL); the median 64 x 100 dispatch."""
    from clsr_tpu_torch.serving import ScoringService
    from clsr_tpu_torch.training.kernel_check import counted
    rng = np.random.RandomState(17)
    big = make_requests(rng, 64, 100, USERS, ITEMS, CATES, max_hist=P17_L)
    small = make_requests(rng, 8, 10, USERS, ITEMS, CATES, max_hist=P17_L)
    vocabs = vocab_for(big + small)
    svc = ScoringService(cfg, USERS, ITEMS, CATES, *vocabs)
    svc.model.load_state_dict(weights)
    svc.score(big[:2])
    scores, counts = counted(lambda: svc.score(big) + svc.score(small))
    for sc, req in zip(scores, big + small):
        if sc.shape != (len(req.cand_items),) or not np.isfinite(sc).all() \
                or sc.min() < 0 or sc.max() > 1:
            raise AssertionError("phase 17 (a) serving: scores not finite "
                                 "in [0, 1], one per candidate")
    check_counts("phase 17 (a) serving, two dispatches", counts,
                 dict(clsr_scan=2, eval_scorer=0))
    cpu = ScoringService(cfg, USERS, ITEMS, CATES, *vocabs, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in weights.items()})
    cpu_err = max(float(np.abs(a - b).max()) for a, b in
                  zip(scores[len(big):], cpu.score(small)))
    del cpu
    ms = dispatch_ms(svc, big)
    log(f"phase 17 (a) serving at L = {P17_L}: launches {counts} | |cuda - "
        f"cpu| on 8x10 {cpu_err:.3e} (tol {SERVE_TOL}) | 64x100 dispatch "
        f"median {ms:.3f} ms, {64 * 100 / ms * 1e3:,.0f} candidates/s | "
        f"{smi}")
    if not cpu_err <= SERVE_TOL:
        raise AssertionError("phase 17 (a) serving: the card and the CPU "
                             "disagree")
    del svc
    torch.cuda.empty_cache()
    return dict(launches=counts, cpu_err=cpu_err, dispatch_ms=ms,
                cands_per_s=64 * 100 / ms * 1e3)


def p17_memory(smi):
    """Phase 17 (a): one eager lazyadam step (after a warm-up step) with
    the attention blocked and unblocked at L = 1,000 and 4,000: the
    step's peak device memory, above what the state keeps, and its ms
    (CUDA events)."""
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.training.state import create_train_state
    from clsr_tpu_torch.training.steps import make_train_step
    out = {}
    for L in (P17_L, P17_LONG_L):
        batches = train_batches(2, 18, USERS, ITEMS, CATES, L=L)
        for block in (P17_BLOCK, 0):
            cfg = p17_cfg(attention_block_size=block, max_seq_length=L)
            model = get_model_class("clsr")(cfg, USERS, ITEMS, CATES)
            spread(model, 18)
            state = create_train_state(model, cfg)
            step = make_train_step(model, cfg)
            gen = torch.Generator(device="cuda").manual_seed(3)
            step(state, batches[0], gen)
            torch.cuda.synchronize()
            kept = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            _, parts = step(state, batches[1], gen)
            end.record()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            key = f"L{L}/{'blocked' if block else 'unblocked'}"
            out[key] = dict(peak_mb=peak / 1e6,
                            step_mb=(peak - kept) / 1e6,
                            step_ms=start.elapsed_time(end),
                            loss=float(parts.loss))
            if not np.isfinite(out[key]["loss"]):
                raise AssertionError(f"phase 17 (a) {key}: loss "
                                     f"{out[key]['loss']}")
            del model, state, step, parts
            torch.cuda.empty_cache()
        del batches
    log("phase 17 (a) an eager lazyadam step, peak device memory (above "
        "the kept state) and ms: " + ", ".join(
            f"{k} {v['peak_mb']:,.0f} MB ({v['step_mb']:,.0f}) "
            f"{v['step_ms']:.1f} ms" for k, v in out.items()) + f" | {smi}")
    return out


def long_context(smi):
    """Phase 17 (a): blockwise long-context attention at full width."""
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.training.state import create_train_state
    from clsr_tpu_torch.training.steps import make_train_step
    att = p17_attention(smi)
    torch.cuda.empty_cache()
    k2 = p17_k2(smi)
    torch.cuda.empty_cache()
    cfg = p17_cfg()
    model = get_model_class("clsr")(cfg, USERS, ITEMS, CATES)
    spread(model, 17)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    batches = train_batches(P17_K + 1, 17, USERS, ITEMS, CATES, L=P17_L)
    res = graph_against_eager("phase 17 (a) long context", cfg,
                              (USERS, ITEMS, CATES), batches, smi,
                              timed_call=True, weights=weights)
    del batches
    torch.cuda.empty_cache()
    per_step = {k: v // (P17_K + 1)
                for k, v in res["launches"]["eager"].items()}
    check_counts("phase 17 (a) long-context step", per_step, dict(
        clsr_scan=1, clsr_scan_backward=1, row_scatter=1, eval_scorer=0,
        train_stats0=0, train_stats1=0))
    if not np.isfinite(res["loss"]):
        raise AssertionError(f"phase 17 (a): loss {res['loss']}")
    log(f"phase 17 (a) graphed lazyadam step at B = {TRAIN_B}, L = "
        f"{P17_L}: {res['step_ms']:.3f} ms (CUDA events over "
        f"{res['timed_steps']} replays), {TRAIN_B / res['step_ms'] * 1e3:,.0f}"
        f" examples/s, peak {res['peak_mb']:.1f} MB | launches a step "
        f"{per_step} | {smi}")
    # where the step's device time goes: one eager step under
    # torch.profiler (kernels a step, busy ms, the top kernels)
    model = get_model_class("clsr")(cfg, USERS, ITEMS, CATES)
    model.load_state_dict(weights)
    profile = profile_steps(
        make_train_step(model, cfg), create_train_state(model, cfg),
        train_batches(1, 19, USERS, ITEMS, CATES, L=P17_L),
        "phase 17 long context lazyadam eager", smi)
    del model
    torch.cuda.empty_cache()
    served = p17_serve(cfg, weights, smi)
    del weights
    memory = p17_memory(smi)
    return dict(attention=att, k2=k2, train=dict(res, per_step=per_step),
                serve=served, memory=memory, profile=profile,
                launches={"p17_long_train": res["launches"]["graph"],
                          "p17_long_serve": served["launches"]})


class Killed(Exception):
    """Phase 17 (b)'s kill, raised right after an autosave."""


def p17_histograms(resumed, cfg, sizes, smi):
    """Phase 17 (c): the histogram step on the resumed weights and its
    probe batch, on the card and on the CPU: the tables' counts equal;
    each activation's counts equal when both sides bucket the card's
    values; from each side's own forward, lo and hi within 1e-4 abs and
    no more values in another bucket than lie within P17_HIST_EDGE of a
    bucket edge."""
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.training.steps import (HISTOGRAM_AUX_TAGS,
                                               device_histogram,
                                               make_histogram_step)
    nbins = 64
    probe = resumed._hist_probe
    on_card = resumed._hist_step(resumed.state.model, probe)
    cpu_model = get_model_class("clsr")(cfg, *sizes, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               resumed.state.model.state_dict().items()})
    on_cpu = make_histogram_step(nbins)(cpu_model, probe.to("cpu"))

    def activations(model, batch):
        model.eval()
        with torch.inference_mode():
            logits, aux = model(batch)
        return dict({"logit": logits}, **{tag: aux[key] for key, tag in
                                         HISTOGRAM_AUX_TAGS if key in aux})

    card_x = activations(resumed.state.model, probe)
    cpu_x = activations(cpu_model, probe.to("cpu"))
    out, bad = {}, []
    for tag, (counts, lo, hi, nonfinite) in on_card.items():
        c_counts, c_lo, c_hi, c_nonfinite = on_cpu[tag]
        counts, lo, hi = counts.cpu(), float(lo), float(hi)
        moved = int((counts - c_counts).abs().sum()) // 2
        rec = dict(moved=moved, lo=lo, hi=hi, cpu_lo=float(c_lo),
                   cpu_hi=float(c_hi), n=int(counts.sum()))
        if tag in card_x:
            same = [t.cpu() for t in device_histogram(card_x[tag], nbins)]
            rebucket = [t for t in device_histogram(card_x[tag].cpu(),
                                                    nbins)]
            rec["same_values_equal"] = all(torch.equal(a, b) for a, b in
                                           zip(same, rebucket))
            x = cpu_x[tag].float().reshape(-1)
            pos = (x - c_lo) / max(float(c_hi - c_lo), 1e-12) * nbins
            dist = (pos - pos.round()).abs()
            interior = (pos.round() > 0) & (pos.round() < nbins)
            rec["near_edge"] = int(((dist < P17_HIST_EDGE) & interior).sum())
            ok = (rec["same_values_equal"] and moved <= rec["near_edge"]
                  and abs(lo - float(c_lo)) <= 1e-4
                  and abs(hi - float(c_hi)) <= 1e-4)
        else:                  # the tables' rows: the same values
            ok = (torch.equal(counts, c_counts) and lo == float(c_lo)
                  and hi == float(c_hi))
        if not ok or int(nonfinite) != int(c_nonfinite):
            bad.append(tag)
        out[tag] = rec
    log(f"phase 17 (c) histograms, card against CPU on the resumed weights "
        f"and the probe batch ({probe.users.shape[0]} rows): tags "
        f"{sorted(out)} | activations: values in another bucket "
        + ", ".join(f"{t} {r['moved']} (<= {r['near_edge']} within "
                    f"{P17_HIST_EDGE} of an edge)"
                    for t, r in out.items() if "near_edge" in r)
        + "; the card's values bucketed on both sides equal: "
        + str(all(r.get("same_values_equal", True) for r in out.values()))
        + f" | tables' counts equal: "
        + str(all(t not in bad for t in out if t.endswith("_output")))
        + f" | {smi}")
    if bad:
        raise AssertionError(f"phase 17 (c): card and CPU histograms "
                             f"disagree: {bad}")
    return out


def p17_events(summary_dir, kill_step, smi):
    """Phase 17 (c): the event files of the killed and the resumed fit,
    read back by the port's reader (CRCs checked): the resumed fit's
    loss scalars and its histograms at each show_step after the kill,
    each a [64, 3] tensor whose counts sum to the probe's values."""
    import glob
    from clsr_tpu_torch.utils import summaries
    files = sorted(glob.glob(os.path.join(summary_dir,
                                          "events.out.tfevents.*")))
    read = [summaries.read_events(f) for f in files]
    hist_steps, scalar_tags, n_hist = set(), set(), 0
    for events in read:
        if events[0].get("file_version") != "brain.Event:2":
            raise AssertionError("phase 17 (c): an event file without its "
                                 "version record")
        for e in events[1:]:
            for v in e["values"]:
                if v["plugin"] == "histograms":
                    t = v["tensor"]
                    if t.shape != (64, 3) or not np.isfinite(t).all():
                        raise AssertionError(f"phase 17 (c): histogram "
                                             f"{v['tag']} {t.shape}")
                    hist_steps.add(e["step"])
                    n_hist += 1
                else:
                    scalar_tags.add(v["tag"])
    after = {s for s in hist_steps if s > kill_step}
    log(f"phase 17 (c) event files: {len(files)} (killed and resumed "
        f"fit), {sum(len(r) for r in read)} records read back, "
        f"{n_hist} histograms at steps {sorted(hist_steps)}, scalar tags "
        f"{sorted(scalar_tags)} | {smi}")
    if not (len(files) == 2 and after and "loss" in scalar_tags
            and "valid/wauc" in scalar_tags):
        raise AssertionError("phase 17 (c): the event files lack the "
                             "fit's summaries")
    return dict(files=len(files), records=sum(len(r) for r in read),
                histograms=n_hist, steps=sorted(hist_steps))


def resume_and_histograms(cfg_b, sizes, loaders, trainer_b, res_b, root,
                          smi):
    """Phase 17 (b) and (c), inside phase 11 after run B's epoch and test
    eval, on its data: run B's configuration (streamed, K = 32 graphed,
    every kernel) with an autosave every P17_AUTOSAVE calls is killed
    right after call P17_KILL; a fresh trainer resumes from the
    autosave: every model and optimizer tensor, the valid and the test
    metrics bit-identical to run B's.  Both fits write histograms and
    TensorBoard events at show_step 32, which changes no number."""
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.training.evaluator import run_weighted_eval
    from clsr_tpu_torch.training.kernel_check import counted
    from clsr_tpu_torch.training.trainer import Trainer
    cfg = cfg_b.replace(autosave_every_calls=P17_AUTOSAVE, show_step=32,
                        model_dir=os.path.join(root, "model_17b"),
                        summaries_dir=os.path.join(root, "summary_17b"),
                        write_histograms=True, write_tfevents=True)
    killed = Trainer(get_model_class("clsr")(cfg, *sizes), cfg,
                     log=lambda *_: None)
    save, seen = killed._autosave_stream, []

    def kill(*args, **kw):
        save(*args, **kw)
        seen.append(args[1])
        if args[1] == P17_KILL:
            raise Killed

    killed._autosave_stream = kill
    t0 = time.perf_counter()
    try:
        killed.fit(loaders["train"], loaders["valid"])
        raise AssertionError("phase 17 (b): the fit ran to its end")
    except Killed:
        killed_s = time.perf_counter() - t0
    kill_step = killed.state.step
    killed.summary.close()
    del killed
    torch.cuda.empty_cache()
    lines = []
    resumed = Trainer(get_model_class("clsr")(cfg, *sizes), cfg,
                      log=lines.append)
    t0 = time.perf_counter()
    _, counts = counted(lambda: resumed.fit(loaders["train"],
                                            loaders["valid"], resume=True))
    resumed_s = time.perf_counter() - t0
    resumed.summary.close()
    bad = differing(state_tensors(trainer_b.state),
                    state_tensors(resumed.state))
    res = run_weighted_eval(resumed.eval_step, resumed.state.model,
                            loaders["test"], cfg, cfg.test_num_ngs)
    same_valid = resumed.eval_history == trainer_b.eval_history
    at = [line for line in lines if line.startswith("resuming at")]
    steps = resumed.epoch_stats[0]["steps"]
    check_counts("phase 17 (b) resumed fit", counts,
                 dict(row_scatter=steps, clsr_scan_backward=steps))
    log(f"phase 17 (b) kill and resume (run B's config, autosave every "
        f"{P17_AUTOSAVE} calls, killed after call {P17_KILL} = step "
        f"{kill_step}, autosaves {seen}): killed fit {killed_s:.3f} s, "
        f"resumed fit {resumed_s:.3f} s ({steps} steps, {at}) | against "
        f"run B: {len(state_tensors(trainer_b.state))} state tensors, "
        f"differ {bad[:5]}, valid metrics equal {same_valid}, test metrics "
        f"equal {res == res_b} | launches {counts} | {smi}")
    if (bad or not same_valid or res != res_b
            or seen != list(range(P17_AUTOSAVE, P17_KILL + 1,
                                  P17_AUTOSAVE))
            or not at or f"call {P17_KILL} " not in at[0]):
        raise AssertionError("phase 17 (b): the resumed fit is not run B's")
    hists = p17_histograms(resumed, cfg, sizes, smi)
    events = p17_events(cfg.summaries_dir, kill_step, smi)
    del resumed
    torch.cuda.empty_cache()
    return dict(killed_s=killed_s, resumed_s=resumed_s, kill_step=kill_step,
                resumed_steps=steps, launches=counts, histograms=hists,
                events=events)


def train_and_evaluate(smi):
    """Phase 11: the synthetic set through the CLI (run A), through
    Trainer.fit with every kernel gate on (run B), and the gates."""
    from clsr_tpu_torch import cli
    from clsr_tpu_torch.data.loader import SequenceLoader
    from clsr_tpu_torch.data.parser import parse_file
    from clsr_tpu_torch.data.prefetch import to_device
    from clsr_tpu_torch.data.synthetic import write_synthetic_dataset
    from clsr_tpu_torch.data.vocab import load_vocab
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.serving import ScoreRequest, ScoringService
    from clsr_tpu_torch.training import checkpoint, kernel_check
    from clsr_tpu_torch.training.evaluator import run_weighted_eval
    from clsr_tpu_torch.training.kernel_check import counted
    from clsr_tpu_torch.training.steps import make_eval_step_fn
    from clsr_tpu_torch.training.trainer import Trainer

    root = tempfile.mkdtemp(prefix="clsr_phase11_")
    t11, marks = time.perf_counter(), {}

    def mark(label):
        marks[label] = time.perf_counter() - t11
        log(f"[phase 11: {label} done at {marks[label]:.1f} s]")

    try:
        data_dir = os.path.join(root, "synthetic")
        t0 = time.perf_counter()
        paths = write_synthetic_dataset(data_dir, valid_num_ngs=4,
                                        test_num_ngs=99, **P11_DATA)
        os.replace(paths.pop("cate_vocab"),
                   os.path.join(data_dir, "category_vocab.pkl"))
        write_s = time.perf_counter() - t0
        vocabs = [load_vocab(os.path.join(data_dir, f"{n}_vocab.pkl"))
                  for n in ("user", "item", "category")]
        sizes = tuple(map(len, vocabs))
        log(f"phase 11: synthetic set {P11_DATA} written in {write_s:.3f} s")
        full_test = parse_file(paths["test"], *vocabs)
        keep_groups(paths["test"], P11_TEST_GROUPS, 100)
        parsed, parse = parse_both(paths, vocabs)

        # ---- run A: the CLI as a user runs it ---------------------------
        argv = P11_ARGV + ["--data_path", root]
        text, wall, launches_a = run_cli(argv + ["--write_prediction_to_file"])
        a = cli_numbers(text)
        last = max(a["valid"])
        with open(paths["test"]) as f:
            n_test = sum(1 for _ in f)
        scores = np.loadtxt(os.path.join(root, "output.txt"))
        for e in a["epochs"]:
            log(f"run A epoch {e['epoch']}: {e['train_s']:.3f} s, "
                f"{e['steps']} steps, {e['examples_per_s']:,.1f} examples/s, "
                f"valid eval {e['valid_eval_s']:.3f} s | {smi}")
        log(f"run A: wall {wall:.3f} s, test eval {a['test_eval_s'][0]:.3f} "
            f"s, test {a['test']} | launches {launches_a} | output.txt "
            f"{scores.shape[0]:,} scores for {n_test:,} test lines")
        if not (a["valid"][last]["auc"] > 0.5 and scores.shape == (n_test,)
                and np.isfinite(scores).all()
                and len(a["epochs"]) == 2 and launches_a["eval_scorer"] > 0):
            raise AssertionError(f"run A failed its gates: valid "
                                 f"{a['valid']}, {scores.shape[0]} scores")
        mark("run A")
        text, wall_t, launches_t = run_cli(argv + ["--only_test"])
        only = cli_numbers(text)["test"]
        same = {k: only.get(k) for k in a["test"]} == a["test"]
        log(f"run A --only_test: wall {wall_t:.3f} s, the same test dict: "
            f"{same} (+ mean_alpha {only.get('mean_alpha')}) | launches "
            f"{launches_t}")
        if not same:
            raise AssertionError(f"--only_test printed {only}, the run "
                                 f"printed {a['test']}")

        # ---- the checkpoint through ScoringService.load_latest ----------
        cfg_a = cli.make_config(cli.build_arg_parser().parse_args(argv))
        svc = ScoringService(cfg_a, *sizes, *vocabs)
        svc.load_latest(cfg_a.model_dir)
        with open(paths["test"]) as f:
            rows = [next(f).rstrip("\n").split("\t")
                    for _ in range(100 * P11_SERVE_GROUPS)]
        reqs = [ScoreRequest(
            user=c[1], hist_items=c[5].split(","), hist_cates=c[6].split(","),
            hist_times=[float(t) for t in c[7].split(",")],
            current_time=float(c[4]),
            cand_items=[r[2] for r in rows[g * 100:(g + 1) * 100]],
            cand_cates=[r[3] for r in rows[g * 100:(g + 1) * 100]])
            for g, c in ((g, rows[g * 100]) for g in range(P11_SERVE_GROUPS))]
        served = np.stack(svc.score(reqs))
        model_a = get_model_class("clsr")(cfg_a, *sizes)
        checkpoint.load_model(checkpoint.latest_epoch_dir(cfg_a.model_dir),
                              model_a)
        test_loader = SequenceLoader(parsed["test"], cfg_a.max_seq_length)
        batch = next(test_loader.eval_batches(100, P11_SERVE_GROUPS))
        preds, _ = make_eval_step_fn(cfg_a)(model_a, to_device(batch,
                                                               "cuda"))
        serve_err = float(np.abs(served - preds.cpu().numpy()).max())
        log(f"ScoringService.load_latest: {P11_SERVE_GROUPS} x 100 scores "
            f"against the eval step on the same groups, max abs err "
            f"{serve_err:.3e} (tol {SERVE_CKPT_TOL})")
        if not serve_err <= SERVE_CKPT_TOL:
            raise AssertionError("load_latest scores differ from the eval "
                                 "step's")
        del svc, model_a
        loaders = {s: SequenceLoader(ds, cfg_a.max_seq_length)
                   for s, ds in parsed.items()}

        # ---- run A's steps eager, in the same run: the epoch before the
        # graph, the idle shares eager and graphed, then phase 12 ----------
        mark("run A --only_test and load_latest")
        eager_a = eager_epoch("run A", cfg_a, sizes, dict(
            loaders, train=SequenceLoader(head(parsed["train"],
                                               P11_EAGER_ROWS),
                                          cfg_a.max_seq_length)), smi)
        mark("run A eager epoch")
        trainer_a = eager_a.pop("trainer")
        # few steps: each makes ~12,000 launches for the profiler
        profile_a = {"eager": profile_fit(trainer_a, loaders["train"], smi,
                                          graphed=False, n=1),
                     "graphed": profile_fit(trainer_a, loaders["train"],
                                            smi, graphed=True,
                                            n=P11_PROFILE_K)}
        del trainer_a
        mark("run A profiles")
        graph_a = graph_against_eager("run A", cfg_a, sizes,
                                      loaders["train"], smi)
        mark("phase 12 run A")

        # ---- run B: every kernel on the path, one epoch ------------------
        # streamed (the CLI's auto is resident): phase 13 holds the
        # resident path against this one
        cfg_b = cfg_a.replace(use_pallas_scan=True,
                              use_pallas_train_attention="on",
                              optimizer="lazyadam", epochs=1,
                              resident_data="off",
                              model_dir=os.path.join(root, "model_b"),
                              summaries_dir=None)
        trainer = Trainer(get_model_class("clsr")(cfg_b, *sizes), cfg_b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before_mb = torch.cuda.memory_allocated() / 1e6
        _, fit_counts = counted(lambda: trainer.fit(loaders["train"],
                                                    loaders["valid"]))
        memory_b = dict(
            before_fit_mb=before_mb,
            peak_mb=torch.cuda.max_memory_allocated() / 1e6,
            kept_mb=torch.cuda.memory_allocated() / 1e6,
            graph_pool_mb=trainer.multi_step.capture_stats["pool_bytes"]
            / 1e6, capture_s=trainer.multi_step.capture_stats["capture_s"])
        log(f"run B fit through the graph (K = "
            f"{cfg_b.train_steps_per_call}): capture and instantiate "
            f"{memory_b['capture_s']:.3f} s, graph pool "
            f"{memory_b['graph_pool_mb']:.1f} MB | device memory "
            f"{before_mb:.1f} MB before the fit (model and optimizer), peak "
            f"{memory_b['peak_mb']:.1f} MB, kept after it "
            f"{memory_b['kept_mb']:.1f} MB | {smi}")
        stats = trainer.epoch_stats[0]
        steps = stats["steps"]
        n_valid = -(-len(parsed["valid"]) // 5 // (cfg_b.batch_size // 5))
        check_counts("run B epoch", fit_counts, dict(
            row_scatter=steps, clsr_scan_backward=steps,
            train_stats0=2 * steps, train_stats1=2 * steps,
            eval_scorer=2 * steps, clsr_scan=steps + n_valid, row_sweep=0))
        mark("run B fit")
        t0 = time.perf_counter()
        kept_on = []
        res_on, test_counts = counted(lambda: run_weighted_eval(
            recording(trainer.eval_step, kept_on), trainer.state.model,
            loaders["test"], cfg_b, cfg_b.test_num_ngs))
        test_b_s = time.perf_counter() - t0
        n_test_calls = -(-len(parsed["test"]) // 100 // (cfg_b.batch_size
                                                         // 100))
        check_counts("run B test eval", test_counts, dict(
            eval_scorer=n_test_calls, clsr_scan=n_test_calls))
        losses = [s["mean_loss"] for s in trainer.epoch_stats]
        log(f"run B epoch: {stats['train_s']:.3f} s, {steps} steps, "
            f"{stats['examples'] / stats['train_s']:,.1f} examples/s, valid "
            f"eval {stats['eval_s']:.3f} s, mean loss {losses[0]:.5f} | test "
            f"eval {test_b_s:.3f} s ({n_test_calls} dispatches of "
            f"{cfg_b.batch_size // 100} groups), test {res_on} | launches: "
            f"epoch {fit_counts}, test eval {test_counts} | {smi}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"run B losses {losses}")

        mark("run B test eval")
        p17 = resume_and_histograms(cfg_b, sizes, loaders, trainer, res_on,
                                    root, smi)
        mark("phase 17 (b) and (c)")
        # ---- K1 on against K1 off on the same weights: every prediction --
        cfg_off = cfg_b.replace(use_pallas_eval_attention="off")
        model_off = get_model_class("clsr")(cfg_off, *sizes)
        model_off.load_state_dict(trainer.state.model.state_dict())
        kept_off = []
        res_off, off_counts = counted(lambda: run_weighted_eval(
            recording(make_eval_step_fn(cfg_off), kept_off), model_off,
            loaders["test"], cfg_off, cfg_off.test_num_ngs))
        on, off = valid_preds(kept_on), valid_preds(kept_off)
        k1_pred_err = (on - off).abs().max().item()
        k1_err = max(abs(res_on[k] - res_off[k]) for k in res_on)
        log(f"test eval K1 on against K1 off: {on.numel():,} predictions, "
            f"max abs err {k1_pred_err:.3e} (tol {K1_ONOFF_TOL}); the "
            f"4-decimal metrics {k1_err:.4g} apart | K1 launches with it "
            f"off {off_counts['eval_scorer']}")
        if not (res_on.keys() == res_off.keys()
                and on.shape == off.shape
                and k1_pred_err <= K1_ONOFF_TOL
                and off_counts["eval_scorer"] == 0):
            raise AssertionError(f"K1 on {res_on} against off {res_off}: "
                                 f"predictions {k1_pred_err:.3e} apart")
        del model_off, kept_on, kept_off, on, off

        # ---- the fit's shapes: the kernel steps against the plain ones ---
        # run B's first train batch (B = 500) and one test batch (5 x 100)
        # on run B's weights, every kernel of the path held against its
        # plain version (kernel_check: scores 1e-4 abs, loss parts 1e-4
        # rel, gradients 1e-4 of max abs, BN stats 1e-5, K5 bit for bit)
        first = to_device(next(loaders["train"].train_batches(
            cfg_b.batch_size, np.random.RandomState(cfg_b.seed),
            min_seq_length=cfg_b.min_seq_length)), "cuda")
        test_batch = to_device(next(loaders["test"].eval_batches(
            group_size=cfg_b.test_num_ngs + 1,
            batch_groups=cfg_b.batch_size // (cfg_b.test_num_ngs + 1),
            min_seq_length=cfg_b.min_seq_length)), "cuda")
        shapes = kernel_check.compare_steps(
            cfg_b, trainer.state.model.state_dict(), sizes, first,
            test_batch)
        del first, test_batch
        lc = shapes["launches"]
        nonzero = {side: {k: n for k, n in c.items() if n}
                   for side, c in lc.items()}
        log(f"fit shapes, kernel steps against plain steps (train B = "
            f"{cfg_b.batch_size}, eval {cfg_b.batch_size // 100} x 100): "
            f"scores max abs err {shapes['score_err']:.3e} (tol 1e-4), loss "
            f"parts max rel err {shapes['loss_rel_err']:.3e} (tol 1e-4), "
            f"gradients max err / max abs {shapes['grad_rel_err']:.3e}, table "
            f"row gradients {shapes['table_grad_rel_err']:.3e} (tol 1e-4; "
            f"zero-by-construction biases max abs err "
            f"{shapes['zero_grad_abs_err']:.3e}), BN running stats max abs "
            f"err {shapes['bn_err']:.3e} (tol 1e-5), K5 bit-identical: "
            f"{shapes['k5_identical']} ({shapes['k5_groups']} group) | "
            f"launches {nonzero} | {smi}")
        check_counts("fit shapes, kernel eval step", lc["eval/kernel"],
                     dict(eval_scorer=1, clsr_scan=1))
        check_counts("fit shapes, kernel train step", lc["train/kernel"],
                     dict(train_stats0=2, train_stats1=2, eval_scorer=2,
                          clsr_scan=1, clsr_scan_backward=1, row_scatter=1))
        for side in ("eval/plain", "train/plain"):
            check_counts(f"fit shapes, {side}", lc[side],
                         {k: 0 for k in lc[side]})
        bad = kernel_check.failures(shapes)
        if bad or shapes["k5_identical"] is not True:
            raise AssertionError(f"fit shapes: the kernel steps disagree "
                                 f"with the plain ones: {bad}")
        bare = cfg_b.replace(metrics=(), pairwise_metrics=(),
                             weighted_metrics=())
        t0 = time.perf_counter()
        run_weighted_eval(trainer.eval_step, trainer.state.model,
                          loaders["test"], bare, bare.test_num_ngs)
        test_bare_s = time.perf_counter() - t0
        log(f"run B test eval without the metrics (batches, dispatches, one "
            f"copy back): {test_bare_s:.3f} s of {test_b_s:.3f} s, "
            f"{len(parsed['test']) // 100 / test_bare_s:,.1f} groups/s | "
            f"{smi}")
        mark("K1 on / off, fit shapes, bare test eval")
        profile = {"eager": profile_fit(trainer, loaders["train"], smi,
                                        graphed=False, n=4),
                   "graphed": profile_fit(trainer, loaders["train"], smi,
                                          graphed=True,
                                          n=P11_PROFILE_K)}
        del trainer
        mark("run B profiles")
        eager_b = eager_epoch("run B", cfg_b, sizes, dict(
            loaders, train=SequenceLoader(head(parsed["train"],
                                               P11_EAGER_ROWS),
                                          cfg_b.max_seq_length)), smi)
        del eager_b["trainer"]
        mark("run B eager epoch")
        graph_b = graph_against_eager("run B", cfg_b, sizes,
                                      loaders["train"], smi)
        mark("phase 12 run B")

        # ---- prefetch on against off: a short fit, bit for bit ------------
        short = SequenceLoader(head(parsed["train"], P11_PREFETCH_ROWS),
                               cfg_b.max_seq_length)
        # deterministic algorithms off: the train step sums a repeated
        # row's gradient in sorted order, so two fits give the same bits;
        # dense Adam with prefetch 2 and 0, and two lazyadam fits
        if torch.are_deterministic_algorithms_enabled():
            raise AssertionError("deterministic algorithms are on")
        fits = {}
        for run, opt, depth in (("prefetch 2", "adam", 2),
                                ("prefetch 0", "adam", 0),
                                ("lazy a", "lazyadam", 2),
                                ("lazy b", "lazyadam", 2)):
            cfg_p = cfg_b.replace(optimizer=opt, seed=3,
                                  prefetch_batches=depth, model_dir=None)
            t = Trainer(get_model_class("clsr")(cfg_p, *sizes), cfg_p,
                        log=lambda *_: None)
            t.fit(short, loaders["valid"])
            fits[run] = (state_tensors(t.state), t.eval_history,
                         t.epoch_stats[0])
            del t
        bit_same = {}
        for x, y in (("prefetch 2", "prefetch 0"), ("lazy a", "lazy b")):
            (sa, ha, ea), (sb, hb, eb) = fits[x], fits[y]
            bit_same[f"{x} / {y}"] = not differing(sa, sb) and ha == hb
            log(f"fits {x} against {y}: {ea['steps']} steps each (graphed), "
                f"every model and optimizer tensor and the valid metrics "
                f"bit-identical: {bit_same[f'{x} / {y}']} | epoch "
                f"{ea['train_s']:.3f} s against {eb['train_s']:.3f} s")
        if not all(bit_same.values()):
            raise AssertionError(f"two fits from one seed differ: {bit_same}")
        ea, eb = fits["prefetch 2"][2], fits["prefetch 0"][2]
        mark("fits from one seed")
        del fits
        p13 = resident_and_buckets(cfg_b, sizes, dict(
            loaders, test=SequenceLoader(head(full_test, P13_TEST_GROUPS
                                              * 100), cfg_a.max_seq_length)),
            smi)
        del full_test
        mark("phase 13")
        p14 = mixed_on_p11_data(cfg_b, sizes, loaders,
                                p13["resident"]["examples_per_s"], smi)
        mark("phase 14 (c) and (d)")
        p15 = zoo_fits(root, smi)
        mark("phase 15 (c)")
        p16 = zoo_fits(root, smi, ZOO_REST_FITS, "16")
        mark("phase 16 (c)")
        return dict(
            p20_sets=p20_sets_of(parsed["train"], parsed["valid"],
                                 parsed["test"], sizes),
            data=P11_DATA, write_s=write_s, parse=parse,
            run_a=dict(a, wall_s=wall, launches=launches_a,
                       only_test=only, only_test_wall_s=wall_t,
                       only_test_launches=launches_t, eager_epoch=eager_a,
                       profile=profile_a),
            serve_ckpt_err=serve_err,
            run_b=dict(epoch=stats, launches=fit_counts,
                       test_launches=test_counts, test_eval_s=test_b_s,
                       test_eval_no_metrics_s=test_bare_s,
                       test=res_on, test_k1_off=res_off, k1_onoff_err=k1_err,
                       k1_onoff_pred_err=k1_pred_err, fit_shapes=shapes,
                       profile=profile, memory=memory_b,
                       eager_epoch=eager_b),
            graph=dict(run_a=graph_a, run_b=graph_b), marks_s=marks,
            prefetch=dict(bit_identical=bit_same, on=ea, off=eb),
            phase13={k: v for k, v in p13.items() if k != "launches"},
            phase14={k: v for k, v in p14.items() if k != "launches"},
            phase15_fits=p15, phase16_fits=p16,
            phase17={k: v for k, v in p17.items() if k != "launches"},
            launches={"p15_zoo_fit": {k: sum(f["launches"][k]
                                             for f in p15.values())
                                      for k in launches_a},
                      "p16_zoo_fit": {k: sum(f["launches"][k]
                                             for f in p16.values())
                                      for k in launches_a},
                      "p17_resume_fit": p17["launches"],
                      "fit_cli": {k: launches_a[k] + launches_t[k]
                                  for k in launches_a},
                      "fit_kernels": {k: fit_counts[k] + test_counts[k]
                                      for k in fit_counts},
                      **p13["launches"], **p14["launches"]})
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------- phase 18
# the ETL from a raw Taobao-format log (UserBehavior.csv's schema), the
# packed format, a fit on the ETL's output and the CLI from the raw log
# a tenth of UserBehavior.csv's 100,150,807 rows took phase 18 164 s on
# the card, over its 120 s: depth cut to 6,000,000 (~60,000 users), then
# to 5,000,000 (~50,000 users; (c)'s 3 graphed calls of 32 x 400 need
# ~38,400 train lines, 4,000,000 keep ~35,000) to make room for phase 19,
# then to 2,000,000 (~19,000 train lines) and (c)'s one call of 32 x 400
# (12,800 lines) to make room for phase 22
P18_ROWS = 2_000_000
P18_EVENTS_A_USER = 101        # the public file's rows a user
P18_ITEMS, P18_CATES = 4_162_024, 9_439   # the public file's counts
P18_ID_RANGES = (1_018_011, 5_163_070, 5_162_429)   # uid, iid, category
P18_BEHAVIOURS = (("pv", 0.895), ("cart", 0.055), ("fav", 0.029),
                  ("buy", 0.021))
P18_ZIPF = (1.3, 100.0)        # item popularity (rank + r0)^-a
P18_INTEREST = 0.8             # events in a user's 1-5 favoured categories
P18_SECOND_CATE = 0.005        # items that also show a second category
P18_OUTSIDE = 0.001            # rows outside 2017-11-25 .. 12-03
P18_SEED = 18
P18_B = 400                    # (c): clsr.yaml's train batch
P18_CALLS = 1                  # (c): graphed calls from each loader
P18_ETL_RUNS = (("packed", dict(output_format="packed")),
                ("python", {}), ("native", dict(engine="native")),
                ("processes", dict(processes=4)))
P18_VIEW_FIELDS = ("users", "items", "cates", "labels", "lengths",
                   "item_hist", "cate_hist", "mask", "time_diff",
                   "time_from_first", "time_to_now")
ETL_RE = re.compile(r"^etl packed: ([\d.]+)s \((.*)\)$", re.M)


def _digits(v, width):
    """[n, width] ASCII digits of non-negative ints, right-aligned, the
    leading zeros as 0 bytes (dropped when the rows are joined)."""
    out = np.zeros((len(v), width), np.uint8)
    for d in range(width):
        p = 10 ** (width - 1 - d)
        out[:, d] = np.where((v >= p) | (d == width - 1), v // p % 10 + 48,
                             0)
    return out


def csv_bytes(cols):
    """One CSV line a row of `cols` (int arrays, or (codes, strings))."""
    parts = []
    for c in cols:
        if isinstance(c, tuple):
            codes, strings = c
            table = np.zeros((len(strings), max(map(len, strings))),
                             np.uint8)
            for i, s in enumerate(strings):
                table[i, :len(s)] = np.frombuffer(s.encode(), np.uint8)
            parts.append(table[codes])
        else:
            parts.append(_digits(c, len(str(int(c.max())))))
        parts.append(np.full((len(parts[-1]), 1), ord(","), np.uint8))
    parts[-1][:] = ord("\n")
    mat = np.concatenate(parts, axis=1)
    return mat[mat != 0].tobytes()


def _sorted_search(cum, x):
    """np.searchsorted(cum, x), the queries taken in order (a cached
    walk of cum instead of random probes)."""
    o = np.argsort(x)
    out = np.empty(len(x), np.int64)
    out[o] = np.searchsorted(cum, x[o])
    return out


def write_user_behavior(path, n_rows, seed, chunk=1_000_000):
    """A seeded raw log in the public UserBehavior.csv schema
    (uid,iid,category,behavior,ts; no header): ~101 rows a user; items
    of Zipf-like popularity over 4,162,024 ids, each of one of 9,439
    categories (0.5% of items show a second one on half their rows);
    each user's 1-5 favoured categories take 80% of their rows (the
    item by popularity within the category), the rest by global
    popularity; pv 89.5%, cart, fav, buy; times uniform over 2017-11-25
    .. 12-03 (local time, as the ETL's clamp), 0.1% of rows outside."""
    rng = np.random.RandomState(seed)
    n_users = max(1, round(n_rows / P18_EVENTS_A_USER))
    uid_max, iid_max, cid_max = P18_ID_RANGES
    uids = np.sort(rng.choice(uid_max, n_users, replace=False) + 1)
    item_ids = rng.choice(iid_max, P18_ITEMS, replace=False) + 1  # by rank
    cate_ids = rng.choice(cid_max, P18_CATES, replace=False) + 1
    wc = 1.0 / np.arange(1, P18_CATES + 1)
    cat_of = rng.choice(P18_CATES, P18_ITEMS, p=wc / wc.sum())
    a, r0 = P18_ZIPF
    w = (np.arange(P18_ITEMS) + r0) ** -a
    order = np.lexsort((np.arange(P18_ITEMS), cat_of))  # (category, rank)
    cum = np.cumsum(w[order])
    base = np.concatenate([[0.0], cum])
    start = np.searchsorted(cat_of[order], np.arange(P18_CATES))
    end = np.append(start[1:], P18_ITEMS)
    mass = base[end] - base[start]
    gcum = np.cumsum(w)
    gcum /= gcum[-1]
    second = rng.uniform(size=P18_ITEMS) < P18_SECOND_CATE
    n_fav = rng.randint(1, 6, n_users)
    fav = rng.choice(P18_CATES, (n_users, 5), p=mass / mass.sum())
    lo = int(datetime(2017, 11, 25).timestamp())
    hi = int(datetime(2017, 12, 3, 23, 59, 59).timestamp())
    beh_cum = np.cumsum([p for _, p in P18_BEHAVIOURS])
    names = [b for b, _ in P18_BEHAVIOURS]
    with open(path, "wb") as f:
        for c0 in range(0, n_rows, chunk):
            n = min(chunk, n_rows - c0)
            u = rng.randint(n_users, size=n)
            c = fav[u, (rng.uniform(size=n) * n_fav[u]).astype(np.int64)]
            x = base[start[c]] + rng.uniform(size=n) * mass[c]
            in_cat = order[np.minimum(_sorted_search(cum, x), end[c] - 1)]
            glob = np.minimum(_sorted_search(gcum, rng.uniform(size=n)),
                              P18_ITEMS - 1)
            item = np.where(rng.uniform(size=n) < P18_INTEREST, in_cat,
                            glob)
            cat = cat_of[item]
            flip = second[item] & (rng.uniform(size=n) < 0.5)
            cat[flip] = (cat[flip] + 1 + rng.randint(
                P18_CATES - 1, size=int(flip.sum()))) % P18_CATES
            ts = rng.randint(lo, hi + 1, n)
            out = rng.uniform(size=n) < P18_OUTSIDE
            ts[out] += np.where(rng.uniform(size=int(out.sum())) < 0.5,
                                -3 * 86400, 2 * 86400)
            beh = np.searchsorted(beh_cum, rng.uniform(size=n) * beh_cum[-1])
            f.write(csv_bytes([uids[u], item_ids[item], cate_ids[cat],
                               (beh, names), ts]))
    return n_users


def _mb(*paths):
    return sum(os.path.getsize(p) for p in paths) / 1e6


def _peak_rss_mb():
    """Peak resident memory of this process so far, MB (the ETL's worker
    processes are not in it)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def p18_etl(raw, root, smi):
    """(b) The ETL four times from the raw log: packed, then the TSVs by
    the Python engine, by C++ and by 4 worker processes; the vocabs of
    every run equal, the three train TSVs byte-identical, the packed
    train view equal to the parsed train TSV's, field for field.
    Returns (packed loaders, the TSV train loader, vocab sizes, the
    numbers)."""
    from clsr_tpu_torch.data import etl, packed
    from clsr_tpu_torch.data.loader import SequenceLoader
    from clsr_tpu_torch.data.parser import parse_file, time_range_for_unit
    from clsr_tpu_torch.data.vocab import load_vocab

    runs, files = {}, {}
    for name, kw in P18_ETL_RUNS:
        d = os.path.join(root, name)
        f = {s: os.path.join(d, f"{s}_data") for s in ("train", "valid",
                                                        "test")}
        f.update({v: os.path.join(d, f"{v}_vocab.pkl")
                  for v in ("user", "item", "category")})
        t0 = time.perf_counter()
        stages = etl.data_preprocessing(
            raw, f["train"], f["valid"], f["test"], f["user"], f["item"],
            f["category"], valid_num_ngs=4, test_num_ngs=99,
            dataset="taobao", seed=P18_SEED, **kw)
        wall = time.perf_counter() - t0
        vocabs = [load_vocab(f[v]) for v in ("user", "item", "category")]
        runs[name] = dict(wall_s=wall, stages=stages,
                          vocab_sizes=list(map(len, vocabs)),
                          peak_rss_mb=_peak_rss_mb())
        files[name] = (f, [list(v.mapping.items()) for v in vocabs])
        log(f"phase 18 (b) etl {name}: {wall:.3f} s (" + ", ".join(
            f"{k} {v:.3f}" for k, v in stages.items()) + f") | vocabs "
            f"{runs[name]['vocab_sizes']} | the process's peak RSS so far "
            f"{runs[name]['peak_rss_mb']:,.0f} MB")
    same_vocabs = all(m == files["packed"][1] for _, m in files.values())
    train = {n: files[n][0]["train"] for n in ("python", "native",
                                               "processes")}
    same_train = all(filecmp.cmp(train["python"], p, shallow=False)
                     for p in train.values())
    log(f"phase 18 (b): vocabs equal across the four runs: {same_vocabs}; "
        f"train_data byte-identical across the three TSV engines: "
        f"{same_train} ({_mb(train['python']):,.1f} MB)")
    if not (same_vocabs and same_train):
        raise AssertionError("phase 18 (b): the ETL runs disagree")
    for n in ("native", "processes"):
        shutil.rmtree(os.path.join(root, n))

    f, _ = files["python"]
    vocabs = [load_vocab(f[v]) for v in ("user", "item", "category")]
    parsed, parse_s = {}, {}
    for s in ("train", "valid", "test"):
        t0 = time.perf_counter()
        parsed[s] = parse_file(f[s], *vocabs)
        parse_s[s] = time.perf_counter() - t0
    tr = time_range_for_unit("s")
    pack_path = os.path.join(root, "packed", packed.PACKED_FILENAME)
    t0 = time.perf_counter()
    pack = packed.load_packed(pack_path)
    load_s = time.perf_counter() - t0
    loaders, view_s = {}, {}
    for s in ("train", "valid", "test"):
        t0 = time.perf_counter()
        loaders[s] = packed.make_loader(pack, s, TRAIN_L, tr)
        view_s[s] = time.perf_counter() - t0
    tsv_train = SequenceLoader(parsed["train"], TRAIN_L)
    ref, got = tsv_train.view, loaders["train"].view
    differ = [k for k in P18_VIEW_FIELDS
              if not (getattr(got, k).dtype == getattr(ref, k).dtype
                      and np.array_equal(getattr(got, k), getattr(ref, k)))]
    n_lines = {s: len(parsed[s]) for s in parsed}
    sizes = dict(tsv_mb=_mb(*(f[s] for s in ("train", "valid", "test"))),
                 packed_mb=_mb(pack_path))
    del parsed
    log(f"phase 18 (b): the TSVs {sizes['tsv_mb']:,.1f} MB ({n_lines} "
        f"lines) against packed.npz {sizes['packed_mb']:,.1f} MB "
        f"({pack.n_events:,} events, lines {[len(s) for s in pack.splits.values()]}); "
        f"parse (C++) {sum(parse_s.values()):.3f} s "
        f"({', '.join(f'{k} {v:.3f}' for k, v in parse_s.items())}) "
        f"against load {load_s:.3f} s + views "
        f"{sum(view_s.values()):.3f} s; the packed train view equals the "
        f"parsed train TSV's in every field: {not differ} "
        f"(differ: {differ}) | {smi}")
    if differ:
        raise AssertionError(f"phase 18 (b): the packed train view "
                             f"differs in {differ}")
    return loaders, tsv_train, tuple(map(len, vocabs)), dict(
        runs=runs, lines=n_lines, parse_s=parse_s, load_s=load_s,
        view_s=view_s, **sizes, events=int(pack.n_events))


def p18_fit(loaders, tsv_train, sizes, root, smi):
    """(c) Run B's configuration (K2 and its backward, K3a/K3b, K1,
    lazyadam with K5, graphed K = 32) at B = 400: P18_CALLS graphed calls
    fed from the packed loader and from the TSV loader, every state
    tensor bit for bit; then one epoch and the 1 + 99 test eval from
    the pack, counted."""
    from clsr_tpu_torch import cli
    from clsr_tpu_torch.data.prefetch import to_device
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.training.evaluator import run_weighted_eval
    from clsr_tpu_torch.training.kernel_check import counted
    from clsr_tpu_torch.training.state import create_train_state
    from clsr_tpu_torch.training.steps import make_multi_train_step
    from clsr_tpu_torch.training.trainer import Trainer

    cfg = cli.make_config(cli.build_arg_parser().parse_args(
        ["--dataset", "taobao", "--model", "CLSR", "--data_path", root,
         "--seed", "7"])).replace(
        use_pallas_scan=True, use_pallas_train_attention="on",
        optimizer="lazyadam", epochs=1, resident_data="off",
        batch_size=P18_B, model_dir=None, summaries_dir=None)
    K = cfg.train_steps_per_call
    states, gate_counts = {}, {}
    for name, loader in (("packed", loaders["train"]), ("tsv", tsv_train)):
        model = get_model_class("clsr")(cfg, *sizes)
        state = create_train_state(model, cfg)
        multi = make_multi_train_step(model, cfg, K)
        gen = torch.Generator(device="cuda").manual_seed(21)
        stacks = itertools.islice(
            (b for b in loader.train_batches_stacked(
                cfg.batch_size, K, np.random.RandomState(3))
             if b.users.ndim == 2), P18_CALLS)

        def calls():
            n = 0
            for b in stacks:
                multi(state, to_device(b, "cuda"), gen)
                n += 1
            return n
        n_calls, gate_counts[name] = counted(calls)
        if n_calls != P18_CALLS:
            raise AssertionError(f"phase 18 (c): {n_calls} calls from the "
                                 f"{name} loader")
        states[name] = state_tensors(state)
        del model, state, multi
    bad = differing(states["packed"], states["tsv"])
    log(f"phase 18 (c): {P18_CALLS} graphed calls of K = {K} steps (B = "
        f"{cfg.batch_size}) from the packed loader against the TSV loader: "
        f"{len(states['tsv'])} state tensors, bit-identical "
        f"{len(states['tsv']) - len(bad)} (differ: {bad[:5]}) | launches "
        f"{gate_counts['packed']}")
    if bad:
        raise AssertionError("phase 18 (c): the packed and TSV fits differ")
    del states

    trainer = Trainer(get_model_class("clsr")(cfg, *sizes), cfg)
    _, fit_counts = counted(lambda: trainer.fit(loaders["train"],
                                                loaders["valid"]))
    stats = trainer.epoch_stats[0]
    steps = stats["steps"]
    n_valid = -(-loaders["valid"].view.n_rows // 5
                // max(1, cfg.batch_size // 5))
    check_counts("phase 18 (c) epoch", fit_counts, dict(
        row_scatter=steps, clsr_scan_backward=steps,
        train_stats0=2 * steps, train_stats1=2 * steps,
        eval_scorer=2 * steps, clsr_scan=steps + n_valid, row_sweep=0))
    t0 = time.perf_counter()
    res, test_counts = counted(lambda: run_weighted_eval(
        trainer.eval_step, trainer.state.model, loaders["test"], cfg,
        cfg.test_num_ngs))
    test_s = time.perf_counter() - t0
    groups = loaders["test"].view.n_rows // 100
    n_test = -(-groups // max(1, cfg.batch_size // 100))
    check_counts("phase 18 (c) test eval", test_counts,
                 dict(eval_scorer=n_test, clsr_scan=n_test))
    valid = trainer.eval_history[-1][1] if trainer.eval_history else {}
    ex_s = stats["examples"] / stats["train_s"]
    log(f"phase 18 (c): one epoch from the pack, {steps} steps, "
        f"{stats['train_s']:.3f} s, {ex_s:,.1f} examples/s, mean loss "
        f"{stats['mean_loss']:.5f}, valid {valid} | test eval of {groups:,} "
        f"groups of 1 + 99 in {test_s:.3f} s: {res} | launches epoch "
        f"{fit_counts}, test {test_counts} | {smi}")
    if not (np.isfinite(stats["mean_loss"]) and res["auc"] > 0.5
            and all(np.isfinite(v) for v in res.values())):
        raise AssertionError(f"phase 18 (c): loss {stats['mean_loss']}, "
                             f"test {res}")
    return dict(gate_calls=P18_CALLS, K=K, gate_launches=gate_counts,
                epoch=stats, valid=valid, test=res, test_eval_s=test_s,
                test_groups=groups, examples_per_s=ex_s,
                launches={k: fit_counts[k] + test_counts[k]
                          for k in fit_counts})


def p18_cli(raw, root, smi):
    """(d) The CLI as a user runs it from the raw log (the defaults:
    B = 500, test 1 + 99, resident, K = 32), --etl_format packed, one
    epoch; then --only_test on the same directory, which must read the
    pack (no new ETL) and print the same test dict."""
    argv = ["--dataset", "taobao", "--model", "CLSR", "--epochs", "1",
            "--data_path", os.path.join(root, "cli")]
    text, wall, launches = run_cli(argv + ["--raw_data", raw,
                                           "--etl_format", "packed"])
    run = cli_numbers(text)
    m = ETL_RE.search(text)
    etl_s = float(m[1]) if m else None
    text_t, wall_t, launches_t = run_cli(argv + ["--only_test"])
    only = cli_numbers(text_t)["test"]
    same = {k: only.get(k) for k in run["test"]} == run["test"]
    e = run["epochs"][0] if run["epochs"] else {}
    last = run["valid"][max(run["valid"])] if run["valid"] else {}
    log(f"phase 18 (d) the CLI from the raw log: wall {wall:.3f} s, etl "
        f"{etl_s} s ({m[2] if m else '-'}), epoch {e.get('train_s')} s, "
        f"{e.get('examples_per_s')} examples/s, valid {last}, test eval "
        f"{run['test_eval_s']} s, test {run['test']} | launches "
        f"{launches} | {smi}")
    log(f"phase 18 (d) --only_test: wall {wall_t:.3f} s, no new ETL: "
        f"{'etl packed' not in text_t}, the same test dict: {same} | "
        f"launches {launches_t}")
    if not (same and "etl packed" not in text_t and len(run["epochs"]) == 1
            and last.get("auc", 0) > 0.5 and launches["eval_scorer"] > 0):
        raise AssertionError(f"phase 18 (d): the CLI failed its gates: "
                             f"valid {run['valid']}, only_test {only}")
    return dict(run=run, wall_s=wall, etl_s=etl_s, only_test=only,
                only_test_wall_s=wall_t,
                launches={k: launches[k] + launches_t[k] for k in launches})


def etl_phase(smi):
    """Phase 18: a seeded raw log through the ETL, a fit and the CLI."""
    root = tempfile.mkdtemp(prefix="clsr_phase18_")
    try:
        raw = os.path.join(root, "UserBehavior.csv")
        t0 = time.perf_counter()
        n_users = write_user_behavior(raw, P18_ROWS, P18_SEED)
        write_s = time.perf_counter() - t0
        log(f"phase 18 (a): {P18_ROWS:,} rows of {n_users:,} users "
            f"({_mb(raw):,.1f} MB) written in {write_s:.3f} s")
        t0 = time.perf_counter()
        loaders, tsv_train, sizes, b = p18_etl(raw, root, smi)
        b_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        c = p18_fit(loaders, tsv_train, sizes, root, smi)
        del loaders, tsv_train
        c_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        d = p18_cli(raw, root, smi)
        d_s = time.perf_counter() - t0
        rows_s = P18_ROWS / b["runs"]["packed"]["wall_s"]
        log(f"phase 18: (a) {write_s:.1f} s, (b) {b_s:.1f} s, (c) "
            f"{c_s:.1f} s, (d) {d_s:.1f} s; raw rows to packed.npz "
            f"{rows_s:,.0f} rows/s")
        return dict(rows=P18_ROWS, users=n_users, raw_mb=_mb(raw),
                    write_s=write_s, etl=b, fit=c, cli=d,
                    phase_s=dict(a=write_s, b=b_s, c=c_s, d=d_s),
                    rows_per_s_to_packed=rows_s,
                    launches={"p18_etl_fit": c.pop("launches"),
                              "p18_cli": d.pop("launches")})
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------- phase 19
# the (data, model) mesh: a 4-rank gloo world on the one card
P19_MESH = dict(data_parallel=2, model_parallel=2)
P19_STEPS_A, P19_STEPS_B = 8, 4
P19_SEED = 19
P19_REQ = (64, 100)            # (c): requests x candidates
P19_LOSS_REL = 1e-4            # mesh / one-rank: each loss part, and
#                                each optimizer moment after step 1
#                                (norm-relative), relative
P19_PARAM_ABS = 1e-4           # an element of a parameter, BN statistic
#                                or touched table row is "off" past this
P19_FLIP_SHARE = 1e-3          # at most this share of elements off, and
#                                none past Adam's step bound: 2.1 lr after
#                                step 1, 2.1 lr a step after the last (an
#                                element whose gradient is rounding noise
#                                moves +-lr a step either way: the
#                                zero-by-construction biases, and the BN
#                                means they shift, always)
P19_SCORE_ABS = 1e-5           # (c) and (d): scores and predictions
# (d)'s tables: phase 11's counts, so the checkpoint stays small
P19_CKPT_SIZES = (10_000, 50_000, 1_001)
P19_TIMEOUT_S = 900.0


def p19_cfg(**kw):
    from clsr_tpu_torch.config import CONFIG_DIR, load_config
    return load_config(os.path.join(CONFIG_DIR, "clsr.yaml"),
                       user_vocab="u", item_vocab="i", cate_vocab="c",
                       seed=0, batch_size=TRAIN_B,
                       use_pallas_train_attention="on", use_pallas_scan=True,
                       **kw)


def p19_model(cfg, sizes):
    """clsr.yaml's model from the config's seed, spread as phase 5's; the
    same bits in every process on the card."""
    from clsr_tpu_torch.models.registry import get_model_class
    model = get_model_class("clsr")(cfg, *sizes)
    spread(model, P19_SEED)
    return model


def p19_touched(batches):
    """{table: sorted unique logical ids} that the positives touch (the
    in-batch negatives are drawn from them)."""
    from clsr_tpu_torch.training.lazy_adam import batch_table_ids
    out = {}
    for b in batches:
        for name, ids in batch_table_ids(b).items():
            out.setdefault(name, []).append(ids.reshape(-1).cpu().numpy())
    return {k: np.unique(np.concatenate(v)) for k, v in out.items()}


def p19_snapshot(state, touched, mesh=None):
    """The train state as numpy: every tensor of the model but the
    tables, each table's rows at the touched ids (on a mesh, the rank's
    owned ones, with their ids), and the optimizer's moments likewise:
    dense Adam's exp_avg / exp_avg_sq ('opt.exp_avg.<name>'), and the
    lazy moments' m and v lanes ('opt.m.<name>', 'opt.v.<name>'; the
    pmn layout's p lane is the table itself)."""
    from clsr_tpu_torch.parallel.embedding import owned_rows
    from clsr_tpu_torch.training.lazy_adam import LazyAdamState
    model = state.model
    sharded = {n for n, p in model.named_parameters()
               if getattr(p, "mesh_rows", None) is not None}

    def host(t):                        # a copy, never a view
        return t.detach().float().cpu().numpy().copy()

    def rows(name, t):
        ids = torch.from_numpy(touched[name.rpartition(".")[2]]).to(t.device)
        loc = ids
        if mesh is not None and name in sharded:
            loc, ok = owned_rows(ids, mesh, t.shape[0])
            ids, loc = ids[ok], loc[ok]
        return ids.cpu().numpy(), host(t[loc.long()])

    out = {}
    for name, t in model.state_dict().items():
        out[name] = rows(name, t) if name.endswith("_embedding") else host(t)
    adam = state.optimizer
    if isinstance(adam, LazyAdamState):
        params = dict(model.named_parameters())
        for name, mv in adam.moments.items():
            d = params[name].shape[1]
            mv = mv[:, -2 * d:]             # (m, v) of (p, m, v) or (m, v)
            out[f"opt.m.{name}"] = rows(name, mv[:, :d])
            out[f"opt.v.{name}"] = rows(name, mv[:, d:])
        adam = adam.dense_opt
    for name, p in model.named_parameters():
        for key, t in adam.state.get(p, {}).items():
            if key in ("exp_avg", "exp_avg_sq"):
                out[f"opt.{key}.{name}"] = (
                    rows(name, t) if name.endswith("_embedding")
                    else host(t))
    return out


def p19_start(cfg, sizes, mesh=None):
    """p19_model, placed on the mesh, and a copy of its start."""
    from clsr_tpu_torch.parallel.mesh import place_model
    model = p19_model(cfg, sizes)
    if mesh is not None:
        place_model(model, mesh)
    return model, {k: v.clone() for k, v in model.state_dict().items()}


def p19_train(model, start, cfg, batches, mesh=None, touched=None,
              after_step=None):
    """len(batches) train steps of cfg from `start` (p19_start's):
    (loss parts [n, 5], the state, the launches of the steps, ms a step
    after the first, and with `touched` the state's p19_snapshot after
    the first step); `after_step(state)` runs after each step."""
    from clsr_tpu_torch.ops import launches
    from clsr_tpu_torch.parallel.mesh import shard_batch
    from clsr_tpu_torch.training.state import create_train_state
    from clsr_tpu_torch.training.steps import LOSS_FIELDS, make_train_step
    model.load_state_dict(start)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg, mesh)
    gen = torch.Generator(device="cuda").manual_seed(P19_SEED)
    local = [shard_batch(b, mesh) if mesh is not None else b
             for b in batches]
    torch.cuda.synchronize()
    launches.add(launches.snapshot(), -1)          # every count to 0
    rows, t1, first = [], None, None
    for i, b in enumerate(local):
        state, parts = step(state, b, gen)
        rows.append([float(getattr(parts, f)) for f in LOSS_FIELDS])
        if after_step is not None:
            after_step(state)
        if i == 0:
            if touched is not None:
                first = p19_snapshot(state, touched, mesh)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3 / max(len(local) - 1, 1)
    counts = {n: k for n, k in launches.snapshot().items() if k}
    return np.array(rows), state, counts, ms, first


def p19_eval_batch(sizes, seed, B=64, G=100, L=TRAIN_L):
    """A seeded eval batch of G candidates a row on the card."""
    b = train_batches(1, seed, *sizes, L=L)[0]
    rng = np.random.RandomState(seed + 1)
    items = torch.from_numpy(rng.randint(1, sizes[1], (TRAIN_B, G))
                             .astype(np.int32)).cuda()
    cates = torch.from_numpy(rng.randint(1, sizes[2], (TRAIN_B, G))
                             .astype(np.int32)).cuda()
    from clsr_tpu_torch.data.batch import Batch
    fields = {f: getattr(b, f)[:B] for f in Batch.__dataclass_fields__}
    fields.update(items=items[:B], cates=cates[:B],
                  labels=torch.zeros(B, G, device="cuda"))
    return Batch(**fields)


def p19_gloo_cuda(device):
    """Which collectives this torch build's gloo takes on CUDA tensors
    directly (the port stages gloo's through host memory itself, so it
    does not depend on them): {name: True or the error's first line}."""
    import torch.distributed as dist
    x = torch.ones(4, device=device)
    n = dist.get_world_size()
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(n)], x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4 // n, device=device), x)}
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = True
        except Exception as e:          # noqa: BLE001 — recorded
            out[name] = str(e).splitlines()[0][:120]
        dist.barrier()
    return out


def p19_rank(rank, device, spec):
    """One rank of phase 19's world: (a) twice, (b), (c), (d); then phase
    20's (p20_rank)."""
    from clsr_tpu_torch import serving
    from clsr_tpu_torch.parallel import collectives as col
    from clsr_tpu_torch.parallel.mesh import (make_mesh,
                                              make_sharded_eval_step)
    from clsr_tpu_torch.training import checkpoint
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sizes = (USERS, ITEMS, CATES)
    batches = train_batches(P19_STEPS_A, P19_SEED, *sizes)
    touched = p19_touched(batches)
    out = {"gloo_cuda": (p19_gloo_cuda(device) if spec["backend"] == "gloo"
                         else None)}
    t0 = time.perf_counter()
    model, start = p19_start(p19_cfg(**P19_MESH), sizes,
                             make_mesh(p19_cfg(**P19_MESH)))
    out["start_s"] = time.perf_counter() - t0
    for run, kw, n in (("a", dict(optimizer="lazyadam"), P19_STEPS_A),
                       ("b", dict(optimizer="adam", mesh_flat_batch="off"),
                        P19_STEPS_B)):
        cfg = p19_cfg(**kw, **P19_MESH)
        mesh = make_mesh(cfg)
        t0 = time.perf_counter()
        with col.count_collectives() as calls:      # phase 20 (a)'s bytes
            losses, state, counts, ms, step1 = p19_train(
                model, start, cfg, batches[:n], mesh, touched)
        out[run] = dict(losses=losses, launches=counts, ms=ms,
                        flat=mesh.flat, step1=step1,
                        state=p19_snapshot(state, touched, mesh),
                        bytes=p20_bytes(calls, n, p20_item_stream(cfg)[1]))
        del state
        again, state, _, ms2, _ = p19_train(model, start, cfg, batches[:n],
                                            mesh)
        snap = p19_snapshot(state, touched, mesh)
        first = out[run]["state"]
        out[run]["ms_again"] = ms2
        out[run]["bit_identical"] = bool(
            np.array_equal(again, losses) and all(
                np.array_equal(*(np.asarray(x[k][-1] if isinstance(
                    x[k], tuple) else x[k]) for x in (snap, first)))
                for k in snap))
        out[run]["s"] = time.perf_counter() - t0
        del state
        torch.cuda.empty_cache()
    del model, start
    torch.cuda.empty_cache()
    # (c) the mesh service against the one-device scores
    cfg = p19_cfg(**P19_MESH)
    svc = serving.ScoringService(cfg, *sizes, *spec["vocabs"])
    t0 = time.perf_counter()
    scores = svc.score(spec["requests"])
    out["c"] = dict(scores=scores, s=time.perf_counter() - t0,
                    n_batch=svc.mesh.n_batch)
    t0 = time.perf_counter()
    del svc
    torch.cuda.empty_cache()
    # (d) a mesh checkpoint (lazyadam, 2 steps) and its eval
    cfg = p19_cfg(optimizer="lazyadam", **P19_MESH)
    mesh = make_mesh(cfg)
    dsizes = P19_CKPT_SIZES
    _, state, _, _, _ = p19_train(*p19_start(cfg, dsizes, mesh), cfg,
                               train_batches(2, P19_SEED + 1, *dsizes), mesh)
    checkpoint.save_state(spec["ckpt"], state, mesh)
    preds, _ = make_sharded_eval_step(cfg, mesh)(
        state.model, p19_eval_batch(dsizes, P19_SEED + 2))
    out["d"] = dict(preds=preds.cpu().numpy(), s=time.perf_counter() - t0)
    del state
    torch.cuda.empty_cache()
    out["p20"] = p20_rank(rank, device, spec, sizes, batches, touched)
    out["p21"] = p21_rank(rank, device, spec)
    if spec["backend"] == "nccl":
        out["p22"] = p22_rank(rank, device, spec, sizes, batches, touched)
    return out


def p19_compare(got, want, bound):
    """The snapshot's model against the one-rank one: by kind (dense
    parameters and BN statistics, the zero-by-construction ones, table
    rows) the max abs difference, the elements off by more than
    P19_PARAM_ABS and the elements compared; and the kinds past the
    gates: any element past `bound`, or more than P19_FLIP_SHARE of a
    kind's elements off (the flip kind excepted)."""
    errs = {kind: [0.0, 0, 0] for kind in ("param", "flip", "table")}

    def add(kind, d):
        e = errs[kind]
        e[0] = max(e[0], float(d.max()) if d.size else 0.0)
        e[1] += int((d > P19_PARAM_ABS).sum())
        e[2] += int(d.size)

    for k, w in want.items():
        if k.startswith("opt."):
            continue
        g = got[k]
        if isinstance(w, tuple):       # (ids, rows): the owned subset
            ids, rows = g
            add("table", np.abs(rows - w[1][np.searchsorted(w[0], ids)]))
            continue
        add("flip" if zero_by_construction(k) or re.search(
            r"bn\d+\.mean$", k) else "param", np.abs(g - w))
    bad = [kind for kind, (mx, off, n) in errs.items()
           if mx > bound or (kind != "flip" and off > P19_FLIP_SHARE * n)]
    return errs, bad


def p19_moments(got, want):
    """The optimizer moments of the snapshot against the one-rank ones:
    the largest relative error ||got - want|| / ||want|| of a moment
    tensor (a table's: its rank's owned touched rows), and its name.
    The zero-by-construction biases' moments (rounding noise) are left
    out."""
    worst = (0.0, None)
    for k, w in want.items():
        if not k.startswith("opt.") or zero_by_construction(k):
            continue
        g = got[k]
        if isinstance(w, tuple):
            ids, g = g
            w = w[1][np.searchsorted(w[0], ids)]
        rel = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
        worst = max(worst, (rel, k), key=lambda x: x[0])
    return worst


def mesh_phase(smi, backend="gloo", p20_sets=None):
    """Phases 19 and 20: the (data, model) mesh on the card, a 4-rank
    gloo world at (2, 2) against the one-rank port from the same seed.
    `p20_sets` are phase 20 (d)'s rows of phase 11's set
    (`p20_sets_of`); without them the set is written here.  With
    backend "nccl" the ranks take a card each (on a host of 4 cards:
    `python3 -c "import chip_smoke as c; s = c.card_check();
    c.build_kernels(); c.mesh_phase(s, 'nccl')"`)."""
    from clsr_tpu_torch import serving
    from clsr_tpu_torch.parallel.distributed import run_local_world
    from clsr_tpu_torch.training import checkpoint
    from clsr_tpu_torch.training.state import create_train_state
    from clsr_tpu_torch.training.steps import make_eval_step_fn
    sizes = (USERS, ITEMS, CATES)
    batches = train_batches(P19_STEPS_A, P19_SEED, *sizes)
    touched = p19_touched(batches)
    ref = {}
    t0 = time.perf_counter()
    model, start = p19_start(p19_cfg(), sizes)
    for run, kw, n in (("a", dict(optimizer="lazyadam"), P19_STEPS_A),
                       ("b", dict(optimizer="adam"), P19_STEPS_B)):
        losses, state, counts, ms, step1 = p19_train(
            model, start, p19_cfg(**kw), batches[:n], touched=touched)
        ref[run] = dict(losses=losses, ms=ms, launches=counts, step1=step1,
                        state=p19_snapshot(state, touched))
        del state
        torch.cuda.empty_cache()
    del model, start
    rng = np.random.RandomState(P19_SEED)
    reqs = make_requests(rng, *P19_REQ, *sizes)
    vocabs = vocab_for(reqs)
    svc = serving.ScoringService(p19_cfg(), *sizes, *vocabs)
    want_scores = svc.score(reqs)
    del svc
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    refs20 = p20_refs(sizes, batches)
    del batches
    ref20_s = time.perf_counter() - t0
    one22 = None
    if backend == "nccl":       # phase 22 (b): one rank's graphed steps
        one22 = {b: p22_graphed_ms(p22_cfg(b, TRAIN_L), sizes, P19_SEED)
                 for b in (TRAIN_B // 4, TRAIN_B)}
    root = tempfile.mkdtemp(prefix="clsr_phase19_")
    try:
        if p20_sets is None:
            p20_sets = p20_write_sets(root)
        reqs21 = make_requests(np.random.RandomState(P19_SEED + 21),
                               *P19_REQ, *P19_CKPT_SIZES)
        vocabs21 = vocab_for(reqs21)
        refs21 = p21_refs(p20_sets, reqs21, vocabs21, root)
        t0 = time.perf_counter()
        ranks = run_local_world(
            p19_rank, 4, backend, "cuda",
            (dict(requests=reqs, vocabs=vocabs, backend=backend,
                  ckpt=os.path.join(root, "epoch_1"),
                  p20_sets=p20_sets, root=root, p21_requests=reqs21,
                  p21_vocabs=vocabs21),), P19_TIMEOUT_S)
        world_s = time.perf_counter() - t0
        after21 = p21_after(refs21, vocabs21, reqs21, root)
        # (d) the mesh checkpoint on one device
        dcfg = p19_cfg(optimizer="lazyadam")
        model = p19_model(dcfg, P19_CKPT_SIZES)
        checkpoint.load_state(os.path.join(root, "epoch_1"),
                              create_train_state(model, dcfg))
        want_preds, _ = make_eval_step_fn(dcfg)(
            model, p19_eval_batch(P19_CKPT_SIZES, P19_SEED + 2))
        want_preds = want_preds.cpu().numpy()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    lr = p19_cfg().learning_rate
    out = dict(backend=backend, ref_s=ref_s, world_s=world_s, ranks={},
               gloo_cuda=ranks[0]["gloo_cuda"])
    log(f"phase 19 ({backend}): gloo on CUDA tensors in this build: "
        f"{ranks[0]['gloo_cuda']}")
    kernels = ("eval_scorer", "clsr_scan", "clsr_scan_backward",
               "train_stats0", "train_stats1", "row_scatter")
    failed = []
    for r, res in enumerate(ranks):
        row = {}
        for run, n in (("a", P19_STEPS_A), ("b", P19_STEPS_B)):
            got, want = res[run], ref[run]
            rel = float(np.max(np.abs(got["losses"] - want["losses"])
                               / np.maximum(np.abs(want["losses"]), 1e-12)))
            # after step 1 (one start, so only rounding differs): each
            # element within Adam's step, 2.1 lr, and the moments (linear
            # and quadratic in the gradient, so a gradient counted twice
            # shows) within the loss tolerance; after the last step the
            # elements within 2.1 lr a step
            errs1, bad1 = p19_compare(got["step1"], want["step1"], 2.1 * lr)
            mom1 = p19_moments(got["step1"], want["step1"])
            errs, bad = p19_compare(got["state"], want["state"],
                                    2.1 * lr * n)
            mom = p19_moments(got["state"], want["state"])
            bad = [f"{b} after step {n}" for b in bad] + [
                f"{b} after step 1" for b in bad1]
            if mom1[0] > P19_LOSS_REL:
                bad.append(f"moment {mom1[1]} after step 1, rel err "
                           f"{mom1[0]:.3g}")
            need = kernels if run == "a" else kernels[:-1]
            missing = [k for k in need if not got["launches"].get(k)]
            if rel > P19_LOSS_REL:
                bad.append("losses")
            if not got["bit_identical"]:
                bad.append("two mesh runs from one seed differ")
            if missing:
                bad.append(f"kernels {missing} never launched")
            failed += [f"({run}), rank {r}: {b}" for b in bad]
            row[run] = dict(loss_rel_err=rel, errs=errs, errs_step1=errs1,
                            moment_rel_err_step1=mom1,
                            moment_rel_err=mom, ms=got["ms"],
                            ms_again=got["ms_again"], flat=got["flat"],
                            launches=got["launches"], s=got["s"])
        c_err = max(float(np.abs(g - w).max())
                    for g, w in zip(res["c"]["scores"], want_scores))
        d_err = float(np.abs(res["d"]["preds"] - want_preds).max())
        if c_err > P19_SCORE_ABS or d_err > P19_SCORE_ABS:
            failed.append(f"rank {r}: served scores {c_err:.3g}, "
                          f"checkpoint eval {d_err:.3g} from one device's")
        row.update(c=dict(max_abs_err=c_err, s=res["c"]["s"],
                          n_batch=res["c"]["n_batch"]),
                   d=dict(max_abs_err=d_err, s=res["d"]["s"]),
                   start_s=res["start_s"])
        out["ranks"][r] = row
        log(f"phase 19 rank {r}: (a) lazyadam compact, flat "
            f"{row['a']['flat']}: loss rel err {row['a']['loss_rel_err']:.3g}"
            f", [max abs, off, of] step 1 {row['a']['errs_step1']}, last "
            f"{row['a']['errs']}, moments' worst rel err step 1 "
            f"{row['a']['moment_rel_err_step1']}, last "
            f"{row['a']['moment_rel_err']}, {row['a']['ms']:.1f} "
            f"ms a step, launches {row['a']['launches']}; (b) dense adam, "
            f"flat {row['b']['flat']}: loss rel err "
            f"{row['b']['loss_rel_err']:.3g}, step 1 {row['b']['errs_step1']}"
            f", last {row['b']['errs']}, moments step 1 "
            f"{row['b']['moment_rel_err_step1']}, last "
            f"{row['b']['moment_rel_err']}, "
            f"{row['b']['ms']:.1f} ms a step; (c) {P19_REQ[0]} x "
            f"{P19_REQ[1]} served, max abs err {c_err:.3g}; (d) checkpoint "
            f"eval max abs err {d_err:.3g}; s: start {row['start_s']:.1f}, "
            f"(a) {row['a']['s']:.1f}, (b) {row['b']['s']:.1f}, (c) "
            f"{row['c']['s']:.1f}, (d) {row['d']['s']:.1f}")
    log(f"phase 19: one rank (a) {ref['a']['ms']:.1f} ms a step, (b) "
        f"{ref['b']['ms']:.1f} ms a step; the world {world_s:.1f} s ("
        + ("gloo through host memory on one card: a transport, not NCCL)"
           if backend == "gloo" else "nccl, a card a rank)"))
    out["one_rank"] = {run: dict(ms=v["ms"], launches=v["launches"],
                                 losses=v["losses"].tolist())
                       for run, v in ref.items()}
    if failed:
        raise AssertionError("phase 19: " + "; ".join(failed))
    failed, rows20 = p20_check(ranks, ref, refs20, lr)
    for r, row in rows20.items():
        a, d = row["a"], row["d"]
        log(f"phase 20 rank {r}: (a) owner merge: loss rel err "
            f"{a['loss_rel_err']:.3g} (one rank), "
            f"{a['loss_rel_err_broadcast']:.3g} (the broadcast run), step 1 "
            f"{a['errs_step1']}, last {a['errs']}, moments step 1 "
            f"{a['moment_rel_err_step1']}, {a['ms']:.1f} ms a step against "
            f"the broadcast's {a['broadcast_ms']:.1f}, launches "
            f"{a['launches']}, bytes received a step a rank: owner "
            f"{a['bytes']['total']:,.0f} (merge streams "
            f"{a['bytes']['merge']:,.0f}), broadcast "
            f"{a['broadcast_bytes']['total']:,.0f} (merge streams "
            f"{a['broadcast_bytes']['merge']:,.0f}); (b) fallback at C = 1: "
            f"overflow {row['b']['overflow']}, {row['b']['ms']:.1f} ms a "
            f"step; (c) drop: overflow {row['c']['overflow']}, "
            f"{row['c']['ms']:.1f} ms, bytes {row['c']['bytes']['total']:,.0f}"
            f" (merge {row['c']['bytes']['merge']:,.0f}), streams of >= "
            f"{row['item_stream'][1]:,} floats {row['c']['bytes']['stream']};"
            f" (d) streamed {d['streamed']['s']:.1f} s, resident "
            f"{d['resident']['s']:.1f} s, bit for bit {d['bit_identical']},"
            f" resident launches {d['resident']['launches']}, buckets Lb "
            f"{d['buckets']['lb']} {d['buckets']['s']:.1f} s launches "
            f"{d['buckets']['launches']}, K1 / K2 errs by Lb "
            f"{d['kernel_errs']}; (e) {row['e']}; (f) "
            + ", ".join(f"{k} loss rel err {v['loss_rel_err']:.3g} step 1 "
                        f"{v['errs_step1']} last {v['errs']} moments "
                        f"{v['moment_rel_err_step1']} {v['ms']:.1f} ms a "
                        f"step (one rank {v['one_rank_ms']:.1f})"
                        for k, v in row["f"].items())
            + f"; s {row['s']}")
    log(f"phase 20: the ranks' work {max(r['s']['all'] for r in rows20.values()):.1f} s, "
        f"the one-rank (f) runs {ref20_s:.1f} s")
    out["p20"] = dict(ranks=rows20, ref_s=ref20_s)
    if failed:
        raise AssertionError("phase 20: " + "; ".join(failed))
    failed, rows21 = p21_check(ranks, refs21, after21,
                               p21_lgn_cfg(False).learning_rate)
    for r, row in rows21.items():
        a, b, c, d, e = (row[k] for k in "abcde")
        log(f"phase 21 rank {r}: (a) LGN, flat {a['flat']}: loss rel err "
            f"{a['loss_rel_err']:.3g}, step 1 {a['errs_step1']}, last "
            f"{a['errs']}, moments step 1 {a['moment_rel_err_step1']}, "
            f"{a['ms']:.1f} ms a step (one rank {a['one_rank_ms']:.1f}), "
            f"the tables' gathers {a['gather_bytes']:,.0f} bytes received "
            f"a step a rank of {a['bytes']['total']:,.0f} in all; (b) "
            + ", ".join(f"{run} killed at call {b[run]['killed_at']}, "
                        f"resumed = uninterrupted bit for bit "
                        f"{b[run]['same_as_uninterrupted']}, "
                        f"{b[run]['s']:.1f} s"
                        for run in ("streamed", "resident"))
            + f", launches {b['launches']}; (c) {c['tags']} tags, lo/hi "
            f"rel err {c['lo_hi_rel_err']:.3g}, counts moved "
            f"{c['counts_share']:.3g}; (d) {d['dispatches']} dispatches "
            f"(steps {len(d['steps'])}) in {d['s']:.2f} s, launches "
            f"{d['launches']}; (e) mesh scores off one rank's by f32 "
            f"{e['err_f32']:.3g}, int8 {e['err_int8']:.3g}; the one rank's "
            f"files loaded on the mesh bit for bit f32 {e['loaded_f32']}, "
            f"int8 {e['loaded_int8']}, the mesh's on one rank "
            f"{after21}; s {row['s']}")
    log(f"phase 21: the ranks' work {max(r['s']['all'] for r in rows21.values()):.1f} s, "
        f"the one-rank side {refs21['s']:.1f} s; LGN on {refs21['lgn']['edges']:,} "
        f"edges")
    out["p21"] = dict(ranks=rows21, ref_s=refs21["s"],
                      edges=refs21["lgn"]["edges"])
    if failed:
        raise AssertionError("phase 21: " + "; ".join(failed))

    if backend == "nccl":
        out["p22"] = p22_report(ranks, one22, smi)

    def summed(pick):
        return {k: sum(pick(res["p20"]).get(k, 0) for res in ranks)
                for k in kernels}
    out["launches"] = {
        "p19_mesh_train": {
            k: sum(res["a"]["launches"].get(k, 0) for res in ranks)
            for k in kernels},
        "p20_owner_train": summed(lambda p: p["a"]["launches"]),
        "p20_mesh_resident": summed(
            lambda p: p["d"]["resident"]["launches"]),
        "p20_mesh_buckets": summed(
            lambda p: p["d"]["buckets"]["launches"]),
        "p20_zoo_mesh": {k: sum(f["launches"].get(k, 0)
                                for res in ranks
                                for f in res["p20"]["f"].values())
                         for k in kernels},
        "p21_mesh_resume": {k: sum(res["p21"]["b"]["launches"].get(k, 0)
                                   for res in ranks) for k in kernels},
        "p21_mesh_async": {k: sum(res["p21"]["d"]["launches"].get(k, 0)
                                  for res in ranks) for k in kernels}}
    if backend == "nccl":
        out["launches"]["p22_mesh_graphed"] = out["p22"]["graphed_launches"]
    return out


def p20_write_sets(root):
    """Phase 11's synthetic set, written and parsed here (phase 19 and 20
    run alone), cut to p20_sets_of's rows."""
    from clsr_tpu_torch.data.parser import parse_file
    from clsr_tpu_torch.data.synthetic import write_synthetic_dataset
    from clsr_tpu_torch.data.vocab import load_vocab
    paths = write_synthetic_dataset(os.path.join(root, "p20"),
                                    valid_num_ngs=4, test_num_ngs=99,
                                    **P11_DATA)
    vocabs = [load_vocab(paths[f"{n}_vocab"])
              for n in ("user", "item", "cate")]
    return p20_sets_of(*(parse_file(paths[k], *vocabs)
                         for k in ("train", "valid", "test")),
                       tuple(map(len, vocabs)))

# ------------------------------------------------------------- phase 20
# the rest of the mesh's training path, run inside phase 19's world
P20_OWNER = dict(optimizer="lazyadam", mesh_update_routing="owner",
                 mesh_owner_capacity=4.0)
P20_ONE_SLOT = 1e-6            # (b), (c): int(1e-6 * Mi) = 0, so C = 1
P20_STEPS_BC = 4               # (b), (c): steps
P20_FIT = dict(optimizer="lazyadam", epochs=1, train_steps_per_call=4,
               valid_num_ngs=4, test_num_ngs=99, show_step=0,
               save_model=False, early_stop=10)
P20_FIT_ROWS = 16 * TRAIN_B    # (d): 16 steps of B = 400
P20_VALID_GROUPS, P20_TEST_GROUPS = 200, 64
P20_TEST_G = 100               # a test group: 1 + 99
P20_EVAL_ROWS = 4              # (d): a test batch's groups, one a rank
P20_REFRESH = 8                # (d): the bucketed epoch's refresh batches
P20_ATT = dict(B=100, L=1_000, block=64)     # (e)
P20_ATT_TOL = (1e-5, 1e-4)     # (e): output abs; gradients of max abs
P20_ZOO = (("gru4rec", "gru4rec"), ("din", "din"))
P20_ZOO_STEPS = 4
P20_KERNELS = ("eval_scorer", "clsr_scan", "clsr_scan_backward",
               "train_stats0", "train_stats1", "row_scatter")


def p20_cfg(**kw):
    return p19_cfg(**P19_MESH, **kw)


def p20_start(cfg, sizes, mesh=None):
    """cfg's model (clsr.yaml's or a zoo yaml's) from the config's seed,
    spread as phase 19's, placed on the mesh; and a copy of its start."""
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.parallel.mesh import place_model
    model = get_model_class(cfg.model_type)(cfg, *sizes)
    spread(model, P19_SEED)
    if mesh is not None:
        place_model(model, mesh)
    return model, {k: v.clone() for k, v in model.state_dict().items()}


def p20_same(a, b):
    """Two p19_snapshot's bit for bit."""
    return a.keys() == b.keys() and all(
        np.array_equal(*(np.asarray(x[k][-1] if isinstance(x[k], tuple)
                                    else x[k]) for x in (a, b)))
        for k in a)


def p20_bytes(calls, steps, stream):
    """From a count_collectives record of `steps` steps: bytes received a
    step a rank by every collective and by the float all_gathers and
    all_to_alls (the merges' gradient streams), and the float ones
    carrying `stream` floats or more (the item table's [Mi, D] stream)."""
    floats = [c for c in calls if c.dtype == torch.float32
              and c.kind in ("all_gather", "all_to_all")]
    return dict(
        total=sum(c.received_bytes for c in calls) / steps,
        merge=sum(c.received_bytes for c in floats) / steps,
        calls=len(calls) / steps,
        stream=sorted({(c.kind, c.group, c.shape) for c in floats
                       if int(np.prod(c.shape)) >= stream}))


def p20_item_stream(cfg):
    """Mi * D of the item table on a rank of a flat batch: its sorted ids
    (history + candidates) times the row width."""
    mi = TRAIN_B // 4 * (TRAIN_L + 1 + cfg.train_num_ngs)
    return mi, mi * cfg.item_embedding_dim


def p20_attention(device, group, rank, n):
    """(e): the sequence-parallel merge over `group` against the one-rank
    blocked attention: (output max abs err, the keys' and parameters'
    gradients' max abs err over their max abs)."""
    from clsr_tpu_torch.ops.initializers import get_initializer
    from clsr_tpu_torch.ops.long_context import LongTargetAttention
    from clsr_tpu_torch.parallel import collectives as col
    cfg = p19_cfg()
    B, L, blk = P20_ATT["B"], P20_ATT["L"], P20_ATT["block"]
    dq, dk = cfg.user_embedding_dim, cfg.item_embedding_dim + \
        cfg.cate_embedding_dim
    mod = LongTargetAttention(
        dq, dk, cfg.att_fcn_layer_sizes, get_initializer("tnormal", 0.1),
        torch.Generator(device=device).manual_seed(P19_SEED), device,
        block_size=blk)
    rng = np.random.RandomState(P19_SEED + 20)     # the same on each rank
    dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    query, keys = dev(rng.randn(B, dq)), dev(rng.randn(B, L, dk))
    mask = dev(np.arange(L)[None] < rng.randint(1, L + 1, B)[:, None])
    cot = dev(rng.randn(B, dk))
    params = list(mod.parameters())
    full = keys.clone().requires_grad_()
    want = mod(query, full, mask)
    g_want = torch.autograd.grad((want * cot).sum(), [full] + params)
    per = L // n
    part = keys[:, rank * per:(rank + 1) * per].clone().requires_grad_()
    got = mod(query, part, mask[:, rank * per:(rank + 1) * per],
              axis_name=group)
    g_got = torch.autograd.grad((got * cot).sum() / n, [part] + params)
    d_keys = col.all_gather(g_got[0], group).permute(1, 0, 2, 3).reshape(
        B, L, dk)
    grads = [d_keys] + [col.all_reduce(g, group) for g in g_got[1:]]
    names = ["keys"] + [n for n, _ in mod.named_parameters()]
    out_err = float((got - want).detach().abs().max())
    # the output bias under the softmax over L has a zero gradient by
    # construction (rounding noise on both sides): held in absolute terms
    rel = {n: float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
           for n, g, w in zip(names, grads, g_want)
           if n != "w_nn_output_bias"}
    zero_abs = float((grads[-1] - g_want[-1]).abs().max())
    return dict(out_err=out_err, grad_err=max(rel.values()),
                worst=max(rel, key=rel.get), zero_grad_abs=zero_abs,
                finite=bool(torch.isfinite(got).all()))


def p20_fits(spec, device, mesh):
    """(d): the streamed, resident and bucketed fits on phase 11's rows,
    the launches of each, and K1 / K2 against their plain versions at
    every Lb of the bucketed model on the mesh."""
    from clsr_tpu_torch.data.loader import SequenceLoader
    from clsr_tpu_torch.data.prefetch import to_device
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.ops import launches
    from clsr_tpu_torch.parallel.mesh import shard_batch, use_mesh
    from clsr_tpu_torch.training.trainer import Trainer
    sets = spec["p20_sets"]
    loaders = {k: SequenceLoader(sets[k], TRAIN_L)
               for k in ("train", "valid", "test")}
    out, trainers = {}, {}
    for run, kw in (("streamed", dict(resident_data="off")),
                    ("resident", dict(resident_data="auto")),
                    ("buckets", dict(resident_data="auto",
                                     length_buckets="auto",
                                     bn_refresh_batches=P20_REFRESH))):
        cfg = p20_cfg(**P20_FIT, **kw)
        model = get_model_class("clsr")(cfg, *sets["sizes"])
        spread(model, P19_SEED)
        t = Trainer(model, cfg, log=lambda *a: None)
        torch.cuda.synchronize()
        launches.add(launches.snapshot(), -1)       # every count to 0
        t0 = time.perf_counter()
        t.fit(loaders["train"], loaders["valid"])
        torch.cuda.synchronize()
        out[run] = dict(
            s=time.perf_counter() - t0, history=t.eval_history,
            steps=t.epoch_stats[0]["steps"], resident=t.feeds is not None,
            bucketed=t.bucketed,
            lb=[f.res.seq_len for f, _ in t.feeds] if t.feeds else [],
            launches={n: k for n, k in launches.snapshot().items() if k},
            digest=p21_digest(t.state))
        trainers[run] = t
    a, b = (trainers[r].state for r in ("streamed", "resident"))
    sa, sb = a.model.state_dict(), b.model.state_dict()
    out["bit_identical"] = bool(
        sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
        and all(torch.equal(a.optimizer.moments[k], b.optimizer.moments[k])
                for k in a.optimizer.moments)
        and torch.equal(a.optimizer.count, b.optimizer.count))
    t = trainers["buckets"]
    errs = {}
    with use_mesh(t.mesh):
        for lb, batch in sorted(first_batches(
                loaders["test"], P20_TEST_G, P20_EVAL_ROWS * P20_TEST_G,
                out["buckets"]["lb"]).items()):
            errs[lb] = kernels_at(t.cfg, t.state.model, shard_batch(
                to_device(batch, device), t.mesh))
    out["kernel_errs"] = errs
    return out


def p20_rank(rank, device, spec, sizes, batches, touched):
    """Phase 20's work on one rank of phase 19's world: (a)-(f)."""
    from clsr_tpu_torch.parallel import collectives as col
    from clsr_tpu_torch.parallel.mesh import make_mesh
    t_all = time.perf_counter()
    out, s = {}, {}
    cfg = p20_cfg(**P20_OWNER)
    mesh = make_mesh(cfg)
    mi, stream = p20_item_stream(cfg)
    t0 = time.perf_counter()
    model, start = p20_start(cfg, sizes, mesh)
    s["start"] = time.perf_counter() - t0
    # (a) the owner merge, twice
    t0 = time.perf_counter()
    ovf = []
    with col.count_collectives() as calls:
        losses, state, counts, ms, step1 = p19_train(
            model, start, cfg, batches, mesh, touched,
            after_step=lambda st: ovf.append(int(st.optimizer.route_overflow)))
    snap = p19_snapshot(state, touched, mesh)
    del state
    again, state, _, ms2, _ = p19_train(model, start, cfg, batches, mesh)
    out["a"] = dict(losses=losses, launches=counts, ms=ms, ms_again=ms2,
                    step1=step1, state=snap, overflow=ovf,
                    interleaved=mesh.interleaved, flat=mesh.flat,
                    bytes=p20_bytes(calls, len(batches), stream),
                    bit_identical=bool(np.array_equal(again, losses)
                                       and p20_same(snap, p19_snapshot(
                                           state, touched, mesh))))
    del state
    s["a"] = time.perf_counter() - t0
    # (b) fallback at one slot, its broadcast twin, (c) drop
    t0 = time.perf_counter()
    n = P20_STEPS_BC
    for run, c in (
            ("b", p20_cfg(**dict(P20_OWNER,
                                 mesh_owner_capacity=P20_ONE_SLOT))),
            ("b_broadcast", p20_cfg(optimizer="lazyadam",
                                    mesh_row_layout="interleaved")),
            ("c", p20_cfg(**dict(P20_OWNER,
                                 mesh_owner_capacity=P20_ONE_SLOT,
                                 mesh_owner_overflow="drop")))):
        ovf = []
        with col.count_collectives() as calls:
            losses, state, counts, ms, _ = p19_train(
                model, start, c, batches[:n], make_mesh(c),
                after_step=lambda st: ovf.append(
                    int(st.optimizer.route_overflow)))
        out[run] = dict(losses=losses, overflow=ovf, ms=ms, launches=counts,
                        state=p19_snapshot(state, touched, mesh),
                        bytes=p20_bytes(calls, n, stream))
        del state
    # compared here: the snapshots stay on the rank
    out["b"]["same_as_broadcast"] = bool(
        np.array_equal(out["b"]["losses"], out["b_broadcast"]["losses"])
        and p20_same(out["b"]["state"], out["b_broadcast"]["state"]))
    for run in ("b", "b_broadcast", "c"):
        del out[run]["state"]
    del model, start
    torch.cuda.empty_cache()
    s["b_c"] = time.perf_counter() - t0
    # (d) mesh-resident data and length buckets
    t0 = time.perf_counter()
    out["d"] = p20_fits(spec, device, mesh)
    torch.cuda.empty_cache()
    s["d"] = time.perf_counter() - t0
    # (e) the sequence-parallel merge over the 4 ranks
    t0 = time.perf_counter()
    out["e"] = p20_attention(device, mesh.world, rank, 4)
    s["e"] = time.perf_counter() - t0
    # (f) GRU4Rec and DIN, held at the rows their steps touch
    t0 = time.perf_counter()
    out["f"] = {}
    touched = p19_touched(batches[:P20_ZOO_STEPS])
    for name, yaml in P20_ZOO:
        c = zoo_cfg(yaml, dict(batch_size=TRAIN_B, optimizer="lazyadam",
                               use_pallas_train_attention="on", **P19_MESH))
        m = make_mesh(c)
        model, start = p20_start(c, sizes, m)
        losses, state, counts, ms, step1 = p19_train(
            model, start, c, batches[:P20_ZOO_STEPS], m, touched)
        out["f"][name] = dict(losses=losses, launches=counts, ms=ms,
                              step1=step1,
                              state=p19_snapshot(state, touched, m))
        del model, start, state
        torch.cuda.empty_cache()
    s["f"] = time.perf_counter() - t0
    s["all"] = time.perf_counter() - t_all
    out["s"] = s
    out["item_stream"] = (mi, stream)
    return out


def p20_refs(sizes, batches):
    """(f)'s one-rank runs of GRU4Rec and DIN."""
    out = {}
    touched = p19_touched(batches[:P20_ZOO_STEPS])
    for name, yaml in P20_ZOO:
        c = zoo_cfg(yaml, dict(batch_size=TRAIN_B, optimizer="lazyadam",
                               use_pallas_train_attention="on"))
        model, start = p20_start(c, sizes)
        losses, state, counts, ms, step1 = p19_train(
            model, start, c, batches[:P20_ZOO_STEPS], touched=touched)
        out[name] = dict(losses=losses, ms=ms, launches=counts, step1=step1,
                         state=p19_snapshot(state, touched))
        del model, start, state
        torch.cuda.empty_cache()
    return out


def p20_sets_of(train, valid, test, sizes):
    """(d)'s rows of phase 11's parsed splits: the first 16 x 400 train
    rows, 400 valid groups of 5, 64 test groups of 100; the vocabs'
    counts (5,001, 50,001, 1,001: each with its default row) rounded up
    to a multiple of the model ranks, a row left unused, so that every
    table is row-sharded on the mesh."""
    m = P19_MESH["model_parallel"]
    return dict(train=head(train, P20_FIT_ROWS),
                valid=head(valid, P20_VALID_GROUPS * 5),
                test=head(test, P20_TEST_GROUPS * P20_TEST_G),
                sizes=tuple(-(-n // m) * m for n in sizes))


def p20_check(ranks, ref19, refs, lr):
    """Phase 20's gates on every rank's results: (failures, a summary
    row a rank)."""
    failed, rows = [], {}
    for r, res in enumerate(ranks):
        p, bad = res["p20"], []
        a = p["a"]
        rel = lambda x, y: float(np.max(np.abs(x - y) / np.maximum(
            np.abs(y), 1e-12)))
        rel_one, rel_b = (rel(a["losses"], ref19["a"]["losses"]),
                          rel(a["losses"], res["a"]["losses"]))
        errs1, bad1 = p19_compare(a["step1"], ref19["a"]["step1"], 2.1 * lr)
        errs, badn = p19_compare(a["state"], ref19["a"]["state"],
                                 2.1 * lr * len(a["losses"]))
        mom1 = p19_moments(a["step1"], ref19["a"]["step1"])
        bad += [f"(a) {k} after step 1" for k in bad1]
        bad += [f"(a) {k} after the last step" for k in badn]
        if max(rel_one, rel_b) > P19_LOSS_REL:
            bad.append(f"(a) losses {rel_one:.3g} / {rel_b:.3g}")
        if mom1[0] > P19_LOSS_REL:
            bad.append(f"(a) moment {mom1[1]} after step 1 {mom1[0]:.3g}")
        if any(a["overflow"]) or not a["interleaved"] or not a["flat"]:
            bad.append(f"(a) overflow {a['overflow']}, interleaved "
                       f"{a['interleaved']}, flat {a['flat']}")
        if not a["bit_identical"]:
            bad.append("(a) two runs differ")
        if a["launches"].get("row_scatter") != len(a["losses"]):
            bad.append(f"(a) K5 {a['launches'].get('row_scatter')} "
                       f"launches for {len(a['losses'])} steps")
        missing = [k for k in P20_KERNELS if not a["launches"].get(k)]
        if missing:
            bad.append(f"(a) kernels {missing} never launched")
        b, bb, c = p["b"], p["b_broadcast"], p["c"]
        inc = lambda o: list(np.diff([0] + o))
        if not b["same_as_broadcast"]:
            bad.append("(b) fallback differs from the broadcast merge")
        if min(inc(b["overflow"])) <= 0:
            bad.append(f"(b) overflow {b['overflow']}")
        if inc(c["overflow"]) != inc(b["overflow"]):
            bad.append(f"(c) overflow {c['overflow']} against (b)'s "
                       f"{b['overflow']}")
        if c["bytes"]["stream"] or not res["a"]["bytes"]["stream"]:
            bad.append(f"(c) streams {c['bytes']['stream']}, phase 19 "
                       f"(a)'s {res['a']['bytes']['stream']}")
        if not np.isfinite(c["losses"]).all():
            bad.append("(c) losses not finite")
        d = p["d"]
        if not (d["bit_identical"] and d["streamed"]["history"]
                == d["resident"]["history"]):
            bad.append("(d) resident differs from streamed")
        if d["streamed"]["resident"] or not d["resident"]["resident"]:
            bad.append("(d) 'auto' did not go resident")
        if not (d["streamed"]["steps"] == d["resident"]["steps"]
                == P20_FIT_ROWS // TRAIN_B):
            bad.append(f"(d) steps {d['streamed']['steps']}")
        missing = [k for k in P20_KERNELS
                   if not d["resident"]["launches"].get(k)]
        if missing:
            bad.append(f"(d) kernels {missing} never launched resident")
        if not d["buckets"]["bucketed"] or not d["kernel_errs"]:
            bad.append(f"(d) buckets {d['buckets']['lb']}, kernel checks "
                       f"at {sorted(d['kernel_errs'])}")
        for lb, (e1, e2) in d["kernel_errs"].items():
            if e1 > K1_TOL or e2 > K2_TOL:
                bad.append(f"(d) Lb {lb}: K1 {e1:.3g}, K2 {e2:.3g}")
        e = p["e"]
        if not (e["finite"] and e["out_err"] <= P20_ATT_TOL[0]
                and e["grad_err"] <= P20_ATT_TOL[1]
                and e["zero_grad_abs"] <= P20_ATT_TOL[0]):
            bad.append(f"(e) {e}")
        zoo = {}
        for name, got in p["f"].items():
            want = refs[name]
            zrel = rel(got["losses"], want["losses"])
            z1, zb1 = p19_compare(got["step1"], want["step1"], 2.1 * lr)
            zn, zbn = p19_compare(got["state"], want["state"],
                                  2.1 * lr * P20_ZOO_STEPS)
            zm = p19_moments(got["step1"], want["step1"])
            bad += [f"(f) {name} {k}" for k in zb1 + zbn]
            if zrel > P19_LOSS_REL or zm[0] > P19_LOSS_REL:
                bad.append(f"(f) {name}: losses {zrel:.3g}, moment "
                           f"{zm}")
            if not got["launches"].get("row_scatter"):
                bad.append(f"(f) {name}: K5 never launched")
            zoo[name] = dict(loss_rel_err=zrel, errs_step1=z1, errs=zn,
                             moment_rel_err_step1=zm, ms=got["ms"],
                             one_rank_ms=want["ms"],
                             launches=got["launches"])
        failed += [f"rank {r}: {x}" for x in bad]
        rows[r] = dict(
            a=dict(loss_rel_err=rel_one, loss_rel_err_broadcast=rel_b,
                   errs_step1=errs1, errs=errs, moment_rel_err_step1=mom1,
                   ms=a["ms"], ms_again=a["ms_again"],
                   broadcast_ms=res["a"]["ms"], launches=a["launches"],
                   bytes=a["bytes"], broadcast_bytes=res["a"]["bytes"]),
            b=dict(overflow=b["overflow"], ms=b["ms"],
                   broadcast_ms=bb["ms"], bytes=b["bytes"]),
            c=dict(overflow=c["overflow"], ms=c["ms"], bytes=c["bytes"]),
            d={k: (v if k in ("bit_identical", "kernel_errs") else
                   {kk: vv for kk, vv in v.items() if kk != "history"})
               for k, v in d.items()},
            e=e, f=zoo, s=p["s"], item_stream=p["item_stream"])
    return failed, rows



# ------------------------------------------------------------- phase 21
# the refused mesh settings, run inside phase 19's world: LGN on the
# mesh, kill and resume, histograms, the async service, a sharded
# service's save and load
P21_LGN_STEPS = 4              # (a): dense-Adam steps of B = 400
P21_KILL = {"streamed": 3, "resident": 2}   # (b): killed after this call
P21_HIST_REL = 1e-5            # (c): lo, hi relative to the one rank's
P21_HIST_SHARE = 0.01          # (c): counts' L1 difference / their total
P21_THREADS = 16               # (d): concurrent submitting threads
P21_SEEDS = (0, 1)             # (e): the services' weights (cfg.seed)
P21_KERNELS_B = ("eval_scorer", "clsr_scan", "clsr_scan_backward",
                 "train_stats0", "train_stats1", "row_scatter")
P21_KERNELS_D = ("eval_scorer", "clsr_scan")


class P21Killed(Exception):
    pass


def p21_digest(state):
    """sha256 of every tensor of a train state (model, optimizer moments
    and count), in name order: two states bit for bit or not."""
    import hashlib
    from clsr_tpu_torch.training.lazy_adam import LazyAdamState
    h = hashlib.sha256()
    tensors = sorted(state.model.state_dict().items())
    opt = state.optimizer
    if isinstance(opt, LazyAdamState):
        tensors += sorted(opt.moments.items()) + [("count", opt.count)]
    for name, t in tensors:
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def p21_graph(train, sizes):
    """LGN's graph of phase 20's train rows: each user's last row, its
    history and target (data/graph.py's rule for a train file)."""
    from clsr_tpu_torch.data.graph import build_graph_from_sequences
    last = {}
    for r, u in enumerate(train.users.tolist()):
        last[u] = r

    def seqs():
        for u, r in last.items():
            a, b = int(train.offsets[r]), int(train.offsets[r + 1])
            yield (u, train.hist_items[a:b].tolist() + [int(train.items[r])],
                   train.hist_cates[a:b].tolist() + [int(train.cates[r])])
    return build_graph_from_sequences(seqs(), sizes[0], sizes[1])


def p21_lgn_cfg(mesh):
    return zoo_cfg("lgn", dict(batch_size=TRAIN_B,
                               **(P19_MESH if mesh else {})))


def p21_lgn(sets, mesh=None):
    """(a)'s inputs: lgn.yaml's model on phase 20's graph and tables from
    the seed (spread as phase 19's, placed on the mesh), its start, the
    first P21_LGN_STEPS batches of phase 20's train rows, their touched
    ids, the graph's edges."""
    from clsr_tpu_torch.data.loader import SequenceLoader
    from clsr_tpu_torch.data.prefetch import to_device
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.parallel.mesh import place_model
    cfg = p21_lgn_cfg(mesh is not None)
    graph = p21_graph(sets["train"], sets["sizes"])
    model = get_model_class("lgn")(cfg, *sets["sizes"], graph=graph)
    spread(model, P19_SEED)
    if mesh is not None:
        place_model(model, mesh)
    it = SequenceLoader(sets["train"], TRAIN_L).train_batches(
        TRAIN_B, np.random.RandomState(P19_SEED))
    batches = [to_device(next(it), "cuda") for _ in range(P21_LGN_STEPS)]
    start = {k: v.clone() for k, v in model.state_dict().items()}
    return cfg, model, start, batches, p19_touched(batches), len(graph.src)


def p21_hists(mesh=None):
    """(c): the histogram step (on a mesh the mesh's) of phase 19 (d)'s
    model from the seed on a seeded train batch, as the records
    `utils/summaries.py` writes: {tag: (counts, lo, hi, nonfinite)}."""
    from clsr_tpu_torch.training.steps import make_histogram_step
    cfg = p19_cfg(**(P19_MESH if mesh is not None else {}))
    model, _ = p19_start(cfg, P19_CKPT_SIZES, mesh)
    batch = train_batches(1, P19_SEED + 21, *P19_CKPT_SIZES)[0]
    hists = make_histogram_step(mesh=mesh)(model, batch)
    return {tag: (c.cpu().numpy().tolist(), float(lo), float(hi), int(nf))
            for tag, (c, lo, hi, nf) in hists.items()}


def p21_service(seed, vocabs, mesh, **kw):
    from clsr_tpu_torch import serving
    cfg = p19_cfg(**(P19_MESH if mesh else {})).replace(seed=seed)
    return serving.ScoringService(cfg, *P19_CKPT_SIZES, *vocabs, **kw)


def p21_refs(sets, reqs, vocabs, root):
    """Phase 21's one-rank side before the world: (a) the LGN steps, (c)
    the histograms, (e) the one-rank services' files of the second seed
    and the first seed's scores."""
    t0 = time.perf_counter()
    cfg, model, start, batches, touched, edges = p21_lgn(sets)
    losses, state, _, ms, step1 = p19_train(model, start, cfg, batches,
                                            touched=touched)
    out = dict(lgn=dict(losses=losses, ms=ms, step1=step1, edges=edges,
                        state=p19_snapshot(state, touched)))
    del model, start, state, batches
    torch.cuda.empty_cache()
    out["hists"] = p21_hists()
    for name, kw in (("f32", {}), ("int8", dict(int8_tables=True))):
        p21_service(P21_SEEDS[1], vocabs, False, **kw).save(
            os.path.join(root, f"p21_one_{name}.pt"))
        out[f"scores_{name}"] = p21_service(P21_SEEDS[0], vocabs, False,
                                            **kw).score(reqs)
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


def p21_fits(spec, device):
    """(b): phase 20 (d)'s streamed and resident fits killed after a few
    calls of their autosave and resumed by a fresh Trainer; the resumed
    state's digest, its history, and the launches of the kill and the
    resume together."""
    from clsr_tpu_torch.data.loader import SequenceLoader
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.ops import launches
    from clsr_tpu_torch.training.trainer import Trainer
    sets = spec["p20_sets"]
    loaders = {k: SequenceLoader(sets[k], TRAIN_L) for k in ("train", "valid")}
    out = {}
    torch.cuda.synchronize()
    launches.add(launches.snapshot(), -1)           # every count to 0
    for run, kw in (("streamed", dict(resident_data="off")),
                    ("resident", dict(resident_data="auto"))):
        cfg = p20_cfg(**P20_FIT, **kw, autosave_every_calls=1,
                      model_dir=os.path.join(spec["root"], f"p21_{run}"))

        def trainer(log=lambda *a: None):
            model = get_model_class("clsr")(cfg, *sets["sizes"])
            spread(model, P19_SEED)
            return Trainer(model, cfg, log=log)
        t0 = time.perf_counter()
        b = trainer()
        name = "_autosave" if run == "resident" else "_autosave_stream"
        save, seen = getattr(b, name), []

        def kill(*args, **kwargs):
            save(*args, **kwargs)
            seen.append(args[1])
            if len(seen) == P21_KILL[run]:
                raise P21Killed
        setattr(b, name, kill)
        try:
            b.fit(loaders["train"], loaders["valid"])
        except P21Killed:
            pass
        del b
        logs = []
        c = trainer(lambda *a: logs.append(" ".join(map(str, a))))
        c.fit(loaders["train"], loaders["valid"], resume=True)
        torch.cuda.synchronize()
        out[run] = dict(killed_at=seen[-1], digest=p21_digest(c.state),
                        history=c.eval_history, resident=c.feeds is not None,
                        resumed=any(f"call {seen[-1]}" in line
                                    for line in logs),
                        s=time.perf_counter() - t0)
        del c
        torch.cuda.empty_cache()
    out["launches"] = {n: k for n, k in launches.snapshot().items() if k}
    return out


def p21_async(svc, reqs, rank):
    """(d): the async frontend over the mesh service on every rank, rank
    0 submitting `reqs` from P21_THREADS threads at once: (rank 0's
    scores or another rank's refusal of submit, the dispatches, the
    eval steps' (B, G), the launches, the synchronous service's scores
    of the same dispatches in request order)."""
    import concurrent.futures
    import torch.distributed as dist
    from clsr_tpu_torch.ops import launches
    from clsr_tpu_torch.serving import AsyncScoringService
    steps, step, plan = [], svc.step, svc.plan
    groups, index = [], {id(r): i for i, r in enumerate(reqs)}
    svc.step = lambda b: (steps.append(tuple(b.items.shape)), step(b))[1]
    svc.plan = lambda rs: (
        groups.append([index[id(r)] for r in rs]), plan(rs))[1]
    torch.cuda.synchronize()
    launches.add(launches.snapshot(), -1)           # every count to 0
    t0 = time.perf_counter()
    front = AsyncScoringService(svc)
    scores = None
    try:
        if rank == 0:
            with concurrent.futures.ThreadPoolExecutor(P21_THREADS) as pool:
                futs = list(pool.map(front.submit, reqs))
            scores = [f.result() for f in futs]
        else:
            try:
                front.submit(reqs[0])
            except RuntimeError as e:
                scores = str(e)
    finally:
        front.close()
        del svc.step, svc.plan
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    counts = {n: k for n, k in launches.snapshot().items() if k}
    shared = [groups]
    dist.broadcast_object_list(shared, src=0)
    sync = [None] * len(reqs)
    for g in shared[0]:
        for i, x in zip(g, svc.score([reqs[i] for i in g])):
            sync[i] = x
    return dict(scores=scores, dispatches=front.dispatches, steps=steps,
                launches=counts, s=s,
                error=None if front.error is None else repr(front.error),
                same=(rank != 0 or all(np.array_equal(a, b)
                                       for a, b in zip(scores, sync))))


def p21_rank(rank, device, spec):
    """Phase 21's work on one rank of phase 19's world: (a)-(e)."""
    from clsr_tpu_torch.parallel import collectives as col
    from clsr_tpu_torch.parallel.mesh import make_mesh
    out, s = {}, {}
    t_all = time.perf_counter()
    # (a) LGN on the mesh, twice
    t0 = time.perf_counter()
    mesh = make_mesh(p21_lgn_cfg(True))
    cfg, model, start, batches, touched, _ = p21_lgn(spec["p20_sets"], mesh)
    with col.count_collectives() as calls:
        losses, state, _, ms, step1 = p19_train(model, start, cfg, batches,
                                                mesh, touched)
    snap = p19_snapshot(state, touched, mesh)
    del state
    again, state, _, ms2, _ = p19_train(model, start, cfg, batches, mesh)
    # the tables' gathers: the model row's float all_gathers of a block
    blocks = [p for p in model.parameters()
              if getattr(p, "mesh_rows", None) is not None]
    gathers = [c for c in calls if (c.kind, c.group, c.dtype) == (
        "all_gather", "model", torch.float32)
        and c.shape in {tuple(p.shape) for p in blocks}]
    want = sum(p.numel() * 4 * (mesh.n_model - 1) for p in blocks)
    out["a"] = dict(
        losses=losses, ms=ms, ms_again=ms2, step1=step1, state=snap,
        flat=mesh.flat, bytes=p20_bytes(calls, P21_LGN_STEPS, 1 << 62),
        gather_bytes=sum(c.received_bytes for c in gathers) / P21_LGN_STEPS,
        gather_bytes_want=want,
        bit_identical=bool(np.array_equal(again, losses) and p20_same(
            snap, p19_snapshot(state, touched, mesh))))
    del model, start, state, batches
    torch.cuda.empty_cache()
    s["a"] = time.perf_counter() - t0
    # (b) kill and resume
    t0 = time.perf_counter()
    out["b"] = p21_fits(spec, device)
    s["b"] = time.perf_counter() - t0
    # (c) histograms
    t0 = time.perf_counter()
    out["c"] = p21_hists(make_mesh(p19_cfg(**P19_MESH)))
    torch.cuda.empty_cache()
    s["c"] = time.perf_counter() - t0
    # (d) the async service, (e) save and load
    t0 = time.perf_counter()
    reqs, vocabs, root = spec["p21_requests"], spec["p21_vocabs"], \
        spec["root"]
    svc = p21_service(P21_SEEDS[0], vocabs, True)
    out["d"] = p21_async(svc, reqs, rank)
    s["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    e = {}
    for name, kw in (("f32", {}), ("int8", dict(int8_tables=True))):
        a = svc if name == "f32" else p21_service(P21_SEEDS[0], vocabs,
                                                  True, **kw)
        e[f"scores_{name}"] = a.score(reqs)
        a.save(os.path.join(root, f"p21_mesh_{name}.pt"))
        a.load(os.path.join(root, f"p21_one_{name}.pt"))
        loaded = a.score(reqs)
        built = p21_service(P21_SEEDS[1], vocabs, True, **kw).score(reqs)
        e[f"loaded_{name}"] = all(np.array_equal(x, y)
                                  for x, y in zip(loaded, built))
        e[f"moved_{name}"] = not all(np.array_equal(x, y) for x, y in
                                     zip(loaded, e[f"scores_{name}"]))
        del a
    del svc
    torch.cuda.empty_cache()
    out["e"] = e
    s["e"] = time.perf_counter() - t0
    s["all"] = time.perf_counter() - t_all
    out["s"] = s
    return out


def p21_after(refs, vocabs, reqs, root):
    """(e)'s one-rank side after the world: each mesh file loaded on one
    rank against a one-rank service built from the same seed."""
    out = {}
    for name, kw in (("f32", {}), ("int8", dict(int8_tables=True))):
        svc = p21_service(P21_SEEDS[1], vocabs, False, **kw)
        svc.load(os.path.join(root, f"p21_mesh_{name}.pt"))
        got = svc.score(reqs)
        out[name] = all(np.array_equal(x, y)
                        for x, y in zip(got, refs[f"scores_{name}"]))
        del svc
    torch.cuda.empty_cache()
    return out


def p21_check(ranks, refs, after, lr):
    """Phase 21's gates on every rank: (failures, a summary row a
    rank)."""
    failed, rows = [], {}
    lead = ranks[0]["p21"]["d"]
    for r, res in enumerate(ranks):
        p, bad = res["p21"], []
        a, want = p["a"], refs["lgn"]
        rel = float(np.max(np.abs(a["losses"] - want["losses"]) / np.maximum(
            np.abs(want["losses"]), 1e-12)))
        errs1, bad1 = p19_compare(a["step1"], want["step1"], 2.1 * lr)
        errs, badn = p19_compare(a["state"], want["state"],
                                 2.1 * lr * P21_LGN_STEPS)
        mom1 = p19_moments(a["step1"], want["step1"])
        bad += [f"(a) {k} after step 1" for k in bad1]
        bad += [f"(a) {k} after the last step" for k in badn]
        if rel > P19_LOSS_REL or not np.isfinite(a["losses"]).all():
            bad.append(f"(a) losses rel err {rel:.3g}")
        if mom1[0] > P19_LOSS_REL:
            bad.append(f"(a) moment {mom1[1]} after step 1 {mom1[0]:.3g}")
        if not a["bit_identical"]:
            bad.append("(a) two runs differ")
        if a["gather_bytes"] != a["gather_bytes_want"]:
            bad.append(f"(a) gathered {a['gather_bytes']} bytes a step, "
                       f"not {a['gather_bytes_want']}")
        b = p["b"]
        d20 = res["p20"]["d"]
        for run in ("streamed", "resident"):
            x = b[run]
            # rank 0 alone logs the resume
            if not (x["killed_at"] == P21_KILL[run]
                    and (x["resumed"] or r > 0)
                    and x["resident"] == (run == "resident")):
                bad.append(f"(b) {run}: killed at {x['killed_at']}, "
                           f"resumed {x['resumed']}, resident "
                           f"{x['resident']}")
            x["same_as_uninterrupted"] = (
                x["digest"] == d20[run]["digest"]
                and x["history"] == d20[run]["history"])
            if not x["same_as_uninterrupted"]:
                bad.append(f"(b) {run}: the resumed fit differs from "
                           f"phase 20 (d)'s uninterrupted one")
        missing = [k for k in P21_KERNELS_B if not b["launches"].get(k)]
        if missing:
            bad.append(f"(b) kernels {missing} never launched")
        hw, hg = refs["hists"], p["c"]
        if hw.keys() != hg.keys() or not {"alpha", "item_embedding_output"
                                          } <= set(hg):
            bad.append(f"(c) tags {sorted(hg)}, one rank {sorted(hw)}")
        hist_err = [0.0, 0.0]
        for tag in set(hw) & set(hg):
            (cw, lw, uw, nw), (cg, lg, ug, ng) = hw[tag], hg[tag]
            span = max(abs(lw), abs(uw), 1e-30)
            e_lohi = max(abs(lg - lw), abs(ug - uw)) / span
            e_counts = np.abs(np.subtract(cg, cw)).sum() / max(sum(cw), 1)
            hist_err = [max(hist_err[0], e_lohi), max(hist_err[1], e_counts)]
            if (e_lohi > P21_HIST_REL or e_counts > P21_HIST_SHARE
                    or sum(cg) != sum(cw) or ng != nw):
                bad.append(f"(c) {tag}: lo/hi {e_lohi:.3g}, counts "
                           f"{e_counts:.3g}")
        d = p["d"]
        if r == 0 and not d["same"]:
            bad.append("(d) async scores differ from the synchronous ones")
        if d["error"] is not None:
            bad.append(f"(d) the frontend stopped on rank {r}: "
                       f"{d['error']}")
        if r and "rank 0 takes the requests" not in str(d["scores"]):
            bad.append(f"(d) submit on rank {r}: {d['scores']}")
        if (d["dispatches"], d["steps"]) != (lead["dispatches"],
                                             lead["steps"]):
            bad.append(f"(d) {d['dispatches']} dispatches, rank 0 "
                       f"{lead['dispatches']}")
        missing = [k for k in P21_KERNELS_D if not d["launches"].get(k)]
        if missing:
            bad.append(f"(d) kernels {missing} never launched")
        e = p["e"]
        for name in ("f32", "int8"):
            if not (e[f"loaded_{name}"] and e[f"moved_{name}"]
                    and after[name]):
                bad.append(f"(e) {name}: one rank's file on the mesh "
                           f"{e[f'loaded_{name}']}, the mesh's on one "
                           f"rank {after[name]}")
            err = max(float(np.abs(g - w).max()) for g, w in
                      zip(e[f"scores_{name}"], refs[f"scores_{name}"]))
            e[f"err_{name}"] = err
            if err > P19_SCORE_ABS:
                bad.append(f"(e) {name}: mesh scores {err:.3g} from one "
                           f"rank's")
        failed += [f"rank {r}: {x}" for x in bad]
        rows[r] = dict(
            a=dict(loss_rel_err=rel, errs_step1=errs1, errs=errs,
                   moment_rel_err_step1=mom1, ms=a["ms"],
                   ms_again=a["ms_again"], one_rank_ms=want["ms"],
                   flat=a["flat"], bytes=a["bytes"],
                   gather_bytes=a["gather_bytes"]),
            b={k: (v if k == "launches" else
                   {kk: vv for kk, vv in v.items() if kk != "history"})
               for k, v in b.items()},
            c=dict(lo_hi_rel_err=hist_err[0], counts_share=hist_err[1],
                   tags=len(hg)),
            d={k: v for k, v in d.items() if k not in ("scores",)},
            e={k: v for k, v in e.items() if not k.startswith("scores")},
            s=p["s"])
    return failed, rows


# ------------------------------------------------------------- phase 22
# graphed mesh steps over NCCL, and the port's scaling model
P22_CONFIGS = ("taobao", "kuaishou")    # scaling_model.CONFIGS
P22_K = 8                   # (a): a graphed call's steps
P22_MIXED_CAPACITY = 1.1    # (b): the user tables (a rank's 100 users, C =
#                             55 an owner) overflow on some steps, the
#                             item table (C = 3,025) on none
P22_KERNELS = P20_KERNELS


def p22_cfg(B, L, **kw):
    from clsr_tpu_torch.config import CONFIG_DIR, load_config
    return load_config(os.path.join(CONFIG_DIR, "clsr.yaml"),
                       user_vocab="u", item_vocab="i", cate_vocab="c",
                       seed=0, batch_size=B, max_seq_length=L,
                       use_pallas_train_attention="on", use_pallas_scan=True,
                       optimizer="lazyadam", **kw)


def p22_graphed_ms(cfg, sizes, seed, K=P22_K):
    """One rank's graphed lazyadam compact step of cfg at table counts
    `sizes`: a call of K steps (the warm-up, the capture, the replays),
    then K more replays each between CUDA events: (the median ms, every
    replay's ms, the capture stats)."""
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.training.state import create_train_state
    from clsr_tpu_torch.training.steps import (make_multi_train_step,
                                               stack_batches)
    model = get_model_class("clsr")(cfg, *sizes)
    spread(model, seed)
    state = create_train_state(model, cfg)
    multi = make_multi_train_step(model, cfg, K)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = train_batches(K, seed, *sizes, L=cfg.max_seq_length,
                            B=cfg.batch_size)
    multi(state, stack_batches(batches), gen)
    times = []
    for b in batches:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        multi.step(state, b, gen)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    stats = dict(multi.capture_stats)
    del model, state, multi, batches
    torch.cuda.empty_cache()
    return statistics.median(times), times, stats


P22_COUNT = ("import json, sys; from clsr_tpu_torch import scaling_model "
             "as m; json.dump([[list(k), list(v.items())] for k, v in "
             "m.count_configs(sys.argv[1:]).items()], sys.stdout)")


def p22_start_count():
    """The scaling model's byte count (gloo worlds of 2, 4 and 8 ranks on
    the host's CPU) in a subprocess at the lowest priority, started at
    the script's start: it takes the cores the card's phases leave idle,
    and p22_scaling collects it."""
    return subprocess.Popen([sys.executable, "-c", P22_COUNT, *P22_CONFIGS],
                            cwd=ROOT, stdout=subprocess.PIPE, text=True,
                            start_new_session=True,
                            preexec_fn=lambda: os.nice(19))


def p22_scaling(smi, counting):
    """(a): the one-rank graphed step at each scaling config's per-rank
    batch and L, tables at its counts, and the scaling model's table from
    those times and the bytes `counting` (p22_start_count) counted."""
    from clsr_tpu_torch import scaling_model
    out = {}
    for name in P22_CONFIGS:
        sc = scaling_model.CONFIGS[name]
        sizes = (sc["n_users"], sc["n_items"], sc["n_cates"])
        t0 = time.perf_counter()
        ms, times, stats = p22_graphed_ms(
            p22_cfg(sc["B_dev"], sc["L"]), sizes, 22)
        out[name] = dict(ms=ms, times=times, B=sc["B_dev"], L=sc["L"],
                         sizes=sizes, capture_s=stats["capture_s"],
                         pool_mb=stats["pool_bytes"] / 1e6,
                         s=time.perf_counter() - t0)
        log(f"phase 22 (a) {name}: graphed one-rank lazyadam step at B = "
            f"{sc['B_dev']}, L = {sc['L']}, tables {sizes}: median "
            f"{ms:.3f} ms of {len(times)} replays ({min(times):.3f}-"
            f"{max(times):.3f}), capture {stats['capture_s']:.2f} s, pool "
            f"{stats['pool_bytes'] / 1e6:.1f} MB | {smi}")
    t0 = time.perf_counter()
    text, _ = counting.communicate()
    if counting.returncode != 0:
        raise AssertionError(f"phase 22 (a): the byte count exited "
                             f"{counting.returncode}")
    counted = {tuple(k): {int(b): by for b, by in v}
               for k, v in json.loads(text)}
    out["count_wait_s"] = time.perf_counter() - t0
    lines = scaling_model.report(list(P22_CONFIGS),
                                 {n: out[n]["ms"] for n in P22_CONFIGS},
                                 card=smi, counted=counted)
    out["table"] = lines
    for line in lines:
        log(f"phase 22 (a) | {line}")
    return out


def p22_digest(state):
    """p21_digest with dense Adam's state too."""
    import hashlib
    from clsr_tpu_torch.training.lazy_adam import LazyAdamState
    h = hashlib.sha256(p21_digest(state).encode())
    opt = state.optimizer
    opt = opt.dense_opt if isinstance(opt, LazyAdamState) else opt
    for i, st in enumerate(opt.state_dict()["state"].values()):
        for k, v in sorted(st.items()):
            h.update(f"{i}/{k}".encode())
            h.update(torch.as_tensor(v).detach().cpu().contiguous()
                     .reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def p22_run(model, start, cfg, batches, mesh, K):
    """len(batches) steps of cfg from `start` on the mesh: K = 1 eager
    single steps, else one call of K = len(batches) graphed steps, then
    a barrier, a call, and a call timed.  The loss rows, the state's
    digest, the launches, the collectives (as tuples), the branch
    patterns read, the capture stats and ms a step."""
    from clsr_tpu_torch.ops import launches
    from clsr_tpu_torch.parallel import collectives as col
    from clsr_tpu_torch.parallel.mesh import shard_batch
    from clsr_tpu_torch.training import lazy_adam
    from clsr_tpu_torch.training.state import create_train_state
    from clsr_tpu_torch.training.steps import (LOSS_FIELDS,
                                               make_multi_train_step,
                                               make_train_step,
                                               stack_batches)
    model.load_state_dict(start)
    state = create_train_state(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(P19_SEED)
    local = [shard_batch(b, mesh) for b in batches]
    patterns, pattern = [], lazy_adam.MeshMerge.pattern

    def recorded(merge):
        patterns.append(pattern(merge))
        return patterns[-1]
    lazy_adam.MeshMerge.pattern = recorded
    torch.cuda.synchronize()
    launches.add(launches.snapshot(), -1)           # every count to 0
    stats, ms = None, None
    try:
        with col.count_collectives() as calls:
            if K == 1:
                step = make_train_step(model, cfg, mesh)
                rows = [[float(getattr(p, f)) for f in LOSS_FIELDS]
                        for p in (step(state, b, gen)[1] for b in local)]
            else:
                multi = make_multi_train_step(model, cfg, len(local), mesh)
                _, p = multi(state, stack_batches(local), gen)
                rows = np.stack([getattr(p, f).cpu().numpy()
                                 for f in LOSS_FIELDS], 1).tolist()
            torch.cuda.synchronize()
        counts = {n: k for n, k in launches.snapshot().items() if k}
    finally:
        lazy_adam.MeshMerge.pattern = pattern
    digest = p22_digest(state)
    if K > 1:
        # the ranks leave the digest apart: a barrier, a call, then the
        # timed call, so no rank's time holds another's host work
        stats = dict(multi.capture_stats)
        torch.distributed.barrier()
        multi(state, stack_batches(local), gen)
        start_ev, end_ev = (torch.cuda.Event(enable_timing=True)
                            for _ in range(2))
        start_ev.record()
        multi(state, stack_batches(local), gen)
        end_ev.record()
        end_ev.synchronize()
        ms = start_ev.elapsed_time(end_ev) / len(local)
    out = dict(rows=rows, digest=digest, launches=counts,
               calls=[(c.kind, c.group, c.shape, str(c.dtype),
                       c.received_bytes) for c in calls],
               patterns=patterns, stats=stats, ms=ms)
    del state
    torch.cuda.empty_cache()
    return out


def p22_fits_eager(spec):
    """Phase 20 (d)'s three fits with every call's steps run eagerly
    (steps.graph_refusal forced), the same calls of 4 steps: each one's
    digest and eval history."""
    from clsr_tpu_torch.data.loader import SequenceLoader
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.training import steps
    from clsr_tpu_torch.training.trainer import Trainer
    sets = spec["p20_sets"]
    loaders = {k: SequenceLoader(sets[k], TRAIN_L) for k in ("train", "valid")}
    out = {}
    refusal = steps.graph_refusal
    steps.graph_refusal = lambda mesh, device: "forced eager (phase 22)"
    try:
        for run, kw in (("streamed", dict(resident_data="off")),
                        ("resident", dict(resident_data="auto")),
                        ("buckets", dict(resident_data="auto",
                                         length_buckets="auto",
                                         bn_refresh_batches=P20_REFRESH))):
            cfg = p20_cfg(**P20_FIT, **kw)
            model = get_model_class("clsr")(cfg, *sets["sizes"])
            spread(model, P19_SEED)
            t = Trainer(model, cfg, log=lambda *a: None)
            t0 = time.perf_counter()
            t.fit(loaders["train"], loaders["valid"])
            torch.cuda.synchronize()
            out[run] = dict(digest=p21_digest(t.state),
                            history=t.eval_history,
                            s=time.perf_counter() - t0)
            del t, model
            torch.cuda.empty_cache()
    finally:
        steps.graph_refusal = refusal
    return out


def p22_rank(rank, device, spec, sizes, batches, touched):
    """Phase 22 (b) on one rank of the NCCL world: each check's steps
    eager (K = 1) and as one graphed call; phase 20 (d)'s fits eager
    against its graphed ones; a (4, 1) graphed call timed."""
    from clsr_tpu_torch.parallel.mesh import make_mesh
    t_all = time.perf_counter()
    out = {}
    cases = {
        "19a": (p20_cfg(optimizer="lazyadam"), P19_STEPS_A),
        "19b": (p20_cfg(optimizer="adam", mesh_flat_batch="off"),
                P19_STEPS_B),
        "20a": (p20_cfg(**P20_OWNER), P19_STEPS_A),
        "20b": (p20_cfg(**dict(P20_OWNER, mesh_owner_capacity=P20_ONE_SLOT)),
                P20_STEPS_BC),
        "mixed": (p20_cfg(**dict(P20_OWNER,
                                 mesh_owner_capacity=P22_MIXED_CAPACITY)),
                  P19_STEPS_A),
    }
    models = {}
    for name, (cfg, n) in cases.items():
        mesh = make_mesh(cfg)
        if mesh.interleaved not in models:
            models[mesh.interleaved] = p20_start(cfg, sizes, mesh)
        model, start = models[mesh.interleaved]
        out[name] = [p22_run(model, start, cfg, batches[:n], mesh, K)
                     for K in (1, n)]
    del models, model, start
    torch.cuda.empty_cache()
    # LGN
    mesh = make_mesh(p21_lgn_cfg(True))
    cfg, model, start, lgn_batches, _, _ = p21_lgn(spec["p20_sets"], mesh)
    out["21a"] = [p22_run(model, start, cfg, lgn_batches, mesh, K)
                  for K in (1, len(lgn_batches))]
    del model, start
    torch.cuda.empty_cache()
    # the fits, eager
    t0 = time.perf_counter()
    out["fits_eager"] = p22_fits_eager(spec)
    out["fits_s"] = time.perf_counter() - t0
    # (4, 1): the broadcast merge, every table whole on each rank
    cfg = p19_cfg(optimizer="lazyadam", data_parallel=4, model_parallel=1)
    mesh = make_mesh(cfg)
    model, start = p20_start(cfg, sizes, mesh)
    out["4x1"] = p22_run(model, start, cfg, batches, mesh, len(batches))
    out["4x1_eager"] = p22_run(model, start, cfg, batches[:1], mesh, 1)
    del model, start
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_all
    return out


def p22_cli(root, smi):
    """(b): the CLI at (2, 2) over NCCL on phase 11's synthetic set, one
    epoch, with the default K = 32 and with K = 1 (each as a user runs
    it, the ranks spawned): (the two test dicts, each run's s)."""
    out = {}
    data = os.path.join(root, "p22_cli")
    for run, extra in (("graphed", []), ("eager", ["--train_steps_per_call",
                                                   "1"])):
        argv = [sys.executable, "-m", "clsr_tpu_torch.cli", "--dataset",
                "synthetic", "--model", "CLSR", "--epochs", "1", "--seed",
                "7", "--data_path", data, "--data_parallel", "2",
                "--model_parallel", "2", "--dist_backend", "nccl"] + extra
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"phase 22 (b) CLI {run}: rc "
                                 f"{proc.returncode}\n{proc.stderr[-3000:]}")
        out[run] = dict(test=ast.literal_eval(
            proc.stdout.strip().splitlines()[-1]),
            s=time.perf_counter() - t0)
    return out


def p22_check(ranks, cli):
    """Phase 22 (b)'s gates on every rank: (failures, a summary)."""
    failed, rows = [], {}
    for r, res in enumerate(ranks):
        p, bad, row = res["p22"], [], {}
        for name in ("19a", "19b", "20a", "20b", "mixed", "21a"):
            eager, graphed = p[name]
            same = (eager["rows"] == graphed["rows"]
                    and eager["digest"] == graphed["digest"])
            if not same:
                bad.append(f"{name}: graphed differs from eager")
            if eager["calls"] != graphed["calls"]:
                bad.append(f"{name}: collectives differ")
            if eager["patterns"] != graphed["patterns"]:
                bad.append(f"{name}: patterns {graphed['patterns']} "
                           f"against {eager['patterns']}")
            if name != "21a":
                want = P22_KERNELS if name != "19b" else P22_KERNELS[:-1]
                missing = [k for k in want if not graphed["launches"].get(k)]
                if missing:
                    bad.append(f"{name}: kernels {missing} never launched "
                               f"graphed")
            by_group = {}
            for c in graphed["calls"]:
                by_group[c[1]] = by_group.get(c[1], 0) + c[4]
            row[name] = dict(
                same=same, ms=graphed["ms"],
                capture_s=graphed["stats"]["capture_s"],
                pool_mb=graphed["stats"]["pool_bytes"] / 1e6,
                tails=graphed["stats"].get("tails", 0),
                patterns=sorted(set(map(tuple, graphed["patterns"]))),
                bytes_a_step={g: v / len(graphed["rows"])
                              for g, v in by_group.items()},
                launches=graphed["launches"])
        if not any(set(q) == {False, True} for q in p["mixed"][0]["patterns"]):
            bad.append(f"mixed: patterns {p['mixed'][0]['patterns']} never "
                       f"mixed")
        if not (p["20b"][0]["patterns"]
                and all(all(q) for q in p["20b"][0]["patterns"])):
            bad.append(f"20b: patterns {p['20b'][0]['patterns']}")
        d20 = res["p20"]["d"]
        for run, x in p["fits_eager"].items():
            if (x["digest"], x["history"]) != (d20[run]["digest"],
                                               d20[run]["history"]):
                bad.append(f"fit {run}: graphed differs from eager")
        failed += [f"rank {r}: {b}" for b in bad]
        rows[r] = row
    if cli["graphed"]["test"] != cli["eager"]["test"]:
        failed.append(f"CLI: K = 32 {cli['graphed']['test']} against K = 1 "
                      f"{cli['eager']['test']}")
    return failed, rows


P22_CASES = ("19a", "19b", "20a", "20b", "mixed", "21a")


def p22_report(ranks, one22, smi):
    """Phase 22 (b) after the world: the CLI pair, the gates, and the
    step ms a rank graphed and eager beside one rank's and the scaling
    model's prediction."""
    from clsr_tpu_torch import scaling_model
    root = tempfile.mkdtemp(prefix="clsr_phase22_")
    try:
        cli = p22_cli(root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    failed, rows = p22_check(ranks, cli)
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True).stdout
    log("phase 22 (b): nvidia-smi topo -m\n" + topo.rstrip())
    t1 = {b: v[0] for b, v in one22.items()}
    predicted = {}
    for r, row in rows.items():
        p = ranks[r]["p22"]
        bytes41 = {}
        for c in p["4x1_eager"]["calls"]:
            bytes41[c[1]] = bytes41.get(c[1], 0) + c[4]
        pred22 = scaling_model.predict_step_ms(t1[TRAIN_B // 4],
                                               row["19a"]["bytes_a_step"])
        pred41 = scaling_model.predict_step_ms(t1[TRAIN_B // 4], bytes41)
        predicted[r] = {"2x2": pred22, "4x1": pred41,
                        "4x1_ms": p["4x1"]["ms"]}
        eager_ms = ranks[r]["a"]["ms"]
        log(f"phase 22 (b) rank {r}: graphed = eager bit for bit in "
            + ", ".join(f"{k} {v['same']}" for k, v in row.items())
            + f"; (2, 2) lazyadam step {row['19a']['ms']:.2f} ms graphed, "
            f"{eager_ms:.2f} ms eager (phase 19 (a)), one rank's graphed "
            f"{t1[TRAIN_B // 4]:.2f} ms at {TRAIN_B // 4} rows and "
            f"{t1[TRAIN_B]:.2f} ms at {TRAIN_B}; predicted {pred22:.2f} ms "
            f"(2, 2) and {pred41:.2f} ms (4, 1) against {p['4x1']['ms']:.2f}"
            f" ms graphed at (4, 1); capture s / pool MB / tails by check "
            + ", ".join(f"{k} {v['capture_s']:.2f} / {v['pool_mb']:.0f} / "
                        f"{v['tails']}" for k, v in row.items())
            + f"; ms a step graphed "
            + ", ".join(f"{k} {v['ms']:.2f}" for k, v in row.items())
            + f"; bytes a step (2, 2) {row['19a']['bytes_a_step']}; the "
            f"mixed check's patterns {row['mixed']['patterns']}; eager fits "
            f"{ranks[r]['p22']['fits_s']:.1f} s; rank s "
            f"{ranks[r]['p22']['s']:.1f} | {smi}")
    graphed = {k: sum(res["p22"][name][1]["launches"].get(k, 0)
                      for res in ranks for name in P22_CASES)
               for k in P22_KERNELS}
    log(f"phase 22 (b): launches of the graphed calls, summed over the "
        f"ranks: {graphed}")
    log(f"phase 22 (b): the CLI at (2, 2) over nccl, K = 32 "
        f"{cli['graphed']['s']:.1f} s, K = 1 {cli['eager']['s']:.1f} s, the "
        f"same test dict {cli['graphed']['test'] == cli['eager']['test']}: "
        f"{cli['graphed']['test']}")
    if failed:
        raise AssertionError("phase 22 (b): " + "; ".join(failed))
    return dict(ranks=rows, one_rank={b: dict(ms=v[0], times=v[1])
                                      for b, v in one22.items()},
                predicted=predicted, cli=cli, topo=topo,
                graphed_launches=graphed)


def main():
    smi = card_check()
    counting = p22_start_count()
    try:
        run_phases(smi, counting)
    finally:
        if counting.poll() is None:     # a phase failed before (a):
            os.killpg(counting.pid, 9)  # the count and its ranks
            counting.wait()


def run_phases(smi, counting):
    sys.path.insert(0, ROOT)
    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        log(f"[{name}: {phase_s[name]:.1f} s]")
        return out

    build_s = timed("build", build_kernels)
    k1 = timed("k1", check_k1, smi)
    k2 = timed("k2", check_k2, smi)
    served = timed("serve", serve, smi)
    k3 = timed("k3", check_k3, smi)
    scorer = timed("train scorer", check_train_scorer, smi)
    trained = timed("train", train, smi)
    rows = timed("row update", check_row_update, smi)
    lazy = timed("train lazy", train_lazy, smi)
    sums = timed("segment sums", check_segment_sum, smi)
    mixed = timed("mixed precision", mixed_precision, smi)
    zoo = timed("model zoo", model_zoo, smi)
    rest = timed("model zoo rest", zoo_rest, smi,
                 zoo["train"]["clsr_fused"]["lazyadam"]["step_ms"])
    fit = timed("train and evaluate", train_and_evaluate, smi)
    p20_sets = fit.pop("p20_sets")
    long = timed("long context", long_context, smi)
    etl18 = timed("etl", etl_phase, smi)
    mesh19 = timed("mesh", mesh_phase, smi, "gloo", p20_sets)
    scaling = timed("scaling", p22_scaling, smi, counting)
    if torch.cuda.device_count() >= 4:
        mesh22 = timed("mesh nccl", mesh_phase, smi, "nccl", p20_sets)
    else:
        mesh22 = None
        log(f"phase 22 (b): needs 4 cards, this host has "
            f"{torch.cuda.device_count()}: not run (on a host of 4: "
            f"python3 -c \"import chip_smoke as c; s = c.card_check(); "
            f"c.build_kernels(); c.mesh_phase(s, 'nccl')\")")
    launches = {
        "serve": {"eval_scorer": served["runs"]["k1"]["launches"]
                  ["eval_scorer"],
                  "clsr_scan": served["runs"]["k1k2"]["launches"]
                  ["clsr_scan"]},
        "train": trained["launches"],
        "lazy_train": lazy["launches"],
        "bench_row_update": rows["bench"]["launches"],
        "p14_bf16_train": mixed["train"]["launches"],
        "p14_int8_serve": mixed["serve"]["launches"],
        **zoo["launches"], **rest["launches"],
        **fit["launches"], **long["launches"], **etl18["launches"],
        **mesh19["launches"]}
    if mesh22 is not None:
        launches["p22_mesh_graphed"] = mesh22["launches"]["p22_mesh_graphed"]
    meta = {
        "eval_scorer": ("clsr_tpu_torch/csrc/eval_scorer.cu",
                        "clsr_tpu/ops/pallas_attention.py:147"),
        "clsr_scan": ("clsr_tpu_torch/csrc/clsr_scan.cu",
                      "clsr_tpu/ops/pallas_scan.py:45"),
        "clsr_scan_backward": ("clsr_tpu_torch/csrc/clsr_scan.cu",
                               "clsr_tpu/ops/pallas_scan.py:243"),
        "train_stats0": ("clsr_tpu_torch/csrc/train_stats.cu",
                         "clsr_tpu/ops/pallas_attention.py:429"),
        "train_stats1": ("clsr_tpu_torch/csrc/train_stats.cu",
                         "clsr_tpu/ops/pallas_attention.py:459"),
        "row_scatter": ("clsr_tpu_torch/csrc/row_update.cu",
                        "scripts/bench_pallas_update.py:239"),
        "row_sweep": ("clsr_tpu_torch/csrc/row_update.cu",
                      "scripts/bench_pallas_update.py:143"),
    }
    # K1 and K2 at the serving shapes of phases 3-4, K2's backward (with
    # its five weight products) and K3a/K3b at the train shape, K5 at the
    # item-pmn shape of the compact update, K4 at the bench shape; the
    # other shapes are in chip_smoke.json
    timed = {"eval_scorer": k1, "clsr_scan": k2,
             "clsr_scan_backward": scorer["clsr_scan"],
             "train_stats0": k3["train_stats0/short"],
             "train_stats1": k3["train_stats1/short"],
             "row_scatter": rows["row_scatter/item_pmn"],
             "row_sweep": rows["row_sweep/bench"]}
    no_library = "no single PyTorch call computes this function"
    kernels = []
    for name, k in timed.items():
        source, replaces = meta[name]
        by_path = {path: counts[name] for path, counts in launches.items()
                   if name in counts}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
            "library_note": ("index_copy_ on the valid ids"
                             if "library_ms" in k else no_library)})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "phase_s": phase_s, "build_s": build_s,
                   "k1": k1, "k2": k2,
                   "serve": served, "k3": k3, "train_scorer": scorer,
                   "train": trained, "row_update": rows,
                   "train_lazy": lazy, "segment_sums": sums,
                   "mixed_precision": mixed,
                   "model_zoo": {k: v for k, v in zoo.items()
                                 if k != "launches"},
                   "model_zoo_rest": {k: v for k, v in rest.items()
                                      if k != "launches"},
                   "train_and_evaluate": fit,
                   "long_context": {k: v for k, v in long.items()
                                    if k != "launches"},
                   "etl": {k: v for k, v in etl18.items()
                           if k != "launches"},
                   "mesh": {k: v for k, v in mesh19.items()
                            if k != "launches"},
                   "scaling": scaling,
                   "mesh_nccl": (None if mesh22 is None else
                                 {k: v for k, v in mesh22.items()
                                  if k != "launches"})}, f,
                  indent=1)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
