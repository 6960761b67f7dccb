#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py [--paper] [--phases NAME[,NAME...]]

``--paper`` runs ``[table2]`` at every checkpoint of exp1-exp6 (the
paper's full trajectories, as ``benchmarks/table2_synthetic.py --full``);
by default exp1-exp5 stop at their first checkpoint.  ``--phases`` runs
the build, the data and the named phases only (``PHASES``, in their
order), with what they need from earlier ones: ``[serve]``,
``[sharded]`` and ``[measure]`` take ``[main]``'s fits, and an LM phase
run without ``[lm]`` takes the flash row from the kernel alone at
``[lm]``'s shape.  The default is every phase.

Phases, each of which fails the run (non-zero exit, no result line):

1. Build: compile the CUDA kernels (``kernels/csrc/*.cu``, one ``nvcc``
   each, all at once) and print the build seconds and the card's name and
   power limit.
2. Kernels against their plain PyTorch versions, at the main path's
   shapes (the full 5x5 stack of MovieLens-1M-scale blocks): error, the
   kernel's and the plain version's time (CUDA events; median over
   CUDA-graph replays, so the host's launch cost is not in it; the
   kernel's replay range in ``ms_range``), the device ms of each kernel
   of the call from ``torch.profiler`` with the launches it recorded
   (``device_breakdown_ms``, ``device_launches_seen``), and the
   least time the card could take (bytes over HBM rate or operations over
   f32 rate, whichever is larger, counted from this run's data).  The
   three f-gradient kernels are also measured on the three blocks of one
   Sequential structure, gathered as ``sgd_structure_step`` gathers them
   (keys ending in ``_b3``: ``max_rel_err_b3``, ``ms_b3``,
   ``eager_ms_b3``, ``plain_ms_b3``, ``bound_ms_b3``,
   ``device_breakdown_ms_b3``, ...), the stack most of their launches get.
   The scatter kernel's row also gives the cluster size its C entry picks
   (``cluster_size``), the first scatter design's time on the same inputs
   through ``sddmm_factor_grad_first`` (``first_ms``, its error held to
   the same tolerance), and its time on the same entries permuted within
   each block (``ms_permuted``, error held too), at both stacks.
3. The main path through the user entry points, each phase with the
   launch counters set to 0 just before it and read just after (the
   segment and dense kernels' also by stack shape):
   ``CompletionProblem`` -> ``Trainer.fit`` (FullGD on the sparse store
   with the segment method for the Table 3 cell's 800 rounds, printing
   its held-out RMSE, with the scatter method, and on the dense layout,
   one Wave round on each layout, Sequential iterations on each layout)
   -> ``FitResult`` -> ``recommend_topk`` for 256 users.  Checks: costs
   finite and falling, each kernel launched in its phase, sparse and dense
   FullGD states agree at round 40, top-k agrees with a float64 host
   reference.
   ``[table2]``: the paper's Table 2 cells (``configs/gossip_mc.py``)
   through ``launch/paper_tables.py``: exp1-exp5 to their first checkpoint
   (80k structure updates, 10k for exp5) on the dense layout, each with
   the cost at t = 0 and at the checkpoint, us per iteration, ms per
   round and the dense kernel's launches by stack (B = 16/20/25/36/25).
   Checks: costs finite and falling, the kernel launched.
   ``[gossip]``: the synchronous ``Gossip`` schedule.  On the 1x1 plan,
   200 rounds of exp3 (dense, B = 25) and of the ML-1M cell (segment and
   scatter methods) against FullGD from one state (max |dU|, |dW|, the
   relative cost difference, and whether they are bitwise equal).  Then
   one 2x2 grid of four ``gloo`` processes sharing the card
   (``launch/gossip.py``, the edges staged through pinned host buffers)
   runs exp1 (4x4 dense, B = 4 a rank) and a 4x4 ML-1M sparse grid for
   300 rounds against the 1x1 run from the same state (max |dU| < 1e-5,
   cost rel < 1e-4, tests/test_distributed.py's tolerance), and
   staleness 2 with int8 messages on exp1 (the cost must fall).  Prints
   ms per round, staged bytes per round, the start-up seconds of the
   grid's processes, and checks ``train_gossip_halo_bytes_total`` against
   exchanges x ``halo_bytes_per_round``.  A 2x2 grid on one card measures
   the exchange's correctness and its host cost, not a wire between
   cards.
4. The int8 score kernel against its plain version on the fitted index
   at the top serving bucket (1024 users), with the same times and bound
   and the ``"dequant"`` method's time; and at every other bucket
   (``by_bucket``: B = 16, 64, 256, users drawn the same way), each with
   its graph time and replay range, eager and plain times, bound, profiler
   breakdown (its kernel name gives the tile shape picked) and error, held
   to 0; at every bucket a ``torch._int_mm`` yardstick on the same codes
   (B = 16 padded to 32 rows, which ``_int_mm`` needs, and sliced); beside
   them, at each bucket, the
   first kernel through its own C entry (``first_ms``, held to 0), the
   host's µs per call of the wrapper and of both C entries (``host_us``),
   and the time of ``fill_`` on the same output (``store_floor_ms``: what
   writing those bytes alone costs); and at the top bucket the kernel's
   time against seeded catalogs of 3704, 3706 and 3712 items
   (``catalog_alignment_ms``: output rows on and off the 16-byte grid).
5. ``[serve]``: ``quantize_index`` of the sparse FullGD fit's index ->
   ``ServingEngine(quant="int8")`` with buckets (16, 64, 256, 1024) ->
   ~200 requests of 1-3000 users -> ``refresh`` from the dense FullGD fit
   -> 50 more requests; then an f32 engine over the same requests.
   Checks: int8 codes and scales equal the CPU's bitwise, the kernel
   launched once per bucket run (startup included), its launches by batch
   size (``dequant_score.by_batch``, printed on the int8 line) add up to
   that and match the ladder's plan bucket by bucket,
   ``serve_compiles_total`` stays 4, every answer equals ``recommend_topk``
   on the same index, overlap@100 of int8 against f32 >= 0.95.  Prints
   per-bucket latency for both layouts and the index bytes.
6. ``[lm]``: gemma2-2b serving at full width and depth (26 layers, d_model
   2304, f32 parameters from a seeded generator, bf16 KV cache).  First
   the flash kernel against its plain version at the path's shapes (q
   (4, 8, 8000, 256), k/v (4, 4, 8000, 256)): one global call (causal,
   softcap 50), one local call (window 4096), both at rtol 2e-4 / atol
   2e-5, one (b, h) slice of the global call against float64 (the
   kernel's error at most 4x the plain version's + 1e-7), and a bf16 call
   at max abs error 5e-2, with times, two bounds (3xTF32 on the tensor
   cores and f32 on the CUDA cores) and an SDPA yardstick (no softcap,
   explicit mask).  Then a warm-up
   ``generate`` (batch 1, 256 tokens, 2 new), then ``build_model`` ->
   ``init`` -> ``ServeLoop(max_len=8192).generate`` of 32 greedy tokens
   after 4 prompts of 8000 tokens (numpy seed 13).  Checks: 26 flash
   launches (one per attention sublayer of the prefill, none in decode),
   finite logits, output (4, 32); then the same prefill through the plain
   attention (``Ctx(attn_impl="ref")``) agrees within 1e-3 x max|logit|
   and gives the same first token wherever the top-2 margin exceeds that.
   Prints prefill and decode times, tokens/s and peak device memory.

``[train]`` (after ``[lm]``, whose model is freed first): gemma2-2b
training on the card through ``make_train_step`` (``Ctx(attn_impl="ref",
remat=True)``: the flash kernel has no backward, so this path launches no
kernel, which the phase checks).  a. Full width and depth (26 layers,
2.61 B seeded f32 parameters), ``train_4k``'s 4096 tokens a sequence,
4 sequences a step as ``microbatch=4`` of one, AdamW from ``TrainConfig``'s
defaults, three steps on ``LMTokenPipeline``'s batches (the first a
warm-up, the last under ``torch.profiler``): s/step, tokens/s, peak device
memory (gated below 80 GB), the device busy share and the top kernels, the
operations a step against the f32 rate; every loss finite.  b. Full width,
depth one unit (2 sublayers, 0.75 B parameters): remat on and off within
``REMAT_TOL`` of each gradient leaf's max; ``microbatch=4`` against one
pass over the same 4 sequences (loss, gradients and an SGD step within
``MICRO_TOL``); <grad L, d> in float64 against the central difference
along a seeded unit direction at 256 tokens (relative error below
``F64_GRAD_TOL``); three AdamW steps on one repeated batch lower its loss.
c. Gossip data-parallel training (``train/gossip_dp.py``) on a ring of
four ``gloo`` ranks sharing the card, one unit at full width, 8 sequences
of 512 tokens a step (2 a rank), SGD with momentum at lr 1e-2, 5 steps,
against ``make_train_step`` on the global batch in this process (the
reference's gate, ``tests/test_distributed.py``: consensus error below
0.05, the final loss within 15%); staleness 2 and int8 messages too, each
with its consensus error, ms per exchange and bytes per exchange.

``[moe]`` (after ``[train]``): the MoE family at full width and depth.
First the flash kernel against its plain version at both archs' prefill
shapes, causal with no window and no softcap: granite-moe's q (4, 24,
4000, 64) with k/v (4, 8, 4000, 64) (GQA groups of 3) and MLA's q/k (4,
16, 4000, 192) with v (4, 16, 4000, 128); each at rtol 2e-4 / atol 2e-5,
one (b, h) slice against float64, a bf16 call at 5e-2, its CUDA-graph and
eager times, the plain version's, the 3xTF32 and f32 bounds, and SDPA's
time (here SDPA computes the same function).  Then granite-moe-3b-a800m
(32 layers, 40 experts top-8, 3.3 B seeded f32 parameters) and
deepseek-v2-lite-16b (27 layers, layer 0 dense, MLA with kv_lora 512, 64
routed experts top-6 and 2 shared, 15.7 B parameters), each through
``build_model`` -> ``init`` -> ``ServeLoop(max_len=4096).generate`` of 32
greedy tokens after 4 prompts of 4000 tokens (numpy seed 13).  Checks:
one flash launch a layer in the prefill and none in decode, finite
logits, output (4, 32).  Prints prefill s, tokens/s, decode ms a step,
the host reads of the expert run lengths a step, peak memory, the device
busy share, launches and top kernels of one prefill and one decode step
under the profiler, each expert's share of the prefill's slots, and the
latent cache's bytes beside a (k, v) cache of the same heads.  Then the
plain-attention model on the same prompts, with every router call
recorded: routing flips against the kernel model counted (at each row's
first flip the gap between the k-th and (k+1)-th probability at most
``ROUTE_MARGIN``, at most ``FLIP_SHARE`` of all choices flipped), the
last-position logits within 1e-3 x max|logit| on the rows whose routing
agreed, and again for all rows with the plain model routed as the kernel
model was (its own weights at those experts), with the same first token
wherever the top-2 margin exceeds that; peak memory below the card's.

``[ssm]`` (after ``[moe]``, whose models are freed first): the SSM family
and the hybrid at full width and depth.  First the flash kernel against
its plain version at zamba2-2.7b's prefill shape, q/k/v (4, 32, 3840,
80), causal, no window, no softcap (the Dv <= 128 instantiation at a head
dim that is not a power of two), with the same gates, times, bounds and
SDPA yardstick as ``[moe]``'s.  Then one mamba2 layer's scan at full
width, ``ssd_chunked`` against the sequential ``ssd_reference`` at (1,
1024, 48, 64), d_state 128, chunk 256, at ``tests/test_moe_ssm.py``'s
rtol/atol 1e-4.  Then mamba2-780m (48 layers, d_model 1536, 48 SSM heads
of 64, d_state 128; 0.86 B seeded f32 parameters) and zamba2-2.7b (54
Mamba2 layers, d_model 2560, one shared attention block of 32 heads of 80
invoked 9 times; 2.54 B parameters, ``lora_b`` drawn N(0, 0.1^2) from the
seed, since its zero init would leave the LoRA deltas unexercised), each
through ``build_model`` -> ``init`` -> ``ServeLoop(max_len=4096)
.generate`` of 32 greedy tokens after 4 prompts of 3840 tokens (numpy
seed 13).  Checks: mamba2 launches no kernel at all (its path has no TPU
kernel), zamba2 9 flash launches in the prefill and none in decode;
finite logits, output (4, 32); continuation: a prefill of 3584 tokens and
256 decode steps over the rest of the prompt give last-position logits
within 1e-3 x max|logit| of the generate's prefill of 3840 (with a float32
cache, as ``tests/test_models_consistency.py`` holds JAX's); for zamba2
the plain-attention model on the same parameters agrees within 1e-3 x
max|logit| and gives the same first token wherever the top-2 margin
exceeds that; peak memory below the card's.  Prints prefill s, tokens/s,
decode ms a step, the launches, busy share and top kernels of one prefill
and one decode step under the profiler, peak memory, and the cache's
bytes beside a bf16 (k, v) cache of as many layers of the same width at
3840 tokens.

``[encdec]`` (after ``[ssm]``, whose models are freed first): the
encoder-decoder family.  First the flash kernel against its plain version
at whisper-large-v3's two new attention shapes, both non-causal with no
window and no softcap: the encoder's q/k/v (8, 20, 1500, 64) (the last
32-key tile partial) and the cross-attention's q (8, 20, 224, 64) against
k/v (8, 20, 1500, 64); each with ``[moe]``'s gates, times, bounds and SDPA
yardstick.  Then whisper-large-v3 at full width and depth (32 encoder and
32 decoder layers, d_model 1280, 20 heads of 64, 1.60 B seeded f32
parameters, bf16 cache) through ``build_model`` -> ``init`` ->
``ServeLoop(max_len=448).generate`` of 32 greedy tokens: 8 clips of stub
frames (8, 1500, 1280) (numpy seed 13), which stand for 30 s of audio each
after the conv front end the JAX package stubs, and prompts of 224 tokens,
which stand for Whisper's previous-text conditioning within its 448-token
decoder context.  Checks: 96 flash launches in the prefill (32 encoder, 32
decoder-self, 32 cross) and none in decode, finite logits, output (8, 32);
continuation: a prefill of the first 192 tokens and 32 decode steps give
last-position logits within 1e-3 x max|logit| of the generate's prefill
(float32 cache); the plain-attention model agrees within 1e-3 x
max|logit| with the same first token wherever the top-2 margin exceeds
that; peak memory below the card's.  Prints the encoder's and the
prefill's seconds, decoder tokens/s, decode ms a step, the launches, busy
share and top kernels of one prefill and one decode step, peak memory and
the cache's bytes, self and cross.

``[vlm]`` (after ``[encdec]``): the VLM family.  First the flash kernel at
internvl2-76b's prefill shape, q (4, 64, 2048, 128) and k/v (4, 8, 2048,
128), causal, GQA groups of 8, as above.  Then internvl2-76b at full width
(d_model 8192, 64 heads of 128 over 8 KV heads, d_ff 28672, vocab
128,256) and **8 of its 80 layers**: its 70.6 B f32 parameters (282.5 GB)
do not fit one card, the 8 layers with the embedding, ``lm_head`` and
projector are 36.1 GB, and full depth waits for sharded serving.  4
requests, each of 256 stub patch tokens (4, 256, 1024) (numpy seed 13),
which stand for one 448-px image tile after InternViT (stubbed in the JAX
package), and 1792 text tokens: 2048 fused positions;
``ServeLoop(max_len=2080).generate`` of 32 greedy tokens at absolute
positions after the patches.  Checks as ``[encdec]``'s (8 flash launches
in the prefill; the continuation from patches + 1760 tokens).  Also
prints fused tokens/s and the decode's HBM bound: the bytes of the
weights a step multiplies by (~31.6 GB in f32) and of the live (k, v),
over the card's rate, against the measured step.

``[tp]`` (last): tensor-parallel serving of the same VLM cell.  The flash
kernel at a rank's shape (row 5h: q (4, 16, 2048, 128), k/v (4, 2, 2048,
128), causal, GQA 8) against its plain version, float64 and SDPA.  Then
the reference run in this process: internvl2-76b at 8 of 80 layers from
``train/shard.py::init_shard`` at ``model = 1`` through
``launch/lm_engine.py``'s ``make_prefill_step``/``make_serve_step``: a
prefill of 4 x (256 patches + 1792 tokens) into ``max_len`` 2080, then
32 greedy tokens (8 flash launches).  Then the same on 4 ranks of
``run_on_grid`` (``gloo`` on one card, the collectives staged through
the host; ``nccl`` with a card a rank), each from its own
``init_shard`` at ``model = 4``, fed the reference's tokens: every
step's logits within 1e-3 x max|logit| of the reference's, the greedy
tokens equal wherever its top-2 margin exceeds that bound, 8 flash
launches a rank.  Prints prefill s and decode ms a step of both runs,
the all-reduce and all-gather share of the prefill and of a decode step
(the prefill and 8 decode steps run again, rank 0 synchronising the card
around each collective; the times reported are the untimed run's), each
rank's peak memory and bytes of shards and
cache, and the per-rank bytes of the four-rank full-depth model
reckoned from its specs (``train/shard.py::shard_nbytes``) beside
``param_count``.

``[stream]`` (after ``[gossip]``): the streaming loop at the Table 3
cell through ``launch/streaming.py``: 85% of the training ratings
ingested with the headroom of the stream's largest per-block count; the
append sweep (batches of 100, 1000, 10000, repeated as
``benchmarks/streaming_ingest.py`` repeats them; the base store must be
unchanged after it); the cell's 800 FullGD rounds on the base, the rest
appended, ``Trainer.refit`` (``Incremental``: 40 Wave rounds) and a cold
800-round fit, with their held-out RMSE and wall seconds (gated: costs
finite, the refit's cost falling; the reference's RMSE gate is printed,
not gated); the segment kernel on the spliced store against its plain
version and bitwise against a fresh ingest of the union at the same
capacity; an int8 engine bound with ``RefreshPolicy(max_appends=60000)``
and a seen headroom sized from the data, fed the stream in batches of
10000 through ``append`` + ``note_append`` while a second thread sends
requests (2 policy refreshes, ``serve_compiles_total`` unchanged, every
answer equal to the index live at submit or the one swapped in while it
ran); ``Gossip(batch=8192)`` for 200 rounds on the 5x5 cell and on a 2x2
grid of the 4x4 cut against its 1x1 run (the grid's tolerance above),
the segment kernel on a (5, 5) minibatch and a rank's (2, 2) minibatch
tile; and an append and refit of exp3 on the dense layout.

``[faults]`` (after ``[stream]``): fault injection, staleness gates,
asynchronous rounds, self-healing and resume through ``Trainer.fit`` and
``Gossip`` on one 2x2 grid of four gloo processes on the card
(``launch/gossip.py``), at the ML-1M cell cut 4x4 (sparse/segment, r =
15), 300 rounds a job, eval every 100: a clean fit, first and again
last; ``FaultPlan(p=0)`` bitwise it; ``p_drop_edge`` 0.05 and 0.2 x ``max_staleness`` 1 and 3,
and ``p_straggle`` 0.05, their observed drops and straggles equal to
``FaultPlan.replay`` masked to existing edges; ``async_rounds`` with
``exchange_every`` 1, 2, 4 (``max_staleness`` e - 1), full-gradient and
with ``batch=8192``, the skipped exchanges and halo bytes exact and e = 1
bitwise the synchronous fit; ``nan_at=150`` with ``Checkpoint(every=1)``,
eval every 50 and ``RecoveryPolicy()``: one restart, from unit 150 or
earlier, the cost finite and below the restored checkpoint's after it; a
fit stopped by ``StopAt`` after its second checkpoint and resumed with
``resume_from=``, bitwise the clean fit; exp1 dense clean, p = 0 and
async e = 1, bitwise.  Each job prints its held-out RMSE,
``rmse_vs_clean``, the counters and ms per round.  Then a 1x1 Wave fit of
the Table 3 cell stopped and resumed, bitwise.  ``[main]``'s 800-round
FullGD fit runs under ``Telemetry()`` inside ``obs.trace``: the trace must
hold a ``fit.full`` slice and CUDA kernel events, ``train_units_total``
must be 800.

``[sharded]`` (after ``[serve]``): the sharded session on one 2x2 grid
of four gloo processes on the card (``sharded_rank``), each part closed
by a barrier.  a. The ML-1M cell cut 4x4: 10,000 training ratings held
back, the rest ingested owner-routed (``CompletionProblem.from_entries(
plan=)``, ``sparse.ShardedEntries.from_coo``) and by the global
pack-and-slice, per-rank seconds of both, the tiles bitwise; 300
``Gossip`` rounds on each store from one state, bitwise;
``f_grads_sharded`` against the tile of the 1x1 gradients (1e-5); the
held-back ratings appended owner-routed, bitwise the tile of
``append_entries``.  b. The Netflix Prize shape (480,189 x 17,770) with
10,000,000 seeded distinct ratings in 1-5 on 8x8 blocks (the public
set's 100,480,507 cut to the run's time): routed against global ingest,
per-rank seconds, the tiles bitwise.  c. ``FitResult.to_engine()`` on
every rank of an 800-round ML-1M 4x4 ``Gossip`` fit, int8 and f32,
``[serve]``'s ~250 requests with a hot refresh between them to 100
more rounds fitted on the grid while the engines serve the first 200
(``launch/serve_recommend.serve_fit_rank``): rank 0's
answers against the unsharded engine on the same fits (items exactly;
int8 scores bitwise, f32 within 1e-5), p50/p99 by bucket of both.  d.
The ``PRODUCTION`` catalog (m = n = 2^20, r = 64; seeded factors, 100
seen items a user) served by the int8 grid engine (262,144 items a
shard) at every bucket, k = 10, 512 users bitwise the unsharded int8
path; the bytes each rank holds and its peak.  Then, in this process,
the segment kernel on a Netflix-shape rank tile and ``dequant_score`` at
B = 256 against a PRODUCTION shard (n = 262,144, r = 64) against their
plain versions (with bound, ``torch._int_mm`` yardstick), and the
ordered top-k on the fit's masked scores at (1024, 3706) against the
int64-key selection of every row it replaced (the same positions) and a
bare ``torch.topk``.

``[measure]`` (after ``[sharded]``): the paper workload's instruments on
the card.  ``launch/serving_traffic.py``'s replay of one seeded Poisson
tape (200 requests at 200/s) through an f32 and an int8 ``ServingEngine``
on ``[main]``'s index (buckets 16-1024, k = 100), failing below
overlap@100 0.99, and its method sweep (median and spread of 50 CUDA-event
timed full queries a method at B = 1024), beside the method ``method=None``
resolves from the committed ``kernels/quant/method_sweep.json``;
``launch/sparse_vs_dense.py``'s density sweep at the Table 3 shape (6040 x
3706, 5x5, r = 15; densities 0.01, 0.02, 0.0357, 0.1, 0.2), failing where
a sparse engine's ∇L or cost differs from the dense one's by more than
1e-5 relative; ``launch/gossip_comm.py --measure`` on a 2x2 grid of gloo
ranks on the card; and ``launch/roofline_bench.py``'s records, printed
beside ``[main]``'s and ``[gossip]``'s ms a round and, after ``[tp]``,
beside its prefill and decode times.

The launch counts of the ``{"kernels": ...}`` line add up the main
path's phases, ``[table2]``, ``[gossip]`` (the grid's ranks included),
``[stream]``, ``[faults]`` (the ranks' by stack shape in
``faults_launches_by_stack``), ``[serve]``, ``[sharded]`` (the ranks'),
``[measure]`` (the ranks' included), ``[lm]``, ``[moe]``, ``[ssm]``, ``[encdec]``, ``[vlm]`` and ``[tp]`` (the
flash row's ``moe``, ``ssm``, ``encdec``, ``vlm`` and ``tp`` keys have
those phases' numbers; ``[tp]``'s are the reference run's and every
rank's); ``[train]`` launches none.

The configuration is the paper's Table 3 cell at MovieLens-1M scale
(``benchmarks/table3_rmse.py --full``): the 6040x3706 ``movielens_proxy``
with 1M ratings (800k for training), a 5x5 grid, rank 15, mean-centred,
rho=1e3, lam=1e-6, a=2e-4, b=5e-7; random initial factors from seed 0.

The LM cell is gemma2-2b (``repro_torch/configs/gemma2_2b.py``) as
``examples/serve_lm.py`` serves it, at its published widths and depth;
8000-token prompts leave room for the 32 new tokens in Gemma 2's context
of 8192, exceed the local window and fit no tile exactly.  Its training
cell is ``launch/train.py``'s ``train_4k`` sequence length with 4
sequences a step (the shape's global batch of 256 cut to what one card
holds beside f32 AdamW state).  The MoE cells are the two archs'
published configs (``repro_torch/configs/``), 4000-token prompts with the
32 new tokens inside Granite 3.0's context of 4096.  The SSM cells are
mamba2-780m's and zamba2-2.7b's configs with 3840-token prompts: the
largest multiple of the 256-token chunk that leaves room for 32 new tokens
in a max_len of 4096, so that every prefill takes the chunked scan, as the
reference would (a length off the chunk grid runs the sequential scan, one
Python step a token and a layer).  The encoder-decoder cell is
whisper-large-v3's config (``repro_torch/configs/whisper_large_v3.py``)
at its published widths and depth, 8 clips a batch; the VLM cell is
internvl2-76b's config at its published widths, its depth cut to 8 of 80
layers by one card's memory.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the ``{"kernels": [...]}`` summary, and the line before that the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.config import (  # noqa: E402
    GossipMCConfig,
    MeshConfig,
    ShapeConfig,
    TrainConfig,
    get_model_config,
)
from repro_torch.configs.gossip_mc import EXPERIMENTS, PRODUCTION  # noqa: E402
from repro_torch.core import gossip as core_gossip  # noqa: E402
from repro_torch.core import grid as G  # noqa: E402
from repro_torch.core.state import State, build_tables, init_state  # noqa: E402
from repro_torch.data import (  # noqa: E402
    LMTokenPipeline,
    lowrank_problem,
    movielens_proxy,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref,
)
from repro_torch.kernels.masked_factor_grad import ops as mfg_ops  # noqa: E402
from repro_torch.kernels.masked_factor_grad.ref import (  # noqa: E402
    masked_factor_grad_ref,
)
from repro_torch.kernels.quant import ops as quant_ops  # noqa: E402
from repro_torch.kernels.quant.ref import (  # noqa: E402
    dequant_score_ref,
    fused_score_ref,
)
from repro_torch.kernels.sddmm import ops as sddmm_ops  # noqa: E402
from repro_torch.kernels.sddmm.ref import sddmm_factor_grad_ref  # noqa: E402
from repro_torch.kernels.sddmm.segment import (  # noqa: E402
    sddmm_segment_grad_ref,
)
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.faults import (  # noqa: E402
    FaultPlan,
    RecoveryPolicy,
    edges_exist,
)
from repro_torch.mc import (  # noqa: E402
    Callback,
    Checkpoint,
    CompletionProblem,
    FitResult,
    FullGD,
    Gossip,
    Sequential,
    Telemetry,
    Trainer,
    Wave,
)
from repro_torch import obs  # noqa: E402
from repro_torch.launch import paper_tables  # noqa: E402
from repro_torch.launch.gossip import (  # noqa: E402
    FitJob,
    FitStopped,
    ProblemRecipe,
    StopAt,
    fit_on_grid,
    pick_backend,
    run_on_grid,
)
from repro_torch.launch.gossip_async import check_skips  # noqa: E402
from repro_torch.launch.gossip_faults import expected_drops  # noqa: E402
from repro_torch.launch.gossip import shutdown as shutdown_grids  # noqa: E402
from repro_torch.launch import streaming  # noqa: E402
from repro_torch.launch import gossip_comm  # noqa: E402
from repro_torch.launch import roofline_bench  # noqa: E402
from repro_torch.launch import serving_traffic  # noqa: E402
from repro_torch.launch import sparse_vs_dense  # noqa: E402
from repro_torch.kernels.quant import autotune as quant_autotune  # noqa: E402
from repro_torch.roofline import analyze_record  # noqa: E402
from repro_torch.launch.lm_engine import (  # noqa: E402
    ServeLoop,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.launch.serve_recommend import (  # noqa: E402
    ServeJob,
    collective_floor,
    serve_fit_rank,
    serve_requests,
)
from repro_torch.mesh import MeshPlan  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402
from repro_torch.models import encdec as encdec_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.models.transformer import _index  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import (  # noqa: E402
    make_eval_step,
    make_gossip_dp_step,
    make_train_step,
    rank_consensus_error,
)
from repro_torch.train import sharding as shard_rules  # noqa: E402
from repro_torch.train.shard import init_shard, shard_nbytes  # noqa: E402
from repro_torch.train.step import loss_and_grads, split_batch  # noqa: E402
from repro_torch.serve.quant import index_nbytes, quantize_index  # noqa: E402
from repro_torch.serve.recommend import (  # noqa: E402
    RecommendIndex,
    _keyed_topk,
    build_seen_table_coo,
    recommend_topk,
    topk_ordered,
)
from repro_torch.serving import (  # noqa: E402
    DEFAULT_BUCKETS,
    BucketLadder,
    RefreshPolicy,
    ServingEngine,
)
from repro_torch.sparse import store as sparse_store  # noqa: E402
from repro_torch.sparse.objective import f_grads_sparse  # noqa: E402
from repro_torch.sparse.sharded import (  # noqa: E402
    ShardedEntries,
    f_grads_sharded,
)
from repro_torch.sparse.store import MinibatchStream  # noqa: E402

P = Q = 5
RANK = 15
PHASES = ("kernels", "main", "table2", "gossip", "stream", "faults",
          "serve", "sharded", "measure", "lm", "train", "moe", "ssm",
          "encdec", "vlm", "tp")
NEEDS = {"serve": ("main",), "sharded": ("main",), "measure": ("main",)}
LM_PHASES = ("lm", "moe", "ssm", "encdec", "vlm", "tp")
CFG = dict(rho=1e3, lam=1e-6, a=2.0e-4, b=5.0e-7)
FULL_ROUNDS = 800   # the Table 3 cell's rounds (benchmarks/table3_rmse.py)
COMPARE_ROUNDS = 40  # sparse and dense FullGD are compared at this round
TOL = 1e-5          # |kernel - plain| <= TOL * (|plain| + max|plain|)
STATE_RTOL = 1e-4   # sparse vs dense FullGD after COMPARE_ROUNDS rounds
# [gossip]: rounds of the 1x1 runs and of the 2x2 grids, and the 2x2
# grid's tolerance against 1x1, tests/test_distributed.py's own
GOSSIP_ROUNDS, GRID_ROUNDS = 200, 300
GRID_U_ATOL, GRID_COST_RTOL = 1e-5, 1e-4
GRID = (2, 2)
# the ML-1M cell cut 4x4, which tiles the 2x2 rank grid
ML_4X4 = ProblemRecipe("movielens_proxy", {}, p=4, q=4, rank=RANK,
                       layout="sparse", mean_center=True)
# [stream]: the benchmark's held-back share and append batches
# (benchmarks/streaming_ingest.py), the engine's append batch and policy,
# minibatch gossip's batch and rounds
STREAM_FRAC, STREAM_BATCHES = 0.15, (100, 1000, 10000)
ENGINE_BATCH, POLICY_APPENDS = 10_000, 60_000
MB_BATCH, MB_ROUNDS = 8192, 200
# [table2] --paper: a converged cost may move by float32 rounding between
# checkpoints, no more
FLOOR_RTOL = 1e-5
# [faults]: rounds and eval interval of each grid job; the drop x
# staleness-bound sweep and the straggle case (benchmarks/gossip_faults.py's
# cells); the async exchange intervals (benchmarks/gossip_async.py's, and
# e = 1); the one-shot NaN round and its eval interval; the 1x1 Wave fit
# stopped after its second checkpoint and resumed
FAULT_ROUNDS, FAULT_EVAL = 300, 100
FAULT_DROPS, FAULT_BOUNDS, FAULT_STRAGGLE = (0.05, 0.2), (1, 3), 0.05
ASYNC_EVERY = (1, 2, 4)
NAN_AT, NAN_EVAL = 150, 50
WAVE_ROUNDS, WAVE_EVAL = 30, 10
# [sharded]: the ratings appended owner-routed at the ML-1M 4x4 cell; the
# Netflix Prize shape with its 100,480,507 ratings cut to 10M (the run's
# time limit) on 8x8 blocks; the grid engine's refresh fit (rounds past
# FULL_ROUNDS); the PRODUCTION catalog's seen items a user, requests a
# bucket, users compared with the unsharded path, k, and the score
# kernel's timed batch
SHARD_APPEND = 10_000
NETFLIX = dict(m=480_189, n=17_770, ratings=10_000_000, p=8, q=8)
SHARD_REFIT = 100
PROD_SEEN, PROD_REQUESTS, PROD_COMPARE, PROD_K = 100, 20, 512, 10
PROD_SCORE_B = 256

WRAPPERS = {
    "sddmm_segment_grad": sddmm_ops.sddmm_segment_grad,
    "sddmm_factor_grad": sddmm_ops.sddmm_factor_grad,
    "masked_factor_grad": mfg_ops.masked_factor_grad,
    "dequant_score": quant_ops.dequant_score,
    "flash_attention": flash_ops.flash_attention,
}
# wrappers that also count their launches by stack shape
STACKED = (sddmm_ops.sddmm_segment_grad, mfg_ops.masked_factor_grad)
META = {
    "sddmm_segment_grad": ("src/repro_torch/kernels/csrc/sddmm.cu",
                           "src/repro/kernels/sddmm/segment_kernel.py:113"),
    "sddmm_factor_grad": ("src/repro_torch/kernels/csrc/sddmm.cu",
                          "src/repro/kernels/sddmm/kernel.py:82"),
    "masked_factor_grad": (
        "src/repro_torch/kernels/csrc/masked_factor_grad.cu",
        "src/repro/kernels/masked_factor_grad/kernel.py:75"),
    "dequant_score": ("src/repro_torch/kernels/csrc/dequant_score.cu",
                      "src/repro/kernels/quant/kernel.py:48"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:106"),
}
# (HBM bytes/s, f32 non-tensor flop/s, int8 tensor-core op/s, TF32
# tensor-core flop/s): NVIDIA data sheets, dense rates
PEAKS = {"PCIe": (2.0e12, 51e12, 1513e12, 378e12),
         "NVL": (3.9e12, 60e12, 1671e12, 417e12),
         "H100": (3.35e12, 67e12, 1979e12, 495e12)}
TOP_BUCKET = DEFAULT_BUCKETS[-1]
OVERLAP_MIN = 0.95  # overlap@100 of int8 against f32 top-k on the fit
LM_ARCH = "gemma2-2b"
LM_BATCH, LM_PROMPT, LM_NEW, LM_MAX_LEN = 4, 8000, 32, 8192
# the JAX package's own tolerances (tests/test_kernel_flash_attention.py)
FLASH_RTOL, FLASH_ATOL, FLASH_BF16_ABS = 2e-4, 2e-5, 5e-2
# the kernel's f32 products are three TF32 products (3xTF32): against a
# float64 attention its error stays within F64_FACTOR x the plain f32
# version's + F64_SLACK, which one TF32 or bf16 pass would not
TF32_PASSES, F64_FACTOR, F64_SLACK = 3, 4.0, 1e-7
LOGIT_TOL = 1e-3    # kernel vs plain model: |diff| <= LOGIT_TOL * max|logit|
# [train]: train_4k's seq_len, 4 sequences a step as microbatch=4 of one
TRAIN_SEQ, TRAIN_SEQS, TRAIN_STEPS = 4096, 4, 3
GATE_SEQ, F64_SEQ, F64_EPS = 512, 256, 1e-3
REMAT_TOL = 1e-6      # remat on vs off: rel to each gradient leaf's max
MICRO_TOL = 1e-5      # microbatch=4 vs one pass: loss and leaves, relative
F64_GRAD_TOL = 1e-6   # float64 <grad L, d> vs central difference, relative
DP_WORKERS, DP_SEQ, DP_BATCH, DP_STEPS = 4, 512, 8, 5
DP_TRAIN = dict(optimizer="sgd", learning_rate=1e-2, warmup_steps=0,
                total_steps=100, max_grad_norm=0.0)
DP_CASES = {"staleness1": dict(staleness=1, compression="none"),
            "staleness2": dict(staleness=2, compression="none"),
            "int8": dict(staleness=1, compression="int8")}
DP_CERR, DP_LOSS = 0.05, 0.15   # tests/test_distributed.py's gossip-DP gate
# [moe]: both MoE archs at full width and depth; 4 prompts of 4000 tokens
# and 32 new tokens in Granite 3.0's context of 4096
MOE_ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")
MOE_BATCH, MOE_PROMPT, MOE_NEW, MOE_MAX_LEN = 4, 4000, 32, 4096
# routing, kernel model against plain-attention model: at a row's first
# flip every flipped token's gap between the k-th and (k+1)-th router
# probability must be at most ROUTE_MARGIN (the two attentions differ by
# ~1e-6 a layer, compounded over up to 32 layers; the CPU tests hold 1e-5
# at 3 layers), and at most FLIP_SHARE of the (layer, token) choices may
# differ in all (a flipped token's later layers flip with it)
ROUTE_MARGIN, FLIP_SHARE = 1e-4, 1e-2
# [ssm]: mamba2-780m and zamba2-2.7b at full width and depth; 4 prompts of
# 3840 tokens, the largest multiple of the 256-token chunk that leaves room
# for the 32 new tokens in max_len 4096 (a prompt off the chunk grid runs
# the sequential scan, a Python step a token and a layer)
SSM_ARCHS = ("mamba2-780m", "zamba2-2.7b")
SSM_BATCH, SSM_PROMPT, SSM_NEW, SSM_MAX_LEN = 4, 3840, 32, 4096
SSM_SPLIT = 3584      # continuation: a prefill of 14 chunks + 256 decodes
SSM_WARM = 512        # warm-up prompt: 2 chunks, the chunked scan
# one mamba2 layer's scan: (b, L, h, p, n, chunk)
SSD_SHAPE = (1, 1024, 48, 64, 128, 256)
SSD_TOL = 1e-4        # tests/test_moe_ssm.py's rtol/atol
SSD_F64_TOL = 1e-9    # chunked vs sequential in float64, x max|y|
LORA_B_STD = 0.1      # zamba2's lora_b, zero at init, drawn N(0, 0.1^2)
# [encdec]: whisper-large-v3 at full width and depth; 8 clips of 1500 stub
# frames (30 s of audio each after the conv front end), prompts of 224
# tokens (previous-text conditioning) and 32 new ones within Whisper's
# 448-token decoder context
ENCDEC_ARCH = "whisper-large-v3"
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_NEW, ENCDEC_MAX_LEN = 8, 224, 32, 448
ENCDEC_SPLIT = 192    # continuation: a prefill of 192 tokens + 32 decodes
# [vlm]: internvl2-76b at full width and 8 of its 80 layers (70.6 B f32
# parameters, 282.5 GB, are more than one card holds: full depth needs
# sharded serving); 4 requests of one 448-px image tile (256 stub patch
# tokens) and 1792 text tokens, 2048 fused positions, 32 new tokens
VLM_ARCH, VLM_LAYERS = "internvl2-76b", 8
VLM_BATCH, VLM_PROMPT, VLM_NEW, VLM_MAX_LEN = 4, 1792, 32, 2080
VLM_SPLIT = 1760      # continuation: patches + 1760 tokens + 32 decodes
# [tp]: the [vlm] cell on 4 tensor-parallel ranks (the model axis of the
# JAX package's mesh), each holding 16 query and 2 KV heads; decode steps
# timed with the collectives synchronised on rank 0
TP_RANKS, TP_SEED, TP_TIMED_STEPS = 4, 0, 8
# [measure]: the traffic tape, the density sweep, the gossip_comm grid
MEASURE_REQUESTS, MEASURE_RATE, MEASURE_K = 200, 200.0, 100
MEASURE_SHAPE = (6040, 3706)         # the Table 3 cell's matrix
MEASURE_DENSITIES = (0.01, 0.02, 0.0357, 0.1, 0.2)
MEASURE_ITERS, MEASURE_ROUNDS = 10, 30
MEASURE_RTOL = 1e-5   # sparse engines' ∇L and cost against the dense one's
# ms a round and step times the roofline lines stand beside
MEASURED: dict = {}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def peaks(name: str) -> tuple[float, float, float, float]:
    for key in ("PCIe", "NVL", "H100"):
        if key in name:
            return PEAKS[key]
    fail(f"no peak rates known for {name!r}")


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    for fn in STACKED:
        fn.by_stack.clear()
    quant_ops.dequant_score.by_batch.clear()
    quant_ops.dequant_score.by_kernel.clear()


def counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def graph_ms(fn, calls: int = 10, reps: int = 25) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA
    graph, the graph replayed ``reps`` times between CUDA events; the
    median replay over ``calls``."""

    return statistics.median(graph_replays_ms(fn, calls, reps))


def graph_replays_ms(fn, calls: int = 10, reps: int = 25) -> list[float]:
    """Each of ``graph_ms``'s ``reps`` replays, over ``calls``."""

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return times


def eager_ms(fn, reps: int = 25) -> float:
    """Time of one eager ``fn()`` as a caller sees it (host launch cost
    included): median over ``reps`` calls between CUDA events."""

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _kernel_ms(prof, calls: int, seen=None) -> dict[str, float]:
    """Device ms per call of each kernel name; ``seen``, when given, gets
    the launches the profiler recorded of each."""

    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0.0)
        if us > 0:
            # "void (anonymous namespace)::segment_kernel<16>(int const*, ..."
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0].strip() or "other"
            out[name] = out.get(name, 0.0) + us / calls / 1e3
            if seen is not None:
                seen[name] = seen.get(name, 0) + ev.count
    return out


def profiled(fn, seen=None):
    """One ``fn()`` under ``torch.profiler`` (CUPTI): its result, the host
    seconds it took (ended by a synchronize) and the device ms of each CUDA
    kernel it launched (``seen``: see ``_kernel_ms``)."""

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return out, seconds, _kernel_ms(prof, 1, seen)


def top(breakdown: dict[str, float], n: int = 8) -> str:
    total = sum(breakdown.values())
    rows = sorted(breakdown.items(), key=lambda kv: -kv[1])[:n]
    return f"total {total:.3f} ms; " + "; ".join(
        f"{name[:60]} {ms:.3f} ms ({100 * ms / total:.1f}%)"
        for name, ms in rows)


def device_breakdown(fn, calls: int = 5, seen=None) -> dict[str, float]:
    """Device ms per call of each CUDA kernel ``fn`` launches, from
    ``torch.profiler`` (CUPTI) over ``calls`` calls (``seen``: see
    ``_kernel_ms``)."""

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return _kernel_ms(prof, calls, seen)


def compare(got, want) -> tuple[float, float]:
    """(max abs error, max error / (|plain| + max|plain|)) over outputs."""

    abs_err, rel_err = 0.0, 0.0
    for g, w in zip(got, want):
        d = (g.double() - w.double()).abs()
        scale = float(w.abs().max())
        abs_err = max(abs_err, float(d.max()))
        rel_err = max(rel_err, float((d / (w.double().abs() + scale
                                           + 1e-30)).max()))
    return abs_err, rel_err


def measure(kern, plain, nbytes, ops, card):
    """Error, times and bound of one kernel call against its plain
    version on the same inputs."""

    bw, flops, _, _ = peaks(card)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    abs_err, rel_err = compare(got, want)
    t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
    replays, seen = graph_replays_ms(kern), {}
    return {
        "max_abs_err": abs_err, "max_rel_err": rel_err,
        "ms": statistics.median(replays),
        "ms_range": [min(replays), max(replays)], "plain_ms": graph_ms(plain),
        "eager_ms": eager_ms(kern), "plain_eager_ms": eager_ms(plain),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "operations": ops,
        "device_breakdown_ms": device_breakdown(kern, seen=seen),
        "device_launches_seen": seen,   # over 5 calls
    }


def dense_f64(X, Mk, U, W):
    """(loss, gU, gW) of the dense f-gradient in float64."""

    X, Mk, U, W = (t.double() for t in (X, Mk, U, W))
    R = Mk * (X - U @ W.mT)
    return (R * R).sum((-2, -1)), -2.0 * R @ W, -2.0 * R.mT @ U


def sparse_f64(ent, U, W):
    """(loss, gU, gW) of the sparse f-gradient in float64, by
    scatter-adds over the padded-COO entries."""

    lead, (M, r), N = U.shape[:-2], U.shape[-2:], W.shape[-2]
    B = U.numel() // (M * r)
    U, W = U.double().reshape(B, M, r), W.double().reshape(B, N, r)
    rows = ent.rows.reshape(B, -1, 1).long().expand(-1, -1, r)
    cols = ent.cols.reshape(B, -1, 1).long().expand(-1, -1, r)
    ue, we = U.gather(1, rows), W.gather(1, cols)
    e = ent.valid.reshape(B, -1).double() * (
        ent.vals.reshape(B, -1).double() - (ue * we).sum(-1))
    d = -2.0 * e.unsqueeze(-1)
    gu = torch.zeros_like(U).scatter_add_(1, rows, d * we)
    gw = torch.zeros_like(W).scatter_add_(1, cols, d * ue)
    return ((e * e).sum(-1).reshape(lead), gu.reshape(*lead, M, r),
            gw.reshape(*lead, N, r))


def shape_check(label, name, kern, plain, exact, work, card, shape) -> dict:
    """A kernel against its plain version at one more shape its path
    gives it, both also against ``exact`` (the same function in float64):
    errors, graph-replay times of both and the bound from ``work`` =
    (bytes, operations).  Fails unless the kernel is within TOL of its
    plain version or, where the two differ by more (long f32 sums whose
    result cancels, as at a fitted state), within TOL of float64."""

    bw, flops, _, _ = peaks(card)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    abs_err, rel_err = compare(got, want)
    ref = exact()
    plain_f64, kern_f64 = compare(want, ref)[1], compare(got, ref)[1]
    t_bytes, t_ops = work[0] / bw * 1e3, work[1] / flops * 1e3
    out = {"phase": label, "shape": shape, "max_abs_err": abs_err,
           "max_rel_err": rel_err, "kernel_f64_rel_err": kern_f64,
           "plain_f64_rel_err": plain_f64, "tolerance": TOL,
           "ms": graph_ms(kern), "plain_ms": graph_ms(plain),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"[{label.split()[0]}] {name} against its plain version, "
          f"{label}: {json.dumps(out)}", flush=True)
    if not min(rel_err, kern_f64) <= TOL:
        fail(f"{name} at {label}: max error {rel_err:.3e} against its plain "
             f"version and {kern_f64:.3e} against float64, both > "
             f"{TOL:.0e}")
    return out


def dense_check(label, X, Mk, U, W, card) -> dict:
    """``shape_check`` of the dense kernel on (X, mask, U, W)."""

    return shape_check(
        label, "masked_factor_grad",
        lambda: mfg_ops.masked_factor_grad(X, Mk, U, W),
        lambda: masked_factor_grad_ref(X, Mk, U, W),
        lambda: dense_f64(X, Mk, U, W), dense_work(U, W), card,
        {"lead": list(U.shape[:-2]), "mb": U.shape[-2], "nb": W.shape[-2],
         "r": U.shape[-1]})


def segment_check(label, ent, U, W, card) -> dict:
    """``shape_check`` of the segment kernel on (entries, U, W)."""

    nnz = int(ent.valid.sum())
    factor_bytes, ops, B, M, N, r = sparse_work(ent, U, W, nnz)
    return shape_check(
        label, "sddmm_segment_grad",
        lambda: sddmm_ops.sddmm_segment_grad(ent, U, W),
        lambda: sddmm_segment_grad_ref(ent, U, W),
        lambda: sparse_f64(ent, U, W),
        (nnz * 5 * 4 + 4 * B * (M + N + 2) + factor_bytes, ops), card,
        {"lead": list(U.shape[:-2]), "mb": M, "nb": N, "r": r,
         "E": ent.capacity, "nnz": nnz})


def sparse_work(ent, U, W, nnz):
    """(bytes, operations) of one sparse f-gradient call: each real
    entry's index and value words, the factors in, the gradients and the
    loss out; about 6r + 4 flops an entry."""

    B = U.numel() // (U.shape[-2] * U.shape[-1])
    M, N, r = U.shape[-2], W.shape[-2], U.shape[-1]
    factor_bytes = 2 * 4 * B * (M + N) * r + 4 * B   # U, W in; gU, gW, loss out
    return factor_bytes, nnz * (6 * r + 4), B, M, N, r


def dense_work(U, W):
    """(bytes, operations) of one dense f-gradient call: X and mask read
    once, the factors in, the gradients and the loss out; 6r + 4 flops a
    matrix entry."""

    factor_bytes, _, B, M, N, r = sparse_work(None, U, W, 0)
    return 2 * 4 * B * M * N + factor_bytes, B * M * N * (6 * r + 4)


def kernel_phase(sparse, dense, state, card):
    """Each kernel against its plain version on the main path's stack; the
    segment and dense kernels also on one Sequential structure's three
    blocks."""

    ent, U, W = sparse.data.entries, state.U, state.W
    X, Mk = dense.data.xb, dense.data.maskb
    E = ent.capacity
    nnz = int(sparse.data.nnz.sum())
    factor_bytes, sparse_ops, B, M, N, r = sparse_work(ent, U, W, nnz)
    work = {
        "sddmm_segment_grad": (
            lambda: sddmm_ops.sddmm_segment_grad(ent, U, W),
            lambda: sddmm_segment_grad_ref(ent, U, W),
            nnz * 5 * 4 + 4 * B * (M + N + 2) + factor_bytes, sparse_ops),
        "sddmm_factor_grad": (
            lambda: sddmm_ops.sddmm_factor_grad(ent, U, W),
            lambda: sddmm_factor_grad_ref(ent, U, W),
            nnz * 4 * 4 + factor_bytes, sparse_ops),
        "masked_factor_grad": (
            lambda: mfg_ops.masked_factor_grad(X, Mk, U, W),
            lambda: masked_factor_grad_ref(X, Mk, U, W), *dense_work(U, W)),
    }
    rows = []
    for name, (kern, plain, nbytes, ops) in work.items():
        row = {"name": name, "route": "cuda", "source": META[name][0],
               "replaces": META[name][1], "launches": 0, "tolerance": TOL,
               **measure(kern, plain, nbytes, ops, card),
               "library_ms": None,
               "shape": {"blocks": B, "mb": M, "nb": N, "r": r, "E": E,
                         "nnz": nnz}}
        if name == "sddmm_factor_grad":
            row.update(scatter_extras(ent, U, W, plain()))
        row.update(structure_trio(name, sparse, dense, state, card))
        print(json.dumps(row), flush=True)
        for key in ("max_rel_err", "max_rel_err_b3"):
            if key in row and not row[key] <= TOL:
                fail(f"{name} disagrees with its plain version ({key}): "
                     f"max error {row[key]:.3e} > {TOL:.0e}")
        rows.append(row)
    return rows


def scatter_first(ent, U, W):
    """A callable that runs the first scatter design through its own C
    entry, ``sddmm_factor_grad_first``, on the wrapper's inputs, into
    outputs of its own; it returns (loss, gU, gW)."""

    lib = _build.load("sddmm")
    lead, (M, r), N = U.shape[:-2], U.shape[-2:], W.shape[-2]
    B, E = U.numel() // (M * r), ent.capacity
    loss = torch.empty(lead, dtype=torch.float32, device="cuda")
    gu, gw = torch.empty_like(U), torch.empty_like(W)
    partials = torch.empty((B, lib.sddmm_num_partials(B, E, r)),
                           dtype=torch.float32, device="cuda")
    ptrs = [t.data_ptr() for t in (ent.rows, ent.cols, ent.vals, ent.valid,
                                   U, W, loss, gu, gw, partials)]

    def run():
        rc = lib.sddmm_factor_grad_first(
            *ptrs, B, E, M, N, r, torch.cuda.current_stream().cuda_stream)
        _build.check("sddmm_factor_grad_first", rc)
        return loss, gu, gw
    return run


def scatter_extras(ent, U, W, want):
    """On the scatter kernel's inputs: the cluster size its C entry picks;
    the first design through ``sddmm_factor_grad_first`` (``first_ms``,
    its error held to TOL); and the same entries in a seeded random order
    within each block, padding slots interleaved (``ms_permuted``, error
    held to TOL): the kernel's any-order contract at the path's size."""

    lib = _build.load("sddmm")
    M, r, N = U.shape[-2], U.shape[-1], W.shape[-2]
    B = U.numel() // (M * r)
    first = scatter_first(ent, U, W)
    first_err = compare(first(), want)[1]
    rng = np.random.default_rng(3)
    E = ent.capacity
    perm = torch.as_tensor(np.stack([rng.permutation(E) for _ in range(B)])
                           .reshape(*ent.rows.shape[:-1], E), device="cuda")
    shuffled = type(ent)(*(torch.take_along_dim(f, perm, -1) for f in (
        ent.rows, ent.cols, ent.vals, ent.valid)))
    kern = lambda: sddmm_ops.sddmm_factor_grad(shuffled, U, W)  # noqa: E731
    perm_err = compare(kern(), want)[1]
    out = {"cluster_size": lib.sddmm_cluster_size(B, M, N, r),
           "first_ms": graph_ms(first), "first_max_rel_err": first_err,
           "ms_permuted": graph_ms(kern),
           "max_rel_err_permuted": perm_err}
    for key in ("first_max_rel_err", "max_rel_err_permuted"):
        if not out[key] <= TOL:
            fail(f"sddmm_factor_grad ({key}) at B = {B}: max error "
                 f"{out[key]:.3e} > {TOL:.0e}")
    return out


def structure_trio(name, sparse, dense, state, card):
    """A kernel on the three blocks of Sequential's structure 0, gathered
    as ``sgd_structure_step`` gathers them; keys end in ``_b3``.  The
    scatter kernel's also include ``scatter_extras`` there."""

    tables = build_tables(P, Q, G.enumerate_structures(P, Q), "cuda")
    idx = tables.blocks[0].long()
    bi, bj = idx[:, 0], idx[:, 1]
    U, W = state.U[bi, bj], state.W[bi, bj]
    nnz = int(sparse.data.nnz[bi, bj].sum())
    if name == "sddmm_segment_grad":
        ent = sparse.data.entries.gather(bi, bj)
        factor_bytes, ops, B, M, N, _ = sparse_work(ent, U, W, nnz)
        got = measure(lambda: sddmm_ops.sddmm_segment_grad(ent, U, W),
                      lambda: sddmm_segment_grad_ref(ent, U, W),
                      nnz * 5 * 4 + 4 * B * (M + N + 2) + factor_bytes, ops,
                      card)
    elif name == "sddmm_factor_grad":
        ent = sparse.data.entries.gather(bi, bj)
        factor_bytes, ops, B, M, N, _ = sparse_work(ent, U, W, nnz)
        plain = lambda: sddmm_factor_grad_ref(ent, U, W)  # noqa: E731
        got = measure(lambda: sddmm_ops.sddmm_factor_grad(ent, U, W), plain,
                      nnz * 4 * 4 + factor_bytes, ops, card)
        got.update(scatter_extras(ent, U, W, plain()))
    else:
        X, Mk = dense.data.xb[bi, bj], dense.data.maskb[bi, bj]
        B = len(idx)
        got = measure(lambda: mfg_ops.masked_factor_grad(X, Mk, U, W),
                      lambda: masked_factor_grad_ref(X, Mk, U, W),
                      *dense_work(U, W), card)
    got["shape"] = {"blocks": B, "structure": idx.tolist(), "nnz": nnz}
    return {f"{key}_b3": val for key, val in got.items()}


def trace_check(trace_dir) -> None:
    """The traced Table 3 fit: Telemetry's counts, and a Chrome trace that
    holds the ``fit.full`` span and CUDA kernel events."""

    snap = obs.snapshot()
    units = snap["counters"].get("train_units_total")
    fit_s = snap["histograms"].get("train_fit_seconds", {}).get("sum")
    with open(os.path.join(trace_dir, obs.spans.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    shutil.rmtree(trace_dir, ignore_errors=True)
    fit_slices = sum(1 for e in events if e.get("name") == "fit.full")
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"[main] FullGD sparse/segment under Telemetry() in obs.trace: "
          f"train_units_total {units}, train_evals_total "
          f"{snap['counters'].get('train_evals_total')}, train_fit_seconds "
          f"{fit_s}; the trace holds {len(events)} events, {fit_slices} "
          f"fit.full slices, {kernels} CUDA kernel events (the fit's "
          f"ms/round above includes the profiler)", flush=True)
    if units != FULL_ROUNDS or not fit_s:
        fail(f"Telemetry: train_units_total {units}, train_fit_seconds "
             f"{fit_s}")
    if not fit_slices or not kernels:
        fail(f"the trace holds {fit_slices} fit.full slices and {kernels} "
             "kernel events")


def run_phase(label, expect, fit):
    """Drive one phase of the main path with the counters at 0; fail
    unless each kernel in ``expect`` launched."""

    reset_counts()
    t0 = time.perf_counter()
    result = fit()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = counts()
    by_stack = {fn.__name__: {"x".join(map(str, lead)): n for lead, n in
                              fn.by_stack.items()} for fn in STACKED}
    costs = [c for _, c in result.history]
    print(f"[main] {label}: t={result.t} costs={costs} "
          f"wall={seconds:.3f}s launches={got} "
          f"launches by stack={by_stack}", flush=True)
    if not np.isfinite(costs).all():
        fail(f"{label}: non-finite cost {costs}")
    for name in expect:
        if got[name] == 0:
            fail(f"{label}: {name} was never launched")
    return result, got


def check_topk(index, users, items, scores, k):
    """Top-k against a float64 host reference, where scores have no ties."""

    u = index.u.double().cpu().numpy()[users]
    w = index.w.double().cpu().numpy()
    ref = u @ w.T
    seen = index.seen.cpu().numpy()[users]
    for b in range(len(users)):
        s = seen[b][seen[b] < w.shape[0]]
        ref[b, s] = -np.inf
    order = np.argsort(-ref, axis=1)[:, :k]
    top = np.take_along_axis(ref, order, 1)
    tie_free = (np.abs(np.diff(top, axis=1)) > 1e-6).all(axis=1)
    if tie_free.sum() < len(users) // 2:
        fail("top-k check: too few tie-free users")
    if not np.array_equal(items.cpu().numpy()[tie_free], order[tie_free]):
        fail("recommend_topk disagrees with the host reference")
    if not np.allclose(scores.double().cpu().numpy(), top, rtol=1e-4,
                       atol=1e-4):
        fail("recommend_topk scores disagree with the host reference")
    return int(tie_free.sum())


def score_timing(args, card):
    """The int8 score kernel against its plain version on one batch: error
    (must be 0), times, replay range, device breakdown and bound."""

    bw, _, int8_ops, _ = peaks(card)
    uq, wq = args[0], args[2]
    B, r = uq.shape
    n = wq.shape[0]
    kern = lambda: quant_ops.dequant_score(*args, method="fused")  # noqa: E731
    plain = lambda: fused_score_ref(*args)                         # noqa: E731
    got, want = kern(), plain()
    torch.cuda.synchronize()
    abs_err = float((got.double() - want.double()).abs().max())
    nbytes = B * r + 4 * B + n * r + 4 * n + 4 * B * n
    ops = 2 * B * n * r
    t_bytes, t_ops = nbytes / bw * 1e3, ops / int8_ops * 1e3
    replays = graph_replays_ms(kern)
    timing = {
        "max_abs_err": abs_err, "ms": statistics.median(replays),
        "ms_range": [min(replays), max(replays)], "plain_ms": graph_ms(plain),
        "eager_ms": eager_ms(kern), "plain_eager_ms": eager_ms(plain),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "operations": ops,
        "device_breakdown_ms": device_breakdown(kern),
        "shape": {"B": B, "n": n, "r": r},
    }
    if abs_err != 0.0:
        fail(f"dequant_score disagrees with its plain version at B = {B}: "
             f"max abs error {abs_err:.3e}, tolerance 0")
    timing.update(first_kernel_and_host(args, want))
    timing.update(int_mm_yardstick(args, want))
    return timing


def int_mm_yardstick(args, want):
    """``torch._int_mm`` + the same epilogue on the same codes, a yardstick
    the port never calls: cuBLASLt's int8 GEMM on the codes zero-padded to
    r -> a multiple of 16 and n -> a multiple of 8 and, at 16 users or
    fewer (``_int_mm`` takes more than 16 rows), to 32 users, the padding
    sliced off.  Its graph ms, whether it equals the plain version bitwise,
    and the rows it ran (``library_rows``)."""

    uq, us, wq, ws = args
    B, r = uq.shape
    n = wq.shape[0]
    bp, rp, np_ = B if B > 16 else 32, -(-r // 16) * 16, -(-n // 8) * 8
    uq_p = torch.zeros((bp, rp), dtype=torch.int8, device="cuda")
    wq_p = torch.zeros((np_, rp), dtype=torch.int8, device="cuda")
    uq_p[:B, :r], wq_p[:n, :r] = uq, wq

    def library():
        acc = torch._int_mm(uq_p, wq_p.T)[:B, :n]
        return acc.float() * us[:, None] * ws[None, :]

    try:
        equal = bool(torch.equal(library(), want))
        ms, error = graph_ms(library), None
    except RuntimeError as err:
        equal, ms, error = None, None, str(err)[:200]
    return {"library_ms": ms, "library_call": "torch._int_mm + epilogue",
            "library_equal": equal, "library_error": error,
            "library_rows": bp}


def first_kernel_and_host(args, want):
    """On the same inputs: the first, byte-staged kernel (which
    ``dequant_score`` runs for r > 64) through its own C entry
    ``dequant_score_first``, held bitwise to the plain version, and its
    graph ms (``first_ms``); ``host_us``, the host's µs per call of the
    wrapper, of the C entry ``dequant_score`` and of ``dequant_score_first``
    (wall time of ``calls`` calls queued back to back, the three in turn
    ``rounds`` times, the median round of each); and ``store_floor_ms``,
    the graph ms of ``fill_`` on the same (B, n) f32 output, a PyTorch call
    that writes the same bytes and computes nothing."""

    lib = _build.load("dequant_score")
    uq, us, wq, ws = args
    B, r = uq.shape
    n = wq.shape[0]
    out = torch.empty((B, n), dtype=torch.float32, device="cuda")

    def entry(name):
        fn = getattr(lib, name)

        def run():
            rc = fn(uq.data_ptr(), us.data_ptr(), wq.data_ptr(),
                    ws.data_ptr(), out.data_ptr(), B, n, r,
                    torch.cuda.current_stream().cuda_stream)
            if rc < quant_ops.FIRST_KERNEL:     # else the kernel that ran
                _build.check(name, rc)
            return out
        return run

    first = entry("dequant_score_first")
    first()
    torch.cuda.synchronize()
    err = float((out.double() - want.double()).abs().max())
    if err != 0.0:
        fail(f"dequant_score_first disagrees with the plain version at "
             f"B = {B}: max abs error {err:.3e}")
    first_ms = graph_ms(first)
    host = {"wrapper": lambda: quant_ops.dequant_score(*args, method="fused"),
            "entry": entry("dequant_score"), "first_entry": first}
    calls, rounds = 200, 5
    times = {label: [] for label in host}
    for _ in range(rounds):
        for label, fn in host.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            times[label].append((t1 - t0) / calls * 1e6)
    return {"first_ms": first_ms, "first_max_abs_err": err,
            "host_us": {k: statistics.median(v) for k, v in times.items()},
            "store_floor_ms": graph_ms(lambda: out.fill_(0.0))}


def catalog_alignment(B, r, seed=17):
    """Graph ms of ``dequant_score`` at B users of rank r against seeded
    random catalogs of n = 3704, 3706 and 3712 items, each held bitwise to
    the plain version: at the cell's 3706 every other output row starts 8
    bytes off the 16-byte grid, at 3704 and 3712 every row starts on it."""

    rng = np.random.default_rng(seed)
    times = {}
    for n in (3704, 3706, 3712):
        args = [torch.from_numpy(a).to("cuda") for a in (
            rng.integers(-127, 128, size=(B, r)).astype(np.int8),
            rng.lognormal(-3.0, 1.0, size=B).astype(np.float32),
            rng.integers(-127, 128, size=(n, r)).astype(np.int8),
            rng.lognormal(-3.0, 1.0, size=n).astype(np.float32))]
        kern = lambda: quant_ops.dequant_score(*args, method="fused")  # noqa: E731
        if not torch.equal(kern(), fused_score_ref(*args)):
            fail(f"dequant_score disagrees with its plain version at B = {B}, "
                 f"n = {n}")
        times[n] = graph_ms(kern)
    return times


def quant_kernel_row(qidx, users, card):
    """The int8 score kernel against its plain version on the fitted index
    at every serving bucket (the top bucket's numbers at the row's top
    level, the others under ``by_bucket``): error (must be 0), times,
    bound, the ``torch._int_mm`` yardstick; at the top bucket also the
    dequant method's time."""

    def batch(size):
        sel = users[:size]
        return (qidx.u_q[sel].contiguous(), qidx.u_scale[sel].contiguous(),
                qidx.w_q, qidx.w_scale)

    args = batch(TOP_BUCKET)
    B, r = args[0].shape
    row = {
        "name": "dequant_score", "route": "cuda",
        "source": META["dequant_score"][0],
        "replaces": META["dequant_score"][1], "launches": 0,
        "tolerance": 0.0, **score_timing(args, card),
        "dequant_method_ms": graph_ms(lambda: dequant_score_ref(*args)),
        "catalog_alignment_ms": catalog_alignment(B, r),
        "by_bucket": {b: score_timing(batch(b), card)
                      for b in DEFAULT_BUCKETS if b != TOP_BUCKET},
    }
    print(json.dumps(row), flush=True)
    return row


def chunks(ladder, requests) -> int:
    return sum(len(ladder.plan(len(x))) for x in requests)


def check_answers(label, ladder, requests, answers, index, k, method,
                  exact):
    """Each engine answer against ``recommend_topk`` on the same index and
    the same padded chunks: scores bitwise (``exact``) or to 1e-6, items
    on rows whose k+1 top scores have no ties."""

    checked = 0
    for users, (items, scores) in zip(requests, answers):
        for start, length, bucket in ladder.plan(len(users)):
            chunk = np.pad(users[start:start + length], (0, bucket - length))
            ri, rs = recommend_topk(index, chunk, k=k + 1, method=method)
            ri, rs = ri.cpu().numpy()[:length], rs.cpu().numpy()[:length]
            got_i = items[start:start + length]
            got_s = scores[start:start + length]
            if exact:
                ok = np.array_equal(got_s, rs[:, :k])
            else:
                ok = np.allclose(got_s, rs[:, :k], rtol=1e-6, atol=1e-6)
            tie_free = (np.diff(rs, axis=1) != 0).all(axis=1)
            if not ok or not np.array_equal(got_i[tie_free],
                                            ri[tie_free, :k]):
                fail(f"{label}: engine answer differs from recommend_topk "
                     f"(request of {len(users)} users, chunk at {start})")
            checked += int(tie_free.sum())
    return checked


def serve_engine(label, index, refresh_from, before, after, k, expect_q):
    """One engine over ``before``, a refresh, then ``after``; prints its
    latencies and returns both lists of answers, the launch counts and the
    engine's scoring method."""

    obs.reset()
    reset_counts()
    t0 = time.perf_counter()
    # the kernel, whatever the committed method sweep picks for method=None
    eng = ServingEngine(index, buckets=DEFAULT_BUCKETS, k=k,
                        quant_method="fused")
    startup = time.perf_counter() - t0
    with eng:
        if eng.quant != expect_q:
            fail(f"{label}: engine layout {eng.quant}, expected {expect_q}")
        compiles = [obs.counter("serve_compiles_total").value]
        t0 = time.perf_counter()
        first = [f.result(timeout=120) for f in
                 [eng.submit(x) for x in before]]
        t_first = time.perf_counter() - t0
        compiles.append(obs.counter("serve_compiles_total").value)
        eng.refresh(refresh_from)
        second = [f.result(timeout=120) for f in
                  [eng.submit(x) for x in after]]
        compiles.append(obs.counter("serve_compiles_total").value)
        got = counts()
        by_batch = dict(sorted(quant_ops.dequant_score.by_batch.items()))
        metrics = eng.metrics()
        method = eng.quant_method
    if compiles != [len(DEFAULT_BUCKETS)] * 3:
        fail(f"{label}: serve_compiles_total went {compiles}, expected "
             f"{len(DEFAULT_BUCKETS)} throughout")
    users = sum(len(x) for x in before)
    print(f"[serve] {label}: startup {startup:.3f}s, {len(before)} requests "
          f"({users} users) in {t_first:.3f}s = {users / t_first:.0f} "
          f"users/s, then refresh and {len(after)} requests; "
          f"compiles {compiles}; launches {got}; dequant_score launches by "
          f"batch {by_batch}", flush=True)
    for b in DEFAULT_BUCKETS:
        h = metrics["buckets"][b]
        print(f"[serve] {label} bucket {b}: count={h['count']} "
              f"p50={1e3 * h['p50']:.3f}ms p99={1e3 * h['p99']:.3f}ms "
              f"mean={1e3 * h['mean']:.3f}ms min={1e3 * h['min']:.3f}ms "
              f"max={1e3 * h['max']:.3f}ms", flush=True)
    lat = metrics["latency"]
    print(f"[serve] {label} request: p50={1e3 * lat['p50']:.3f}ms "
          f"p99={1e3 * lat['p99']:.3f}ms (queue wait included)", flush=True)
    return first, second, got, by_batch, method


def serve_phase(fit_a, fit_b):
    """The int8 serving path end to end, then the f32 engine over the same
    requests."""

    k = 10
    rng = np.random.default_rng(11)
    index_a = fit_a.to_recommend_index()
    m = index_a.num_users
    before = serve_requests(rng, 200, m)
    after = serve_requests(rng, 50, m)
    qidx = quantize_index(index_a)
    q_host = quantize_index(index_a._replace(
        u=index_a.u.cpu(), w=index_a.w.cpu(), seen=index_a.seen.cpu()))
    for name in ("u_q", "u_scale", "w_q", "w_scale"):
        if not torch.equal(getattr(qidx, name).cpu(), getattr(q_host, name)):
            fail(f"[serve] quantize_index on the card differs from the CPU "
                 f"in {name}")
    print("[serve] quantize_index: codes and scales on the card equal the "
          "CPU's bitwise", flush=True)
    ladder = BucketLadder(DEFAULT_BUCKETS)
    first, second, got, by_batch, method = serve_engine(
        "int8", qidx, fit_b, before, after, k, "int8")
    expect = len(DEFAULT_BUCKETS) + chunks(ladder, before + after)
    if got["dequant_score"] != expect:
        fail(f"[serve] dequant_score launched {got['dequant_score']} times, "
             f"expected {expect} (startup runs + bucket executions)")
    if sum(by_batch.values()) != got["dequant_score"]:
        fail(f"[serve] dequant_score launches by batch {by_batch} do not add "
             f"up to its {got['dequant_score']} launches")
    want_by_batch = dict.fromkeys(DEFAULT_BUCKETS, 1)       # startup runs
    for x in before + after:
        for _, _, bucket in ladder.plan(len(x)):
            want_by_batch[bucket] += 1
    if by_batch != want_by_batch:
        fail(f"[serve] dequant_score launches by batch {by_batch}, expected "
             f"{want_by_batch} from the ladder's plan")
    qidx_b = quantize_index(fit_b.to_recommend_index())
    n1 = check_answers("int8", ladder, before, first, qidx, k, method, True)
    n2 = check_answers("int8 refreshed", ladder, after, second, qidx_b, k,
                       method, True)
    print(f"[serve] int8 ({method}): every answer equals recommend_topk on "
          f"the same quantized index (scores bitwise, items on {n1 + n2} "
          f"tie-free "
          f"rows); dequant_score launches {got['dequant_score']} = "
          f"{len(DEFAULT_BUCKETS)} startup + "
          f"{expect - len(DEFAULT_BUCKETS)} bucket runs",
          flush=True)

    first_f, second_f, got_f, _, _ = serve_engine("f32", index_a, fit_b,
                                               before, after, k, None)
    if got_f["dequant_score"] != 0:
        fail("[serve] the f32 engine launched the int8 kernel")
    check_answers("f32", ladder, before, first_f, index_a, k, None, False)
    check_answers("f32 refreshed", ladder, after, second_f,
                  fit_b.to_recommend_index(), k, None, False)

    users = np.arange(m)
    overlaps = []
    for s in range(0, m, TOP_BUCKET):
        i_f, _ = recommend_topk(index_a, users[s:s + TOP_BUCKET], k=100)
        i_q, _ = recommend_topk(qidx, users[s:s + TOP_BUCKET], k=100)
        for a, b in zip(i_f.cpu().numpy(), i_q.cpu().numpy()):
            overlaps.append(len(set(a.tolist()) & set(b.tolist())) / 100)
    overlap = float(np.mean(overlaps))
    nb_f, nb_q = index_nbytes(index_a), index_nbytes(qidx)
    print(f"[serve] overlap@100 int8 vs f32 over all {m} users: "
          f"{overlap:.4f} (gate {OVERLAP_MIN}); index bytes f32 {nb_f}, "
          f"int8 {nb_q} ({nb_q / nb_f:.4f}x)", flush=True)
    if not overlap >= OVERLAP_MIN:
        fail(f"[serve] overlap@100 {overlap:.4f} < {OVERLAP_MIN}")

    # where the time of one top-bucket execution goes, on the device
    chunk = torch.as_tensor(before[9][:TOP_BUCKET], device="cuda")
    for label, idx in (("int8", qidx), ("f32", index_a)):
        bd = device_breakdown(lambda: recommend_topk(idx, chunk, k=k))
        print(f"[serve] {label} bucket {TOP_BUCKET} device ms by kernel "
              f"({sum(bd.values()):.4f} in all): {json.dumps(bd)}",
              flush=True)
    return got["dequant_score"]


def live_pairs(L: int, window: int) -> int:
    """Unmasked (q, k) pairs of one causal head of length L."""

    i = np.arange(L, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    return int((i - lo + 1).sum())


def f64_check(q, k, v, got, want, softcap, b=LM_BATCH - 1, h=7,
              tag="[lm]", causal=True):
    """Max abs error of the kernel's and the plain version's (b, h) slice
    of a layer (causal unless ``causal`` is false, softcapped when
    ``softcap``) against the same attention in float64; fails the run when
    the kernel's exceeds F64_FACTOR x the plain version's + F64_SLACK."""

    L, D = q.shape[2], q.shape[3]
    kvh = h // (q.shape[1] // k.shape[1])
    qd, kd, vd = q[b, h].double(), k[b, kvh].double(), v[b, kvh].double()
    logits = qd @ kd.T / D ** 0.5                        # 512 MB at L = 8000
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    if causal:
        pos = torch.arange(L, device=q.device)
        logits.masked_fill_(pos[:, None] < pos[None, :], float("-inf"))
    ref = torch.softmax(logits, -1) @ vd
    del logits
    err = float((got[b, h].double() - ref).abs().max())
    err_plain = float((want[b, h].double() - ref).abs().max())
    limit = F64_FACTOR * err_plain + F64_SLACK
    print(f"{tag} flash f64 check, slice (b={b}, h={h}) of (L={L}, D={D}): "
          f"kernel max abs error {err:.3e}, plain {err_plain:.3e}, limit "
          f"{F64_FACTOR:g} x plain + {F64_SLACK:g} = {limit:.3e}", flush=True)
    if not err <= limit:
        fail(f"flash_attention is not f32-accurate: max abs error {err:.3e} "
             f"against float64 exceeds {limit:.3e}")
    return {"f64_max_abs_err": err, "plain_f64_max_abs_err": err_plain}


def flash_row(card):
    """The flash kernel against its plain version at the [lm] path's
    shapes: the global and the local layer of gemma2-2b's prefill in f32
    (the global one also against float64), then one bf16 call; times,
    bounds and the SDPA yardstick."""

    bw, flops, _, tf32 = peaks(card)
    B, Hq, Hkv, L, D = LM_BATCH, 8, 4, LM_PROMPT, 256
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = (torch.randn(shape, generator=g, device="cuda")
               for shape in ((B, Hq, L, D), (B, Hkv, L, D), (B, Hkv, L, D)))
    nbytes = 4 * (2 * q.numel() + 2 * k.numel())   # q, k, v in; o out
    layers = {}
    for label, window in (("global", 0), ("local", 4096)):
        kw = dict(causal=True, softcap=50.0, window=window)
        kern = lambda: flash_ops.flash_attention(q, k, v, **kw)  # noqa: E731
        plain = lambda: attention_ref(q, k, v, **kw)             # noqa: E731
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs()
        abs_err = float(err.max())
        ok = bool((err <= FLASH_ATOL + FLASH_RTOL * want.abs()).all())
        del err
        f64 = (f64_check(q, k, v, got, want, kw["softcap"])
               if label == "global" else {})
        del got, want
        ops = 4 * D * live_pairs(L, window) * B * Hq
        # the least time for the same f32-accurate work: 3xTF32 on the
        # tensor cores or f32 on the CUDA cores, whichever is quicker
        t_bytes = nbytes / bw * 1e3
        t_f32, t_tc = ops / flops * 1e3, TF32_PASSES * ops / tf32 * 1e3
        t_ops = min(t_f32, t_tc)
        layers[label] = {
            "ms": eager_ms(kern, reps=7), "plain_ms": eager_ms(plain, reps=5),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_f32_cuda_core_ms": max(t_bytes, t_f32),
            "operations": ops, "bytes": nbytes, "max_abs_err": abs_err,
            **f64}
        print(f"[lm] flash {label}: {json.dumps(layers[label])}", flush=True)
        if not ok:
            fail(f"flash_attention {label} layer disagrees with its plain "
                 f"version beyond rtol {FLASH_RTOL} / atol {FLASH_ATOL} "
                 f"(max abs error {abs_err:.3e})")

    # yardstick only, never called by the port: SDPA in f32 on the local
    # layer's inputs with an explicit causal-and-window mask and no softcap
    # (no single PyTorch call computes the softcapped function); K/V are
    # repeated to Hq heads beforehand
    pos = torch.arange(L, device="cuda")
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :]
                                             < 4096)
    kr, vr = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (k, v))
    library_ms = eager_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kr, vr, attn_mask=mask), reps=5)
    del kr, vr, mask

    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    got = flash_ops.flash_attention(qb, kb, vb, causal=True, softcap=50.0)
    want = attention_ref(qb, kb, vb, causal=True, softcap=50.0)
    torch.cuda.synchronize()
    bf16_err = float((got.float() - want.float()).abs().max())
    del got, want, qb, kb, vb, q, k, v
    torch.cuda.empty_cache()
    print(f"[lm] flash bf16 global: max abs error {bf16_err:.3e} "
          f"(limit {FLASH_BF16_ABS})", flush=True)
    if not bf16_err < FLASH_BF16_ABS:
        fail(f"flash_attention bf16 max abs error {bf16_err:.3e} >= "
             f"{FLASH_BF16_ABS}")

    local = layers["local"]
    row = {
        "name": "flash_attention", "route": "cuda",
        "source": META["flash_attention"][0],
        "replaces": META["flash_attention"][1], "launches": 0,
        "max_abs_err": max(x["max_abs_err"] for x in layers.values()),
        "tolerance": {"rtol": FLASH_RTOL, "atol": FLASH_ATOL},
        "ms": local["ms"], "plain_ms": local["plain_ms"],
        "bound_ms": local["bound_ms"], "bound_by": local["bound_by"],
        "bound_f32_cuda_core_ms": local["bound_f32_cuda_core_ms"],
        "operations": local["operations"], "bytes": local["bytes"],
        "timing": "eager: median of single calls between CUDA events",
        "row_layer": "local (window 4096); global below",
        "library_ms": library_ms,
        "library_call": "scaled_dot_product_attention f32, explicit causal "
                        "+ window bool mask, no softcap, K/V repeated to Hq",
        "global": layers["global"], "bf16_max_abs_err": bf16_err,
        "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "L": L, "D": D},
    }
    print(json.dumps(row), flush=True)
    return row


def timed(fn, log):
    """``fn`` with each call's seconds (host clock, ended by a
    synchronize) and logits recorded in ``log``."""

    def call(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = fn(*args)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0, logits))
        return logits, cache

    return call


def lm_phase(card):
    """gemma2-2b serving on the card: ``ServeLoop.generate`` through the
    flash kernel, then the same prefill through the plain attention."""

    row = flash_row(card)
    cfg = get_model_config(LM_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, Ctx(attn_impl="kernel"))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"[lm] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n_params} parameters in {cfg.param_dtype}, init "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    prompts = np.random.default_rng(13).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))

    ServeLoop(model, params, 1, LM_MAX_LEN).generate(
        {"tokens": prompts[:1, :256]}, 2)                # warm-up
    torch.cuda.synchronize()

    pre, dec = [], []
    spy = model._replace(prefill=timed(model.prefill, pre),
                         decode=timed(model.decode, dec))
    loop = ServeLoop(spy, params, LM_BATCH, LM_MAX_LEN)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = loop.generate({"tokens": prompts}, LM_NEW)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    if got["flash_attention"] != cfg.num_layers:
        fail(f"[lm] flash_attention launched {got['flash_attention']} "
             f"times, expected {cfg.num_layers} (one per prefill sublayer)")
    if tuple(out.shape) != (LM_BATCH, LM_NEW):
        fail(f"[lm] generate gave shape {tuple(out.shape)}")
    if not all(bool(torch.isfinite(lg).all()) for _, lg in pre + dec):
        fail("[lm] non-finite logits")
    t_pre = pre[0][0]
    t_dec = sum(s for s, _ in dec)
    print(f"[lm] generate: prefill {t_pre:.3f}s "
          f"({LM_BATCH * LM_PROMPT / t_pre:.0f} prompt tokens/s), decode "
          f"{1e3 * t_dec / len(dec):.3f} ms/step over {len(dec)} steps "
          f"({LM_BATCH * len(dec) / t_dec:.1f} generated tokens/s), total "
          f"{total:.3f}s ({LM_BATCH * LM_NEW / total:.1f} tokens/s); "
          f"launches {got}; peak device memory {peak / 2**30:.2f} GiB",
          flush=True)
    print(f"[lm] first row: {out[0].tolist()}", flush=True)

    # where the device time of one prefill and one decode step goes
    batch = {"tokens": prompts}
    with torch.inference_mode():
        (_, cache), s_pre, bd_pre = profiled(
            lambda: model.prefill(params, batch, LM_MAX_LEN))
        tok = torch.zeros(LM_BATCH, dtype=torch.int32, device="cuda")
        _, s_dec, bd_dec = profiled(
            lambda: model.decode(params, cache, tok, LM_PROMPT))
    del cache
    for label, secs, bd in (("prefill", s_pre, bd_pre),
                            ("decode step", s_dec, bd_dec)):
        busy = sum(bd.values()) / (1e3 * secs)
        print(f"[lm] {label} under the profiler: wall {1e3 * secs:.3f} ms, "
              f"device busy {100 * busy:.1f}%; by kernel: {top(bd)}",
              flush=True)

    lk = pre[0][1].float()
    ref = build_model(cfg, Ctx(attn_impl="ref"))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        lr, _ = ref.prefill(params, {"tokens": prompts}, LM_MAX_LEN)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    if counts()["flash_attention"] != 0:
        fail("[lm] the plain model launched the flash kernel")
    lr = lr.float()
    bound = LOGIT_TOL * float(lr.abs().max())
    diff = float((lk - lr).abs().max())
    top2 = lr.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > bound
    same = bool(torch.equal(lk.argmax(-1)[sure], lr.argmax(-1)[sure]))
    print(f"[lm] kernel vs plain model prefill ({t_ref:.3f}s): last-position "
          f"logits max diff {diff:.3e}, bound {bound:.3e} (1e-3 x max|logit| "
          f"{float(lr.abs().max()):.4f}); first token equal on "
          f"{int(sure.sum())} of {LM_BATCH} rows with margin > bound: {same}",
          flush=True)
    if not diff <= bound:
        fail(f"[lm] kernel model logits differ from the plain model's by "
             f"{diff:.3e} > {bound:.3e}")
    if not same:
        fail("[lm] first greedy token differs on a row with a clear margin")
    row["launches"] = got["flash_attention"]
    row["lm"] = {"prefill_s": t_pre, "decode_ms_per_step":
                 1e3 * t_dec / len(dec), "plain_prefill_s": t_ref,
                 "peak_gib": peak / 2**30, "logit_max_diff": diff}
    del params, lr, lk
    return row


def _n_elems(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def train_flops(cfg, n_params: int, seqs: int, seq: int) -> float:
    """Operations of one remat training step of the dense LM on ``seqs``
    sequences of ``seq`` tokens: 2 x params x tokens for each matmul pass
    of the units (the forward, the recompute, and the backward's two), 6 x
    for the tied unembedding (forward and backward; the lookup is no
    product), and the plain attention's full (L x L) QK and PV products
    (4 L^2 H D a sequence and sublayer) in the same four passes."""

    tokens = seqs * seq
    embed = cfg.vocab_size * cfg.d_model
    units = n_params - embed - cfg.d_model          # the final norm aside
    attn = 4 * seq * seq * cfg.num_heads * cfg.resolved_head_dim
    return (8.0 * units * tokens + 6.0 * embed * tokens
            + 4.0 * attn * seqs * cfg.num_layers)


def train_full(card, device) -> dict:
    """a. Full-width, full-depth gemma2-2b training steps on the card."""

    cfg = get_model_config(LM_ARCH)
    tc = TrainConfig(microbatch=TRAIN_SEQS)
    model = build_model(cfg, Ctx(attn_impl="ref", remat=True), device=device)
    optimizer = make_optimizer(tc)
    step = make_train_step(model, tc, optimizer)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    opt_state = optimizer.init(params)
    torch.cuda.synchronize()
    n = _n_elems(params)
    gb = 4 * n / 1e9
    logits_gb = TRAIN_SEQ * cfg.vocab_size * 4 / 1e9
    print(f"[train] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n} f32 parameters ({gb:.2f} GB), AdamW state "
          f"init {time.perf_counter() - t0:.2f}s; {TRAIN_SEQS} sequences "
          f"of {TRAIN_SEQ} tokens a step as microbatch={TRAIN_SEQS} of one, "
          f"remat on.  Reckoning: params + grads + 2 moments {4 * gb:.1f} "
          f"GB, one sequence's logits {logits_gb:.2f} GB x ~3, remat unit "
          f"inputs {cfg.num_layers // 2} x "
          f"{TRAIN_SEQ * cfg.d_model * 4 / 1e6:.0f} MB, plain attention "
          f"scores (1, {cfg.num_heads}, {TRAIN_SEQ}, {TRAIN_SEQ}) "
          f"{cfg.num_heads * TRAIN_SEQ ** 2 * 4 / 1e9:.2f} GB a copy: "
          f"expected peak ~55-60 GB", flush=True)
    pipe = LMTokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_SEQS)
    reset_counts()
    secs, losses = [], []
    for i in range(TRAIN_STEPS):
        tok, tgt = pipe.batch_at(i)
        batch = {"tokens": tok, "targets": tgt}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i < TRAIN_STEPS - 1:     # the first is the warm-up
            params, opt_state, metrics = step(params, opt_state, batch)
        else:                       # the last runs under the profiler
            (params, opt_state, metrics), s_prof, bd = profiled(
                lambda: step(params, opt_state, batch))
        losses.append(float(metrics["loss"]))
        secs.append(time.perf_counter() - t0)
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    if any(got.values()):
        fail(f"[train] the training path launched a kernel: {got} (it "
             "trains through the plain attention)")
    if not all(np.isfinite(losses)):
        fail(f"[train] non-finite loss: {losses}")
    s_step = statistics.mean(secs[1:-1])
    busy = sum(bd.values()) / (1e3 * s_prof)
    flops = train_flops(cfg, n, TRAIN_SEQS, TRAIN_SEQ)
    bound_s = flops / peaks(card)[1]
    row = {"arch": cfg.name, "layers": cfg.num_layers, "params": n,
           "seq": TRAIN_SEQ, "seqs_per_step": TRAIN_SEQS,
           "microbatch": TRAIN_SEQS, "remat": True, "steps": TRAIN_STEPS,
           "step_s": secs, "s_per_step": s_step,  # without the profiler
           "tokens_per_s": TRAIN_SEQS * TRAIN_SEQ / s_step,
           "peak_gb": peak / 1e9, "losses": losses,
           "profiled_step_s": s_prof, "device_busy": busy,
           "flops_per_step": flops, "f32_bound_s": bound_s,
           "f32_roofline_share": bound_s / s_step}
    print(f"[train] full: {json.dumps(row)}", flush=True)
    print(f"[train] one step under the profiler: wall {s_prof:.3f} s, "
          f"device busy {100 * busy:.1f}%; by kernel: {top(bd)}", flush=True)
    if peak >= 80e9:
        fail(f"[train] peak device memory {peak / 1e9:.1f} GB >= 80 GB")
    del params, opt_state, step, optimizer
    _free()
    return row


def _rel_leaf_err(got, want) -> float:
    """max over leaves of max|got - want| / max|want|."""

    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def train_gates(card, device) -> dict:
    """b. Remat, microbatch, float64 gradient and one-batch gates at full
    width and depth one unit."""

    cfg = dataclasses.replace(get_model_config(LM_ARCH), num_layers=2)
    gen = torch.Generator(device=device).manual_seed(1)
    plain = build_model(cfg, Ctx(attn_impl="ref"), device=device)
    remat = build_model(cfg, Ctx(attn_impl="ref", remat=True), device=device)
    params = plain.init(gen)
    n = _n_elems(params)
    tok, tgt = LMTokenPipeline(cfg.vocab_size, GATE_SEQ, 4).batch_at(0)
    batch = {"tokens": tok, "targets": tgt}
    out = {"params": n, "seq": GATE_SEQ}

    l0, g0 = loss_and_grads(plain.loss, params, [batch])
    l1, g1 = loss_and_grads(remat.loss, params, [batch])
    out["remat_loss"] = [float(l0), float(l1)]
    out["remat_rel_err"] = _rel_leaf_err(g1, g0)
    if not (abs(float(l1) - float(l0)) <= REMAT_TOL * abs(float(l0))
            and out["remat_rel_err"] <= REMAT_TOL):
        fail(f"[train] remat on and off differ: {out}")
    del g1
    _free()

    lm, gm = loss_and_grads(plain.loss, params, split_batch(batch, 4))
    out["micro_loss"] = [float(l0), float(lm)]
    out["micro_grad_rel_err"] = _rel_leaf_err(gm, g0)
    del gm, g0
    _free()
    sgd_cfg = TrainConfig(**DP_TRAIN)
    stepped = []
    for mb in (0, 4):
        tc = dataclasses.replace(sgd_cfg, microbatch=mb)
        p = tree_map(torch.clone, params)
        opt = make_optimizer(tc)
        p, _, _ = make_train_step(plain, tc, opt)(p, opt.init(p), batch)
        stepped.append(p)
        _free()
    out["micro_param_rel_err"] = _rel_leaf_err(stepped[1], stepped[0])
    del stepped
    _free()
    if not (abs(float(lm) - float(l0)) <= MICRO_TOL * abs(float(l0))
            and out["micro_grad_rel_err"] <= MICRO_TOL
            and out["micro_param_rel_err"] <= MICRO_TOL):
        fail(f"[train] microbatch=4 differs from one pass: {out}")

    # <grad L, d> against the central difference, all in float64
    p64 = tree_map(lambda p: p.double(), params)
    dgen = torch.Generator(device=device).manual_seed(2)
    d = tree_map(lambda p: torch.randn(p.shape, generator=dgen,
                                       dtype=torch.float64, device=device),
                 p64)
    norm = torch.sqrt(sum(torch.sum(x * x) for x in tree_leaves(d)))
    d = tree_map(lambda x: x / norm, d)
    tok, tgt = LMTokenPipeline(cfg.vocab_size, F64_SEQ, 2).batch_at(1)
    small = {"tokens": tok, "targets": tgt}
    _, g64 = loss_and_grads(plain.loss, p64, [small])
    dd = float(sum(torch.sum(g * x) for g, x in
                   zip(tree_leaves(g64), tree_leaves(d))))
    del g64
    with torch.no_grad():
        lp = float(plain.loss(tree_map(lambda p, x: p + F64_EPS * x, p64, d),
                              small))
        lq = float(plain.loss(tree_map(lambda p, x: p - F64_EPS * x, p64, d),
                              small))
    fd = (lp - lq) / (2 * F64_EPS)
    out["f64_directional"] = {"grad_dot_d": dd, "central_difference": fd,
                              "eps": F64_EPS,
                              "rel_err": abs(dd - fd) / abs(dd)}
    del p64, d
    _free()
    if not out["f64_directional"]["rel_err"] < F64_GRAD_TOL:
        fail(f"[train] float64 gradient against the central difference: "
             f"{out['f64_directional']}")

    # three AdamW steps on one repeated batch lower its loss
    tc = TrainConfig(learning_rate=1e-4, warmup_steps=0)
    opt = make_optimizer(tc)
    step = make_train_step(plain, tc, opt)
    opt_state = opt.init(params)
    losses = []
    for _ in range(3):
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
    losses.append(float(make_eval_step(plain)(params, batch)))
    out["one_batch_losses"] = losses
    del params, opt_state
    _free()
    if not all(a > b for a, b in zip(losses, losses[1:])):
        fail(f"[train] AdamW did not lower one batch's loss: {losses}")
    print(f"[train] gates at full width, one unit: {json.dumps(out)}",
          flush=True)
    return out


def gossip_dp_rank(rank, device, cases) -> dict:
    """c. One worker of gossip data-parallel training: every case from the
    same seeded one-unit full-width parameters."""

    cfg = dataclasses.replace(get_model_config(LM_ARCH), num_layers=2)
    model = build_model(cfg, Ctx(attn_impl="ref"), device=device)
    optimizer = make_optimizer(TrainConfig(**DP_TRAIN))
    pipe = LMTokenPipeline(cfg.vocab_size, DP_SEQ, DP_BATCH)
    out = {}
    for name, kw in cases.items():
        params = model.init(torch.Generator(device=device).manual_seed(1))
        opt_state = optimizer.init(params)
        step = make_gossip_dp_step(model.loss, optimizer, **kw)
        obs.reset()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        losses = []
        t0 = time.perf_counter()
        for i in range(DP_STEPS):
            tok, tgt = pipe.batch_at(i)
            params, opt_state, loss = step(
                params, opt_state, {"tokens": tok, "targets": tgt}, i)
            losses.append(float(loss))
        wall = time.perf_counter() - t0
        snap = obs.snapshot()
        ex = snap["histograms"]["train_gossip_dp_exchange_seconds"]
        sent = snap["counters"]["train_gossip_dp_bytes_total"]
        out[name] = {"losses": losses,
                     "consensus_error": float(rank_consensus_error(params)),
                     "exchanges": ex["count"],
                     "ms_per_exchange": 1e3 * ex["sum"] / ex["count"],
                     "bytes_per_exchange": sent / ex["count"],
                     "s_per_step": wall / DP_STEPS,
                     "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9
                     if device.type == "cuda" else None}
        del params, opt_state, step
        _free()
    return out


def train_gossip_dp(card, device) -> dict:
    """c. Gossip DP on a ring of four gloo ranks on the card, against the
    exact step on the global batch in this process."""

    cfg = dataclasses.replace(get_model_config(LM_ARCH), num_layers=2)
    model = build_model(cfg, Ctx(attn_impl="ref"), device=device)
    tc = TrainConfig(**DP_TRAIN)
    optimizer = make_optimizer(tc)
    step = make_train_step(model, tc, optimizer)
    params = model.init(torch.Generator(device=device).manual_seed(1))
    opt_state = optimizer.init(params)
    pipe = LMTokenPipeline(cfg.vocab_size, DP_SEQ, DP_BATCH)
    t0 = time.perf_counter()
    ref_losses = []
    for i in range(DP_STEPS):
        tok, tgt = pipe.batch_at(i)
        params, opt_state, m = step(params, opt_state,
                                    {"tokens": tok, "targets": tgt})
        ref_losses.append(float(m["loss"]))
    ref_s = (time.perf_counter() - t0) / DP_STEPS
    del params, opt_state, step
    _free()
    marks: list = []
    t0 = time.perf_counter()
    try:
        outs = run_on_grid(gossip_dp_rank, (DP_WORKERS, 1), DP_CASES,
                           device=torch.device(device).type, timeout=600,
                           marks=marks)
    finally:
        shutdown_grids()        # the forkserver would outlive this phase
    grid_s = time.perf_counter() - t0
    res = outs[0]
    for name in DP_CASES:
        if any(o[name]["losses"] != res[name]["losses"] for o in outs):
            fail(f"[train] gossip DP {name}: the ranks report different "
                 "mean losses")
        if not all(np.isfinite(res[name]["losses"])):
            fail(f"[train] gossip DP {name}: non-finite loss")
    base = res["staleness1"]
    cerr, final, want = (base["consensus_error"], base["losses"][-1],
                         ref_losses[-1])
    row = {"workers": DP_WORKERS, "seq": DP_SEQ, "batch": DP_BATCH,
           "steps": DP_STEPS, "one_process_losses": ref_losses,
           "one_process_s_per_step": ref_s, "grid_s": grid_s,
           "startup_s": max(m["group_s"] for m in marks),
           "rank_peak_gb": [o[k]["peak_gb"] for o in outs
                            for k in DP_CASES], "cases": res}
    print(f"[train] gossip DP: {json.dumps(row)}", flush=True)
    if not cerr < DP_CERR:
        fail(f"[train] gossip DP consensus error {cerr:.4g} >= {DP_CERR}")
    if not abs(final - want) < DP_LOSS * abs(want):
        fail(f"[train] gossip DP final loss {final:.5f} not within "
             f"{DP_LOSS:.0%} of the one-process loss {want:.5f}")
    return row


def train_phase(card, device="cuda") -> dict:
    """``[train]``: LM training of gemma2-2b on the card (no kernel on this
    path: the flash kernel has no backward)."""

    t_phase = time.perf_counter()
    out = {"full": train_full(card, device),
           "gates": train_gates(card, device),
           "gossip_dp": train_gossip_dp(card, device)}
    print(f"[train] phase: {time.perf_counter() - t_phase:.1f}s of command",
          flush=True)
    return out


def prefill_flash(card, tag, label, B, L, Hq, Hkv, D, Dv, Lk=None,
                  causal=True) -> dict:
    """The flash kernel against its plain version at one arch's prefill
    shapes (q of length L, k/v of length ``Lk``, L by default; causal
    unless ``causal`` is false; no window, no softcap): f32 at rtol 2e-4 /
    atol 2e-5, one (b, h) slice against float64, a bf16 call at 5e-2;
    CUDA-graph and eager times, the plain version's, the bounds, and SDPA,
    which computes the same function here (K/V repeated to Hq heads)."""

    Lk = Lk or L
    bw, flops, _, tf32 = peaks(card)
    g = torch.Generator(device="cuda").manual_seed(13)
    q = torch.randn((B, Hq, L, D), generator=g, device="cuda")
    k = torch.randn((B, Hkv, Lk, D), generator=g, device="cuda")
    v = torch.randn((B, Hkv, Lk, Dv), generator=g, device="cuda")
    kern = lambda: flash_ops.flash_attention(q, k, v, causal=causal)  # noqa: E731
    plain = lambda: attention_ref(q, k, v, causal=causal)             # noqa: E731
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = (got - want).abs()
    abs_err = float(err.max())
    ok = bool((err <= FLASH_ATOL + FLASH_RTOL * want.abs()).all())
    del err
    f64 = f64_check(q, k, v, got, want, 0.0, b=B - 1, h=Hq - 1,
                    tag=f"{tag} {label}", causal=causal)
    del want
    # yardstick only, never called by the port
    kr, vr = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, kr, vr, is_causal=causal)
    library_err = float((sdpa() - got).abs().max())
    del got
    library_ms = eager_ms(sdpa, reps=5)
    del kr, vr
    _free()
    pairs = live_pairs(L, 0) if causal else L * Lk
    ops = 2 * (D + Dv) * pairs * B * Hq
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + B * Hq * L * Dv)
    t_bytes = nbytes / bw * 1e3
    t_f32, t_tc = ops / flops * 1e3, TF32_PASSES * ops / tf32 * 1e3
    t_ops = min(t_f32, t_tc)
    replays = graph_replays_ms(kern, calls=3, reps=9)
    out = {
        "ms": statistics.median(replays),
        "ms_range": [min(replays), max(replays)],
        "eager_ms": eager_ms(kern, reps=7),
        "plain_ms": eager_ms(plain, reps=3),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_f32_cuda_core_ms": max(t_bytes, t_f32),
        "operations": ops, "bytes": nbytes, "max_abs_err": abs_err,
        "library_ms": library_ms, "library_max_abs_err": library_err,
        "library_call": f"scaled_dot_product_attention f32, is_causal="
                        f"{causal}, K/V repeated to Hq (the same function)",
        "timing": "ms: median of CUDA-graph replays of 3 calls; eager and "
                  "plain: median of single calls between CUDA events",
        "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "L": L, "Lk": Lk, "D": D,
                  "Dv": Dv, "causal": causal},
        **f64}
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    bf16_err = float((flash_ops.flash_attention(qb, kb, vb, causal=causal)
                      .float() - attention_ref(qb, kb, vb, causal=causal)
                      .float()).abs().max())
    out["bf16_max_abs_err"] = bf16_err
    del q, k, v, qb, kb, vb
    _free()
    print(f"{tag} flash {label}: {json.dumps(out)}", flush=True)
    if not ok:
        fail(f"{tag} flash_attention at {label}'s shapes disagrees with its "
             f"plain version beyond rtol {FLASH_RTOL} / atol {FLASH_ATOL} "
             f"(max abs error {abs_err:.3e})")
    if not bf16_err < FLASH_BF16_ABS:
        fail(f"{tag} flash_attention bf16 at {label}'s shapes: max abs "
             f"error {bf16_err:.3e} >= {FLASH_BF16_ABS}")
    return out


class RouteLog:
    """Stands in for the port's router (``models.moe.route``, which
    ``moe_ffn`` looks up at each call) while ``with``-ed: it records each
    call's expert choices and the gap between the k-th and (k+1)-th
    probability on the host.  Given ``force`` (an earlier log's choices) it
    routes by those instead, weighted by this model's own probabilities and
    renormalised as ``route`` does, so that two models can be compared
    under the same routing."""

    def __init__(self, force=None):
        self.idx, self.gap, self.force = [], [], force
        self._route = moe_mod.route

    def __enter__(self):
        moe_mod.route = self
        return self

    def __exit__(self, *exc):
        moe_mod.route = self._route

    def __call__(self, params, xt, cfg):
        top_idx, top_w, aux = self._route(params, xt, cfg)
        k = cfg.num_experts_per_tok
        probs = torch.softmax(xt.float() @ params["router"], dim=-1)
        if self.force is not None:
            top_idx = torch.as_tensor(self.force[len(self.idx)],
                                      device=xt.device)
            top_w = probs.gather(-1, top_idx)
            top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        top = probs.topk(k + 1, dim=-1).values
        self.idx.append(top_idx.cpu().numpy())
        self.gap.append((top[:, k - 1] - top[:, k]).cpu().numpy())
        return top_idx, top_w, aux

    def rows(self, n: int) -> None:
        """Keep the first ``n`` prompts of every recorded prefill call."""

        self.idx = [i.reshape(MOE_BATCH, -1, i.shape[-1])[:n]
                    .reshape(-1, i.shape[-1]) for i in self.idx]
        self.gap = [gp.reshape(MOE_BATCH, -1)[:n].reshape(-1)
                    for gp in self.gap]


def route_flips(ref: RouteLog, other: RouteLog, rows: int) -> dict:
    """Routing of ``other`` against ``ref`` over the same prompts: the
    (layer, token) choices whose expert sets differ, the rows with none,
    and at each row's first flip the largest gap of ``ref`` among its
    flipped tokens (a flip changes its token's state and, through
    attention, its row's, so later flips in that row are consequences)."""

    flips, total = 0, 0
    alive = np.ones(rows, bool)
    first_gap = [None] * rows
    for a, b, gap in zip(ref.idx, other.idx, ref.gap):
        same = (np.sort(a, -1) == np.sort(b, -1)).all(-1)
        same, gap = same.reshape(rows, -1), gap.reshape(rows, -1)
        for r in np.flatnonzero(alive & ~same.all(1)):
            first_gap[r] = float(gap[r][~same[r]].max())
        alive &= same.all(1)
        flips += int((~same).sum())
        total += same.size
    return {"flips": flips, "choices": total, "share": flips / total,
            "rows_agreed": alive.tolist(), "first_flip_gap": first_gap}


def _flat_caches(cache):
    """Every sublayer cache (a ``KVCache`` or ``MLACache``) of an LM cache
    tree."""

    for sub in cache.values():
        if isinstance(sub, dict):
            yield from _flat_caches(sub)
        else:
            yield sub


def moe_model(card, arch, flash_shapes, device="cuda") -> dict:
    """One MoE arch served at full width and depth through the flash
    kernel, then against the plain-attention model on the same prompts."""

    cfg = get_model_config(arch)
    t0 = time.perf_counter()
    model = build_model(cfg, Ctx(attn_impl="kernel"), device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    param_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    print(f"[moe] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.moe.num_experts} experts top-"
          f"{cfg.moe.num_experts_per_tok} (+{cfg.moe.num_shared_experts} "
          f"shared), {n_params} parameters in {cfg.param_dtype} "
          f"({param_bytes / 1e9:.2f} GB), init "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    prompts = np.random.default_rng(13).integers(
        0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT))
    n_moe = cfg.num_layers - (1 if cfg.mla is not None else 0)

    ServeLoop(model, params, 1, MOE_MAX_LEN).generate(
        {"tokens": prompts[:1, :256]}, 2)                # warm-up
    torch.cuda.synchronize()

    pre, dec = [], []
    spy = model._replace(prefill=timed(model.prefill, pre),
                         decode=timed(model.decode, dec))
    loop = ServeLoop(spy, params, MOE_BATCH, MOE_MAX_LEN)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = loop.generate({"tokens": prompts}, MOE_NEW)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    del loop, spy
    if got["flash_attention"] != cfg.num_layers:
        fail(f"[moe] {arch}: flash_attention launched "
             f"{got['flash_attention']} times, expected {cfg.num_layers} "
             "(one per prefill sublayer, none in decode)")
    if any(n for name, n in got.items() if name != "flash_attention"):
        fail(f"[moe] {arch}: an unexpected kernel launched: {got}")
    if tuple(out.shape) != (MOE_BATCH, MOE_NEW):
        fail(f"[moe] {arch}: generate gave shape {tuple(out.shape)}")
    if not all(bool(torch.isfinite(lg).all()) for _, lg in pre + dec):
        fail(f"[moe] {arch}: non-finite logits")
    t_pre = pre[0][0]
    t_dec = sum(s for s, _ in dec)
    print(f"[moe] {arch} generate: prefill {t_pre:.3f}s "
          f"({MOE_BATCH * MOE_PROMPT / t_pre:.0f} prompt tokens/s), decode "
          f"{1e3 * t_dec / len(dec):.3f} ms/step over {len(dec)} steps "
          f"({MOE_BATCH * len(dec) / t_dec:.1f} generated tokens/s), total "
          f"{total:.3f}s ({MOE_BATCH * MOE_NEW / total:.1f} tokens/s); "
          f"launches {got}; {n_moe} host reads of the expert run lengths a "
          f"step (one a MoE layer); peak device memory {peak / 2**30:.2f} "
          f"GiB", flush=True)
    print(f"[moe] {arch} first row: {out[0].tolist()}", flush=True)

    # where the device time of one prefill and one decode step goes; the
    # prefill also records the kernel model's routing (a host copy of each
    # layer's choices, inside the profiled wall)
    batch = {"tokens": prompts}
    seen_pre, seen_dec = {}, {}
    with torch.inference_mode():
        with RouteLog() as routes_k:
            (lk, cache), s_pre, bd_pre = profiled(
                lambda: model.prefill(params, batch, MOE_MAX_LEN), seen_pre)
        tok = torch.zeros(MOE_BATCH, dtype=torch.int32, device=device)
        _, s_dec, bd_dec = profiled(
            lambda: model.decode(params, cache, tok, MOE_PROMPT), seen_dec)
    cache_bytes = sum(x.numel() * x.element_size()
                      for c in _flat_caches(cache) for x in c)
    del cache
    lk = lk.float()
    same_prefill = bool(torch.equal(lk, pre[0][1].float()))
    prof = {}
    for label, secs, bd, seen in (("prefill", s_pre, bd_pre, seen_pre),
                                  ("decode step", s_dec, bd_dec, seen_dec)):
        busy = sum(bd.values()) / (1e3 * secs)
        prof[label] = {"wall_ms": 1e3 * secs, "busy": busy,
                       "launches": sum(seen.values())}
        print(f"[moe] {arch} {label} under the profiler: wall "
              f"{1e3 * secs:.3f} ms, device busy {100 * busy:.1f}%, "
              f"{sum(seen.values())} kernel launches; by kernel: {top(bd)}",
              flush=True)

    # expert load: the share of the prefill's slots each expert took,
    # summed over the MoE layers
    E = cfg.moe.num_experts
    load = sum(np.bincount(i.reshape(-1), minlength=E) for i in routes_k.idx)
    share = load / load.sum()
    print(f"[moe] {arch} expert load over {len(routes_k.idx)} layers: share "
          f"of slots min {share.min():.4f} max {share.max():.4f} (uniform "
          f"{1 / E:.4f}); by expert {[round(float(x), 4) for x in share]}",
          flush=True)

    # the latent cache beside a (k, v) cache of the same heads
    if cfg.mla is not None:
        dk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        kv_equiv = (2 * MOE_BATCH * MOE_MAX_LEN * cfg.num_heads
                    * cfg.num_layers * (dk + cfg.mla.v_head_dim))
        print(f"[moe] {arch} cache: latent (c_kv, k_rope) {cache_bytes} "
              f"bytes in bf16 against {kv_equiv} for a (k, v) cache of the "
              f"same heads (k {dk}, v {cfg.mla.v_head_dim}): "
              f"{kv_equiv / cache_bytes:.2f}x", flush=True)
    else:
        kv_equiv = cache_bytes
        print(f"[moe] {arch} cache: (k, v) {cache_bytes} bytes in bf16",
              flush=True)

    # the plain-attention model on the same prompts: free routing (flips
    # counted, rows whose routing agreed held), then routed as the kernel
    # model was (every row held)
    ref = build_model(cfg, Ctx(attn_impl="ref"), device=device)
    plain_bytes = 4 * MOE_BATCH * cfg.num_heads * MOE_PROMPT ** 2
    total_mem = torch.cuda.get_device_properties(0).total_memory
    rows = MOE_BATCH
    if peak + plain_bytes > 0.95 * total_mem:
        rows = 1
        routes_k.rows(rows)
        lk = lk[:rows]
        print(f"[moe] {arch}: the plain comparison runs on the first prompt "
              f"alone (the prefill's peak {peak / 1e9:.1f} GB and "
              f"{plain_bytes / 1e9:.1f} GB of plain logits exceed 95% of "
              "the card)", flush=True)
    sub = {"tokens": prompts[:rows]}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode(), RouteLog() as routes_p:
        lr, _ = ref.prefill(params, sub, MOE_MAX_LEN)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    with torch.inference_mode(), RouteLog(force=routes_k.idx):
        lf, _ = ref.prefill(params, sub, MOE_MAX_LEN)
    torch.cuda.synchronize()
    if counts()["flash_attention"] != 0:
        fail(f"[moe] {arch}: the plain model launched the flash kernel")
    peak_all = torch.cuda.max_memory_allocated()
    flips = route_flips(routes_k, routes_p, rows)
    lr, lf = lr.float(), lf.float()
    bound = LOGIT_TOL * float(lf.abs().max())
    agreed = torch.as_tensor(flips["rows_agreed"], device=device)
    diff_agreed = (float((lk - lr).abs()[agreed].max()) if bool(agreed.any())
                   else None)
    diff_free = float((lk - lr).abs().max())
    diff_forced = float((lk - lf).abs().max())
    top2 = lf.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > bound
    same_tok = bool(torch.equal(lk.argmax(-1)[sure], lf.argmax(-1)[sure]))
    firsts = [g_ for g_ in flips["first_flip_gap"] if g_ is not None]
    print(f"[moe] {arch} kernel vs plain model prefill ({t_ref:.3f}s, "
          f"{rows} prompt(s)): routing flips {flips['flips']} of "
          f"{flips['choices']} (layer, token) choices (share "
          f"{flips['share']:.2e}, bound {FLIP_SHARE}); rows with no flip "
          f"{flips['rows_agreed']}; gap at each row's first flip "
          f"{flips['first_flip_gap']} (bound {ROUTE_MARGIN}); last-position "
          f"logits max diff on those rows {diff_agreed}, on all rows "
          f"{diff_free:.3e}; routed as the kernel model: {diff_forced:.3e}; "
          f"bound {bound:.3e} (1e-3 x max|logit|); first token equal on "
          f"{int(sure.sum())} of {rows} rows with margin > bound: "
          f"{same_tok}; the profiled prefill's logits bitwise the "
          f"generate's: {same_prefill}; peak device memory "
          f"{peak_all / 2**30:.2f} GiB of {total_mem / 2**30:.2f}",
          flush=True)
    if flips["share"] > FLIP_SHARE:
        fail(f"[moe] {arch}: {flips['share']:.2e} of the routing choices "
             f"flipped, more than {FLIP_SHARE}")
    if firsts and max(firsts) > ROUTE_MARGIN:
        fail(f"[moe] {arch}: a row's first routing flip lies on a gap of "
             f"{max(firsts):.3e} > {ROUTE_MARGIN}")
    if diff_agreed is not None and not diff_agreed <= bound:
        fail(f"[moe] {arch}: on rows whose routing agreed the kernel model's "
             f"logits differ from the plain model's by {diff_agreed:.3e} > "
             f"{bound:.3e}")
    if not diff_forced <= bound:
        fail(f"[moe] {arch}: routed alike, the kernel model's logits differ "
             f"from the plain model's by {diff_forced:.3e} > {bound:.3e}")
    if not same_tok:
        fail(f"[moe] {arch}: first greedy token differs on a row with a "
             "clear margin")
    if not peak_all < total_mem:
        fail(f"[moe] {arch}: peak device memory {peak_all / 2**30:.2f} GiB "
             f">= the card's {total_mem / 2**30:.2f}")
    del params, lk, lr, lf
    _free()
    return {"launches": got["flash_attention"], "prefill_s": t_pre,
            "decode_ms_per_step": 1e3 * t_dec / len(dec),
            "tokens_per_s": MOE_BATCH * MOE_NEW / total,
            "plain_prefill_s": t_ref, "peak_gib": peak_all / 2**30,
            "routing": {k_: flips[k_] for k_ in ("flips", "choices",
                                                 "share")},
            "logit_max_diff_routed_alike": diff_forced,
            "logit_max_diff_agreed_rows": diff_agreed,
            "profile": prof, "cache_bytes": cache_bytes,
            "kv_cache_bytes_same_heads": kv_equiv,
            "expert_share_min_max": [float(share.min()),
                                     float(share.max())],
            "flash": flash_shapes}


def moe_phase(card, flash_row) -> dict:
    """``[moe]``: the flash kernel at both MoE archs' prefill shapes, then
    granite-moe-3b-a800m and deepseek-v2-lite-16b served at full width and
    depth through it.  Adds the phase's flash launches to ``flash_row``."""

    t_phase = time.perf_counter()
    shapes = {
        "granite-moe-3b-a800m": prefill_flash(
            card, "[moe]", "granite-moe", MOE_BATCH, MOE_PROMPT, 24, 8, 64,
            64),
        "deepseek-v2-lite-16b": prefill_flash(
            card, "[moe]", "mla", MOE_BATCH, MOE_PROMPT, 16, 16, 192, 128)}
    out = {arch: moe_model(card, arch, shapes[arch]) for arch in MOE_ARCHS}
    flash_row["launches"] += sum(o["launches"] for o in out.values())
    flash_row["moe"] = out
    print(f"[moe] phase: {time.perf_counter() - t_phase:.1f}s of command",
          flush=True)
    return out


def ssd_check(cfg, params, prompts, device="cuda") -> dict:
    """One mamba2 layer's scan at full width on the card (``SSD_SHAPE``),
    ``ssd_chunked`` against the sequential ``ssd_reference``.

    a. The first layer's own inputs (``scan_inputs`` of the first prompt's
    first L tokens), float32, at ``tests/test_moe_ssm.py``'s rtol/atol.
    b. Seeded draws shaped and distributed as that test draws them, in
    float64 (the two forms within ``SSD_F64_TOL`` of max|y|); each float32
    form's error against float64 is printed.  Those draws' decays sum to
    thousands within a 256-token chunk, where the chunked form's decay
    matrix (differences of within-chunk cumsums) loses float32 precision,
    in the JAX package's ``ssd_chunked`` as here.  The time of each form."""

    b, L, h, p, n, chunk = SSD_SHAPE
    if (h, p, n, chunk) != (cfg.ssm.n_heads(cfg.d_model), cfg.ssm.head_dim,
                            cfg.ssm.d_state, cfg.ssm.chunk_size):
        fail(f"[ssm] SSD_SHAPE {SSD_SHAPE} is not {cfg.name}'s layer")
    g = torch.Generator(device=device).manual_seed(13)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.float64)

    def both(args):
        y1, f1 = ssm_mod.ssd_chunked(*args, chunk)
        y2, f2 = ssm_mod.ssd_reference(*args)
        return (y1, f1), (y2, f2)

    out = {"shape": dict(zip("bLhpn", (b, L, h, p, n)), chunk=chunk)}
    with torch.inference_mode():
        lp = _index(params["units"], 0)["s0"]
        x = rms_norm(params["embed"][torch.as_tensor(prompts[:b, :L],
                                                     device=device)],
                     lp["norm1"], cfg.norm_eps)
        layer = ssm_mod.scan_inputs(lp["ssm"], x, cfg.ssm, cfg.d_model)
        (y1, f1), (y2, f2) = both(layer)
        ok = all(bool(torch.allclose(a, r, rtol=SSD_TOL, atol=SSD_TOL))
                 for a, r in ((y1, y2), (f1, f2)))
        out["layer"] = {"max_abs_err_y": float((y1 - y2).abs().max()),
                        "max_abs_err_state": float((f1 - f2).abs().max()),
                        "max_abs_y": float(y2.abs().max())}
        x, dt = draw(b, L, h, p), torch.nn.functional.softplus(draw(b, L, h))
        drawn = (x, dt, -torch.exp(draw(h)), draw(b, L, n), draw(b, L, n))
        (z1, _), (z2, _) = both(drawn)
        f64_err = float((z1 - z2).abs().max())
        (y1, _), (y2, _) = both([a.float() for a in drawn])
        scale = float(z2.abs().max())
        out["drawn"] = {
            "f64_max_abs_err": f64_err, "max_abs_y": scale,
            "f32_chunked_vs_f64": float((y1.double() - z2).abs().max()),
            "f32_sequential_vs_f64": float((y2.double() - z2).abs().max()),
            "f32_chunked_vs_sequential": float((y1 - y2).abs().max()),
            "min_chunk_decay_sum": float(torch.cumsum(
                (dt * drawn[2]).reshape(b, L // chunk, chunk, h), 2).min())}
        f32 = [a.float() for a in layer]
        out["chunked_ms"] = eager_ms(
            lambda: ssm_mod.ssd_chunked(*f32, chunk), reps=5)
        out["sequential_ms"] = eager_ms(
            lambda: ssm_mod.ssd_reference(*f32), reps=1)
    print(f"[ssm] ssd_chunked against ssd_reference on the card: "
          f"{json.dumps(out)} (layer: rtol/atol {SSD_TOL}; drawn: float64 "
          f"within {SSD_F64_TOL} x max|y|)", flush=True)
    if not ok:
        fail(f"[ssm] on the first layer's inputs ssd_chunked disagrees with "
             f"ssd_reference beyond rtol/atol {SSD_TOL}: {out['layer']}")
    if not f64_err <= SSD_F64_TOL * scale:
        fail(f"[ssm] in float64 ssd_chunked disagrees with ssd_reference by "
             f"{f64_err:.3e} > {SSD_F64_TOL} x {scale:.3e}")
    return out


def ssm_model(card, arch, device="cuda") -> dict:
    """One SSM-family arch served at full width and depth: ``generate``,
    the profiled prefill and decode step, the continuation check, and for
    the hybrid the plain-attention model on the same prompts."""

    cfg = get_model_config(arch)
    hybrid = cfg.family == "hybrid"
    n_units = cfg.num_layers // cfg.shared_attn_every if hybrid else 0
    t0 = time.perf_counter()
    model = build_model(cfg, Ctx(attn_impl="kernel"), device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    lora = None
    if hybrid:
        # lora_b is zero at init, as in Zamba2, which would leave the LoRA
        # deltas unexercised: draw it from the seed
        units = params["units"]
        units["lora_b"].normal_(generator=torch.Generator(
            device=device).manual_seed(1)).mul_(LORA_B_STD)
        delta = units["lora_a"][:, 0] @ units["lora_b"][:, 0]
        wq = params["shared"]["attn"]["wq"]
        lora = {"lora_b_std": LORA_B_STD,
                "rms_delta_q": float(delta.square().mean().sqrt()),
                "rms_wq": float(wq.square().mean().sqrt())}
        del delta
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    param_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    print(f"[ssm] {cfg.name}: {cfg.num_layers} Mamba2 layers"
          + (f" + {n_units} invocations of one shared attention block "
             f"({cfg.num_heads} heads of {cfg.resolved_head_dim})"
             if hybrid else "")
          + f", d_model {cfg.d_model}, {cfg.ssm.n_heads(cfg.d_model)} SSM "
          f"heads of {cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}; "
          f"{n_params} parameters in {cfg.param_dtype} "
          f"({param_bytes / 1e9:.2f} GB), init "
          f"{time.perf_counter() - t0:.2f}s"
          + (f"; lora_b drawn N(0, {LORA_B_STD}^2): rms of wq's delta "
             f"{lora['rms_delta_q']:.3e} against rms(wq) {lora['rms_wq']:.3e}"
             if hybrid else ""), flush=True)
    prompts = np.random.default_rng(13).integers(
        0, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT))

    ServeLoop(model, params, 1, SSM_MAX_LEN).generate(
        {"tokens": prompts[:1, :SSM_WARM]}, 2)           # warm-up
    torch.cuda.synchronize()

    pre, dec = [], []
    spy = model._replace(prefill=timed(model.prefill, pre),
                         decode=timed(model.decode, dec))
    loop = ServeLoop(spy, params, SSM_BATCH, SSM_MAX_LEN)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = loop.generate({"tokens": prompts}, SSM_NEW)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    del loop, spy
    if got["flash_attention"] != n_units:
        fail(f"[ssm] {arch}: flash_attention launched "
             f"{got['flash_attention']} times, expected {n_units} (one per "
             "shared-block invocation of the prefill, none in decode)")
    if any(n for name, n in got.items() if name != "flash_attention"):
        fail(f"[ssm] {arch}: an unexpected kernel launched: {got}")
    if tuple(out.shape) != (SSM_BATCH, SSM_NEW):
        fail(f"[ssm] {arch}: generate gave shape {tuple(out.shape)}")
    if not all(bool(torch.isfinite(lg).all()) for _, lg in pre + dec):
        fail(f"[ssm] {arch}: non-finite logits")
    t_pre = pre[0][0]
    t_dec = sum(s for s, _ in dec)
    print(f"[ssm] {arch} generate: prefill {t_pre:.3f}s "
          f"({SSM_BATCH * SSM_PROMPT / t_pre:.0f} prompt tokens/s), decode "
          f"{1e3 * t_dec / len(dec):.3f} ms/step over {len(dec)} steps "
          f"({SSM_BATCH * len(dec) / t_dec:.1f} generated tokens/s), total "
          f"{total:.3f}s ({SSM_BATCH * SSM_NEW / total:.1f} tokens/s); "
          f"launches {got}; peak device memory {peak / 2**30:.2f} GiB",
          flush=True)
    print(f"[ssm] {arch} first row: {out[0].tolist()}", flush=True)
    ssd = None if hybrid else ssd_check(cfg, params, prompts, device)

    # where the device time of one prefill and one decode step goes
    batch = {"tokens": prompts}
    seen_pre, seen_dec = {}, {}
    with torch.inference_mode():
        (_, cache), s_pre, bd_pre = profiled(
            lambda: model.prefill(params, batch, SSM_MAX_LEN), seen_pre)
        tok = torch.zeros(SSM_BATCH, dtype=torch.int32, device=device)
        _, s_dec, bd_dec = profiled(
            lambda: model.decode(params, cache, tok, SSM_PROMPT), seen_dec)
    prof = {}
    for label, secs, bd, seen in (("prefill", s_pre, bd_pre, seen_pre),
                                  ("decode step", s_dec, bd_dec, seen_dec)):
        busy = sum(bd.values()) / (1e3 * secs)
        prof[label] = {"wall_ms": 1e3 * secs, "busy": busy,
                       "launches": sum(seen.values())}
        print(f"[ssm] {arch} {label} under the profiler: wall "
              f"{1e3 * secs:.3f} ms, device busy {100 * busy:.1f}%, "
              f"{sum(seen.values())} kernel launches; by kernel: {top(bd)}",
              flush=True)

    # the cache: SSM states (+ the hybrid's (k, v)) beside a (k, v) cache
    # of as many layers of the same width at the prompt's length
    nbytes = {}
    for sub in _flat_caches(cache):
        name = type(sub).__name__
        nbytes[name] = nbytes.get(name, 0) + sum(
            x.numel() * x.element_size() for x in sub)
    kv_equiv = 2 * SSM_BATCH * SSM_PROMPT * cfg.num_layers * cfg.d_model * 2
    print(f"[ssm] {arch} cache after the prefill: {nbytes} bytes (the SSM "
          f"states' conv registers in the activations' float32, h float32"
          + (", (k, v) bf16 at max_len" if hybrid else "") + f"); a bf16 "
          f"(k, v) cache of {cfg.num_layers} layers of width {cfg.d_model} "
          f"at {SSM_PROMPT} tokens: {kv_equiv} bytes "
          f"({kv_equiv / sum(nbytes.values()):.2f}x)", flush=True)
    del cache

    # continuation: a prefill of SSM_SPLIT tokens, then the rest of the
    # prompt one decode step at a time, against the prefill of all of it;
    # with a float32 cache, as tests/test_models_consistency.py holds JAX's
    # (a bf16 (k, v) cache rounds zamba2's attention inputs; the SSM
    # registers after a prefill are float32 either way)
    full = pre[0][1].float()
    toks = torch.as_tensor(prompts, device=device)
    f32 = build_model(cfg, Ctx(attn_impl="kernel", cache_dtype=torch.float32),
                      device=device)
    with torch.inference_mode():
        _, cache = f32.prefill(params, {"tokens": prompts[:, :SSM_SPLIT]},
                               SSM_MAX_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(SSM_SPLIT, SSM_PROMPT):
            cont, cache = f32.decode(params, cache, toks[:, pos], pos)
        torch.cuda.synchronize()
    t_cont = time.perf_counter() - t0
    del cache
    cont = cont.float()
    bound = LOGIT_TOL * float(full.abs().max())
    cont_diff = float((cont - full).abs().max())
    steps = SSM_PROMPT - SSM_SPLIT
    print(f"[ssm] {arch} continuation, float32 cache: prefill {SSM_SPLIT} "
          f"+ {steps} decode steps ({1e3 * t_cont / steps:.3f} ms/step) "
          f"against the "
          f"prefill of {SSM_PROMPT}: last-position "
          f"logits max diff {cont_diff:.3e}, bound {bound:.3e} (1e-3 x "
          f"max|logit|)", flush=True)
    if not cont_diff <= bound:
        fail(f"[ssm] {arch}: prefill + decode differs from the full prefill "
             f"by {cont_diff:.3e} > {bound:.3e}")

    res = {"launches": got["flash_attention"], "prefill_s": t_pre,
           "decode_ms_per_step": 1e3 * t_dec / len(dec),
           "continuation_decode_ms_per_step": 1e3 * t_cont / steps,
           "tokens_per_s": SSM_BATCH * SSM_NEW / total,
           "peak_gib": peak / 2**30, "profile": prof, "cache_bytes": nbytes,
           "kv_cache_bytes_same_layers": kv_equiv,
           "continuation_max_diff": cont_diff, "logit_bound": bound,
           "ssd": ssd}
    if hybrid:
        res.update(lora=lora, **plain_model(cfg, params, prompts, full,
                                            device))
    del params
    _free()
    return res


def plain_model(cfg, params, prompts, lk, device) -> dict:
    """The hybrid's plain-attention model (same parameters) on the same
    prompts against the kernel model's last-position logits ``lk``."""

    ref = build_model(cfg, Ctx(attn_impl="ref"), device=device)
    total_mem = torch.cuda.get_device_properties(0).total_memory
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        lr, _ = ref.prefill(params, {"tokens": prompts}, SSM_MAX_LEN)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if counts()["flash_attention"] != 0:
        fail(f"[ssm] {cfg.name}: the plain model launched the flash kernel")
    lr = lr.float()
    bound = LOGIT_TOL * float(lr.abs().max())
    diff = float((lk - lr).abs().max())
    top2 = lr.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > bound
    same_tok = bool(torch.equal(lk.argmax(-1)[sure], lr.argmax(-1)[sure]))
    print(f"[ssm] {cfg.name} kernel vs plain model prefill ({t_ref:.3f}s): "
          f"last-position logits max diff {diff:.3e}, bound {bound:.3e} "
          f"(1e-3 x max|logit|); first token equal on {int(sure.sum())} of "
          f"{SSM_BATCH} rows with margin > bound: {same_tok}; peak device "
          f"memory {peak / 2**30:.2f} GiB of {total_mem / 2**30:.2f}",
          flush=True)
    if not diff <= bound:
        fail(f"[ssm] {cfg.name}: the kernel model's logits differ from the "
             f"plain model's by {diff:.3e} > {bound:.3e}")
    if not same_tok:
        fail(f"[ssm] {cfg.name}: first greedy token differs on a row with a "
             "clear margin")
    if not peak < total_mem:
        fail(f"[ssm] {cfg.name}: peak device memory {peak / 2**30:.2f} GiB "
             f">= the card's {total_mem / 2**30:.2f}")
    return {"plain_prefill_s": t_ref, "plain_logit_max_diff": diff,
            "plain_peak_gib": peak / 2**30}


def ssm_phase(card, flash_row) -> dict:
    """``[ssm]``: the flash kernel at zamba2's prefill shape, then
    mamba2-780m (with one layer's scan at full width) and zamba2-2.7b
    served at full width and depth.  Adds the phase's flash launches to
    ``flash_row``."""

    t_phase = time.perf_counter()
    flash = prefill_flash(card, "[ssm]", "zamba2", SSM_BATCH, SSM_PROMPT,
                          32, 32, 80, 80)
    out = {arch: ssm_model(card, arch) for arch in SSM_ARCHS}
    out["zamba2-2.7b"]["flash"] = flash
    flash_row["launches"] += sum(out[arch]["launches"] for arch in SSM_ARCHS)
    flash_row["ssm"] = out
    print(f"[ssm] phase: {time.perf_counter() - t_phase:.1f}s of command",
          flush=True)
    return out


def _nbytes(tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def served_family(tag, cfg, inputs, prompts, max_len, new, split,
                  expect, device="cuda") -> dict:
    """One encoder-decoder or VLM arch served through the flash kernel:
    ``build_model`` -> ``init`` -> ``ServeLoop(max_len).generate`` of
    ``new`` greedy tokens after ``prompts`` with the float ``inputs``
    (frames or patches); ``expect`` flash launches in the prefill and none
    in decode; the profiled prefill and decode step; the continuation
    check (a float32 cache: a prefill of ``split`` tokens, then decode
    steps over the rest of the prompt, against the generate's prefill);
    the plain-attention model on the same inputs."""

    vlm = cfg.family == "vlm"
    offset = cfg.num_patch_tokens if vlm else 0
    B, L = prompts.shape
    t0 = time.perf_counter()
    model = build_model(cfg, Ctx(attn_impl="kernel"), device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    param_bytes = _nbytes(_leaves(params))
    print(f"{tag} {cfg.name}: "
          + (f"{cfg.num_layers} of 80 LM layers" if vlm else
             f"{cfg.encoder_layers} encoder + {cfg.num_layers} decoder "
             "layers")
          + f", d_model {cfg.d_model}, {cfg.num_heads} heads of "
          f"{cfg.resolved_head_dim} over {cfg.num_kv_heads} KV heads, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}; {n_params} parameters in "
          f"{cfg.param_dtype} ({param_bytes / 1e9:.2f} GB), init "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    batch = {**inputs, "tokens": prompts}

    ServeLoop(model, params, 1, max_len).generate(
        {**{k: x[:1] for k, x in inputs.items()},
         "tokens": prompts[:1, :64]}, 2)                 # warm-up
    torch.cuda.synchronize()

    pre, dec = [], []
    spy = model._replace(prefill=timed(model.prefill, pre),
                         decode=timed(model.decode, dec))
    loop = ServeLoop(spy, params, B, max_len)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = loop.generate(batch, new)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    del loop, spy
    if got["flash_attention"] != expect:
        fail(f"{tag} {cfg.name}: flash_attention launched "
             f"{got['flash_attention']} times, expected {expect} (the "
             "prefill's, none in decode)")
    if any(n for name, n in got.items() if name != "flash_attention"):
        fail(f"{tag} {cfg.name}: an unexpected kernel launched: {got}")
    if tuple(out.shape) != (B, new):
        fail(f"{tag} {cfg.name}: generate gave shape {tuple(out.shape)}")
    if not all(bool(torch.isfinite(lg).all()) for _, lg in pre + dec):
        fail(f"{tag} {cfg.name}: non-finite logits")
    t_pre = pre[0][0]
    t_dec = sum(s_ for s_, _ in dec)
    res = {"launches": got["flash_attention"], "prefill_s": t_pre,
           "decode_ms_per_step": 1e3 * t_dec / len(dec),
           "decode_tokens_per_s": B * len(dec) / t_dec,
           "tokens_per_s": B * new / total, "peak_gib": peak / 2**30,
           "parameters": n_params, "parameter_bytes": param_bytes}
    if vlm:
        res["fused_tokens_per_s"] = B * (offset + L) / t_pre
    else:
        # the encoder alone, on the same frames already on the card
        frames = torch.as_tensor(inputs["frames"], device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            encdec_mod.encode(params, frames, cfg, model.ctx)
        torch.cuda.synchronize()
        res["encoder_s"] = time.perf_counter() - t0
        del frames
    print(f"{tag} {cfg.name} generate: prefill {t_pre:.3f}s ("
          + (f"{res['fused_tokens_per_s']:.0f} fused tokens/s"
             if vlm else f"encoder alone {res['encoder_s']:.3f}s")
          + f"), decode {res['decode_ms_per_step']:.3f} ms/step over "
          f"{len(dec)} steps ({res['decode_tokens_per_s']:.1f} decoder "
          f"tokens/s), total {total:.3f}s ({res['tokens_per_s']:.1f} "
          f"tokens/s); launches {got}; peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"{tag} {cfg.name} first row: {out[0].tolist()}", flush=True)

    # where the device time of one prefill and one decode step goes
    seen_pre, seen_dec = {}, {}
    with torch.inference_mode():
        (_, cache), s_pre, bd_pre = profiled(
            lambda: model.prefill(params, batch, max_len), seen_pre)
        tok = torch.zeros(B, dtype=torch.int32, device=device)
        _, s_dec, bd_dec = profiled(
            lambda: model.decode(params, cache, tok, offset + L), seen_dec)
    prof = {}
    for label, secs, bd, seen in (("prefill", s_pre, bd_pre, seen_pre),
                                  ("decode step", s_dec, bd_dec, seen_dec)):
        busy = sum(bd.values()) / (1e3 * secs)
        prof[label] = {"wall_ms": 1e3 * secs, "busy": busy,
                       "launches": sum(seen.values())}
        print(f"{tag} {cfg.name} {label} under the profiler: wall "
              f"{1e3 * secs:.3f} ms, device busy {100 * busy:.1f}%, "
              f"{sum(seen.values())} kernel launches; by kernel: {top(bd)}",
              flush=True)
    res["profile"] = prof
    if vlm:
        kv = [x for c in _flat_caches(cache) for x in c]
        res["cache_bytes"] = {"kv": _nbytes(kv)}
        # the least time of a decode step: every weight it multiplies by
        # (the units, the final norm and lm_head; the embedding is
        # gathered a row a token, the projector not used) read once from
        # HBM, and the (k, v) of the live positions
        weights = _nbytes(list(_leaves(params["units"]))
                          + [params["final_norm"], params["lm_head"]])
        live = _nbytes(kv) * (offset + L + 1) // max_len
        bw = peaks(torch.cuda.get_device_name(0))[0]
        res["decode_hbm_bound"] = {
            "weight_bytes": weights, "live_cache_bytes": live,
            "weights_ms": weights / bw * 1e3,
            "ms": (weights + live) / bw * 1e3,
            "share_of_decode_step": (weights + live) / bw
            / (res["decode_ms_per_step"] / 1e3)}
        print(f"{tag} {cfg.name} decode HBM bound: {weights} bytes of "
              f"weights a step ({weights / bw * 1e3:.3f} ms at "
              f"{bw / 1e12:.2f} TB/s) + {live} bytes of live (k, v) = "
              f"{res['decode_hbm_bound']['ms']:.3f} ms against "
              f"{res['decode_ms_per_step']:.3f} ms measured (the bound is "
              f"{100 * res['decode_hbm_bound']['share_of_decode_step']:.1f}"
              "% of the step)", flush=True)
    else:
        res["cache_bytes"] = {"self": _nbytes(cache.self_kv),
                              "cross": _nbytes((cache.cross_k,
                                                cache.cross_v))}
    print(f"{tag} {cfg.name} cache ({str(model.ctx.cache_dtype)[6:]}, "
          f"max_len {max_len}): {res['cache_bytes']} bytes", flush=True)
    del cache

    # continuation: a prefill of the first ``split`` tokens, then the rest
    # of the prompt one decode step at a time (at absolute positions after
    # a VLM's patches), against the generate's prefill of all of it; with a
    # float32 cache, as tests/test_models_consistency.py holds JAX's
    full = pre[0][1].float()
    toks = torch.as_tensor(prompts, device=device)
    f32 = build_model(cfg, Ctx(attn_impl="kernel", cache_dtype=torch.float32),
                      device=device)
    with torch.inference_mode():
        _, cache = f32.prefill(params, {**inputs, "tokens": prompts[:, :split]},
                               max_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(split, L):
            cont, cache = f32.decode(params, cache, toks[:, pos],
                                     offset + pos)
        torch.cuda.synchronize()
    t_cont = time.perf_counter() - t0
    del cache
    cont = cont.float()
    bound = LOGIT_TOL * float(full.abs().max())
    cont_diff = float((cont - full).abs().max())
    print(f"{tag} {cfg.name} continuation, float32 cache: prefill "
          f"{offset} patch + {split} tokens + {L - split} decode steps "
          f"({1e3 * t_cont / (L - split):.3f} ms/step) against the prefill "
          f"of {offset} + {L}: last-position logits max diff "
          f"{cont_diff:.3e}, bound {bound:.3e} (1e-3 x max|logit|)",
          flush=True)
    if not cont_diff <= bound:
        fail(f"{tag} {cfg.name}: prefill + decode differs from the full "
             f"prefill by {cont_diff:.3e} > {bound:.3e}")
    res.update(continuation_max_diff=cont_diff, logit_bound=bound)

    # the plain-attention model (same parameters) on the same inputs
    ref = build_model(cfg, Ctx(attn_impl="ref"), device=device)
    total_mem = torch.cuda.get_device_properties(0).total_memory
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        lr, _ = ref.prefill(params, batch, max_len)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    peak_ref = torch.cuda.max_memory_allocated()
    if counts()["flash_attention"] != 0:
        fail(f"{tag} {cfg.name}: the plain model launched the flash kernel")
    lr = lr.float()
    bound = LOGIT_TOL * float(lr.abs().max())
    diff = float((full - lr).abs().max())
    top2 = lr.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > bound
    same_tok = bool(torch.equal(full.argmax(-1)[sure], lr.argmax(-1)[sure]))
    print(f"{tag} {cfg.name} kernel vs plain model prefill ({t_ref:.3f}s): "
          f"last-position logits max diff {diff:.3e}, bound {bound:.3e} "
          f"(1e-3 x max|logit|); first token equal on {int(sure.sum())} of "
          f"{B} rows with margin > bound: {same_tok}; peak device memory "
          f"{peak_ref / 2**30:.2f} GiB of {total_mem / 2**30:.2f}",
          flush=True)
    if not diff <= bound:
        fail(f"{tag} {cfg.name}: the kernel model's logits differ from the "
             f"plain model's by {diff:.3e} > {bound:.3e}")
    if not same_tok:
        fail(f"{tag} {cfg.name}: first greedy token differs on a row with a "
             "clear margin")
    if not max(peak, peak_ref) < total_mem:
        fail(f"{tag} {cfg.name}: peak device memory "
             f"{max(peak, peak_ref) / 2**30:.2f} GiB >= the card's "
             f"{total_mem / 2**30:.2f}")
    res.update(plain_prefill_s=t_ref, plain_logit_max_diff=diff,
               plain_peak_gib=peak_ref / 2**30)
    del params, full, lr
    _free()
    return res


def encdec_phase(card, flash_row) -> dict:
    """``[encdec]``: the flash kernel at whisper's encoder and
    cross-attention shapes, then whisper-large-v3 served at full width and
    depth.  Adds the phase's flash launches to ``flash_row``."""

    t_phase = time.perf_counter()
    cfg = get_model_config(ENCDEC_ARCH)
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    flash = {
        "encoder": prefill_flash(card, "[encdec]", "whisper encoder",
                                 ENCDEC_BATCH, cfg.encoder_seq_len, H, H, hd,
                                 hd, causal=False),
        "cross": prefill_flash(card, "[encdec]", "whisper cross",
                               ENCDEC_BATCH, ENCDEC_PROMPT, H, H, hd, hd,
                               Lk=cfg.encoder_seq_len, causal=False)}
    rng = np.random.default_rng(13)
    frames = rng.standard_normal(
        (ENCDEC_BATCH, cfg.encoder_seq_len, cfg.d_model), dtype=np.float32)
    prompts = rng.integers(0, cfg.vocab_size, (ENCDEC_BATCH, ENCDEC_PROMPT))
    out = served_family("[encdec]", cfg, {"frames": frames}, prompts,
                        ENCDEC_MAX_LEN, ENCDEC_NEW, ENCDEC_SPLIT,
                        cfg.encoder_layers + 2 * cfg.num_layers)
    out["flash"] = flash
    flash_row["launches"] += out["launches"]
    flash_row["encdec"] = out
    print(f"[encdec] phase: {time.perf_counter() - t_phase:.1f}s of command",
          flush=True)
    return out


def vlm_phase(card, flash_row) -> dict:
    """``[vlm]``: the flash kernel at internvl2's prefill shape, then
    internvl2-76b served at full width and 8 of its 80 layers.  Adds the
    phase's flash launches to ``flash_row``."""

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_model_config(VLM_ARCH),
                              num_layers=VLM_LAYERS)
    flash = prefill_flash(card, "[vlm]", "internvl2", VLM_BATCH,
                          cfg.num_patch_tokens + VLM_PROMPT, cfg.num_heads,
                          cfg.num_kv_heads, cfg.resolved_head_dim,
                          cfg.resolved_head_dim)
    rng = np.random.default_rng(13)
    patches = rng.standard_normal((VLM_BATCH, cfg.num_patch_tokens, 1024),
                                  dtype=np.float32)
    prompts = rng.integers(0, cfg.vocab_size, (VLM_BATCH, VLM_PROMPT))
    out = served_family("[vlm]", cfg, {"patches": patches}, prompts,
                        VLM_MAX_LEN, VLM_NEW, VLM_SPLIT, cfg.num_layers)
    out["flash"] = flash
    flash_row["launches"] += out["launches"]
    flash_row["vlm"] = out
    print(f"[vlm] phase: {time.perf_counter() - t_phase:.1f}s of command",
          flush=True)
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _decode_steps(decode, params, cache, fed, start, device):
    """A decode step for each token of ``fed`` (steps, B) at ``start``,
    ``start + 1``, ...: (logits of every step on the host, seconds of
    every step, the cache)."""

    out, secs = [], []
    for i, tok in enumerate(fed):
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, tok.to(device), start + i)
        _sync(device)
        secs.append(time.perf_counter() - t0)
        out.append(logits.float().cpu())
    return out, secs, cache


def _tp_steps(prefill, decode, params, batch, fed, start, device):
    """A prefill, then ``_decode_steps``: (logits of every step on the
    host, prefill s, decode s of every step, the cache)."""

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    _sync(device)
    t_pre = time.perf_counter() - t0
    out, t_dec, cache = _decode_steps(decode, params, cache, fed, start,
                                      device)
    return [logits.float().cpu()] + out, t_pre, t_dec, cache


def tp_rank(rank, device, cfg, patches, prompts, fed, max_len, ranks):
    """``[tp]``'s rank: its ``init_shard`` shards, a warm-up, the prefill
    and decode steps fed the reference's tokens (its logits returned from
    rank 0, its times the ones reported), then the prefill and
    ``TP_TIMED_STEPS`` decode steps again with rank 0 timing their
    collectives (their shares; the card synchronised around each)."""

    import torch.distributed as dist

    mesh_cfg = MeshConfig(data=1, model=ranks, fsdp=False)
    model = build_model(cfg, Ctx(attn_impl="kernel"), device=device)
    B, L = prompts.shape
    P = cfg.num_patch_tokens
    prefill, info = make_prefill_step(
        model, dist.group.WORLD, mesh_cfg, ShapeConfig("tp", L, B, "prefill"),
        max_len)
    decode, dinfo = make_serve_step(
        model, dist.group.WORLD, mesh_cfg,
        ShapeConfig("tp", max_len - P, B, "decode"))
    t0 = time.perf_counter()
    params = init_shard(TP_SEED, cfg, None, mesh_cfg, rank, device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t_init = time.perf_counter() - t0
    batch = {"patches": patches, "tokens": prompts}
    # warm-up: one short request through both steps on every rank
    _tp_steps(prefill, decode, params,
              {"patches": patches[:1], "tokens": prompts[:1, :64]},
              fed[:1, :1], P + 64, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    n0 = flash_ops.flash_attention.launches
    logits, t_pre, t_dec, cache = _tp_steps(prefill, decode, params, batch,
                                            fed, P + L, device)
    out = {"launches": flash_ops.flash_attention.launches - n0,
           "prefill_s": t_pre, "decode_s": t_dec, "init_s": t_init,
           "param_bytes": _nbytes(_leaves(params)),
           "cache_bytes": _nbytes(x for c in _flat_caches(cache) for x in c),
           "peak_bytes": torch.cuda.max_memory_allocated(device)
           if cuda else 0}
    # the same prefill and decode steps again, rank 0 timing the
    # collectives: it synchronises the card around each (the staged gloo
    # path waits for the card before each one anyway)
    del cache
    tp, dtp = info["model"].ctx.tp, dinfo["model"].ctx.tp
    tp.timed = dtp.timed = rank == 0
    _, t_pre2, t_dec2, cache = _tp_steps(prefill, decode, params, batch,
                                         fed[:TP_TIMED_STEPS], P + L, device)
    tp.timed = dtp.timed = False
    if rank == 0:
        out["timed"] = {"prefill_s": t_pre2, "prefill": tp.stats,
                        "decode_s": t_dec2, "decode": dtp.stats}
        # numpy: a tensor would cross the queue as shared storage that
        # this process takes with it when it exits
        out["logits"] = [x.numpy() for x in logits]
    del params, cache
    return out


def _shares(stats: dict, seconds: float, steps: int = 1) -> dict:
    """{op: calls, seconds and bytes a step, share of the step} of a
    ``TP.stats`` record over ``steps`` steps of ``seconds`` in all."""

    return {op: {"calls": n / steps, "seconds": sec / steps,
                 "bytes": nb / steps, "share": sec / seconds}
            for op, (n, sec, nb) in stats.items()}


def tp_reckoning(cfg, ranks: int, batch: int, max_len: int) -> dict:
    """A rank's bytes of parameters and cache of ``cfg`` at ``ranks``
    tensor-parallel ranks, from its specs on ``meta`` (nothing is
    allocated), beside ``param_count``."""

    mesh_cfg = MeshConfig(data=1, model=ranks, fsdp=False)
    meta = build_model(cfg, device="meta")
    shapes = model_api.param_specs(meta)
    specs = shard_rules.param_pspecs(cfg, shapes, mesh_cfg)
    shape = ShapeConfig("tp", max_len - cfg.num_patch_tokens, batch,
                        "decode")
    cshapes = model_api.cache_specs(meta, batch, max_len)
    cspecs = shard_rules.cache_pspecs_tree(cfg, shape, mesh_cfg, cshapes)
    n = model_api.param_count(cfg)
    return {"layers": cfg.num_layers, "parameters": n,
            "parameter_bytes_all": 4 * n,
            "parameter_bytes_per_rank": shard_nbytes(shapes, specs, mesh_cfg),
            "cache_bytes_per_rank": shard_nbytes(cshapes, cspecs, mesh_cfg)}


def tp_phase(card, flash_row, device="cuda") -> dict:
    """``[tp]``: the flash kernel at a rank's shape (row 5h), then the
    ``[vlm]`` cell served by one process and by ``TP_RANKS`` tensor-parallel
    ranks; see the module docstring.  Adds the phase's flash launches to
    ``flash_row``."""

    t_phase = time.perf_counter()
    full = get_model_config(VLM_ARCH)
    cfg = dataclasses.replace(full, num_layers=VLM_LAYERS)
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    P = cfg.num_patch_tokens
    flash = prefill_flash(card, "[tp]", "internvl2 rank", VLM_BATCH,
                          P + VLM_PROMPT, H // TP_RANKS, Hkv // TP_RANKS, hd,
                          hd)
    rng = np.random.default_rng(13)
    patches = rng.standard_normal((VLM_BATCH, P, 1024), dtype=np.float32)
    prompts = rng.integers(0, cfg.vocab_size, (VLM_BATCH, VLM_PROMPT))
    batch = {"patches": patches, "tokens": prompts}
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    # the reference: one process, the whole model from init_shard(model=1)
    one = MeshConfig(data=1, model=1, fsdp=False)
    model = build_model(cfg, Ctx(attn_impl="kernel"), device=dev)
    prefill, _ = make_prefill_step(
        model, None, one, ShapeConfig("tp", VLM_PROMPT, VLM_BATCH, "prefill"),
        VLM_MAX_LEN)
    decode, _ = make_serve_step(
        model, None, one, ShapeConfig("tp", VLM_MAX_LEN - P, VLM_BATCH,
                                      "decode"))
    t0 = time.perf_counter()
    params = init_shard(TP_SEED, cfg, None, one, 0, dev)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_init = time.perf_counter() - t0
    reset_counts()
    # greedy: each decode step is fed the previous step's argmax
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    sync()
    ref_pre = time.perf_counter() - t0
    ref, fed, ref_dec = [logits.float().cpu()], [], []
    for i in range(VLM_NEW - 1):
        tok = logits.argmax(-1).to(torch.int32)
        fed.append(tok.cpu())
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, tok, P + VLM_PROMPT + i)
        sync()
        ref_dec.append(time.perf_counter() - t0)
        ref.append(logits.float().cpu())
    ref_launches = counts()["flash_attention"]
    ref_peak = torch.cuda.max_memory_allocated() if cuda else 0
    ref_bytes = _nbytes(_leaves(params))
    del model, params, cache, logits, prefill, decode
    _free() if cuda else None
    if ref_launches != cfg.num_layers:
        fail(f"[tp] the reference run launched flash_attention "
             f"{ref_launches} times, expected {cfg.num_layers}")
    fed = torch.stack(fed)                                   # (steps, B)
    ref_ms = 1e3 * statistics.median(ref_dec)
    print(f"[tp] reference, 1 process: {cfg.name} {cfg.num_layers} of 80 "
          f"layers at full width ({ref_bytes / 1e9:.2f} GB of f32 "
          f"parameters, init_shard {t_init:.2f}s); prefill {ref_pre:.3f}s "
          f"of {VLM_BATCH} x ({P} + {VLM_PROMPT}), decode {ref_ms:.3f} "
          f"ms/step (median of {len(ref_dec)}); {ref_launches} flash "
          f"launches; peak {ref_peak / 2**30:.2f} GiB", flush=True)

    marks: list = []
    t0 = time.perf_counter()
    ranks = run_on_grid(tp_rank, (1, TP_RANKS), cfg, patches, prompts, fed,
                        VLM_MAX_LEN, TP_RANKS, device=device, timeout=900,
                        marks=marks)
    t_grid = time.perf_counter() - t0
    backend = pick_backend(device, TP_RANKS)
    launches = [r["launches"] for r in ranks]
    if launches != [cfg.num_layers] * TP_RANKS:
        fail(f"[tp] flash_attention launches by rank {launches}, expected "
             f"{cfg.num_layers} on each of {TP_RANKS}")
    got = ranks[0]["logits"]
    if len(got) != len(ref):
        fail(f"[tp] {len(got)} steps of logits, expected {len(ref)}")
    worst, checked, agree = 0.0, 0, True
    for step, (g, w) in enumerate(zip(got, ref)):
        g = torch.from_numpy(g)
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            fail(f"[tp] step {step}: logits {tuple(g.shape)} not finite or "
                 f"not the reference's {tuple(w.shape)}")
        bound = LOGIT_TOL * float(w.abs().max())
        diff = float((g - w).abs().max())
        worst = max(worst, diff / bound)
        if not diff <= bound:
            fail(f"[tp] step {step}: logits differ from the reference's by "
                 f"{diff:.3e} > {bound:.3e} (1e-3 x max|logit|)")
        top2 = w.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > bound
        checked += int(sure.sum())
        agree &= bool(torch.equal(g.argmax(-1)[sure], w.argmax(-1)[sure]))
    if not agree:
        fail("[tp] a greedy token differs from the reference's where its "
             "top-2 margin exceeds the bound")
    r0 = ranks[0]
    tp_ms = 1e3 * statistics.median(r0["decode_s"])
    timed = r0["timed"]
    shares = {"prefill": _shares(timed["prefill"], timed["prefill_s"]),
              "decode_step": _shares(timed["decode"], sum(timed["decode_s"]),
                                     len(timed["decode_s"]))}
    print(f"[tp] {TP_RANKS} ranks ({backend}, "
          f"{'one card' if backend == 'gloo' else 'a card a rank'}; grid "
          f"{t_grid:.1f}s with start-up {max(m['group_s'] for m in marks):.1f}"
          f"s): prefill {r0['prefill_s']:.3f}s, decode {tp_ms:.3f} ms/step "
          f"(median of {len(r0['decode_s'])}); flash launches by rank "
          f"{launches}; logits' max diff {worst:.3f} x the bound (1e-3 x "
          f"max|logit|) over all {len(ref)} steps, greedy tokens "
          f"equal on all {checked} (row, step) with a margin", flush=True)
    for r, res in enumerate(ranks):
        print(f"[tp] rank {r}: shards {res['param_bytes'] / 1e9:.3f} GB, "
              f"cache {res['cache_bytes'] / 1e9:.3f} GB, peak "
              f"{res['peak_bytes'] / 2**30:.2f} GiB, init_shard "
              f"{res['init_s']:.2f}s", flush=True)
    print(f"[tp] collectives on rank 0, the card synchronised around each "
          f"(the prefill and {len(timed['decode_s'])} decode steps run "
          f"again): prefill {timed['prefill_s']:.3f}s "
          f"{json.dumps(shares['prefill'])}; decode step "
          f"{1e3 * statistics.median(timed['decode_s']):.3f} ms "
          f"{json.dumps(shares['decode_step'])}", flush=True)
    reckon = tp_reckoning(full, TP_RANKS, VLM_BATCH, VLM_MAX_LEN)
    total_mem = (torch.cuda.get_device_properties(0).total_memory
                 if cuda else 0)
    reckon["fits_one_card_a_rank"] = (
        reckon["parameter_bytes_per_rank"] + reckon["cache_bytes_per_rank"]
        < total_mem)
    print(f"[tp] full depth ({full.num_layers} layers) on {TP_RANKS} ranks, "
          f"reckoned from the specs: {reckon['parameters']} parameters "
          f"({reckon['parameter_bytes_all'] / 1e9:.1f} GB of f32); a rank "
          f"holds {reckon['parameter_bytes_per_rank'] / 1e9:.2f} GB of "
          f"weights + {reckon['cache_bytes_per_rank'] / 1e9:.2f} GB of bf16 "
          f"cache at B = {VLM_BATCH}, max_len {VLM_MAX_LEN}, against the "
          f"card's {total_mem / 1e9:.1f} GB", flush=True)
    out = {"launches": ref_launches + sum(launches), "backend": backend,
           "reference": {"prefill_s": ref_pre, "decode_ms_per_step": ref_ms,
                         "peak_gib": ref_peak / 2**30,
                         "parameter_bytes": ref_bytes},
           "ranks": [{k: v for k, v in r.items() if k not in
                      ("logits", "timed")} for r in ranks],
           "prefill_s": r0["prefill_s"], "decode_ms_per_step": tp_ms,
           "collectives": shares, "logit_err_over_bound": worst,
           "greedy_checked": checked, "full_depth": reckon, "flash": flash}
    flash_row["launches"] += out["launches"]
    flash_row["tp"] = out
    print(f"[tp] phase: {time.perf_counter() - t_phase:.1f}s of command",
          flush=True)
    return out


class StateAt(Callback):
    """Keeps a copy of the fit's state at one eval boundary."""

    def __init__(self, unit: int):
        self.unit, self.state = unit, None

    def on_eval(self, unit, cost, state, key):
        if unit == self.unit:
            self.state = State(*(x.clone() for x in state))


def stacks(fn) -> dict[str, int]:
    return {"x".join(map(str, lead)): n for lead, n in fn.by_stack.items()}


def table2_phase(full: bool, card) -> tuple[int, list]:
    """``[table2]``: the paper's Table 2 cells through the port's
    ``paper_tables.run_experiment`` (dense layout, FullGD warm-started
    across checkpoints).  By default exp1-exp5 to their first checkpoint;
    ``full`` runs every checkpoint of exp1-exp6.  Fails unless the cost is
    finite, falls to the first checkpoint and rises by no more than
    FLOOR_RTOL after it, the dense kernel launched, and
    the kernel agrees with its plain version on each experiment's stack
    and fitted state.  Returns the dense kernel's launches and those
    checks."""

    names = [n for n in EXPERIMENTS if full or EXPERIMENTS[n].m < 10000]
    launches, checks = 0, []
    for name in names:
        cfg = EXPERIMENTS[name]
        checkpoints = paper_tables.checkpoints_for(name, full)
        if not full:
            checkpoints = checkpoints[:1]
        t0 = time.perf_counter()
        ds = lowrank_problem(cfg.m, cfg.n, cfg.rank, density=cfg.density,
                             seed=1)
        problem = CompletionProblem.from_dataset(ds, cfg.p, cfg.q, cfg.rank)
        setup = time.perf_counter() - t0
        reset_counts()
        rows, wall, state = paper_tables.run_experiment(
            name, problem=problem, checkpoints=checkpoints)
        got = counts()["masked_factor_grad"]
        launches += got
        n_struct = problem.spec.num_structures
        rounds = rows[-1][0] // n_struct
        print(f"[table2] {name}: {cfg.m}x{cfg.n} grid {cfg.p}x{cfg.q} "
              f"density {cfg.density} B={cfg.p * cfg.q}: cost "
              + " ".join(f"t={t}:{c:.6e}" for t, c in rows)
              + f"; {rounds} FullGD rounds in {wall:.3f}s = "
              f"{1e6 * wall / max(rows[-1][0], 1):.3f} us/iter, "
              f"{1e3 * wall / rounds:.4f} ms/round (cost evals included); "
              f"setup {setup:.2f}s; masked_factor_grad launches {got} by "
              f"stack {stacks(mfg_ops.masked_factor_grad)}", flush=True)
        print(f"[table2] {paper_tables.row(name, rows, wall)}", flush=True)
        costs = [c for _, c in rows]
        if not np.isfinite(costs).all():
            fail(f"table2 {name}: non-finite cost {costs}")
        # falls to the first checkpoint; later ones may sit on the float32
        # floor of a converged fit, where they may not rise past rounding
        if not (costs[1] < costs[0] and all(
                b <= a * (1 + FLOOR_RTOL) for a, b in zip(costs[1:],
                                                          costs[2:]))):
            fail(f"table2 {name}: cost did not fall: {costs}")
        if got == 0:
            fail(f"table2 {name}: masked_factor_grad was never launched")
        checks.append(dense_check(
            f"table2 {name} B={cfg.p * cfg.q}", problem.data.xb,
            problem.data.maskb, state.U, state.W, card))
        del problem, ds, state
    return launches, checks


def state_diff(a: State, b: State) -> dict:
    return {"max_abs_dU": float((a.U - b.U).abs().max()),
            "max_abs_dW": float((a.W - b.W).abs().max()),
            "bitwise": bool(torch.equal(a.U, b.U) and torch.equal(a.W, b.W))}


def gossip_1x1(label, problem, cfg, state0, expect) -> dict[str, int]:
    """Gossip on the 1x1 plan against FullGD from the same state: the
    kernel launched, the states compared (bitwise or not), the cost."""

    trainer = Trainer(cfg)
    trainer.fit(problem, Gossip(num_rounds=2), state=state0)     # warm-up
    full = trainer.fit(problem, FullGD(num_rounds=GOSSIP_ROUNDS,
                                       eval_every=GOSSIP_ROUNDS // 4),
                       state=state0)
    reset_counts()
    obs.reset()
    gos = trainer.fit(problem, Gossip(num_rounds=GOSSIP_ROUNDS,
                                      eval_every=GOSSIP_ROUNDS // 4),
                      state=state0)
    got = counts()
    diff = state_diff(gos.state, full.state)
    c_g, c_f = gos.final_cost, full.final_cost
    diff["cost_rel"] = abs(c_g - c_f) / abs(c_f)
    print(f"[gossip] 1x1 {label}: {GOSSIP_ROUNDS} rounds, Gossip vs FullGD "
          f"from one state: {json.dumps(diff)}; cost {c_g:.6e} vs "
          f"{c_f:.6e}; ms/round gossip "
          f"{1e3 * gos.wall_time / GOSSIP_ROUNDS:.4f} fullgd "
          f"{1e3 * full.wall_time / GOSSIP_ROUNDS:.4f}; halo bytes "
          f"{obs.counter('train_gossip_halo_bytes_total').value:.0f}; "
          f"launches {got} by stack "
          f"{ {fn.__name__: stacks(fn) for fn in STACKED} }", flush=True)
    if got[expect] == 0:
        fail(f"gossip 1x1 {label}: {expect} was never launched")
    if not (diff["max_abs_dU"] < GRID_U_ATOL
            and diff["max_abs_dW"] < GRID_U_ATOL
            and diff["cost_rel"] < GRID_COST_RTOL):
        fail(f"gossip 1x1 {label} disagrees with FullGD: {diff}")
    return got


def grid_reference(recipe, cfg, sched):
    """``sched`` on the 1x1 plan of ``recipe``'s problem from the seed-0
    state: (the fit, the cost at t = 0, the state as numpy)."""

    problem = recipe.build(device="cuda")
    state0 = init_state(torch.Generator(device="cuda").manual_seed(0),
                        problem.spec)
    one = Trainer(cfg).fit(problem, sched, state=state0)
    c0 = problem.total_cost(state0, cfg.lam)
    return one, c0, (state0.U.cpu().numpy(), state0.W.cpu().numpy(), 0)


def check_grid(label, recipe, out, one, c0, rounds=GRID_ROUNDS) -> None:
    """A 2x2 grid's fit against the 1x1 one from the same state, to
    tests/test_distributed.py's tolerance; the halo-byte counter against
    the plan's geometry; the exchange staged."""

    diff = {"max_abs_dU": float(np.abs(out["U"] - one.state.U.cpu().numpy())
                                .max()),
            "max_abs_dW": float(np.abs(out["W"] - one.state.W.cpu().numpy())
                                .max())}
    diff["cost_rel"] = abs(out["history"][-1][1] - one.final_cost) / abs(
        one.final_cost)
    spec = one.problem.spec
    plan = MeshPlan.build(recipe.p, recipe.q, grid=GRID)
    exchange = core_gossip.halo_bytes_per_round(plan, spec.mb, spec.nb,
                                                spec.r)["total_bytes"]
    halo = out["counters"]["train_gossip_halo_bytes_total"]
    blocks = plan.blocks_per_row_shard * plan.blocks_per_col_shard
    print(f"[gossip] 2x2 {label}: {plan.num_devices} {out['backend']} "
          f"processes sharing one card, the exchange staged through pinned "
          f"host buffers: {out['staged']}; B={blocks} a rank; {rounds} "
          f"rounds against 1x1 from one state: {json.dumps(diff)}; cost "
          f"{out['history'][-1][1]:.6e} (1x1 {one.final_cost:.6e}, t=0 "
          f"{c0:.6e}); ms/round 2x2 {out['ms_per_round']:.4f} 1x1 "
          f"{1e3 * one.wall_time / rounds:.4f}; staged bytes/round "
          f"{out['staged_bytes_per_round']:.0f}; "
          f"train_gossip_halo_bytes_total {halo:.0f} = {rounds} "
          f"exchanges x {exchange} B; launches on the ranks "
          f"{out['launches']}; build {out['build_s']:.2f}s warm-up "
          f"{out['warmup_s']:.2f}s", flush=True)
    if not (diff["max_abs_dU"] < GRID_U_ATOL
            and diff["max_abs_dW"] < GRID_U_ATOL
            and diff["cost_rel"] < GRID_COST_RTOL):
        fail(f"gossip 2x2 {label} disagrees with 1x1: {diff}")
    if halo != rounds * exchange:
        fail(f"gossip 2x2 {label}: train_gossip_halo_bytes_total {halo} != "
             f"{rounds} x {exchange}")
    if not out["staged"] or out["staged_bytes_per_round"] <= 0:
        fail(f"gossip 2x2 {label}: the exchange was not staged")


def gossip_phase(sparse, scatter, state0, ml_cfg, card) -> tuple[dict, list]:
    """``[gossip]``: the synchronous Gossip schedule.  1x1 at full size
    (exp3 dense, the ML-1M 5x5 sparse cell with the segment and the
    scatter method) against FullGD; then one 2x2 grid of four gloo
    processes sharing the card, which runs exp1 dense and ML-1M 4x4 sparse
    against 1x1 and staleness 2 with int8 messages on exp1.  Returns the
    kernels' launches (the ranks' included) and the kernels held against
    their plain versions at the shapes this phase adds: the ML-1M 4x4
    stack, and a rank's tile of each 2x2 problem (exp3 and exp1 at 1x1
    are [table2]'s stacks, ML-1M 5x5 is [main]'s)."""

    total = dict.fromkeys(WRAPPERS, 0)

    def add(got):
        for name, n in got.items():
            total[name] += n

    exp3 = EXPERIMENTS["exp3"]
    ds3 = lowrank_problem(exp3.m, exp3.n, exp3.rank, density=exp3.density,
                          seed=1)
    dense3 = CompletionProblem.from_dataset(ds3, exp3.p, exp3.q, exp3.rank)
    st3 = init_state(torch.Generator(device="cuda").manual_seed(0),
                     dense3.spec)
    add(gossip_1x1("exp3 dense B=25", dense3, exp3, st3,
                   "masked_factor_grad"))
    del dense3
    add(gossip_1x1("ML-1M sparse/segment B=25", sparse, ml_cfg, state0,
                   "sddmm_segment_grad"))
    add(gossip_1x1("ML-1M sparse/scatter B=25", scatter, ml_cfg, state0,
                   "sddmm_factor_grad"))

    exp1 = EXPERIMENTS["exp1"]
    rec1 = ProblemRecipe("lowrank_problem", dict(
        m=exp1.m, n=exp1.n, r=exp1.rank, density=exp1.density, seed=1),
        p=exp1.p, q=exp1.q, rank=exp1.rank)
    recml = ML_4X4
    cfg4 = dataclasses.replace(ml_cfg, p=4, q=4)
    sched = Gossip(num_rounds=GRID_ROUNDS, eval_every=GRID_ROUNDS // 3)
    reset_counts()
    one1, c1, st1 = grid_reference(rec1, exp1, sched)
    oneml, cml, stml = grid_reference(recml, cfg4, sched)
    add(counts())
    stale = dataclasses.replace(sched, staleness=2, compression="int8")
    t0 = time.perf_counter()
    try:
        outs = fit_on_grid([FitJob(rec1, exp1, sched, st1),
                            FitJob(rec1, exp1, stale, st1),
                            FitJob(recml, cfg4, sched, stml)],
                           grid=GRID, warmup_rounds=2, timeout=600)
    finally:
        shutdown_grids()        # the forkserver would outlive this phase
    print(f"[gossip] 2x2 grid: 3 fits in {time.perf_counter() - t0:.1f}s; "
          f"slowest rank's seconds from spawn: "
          f"{json.dumps(outs[0]['startup'])}", flush=True)
    for out in outs:
        add(out["launches"])
    check_grid("exp1 dense", rec1, outs[0], one1, c1)
    costs = [c for _, c in outs[1]["history"]]
    print(f"[gossip] 2x2 exp1 dense, staleness=2 compression=int8: cost "
          f"t=0 {c1:.6e} -> {costs}; ms/round {outs[1]['ms_per_round']:.4f};"
          f" train_gossip_halo_bytes_total "
          f"{outs[1]['counters']['train_gossip_halo_bytes_total']:.0f}",
          flush=True)
    if not (np.isfinite(costs).all() and costs[-1] < c1
            and all(b < a for a, b in zip(costs, costs[1:]))):
        fail(f"gossip staleness=2 int8: cost did not fall: {c1} -> {costs}")
    check_grid("ML-1M 4x4 sparse/segment", recml, outs[2], oneml, cml)
    MEASURED["gossip_2x2_ms"] = outs[2]["ms_per_round"]

    plan1 = MeshPlan.build(rec1.p, rec1.q, grid=GRID)
    planml = MeshPlan.build(recml.p, recml.q, grid=GRID)
    d1, s1 = (plan1.local_slice(x, rank=0) for x in (one1.problem.data,
                                                      one1.state))
    sml = oneml.state
    entml = oneml.problem.data.entries
    tile = planml.local_slice((entml, sml), rank=0)
    checks = [
        dense_check("gossip 2x2 exp1 rank-0 tile", d1.xb, d1.maskb, s1.U,
                    s1.W, card),
        segment_check("gossip 1x1 ML-1M 4x4 stack", entml, sml.U, sml.W,
                      card),
        segment_check("gossip 2x2 ML-1M rank-0 tile", tile[0], tile[1].U,
                      tile[1].W, card)]
    return total, checks


def stream_sizes(coo, stream, base, m, n):
    """(per-block append headroom, engine seen headroom) sized from the
    data: the stream's largest per-block count, and how much wider the
    seen table of the grown problem is than the base's."""

    rr, cc, _ = coo
    mb, nb = -(-m // P), -(-n // Q)
    blk = (rr[stream] // mb) * Q + cc[stream] // nb
    headroom = int(np.bincount(blk, minlength=P * Q).max())
    width = {}
    for label, idx in (("base", base), ("grown", np.concatenate([base,
                                                                 stream]))):
        order = np.argsort(rr[idx], kind="stable")
        width[label] = build_seen_table_coo(rr[idx][order], cc[idx][order],
                                            m, n).shape[1]
    return headroom, width["grown"] - width["base"], width


def stream_store_checks(problem, grown, coo, state, card) -> list:
    """The segment kernel on the spliced store: against its plain version
    (``segment_check``), and bitwise against the kernel on a fresh ingest
    of the union at the same capacity, whose arrays must be the same."""

    rr, cc, vv = coo
    sp = grown.data
    E = sp.capacity
    fresh, _ = sparse_store.from_entries(
        rr, cc, np.asarray(vv, np.float32) - problem.mu, *problem.dataset.x
        .shape, P, Q, headroom=E - int(sp.nnz.max()), device="cuda")
    same = [bool(torch.equal(a, b)) for a, b in zip(
        (*sp.entries, sp.nnz), (*fresh.entries, fresh.nnz))]
    got = sddmm_ops.sddmm_segment_grad(sp.entries, state.U, state.W)
    want = sddmm_ops.sddmm_segment_grad(fresh.entries, state.U, state.W)
    bitwise = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    print(f"[stream] appended store against a fresh ingest of the union at "
          f"E={E} (headroom {E - int(sp.nnz.max())}): arrays equal "
          f"{dict(zip(list(sp.entries._fields) + ['nnz'], same))}; segment "
          f"kernel outputs bitwise equal: {bitwise}", flush=True)
    if not all(same):
        fail("[stream] the appended store differs from a fresh ingest of "
             "the union")
    if not bitwise:
        fail("[stream] the segment kernel on the appended store differs "
             "from the kernel on the fresh ingest")
    return [segment_check("stream appended ML-1M B=25", sp.entries,
                          state.U, state.W, card)]


def stream_engine(out, coo, stream, seen_headroom) -> dict:
    """An int8 engine bound to the trainer with a RefreshPolicy; the
    stream appended in batches through ``problem.append`` +
    ``note_append`` while a second thread sends requests.  Returns the
    kernels' launches."""

    rr, cc, vv = coo
    result, trainer = out["result"], out["trainer"]
    policy = RefreshPolicy(max_appends=POLICY_APPENDS)
    obs.reset()
    reset_counts()
    engine = result.to_engine(quant="int8", quant_method="fused",
                              trainer=trainer, refresh_policy=policy,
                              seen_headroom=seen_headroom)
    compiles0 = obs.counter("serve_compiles_total").value
    m = result.problem.num_users
    requests = serve_requests(np.random.default_rng(21), 200, m)
    stop, log, windows = threading.Event(), [], []
    streams = {"main": torch.cuda.current_stream().cuda_stream}

    def client():
        streams["client"] = torch.cuda.current_stream().cuda_stream
        i = 0
        while not stop.is_set():
            users = requests[i % len(requests)]
            i += 1
            before, t0 = engine._bufs, time.perf_counter()
            ans = engine.submit(users).result(timeout=120)
            log.append((users, ans, before, engine._bufs, t0,
                        time.perf_counter()))
            time.sleep(0.002)

    trips = 0
    t_start = time.perf_counter()
    with engine, ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(client)
        try:
            problem = result.problem
            for s in range(0, len(stream), ENGINE_BATCH):
                take = stream[s:s + ENGINE_BATCH]
                problem = problem.append(rr[take], cc[take], vv[take])
                t0 = time.perf_counter()
                if engine.note_append(len(take), problem):
                    trips += 1
                    windows.append((t0, time.perf_counter()))
            time.sleep(0.05)        # answers after the last swap too
        finally:
            stop.set()
        fut.result(timeout=300)
        got = counts()
        by_stack = stacks(sddmm_ops.sddmm_segment_grad)
        by_batch = dict(sorted(quant_ops.dequant_score.by_batch.items()))
        metrics = engine.metrics()
    wall = time.perf_counter() - t_start
    refreshes = obs.counter("engine_refreshes_total").value
    compiles = obs.counter("serve_compiles_total").value
    versions, n_old, n_new, checked = set(), 0, 0, 0
    during, outside = [], []
    for users, (items, scores), before, after, t0, t1 in log:
        versions.update((id(before), id(after)))
        which = []
        for label, idx in (("old", before), ("new", after)):
            ok = True
            for start, length, bucket in engine.ladder.plan(len(users)):
                chunk = np.pad(users[start:start + length],
                               (0, bucket - length))
                ri, rs = recommend_topk(idx, chunk, k=engine.k + 1,
                                        method=engine.quant_method)
                ri, rs = ri.cpu().numpy()[:length], rs.cpu().numpy()[:length]
                tie_free = (np.diff(rs, axis=1) != 0).all(axis=1)
                if not (np.array_equal(scores[start:start + length],
                                       rs[:, :engine.k])
                        and np.array_equal(
                            items[start:start + length][tie_free],
                            ri[tie_free, :engine.k])):
                    ok = False
                    break
            if ok:
                which.append(label)
        if not which:
            fail("[stream] an answer during the stream equals neither the "
                 "old nor the new index's")
        n_old += which[0] == "old"
        n_new += which == ["new"]
        checked += 1
        overlap = any(t0 < b and t1 > a for a, b in windows)
        (during if overlap else outside).append(1e3 * (t1 - t0))
    print(f"[stream] engine: int8, RefreshPolicy(max_appends="
          f"{POLICY_APPENDS}), seen_headroom {seen_headroom}; "
          f"{len(stream)} ratings in batches of {ENGINE_BATCH} in "
          f"{wall:.2f}s; policy trips {trips}, engine_refreshes_total "
          f"{refreshes:.0f}, serve_compiles_total {compiles0:.0f} -> "
          f"{compiles:.0f}; refit+swap seconds "
          f"{[round(b - a, 3) for a, b in windows]}; {checked} answers from "
          f"a second thread, each equal to the old or the new index's "
          f"({n_old} the index live at submit, {n_new} one swapped in while "
          f"it ran; {len(versions)} index versions seen); request ms during "
          f"a refit p50/p99 "
          f"{_pct(during)} ({len(during)}), outside {_pct(outside)} "
          f"({len(outside)}); CUDA stream handle of the main thread "
          f"{streams['main']}, of another thread {streams.get('client')}; "
          f"appends_since_refresh {metrics['appends_since_refresh']}; "
          f"launches {got}; sddmm_segment_grad by stack {by_stack}; "
          f"dequant_score by batch {by_batch}", flush=True)
    if trips != len(stream) // POLICY_APPENDS or refreshes != trips:
        fail(f"[stream] {trips} policy trips and {refreshes} refreshes, "
             f"expected {len(stream) // POLICY_APPENDS}")
    if compiles != compiles0 or compiles0 != len(DEFAULT_BUCKETS):
        fail(f"[stream] serve_compiles_total went {compiles0} -> {compiles}")
    if got["dequant_score"] == 0:
        fail("[stream] dequant_score was never launched")
    if len(versions) < 2 or checked == 0:
        fail("[stream] no request was answered across a refresh")
    return got


def _pct(ms: list) -> str:
    if not ms:
        return "n/a"
    return f"{np.percentile(ms, 50):.3f}/{np.percentile(ms, 99):.3f}"


def stream_gossip(sparse, state0, ml_cfg, card) -> tuple[dict, list]:
    """``Gossip(batch=)`` on the ML-1M cell on 1x1, then a 2x2 grid of the
    4x4 cut against 1x1 from one state and stream; the segment kernel on
    a (5, 5) minibatch and a rank's (2, 2) minibatch tile."""

    total = dict.fromkeys(WRAPPERS, 0)
    sched = Gossip(num_rounds=MB_ROUNDS, eval_every=MB_ROUNDS // 4,
                   batch=MB_BATCH)
    reset_counts()
    one = Trainer(ml_cfg).fit(sparse, sched, state=state0)
    c0 = sparse.total_cost(state0, ml_cfg.lam)
    costs = [c for _, c in one.history]
    got = counts()
    print(f"[stream] Gossip(batch={MB_BATCH}) 1x1 ML-1M 5x5: {MB_ROUNDS} "
          f"rounds, cost t=0 {c0:.6e} -> {costs}; "
          f"{1e3 * one.wall_time / MB_ROUNDS:.4f} ms/round (the host draw "
          f"included); held-out RMSE {one.rmse():.6f}; launches {got} by "
          f"stack {stacks(sddmm_ops.sddmm_segment_grad)}", flush=True)
    if not (np.isfinite(costs).all() and costs[-1] < c0):
        fail(f"[stream] Gossip(batch=) 1x1: cost did not fall: {c0} -> "
             f"{costs}")
    for name, n in got.items():
        total[name] += n
    stream = MinibatchStream(sparse.data, MB_BATCH, seed=0)
    mbat = stream.batch_at(0)
    checks = [segment_check("stream minibatch ML-1M B=25", mbat.entries,
                            one.state.U, one.state.W, card)]

    cfg4 = dataclasses.replace(ml_cfg, p=4, q=4)
    reset_counts()
    oneml, cml, stml = grid_reference(ML_4X4, cfg4, sched)
    for name, n in counts().items():
        total[name] += n
    try:
        out, = fit_on_grid([FitJob(ML_4X4, cfg4, sched, stml)], grid=GRID,
                           warmup_rounds=2, timeout=600)
    finally:
        shutdown_grids()        # the forkserver would outlive this phase
    for name, n in out["launches"].items():
        total[name] += n
    check_grid(f"ML-1M 4x4 sparse/segment Gossip(batch={MB_BATCH})", ML_4X4,
               out, oneml, cml, rounds=MB_ROUNDS)
    plan = MeshPlan.build(ML_4X4.p, ML_4X4.q, grid=GRID)
    full = MinibatchStream(oneml.problem.data, MB_BATCH, seed=0).batch_at(0)
    tile_sp, tile_st = plan.local_slice((oneml.problem.data, oneml.state),
                                        rank=0)
    mine = MinibatchStream(tile_sp, MB_BATCH, seed=0, plan=plan).batch_at(0)
    want = plan.local_slice(full, rank=0)
    if not all(bool(torch.equal(a, b)) for a, b in zip(
            (*mine.entries, mine.nnz), (*want.entries, want.nnz))):
        fail("[stream] rank 0's minibatch differs from its tile of the 1x1 "
             "minibatch")
    print("[stream] rank 0's minibatch on the card equals its tile of the "
          "1x1 minibatch, field for field", flush=True)
    checks.append(segment_check("stream minibatch 2x2 ML-1M rank-0 tile",
                                mine.entries, tile_st.U, tile_st.W, card))
    return total, checks


def stream_dense(card) -> dict:
    """exp3 on the dense layout: a base fit, an append, one refit."""

    exp3 = EXPERIMENTS["exp3"]
    ds3 = lowrank_problem(exp3.m, exp3.n, exp3.rank, density=exp3.density,
                          seed=1)
    (rr, cc, vv), (base, stream) = streaming.split(ds3, STREAM_FRAC)
    dense = CompletionProblem.from_entries(
        rr[base], cc[base], vv[base], ds3.x.shape, exp3.p, exp3.q,
        exp3.rank, layout="dense", dataset=ds3)
    trainer = Trainer(exp3)
    fit = trainer.fit(dense, FullGD(num_rounds=50), seed=1)
    grown = dense.append(rr[stream], cc[stream], vv[stream])
    c_before = grown.total_cost(fit.state, exp3.lam)
    reset_counts()
    ref = trainer.refit(fit, grown)
    torch.cuda.synchronize()
    got = counts()
    print(f"[stream] exp3 dense: {len(stream)} ratings appended to "
          f"{len(base)}; Trainer.refit (Incremental, 40 Wave rounds) cost "
          f"{c_before:.6e} -> {ref.final_cost:.6e} in {ref.wall_time:.3f}s; "
          f"launches {got} by stack "
          f"{stacks(mfg_ops.masked_factor_grad)}", flush=True)
    if not (np.isfinite(ref.final_cost) and ref.final_cost < c_before):
        fail(f"[stream] exp3 dense refit: cost {c_before} -> "
             f"{ref.final_cost}")
    if got["masked_factor_grad"] == 0:
        fail("[stream] exp3 dense refit: masked_factor_grad never launched")
    return got


def stream_phase(ds, sparse, state0, cfg, card) -> tuple[dict, list]:
    """``[stream]``: the streaming loop at the Table 3 cell (see the
    module docstring).  Returns the kernels' launches and the shapes held
    against their plain versions."""

    t_phase = time.perf_counter()
    total = dict.fromkeys(WRAPPERS, 0)

    def add(got):
        for name, n in got.items():
            total[name] += n

    coo, (base, stream) = streaming.split(ds, STREAM_FRAC)
    m, n = ds.x.shape
    headroom, seen_headroom, widths = stream_sizes(coo, stream, base, m, n)
    problem, ingest_ms = streaming.ingest(ds, coo, base, P, Q, RANK,
                                          headroom=headroom,
                                          mean_center=True)
    print(f"[stream] ingest: {len(base)} of {len(base) + len(stream)} "
          f"training ratings in {ingest_ms:.1f} ms, headroom {headroom} "
          f"(the stream's largest per-block count), capacity "
          f"{problem.data.capacity}/block, largest block "
          f"{int(problem.data.nnz.max())}; seen table width {widths} -> "
          f"seen_headroom {seen_headroom}", flush=True)
    before = [t.clone() for t in (*problem.data.entries, problem.data.nnz)]
    sweep = streaming.append_sweep(problem, coo, stream, STREAM_BATCHES)
    streaming.print_appends(sweep, len(stream))
    if not all(bool(torch.equal(a, b)) for a, b in zip(
            before, (*problem.data.entries, problem.data.nnz))):
        fail("[stream] the append sweep changed the base store")
    print(f"[stream] append sweep {json.dumps(sweep)}; the base store is "
          f"unchanged", flush=True)
    del before

    reset_counts()
    out = streaming.refit_vs_cold(
        problem, coo, stream, cfg,
        FullGD(num_rounds=FULL_ROUNDS, eval_every=FULL_ROUNDS // 4))
    got = counts()
    add(got)
    streaming.print_refit(out, len(stream))
    result, refit, cold = out["result"], out["refit"], out["cold"]
    c_warm = out["fresh"].total_cost(result.state, cfg.lam)
    rmse = {k: out[k].rmse() for k in ("result", "refit", "cold")}
    gate = abs(rmse["refit"] - rmse["cold"]) <= 1e-3
    print(f"[stream] fits: base FullGD {FULL_ROUNDS} rounds RMSE "
          f"{rmse['result']:.6f} ({out['wall_s']['initial fit']:.3f}s), "
          f"refit Incremental {out['rounds']['warm refit']} Wave rounds "
          f"RMSE {rmse['refit']:.6f} ({out['wall_s']['warm refit']:.3f}s), "
          f"cold FullGD RMSE {rmse['cold']:.6f} "
          f"({out['wall_s']['cold fit']:.3f}s); refit cost {c_warm:.6e} -> "
          f"{refit.final_cost:.6e}; the reference's gate (refit RMSE within "
          f"1e-3 of the cold fit's) holds: {gate}; launches {got} by stack "
          f"{stacks(sddmm_ops.sddmm_segment_grad)}", flush=True)
    costs = [c for _, c in result.history + refit.history + cold.history]
    if not np.isfinite(costs).all():
        fail(f"[stream] non-finite cost {costs}")
    if not refit.final_cost < c_warm:
        fail(f"[stream] the refit's cost did not fall: {c_warm} -> "
             f"{refit.final_cost}")
    checks = stream_store_checks(problem, out["fresh"], coo, result.state,
                                 card)

    add(stream_engine(out, coo, stream, seen_headroom))
    got, mb_checks = stream_gossip(sparse, state0, cfg, card)
    add(got)
    checks += mb_checks
    add(stream_dense(card))
    print(f"[stream] phase: {time.perf_counter() - t_phase:.1f}s of command; "
          f"launches {total}", flush=True)
    return total, checks


def grid_rmse(out, problem) -> float:
    """Held-out RMSE of a grid job's gathered factors on ``problem`` (the
    global problem of the job's recipe)."""

    dev = problem.device
    state = State(torch.as_tensor(out["U"], device=dev),
                  torch.as_tensor(out["W"], device=dev),
                  torch.tensor(out["t"], device=dev))
    return FitResult(state, out["history"], out["wall_time"], "gossip",
                     problem).rmse()


def same(a, b) -> bool:
    return bool(np.array_equal(a["U"], b["U"])
                and np.array_equal(a["W"], b["W"]))


def faults_jobs(ml_cfg, tmp) -> dict:
    """``[faults]``'s grid jobs by label, in the order they run."""

    cfg4 = dataclasses.replace(ml_cfg, p=4, q=4)
    base = Gossip(num_rounds=FAULT_ROUNDS, eval_every=FAULT_EVAL)

    def ml(sched, **kw):
        return FitJob(ML_4X4, cfg4, sched, **kw)

    jobs = {"clean": ml(base),
            "p=0": ml(dataclasses.replace(base, faults=FaultPlan(key=0)))}
    for pd in FAULT_DROPS:
        for bound in FAULT_BOUNDS:
            jobs[f"p_drop={pd} max_staleness={bound}"] = ml(
                dataclasses.replace(base, max_staleness=bound, faults=FaultPlan(
                    key=0, p_drop_edge=pd)))
    jobs[f"p_straggle={FAULT_STRAGGLE} max_staleness=1"] = ml(
        dataclasses.replace(base, max_staleness=1, faults=FaultPlan(
            key=0, p_straggle=FAULT_STRAGGLE)))
    jobs[f"sync batch={MB_BATCH}"] = ml(dataclasses.replace(
        base, batch=MB_BATCH))
    for e in ASYNC_EVERY:
        asy = dataclasses.replace(base, async_rounds=True, exchange_every=e,
                                  max_staleness=e - 1)
        jobs[f"async e={e}"] = ml(asy)
        jobs[f"async e={e} batch={MB_BATCH}"] = ml(dataclasses.replace(
            asy, batch=MB_BATCH))
    jobs["nan_at"] = ml(
        dataclasses.replace(base, eval_every=NAN_EVAL,
                            faults=FaultPlan(nan_at=NAN_AT)),
        callbacks=(Checkpoint(CheckpointManager(
            os.path.join(tmp, "nan"), keep=FAULT_ROUNDS // NAN_EVAL)),),
        recovery=RecoveryPolicy())
    jobs["stopped"] = ml(base, callbacks=(
        Checkpoint(os.path.join(tmp, "stop")), StopAt(2 * FAULT_EVAL)))
    jobs["resumed"] = ml(base, resume_from=os.path.join(tmp, "stop"))
    # the clean fit again, last: the spread of a job's ms/round by its
    # place in the list, beside the fault path's cost
    jobs["clean, last"] = ml(base)
    exp1 = EXPERIMENTS["exp1"]
    rec1 = ProblemRecipe("lowrank_problem", dict(
        m=exp1.m, n=exp1.n, r=exp1.rank, density=exp1.density, seed=1),
        p=exp1.p, q=exp1.q, rank=exp1.rank)
    for label, sched in (
            ("exp1 clean", base),
            ("exp1 p=0", dataclasses.replace(base, faults=FaultPlan(key=0))),
            ("exp1 async e=1", dataclasses.replace(
                base, async_rounds=True, max_staleness=0))):
        jobs[label] = FitJob(rec1, exp1, sched)
    return jobs


def wave_resume(sparse, ml_cfg, tmp) -> dict[str, int]:
    """A 1x1 Wave fit of the Table 3 cell stopped after its second
    checkpoint and resumed, against the uninterrupted fit: bitwise."""

    sched = Wave(num_rounds=WAVE_ROUNDS, eval_every=WAVE_EVAL)
    reset_counts()
    whole = Trainer(ml_cfg).fit(sparse, sched, seed=3)
    ck = Checkpoint(os.path.join(tmp, "wave"))
    try:
        Trainer(ml_cfg, callbacks=[ck, StopAt(2 * WAVE_EVAL)]).fit(
            sparse, sched, seed=3)
        fail("[faults] StopAt did not stop the Wave fit")
    except FitStopped:
        pass
    resumed = Trainer(ml_cfg).fit(sparse, sched, seed=3,
                                  resume_from=ck.manager.directory)
    got = counts()
    bitwise = bool(torch.equal(whole.state.U, resumed.state.U)
                   and torch.equal(whole.state.W, resumed.state.W))
    print(f"[faults] 1x1 Wave ML-1M 5x5, {WAVE_ROUNDS} rounds: stopped at "
          f"unit {2 * WAVE_EVAL} after checkpoints {ck.manager.valid_steps()},"
          f" resumed: bitwise the uninterrupted fit: {bitwise}; cost "
          f"{resumed.final_cost:.6e}; launches {got}", flush=True)
    if not bitwise:
        fail("[faults] the resumed 1x1 Wave fit differs from the "
             "uninterrupted one")
    return got


def faults_phase(sparse, ml_cfg, card) -> tuple[dict, dict]:
    """``[faults]``: fault injection, staleness gates, asynchronous rounds,
    self-healing and resume on one 2x2 grid of four gloo processes on the
    card (ML-1M 4x4 sparse/segment, 300 rounds a job; exp1 dense for the
    bitwise cases), then a 1x1 Wave resume.  Returns the kernels' launches
    (the ranks' included) and the segment and dense kernels' launches by
    stack shape."""

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-faults-")
    jobs = faults_jobs(ml_cfg, tmp)
    t0 = time.perf_counter()
    try:
        outs = fit_on_grid(list(jobs.values()), grid=GRID, warmup_rounds=2,
                           timeout=600)
    finally:
        shutdown_grids()        # the forkserver would outlive this phase
    print(f"[faults] 2x2 grid: {len(jobs)} fits in "
          f"{time.perf_counter() - t0:.1f}s; slowest rank's seconds from "
          f"spawn: {json.dumps(outs[0]['startup'])}", flush=True)
    out = dict(zip(jobs, outs))
    total = dict.fromkeys(WRAPPERS, 0)
    by_stack: dict = {}
    for o in outs:
        for name, n in o["launches"].items():
            total[name] += n
        for name, got in o["launches_by_stack"].items():
            mine = by_stack.setdefault(name, {})
            for lead, n in got.items():
                mine[lead] = mine.get(lead, 0) + n

    problem = ML_4X4.build(device=sparse.device)
    spec = problem.spec
    plan = MeshPlan.build(ML_4X4.p, ML_4X4.q, grid=GRID)
    exists = edges_exist(plan)
    exchange = core_gossip.halo_bytes_per_round(
        plan, spec.mb, spec.nb, spec.r)["total_bytes"]
    clean = out["clean"]
    clean_rmse = grid_rmse(clean, problem)
    for label, o in out.items():
        if o["diverged"] is not None or (
                o["stopped_at"] is None and not np.isfinite(
                    [c for _, c in o["history"]]).all()):
            fail(f"[faults] {label}: {o['diverged'] or o['history']}")

    def line(label, o, extra=""):
        c = o["counters"]
        rmse = grid_rmse(o, problem)
        # a restarted fit's wall time is its last attempt's
        ms = "n/a (restarted)" if o["recovery_log"] else \
            f"{o['ms_per_round']:.4f}"
        print(f"[faults] {label}: held-out RMSE {rmse:.6f} "
              f"(rmse_vs_clean {rmse / clean_rmse:.6f}), cost "
              f"{o['history'][-1][1]:.6e}, {ms} ms/round;"
              f" dropped {c['gossip_edges_dropped_total']:.0f} stale "
              f"{c['gossip_stale_rounds_total']:.0f} straggled "
              f"{c['gossip_straggled_edges_total']:.0f} skipped "
              f"{c['gossip_skipped_exchanges_total']:.0f} halo bytes "
              f"{c['train_gossip_halo_bytes_total']:.0f}{extra}", flush=True)

    # (a) clean, and p = 0 bitwise it
    line("clean", clean)
    line("clean, last", out["clean, last"], f"; bitwise the first: "
         f"{same(clean, out['clean, last'])}")
    line("FaultPlan(p=0)", out["p=0"], f"; bitwise the clean fit: "
         f"{same(clean, out['p=0'])}")
    if not (same(clean, out["p=0"]) and same(clean, out["clean, last"])):
        fail("[faults] FaultPlan(p=0) or the last clean fit differs from "
             "the clean fit")
    # (b) drops x staleness bounds, one straggle case: observed == replay
    for label in [k for k in jobs if k.startswith(("p_drop", "p_straggle"))]:
        fp = jobs[label].schedule.faults
        rp = fp.replay(FAULT_ROUNDS, plan.num_devices)
        want = (expected_drops(fp, plan, FAULT_ROUNDS),
                int((rp["straggles"] & ~rp["drops"] & exists[None]).sum()))
        c = out[label]["counters"]
        got = (c["gossip_edges_dropped_total"],
               c["gossip_straggled_edges_total"])
        line(label, out[label], f"; replay: dropped {want[0]} straggled "
             f"{want[1]}")
        if got != want:
            fail(f"[faults] {label}: observed (dropped, straggled) {got}, "
                 f"FaultPlan.replay says {want}")
    # (c) the async regime: the skip count and halo bytes exactly, e = 1
    # bitwise the synchronous fit
    for e in ASYNC_EVERY:
        for suffix, sync in (("", "clean"), (f" batch={MB_BATCH}",
                                             f"sync batch={MB_BATCH}")):
            label = f"async e={e}{suffix}"
            o = out[label]
            check_skips(label, FAULT_ROUNDS, e, o["counters"])
            n_ex = -(-FAULT_ROUNDS // e)
            halo = o["counters"]["train_gossip_halo_bytes_total"]
            bitwise = same(o, out[sync])
            line(label, o, f"; against {sync} {out[sync]['ms_per_round']:.4f}"
                 f" ms/round; halo bytes = {n_ex} exchanges x {exchange}; "
                 f"bitwise {sync}: {bitwise}")
            if halo != n_ex * exchange:
                fail(f"[faults] {label}: halo bytes {halo} != {n_ex} x "
                     f"{exchange}")
            if e == 1 and not bitwise:
                fail(f"[faults] {label} differs from {sync}")
    # (d) nan_at with Checkpoint(every=1) and RecoveryPolicy()
    o = out["nan_at"]
    log = o["recovery_log"]
    if len(log) != 1 or log[0]["resumed_from"] > NAN_AT:
        fail(f"[faults] nan_at={NAN_AT}: recovery log {log}")
    step, tree = CheckpointManager(os.path.join(tmp, "nan")).restore(
        {"U": 0, "W": 0, "t": 0}, step=log[0]["resumed_from"],
        device=problem.device)
    restored = problem.total_cost(State(tree["U"], tree["W"], tree["t"]),
                                  ml_cfg.lam)
    after = [c for _, c in o["history"]]
    line(f"nan_at={NAN_AT}", o, f"; recovery_log {json.dumps(log)}; cost "
         f"restored at unit {step} {restored:.6e} -> {after}; clean final "
         f"cost {clean['history'][-1][1]:.6e}")
    if not all(np.isfinite(c) and c < restored for c in after):
        fail(f"[faults] after the restart the cost did not fall below the "
             f"restored {restored}: {after}")
    # (e) stopped after its second checkpoint, resumed: bitwise
    o = out["resumed"]
    print(f"[faults] stopped at unit {out['stopped']['stopped_at']}, resumed "
          f"for {o['counters']['train_gossip_rounds_total']:.0f} rounds: "
          f"bitwise the uninterrupted fit: {same(clean, o)}", flush=True)
    if out["stopped"]["stopped_at"] != 2 * FAULT_EVAL or not same(clean, o):
        fail("[faults] the resumed 2x2 fit differs from the uninterrupted "
             "one")
    # exp1 dense: p = 0 and async e = 1 bitwise the clean fit
    e1 = {k: same(out["exp1 clean"], out[k])
          for k in ("exp1 p=0", "exp1 async e=1")}
    print(f"[faults] exp1 dense 2x2, {FAULT_ROUNDS} rounds: bitwise the "
          f"clean fit: {e1}; cost {out['exp1 clean']['history'][-1][1]:.6e};"
          f" {out['exp1 clean']['ms_per_round']:.4f} ms/round", flush=True)
    if not all(e1.values()):
        fail(f"[faults] exp1: {e1}")
    for name in ("sddmm_segment_grad", "masked_factor_grad"):
        if total[name] == 0:
            fail(f"[faults] {name} was never launched on the ranks")
    for name, n in wave_resume(sparse, ml_cfg, tmp).items():
        total[name] += n
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"[faults] phase: {time.perf_counter() - t_phase:.1f}s of command; "
          f"launches {total}, on the ranks by stack {json.dumps(by_stack)}",
          flush=True)
    return total, by_stack


# ---------------------------------------------------------------------- #
# [sharded]: owner-routed ingest and item-sharded serving on a 2x2 grid
# ---------------------------------------------------------------------- #


def _tiles_equal(a, b) -> bool:
    """Every array of two stores (entries and nnz) bitwise equal."""

    return all(torch.equal(x, y) for x, y in zip((*a.entries, a.nnz),
                                                 (*b.entries, b.nnz)))


def _synced(fn):
    """(fn(), its wall seconds, ended by a synchronize of the card)."""

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def ml_split():
    """The ML-1M proxy's training ratings as COO, and a seeded split into
    (base, the SHARD_APPEND appended ratings)."""

    ds = movielens_proxy()
    rr, cc = np.nonzero(ds.train_mask)
    perm = np.random.default_rng(0).permutation(len(rr))
    return ds, (rr, cc, ds.x[rr, cc]), perm[SHARD_APPEND:], perm[:SHARD_APPEND]


def sharded_ingest_ml(rank, device, ml_cfg) -> dict:
    """Part a on one rank: the ML-1M 4x4 cell ingested owner-routed
    against the global pack-and-slice, bitwise; Gossip on both stores from
    one state, bitwise; ``f_grads_sharded`` against the tile of the 1x1
    gradients; a routed append against the tile of the global append."""

    seg = sddmm_ops.sddmm_segment_grad
    ds, (rr, cc, vv), base, stream = ml_split()
    plan = MeshPlan.build(4, 4, grid=GRID)
    mb, nb = -(-ds.x.shape[0] // 4), -(-ds.x.shape[1] // 4)
    headroom = int(np.bincount((rr[stream] // mb) * 4 + cc[stream] // nb,
                               minlength=16).max())
    kw = dict(headroom=headroom, mean_center=True, dataset=ds, device=device)
    args = (rr[base], cc[base], vv[base], ds.x.shape, 4, 4, RANK)
    routed, t_routed = _synced(lambda: CompletionProblem.from_entries(
        *args, plan=plan, **kw))
    whole, t_whole = _synced(lambda: CompletionProblem.from_entries(
        *args, **kw))
    sliced, t_slice = _synced(lambda: whole.with_plan(plan))
    out = {"ingest_routed_s": t_routed,
           "ingest_global_s": t_whole + t_slice,
           "tiles_bitwise": _tiles_equal(routed.data, sliced.data),
           "E": routed.data.capacity, "nnz": int(routed.data.nnz.sum())}
    cfg4 = dataclasses.replace(ml_cfg, p=4, q=4)
    state0 = init_state(torch.Generator(device=device).manual_seed(0),
                        routed.spec)
    sched = Gossip(num_rounds=GRID_ROUNDS, eval_every=GRID_ROUNDS // 3)
    n0 = seg.launches
    fit = Trainer(cfg4).fit(routed, sched, state=state0)
    out["fit_launches"] = seg.launches - n0
    ref = Trainer(cfg4).fit(sliced, sched, state=state0)
    out["fit_bitwise"] = bool(torch.equal(fit.state.U, ref.state.U)
                              and torch.equal(fit.state.W, ref.state.W))
    out["fit_cost"] = fit.final_cost
    n0 = seg.launches
    gu, gw = f_grads_sharded(ShardedEntries(routed.data, plan, rank),
                             fit.state.U, fit.state.W)
    out["grads_launches"] = seg.launches - n0
    want = f_grads_sparse(whole.data.entries, fit.state.U, fit.state.W)
    out["grads_rel"] = compare((gu, gw), plan.local_slice(
        (want[1], want[2]), rank))[1]
    grown, t_append = _synced(lambda: routed.append(
        rr[stream], cc[stream], vv[stream]))
    want = plan.local_slice(whole.append(rr[stream], cc[stream],
                                         vv[stream]).data, rank)
    out.update(append_s=t_append, append_bitwise=_tiles_equal(grown.data,
                                                              want))
    return out


def netflix_coo(seed: int = 7):
    """NETFLIX["ratings"] distinct seeded (user, movie) pairs of the
    Netflix Prize shape, rated 1..5."""

    m, n, count = NETFLIX["m"], NETFLIX["n"], NETFLIX["ratings"]
    rng = np.random.default_rng(seed)
    lin = np.unique(rng.integers(0, m * n, count + count // 500))
    lin = np.sort(rng.choice(lin, count, replace=False))
    vals = rng.integers(1, 6, count).astype(np.float32)
    return lin // n, lin % n, vals


def sharded_ingest_netflix(rank, device) -> dict:
    """Part b on one rank: the Netflix-shape ratings ingested owner-routed
    against the global pack-and-slice, bitwise, with their seconds."""

    rows, cols, vals = netflix_coo()
    m, n, p, q = (NETFLIX[k] for k in ("m", "n", "p", "q"))
    plan = MeshPlan.build(p, q, grid=GRID)
    (sh, _), t_routed = _synced(lambda: ShardedEntries.from_coo(
        rows, cols, vals, m, n, plan, rank=rank, device=device))
    (whole, _), t_pack = _synced(lambda: sparse_store.from_entries(
        rows, cols, vals, m, n, p, q, device="cpu"))

    def cut():
        host = plan.local_slice(whole, rank)
        return sparse_store.SparseProblem(
            type(host.entries)(*(t.to(device) for t in host.entries)),
            host.nnz.to(device))

    tile, t_slice = _synced(cut)
    return {"ingest_routed_s": t_routed, "ingest_global_s": t_pack + t_slice,
            "tiles_bitwise": _tiles_equal(sh.sp, tile),
            "E": sh.capacity, "nnz": int(sh.nnz.sum())}


def production_serving(rank, device) -> dict:
    """Part d on one rank: the PRODUCTION catalog (seeded factors, every
    rank the same) quantized and served item-sharded by an int8 engine at
    every bucket; rank 0 then holds PROD_COMPARE users' answers against
    the unsharded int8 path, bitwise."""

    cfg = PRODUCTION
    m, n, r = cfg.m, cfg.n, cfg.rank
    torch.cuda.reset_peak_memory_stats(device)
    g = torch.Generator(device=device).manual_seed(31)
    u = torch.randn((m, r), generator=g, device=device)
    w = torch.randn((n, r), generator=g, device=device)
    seen = torch.randint(0, n, (m, PROD_SEEN), generator=g, device=device,
                         dtype=torch.int32)
    width = -(-PROD_SEEN // 16) * 16                # build_seen_table's pad
    seen = torch.cat([seen, torch.full((m, width - PROD_SEEN), n,
                                       dtype=torch.int32, device=device)], 1)
    factor_bytes = (u.numel() + w.numel()) * 4
    qidx = quantize_index(RecommendIndex(u, w, seen))
    del u, w
    obs.reset()                     # this engine's latencies only
    q0 = quant_ops.dequant_score.launches
    engine, startup = _synced(lambda: ServingEngine(
        qidx, buckets=DEFAULT_BUCKETS, k=PROD_K, plan=MeshPlan.for_world(
            GRID[0] * GRID[1]), seen_headroom=0, quant_method="fused"))
    shard = engine._bufs.index
    out = {"startup_s": startup, "shard_items": engine._bufs.shard_items,
           "factor_f32_bytes": factor_bytes,
           "held_int8_bytes": sum(t.numel() * t.element_size() for t in (
               shard.u_q, shard.u_scale, shard.w_q, shard.w_scale)),
           "seen_bytes": shard.seen.numel() * 4}
    rng = np.random.default_rng(41)
    users = rng.choice(m, PROD_COMPARE, replace=False).astype(np.int32)
    with engine:
        if rank == 0:
            for b in DEFAULT_BUCKETS:
                for _ in range(PROD_REQUESTS):
                    engine.recommend(rng.integers(0, m, b).astype(np.int32))
            got = engine.recommend(users)
            metrics = engine.metrics()
            out["buckets"] = {b: metrics["buckets"][b]
                              for b in DEFAULT_BUCKETS}
    out["launches"] = quant_ops.dequant_score.launches - q0
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if rank == 0:
        del engine, shard
        items, scores = recommend_topk(qidx, users, k=PROD_K,
                                       method="fused")
        out["bitwise"] = bool(np.array_equal(got[0], items.cpu().numpy())
                              and np.array_equal(got[1].view(np.int32),
                                                 scores.cpu().numpy().view(
                                                     np.int32)))
    return out


def sharded_rank(rank, device, ml_cfg, jobs) -> dict:
    """``[sharded]``'s rank body: parts a-d in turn, a barrier after
    each, so that no part's timing shares the card with another's."""

    import torch.distributed as dist

    seg = sddmm_ops.sddmm_segment_grad
    out = {"rank": rank}
    t0 = time.perf_counter()
    out["a"] = sharded_ingest_ml(rank, device, ml_cfg)
    dist.barrier()
    out["b"] = sharded_ingest_netflix(rank, device)
    dist.barrier()
    n0 = seg.launches
    out["c"] = {label: serve_fit_rank(rank, device, job, GRID)
                for label, job in jobs.items()}
    out["c_fit_launches"] = seg.launches - n0
    dist.barrier()
    out["floor"] = collective_floor(device, PROD_K)
    out["d"] = production_serving(rank, device)
    out["seconds"] = time.perf_counter() - t0
    return out


def topk_tie_timing(index) -> dict:
    """``recommend_topk``'s ordered top-k at the top bucket of the fitted
    index, on the masked (1024, n) scores it selects from: eager ms of
    ``topk_ordered`` (a float ``topk``, then the rows with a tie selected
    again), of the int64-key selection over every row (``_keyed_topk``,
    which it replaced), and of a bare ``torch.topk``; with the rows that
    were selected again and a check that both orders agree."""

    users = torch.arange(0, TOP_BUCKET * 5, 5, device="cuda") % \
        index.num_users
    scores = torch.nn.functional.pad(index.u[users] @ index.w.T, (0, 1))
    scores.scatter_(1, index.seen[users].long(), float("-inf"))
    scores = scores[:, :index.num_items].contiguous()
    vals = torch.topk(scores, 11).values            # topk_ordered's test
    redo = ~(vals[:, 1:] < vals[:, :-1]).all(1)
    same = torch.equal(topk_ordered(scores, 10)[1],
                       _keyed_topk(scores, 10, None))
    return {"shape": list(scores.shape), "rows_redone": int(redo.sum()),
            "same_as_keyed": same,
            "ordered_ms": eager_ms(lambda: topk_ordered(scores, 10)),
            "keyed_ms": eager_ms(lambda: _keyed_topk(scores, 10, None)),
            "torch_topk_ms": eager_ms(lambda: torch.topk(scores, 10))}


def sharded_phase(ml_cfg, fitted, card) -> tuple[dict, list, list]:
    """``[sharded]``: one 2x2 grid of four gloo processes on the card runs
    parts a-d (``sharded_rank``); then, in this process, the segment
    kernel on a Netflix-shape rank tile and the int8 score kernel at a
    PRODUCTION shard's shape against their plain versions, and the tie
    order's cost.  Returns the kernels' launches on the ranks and the two
    kernels' rows for ``other_shapes``."""

    t_phase = time.perf_counter()
    m = fitted.to_recommend_index().num_users
    rng = np.random.default_rng(11)                 # [serve]'s requests
    before, after = serve_requests(rng, 200, m), serve_requests(rng, 50, m)
    cfg4 = dataclasses.replace(ml_cfg, p=4, q=4)
    jobs = {label: ServeJob(ML_4X4, cfg4, FULL_ROUNDS, SHARD_REFIT,
                            tuple(before), tuple(after), quant=quant,
                            quant_method=method)
            for label, quant, method in (("int8", "int8", "fused"),
                                         ("f32", None, None))}
    marks: list = []
    t0 = time.perf_counter()
    try:
        outs = run_on_grid(sharded_rank, GRID, ml_cfg, jobs, timeout=900,
                           marks=marks)
    finally:
        shutdown_grids()        # the forkserver would outlive this phase
    print(f"[sharded] 2x2 grid of 4 gloo processes: parts a-d in "
          f"{time.perf_counter() - t0:.1f}s; slowest rank's seconds from "
          f"spawn: {json.dumps({k: max(x[k] for x in marks) for k in marks[0]})}",
          flush=True)

    # a: ML-1M 4x4
    a = [o["a"] for o in outs]
    print(f"[sharded] a. ML-1M 4x4 owner-routed ingest, per rank: "
          f"{json.dumps([{k: x[k] for k in ('ingest_routed_s', 'ingest_global_s', 'E', 'nnz', 'append_s')} for x in a])}",
          flush=True)
    print(f"[sharded] a. tiles bitwise the global store's "
          f"{[x['tiles_bitwise'] for x in a]}; {GRID_ROUNDS} Gossip rounds "
          f"on the routed store bitwise the sliced store's "
          f"{[x['fit_bitwise'] for x in a]} (cost {a[0]['fit_cost']:.6e}); "
          f"f_grads_sharded against the tile of the 1x1 gradients, max rel "
          f"{[x['grads_rel'] for x in a]}; routed append of "
          f"{SHARD_APPEND} ratings bitwise the tile of append_entries "
          f"{[x['append_bitwise'] for x in a]}", flush=True)
    for x in a:
        if not (x["tiles_bitwise"] and x["fit_bitwise"]
                and x["append_bitwise"] and x["grads_rel"] <= TOL):
            fail(f"[sharded] a. rank check failed: {x}")
    # b: Netflix shape
    b = [o["b"] for o in outs]
    print(f"[sharded] b. Netflix shape {NETFLIX['m']}x{NETFLIX['n']}, "
          f"{NETFLIX['ratings']} ratings on {NETFLIX['p']}x{NETFLIX['q']} "
          f"blocks, per rank: {json.dumps(b)}", flush=True)
    if not all(x["tiles_bitwise"] for x in b):
        fail("[sharded] b. a routed Netflix tile differs from the global "
             "store's")
    # c: serving from the grid fit
    for label in ("int8", "f32"):
        c = outs[0]["c"][label]
        print(f"[sharded] c. {label} engine from the 2x2 ML-1M 4x4 Gossip "
              f"fit ({FULL_ROUNDS} rounds, refreshed to {FULL_ROUNDS} + "
              f"{SHARD_REFIT} fitted on the grid while it served, "
              f"{c['refit_s']:.3f}s): {len(before)} + {len(after)} requests "
              f"({c['users']} users) in {c['serve_s']:.3f}s; items equal "
              f"the unsharded engine's: {c['items_equal']}, scores bitwise "
              f"{c['scores_bitwise']}, max abs {c['scores_max_abs']:.3e} "
              f"rel {c['scores_max_rel']:.3e}; startup {c['startup_s']:.3f}s"
              f" compiles {c['compiles']}; shard widths "
              f"{[o['c'][label]['shard_items'] for o in outs]}; "
              f"dequant_score launches by rank "
              f"{[o['c'][label]['launches'] for o in outs]}", flush=True)
        for bk in DEFAULT_BUCKETS:
            h, one = c["buckets"][bk], c["one_buckets"][bk]
            print(f"[sharded] c. {label} bucket {bk}: sharded p50="
                  f"{1e3 * h['p50']:.3f}ms p99={1e3 * h['p99']:.3f}ms "
                  f"(count {h['count']}); unsharded engine in the same "
                  f"process p50={1e3 * one['p50']:.3f}ms "
                  f"p99={1e3 * one['p99']:.3f}ms ([serve]'s above)",
                  flush=True)
        ok = c["items_equal"] and (c["scores_bitwise"] if label == "int8"
                                   else c["scores_max_rel"] <= TOL)
        if not ok:
            fail(f"[sharded] c. the {label} grid engine disagrees with the "
                 f"unsharded engine: {c}")
    print(f"[sharded] c. the grid engine's collectives alone, ms a call "
          f"by rank (gloo, host tensors, top bucket): "
          f"{json.dumps([o['floor'] for o in outs])}", flush=True)
    # d: the PRODUCTION catalog
    d = [o["d"] for o in outs]
    print(f"[sharded] d. PRODUCTION catalog {PRODUCTION.m}x{PRODUCTION.n}, "
          f"r={PRODUCTION.rank}, int8, k={PROD_K}: {d[0]['shard_items']} "
          f"items a shard; per rank f32 factors before quantizing "
          f"{d[0]['factor_f32_bytes'] / 2**30:.3f} GiB, int8 held "
          f"{[x['held_int8_bytes'] / 2**30 for x in d]} GiB, seen table "
          f"{d[0]['seen_bytes'] / 2**30:.3f} GiB, peak device memory "
          f"{[round(x['peak_bytes'] / 2**30, 3) for x in d]} GiB (scores "
          f"at bucket {TOP_BUCKET}: "
          f"{TOP_BUCKET * d[0]['shard_items'] * 4 / 2**30:.3f} GiB a rank, "
          f"{TOP_BUCKET * PRODUCTION.n * 4 / 2**30:.3f} unsharded); startup "
          f"{d[0]['startup_s']:.3f}s; {PROD_COMPARE} users bitwise the "
          f"unsharded int8 path: {d[0]['bitwise']}", flush=True)
    for bk in DEFAULT_BUCKETS:
        h = d[0]["buckets"][bk]
        print(f"[sharded] d. bucket {bk}: p50={1e3 * h['p50']:.3f}ms "
              f"p99={1e3 * h['p99']:.3f}ms (count {h['count']})", flush=True)
    if not d[0]["bitwise"]:
        fail("[sharded] d. the sharded PRODUCTION answers differ from the "
             "unsharded int8 path")

    total = dict.fromkeys(WRAPPERS, 0)
    for o in outs:
        total["sddmm_segment_grad"] += (o["a"]["fit_launches"]
                                        + o["a"]["grads_launches"]
                                        + o["c_fit_launches"])
        total["dequant_score"] += (o["c"]["int8"]["launches"]
                                   + o["d"]["launches"])
    for name in ("sddmm_segment_grad", "dequant_score"):
        if total[name] == 0:
            fail(f"[sharded] {name} was never launched on the ranks")

    # the kernels at the new shapes, in this process, against plain
    rows, cols, vals = netflix_coo()
    plan = MeshPlan.build(NETFLIX["p"], NETFLIX["q"], grid=GRID)
    sh, _ = ShardedEntries.from_coo(rows, cols, vals, NETFLIX["m"],
                                    NETFLIX["n"], plan, rank=0)
    g = torch.Generator(device="cuda").manual_seed(5)
    lead = (plan.blocks_per_row_shard, plan.blocks_per_col_shard)
    U = 0.3 * torch.randn((*lead, sh.sp.mb, RANK), generator=g,
                          device="cuda")
    W = 0.3 * torch.randn((*lead, sh.sp.nb, RANK), generator=g,
                          device="cuda")
    seg_row = segment_check("sharded Netflix-shape rank tile", sh.sp.entries,
                            U, W, card)
    del sh, U, W
    gq = np.random.default_rng(43)
    n_shard = PRODUCTION.n // (GRID[0] * GRID[1])
    args = [torch.from_numpy(x).to("cuda") for x in (
        gq.integers(-127, 128, (PROD_SCORE_B, PRODUCTION.rank)).astype(
            np.int8),
        gq.lognormal(-3.0, 1.0, PROD_SCORE_B).astype(np.float32),
        gq.integers(-127, 128, (n_shard, PRODUCTION.rank)).astype(np.int8),
        gq.lognormal(-3.0, 1.0, n_shard).astype(np.float32))]
    q_row = {"phase": "sharded PRODUCTION item shard",
             **score_timing(args, card)}
    print(f"[sharded] dequant_score against its plain version, "
          f"PRODUCTION item shard: {json.dumps(q_row)}", flush=True)
    ties = topk_tie_timing(fitted.to_recommend_index())
    print(f"[sharded] top-k in the reference's tie order at "
          f"{ties['shape']} (masked scores of the fit): "
          f"{ties['ordered_ms']:.4f} ms ({ties['rows_redone']} rows selected "
          f"again), the int64-key selection of every row "
          f"{ties['keyed_ms']:.4f} ms, a bare torch.topk "
          f"{ties['torch_topk_ms']:.4f} ms (eager, CUDA events); the same "
          f"positions as the int64-key selection: {ties['same_as_keyed']}",
          flush=True)
    if not ties["same_as_keyed"]:
        fail("[sharded] topk_ordered differs from the int64-key selection")
    print(f"[sharded] phase: {time.perf_counter() - t_phase:.1f}s of "
          f"command; launches on the ranks {total}", flush=True)
    return total, [seg_row], [q_row]


def prefixed(tag: str):
    """A ``log`` that prints each line of its text after ``tag``."""

    def log(text) -> None:
        for line in str(text).strip("\n").splitlines():
            print(f"{tag} {line}", flush=True)
    return log


def measure_phase(fitted, device="cuda") -> tuple[dict, list]:
    """``[measure]``: the instruments of the module docstring.  Returns
    the kernels' launches (the gossip_comm grid's ranks included) and the
    ``[tp]`` cell's roofline analyses, which are printed after ``[tp]``."""

    t_phase = time.perf_counter()
    total = dict.fromkeys(WRAPPERS, 0)
    reset_counts()
    index = fitted.to_recommend_index()
    gaps, reqs = serving_traffic.make_schedule(
        MEASURE_REQUESTS, MEASURE_RATE, index.num_users, 0, DEFAULT_BUCKETS)
    t0 = time.perf_counter()
    try:
        payload, extra = serving_traffic.replay(
            index, gaps, reqs, buckets=DEFAULT_BUCKETS, k=MEASURE_K,
            quant=True, log=prefixed("[measure] traffic"))
    except AssertionError as err:
        fail(f"[measure] serving_traffic: {err}")
    sweep, spread = payload["method_sweep_ms"], extra["method_sweep_spread_ms"]
    fused, deq = spread["fused"], spread["dequant"]
    overlapping = fused["p10"] <= deq["p90"] and deq["p10"] <= fused["p90"]
    committed = quant_autotune._committed_sweep().get("cuda")
    print(f"[measure] serving_traffic on [main]'s index ({index.num_users} x "
          f"{index.num_items}, r = {index.u.shape[1]}; {MEASURE_REQUESTS} "
          f"requests at {MEASURE_RATE:.0f}/s, k = {MEASURE_K}) in "
          f"{time.perf_counter() - t0:.1f}s: " + json.dumps({
              key: payload[key] for key in ("engine", "quant", "overlap_at_k",
                                            "index_bytes",
                                            "method_sweep_ms")})
          + f"; method sweep spread {json.dumps(spread)}; the medians lie "
          f"within each other's p10-p90: {overlapping}; method=None "
          f"resolves to {quant_autotune.resolve_method(None, device)!r} "
          f"(committed sweep's winner {committed!r})", flush=True)

    t0 = time.perf_counter()
    rows = sparse_vs_dense.sweep(*MEASURE_SHAPE, (P, Q), RANK,
                                 MEASURE_DENSITIES, iters=MEASURE_ITERS,
                                 device=device)
    for row in rows:
        print(f"[measure] sparse_vs_dense {json.dumps(row)}", flush=True)
        for key in ("grad_reldiff_sorted_vs_dense",
                    "grad_reldiff_scatter_vs_dense",
                    "cost_reldiff_sorted_vs_dense",
                    "cost_reldiff_scatter_vs_dense"):
            if not row[key] <= MEASURE_RTOL:
                fail(f"[measure] sparse_vs_dense at density "
                     f"{row['density']}: {key} {row[key]:.3e} > "
                     f"{MEASURE_RTOL:.0e}")
    sparse_vs_dense.report(rows, (), device, log=prefixed("[measure]"))
    for key in ("ms", "device_ms")[:2 if device == "cuda" else 1]:
        wins = [r["density"] for r in rows
                if r[f"grad_sorted_{key}"] < r[f"grad_dense_{key}"]]
        print(f"[measure] density sweep: by {key} the sorted sparse ∇L is "
              f"faster than the dense one at densities {wins} of "
              f"{list(MEASURE_DENSITIES)}", flush=True)
    print(f"[measure] density sweep {time.perf_counter() - t0:.1f}s",
          flush=True)
    total = {k: total[k] + n for k, n in counts().items()}

    t0 = time.perf_counter()
    try:
        measured = gossip_comm.measured_row(MEASURE_ROUNDS, device=device)
    finally:
        shutdown_grids()
    for name, n in measured["launches"].items():
        total[name] += n
    print(f"[measure] gossip_comm --measure ({time.perf_counter() - t0:.1f}"
          f"s): {json.dumps(measured)}", flush=True)
    MEASURED["gossip_comm_2x2_ms"] = measured["ms_per_round"]

    t0 = time.perf_counter()
    fit_records = roofline_bench.gossip_records()
    lm_analyses = [analyze_record(r) for r in roofline_bench.lm_records()]
    print(f"[measure] roofline records counted in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    beside = {"1x1": ("[main] FullGD sparse/segment ms/round",
                      MEASURED.get("main_ms")),
              "2x2": ("[gossip] 2x2 ML-1M 4x4 ms/round",
                      MEASURED.get("gossip_2x2_ms"))}
    for rec in fit_records:
        label, ms = beside[rec["mesh"]]
        print(f"[measure] {roofline_bench.roofline_line(analyze_record(rec))}"
              f" | {label}: {ms if ms is not None else 'not run'}",
              flush=True)
    print(f"[measure] phase: {time.perf_counter() - t_phase:.1f}s of "
          f"command; launches {total}", flush=True)
    return total, lm_analyses


def roofline_after_tp(lm_analyses, tp_out) -> None:
    """The ``[tp]`` cell's roofline lines beside its measured times (the
    one-process reference at ``model`` = 1, rank 0 at 4)."""

    for a in lm_analyses:
        if tp_out is None:
            seen = "not run"
        else:
            run = tp_out["reference"] if a["chips"] == 1 else tp_out
            seen = (f"{run['prefill_s']:.4f} s" if a["shape_cfg"]["kind"]
                    == "prefill" else f"{run['decode_ms_per_step']:.4f} ms")
        print(f"[measure] {roofline_bench.roofline_line(a)} | [tp] "
              f"measured: {seen}", flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def selected_phases(names: str | None) -> set:
    """The phases ``--phases`` names, with what they need (``NEEDS``);
    every phase when it is not given."""

    if names is None:
        return set(PHASES)
    picked = {x.strip() for x in names.split(",") if x.strip()}
    unknown = sorted(picked - set(PHASES))
    if unknown or not picked:
        fail(f"--phases: unknown {unknown or names!r}; the phases are "
             f"{','.join(PHASES)}")
    for name in list(picked):
        picked.update(NEEDS.get(name, ()))
    return picked


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paper", action="store_true",
                    help="[table2] at every checkpoint of exp1-exp6")
    ap.add_argument("--phases", default=None,
                    help="run only these phases, comma-separated (with "
                         "what they need): " + ",".join(PHASES))
    args = ap.parse_args()
    paper = args.paper
    started = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an "
             "NVIDIA GPU")
    phases = selected_phases(args.phases)
    want = phases.__contains__
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    print(f"[phases] {','.join(p for p in PHASES if want(p))}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[build] {json.dumps(built)} total {time.perf_counter() - t0:.2f}s",
          flush=True)

    # data and problems through the user entry points
    t0 = time.perf_counter()
    ds = movielens_proxy()
    sparse = CompletionProblem.from_dataset(ds, P, Q, RANK, layout="sparse",
                                            mean_center=True)
    dense = CompletionProblem.from_dataset(ds, P, Q, RANK, layout="dense",
                                           mean_center=True)
    scatter = sparse.with_engine(method="scatter")
    spec = sparse.spec
    cfg = GossipMCConfig(m=spec.m, n=spec.n, p=P, q=Q, rank=RANK, **CFG)
    state0 = init_state(torch.Generator(device="cuda").manual_seed(0), spec)
    print(f"[data] {spec} train nnz={int(sparse.data.nnz.sum())} "
          f"E={sparse.data.capacity} test={len(ds.test_vals)} "
          f"setup {time.perf_counter() - t0:.2f}s", flush=True)

    # 2. kernels against their plain versions
    rows = kernel_phase(sparse, dense, state0, card) if want("kernels") else []

    total = dict.fromkeys(WRAPPERS, 0)

    def add(got):
        for name, n in got.items():
            total[name] += n

    # 3. main path; a two-round warm-up per problem first, so that the
    # timed phases do not pay PyTorch's one-time CUDA module loading
    results = {}
    if want("main"):
        trainer = Trainer(cfg)
        for problem in (sparse, scatter, dense):
            trainer.fit(problem, FullGD(num_rounds=2), state=state0)
            trainer.fit(problem, Wave(num_rounds=1), seed=0)
        at_compare = StateAt(COMPARE_ROUNDS)
        trace_dir = tempfile.mkdtemp(prefix="chip-smoke-trace-")

        def traced_fit():
            # the Table 3 fit under Telemetry, inside a profiler trace
            obs.reset()
            with obs.trace(trace_dir):
                return Trainer(cfg, callbacks=[at_compare, Telemetry()]).fit(
                    sparse, FullGD(num_rounds=FULL_ROUNDS,
                                   eval_every=COMPARE_ROUNDS), state=state0)

        runs = [
            ("FullGD sparse/segment", ["sddmm_segment_grad"], traced_fit),
            ("FullGD sparse/scatter", ["sddmm_factor_grad"],
             lambda: trainer.fit(scatter, FullGD(num_rounds=10, eval_every=5),
                                 state=state0)),
            ("FullGD dense", ["masked_factor_grad"], lambda: trainer.fit(
                dense, FullGD(num_rounds=COMPARE_ROUNDS, eval_every=10),
                state=state0)),
            ("Wave sparse", ["sddmm_segment_grad"], lambda: trainer.fit(
                sparse, Wave(num_rounds=1), seed=1)),
            ("Wave dense", ["masked_factor_grad"], lambda: trainer.fit(
                dense, Wave(num_rounds=1), seed=1)),
            ("Sequential sparse", ["sddmm_segment_grad"], lambda: trainer.fit(
                sparse, Sequential(num_iters=300, eval_every=100), seed=2)),
            ("Sequential dense", ["masked_factor_grad"], lambda: trainer.fit(
                dense, Sequential(num_iters=100, eval_every=50), seed=2)),
        ]
        for label, expect, fit in runs:
            results[label], got = run_phase(label, expect, fit)
            add(got)
        for label in ("FullGD sparse/segment", "FullGD sparse/scatter",
                      "FullGD dense"):
            res = results[label]
            costs = [c for _, c in res.history]
            if not costs[-1] < costs[0]:
                fail(f"{label}: cost did not fall: {costs}")
            rounds = res.t // (2 * (P - 1) * (Q - 1))
            ms = 1e3 * res.wall_time / rounds
            if label == "FullGD sparse/segment":
                MEASURED["main_ms"] = ms
            print(f"[main] {label}: {ms:.3f} ms/round over {rounds} rounds "
                  f"(cost evals included), held-out RMSE {res.rmse():.4f}",
                  flush=True)

        trace_check(trace_dir)
        res = results["FullGD sparse/segment"]
        print(f"[main] Table 3 cell (ML-1M proxy, grid {P}x{Q}, r={RANK}) "
              f"after {FULL_ROUNDS} FullGD rounds: held-out RMSE "
              f"{res.rmse():.6f}, cost {res.final_cost:.6e}", flush=True)
        a = at_compare.state
        b = results["FullGD dense"].state
        for x, y, nm in ((a.U, b.U, "U"), (a.W, b.W, "W")):
            scale = float(y.abs().max())
            if not torch.allclose(x, y, rtol=STATE_RTOL, atol=1e-5 * scale):
                fail(f"sparse and dense FullGD {nm} disagree: max diff "
                     f"{float((x - y).abs().max()):.3e} (max |{nm}| "
                     f"{scale:.3e})")
        print(f"[main] sparse and dense FullGD states agree after "
              f"{COMPARE_ROUNDS} rounds (rtol {STATE_RTOL:.0e})", flush=True)

        reset_counts()
        index = results["FullGD sparse/segment"].to_recommend_index()
        users = torch.arange(0, 256 * 23, 23, device="cuda")
        recommend_topk(index, users, k=10)            # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        items, scores = recommend_topk(index, users, k=10)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        if items.shape != (256, 10) or not torch.isfinite(scores).all():
            fail(f"recommend_topk gave {tuple(items.shape)} / non-finite "
                 f"scores")
        n_checked = check_topk(index, users.cpu().numpy(), items, scores, 10)
        print(f"[main] recommend_topk: 256 users, k=10, {ms:.3f} ms, "
              f"{n_checked} tie-free users equal to the host reference",
              flush=True)

    # the paper's Table 2 cells, then the Gossip schedule
    t2_checks, g_checks, s_checks, faults_by_stack = [], [], [], {}
    if want("table2"):
        got, t2_checks = table2_phase(paper, card)
        total["masked_factor_grad"] += got
    if want("gossip"):
        got, g_checks = gossip_phase(sparse, scatter, state0, cfg, card)
        add(got)
    # the streaming loop: append, refit, policy-driven refresh, minibatches
    if want("stream"):
        got, s_checks = stream_phase(ds, sparse, state0, cfg, card)
        add(got)
    # fault injection, async rounds, self-healing and resume on a 2x2 grid
    if want("faults"):
        got, faults_by_stack = faults_phase(sparse, cfg, card)
        add(got)
    other_shapes = {"masked_factor_grad": t2_checks + g_checks[:1],
                    "sddmm_segment_grad": g_checks[1:] + s_checks}

    if want("serve"):
        # 4. the int8 score kernel at the top bucket of the fitted index
        qidx = quantize_index(index)
        top_users = torch.as_tensor(np.random.default_rng(5).choice(
            qidx.num_users, TOP_BUCKET, replace=False), device="cuda")
        rows.append(quant_kernel_row(qidx, top_users, card))

        # 5. the serving path: int8 engine, refresh, f32 engine
        total["dequant_score"] += serve_phase(results["FullGD sparse/segment"],
                                              results["FullGD dense"])
    # owner-routed ingest and item-sharded serving on a 2x2 grid
    if want("sharded"):
        got, seg_shapes, q_shapes = sharded_phase(
            cfg, results["FullGD sparse/segment"], card)
        add(got)
        other_shapes["sddmm_segment_grad"] += seg_shapes
        other_shapes["dequant_score"] = q_shapes
    # the paper workload's instruments: traffic, method and density sweeps,
    # gossip_comm, the roofline records
    lm_analyses = None
    if want("measure"):
        got, lm_analyses = measure_phase(results["FullGD sparse/segment"])
        add(got)

    for row in rows:
        row["launches"] = total[row["name"]]
        if other_shapes.get(row["name"]):
            row["other_shapes"] = other_shapes[row["name"]]
        if row["name"] in faults_by_stack:
            row["faults_launches_by_stack"] = faults_by_stack[row["name"]]

    # 6. gemma2-2b serving through the flash kernel, then its training; an
    # LM phase run without [lm] adds its launches to the kernel-only row
    if want("lm"):
        rows.append(lm_phase(card))
        _free()
    elif any(want(name) for name in LM_PHASES):
        rows.append(flash_row(card))
        _free()
    if want("train"):
        train_phase(card)
        _free()
    # 7. the MoE family: granite-moe, then deepseek (MLA), full width
    if want("moe"):
        moe_phase(card, rows[-1])
        _free()
    # 8. the SSM family and the hybrid: mamba2, then zamba2, full width
    if want("ssm"):
        ssm_phase(card, rows[-1])
        _free()
    # 9. the encoder-decoder (whisper), then the VLM (internvl2, 8 layers)
    if want("encdec"):
        encdec_phase(card, rows[-1])
        _free()
    if want("vlm"):
        vlm_phase(card, rows[-1])
        _free()
    # 10. the VLM cell on tensor-parallel ranks
    tp_out = tp_phase(card, rows[-1]) if want("tp") else None
    if lm_analyses is not None:
        roofline_after_tp(lm_analyses, tp_out)
    print(f"[main] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{time.perf_counter() - started:.1f}s since start", flush=True)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
