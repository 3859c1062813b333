"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. device — the card's name, power limit and compute capability;
2. build — every CUDA kernel from the checkout's sources, one nvcc each,
   in parallel (xotorch_support_jetson_tpu_torch/ops/kernels.py);
3. kernels — K1 (flash prefill), K2 (flash decode), K3 (paged decode,
   bf16 / int8 / int4 pages) and K4 (packed-int4 weight matmul) against
   their plain PyTorch versions at llama-3.2-1b's shapes (attention: Hq 32,
   Hkv 8, hd 64, bf16, cache 4096 — and 16384 for one K2 row — page size
   64 and 64 pages per row for K3; K1 also at prompts up to 4096 tokens,
   int8 K/V, four batched rows behind a shared prefix and hd 128; K4: the
   five projection shapes at T = 1, 8, 128, 512, and one row with f32 x;
   K1 also at the mixed-tick slice shapes, B=1, Sq 16 / 256 / 1024 at
   offsets 2048 / 3072 / 1024; K3 also on the verify window of batched
   speculation, B=8 rows × W=9 positions flattened into one launch, rows
   starting at 150..600 and at 1..4087, and W=5 (a model-drafted window)
   at 150..600, with W=1 over the same rows beside each; and at
   Qwen3-30B-A3B's shapes: K1 at its 128 bucket and K3 at B=8
   mixed lengths with Hq 32 / Hkv 4 at hd 128, K4 at its q, k/v, o and
   head products at T = 1; K4 at DeepSeek-Coder-V2-Lite's eight products at
   T = 1; and the dense batched layout's shapes: K1 at B=8 verify windows,
   Sq 5 and 9, rows at offsets 150..600 over the 4096-slot cache, bf16 and
   int8 K/V, and K2 at B=8 rows of mixed positions 1..4095):
   error, kernel / plain / library time and the card's bound (K1's library
   call is SDPA on the live slots with causal masking, or over the cache
   with a per-row causal mask where rows sit at different offsets, the
   fastest backend that runs); K4's per-decode-step sums, and the count of device kernels
   in one call of every K1, K2 and K3 row and of K4 at T = 1 and 8 (the
   kernel nodes of a CUDA graph captured around a call), which must be 1;
4. solo serving — a seeded random-weight bf16 checkpoint with
   llama-3.2-1b's published shapes is written with the port's safetensors
   writer, and the port's daemon path (main → node → API) serves blocking
   and streaming chat completions on it, greedy and sampled, then again
   with XOT_TPU_FLASH_DECODE=1 XOT_TPU_FLASH_DECODE_MIN=4096. The launch
   counters are zeroed just before these requests and read just after: K1
   and K2 must have run. Blocking and streaming greedy token ids must be
   equal, and the served model's prefill and decode logits must agree with
   the plain attention path on the same weights. ``torch.profiler`` splits
   one prefill and eight decode steps into host and device time. Then one
   ~3,000-token prompt (prefill bucket 3072), blocking and streaming, with
   the counters zeroed just before and read just after: greedy ids equal,
   K1 once per layer per prefill, and the served prefill's host and device
   time with K1's share of the device time;
5. quantized solo serving — the same checkpoint through the daemon once
   per weight mode: XOT_TPU_QUANT=int4, int8, and int8 with
   XOT_TPU_QUANT_COMPUTE=w8a8 (the engine quantizes on the card at load).
   Greedy blocking and streaming ids must be equal; in the int4 pass K1
   and K4 must have run and the non-kernel product (int4_two_dot) must not
   have been called, and its prefill and decode logits through K4 must
   agree with XOT_TPU_INT4_KERNEL=0 on the same weights. Each mode's
   logits against the bf16 model are reported; the profiler splits one
   decode step under int4 (K4, and XOT_TPU_INT4_KERNEL=0) and int8 w8a16,
   and the int4 prefill (K4, and XOT_TPU_INT4_KERNEL=0);
5b. solo speculation — the same checkpoint through the solo daemon with
   XOT_TPU_SPEC_DECODE=ngram (draft-free n-gram chunks at depth ≤ 8,
   verify windows of 9), =int8 with XOT_TPU_SPEC_AUTOCAL=0 (the int8
   self-draft at depth 4, windows of 5), =int8 with the load-time A/B on
   (its verdict and both captured tok/s are printed; either verdict
   passes), and =int8 with XOT_TPU_SPEC_DRAFT naming a seeded 2-layer
   checkpoint at llama-3.2-1b's widths that the script writes (a
   cross-model draft), each serving one greedy streaming and one blocking
   request after the same two once as a warm-up (the draft's depth policy
   reset after it), every dispatch captured (models/decoder.py
   ``SoloPrograms``: a round, an n-gram chunk or a draft prefill is one
   replay). Each pass starts from an empty program ledger. The
   counters are zeroed just before the counted requests and read just
   after. Gates: the pass's spec chunks were dispatched; every K1 launch
   inside a graph run and every host launch in the first run of a graph
   the pass captured (each dispatch a replay or a new graph's first run),
   captures ≤ builds per family (``[graphs] spec pass=`` lines); n-gram: K1
   once per layer per verify round (16 a round), blocking ids equal to the
   plain pass's, the streaming ids the plain single-token greedy choice
   given their own prefix at ≥ 0.9 of the positions (bf16 window and
   single-token sums may round apart at a near-tie, after which the stream
   follows its own greedy path: its position-by-position agreement with
   the plain ids is reported, not gated); a draft: K1 once per target
   layer (verify) and once per draft layer (catch-up) in every round and
   once per draft layer in each draft prefill, the blocking
   (``fused_speculative_generate``) and streaming ids equal, and for the
   cross pass the 2-layer draft loaded. Acceptance, the n-gram depth after
   each read and the decode rates beside phase 4's are reported. Then the
   acceptance ceiling: an echo checkpoint (the port's
   ``peaked_echo_params`` of the same seeded weights) and a 2-layer draft
   written from it, served plain and then with ``ngram``, ``int8`` with
   the A/B on, and the cross draft, gated alike, each pass's acceptance,
   tok/s against the echo checkpoint's plain pass and A/B verdict on a
   ``[spec] ceiling`` line. Phase 3 also holds
   K1 at the verify windows (B=1, Sq 5 and 9, offsets 72 / 1024 / 4086,
   bf16 and int8 K/V);
5c. graphs — the solo path's captured programs (models/decoder.py
   ``SoloPrograms``: one CUDA-graph replay per prefill bucket and per decode
   step) on the same checkpoint, with bf16 weights and KV, int8 KV
   (XOT_TPU_KV_QUANT=int8) and int4 weights (XOT_TPU_QUANT=int4): the
   engine's own entry points (captured prefill, ``generate_oneshot``'s 32
   steps, two 16-step ``dispatch_chunk``s) against the uncaptured functions
   called directly on a fresh cache, greedy and sampled at temp 0.6 /
   top_k 35 from equally seeded generators, in a round that builds every
   graph and a round that only replays: transcripts token-identical, the
   prefill's logits within the serving phase's 5e-2 relative L2 (the
   ``[graphs] <mode>`` lines: kernel nodes per graph, launches inside
   replays — K1 in every prefill replay, K4 in the int4 step). K1, K2, K3
   (one query per row, and the B=8 × W=9 verify window) and K4 at the main
   path's shapes inside a captured graph whose inputs are refilled before
   its replay, against their plain versions with the kernel rows'
   tolerances, one launch counted per replay. ``[profile] graphs``
   lines: wall and device ms per 128-token prefill and per decode step,
   captured and eager (device: CUDA events around a call queued behind a
   spin kernel), with the card's name and power limit, and the captured
   bf16 step at positions 128 and 4000 of the 4096-slot cache with K2
   (``XOT_TPU_FLASH_DECODE=1``) and without (recorded, not gated). The
   ``[graphs] spec`` cell: with the int8 self-draft and with the 2-layer
   cross draft, on a pooled 4096-slot pair, two rounds of captured
   against uncaptured dispatches on refilled buffers (the draft's 128-bucket
   prefill, chained 8-token draft-chain chunks at depth 4, chained n-gram
   chunks of 3 rounds at depth 8, 64-token speculative oneshots):
   token-identical, K1 once per layer per window in each captured round;
   ``[profile] graphs spec`` lines: captured wall and device ms (events
   behind a spin kernel) of an n-gram chunk, one int8 and one cross round,
   the oneshot and the draft prefill, kernel nodes, capture seconds and the
   graph pool's bytes, beside the eager function's wall and device ms (not
   the oneshot's: its profile cost ~40 s a run); and
   K1 at Sq 5 and 9 inside a replay on a refilled query and offset within
   its bounds, one kernel node. Then the
   solo daemon: four requests, ``POST /v1/warmup``, the same four again,
   ``GET /v1/programs`` (and ``?scope=cluster``): no steady build, no new
   capture during the repeat, the three solo families replaying, greedy ids
   equal across the passes; the counters are zeroed just before its first
   request and read just after the repeat. Launches made inside graph
   replays count in every phase's counts (a graph's kernels, recorded at
   its capture, once per replay);
5d. the API surface — on that daemon after its gated windows (so its
   scoring programs build after the warmup, as the reference's do; the
   counters are zeroed just before and read just after): ``/v1/completions``
   blocking and streaming greedy on the 72-token prompt with 64-token
   answers (ids equal), ``echo``, a ``stop`` cut and the 400s; OpenAI
   logprobs (chat ``top_logprobs`` 5 and completions ``logprobs`` 3) on
   that prompt (the 256 bucket) and on the 3,000-token one (3072, n bucket
   64): entries one for one with the returned tokens, each chosen log-prob
   <= 0, each top list sorted, top-1 the greedy token wherever the
   runner-up trails by more than ``SCORE_GAP_TOL``, K1 once per layer in
   each scoring forward, one ``prefill.score_last`` dispatch per scored
   request in ``GET /v1/programs``, each scoring call's wall and device ms
   and peak memory, and each call again through the plain attention
   (``XOT_TPU_NO_FLASH``: no K1, chosen log-probs within 5e-2 relative L2,
   its wall ms); token encode, ``/initial_models``, ``/modelpool``,
   ``/v1/models``, ``POST /download`` of a throw-away model directory under
   a temporary ``XOT_TPU_HOME`` and ``/v1/download/progress`` (complete),
   ``DELETE /models/{name}`` of it (then 404; the served checkpoint
   untouched) and ``GET /`` with the web page's controls. Phase 3 also
   holds K1 at the scoring forward's shapes (Sq = Skv = 256 and 3072,
   offset 0) beside SDPA ``is_causal``;
6. batched serving — the same checkpoint through the daemon with
   XOT_TPU_BATCHED=1 (8 slots, 64-token pages, cache 4096) at the batched
   server's defaults, draft-free n-gram speculation, QoS admission and
   mixed prefill+decode ticks on, first with XOT_TPU_QUANT=int4 weights
   and bf16 pages, then on bf16 weights: 16
   streaming greedy requests sharing a 128-token system prefix (prompts
   166–550 tokens, answers 29–64 tokens) in two waves, the second eight
   sent once the first eight stream, once per KV pool type (bf16, int8,
   int4), and bf16 once more with XOT_TPU_SPEC_BATCH=0; then bf16 again
   with XOT_TPU_MIXED_TICK=0, and with QoS and the SLO engine off as well
   (the FIFO scheduler); then a priority pass
   (12 ``batch`` requests of ``PRIORITY_BATCH_TOKENS`` = 720-token
   answers, ten spec chunks' worth at full acceptance, then 4
   ``interactive`` ones once 8 batch rows stream, so they arrive while
   every row is held), last because the process's SLO engine keeps the
   burn its interactive requests leave.
   The counters are zeroed just before each pass and read just after: K1
   (bf16 and int8 pages) and K3 must have run, K4 in the int4-weights pass
   (every prefill chunk too, whatever its rows: no int4_two_dot call), and
   prefix pages must have been shared. Each pass logs its mixed
   dispatches (with the K1 / K3 launches inside them) and its
   preemptions: the default bf16 pass fails without a mixed dispatch, a
   XOT_TPU_MIXED_TICK=0 pass with one, any pass with a mixed dispatch
   that did not launch K1 once per layer (none on int4 pages) and K3, the
   priority pass without a preemption, and every request must end with
   all its tokens. The node is started as the daemon's main starts it, so
   the SLO engine ticks and its slo_burn_rate gauge sets the mixed budget:
   a pass with the SLO engine on fails if the gauge was not there when it
   began. Each pass reports, from deltas of the metrics registry, the mean
   decode-chunk, mixed-tick and host-gap times; the default bf16 pass also
   reads GET /metrics and GET /v1/slo mid-pass. After the repeated
   warmup, one chat request with logprobs on the batched daemon: decoded
   by the batched server, scored on the engine's executor thread (the
   batched replays' thread), K1 once per layer in the scoring forward, one
   ``prefill.score_last`` dispatch. One batched decode step's
   logits through K3 must agree with the gather path on the same pool; one mixed call at full
   width (``fused_mixed_paged_batch_decode``: 8 decode rows, a 200-token
   slice at offset 1024) must agree with the alternating equivalent
   within 5e-2 relative L2 and launch K1 and K3 once per layer;
   ``torch.profiler`` splits a decode chunk, a mixed chunk and a spec
   chunk into host and device time. The batched server runs its host KV
   tier by default:
   every pass logs its spilled and restored pages (the 513-page pools of
   these passes never evict), fails on a spill or restore failure, and
   the priority pass fails unless every preempted row's resume admits with
   all the full pages of its absorbed stream (prompt and generated tokens)
   as a prefix. Each pass logs its spec dispatches (``[batched] pass=...
   spec:`` lines: depth caps, the K3 / K4 launches inside them, accepted
   and proposed tokens by proposer from the registry): the default bf16
   pass fails without a spec dispatch, the XOT_TPU_SPEC_BATCH=0 pass with
   one, and any pass whose spec dispatch did not launch K3 once per layer
   per round (K4 on int4 weights); the two bf16 passes' aggregate tok/s,
   TTFT, decode rates and the share of greedy tokens they agree on are
   reported, not gated. The verify window at full width (B=8 at lengths
   150..600, W=9), per pool type: through K3 against the gather route and
   against 9 single-token steps within 5e-2 relative L2, K3 once per
   layer; and one spec chunk fed the plain 72-step greedy streams as its
   proposals (8 rounds, depth 8) must accept at least 0.9 of them.
   Every batched dispatch of these passes is one CUDA-graph replay (the
   pool's ``BatchedPrograms``): each pass's server starts with a fresh
   pool, fresh graphs and a reset program ledger; the default bf16 pass
   (on either weights), the XOT_TPU_SPEC_BATCH=0 pass and the
   XOT_TPU_MIXED_TICK=0 pass, whose rates are compared, first serve a
   build round (its two waves on other text of the same lengths, so the
   dispatch shapes are captured there; aggregate, TTFT and captures are
   reported, and when the eighth row's first token came against the first
   wave's earliest end: a build round's first-wave request may end with
   its tokens before the eighth row streams, a measured round's may not).
   The measured round fails unless every
   host launch of K1, K3 and K4 came from the eager first run of a graph
   the pass captured (every other launch was inside a replay) and, per
   batched family, ``GET /v1/programs`` shows one capture per build
   (``[graphs] batched pass=`` lines, with the device memory at the pass's
   start). After the passes, ``POST /v1/warmup`` twice on the last server:
   the second must build and capture nothing and replay the warmed
   families;
6b. batched graphs — the batched dispatches (``batched_traffic``: an
   admission prefill of 7 prompts at 150..600 tokens and a padding row, two
   plain chunks of 8 steps, spec chunks of 4 rounds at depth 8 with n-gram
   proposals and at depth 7 without, chained on device-resident tokens and
   positions, and a mixed chunk with a 200-token slice; greedy and sampled
   rows) through a pool's captured programs against the eager functions on
   an identical pool, in a round that builds every graph and one that
   replays them on refilled buffers, per KV pool type on bf16 weights and
   on bf16 pages on int4 weights: every token identical, each graph
   holding its kernels (K3 in every chunk, K1 in the prefill and slice,
   K4 on int4 weights); then ``[profile] graphs batched`` lines: wall and
   device ms of one replay per family (device: CUDA events behind a spin
   kernel, with torch.profiler's sum beside it), its kernel nodes, its
   capture seconds and the graph memory pool's bytes, beside the eager
   chunk's wall and device ms. Phase 5c also holds K3 inside a replay
   (one query per row, and the B=8 × W=9 verify window) on refilled
   inputs against its plain version;
7. tiered batched serving — run before the bf16 batched passes (the
   priority pass leaves an interactive burn that would slice its long
   prompts at the smallest budget), the batched daemon at the defaults
   with XOT_TPU_BATCH_PAGES=257: per KV pool type, 32 pages of a seeded
   pool at llama-3.2-1b's page geometry spill through the host tier
   (``KvTierManager`` with the real ``read_pages``) and restore into 32
   other pages (``write_pages``): every leaf ``torch.equal``, and a K3
   step per layer on the restored pages bit-identical to the originals';
   the spill's host enqueue, the device ms of the spill and of the restore
   against a plain pinned copy of the same bytes, and the device ms of
   prefilling the 2,048 tokens they hold (``[tiered] round trip`` lines).
   Then, on the served path, a 1,536-token prompt's 24 pages are evicted
   and restored at the next admission of it plus 64 tokens: the suffix
   prefill's logits (K1) bit-identical to the run over never-evicted pages
   (``[tiered] restore`` line). Then 16 conversations (turn 1: prompts of
   1,024–1,504 tokens, greedy 32-token answers; turn 2, once all have
   finished: the history plus a 64-token follow-up) with the tier on and
   with XOT_TPU_KV_TIER=0, in turns on, off, off, on (``[tiered] pass=``
   lines: turn-2 TTFT p50/p95,
   prefix pages against the pages the token ids could match, pages
   spilled and restored, host MiB, GET /v1/kv/tier read mid-pass); the
   counters are zeroed just before the first tier-on pass and read just
   after. A tier-on pass fails unless it spilled and restored with no failure,
   launched K1 and K3, ended every request with all its tokens and the
   endpoint answered with host pages; the share of turn-2 greedy tokens
   the two passes agree on is reported, not gated;
7b. batched layouts — the batched daemon on the same checkpoint: first
   ``XOT_TPU_PAGED=auto``, whose server builds the layout the H100
   decode-path table answers at 8 slots and a 4096-token window (printed;
   the layout must follow the verdict); then the passes of
   ``LAYOUT_PASSES``, each the batched phase's 16 streaming greedy
   requests in two waves after a build round on other text (as the
   measured batched passes: the shapes are captured before the measured
   round, whose capture seconds are printed beside its rates): ``bf16_dense`` (``XOT_TPU_PAGED=0`` with
   ``XOT_TPU_FLASH_DECODE=1`` at a minimum of the window: K2 in every
   ``decode.batch`` replay, K1 in every dense verify window), and with the
   ``DRAFT_LAYERS``-layer draft loaded (``XOT_TPU_SPEC_DECODE=int8``,
   ``XOT_TPU_SPEC_DRAFT``): ``bf16_draft`` (paged: model-drafted rows
   verify through K3) and ``bf16_dense_draft``. The counters are zeroed
   just before each pass's requests and read just after. Gates: every
   request ends with all its tokens; the layout, the decode path label and
   the launches (dense: no K3, K2 once per layer per step in every
   ``decode.batch`` graph, K1 once per target and draft layer per round in
   every ``spec.batch`` graph; paged: K1 and K3); with the draft: the
   "model" proposer proposed, the draft's prefill dispatched (K1 once per
   draft layer), the ``kv_draft_*`` gauges set (8 slots), spec dispatches;
   every dispatch a replay or a new graph's first run, captures equal to
   builds; the server drained. Printed: dispatches by program name, the
   proposers' accepted and proposed tokens, the gauges, and the share of
   greedy tokens agreeing with the default paged pass (not gated);
7c. fetch — a daemon with an empty ``XOT_TPU_HOME`` and no
   ``XOT_TPU_MODEL_DIR`` serves llama-3.2-1b's card: it fetches the
   ``DRAFT_LAYERS``-layer checkpoint through the hub API from a
   ``127.0.0.1`` hub of the script's own (``_LoopbackHub``) and answers one
   streaming chat request on the card. Gates: every file fetched whole,
   the last progress event complete, tokens answered, K1 in the prefill.
   Every other phase runs with ``HF_HUB_OFFLINE=1``;
8. processes — with tokenizer files written into the checkpoint (a
   process resolves its tokenizer there): ``python -m
   xotorch_support_jetson_tpu_torch.main run llama-3.2-1b --prompt ...``
   prints its tokens and exits 0, and a daemon process serves a
   completion, gets ``POST /quit`` and exits 0 within ``QUIT_EXIT_S``;
8b. ring — llama-3.2-1b (the same checkpoint and tokenizer files) split
   over three partial shards, layers 0-7 / 8-11 / 12-15. In this process
   (part a): the whole model's captured prefill logits, greedy ids and the
   top-2 gap of its plain forward at every answer position; then three
   partial-shard engines (``ShardPrograms``: one replay per prefill bucket
   and per step) whose hops are chained by hand, each hidden state moved
   through the host as the peer transport moves it, a 72-token chat prompt
   and 64 greedy laps after a warm-up request. The counters are zeroed just
   before the counted request and read just after: K1 exactly 16 (8 + 4 +
   4 in the three prefills), no K2 or K4, no build or capture after the
   warm-up. Gates: the tail's prefill logits within 5e-2 relative L2 of the
   whole model's; the ring's ids equal the whole model's up to the first
   position whose top-2 gap is within ``SCORE_GAP_TOL`` (and its first EOS);
   each shard's captured prefill and step within 5e-2 of its uncaptured
   forward on the same inputs (bit-equality reported), the hops in bf16.
   Reported: the bytes per hop (the hidden state and the frame the peer
   transport sends), the per-token lap's host time against the three
   captured steps' device time (CUDA events behind a spin kernel), then a
   request with ``XOT_TPU_FLASH_DECODE=1`` (K2 exactly 16 per lap) and one
   on shards loaded with ``XOT_TPU_QUANT=int4`` (K4 must run). Then three
   daemon processes (part b) on the card, joined by manual discovery on
   127.0.0.1 with ``XOT_TPU_MEMORY_MB`` 4800 / 2401 / 2400 (the same
   split), the weights found under their ``XOT_TPU_HOME``: once every
   ``/v1/topology`` lists the three with those memories and a warm-up
   request loaded the shards, a streaming and a blocking chat request to
   the head and a streaming one to the tail, the kernel launches read from
   each daemon's ``/metrics`` (``kernel_launches_total``) just before and
   just after: K1 24 / 12 / 12 (each daemon's layers once per prefill).
   Gates: every answer's ids equal part a's up to the near-tie bound, every
   ``/v1/topology`` lists the three, and a request for llama-3.1-8b (its
   ``config.json`` alone under the daemons' home) answers 507. The head's
   streaming TTFT and decode rate are printed beside the solo phase's;
   each daemon gets ``POST /quit`` and must exit 0;
8e. lora — multi-LoRA serving on the same llama-3.2-1b checkpoint, before
   it is removed: ten seeded adapters on wq/wv (ranks 16 and 8, f32 npz
   under build/, B large enough that an adapter row's greedy tokens leave
   the base's) served from ``XOT_TPU_LORA_DIR`` with
   ``XOT_TPU_LORA_RANK=16`` and ``XOT_TPU_LORA_SLOTS=8``. Solo: a daemon
   with ``XOT_TPU_LORA=0`` gives the base tokens and no registry; then the
   registry lists the ten (``GET /v1/adapters``), an adapter selected by
   the ``model`` field and one by ``x-adapter`` leave the base tokens, the
   base request's tokens equal the ``XOT_TPU_LORA=0`` daemon's, an unknown
   name answers 400 ``unknown_adapter``, and the selected adapters' logits
   on the served weights (the hook, K1) agree with a plain f32 forward on
   merged weights W + 2·A·B within 5e-2 relative L2. Batched
   (``LORA_PASSES``): the paged default (K1, K3, n-gram spec dispatches
   with adapter rows required), the dense layout with K2, and int4 base
   weights (K4): per pass a 16-request wave naming six adapters beside
   base rows, then one naming the four not resident, which swap in
   without a 429; every adapter's logits on its row's prompt against the
   merged plain forward, its greedy token against the row's first token,
   no pin left, the aggregate tok/s (beside a base-only wave on the paged
   pass) and ``lora_swap_seconds``. The hook's device time: a captured
   solo step and a captured B=8 ``decode.paged_batch`` chunk, hook off and
   on. K1-K4 each launch on the phase's path (``lora`` in the kernels
   line);
8c. moe — a seeded random bf16 checkpoint at Qwen3-30B-A3B's published
   shapes (``QWEN3_30B_A3B``: hidden 2048, 32/4 heads at hd 128, 128
   experts of 768, top-8 renormalised, qk-norm, vocab 151936, an untied
   head), 12 of its 48 layers (``MOE_LAYERS``: the run's time limit; the
   byte tokenizer's bos / eos ids), written once. First the two MoE paths
   of ops/moe.py (gather, einsum) timed on one layer's experts, bf16 and
   int4, at T = 1 … 128 (``moe_path_rows``: device ms, bytes moved, the
   two outputs within 1e-2 relative L2; the T up to which gather won,
   beside ops/moe.py's H100 table). Then the daemon: solo bf16, every
   dispatch captured — greedy blocking and streaming chat after a warm-up
   pair of the same requests, the counts zeroed just before and read just
   after: ids equal, K1 12 per prefill and no K2 / K3 / K4, every MoE call
   on the path the H100 table gives its token count (``_check_moe_paths``),
   no build or capture after the warm-up; the served logits of the
   prompt's last token (captured prefill) and of one captured decode step
   after it within 5e-2 relative L2 of a plain f32 forward written out
   here (``moe_plain_f32``, its own top-k routing); captured against
   uncaptured (ids identical, prefill logits within 5e-2); the captured
   decode step's wall and device ms and the routed FFN's share of it (the
   12 layers' FFN captured alone); then batched at the defaults on the same
   engine (16 streams, spec and mixed dispatches required, decode chunks
   through K3; K1 and K3 in whole multiples of 12, every MoE call on the
   table's path); then solo with ``XOT_TPU_QUANT=int4`` (ids equal, K4
   once per two-dimensional quantized product per forward, 4 a layer and
   the head: the experts are dequantized next to their product, as in the
   reference; the MoE calls on the table's int4 paths);
8d. mla — a seeded random bf16 checkpoint at DeepSeek-Coder-V2-Lite's
   published shapes (``DEEPSEEK_CODER_V2_LITE``: hidden 2048, 16 heads,
   MLA latent 512 and rope 64, no q LoRA, yarn; layer 0 dense, then 64
   experts of 1408, top-6, 2 shared; vocab 102400, untied; its bos / eos
   100000 / 100001, the ``DeepseekByteTokenizer``'s), 8 of its 27 layers
   (``MLA_LAYERS``: the run's time limit and the disk a call may write;
   ``scripts/mla_phase.py --layers 27`` serves the full depth), routers of
   logit std 3, written once after the MoE checkpoint is removed. First
   one attention layer at DeepSeek-V3's widths (q LoRA 1536, 128 heads)
   over a 4,096-slot latent cache: the port's absorbed op against the
   naive per-head f32 form within 5e-2 (``mla_v3_attention_check``). Then
   the daemon: solo bf16, every dispatch captured — a warm-up round of
   every request kind, then the counted round, the counts zeroed just
   before and read just after: greedy blocking and streaming chat ids
   equal, a 3,000-token prompt blocking and streaming ids equal, one
   n-gram streaming request (spec chunks dispatched), one logprobs request
   (entries aligned, one scoring dispatch); K1, K2, K3 and K4 launch 0
   times (MLA attends through the plain absorbed op, the naive cache-less
   form and the paged gather, as the reference routes it), every MoE call
   on the path the H100 table gives its token count, no build or capture
   after the warm-up; the served logits of the long prompt's last token
   (captured prefill) and of one captured decode step after it within
   5e-2 relative L2 of a naive f32 forward written out here
   (``mla_plain_f32``); captured against uncaptured; the captured decode
   step's wall and device ms with the absorbed op's and the MoE FFN's
   shares (each captured alone); then batched at the defaults on the same
   engine (16 streams; no mixed and no spec dispatch, as the reference's
   MLA server runs neither; K1-K3 0); then solo with
   ``XOT_TPU_QUANT=int4`` (ids equal, nothing built after its warm-up
   pair, K4 once per two-dimensional product
   per forward: q, the latent projection and o in every layer, layer 0's
   MLP, the shared experts of every MoE layer and the head, 6·8 + 1);
9. gemma2 — a seeded random bf16 checkpoint at gemma-2-9b's published
   shapes (``GEMMA_2_9B``: head dim 256, softcaps 50 / 30, a 4,096-token
   window on the even layers; the bos / eos / pad ids are the byte
   tokenizer's), 8 of its 42 layers (``GEMMA_LAYERS``: the run's time
   limit; ``scripts/gemma2_phase.py --layers 42`` serves the full depth),
   written once, served through the daemon:
   solo bf16 with ``XOT_TPU_MAX_SEQ=8192``, every dispatch captured
   (greedy blocking and streaming chat ids equal; a 6,000-token prompt,
   bucket 6016, blocking and streaming ids equal; one logprobs request,
   entries aligned, one scoring dispatch; one n-gram streaming request,
   spec chunks dispatched; K1, K2 and K3 launch 0 times over all of them:
   gemma2 attends through the plain route, as the reference routes it);
   the served logits of the long prompt's last token (captured prefill)
   and of one captured decode step after it against a plain f32 forward
   written out here (``gemma_plain_f32``) within 5e-2 relative L2, and the
   same forward without the window more than 5e-2 away; the captured
   programs against the uncaptured functions (greedy ids identical, the
   6016 bucket's logits within 5e-2); the captured decode step's wall and
   device ms at position 6000 and the long prefill's, each with the plain
   attention's share; then batched at the defaults on the same engine (16
   streams, spec and mixed dispatches required, decode chunks on the
   gather route, K1-K3 0); then solo with ``XOT_TPU_QUANT=int4`` (ids
   equal, K4 once per quantized product per forward: 7 a layer and the
   head). Phase 3 also holds K4 at gemma-2-9b's six weight shapes, T = 1.
   The MoE and MLA phases run before it: each removes its checkpoint.
10. llava — a seeded random bf16 checkpoint at llava-hf/llava-1.5-7b-hf's
   published shapes (``LLAVA_15``: the whole CLIP ViT-L/14-336 tower, of
   which 23 layers run, the 1024 → 4096 → 4096 projector, and 8 of the
   llama-2-7b decoder's 32 layers, ``LLAVA_LAYERS``; ~4.4 GB under the HF
   llava key names, so the loader's vision map runs; removed after the
   phase), served through the daemon with ``XOT_TPU_FLASH_DECODE=1``
   (``XOT_TPU_FLASH_DECODE_MIN=4096``), the byte tokenizer's BOS / EOS 1 /
   2 and a Pillow front end standing in for the HF processor
   (``LlavaByteProcessor``: 336×336, CLIP's normalization, 576
   placeholders of id 32000 an image). It prints what ``import PIL,
   transformers`` gives here. A warm-up round, then, each counted alone:
   one greedy streaming chat request with a PNG ``image_url`` (where
   Pillow is missing: the 400 naming it, then the engine's device half on
   seeded pixels), K1 exactly once per decoder layer (its embeddings
   prefill), K2 in its decode, K3 never, one ``vision.encode`` and one
   ``prefill.embeds`` dispatch, its ids equal to an uncaptured forward of
   the same merged embeddings on the card (``llava_plain_tokens``); one
   text-only streaming request (K1 once per layer, K2); nothing built or
   captured after the warm-up. Then the tower's features and the served
   prefill's logits against a plain f32 forward (``llava_plain_f32``)
   within 5e-2 relative L2, the tower's time per image and its share of
   the image request's TTFT; a batched wave of 16 text requests at the
   defaults (K1 and K3; spec and mixed dispatches); then the two solo
   requests again with ``XOT_TPU_QUANT=int4`` (K4 in them, the tower kept
   in bf16). Phase 3 holds K1–K4 at llava-1.5-7b's shapes.
   ``scripts/llava_phase.py`` runs it at all 32 layers and adds one
   llava-1.6-vicuna-7b any-res request.
11. diffusion — after the llava checkpoint is removed, a seeded random bf16
   checkpoint at stabilityai/stable-diffusion-2-1-base's published shapes
   (``sd21_base_config``: OpenCLIP-H's text tower, the 320 / 640 / 1280 /
   1280 UNet, the 128 … 512 VAE, 512 px), drawn on the card and written in
   the diffusers layout by the port's exporter (~2.6 GB, no tokenizer: the
   crc32 fallback tokenizes; removed after the phase), loaded by the daemon
   through the port's loader, then over HTTP: a 512 × 512, 20-step DDIM
   request at guidance 7.5 on ``/v1/image/generations`` (progress 0, 5,
   10, 15, 20 of 20; the PNG fetched from its URL decodes to 512 × 512
   RGB), the same request again (identical pixels), ``n=2`` ``b64_json``
   on ``/v1/images/generations`` (two different images), img2img from an
   off-grid 500 × 380 PNG at strength 0.5 (512 × 384, 10 steps), two Euler
   candidates through the engine's pipeline (neither route takes a
   sampler, in either package), and a chat request refused with the
   engine's 501; K1–K4 launch 0 times. Then CLIP, one UNet call (t = 500,
   the guidance batch of 2, 64 × 64) and one VAE decode in bf16 against
   the same weights in plain f32 within 5e-2 relative L2; a denoise
   step's, the UNet's, CLIP's and the decode's wall against the profiler's
   device time and their launches (the step also by CUDA events, which
   span its host enqueue), the phase's peak memory.
   ``scripts/diffusion_phase.py`` runs it alone.

The last two lines are the card as ``nvidia-smi`` reports it and
``{"ok": true, "device": {...}}``; the line before them is the kernels' JSON
summary. A full record goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import asyncio
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, same source
K1_ATOL = 3e-2  # bf16 output + bf16-rounded probabilities in the P·V product: K1's absolute cap
# K1 elementwise as well: |got - ref| <= K1_EW_ATOL + K1_RTOL * |ref|. Both
# sides round once to bf16 (2^-7 of the value covers the two roundings); the
# kernel also rounds p to bf16 for the tensor-core P·V product (2^-9 of each
# p, at most ~2^-9·max|v| on a row), which the absolute part covers: it is
# 2.4 times the largest reading beyond the relative part on an H100 (4.2e-3,
# int8 K/V at Sq 128). A wrong mask or a dropped tile is off by 0.1 or more.
K1_EW_ATOL = 1e-2
K1_RTOL = 2.0**-7
# K3 elementwise: |got - ref| <= K3_ATOL + K3_RTOL * |ref|. f32 math inside
# and a bf16 output, so the two may differ by one bf16 rounding step
# (<= 2^-7 of the value); the absolute part is twice the largest reading on
# the card (1.2e-4). Outputs at a 4k context are ~0.02 (~0.013 at 16k), so a
# split-K merge off by a few percent fails.
K3_ATOL = 2.5e-4
K3_RTOL = 2.0**-7
# K2 runs K3's device core (csrc/decode_attention.cuh) on a dense slot
# cache: the same arithmetic, so the same elementwise bound. A flat 1e-2
# would pass errors near a typical output at a 16k context.
K2_ATOL = K3_ATOL
K2_RTOL = K3_RTOL
# K4 elementwise: |got - ref| <= K4_ATOL + K4_RTOL * |ref|. Kernel and plain
# version both sum in f32 and round once to bf16, so they may differ by one
# bf16 rounding step (<= 2^-7 of the value); the absolute part covers the
# f32 summation-order difference near zero, whose largest reading on an
# H100 was 6.3e-8 (15 shapes, T = 1 / 8 / 128). Outputs are ~N(0, 1) (unit
# x, weights scaled 1/sqrt(in)), so 1e-4 is a ten-thousandth of a typical
# value: a merge that drops one of 16 in-splits is off by ~0.25.
K4_ATOL = 1e-4
K4_RTOL = 2.0**-7
# K4 with f32 x (rounded to bf16 inside, as the TPU kernel does): f32 y with
# no final rounding, so the relative part is the f32 summation order over up
# to 8192 terms, not a bf16 step; the absolute part is K4's.
K4_F32_ATOL = 1e-4
K4_F32_RTOL = 1e-5
# llama-3.2-1b: meta-llama/Llama-3.2-1B config.json (published values).
LLAMA_3_2_1B = {
  "architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": 128256, "hidden_size": 2048,
  "intermediate_size": 8192, "num_hidden_layers": 16, "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 64,
  "rms_norm_eps": 1e-5, "rope_theta": 500000.0, "max_position_embeddings": 131072, "tie_word_embeddings": True,
  "rope_scaling": {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
  "bos_token_id": 128000, "eos_token_id": [128001, 128008, 128009], "torch_dtype": "bfloat16",
}
CACHE = 4096  # the serving cap (XOT_TPU_MAX_SEQ default)
MAX_TOKENS = 64
PAGE = 64  # XOT_TPU_PAGE_SIZE default
BATCH_SLOTS = 8
KV_MODES = {"bf16": "", "int8": "int8", "int4": "int4"}
# llama-3.2-1b's weight products, (in, out), and how many one decode step
# makes: 16 layers and the tied LM head.
LLAMA_1B_MATMULS = {"wq/wo": (2048, 2048), "wk/wv": (2048, 512), "w_gate/w_up": (2048, 8192), "w_down": (8192, 2048), "lm_head": (2048, 128256)}
CALLS_PER_STEP = {"wq/wo": 32, "wk/wv": 32, "w_gate/w_up": 32, "w_down": 16, "lm_head": 1}
# gemma-2-9b: google/gemma-2-9b config.json (published values), but for
# three fields the phase logs: the bos / eos / pad ids (2 / 1 / 0) are bytes
# under the smoke's byte tokenizer, so the written config takes the
# tokenizer's ids (``ByteTokenizer``: 128000 / 128009, pad = eos), and the
# weights are random bf16 (the published file says float32).
GEMMA_2_9B = {
  "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2", "vocab_size": 256000, "hidden_size": 3584, "intermediate_size": 14336,
  "num_hidden_layers": 42, "num_attention_heads": 16, "num_key_value_heads": 8, "head_dim": 256, "query_pre_attn_scalar": 256,
  "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0, "sliding_window": 4096, "max_position_embeddings": 8192, "rms_norm_eps": 1e-6,
  "rope_theta": 10000.0, "hidden_activation": "gelu_pytorch_tanh", "hidden_act": "gelu_pytorch_tanh", "attention_bias": False, "tie_word_embeddings": True,
  "bos_token_id": 128000, "eos_token_id": 128009, "pad_token_id": 128009, "torch_dtype": "bfloat16",
}
# gemma-2-9b's weight products, (in, out), and how many one decode step
# makes: 42 layers and the tied LM head.
GEMMA_2_9B_MATMULS = {"wq": (3584, 4096), "wk/wv": (3584, 2048), "wo": (4096, 3584), "w_gate/w_up": (3584, 14336), "w_down": (14336, 3584), "lm_head": (3584, 256000)}
GEMMA_CALLS_PER_STEP = {"wq": 42, "wk/wv": 84, "wo": 42, "w_gate/w_up": 84, "w_down": 42, "lm_head": 1}
# Weight-quantized solo passes: the environment each daemon starts with.
QUANT_MODES = {"int4": {"XOT_TPU_QUANT": "int4"}, "int8": {"XOT_TPU_QUANT": "int8"}, "int8_w8a8": {"XOT_TPU_QUANT": "int8", "XOT_TPU_QUANT_COMPUTE": "w8a8"}}
# Solo speculation knobs: every daemon starts with them unset.
SPEC_KNOBS = ("XOT_TPU_SPEC_DECODE", "XOT_TPU_SPEC_DRAFT", "XOT_TPU_SPEC_AUTOCAL", "XOT_TPU_SPEC_NGRAM", "XOT_TPU_SPEC_GAMMA", "XOT_TPU_SPEC_NGRAM_MAX", "XOT_TPU_SPEC_REPROBE")


def log(msg: str) -> None:
  print(msg, flush=True)


# ---------------------------------------------------------------- 1. device


def _smi() -> str:
  """The card's name and power limit as ``nvidia-smi`` reports them."""
  return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def phase_device(torch):
  if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: no CUDA device visible (torch.cuda.is_available() is false)")
  smi = _smi()
  cap = torch.cuda.get_device_capability(0)
  log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | compute capability {cap[0]}.{cap[1]} | torch {torch.__version__} cuda {torch.version.cuda}")
  if cap < (9, 0):
    raise SystemExit(f"chip_smoke: the kernels are built for sm_90a; this card is sm_{cap[0]}{cap[1]}")
  return smi


# ---------------------------------------------------------------- 2. build


def phase_build():
  from xotorch_support_jetson_tpu_torch.ops import kernels

  t0 = time.perf_counter()
  libs = kernels.build_all()
  dt = time.perf_counter() - t0
  for name, lib in libs.items():
    regs = [ln.split("info    : ")[-1] for ln in lib.with_suffix(".log").read_text().splitlines() if "registers" in ln or "spill" in ln]
    log(f"[build] {name}: {lib.name}; ptxas: {' | '.join(sorted(set(regs)))[:400]}")
  log(f"[build] {len(libs)} kernels built in {dt:.2f} s (parallel nvcc)")
  return dt


# ---------------------------------------------------------------- 3. kernels


def _cuda_ms(torch, fn, iters=30, warmup=3):
  """Mean device time of ``fn`` over ``iters`` calls, each timed with CUDA
  events after a 64 MB write that evicts the 50 MB L2 (a serving step finds
  a layer's cache cold: the other layers' weights pass through L2 between).
  A ~1 ms spin kernel ahead of each call lets the host enqueue the call
  before the card reaches it, so the events time the device work and not
  the wrapper's host-side cost."""
  flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
  for _ in range(warmup):
    fn()
  total = 0.0
  for _ in range(iters):
    flush.zero_()
    torch.cuda._sleep(2_000_000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    total += start.elapsed_time(end)
  return total / iters


def _rand(torch, shape, gen, dtype):
  return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def _launched(name: str) -> int:
  """Launches of kernel ``name`` since the last ``_reset_launches()``: its
  wrapper's host launches (``LAUNCHES``) plus the launches it made inside
  replayed CUDA graphs (utils/programs.py ``REPLAYED``: the launches a
  graph's capture recorded, once per replay)."""
  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa, int4_matmul as k4, paged
  from xotorch_support_jetson_tpu_torch.utils import programs

  host = {**fa.LAUNCHES, **paged.LAUNCHES, **k4.LAUNCHES}
  return host[name] + programs.REPLAYED.get(name, 0)


def _reset_launches() -> None:
  """Every launch count to 0: the wrappers' and the graph replays', and
  the MoE path counts (ops/moe.py ``PATHS``)."""
  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa, int4_matmul as k4, moe, paged
  from xotorch_support_jetson_tpu_torch.utils import programs

  fa.reset_launch_counts()
  paged.reset_launch_counts()
  k4.reset_launch_counts()
  moe.reset_path_counts()
  programs.reset_replayed()


def phase_kernels(torch):
  gen = torch.Generator(device="cuda").manual_seed(SEED)
  Hq, Hkv, hd = 32, 8, 64
  results = {"flash_prefill": flash_prefill_rows(torch, gen)}
  results["flash_prefill_verify"] = flash_prefill_rows(torch, gen, K1_VERIFY_ROWS)
  results["flash_prefill_scoring"] = flash_prefill_rows(torch, gen, K1_SCORING_ROWS, own_kv=True)
  results["flash_decode"] = flash_decode_rows(torch, gen, Hq, Hkv, hd)
  # The dense batched layout's shapes: K1 at B=8 verify windows, each row at
  # its own offset, and K2 at B=8 rows of mixed positions.
  results["flash_prefill_b8_verify"] = flash_prefill_rows(torch, gen, K1_B8_VERIFY_ROWS)
  results["flash_decode_b8"] = flash_decode_rows(torch, gen, Hq, Hkv, hd, K2_B8_ROWS)
  results["paged_decode"] = paged_kernel_rows(torch, gen, Hq, Hkv, hd)
  results["paged_window"] = paged_window_rows(torch, gen, Hq, Hkv, hd)
  # The model-drafted verify window (the bf16_draft pass's spec.paged_batch): W=5.
  results["paged_window_w5"] = paged_window_rows(torch, gen, Hq, Hkv, hd, W=DRAFT_VERIFY_W, wide=False)
  results["int4_matmul"] = int4_kernel_rows(torch, gen)
  results["int4_matmul_bound"] = int4_matmul_bound(results["int4_matmul"])
  # K4 at gemma-2-9b's weight shapes, solo decode (T = 1): the gemma2 int4 phase's products.
  results["int4_matmul_gemma2"] = int4_kernel_rows(torch, gen, GEMMA_2_9B_MATMULS, tokens=(1,), f32_row=False, model="gemma-2-9b")
  results["int4_matmul_gemma2_bound"] = int4_matmul_bound(results["int4_matmul_gemma2"], GEMMA_CALLS_PER_STEP, tokens=(1,), model="gemma-2-9b")
  # Qwen3-30B-A3B's shapes (the MoE phase): K1 at its 128 prefill bucket and
  # K3 at B=8 mixed lengths, 32/4 heads at hd 128; K4 at its products outside
  # the experts, solo decode (T = 1).
  results["flash_prefill_moe"] = flash_prefill_rows(torch, gen, [(128, [0], "bf16", 128)], heads=(32, 4))
  results["paged_decode_moe"] = paged_kernel_rows(torch, gen, 32, 4, 128, length_sets=K3_LENGTHS[-1:], kvs=("bf16",))
  results["int4_matmul_moe"] = int4_kernel_rows(torch, gen, QWEN3_MOE_MATMULS, tokens=(1,), f32_row=False, model="Qwen3-30B-A3B")
  # DeepSeek-Coder-V2-Lite's products (the MLA phase's int4 path), solo decode (T = 1).
  results["int4_matmul_mla"] = int4_kernel_rows(torch, gen, DEEPSEEK_V2_LITE_MATMULS, tokens=(1,), f32_row=False, model="DeepSeek-Coder-V2-Lite")
  # llava-1.5-7b's decoder (the llava phase), 32/32 heads at hd 128: K1 at
  # its image prompt's 640 bucket, K2 at position 640 of the 4096-slot
  # cache, K3 at B=8 mixed lengths; K4 at its products, solo decode (T = 1).
  results["flash_prefill_llava"] = flash_prefill_rows(torch, gen, [(640, [0], "bf16", 128)], heads=(32, 32))
  results["flash_decode_llava"] = flash_decode_rows(torch, gen, 32, 32, 128, (([640], CACHE),))
  results["paged_decode_llava"] = paged_kernel_rows(torch, gen, 32, 32, 128, length_sets=K3_LENGTHS[-1:], kvs=("bf16",))
  results["int4_matmul_llava"] = int4_kernel_rows(torch, gen, LLAVA_MATMULS, tokens=(1,), f32_row=False, model="llava-1.5-7b")
  return results


# K1 rows: (Sq, per-row q offsets, KV type, head dim), Hq 32 / Hkv 8 (hd 64,
# as llama-3.2-1b; hd 128 keeps the heads: K1_HEADS), cache 4096. The first eight are
# the short rows, the head row first (the solo path's 128-token bucket). Then
# long prompts (a solo prompt is padded to a multiple of 128), the second
# 2048-token chunk of a 4096-token batched prefill (XOT_TPU_PREFILL_CHUNK),
# a ragged length, four batched rows behind a shared prefix, and hd 128. Last,
# mixed-tick slices (B=1, a power-of-two Sq at a large offset, over the
# 4096-slot gathered window): Sq 16 at 2048, 256 at 3072, 1024 at 1024.
K1_HEADS = (32, 8)  # (Hq, Hkv) of every K1 row
K1_ROWS = [
  (128, [0], "bf16", 64), (512, [0], "bf16", 64), (128, [128], "bf16", 64), (512, [128], "bf16", 64),
  (128, [0], "int8", 64), (512, [0], "int8", 64), (128, [128], "int8", 64), (512, [128], "int8", 64),
  (1024, [0], "bf16", 64), (2048, [0], "bf16", 64), (3072, [0], "bf16", 64), (4096, [0], "bf16", 64), (4096, [0], "int8", 64),
  (2048, [2048], "bf16", 64), (3000, [0], "bf16", 64), (512, [0, 128, 128, 1536], "bf16", 64), (2048, [0], "bf16", 128),
  (16, [2048], "bf16", 64), (256, [3072], "bf16", 64), (1024, [1024], "bf16", 64),
]
# K1 on solo speculation's verify windows (and the draft's catch-up): B=1,
# Sq = gamma+1 = 5 (int8 draft, depth 4) or 9 (n-gram, depth 8), early, in
# the middle and at the last window of the 4096-slot cache.
K1_VERIFY_ROWS = [(Sq, [off], kv, 64) for kv in ("bf16", "int8") for Sq in (5, 9) for off in (72, 1024, 4086)]
# K1 on the dense batched layout's verify windows (spec.batch): B=8 rows at
# their own offsets over the 4096-slot cache, Sq 5 (a model draft at depth
# 4) and 9 (n-gram depth 8), bf16 and int8 K/V. SDPA takes them in one call
# with a per-row causal mask over the cache (``k1_library``).
K1_B8_OFFSETS = [150, 214, 278, 342, 407, 471, 535, 600]
K1_B8_VERIFY_ROWS = [(Sq, K1_B8_OFFSETS, kv, 64) for kv in ("bf16", "int8") for Sq in (5, 9)]
# K2 on the dense layout's decode step (decode.batch): B=8 rows of mixed
# positions over the 4096-slot cache.
K2_B8_ROWS = (([1, 64, 65, 777, 1500, 2048, 3333, 4095], CACHE),)
# K1 in the logprobs scoring forward (models/decoder.py score_last_tokens):
# the sequence's own K/V (Sq = Skv = S_pad, no cache) from position 0, at
# the API phase's two buckets: the 72-token prompt with its 64-token answer
# (136 tokens, the 256 bucket) and the 3,000-token one (3072).
K1_SCORING_ROWS = [(256, [0], "bf16", 64), (3072, [0], "bf16", 64)]


def k1_case(torch, gen, Sq, offsets, kv, hd, skv=CACHE, heads=K1_HEADS):
  """One K1 row's inputs: q, k, v (``skv`` slots; int8 codes when ``kv``
  is "int8") and the wrapper's keywords. Every slot past a row's last
  position holds junk (1e4) that must stay masked; the offsets are a
  device tensor, as the decoder passes them."""
  from xotorch_support_jetson_tpu_torch.models.quantize import quantize_kv

  B, (Hq, Hkv) = len(offsets), heads
  q = _rand(torch, (B, Sq, Hq, hd), gen, torch.bfloat16)
  k = _rand(torch, (B, skv, Hkv, hd), gen, torch.bfloat16)
  v = _rand(torch, (B, skv, Hkv, hd), gen, torch.bfloat16)
  for b, off in enumerate(offsets):
    k[b, off + Sq :] = 1e4
    v[b, off + Sq :] = 1e4
  kw = {"q_offset": torch.tensor(offsets, dtype=torch.int32, device="cuda")}
  if kv == "int8":
    (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
    kw.update(k_scale=ks, v_scale=vs)
  return q, k, v, kw


def k1_bound(Sq, offsets, kv, hd, heads=K1_HEADS):
  """The least time the card could take for a K1 call: the larger of its
  operations (4·hd·Hq per causal (query, key) pair) over the bf16 peak and
  its bytes (q and out, and the live K/V — codes and scales for int8 —
  each once) over the HBM rate. Returns (ms, what bounds it, flops, bytes)."""
  B, (Hq, Hkv) = len(offsets), heads
  pairs = sum(off * Sq + Sq * (Sq + 1) // 2 for off in offsets)  # sum over rows of (position + 1)
  flops = 4 * hd * Hq * pairs
  live = sum(off + Sq for off in offsets)
  kv_bytes = 2 * live * Hkv * (hd + 4 if kv == "int8" else 2 * hd)
  nbytes = 2 * B * Sq * Hq * hd * 2 + kv_bytes
  by_flops, by_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
  return max(by_flops, by_bytes), "operations" if by_flops >= by_bytes else "bytes", flops, nbytes


def k1_library(torch, q, k, v, offsets):
  """The fair PyTorch yardstick for a bf16 K1 row (the port never calls
  it): scaled_dot_product_attention over the live slots only, with causal
  masking the library's causal kernels take — ``is_causal=True`` at offset
  0, ``causal_lower_right(Sq, off + Sq)`` otherwise. Each SDPA backend is
  tried alone and the fastest that runs is kept; kv heads are expanded
  outside the timing where a backend refuses ``enable_gqa``. Rows at
  different offsets take one call over the whole cache with a boolean
  per-row causal mask [B, 1, Sq, Skv] (key j visible to query i of row b
  while j <= offset_b + i), as the K2 and verify-window rows time SDPA."""
  import torch.nn.functional as F
  from torch.nn.attention import SDPBackend, sdpa_kernel
  from torch.nn.attention.bias import causal_lower_right

  Sq = q.shape[1]
  qt = q.transpose(1, 2).contiguous()
  if len(set(offsets)) == 1:
    live = offsets[0] + Sq
    kt, vt = k[:, :live].transpose(1, 2).contiguous(), v[:, :live].transpose(1, 2).contiguous()
    mask = None if offsets[0] == 0 else causal_lower_right(Sq, live)
    how = "is_causal" if mask is None else "causal_lower_right"
  else:
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    last = torch.tensor(offsets, device=q.device)[:, None] + torch.arange(Sq, device=q.device)[None, :]  # each query's last visible slot
    mask = (torch.arange(k.shape[1], device=q.device)[None, None, :] <= last[:, :, None])[:, None]
    how = "per-row boolean causal mask"
  group = q.shape[2] // k.shape[2]
  ke, ve = kt.repeat_interleave(group, dim=1), vt.repeat_interleave(group, dim=1)  # outside the timing
  best = None
  for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION):
    for gqa, kk, vv in (("enable_gqa", kt, vt), ("expanded", ke, ve)):
      kwargs = {"is_causal": True} if mask is None else {"attn_mask": mask}
      if gqa == "enable_gqa":
        kwargs["enable_gqa"] = True

      def call(kk=kk, vv=vv, kwargs=kwargs, backend=backend):
        with sdpa_kernel([backend]):
          return F.scaled_dot_product_attention(qt, kk, vv, **kwargs)

      try:
        call()
        torch.cuda.synchronize()
      except RuntimeError:
        continue
      ms = _cuda_ms(torch, call)
      if best is None or ms < best[0]:
        best = (ms, f"{backend.name.lower()} ({gqa}, {how})", call)
      break
  if best is None:
    return None, "no SDPA backend took the call"
  return best[0], f"{best[1]}; device kernels: {', '.join(_kernel_names(torch, best[2]))}"


def _kernel_names(torch, fn):
  """Names of the device kernels of one call of ``fn`` (torch.profiler)."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  return sorted({e.name[:80] for e in prof.events() if e.device_type == DeviceType.CUDA})


def flash_prefill_rows(torch, gen, rows=K1_ROWS, own_kv=False, heads=K1_HEADS):
  """K1 against its plain version at ``rows`` (against the 4096-slot
  cache, or with ``own_kv`` the row's own Sq slots): max |err| (held to
  ``K1_ATOL`` and elementwise to ``K1_EW_ATOL + K1_RTOL·|ref|``), kernel /
  plain / fair-library time, the card's bound, and the count of device
  kernels in one call (``_kernels_per_call``), which must be 1."""
  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa

  out = []
  for Sq, offsets, kv, hd in rows:
    skv = Sq if own_kv else CACHE
    q, k, v, kw = k1_case(torch, gen, Sq, offsets, kv, hd, skv, heads)
    got = fa.flash_attention_prefill(q, k, v, **kw)
    want = fa.flash_attention_prefill_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    beyond_rel = (diff - K1_RTOL * want.float().abs()).max().item()  # what the relative part leaves to the absolute one
    used = (diff / (K1_EW_ATOL + K1_RTOL * want.float().abs())).max().item()  # share of the elementwise bound the worst element uses
    label = f"B={len(offsets)} Sq={Sq} q_offset={offsets if len(offsets) > 1 else offsets[0]} kv={kv} hd={hd}" + ("" if heads == K1_HEADS else f" heads={heads[0]}/{heads[1]}")
    if not torch.isfinite(got).all() or not err <= K1_ATOL or not used <= 1.0:
      raise SystemExit(f"chip_smoke: flash_prefill disagrees with its plain version ({label}): max|err| {err} (cap {K1_ATOL}), {used:.2f}x the bound atol {K1_EW_ATOL} + rtol 2^-7·|ref|")
    del diff, want
    bound_ms, bound_by, flops, nbytes = k1_bound(Sq, offsets, kv, hd, heads)
    lib_ms, library = k1_library(torch, q, k, v, offsets) if kv == "bf16" else (None, "no PyTorch call takes int8 codes with scales")
    row = dict(
      Sq=Sq, q_offset=offsets[0] if len(offsets) == 1 else offsets, B=len(offsets), kv=kv, hd=hd, heads=list(heads), skv=skv, max_abs_err=err, abs_beyond_rel=beyond_rel,
      tol=dict(cap=K1_ATOL, atol=K1_EW_ATOL, rtol=K1_RTOL), tol_used=used,
      ms=_cuda_ms(torch, lambda: fa.flash_attention_prefill(q, k, v, **kw)),
      plain_ms=_cuda_ms(torch, lambda: fa.flash_attention_prefill_ref(q, k, v, **kw), iters=10 if Sq <= 1024 else 3, warmup=1),
      library_ms=lib_ms, library=library, bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes,
    )
    row["bound_share"] = bound_ms / row["ms"]
    row["device_kernels_per_call"] = _kernels_per_call(torch, lambda: fa.flash_attention_prefill(q, k, v, **kw))
    if row["device_kernels_per_call"] != 1:
      raise SystemExit(f"chip_smoke: flash_prefill {label}: {row['device_kernels_per_call']} device kernels per call, expected 1")
    out.append(row)
    lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
    log(f"[kernels] flash_prefill {label} {'own K/V (Sq = Skv, the scoring forward)' if own_kv else f'cache={CACHE}'}: max|err| {err:.3e} (cap {K1_ATOL}; {used:.3f} of the bound atol {K1_EW_ATOL} + rtol 2^-7·|ref|; beyond the relative part {beyond_rel:.2e}) | kernel {row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | sdpa {lib} ({library}) | bound {bound_ms:.5f} ms ({bound_by}; {row['bound_share']:.3f} of it reached) | {row['device_kernels_per_call']} device kernel per call")
    del q, k, v, kw, got
  return out


K2_ROWS = (([4095], CACHE), ([127], CACHE), ([0], CACHE), ([0, 1000, 2047, 4095], CACHE), ([16383], 16384))


def flash_decode_rows(torch, gen, Hq, Hkv, hd, rows_at=K2_ROWS):
  """K2 against its plain version at ``rows_at`` ((positions, cache)
  pairs; by default the solo path's cache (4096) at positions 4095 / 127 /
  0 / mixed, and cache 16384 at position 16383). One call of each row must
  be one device kernel (``_kernels_per_call``)."""
  import torch.nn.functional as F

  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa

  rows = []
  for positions, cache in rows_at:
    B = len(positions)
    q = _rand(torch, (B, 1, Hq, hd), gen, torch.bfloat16)
    k = _rand(torch, (B, cache, Hkv, hd), gen, torch.bfloat16)
    v = _rand(torch, (B, cache, Hkv, hd), gen, torch.bfloat16)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")[:, None]
    got = fa.flash_decode_attention(q, k, v, pos)
    want = fa.flash_decode_attention_ref(q, k, v, pos)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    # Share of the allowed error used by the worst element (<= 1 passes).
    used = (diff / (K2_ATOL + K2_RTOL * want.float().abs())).max().item()
    if not torch.isfinite(got).all() or not used <= 1.0:
      raise SystemExit(f"chip_smoke: flash_decode disagrees with its plain version (positions={positions} cache={cache}): max|err| {err}, {used:.2f}x the bound atol {K2_ATOL} + rtol {K2_RTOL}·|ref|")
    live = sum(p + 1 for p in positions)
    nbytes = 2 * live * Hkv * hd * 2 + 2 * B * Hq * hd * 2
    flops = 4 * hd * Hq * live
    bound_flops, bound_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(cache, device="cuda")[None, :] <= pos)[:, None, None, :]
    row = dict(
      B=B, positions=positions, cache=cache, max_abs_err=err, tol=dict(atol=K2_ATOL, rtol=K2_RTOL), tol_used=used,
      ms=_cuda_ms(torch, lambda: fa.flash_decode_attention(q, k, v, pos)),
      plain_ms=_cuda_ms(torch, lambda: fa.flash_decode_attention_ref(q, k, v, pos)),
      library_ms=_cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)),
      bound_ms=max(bound_flops, bound_bytes), bound_by="operations" if bound_flops >= bound_bytes else "bytes",
    )
    row["device_kernels_per_call"] = _kernels_per_call(torch, lambda: fa.flash_decode_attention(q, k, v, pos))
    if row["device_kernels_per_call"] != 1:
      raise SystemExit(f"chip_smoke: flash_decode positions={positions} cache={cache}: {row['device_kernels_per_call']} device kernels per call, expected 1")
    rows.append(row)
    log(f"[kernels] flash_decode B={B} positions={positions} cache={cache}: max|err| {err:.3e} ({used:.3f} of the bound atol {K2_ATOL} + rtol 2^-7·|ref|) | kernel {row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | sdpa {row['library_ms']:.4f} ms | bound {row['bound_ms']:.5f} ms ({row['bound_by']}, {nbytes / 1e6:.2f} MB) | {row['device_kernels_per_call']} device kernel per call")
    del q, k, v
  return rows


def int4_kernel_rows(torch, gen, matmuls=LLAMA_1B_MATMULS, tokens=(1, 8, 128, 512), f32_row=True, model="llama-3.2-1b"):
  """K4 against its plain version at ``matmuls``' weight shapes (by default
  llama-3.2-1b's five), at ``tokens`` rows: T = 1 (solo decode), 8 (batched
  decode, 8 slots), 128 (the prefill bucket) and 512 (a batched prefill
  call), plus one row with f32 x (``f32_row``). The yardstick
  is torch.matmul of the same x with the weight dequantized beforehand (bf16,
  or f32 for f32 x) — the product int4 mode replaces; the dequant is not
  timed. One call at T = 1 and 8 must be one device kernel
  (``_kernels_per_call``)."""
  from xotorch_support_jetson_tpu_torch.models.quantize import dequantize_leaf, quantize_weight_int4
  from xotorch_support_jetson_tpu_torch.ops import int4_matmul as k4

  rows = []
  for name, (d_in, d_out) in matmuls.items():
    packed, scale = quantize_weight_int4(torch.randn((d_in, d_out), generator=gen, device="cuda") * d_in**-0.5)
    w_bf16 = dequantize_leaf(packed, scale, d_in, torch.bfloat16)
    cases = [(T, torch.bfloat16) for T in tokens] + ([(128, torch.float32)] if f32_row and name == "w_gate/w_up" else [])
    for T, dtype in cases:
      x = _rand(torch, (T, d_in), gen, dtype)
      f32 = dtype == torch.float32
      got = k4.int4_matmul(x, packed, scale)
      # f32 x: the kernel rounds x to bf16 for the tensor cores, as the TPU
      # kernel does, and writes f32 y; held to the plain version on that x.
      want = k4.int4_matmul_ref(x.to(torch.bfloat16).float() if f32 else x, packed, scale)
      torch.cuda.synchronize()
      atol, rtol = (K4_F32_ATOL, K4_F32_RTOL) if f32 else (K4_ATOL, K4_RTOL)
      diff = (got.float() - want.float()).abs()
      rel = rtol * want.float().abs()
      err = diff.max().item()
      used = (diff / (atol + rel)).max().item()  # share of the allowed error used by the worst element
      slack = (diff - rel).max().item()  # what the relative part leaves to the absolute one
      if got.dtype != dtype or not torch.isfinite(got).all() or not used <= 1.0:
        raise SystemExit(f"chip_smoke: int4_matmul disagrees with its plain version ({name} in={d_in} out={d_out} T={T} x {dtype}): max|err| {err}, {used:.2f}x the bound atol {atol} + rtol {rtol}·|ref|")
      xs = 4 if f32 else 2
      nbytes = d_in // 2 * d_out + d_out * 4 + T * d_in * xs + T * d_out * xs  # packed codes, scales, x, y
      flops = 2 * T * d_in * d_out
      bound_flops, bound_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
      w_lib = w_bf16.float() if f32 else w_bf16
      cfg, split = k4.plan(T, d_in, d_out, k4.sm_count(x.device.index), k4.wide_ok(x, packed))  # the wrapper's launch geometry
      row = dict(
        model=model, weight=name, T=T, d_in=d_in, d_out=d_out, x_dtype=str(dtype).removeprefix("torch."), tile_t=k4.TILE_T[cfg], split=split,
        mma="wgmma" if cfg == 2 else "mma.sync",
        max_abs_err=err, abs_slack=slack, tol=dict(atol=atol, rtol=rtol), tol_used=used,
        ms=_cuda_ms(torch, lambda: k4.int4_matmul(x, packed, scale)),
        plain_ms=_cuda_ms(torch, lambda: k4.int4_matmul_ref(x, packed, scale), iters=10),
        library_ms=_cuda_ms(torch, lambda: torch.matmul(x, w_lib)),
        library=f"torch.matmul of {'f32' if f32 else 'bf16'} x with the weight dequantized to {'f32' if f32 else 'bf16'} beforehand (dequant not timed)",
        bound_ms=max(bound_flops, bound_bytes), bound_by="operations" if bound_flops >= bound_bytes else "bytes",
      )
      del w_lib
      if T <= 8:
        row["device_kernels_per_call"] = _kernels_per_call(torch, lambda: k4.int4_matmul(x, packed, scale))
        if row["device_kernels_per_call"] != 1:
          raise SystemExit(f"chip_smoke: int4_matmul {name} T={T}: {row['device_kernels_per_call']} device kernels per call, expected 1")
      rows.append(row)
      kern = f" | {row['device_kernels_per_call']} device kernel per call" if T <= 8 else ""
      log(f"[kernels] int4_matmul {model} {name} in={d_in} out={d_out} T={T} x {row['x_dtype']} ({row['tile_t']}-token tiles, {row['mma']}, cluster of {split}): max|err| {err:.3e} ({used:.3f} of the bound atol {atol} + rtol {rtol:.3g}·|ref|; beyond the relative part {slack:.2e}) | kernel {row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | {'f32' if f32 else 'bf16'} matmul {row['library_ms']:.4f} ms | bound {row['bound_ms']:.5f} ms ({row['bound_by']}, {nbytes / 1e6:.2f} MB){kern}")
    del packed, scale, w_bf16
  return rows


def _kernels_per_call(torch, fn):
  """Device kernels one call of ``fn`` launches: the kernel nodes of a CUDA
  graph captured around a warm call (utils/programs.py ``kernels_in``, which
  reads them with cuGraphGetNodes / cuGraphNodeGetType). Every kernel the
  call enqueues is a node, however late in the process it runs."""
  from xotorch_support_jetson_tpu_torch.utils.programs import kernels_in

  return kernels_in(fn)


def int4_matmul_bound(rows, calls=CALLS_PER_STEP, tokens=(1, 8), model="llama-3.2-1b"):
  """K4 per decode step: the weight products of one step (by default
  llama-3.2-1b's 113: 16 layers and the tied head), summed from the
  measured rows at T = 1 (solo) and T = 8 (batched, 8 slots)."""
  res = {}
  for T in tokens:
    at = {r["weight"]: r for r in rows if r["T"] == T and r["x_dtype"] == "bfloat16"}
    step = {key: sum(n * at[w][key] for w, n in calls.items()) for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    step.update(calls=sum(calls.values()), packed_bytes=sum(n * (at[w]["d_in"] // 2 * at[w]["d_out"] + at[w]["d_out"] * 4) for w, n in calls.items()))
    res[f"T{T}"] = step
    log(f"[kernels] int4_matmul {model} per decode step at T={T} ({step['calls']} calls, {step['packed_bytes'] / 1e6:.2f} MB packed weights + scales): kernel {step['ms']:.4f} ms | plain {step['plain_ms']:.4f} ms | bf16 matmul {step['library_ms']:.4f} ms | bound {step['bound_ms']:.5f} ms")
  return res


K3_LENGTHS = ([1], [64], [65], [4096], [1, 64, 65, 777, 1500, 2048, 3333, 4096])


def paged_kernel_rows(torch, gen, Hq, Hkv, hd, length_sets=K3_LENGTHS, kvs=tuple(KV_MODES)):
  """K3 against its plain version at the batched path's pool geometry
  (page size 64, 64 pages per row = the 4096 cache), per pool type in
  ``kvs``, for each row batch of ``length_sets``. Each
  row's pages are shuffled, non-contiguous ids; table entries past a row's
  last page hold junk the kernel must never read."""
  import torch.nn.functional as F

  from xotorch_support_jetson_tpu_torch.models.quantize import quantize_kv, quantize_kv_int4
  from xotorch_support_jetson_tpu_torch.ops import paged

  mp = CACHE // PAGE
  rows = []
  for lengths in length_sets:
    B = len(lengths)
    P = B * mp + 1
    q = _rand(torch, (B, Hq, hd), gen, torch.bfloat16)
    k_f = _rand(torch, (P, Hkv, PAGE, hd), gen, torch.bfloat16)
    v_f = _rand(torch, (P, Hkv, PAGE, hd), gen, torch.bfloat16)
    ids = torch.randperm(P - 1, generator=gen, device="cuda").to(torch.int32).add_(1).reshape(B, mp)
    valid = torch.arange(mp, device="cuda")[None, :] < torch.tensor([-(-n // PAGE) for n in lengths], device="cuda")[:, None]
    bt = torch.where(valid, ids, torch.full_like(ids, 1 << 30))  # junk past each row's pages
    bt_clean = torch.where(valid, ids, torch.zeros_like(ids))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    for kv in kvs:
      k, v, scales = k_f, v_f, {}
      if kv != "bf16":
        quant = quantize_kv_int4 if kv == "int4" else quantize_kv
        (k, ks), (v, vs) = quant(k_f), quant(v_f)
        scales = dict(k_scale_pool_l=ks, v_scale_pool_l=vs)
      got = paged.paged_decode_attention(q, k, v, bt, lens, PAGE, **scales)
      want = paged.paged_decode_attention_ref(q, k, v, bt_clean, lens, PAGE, **scales)
      torch.cuda.synchronize()
      diff = (got.float() - want.float()).abs()
      err = diff.max().item()
      # Share of the allowed error used by the worst element (<= 1 passes).
      used = (diff / (K3_ATOL + K3_RTOL * want.float().abs())).max().item()
      if not torch.isfinite(got).all() or not used <= 1.0:
        raise SystemExit(f"chip_smoke: paged_decode disagrees with its plain version (lengths={lengths} kv={kv}): max|err| {err}, {used:.2f}x the bound atol {K3_ATOL} + rtol {K3_RTOL}·|ref|")
      live = sum(lengths)
      elem = {"bf16": 2.0, "int8": 1.0, "int4": 0.5}[kv]
      kv_bytes = 2 * live * Hkv * (hd * elem + (4 if kv != "bf16" else 0))  # K and V codes (+ scales) of the live slots
      nbytes = kv_bytes + 2 * B * Hq * hd * 2 + sum(-(-n // PAGE) for n in lengths) * 4 + B * 4
      flops = 4 * hd * Hq * live
      bound_flops, bound_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
      # Yardstick (the port never calls it): SDPA over the window gathered
      # and dequantized to bf16 beforehand, with a position mask; the gather
      # is outside the timing.
      kd = paged.gather_pages(k, bt_clean)
      vd = paged.gather_pages(v, bt_clean)
      if kv != "bf16":
        from xotorch_support_jetson_tpu_torch.models.quantize import unpack_int4_kv

        if kv == "int4":
          kd, vd = unpack_int4_kv(kd), unpack_int4_kv(vd)
        kd = (kd.float() * paged.gather_pages(scales["k_scale_pool_l"], bt_clean)).to(torch.bfloat16)
        vd = (vd.float() * paged.gather_pages(scales["v_scale_pool_l"], bt_clean)).to(torch.bfloat16)
      qt, kt, vt = q[:, :, None, :], kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
      mask = (torch.arange(mp * PAGE, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
      row = dict(
        B=B, lengths=lengths, kv=kv, heads=[Hq, Hkv], hd=hd, max_abs_err=err, tol=dict(atol=K3_ATOL, rtol=K3_RTOL), tol_used=used,
        ms=_cuda_ms(torch, lambda: paged.paged_decode_attention(q, k, v, bt, lens, PAGE, **scales)),
        plain_ms=_cuda_ms(torch, lambda: paged.paged_decode_attention_ref(q, k, v, bt_clean, lens, PAGE, **scales), iters=10),
        library_ms=_cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        library="sdpa over the pre-gathered bf16 window, position mask (gather and dequant not timed)",
        bound_ms=max(bound_flops, bound_bytes), bound_by="operations" if bound_flops >= bound_bytes else "bytes",
      )
      row["device_kernels_per_call"] = _kernels_per_call(torch, lambda: paged.paged_decode_attention(q, k, v, bt, lens, PAGE, **scales))
      if row["device_kernels_per_call"] != 1:
        raise SystemExit(f"chip_smoke: paged_decode lengths={lengths} kv={kv}: {row['device_kernels_per_call']} device kernels per call, expected 1")
      rows.append(row)
      log(f"[kernels] paged_decode B={B} lengths={lengths if B == 1 else 'mixed 1..4096'} kv={kv} heads={Hq}/{Hkv} hd={hd} page={PAGE} mp={mp}: max|err| {err:.3e} ({used:.3f} of the bound atol {K3_ATOL} + rtol 2^-7·|ref|) | kernel {row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | sdpa (pre-gathered window) {row['library_ms']:.4f} ms | bound {row['bound_ms']:.5f} ms ({row['bound_by']}, {nbytes / 1e6:.2f} MB) | {row['device_kernels_per_call']} device kernel per call")
  return rows


VERIFY_W = 9  # the batched speculation's verify window: XOT_TPU_SPEC_NGRAM_MAX (8) + 1
DRAFT_VERIFY_W = 5  # a model-drafted verify window: gamma (4) + 1


def paged_window_rows(torch, gen, Hq, Hkv, hd, W=VERIFY_W, wide=True):
  """K3 on the verify window of batched speculation, flattened as the spec
  chunk calls it (``ops/paged.py paged_window_attention``): B=8 rows × W
  window positions (9: n-gram rows; 5: model-drafted rows) = B·W
  single-query rows in ONE launch, each with its own length (position + 1)
  over its row's table, per pool type. Rows start at 150..600 (the batched
  traffic) and, with ``wide``, at 1..4096-W (window ends up to the 4096
  cache). Held elementwise to K3's bound against the gather route
  (``paged_window_attention_ref``). Beside the time: the bound (each row's
  live KV read once, though the flattened call reads it W times, mostly
  from L2), SDPA over the gathered windows with the same per-query masks,
  and W = 1 (one K3 call over the same rows at their window ends) for the
  ratio to W single-query launches."""
  import torch.nn.functional as F

  from xotorch_support_jetson_tpu_torch.models.quantize import quantize_kv, quantize_kv_int4, unpack_int4_kv
  from xotorch_support_jetson_tpu_torch.ops import paged

  mp = CACHE // PAGE
  rows = []
  start_sets = [[int(x) for x in np.linspace(150, 600, BATCH_SLOTS)]] + ([[1, 64, 65, 777, 1500, 2048, 3333, CACHE - W]] if wide else [])
  for starts in start_sets:
    B = len(starts)
    ends = [n + W for n in starts]
    P = B * mp + 1
    q = _rand(torch, (B, W, Hq, hd), gen, torch.bfloat16)
    k_f = _rand(torch, (P, Hkv, PAGE, hd), gen, torch.bfloat16)
    v_f = _rand(torch, (P, Hkv, PAGE, hd), gen, torch.bfloat16)
    ids = torch.randperm(P - 1, generator=gen, device="cuda").to(torch.int32).add_(1).reshape(B, mp)
    valid = torch.arange(mp, device="cuda")[None, :] < torch.tensor([-(-n // PAGE) for n in ends], device="cuda")[:, None]
    bt = torch.where(valid, ids, torch.full_like(ids, 1 << 30))  # junk past each row's pages
    bt_clean = torch.where(valid, ids, torch.zeros_like(ids))
    positions = torch.tensor(starts, dtype=torch.int32, device="cuda")[:, None] + torch.arange(W, dtype=torch.int32, device="cuda")[None, :]
    btw = paged.window_block_tables(bt, W)
    q_flat, lens_flat = q.reshape(B * W, Hq, hd), (positions + 1).reshape(-1).contiguous()
    ends_t = torch.tensor(ends, dtype=torch.int32, device="cuda")
    for kv in KV_MODES:
      k, v, scales = k_f, v_f, {}
      if kv != "bf16":
        quant = quantize_kv_int4 if kv == "int4" else quantize_kv
        (k, ks), (v, vs) = quant(k_f), quant(v_f)
        scales = dict(k_scale_pool_l=ks, v_scale_pool_l=vs)
      before = paged.LAUNCHES["paged_decode"]
      got = paged.paged_window_attention(q, k, v, btw, positions, PAGE, **scales)
      torch.cuda.synchronize()
      launches = paged.LAUNCHES["paged_decode"] - before
      want = paged.paged_window_attention_ref(q, k, v, bt_clean, positions, PAGE, **scales)
      diff = (got.float() - want.float()).abs()
      err = diff.max().item()
      used = (diff / (K3_ATOL + K3_RTOL * want.float().abs())).max().item()
      if launches != 1 or not torch.isfinite(got).all() or not used <= 1.0:
        raise SystemExit(f"chip_smoke: the verify window through K3 (starts={starts} kv={kv}): {launches} launches, max|err| {err}, {used:.2f}x the bound atol {K3_ATOL} + rtol {K3_RTOL}·|ref|")
      elem = {"bf16": 2.0, "int8": 1.0, "int4": 0.5}[kv]
      kv_bytes = 2 * sum(ends) * Hkv * (hd * elem + (4 if kv != "bf16" else 0))  # each row's live K and V once
      nbytes = kv_bytes + 2 * B * W * Hq * hd * 2 + sum(-(-n // PAGE) for n in ends) * 4 + B * W * 4
      flops = 4 * hd * Hq * int((positions + 1).sum())  # every query over its own length
      bound_flops, bound_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
      # Yardstick (the port never calls it): SDPA over each row's window
      # gathered and dequantized to bf16 beforehand, the W queries masked
      # each at its own position; the gather is outside the timing.
      kd, vd = paged.gather_pages(k, bt_clean), paged.gather_pages(v, bt_clean)
      if kv != "bf16":
        if kv == "int4":
          kd, vd = unpack_int4_kv(kd), unpack_int4_kv(vd)
        kd = (kd.float() * paged.gather_pages(scales["k_scale_pool_l"], bt_clean)).to(torch.bfloat16)
        vd = (vd.float() * paged.gather_pages(scales["v_scale_pool_l"], bt_clean)).to(torch.bfloat16)
      qt, kt, vt = q.transpose(1, 2).contiguous(), kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
      mask = (torch.arange(mp * PAGE, device="cuda")[None, None, :] <= positions[:, :, None])[:, None]
      row = dict(
        B=B, W=W, starts=starts, kv=kv, max_abs_err=err, tol=dict(atol=K3_ATOL, rtol=K3_RTOL), tol_used=used, launches_per_call=launches,
        ms=_cuda_ms(torch, lambda: paged.paged_decode_attention(q_flat, k, v, btw, lens_flat, PAGE, **scales)),
        w1_ms=_cuda_ms(torch, lambda: paged.paged_decode_attention(q[:, -1].contiguous(), k, v, bt, ends_t, PAGE, **scales)),
        plain_ms=_cuda_ms(torch, lambda: paged.paged_window_attention_ref(q, k, v, bt_clean, positions, PAGE, **scales), iters=10),
        library_ms=_cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        library="sdpa over the pre-gathered bf16 windows, per-query position masks (gather and dequant not timed)",
        bound_ms=max(bound_flops, bound_bytes), bound_by="operations" if bound_flops >= bound_bytes else "bytes",
      )
      row["device_kernels_per_call"] = _kernels_per_call(torch, lambda: paged.paged_decode_attention(q_flat, k, v, btw, lens_flat, PAGE, **scales))
      if row["device_kernels_per_call"] != 1:
        raise SystemExit(f"chip_smoke: the flattened verify call (kv={kv}): {row['device_kernels_per_call']} device kernels per call, expected 1")
      rows.append(row)
      log(f"[kernels] paged_decode verify window B={B} W={W} starts={'150..600' if starts[0] == 150 else '1..' + str(starts[-1])} kv={kv}: one launch over {B * W} rows | max|err| {err:.3e} ({used:.3f} of the bound) | kernel {row['ms']:.4f} ms (W=1 over the same rows {row['w1_ms']:.4f} ms, ratio {row['ms'] / row['w1_ms']:.2f} against W={W}) | plain {row['plain_ms']:.4f} ms | sdpa (gathered windows, per-query masks) {row['library_ms']:.4f} ms | bound {row['bound_ms']:.5f} ms ({row['bound_by']}, live KV once, {nbytes / 1e6:.2f} MB)")
  return rows


# ---------------------------------------------------------------- 4. serving


class ByteTokenizer:
  """Script glue: a byte-level tokenizer for the random-weight model (ids
  0-255 are bytes; other ids render as ``[id]`` so transcripts keep them)."""

  bos_token_id = 128000
  eos_token_id = 128009

  def encode(self, text: str) -> list[int]:
    return [self.bos_token_id] + list(text.encode("utf-8"))

  def decode(self, ids) -> str:
    return "".join(chr(t) if t < 256 else f"[{t}]" for t in ids)

  def apply_chat_template(self, conversation, tokenize=False, add_generation_prompt=True) -> str:
    text = "".join(f"<|{m['role']}|>{m['content']}\n" for m in conversation)
    return text + ("<|assistant|>" if add_generation_prompt else "")


def write_checkpoint(torch, path: Path, layers: int | None = None, seed: int = SEED, echo: bool = False) -> float:
  """Seeded random bf16 weights at llama-3.2-1b's shapes, HF names, one
  .safetensors file (tied embeddings: no lm_head); ``layers`` cuts the
  depth (the cross-model draft: the same seed gives it the target's
  embedding and first layers); ``echo`` writes the port's
  ``peaked_echo_params`` of those weights (the acceptance ceiling)."""
  from xotorch_support_jetson_tpu_torch.models.loader import save_safetensors

  t0 = time.perf_counter()
  c = dict(LLAMA_3_2_1B, num_hidden_layers=layers or LLAMA_3_2_1B["num_hidden_layers"])
  D, F_, V, L = c["hidden_size"], c["intermediate_size"], c["vocab_size"], c["num_hidden_layers"]
  qd, kd = c["num_attention_heads"] * c["head_dim"], c["num_key_value_heads"] * c["head_dim"]
  gen = torch.Generator(device="cuda").manual_seed(seed)

  def w(out_f, in_f, scale=None):
    return (torch.randn((out_f, in_f), generator=gen, device="cuda") * (scale or in_f**-0.5)).to(torch.bfloat16).cpu()

  ones = torch.ones(D, dtype=torch.bfloat16)
  tensors = {"model.embed_tokens.weight": w(V, D, scale=0.02), "model.norm.weight": ones}
  for i in range(L):
    p = f"model.layers.{i}."
    tensors.update({
      p + "input_layernorm.weight": ones, p + "post_attention_layernorm.weight": ones,
      p + "self_attn.q_proj.weight": w(qd, D), p + "self_attn.k_proj.weight": w(kd, D),
      p + "self_attn.v_proj.weight": w(kd, D), p + "self_attn.o_proj.weight": w(D, qd),
      p + "mlp.gate_proj.weight": w(F_, D), p + "mlp.up_proj.weight": w(F_, D), p + "mlp.down_proj.weight": w(D, F_),
    })
  if echo:
    from xotorch_support_jetson_tpu_torch.utils.synthetic import peaked_echo_params

    # The port's leaf names over the HF tensors (a scale ignores orientation).
    names = {"wo": "self_attn.o_proj.weight", "w_down": "mlp.down_proj.weight"}
    stacks = {k: torch.stack([tensors[f"model.layers.{i}.{n}"] for i in range(L)]) for k, n in names.items()}
    damped = peaked_echo_params({"layers": stacks})["layers"]
    for k, n in names.items():
      for i in range(L):
        tensors[f"model.layers.{i}.{n}"] = damped[k][i].clone()
  path.mkdir(parents=True, exist_ok=True)
  (path / "config.json").write_text(json.dumps(c, indent=1))
  save_safetensors(path / "model.safetensors", tensors)
  return time.perf_counter() - t0


def _post(port: int, body: dict, headers: dict | None = None):
  """One chat completion (with extra ``headers``); returns (text,
  finish_reason, ttft_s, total_s, n_events, request_id)."""
  req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions", data=json.dumps(body).encode(), headers={"Content-Type": "application/json", **(headers or {})})
  t0 = time.perf_counter()
  try:
    opened = urllib.request.urlopen(req, timeout=600)
  except urllib.error.HTTPError as e:  # carry the server's error body to whoever reads this request's result
    raise RuntimeError(f"HTTP {e.code} from /v1/chat/completions: {e.read()[:600]!r}") from None
  with opened as resp:
    if resp.status != 200:
      raise SystemExit(f"chip_smoke: HTTP {resp.status}")
    if not body.get("stream"):
      data = json.loads(resp.read())
      dt = time.perf_counter() - t0
      return data["choices"][0]["message"]["content"], data["choices"][0]["finish_reason"], None, dt, 1, data["id"].removeprefix("chatcmpl-")
    text, finish, ttft, n, rid = "", None, None, 0, None
    for raw in resp:
      line = raw.decode().strip()
      if not line.startswith("data: ") or line == "data: [DONE]":
        continue
      ev = json.loads(line[6:])
      if "error" in ev:
        raise SystemExit(f"chip_smoke: streaming error {ev['error']}")
      ttft = ttft if ttft is not None else time.perf_counter() - t0
      rid = rid or ev["id"].removeprefix("chatcmpl-")
      choice = ev["choices"][0]
      if choice["delta"].get("content"):
        text += choice["delta"]["content"]
        n += 1
      finish = choice["finish_reason"] or finish
    return text, finish, ttft, time.perf_counter() - t0, n, rid


async def _serve_requests(torch, node, engine, port, plan):
  """Send ``plan`` [(label, body) or (label, body, headers)] one after
  another; collect token ids via the node's token callbacks (requests are
  sequential)."""
  ids: dict[str, list[int]] = {}
  node.on_token.register("chip_smoke").on_next(lambda rid, toks, fin: ids.setdefault(rid, []).extend(toks))
  out = []
  for label, body, *headers in plan:
    before = set(ids)
    text, finish, ttft, total, n_events, _ = await asyncio.to_thread(_post, port, body, *headers)
    new = [rid for rid in ids if rid not in before]
    if len(new) != 1:
      raise SystemExit(f"chip_smoke: expected one request's tokens for {label}, saw {len(new)}")
    toks = ids[new[0]]
    if not toks or len(toks) > body["max_tokens"] or engine.sessions:
      raise SystemExit(f"chip_smoke: {label}: {len(toks)} tokens, {len(engine.sessions)} open sessions")
    out.append(dict(label=label, stream=body["stream"], temperature=body["temperature"], tokens=toks, text=text, finish_reason=finish, ttft_s=ttft, total_s=total))
  node.on_token.deregister("chip_smoke")
  return out


def _decode_rate(r) -> float:
  """Streaming decode rate: tokens after the first over the time after the first event."""
  return (len(r["tokens"]) - 1) / max(r["total_s"] - r["ttft_s"], 1e-9)


def _rel_err(a, b) -> float:
  return ((a.float() - b.float()).norm() / b.float().norm()).item()


CHECK_PROMPT = "<|user|>The quick brown fox jumps over the lazy dog.\n<|assistant|>"


def _forward_pair(torch, engine):
  """The served weights' prefill logits on ``CHECK_PROMPT`` (full width)
  and one decode step's logits after it, on a fresh cache, through the
  paths the current environment selects."""
  from xotorch_support_jetson_tpu_torch.models.decoder import init_kv_cache, shard_forward

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  toks = torch.tensor([ByteTokenizer().encode(CHECK_PROMPT)], dtype=torch.int32, device="cuda")
  S = toks.shape[1]
  cache = init_kv_cache(cfg, cfg.n_layers, 1, CACHE, device="cuda")
  pre, cache = shard_forward(params, cfg, shard, toks, torch.arange(S, dtype=torch.int32, device="cuda")[None], cache)
  step, _ = shard_forward(params, cfg, shard, toks[:, -1:], torch.tensor([[S]], dtype=torch.int32, device="cuda"), cache)
  if tuple(pre.shape) != (1, S, cfg.vocab_size) or not (torch.isfinite(pre).all() and torch.isfinite(step).all()):
    raise SystemExit(f"chip_smoke: bad logits shape {tuple(pre.shape)} or non-finite values")
  return pre, step


def _pair_err(a, b):
  """Relative L2 of prefill and decode-step logits pairs, and greedy agreement."""
  return dict(prefill_rel_err=_rel_err(a[0], b[0]), decode_rel_err=_rel_err(a[1], b[1]), prefill_argmax_agree=float((a[0].argmax(-1) == b[0].argmax(-1)).float().mean()))


def check_against_plain(torch, engine):
  """The served weights through the kernel path vs the plain attention path
  (XOT_TPU_NO_FLASH): prefill logits and one K2 decode step, full width."""
  out = {}
  for mode in ("kernel", "plain"):
    # kernel: K1 for the prefill and K2 for the decode step; plain: neither.
    os.environ.update({"XOT_TPU_NO_FLASH": "1"} if mode == "plain" else {"XOT_TPU_FLASH_DECODE": "1", "XOT_TPU_FLASH_DECODE_MIN": str(CACHE)})
    out[mode] = _forward_pair(torch, engine)
    for knob in ("XOT_TPU_NO_FLASH", "XOT_TPU_FLASH_DECODE", "XOT_TPU_FLASH_DECODE_MIN"):
      os.environ.pop(knob, None)
  res = _pair_err(out["kernel"], out["plain"])
  # bf16 through 16 layers: the two paths round differently (bf16
  # probabilities in K1's P·V product, other accumulation orders), and the
  # difference compounds layer by layer; 5e-2 relative bounds that drift
  # while a wrong mask or head mapping gives O(1).
  if not (res["prefill_rel_err"] < 5e-2 and res["decode_rel_err"] < 5e-2):
    raise SystemExit(f"chip_smoke: kernel path disagrees with the plain path: {res}")
  return res


def _profile(torch, label, fn, reps):
  """Where ``fn``'s time goes: host wall time per call with the profiler
  off, over ``reps`` calls, and ``torch.profiler``'s device time of one
  more call (device-side kernel and copy events only: the aten op rows
  repeat their kernels' time). The profiled call is one: the profiler's
  cost grows with the events it keeps, and a call's device work repeats
  from call to call."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  fn()  # warm
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(reps):
    fn()
  torch.cuda.synchronize()
  wall_ms = (time.perf_counter() - t0) * 1e3 / reps
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  events = prof.key_averages()
  device = sorted((e for e in events if e.device_type == DeviceType.CUDA), key=lambda e: e.self_device_time_total, reverse=True)
  host = sorted((e for e in events if e.device_type == DeviceType.CPU), key=lambda e: e.self_cpu_time_total, reverse=True)
  device_ms = sum(e.self_device_time_total for e in device) / 1e3
  k1_ms = sum(e.self_device_time_total for e in device if "flash_prefill_kernel" in e.key) / 1e3
  res = dict(
    k1_device_ms=k1_ms, k1_device_share=k1_ms / device_ms if device_ms else None,
    label=label, reps=reps, wall_ms=wall_ms, device_ms=device_ms, device_busy_share=device_ms / wall_ms,
    launches=sum(e.count for e in host if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")),
    top_host_ops=[(e.key, round(e.count, 1), round(e.self_cpu_time_total / 1e3, 4)) for e in host[:10]],
    top_device_ops=[(e.key[:70], round(e.count, 1), round(e.self_device_time_total / 1e3, 4)) for e in device[:10]],
  )
  busy = "not measured (the profiler saw no device events)" if not device else f"{res['device_busy_share']:.3f}"
  log(f"[profile] {label}: wall {wall_ms:.3f} ms (profiler off), device {device_ms:.3f} ms, device busy {busy}, {res['launches']:.0f} launches")
  log(f"[profile] {label}: host ms by op (calls, ms; profiler on): {res['top_host_ops']}")
  log(f"[profile] {label}: device ms by kernel (calls, ms): {res['top_device_ops']}")
  return res


def profile_serving(torch, engine, steps=8):
  """The served model's prefill (the engine's 128-bucket path, logits to
  the host: a replay of its captured graph) and its decode steps through
  the uncaptured ``fused_decode``, default and with K2."""
  from xotorch_support_jetson_tpu_torch.models.decoder import fused_decode, init_kv_cache

  cfg, shard = engine.cfg, engine._effective_shard
  prompt = np.asarray([ByteTokenizer().encode("<|user|>Write a short poem about a fox who learns to fly.\n<|assistant|>")], dtype=np.int32)

  def prefill():
    engine._infer_tensor_sync("profile", prompt, None)
    engine.end_request("profile")

  cache = init_kv_cache(cfg, cfg.n_layers, 1, CACHE, device="cuda")
  tok = torch.full((1, 1), 65, dtype=torch.int32, device="cuda")
  start = torch.tensor([100], dtype=torch.int32, device="cuda")

  def decode():
    fused_decode(engine.params, cfg, shard, tok, cache, start, steps)

  out = {"prefill": _profile(torch, "prefill (128-token bucket, captured)", prefill, 5)}
  out["decode"] = _profile(torch, f"decode, {steps} steps (eager)", decode, 3)
  os.environ.update(XOT_TPU_FLASH_DECODE="1", XOT_TPU_FLASH_DECODE_MIN=str(CACHE))
  try:
    out["decode_flash"] = _profile(torch, f"decode with K2, {steps} steps (eager)", decode, 3)
  finally:
    os.environ.pop("XOT_TPU_FLASH_DECODE"), os.environ.pop("XOT_TPU_FLASH_DECODE_MIN")
  return out


SERVING_KNOBS = (
  "XOT_TPU_FLASH_DECODE", "XOT_TPU_FLASH_DECODE_MIN", "XOT_TPU_NO_FLASH", "XOT_TPU_KV_QUANT", "XOT_TPU_PLATFORM", "XOT_TPU_BATCHED", "XOT_TPU_PAGED_KERNEL",
  "XOT_TPU_QUANT", "XOT_TPU_QUANT_COMPUTE", "XOT_TPU_INT4_KERNEL", "XOT_TPU_MOE_GATHER", *SPEC_KNOBS,
)
CHAT = [{"role": "user", "content": "Write a short poem about a fox who learns to fly."}]


def _chat_body(stream, temp):
  return {"model": "llama-3.2-1b", "messages": CHAT, "stream": stream, "temperature": temp, "max_tokens": MAX_TOKENS}


def _daemon_args(tmain, ckpt: Path, max_tokens: int = MAX_TOKENS, model: str = "llama-3.2-1b"):
  from xotorch_support_jetson_tpu_torch.utils.helpers import find_available_port

  os.environ["XOT_TPU_MODEL_DIR"] = str(ckpt)
  os.environ["HF_HUB_OFFLINE"] = "1"  # a daemon of the script fetches only in the fetch phase, from its loopback hub
  for knob in SERVING_KNOBS:
    os.environ.pop(knob, None)
  port = find_available_port("127.0.0.1")
  args = tmain.build_parser().parse_args(["--discovery-module", "none", "--chatgpt-api-port", str(port), "--default-model", model, "--max-generate-tokens", str(max_tokens), "--node-id", "chip-smoke"])
  return args, port


def phase_serving(torch, ckpt: Path):
  from xotorch_support_jetson_tpu_torch import main as tmain
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard
  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa

  args, port = _daemon_args(tmain, ckpt)
  return asyncio.run(_serve(torch, tmain, Shard, fa, args, port))


async def _serve(torch, tmain, Shard, fa, args, port):
  node, api, engine, _ = tmain.build_components(args, tokenizer=ByteTokenizer())
  if engine.device.type != "cuda":
    raise SystemExit("chip_smoke: the engine did not choose the card")
  server = await api.run(host="127.0.0.1", port=port)
  try:
    t0 = time.perf_counter()
    await engine.ensure_shard(Shard("llama-3.2-1b", 0, 15, 16))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"[serving] daemon up on 127.0.0.1:{port}; weights loaded to the card in {load_s:.1f} s")
    body = _chat_body
    await _serve_requests(torch, node, engine, port, [("warmup", body(False, 0))])  # first CUDA/cuBLAS work off the clock
    _reset_launches()  # ---- the main path, counted
    run_a = await _serve_requests(torch, node, engine, port, [
      ("greedy blocking", body(False, 0)), ("greedy streaming", body(True, 0)),
      ("sampled blocking", body(False, 0.8)), ("sampled streaming", body(True, 0.8)),
    ])
    launches_a = {n: _launched(n) for n in ("flash_prefill", "flash_decode")}
    os.environ["XOT_TPU_FLASH_DECODE"], os.environ["XOT_TPU_FLASH_DECODE_MIN"] = "1", str(CACHE)
    run_b = await _serve_requests(torch, node, engine, port, [("flash-decode greedy blocking", body(False, 0)), ("flash-decode greedy streaming", body(True, 0))])
    launches = {n: _launched(n) for n in ("flash_prefill", "flash_decode")}  # ---- read just after the main path
    os.environ.pop("XOT_TPU_FLASH_DECODE"), os.environ.pop("XOT_TPU_FLASH_DECODE_MIN")
    for r in run_a + run_b:
      log(f"[serving] {r['label']}: {len(r['tokens'])} tokens, finish {r['finish_reason']}, ttft {r['ttft_s'] if r['ttft_s'] is None else round(r['ttft_s'], 4)} s, total {r['total_s']:.4f} s")
    for a, b, what in ((run_a[0], run_a[1], "default"), (run_b[0], run_b[1], "flash-decode")):
      if a["tokens"] != b["tokens"] or a["text"] != b["text"]:
        raise SystemExit(f"chip_smoke: {what} greedy blocking and streaming differ:\n{a['tokens']}\n{b['tokens']}")
    if launches["flash_prefill"] == 0 or launches["flash_decode"] == 0:
      raise SystemExit(f"chip_smoke: a kernel of the main path never launched: {launches}")
    n_layers = engine.cfg.n_layers
    if launches_a["flash_decode"] != 0 or launches["flash_prefill"] != n_layers * (len(run_a) + len(run_b)):
      raise SystemExit(f"chip_smoke: unexpected launch counts {launches_a} then {launches} for {len(run_a) + len(run_b)} prefills of {n_layers} layers")
    common = next((i for i, (x, y) in enumerate(zip(run_a[0]["tokens"], run_b[0]["tokens"])) if x != y), min(len(run_a[0]["tokens"]), len(run_b[0]["tokens"])))
    stream_a, stream_b = run_a[1], run_b[1]
    summary = dict(
      load_s=load_s, launches=launches, launches_default_run=launches_a, n_layers=n_layers,
      greedy_tokens_default=run_a[0]["tokens"], greedy_tokens_flash_decode=run_b[0]["tokens"], greedy_common_prefix=common,
      ttft_s=stream_a["ttft_s"], decode_tok_s=_decode_rate(stream_a),
      ttft_s_flash_decode=stream_b["ttft_s"], decode_tok_s_flash_decode=_decode_rate(stream_b),
      blocking_s=run_a[0]["total_s"], blocking_tokens=len(run_a[0]["tokens"]),
      requests=[{k: v for k, v in r.items() if k != "text"} for r in run_a + run_b],
    )
    log(f"[serving] launches on the main path {launches} ({n_layers} layers: K1 once per layer per prefill, K2 once per layer per decode step with XOT_TPU_FLASH_DECODE=1)")
    log(f"[serving] greedy blocking == streaming in both runs; default vs flash-decode greedy agree on the first {common} tokens")
    log(f"[serving] streaming TTFT {summary['ttft_s']:.4f} s, decode {summary['decode_tok_s']:.1f} tok/s; with flash decode: TTFT {summary['ttft_s_flash_decode']:.4f} s, decode {summary['decode_tok_s_flash_decode']:.1f} tok/s")
    summary["check"] = check_against_plain(torch, engine)
    log(f"[serving] kernel path vs plain path on the served weights: {summary['check']}")
    summary["profile"] = profile_serving(torch, engine)
    summary["long"] = await _serve_long_prompt(torch, node, engine, port, fa)
    summary["_bf16_logits"] = _forward_pair(torch, engine)  # what the quantized passes report against
    return summary
  finally:
    server.close()
    await server.wait_closed()
    engine.executor.shutdown(wait=True)


LONG_PROMPT_TOKENS = 3000  # BOS + chat template + text: the 3072 prefill bucket, 64 answer tokens within the 4096 cache


def long_prompt_body(stream):
  """A greedy chat request whose prompt is ``LONG_PROMPT_TOKENS`` tokens
  under the byte-level tokenizer (one token per byte, BOS, the template's
  role tags)."""
  overhead = len(ByteTokenizer().encode(ByteTokenizer().apply_chat_template([{"role": "user", "content": ""}])))
  words = "the quick brown fox jumps over a lazy dog while seven tired owls count the stars above an old mill".split()
  text = " ".join(words[i % len(words)] for i in range(LONG_PROMPT_TOKENS))[: LONG_PROMPT_TOKENS - overhead]
  return {"model": "llama-3.2-1b", "messages": [{"role": "user", "content": text}], "stream": stream, "temperature": 0, "max_tokens": MAX_TOKENS}


async def _serve_long_prompt(torch, node, engine, port, fa):
  """The solo daemon on one ~3,000-token prompt (prefill bucket 3072),
  blocking and streaming, greedy: the ids must be equal, K1 must run once
  per layer per prefill, and ``torch.profiler`` splits the served prefill
  into host and device time with K1's share of the device time."""
  prompt = ByteTokenizer().encode(ByteTokenizer().apply_chat_template(long_prompt_body(False)["messages"]))
  if len(prompt) != LONG_PROMPT_TOKENS:
    raise SystemExit(f"chip_smoke: the long prompt is {len(prompt)} tokens, expected {LONG_PROMPT_TOKENS}")
  _reset_launches()  # ---- the long-prompt path, counted
  blocking, streaming = await _serve_requests(torch, node, engine, port, [("long greedy blocking", long_prompt_body(False)), ("long greedy streaming", long_prompt_body(True))])
  launches = {n: _launched(n) for n in ("flash_prefill", "flash_decode")}  # ---- read just after
  if blocking["tokens"] != streaming["tokens"] or blocking["text"] != streaming["text"]:
    raise SystemExit(f"chip_smoke: long prompt: greedy blocking and streaming differ:\n{blocking['tokens']}\n{streaming['tokens']}")
  if launches["flash_prefill"] != 2 * engine.cfg.n_layers or launches["flash_decode"] != 0:
    raise SystemExit(f"chip_smoke: long prompt: unexpected launches {launches}")
  ids = np.asarray([prompt], dtype=np.int32)

  def prefill():
    engine._infer_tensor_sync("profile-long", ids, None)
    engine.end_request("profile-long")

  prof = _profile(torch, f"prefill ({LONG_PROMPT_TOKENS}-token prompt, 3072 bucket)", prefill, 3)
  res = dict(
    prompt_tokens=len(prompt), launches=launches, greedy_tokens=blocking["tokens"], ttft_s=streaming["ttft_s"], decode_tok_s=_decode_rate(streaming),
    blocking_s=blocking["total_s"], prefill_wall_ms=prof["wall_ms"], prefill_device_ms=prof["device_ms"], k1_device_ms=prof["k1_device_ms"],
    k1_device_share=prof["k1_device_share"], profile=prof,
  )
  share = "not measured (no device events)" if res["k1_device_share"] is None else f"{res['k1_device_share']:.3f}"
  log(f"[long] {len(prompt)}-token prompt: greedy blocking == streaming ({len(blocking['tokens'])} tokens); streaming TTFT {res['ttft_s']:.4f} s, decode {res['decode_tok_s']:.1f} tok/s; prefill wall {res['prefill_wall_ms']:.3f} ms, device {res['prefill_device_ms']:.3f} ms, K1 {res['k1_device_ms']:.3f} ms of it ({share}); launches {launches}")
  return res


# --------------------------------------------------- 5. quantized solo serving


def phase_quant_serving(torch, ckpt: Path, bf16_logits):
  """One daemon pass per weight mode of ``QUANT_MODES``."""
  from xotorch_support_jetson_tpu_torch import main as tmain

  out = {}
  for mode, env in QUANT_MODES.items():
    args, port = _daemon_args(tmain, ckpt)
    os.environ.update(env)
    try:
      out[mode] = asyncio.run(_serve_quant(torch, tmain, args, port, mode, env, bf16_logits))
    finally:
      for knob in env:
        os.environ.pop(knob, None)
    gc.collect()
    torch.cuda.empty_cache()
  return out


async def _serve_quant(torch, tmain, args, port, mode, env, bf16_logits):
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard
  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa, int4_matmul as k4

  node, api, engine, _ = tmain.build_components(args, tokenizer=ByteTokenizer())
  server = await api.run(host="127.0.0.1", port=port)
  try:
    t0 = time.perf_counter()
    await engine.ensure_shard(Shard("llama-3.2-1b", 0, 15, 16))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    compute = env.get("XOT_TPU_QUANT_COMPUTE", "w8a16")
    if engine.quant != env["XOT_TPU_QUANT"] or engine.cfg.quant_compute != compute or engine.params["layers"]["wq"].dtype != torch.int8 or "lm_head_scale" not in engine.params:
      raise SystemExit(f"chip_smoke: {mode}: the engine did not load quantized weights ({engine.quant}, {engine.cfg.quant_compute})")
    weight_bytes = sum(t.numel() * t.element_size() for t in [*engine.params["layers"].values(), *(v for k, v in engine.params.items() if k != "layers")])
    log(f"[quant] {mode}: daemon up; weights loaded and quantized on the card in {load_s:.1f} s ({weight_bytes / 1e9:.2f} GB of parameters, the bf16 embedding table included)")
    await _serve_requests(torch, node, engine, port, [("warmup", _chat_body(False, 0))])
    _reset_launches()  # ---- this pass's main path, counted
    run = await _serve_requests(torch, node, engine, port, [("greedy blocking", _chat_body(False, 0)), ("greedy streaming", _chat_body(True, 0))])
    launches = {"flash_prefill": _launched("flash_prefill"), "flash_decode": _launched("flash_decode"), "int4_matmul": _launched("int4_matmul")}  # ---- read just after
    two_dot = k4.CALLS["int4_two_dot"]
    blocking, streaming = run
    if blocking["tokens"] != streaming["tokens"] or blocking["text"] != streaming["text"]:
      raise SystemExit(f"chip_smoke: {mode}: greedy blocking and streaming differ:\n{blocking['tokens']}\n{streaming['tokens']}")
    int4 = env["XOT_TPU_QUANT"] == "int4"
    if launches["flash_prefill"] == 0 or (launches["int4_matmul"] == 0) == int4 or two_dot:
      raise SystemExit(f"chip_smoke: {mode}: unexpected launches {launches}, {two_dot} int4_two_dot calls")
    res = dict(
      mode=mode, env=env, load_s=load_s, weight_bytes=weight_bytes, launches=launches, int4_two_dot_calls=two_dot, greedy_tokens=blocking["tokens"],
      ttft_s=streaming["ttft_s"], decode_tok_s=_decode_rate(streaming), blocking_s=blocking["total_s"], blocking_tokens=len(blocking["tokens"]),
      requests=[{k: v for k, v in r.items() if k != "text"} for r in run],
    )
    log(f"[quant] {mode}: greedy blocking == streaming ({len(blocking['tokens'])} tokens); streaming TTFT {res['ttft_s']:.4f} s, decode {res['decode_tok_s']:.1f} tok/s; launches on the main path {launches}")
    logits = _forward_pair(torch, engine)
    res["vs_bf16"] = _pair_err(logits, bf16_logits)
    log(f"[quant] {mode}: logits against the bf16 model (reported, not gated): {res['vs_bf16']}")
    if int4:
      os.environ["XOT_TPU_INT4_KERNEL"] = "0"
      try:
        res["k4_vs_two_dot"] = _pair_err(logits, _forward_pair(torch, engine))
      finally:
        os.environ.pop("XOT_TPU_INT4_KERNEL")
      log(f"[quant] {mode}: logits through K4 vs XOT_TPU_INT4_KERNEL=0 on the same weights: {res['k4_vs_two_dot']}")
      # Same criterion as the kernel-vs-plain checks: bf16 over 16 layers.
      if not (res["k4_vs_two_dot"]["prefill_rel_err"] < 5e-2 and res["k4_vs_two_dot"]["decode_rel_err"] < 5e-2):
        raise SystemExit(f"chip_smoke: {mode}: K4 path disagrees with the two-dot path: {res['k4_vs_two_dot']}")
    if mode in ("int4", "int8"):
      res["profile"] = profile_decode_step(torch, engine, f"{mode} weights")
    return res
  finally:
    server.close()
    await server.wait_closed()
    engine.executor.shutdown(wait=True)


def profile_decode_step(torch, engine, what, reps=8):
  """One solo decode step (B=1, position 100) on the served weights; for
  int4 weights also the served prefill (the 128-token bucket), and both
  again with XOT_TPU_INT4_KERNEL=0."""
  from xotorch_support_jetson_tpu_torch.models.decoder import fused_decode, init_kv_cache

  cfg, shard = engine.cfg, engine._effective_shard
  cache = init_kv_cache(cfg, cfg.n_layers, 1, CACHE, device="cuda")
  tok = torch.full((1, 1), 65, dtype=torch.int32, device="cuda")
  start = torch.tensor([100], dtype=torch.int32, device="cuda")
  prompt = np.asarray([ByteTokenizer().encode("<|user|>Write a short poem about a fox who learns to fly.\n<|assistant|>")], dtype=np.int32)

  def step():
    fused_decode(engine.params, cfg, shard, tok, cache, start, 1)

  def prefill():
    engine._infer_tensor_sync("profile", prompt, None)
    engine.end_request("profile")

  out = {"decode_step": _profile(torch, f"decode step, {what}", step, reps)}
  if engine.quant == "int4":
    out["prefill"] = _profile(torch, f"prefill (128-token bucket), {what}", prefill, 5)
    os.environ["XOT_TPU_INT4_KERNEL"] = "0"
    try:
      out["decode_step_two_dot"] = _profile(torch, f"decode step, {what}, XOT_TPU_INT4_KERNEL=0", step, reps)
      out["prefill_two_dot"] = _profile(torch, f"prefill (128-token bucket), {what}, XOT_TPU_INT4_KERNEL=0", prefill, 5)
    finally:
      os.environ.pop("XOT_TPU_INT4_KERNEL")
  return out


# ------------------------------------------------ 5b. solo speculative serving

# Solo speculation passes (the solo daemon's XOT_TPU_SPEC_DECODE): the
# draft-free n-gram chain; the int8 self-draft with the load-time A/B off,
# then on; a 2-layer cross-model draft at llama-3.2-1b's widths
# (XOT_TPU_SPEC_DRAFT, its directory filled in by the phase): written from
# the target's seed, it holds the target's embedding and first two layers
# (an early-exit draft of the same model).
SPEC_PASSES = {
  # 8-token chunks (the reference's advice for a local card): the n-gram
  # index proposes at chunk boundaries only, and this stream's first
  # 32-token chunk ends on a token it has not seen before.
  "ngram": {"XOT_TPU_SPEC_DECODE": "ngram", "XOT_TPU_DECODE_CHUNK": "8"},
  "int8": {"XOT_TPU_SPEC_DECODE": "int8", "XOT_TPU_SPEC_AUTOCAL": "0"},
  "int8_autocal": {"XOT_TPU_SPEC_DECODE": "int8"},
  "cross": {"XOT_TPU_SPEC_DECODE": "int8", "XOT_TPU_SPEC_AUTOCAL": "0", "XOT_TPU_SPEC_DRAFT": ""},
}
# The acceptance ceiling: the same passes on the echo checkpoint (the port's
# peaked_echo_params of the same seeded weights, and a 2-layer draft written
# from them), after a plain pass on it that they are compared with.
ECHO_PASSES = {
  "echo_plain": {},
  "echo_ngram": SPEC_PASSES["ngram"],
  "echo_int8_autocal": SPEC_PASSES["int8_autocal"],
  "echo_cross": SPEC_PASSES["cross"],
}
DRAFT_LAYERS = 2
SPEC_FAMILIES = ("spec.chunk", "spec.generate", "spec.batch")


def phase_spec_serving(torch, ckpt: Path, draft_dir: Path, plain):
  """One solo daemon pass per ``SPEC_PASSES`` entry on the served
  checkpoint (``plain`` is phase 4's summary: its greedy ids and decode
  rate), then the ``ECHO_PASSES`` on the echo checkpoint, which this phase
  writes and removes."""
  out = {name: _spec_pass(torch, ckpt, draft_dir, name, env, plain) for name, env in SPEC_PASSES.items()}
  a, b = out["int8"], out["cross"]
  log(f"[spec] int8 self-draft vs {DRAFT_LAYERS}-layer cross draft: acceptance {a['acceptance']:.3f} / {b['acceptance']:.3f}, streaming {a['decode_tok_s']:.1f} / {b['decode_tok_s']:.1f} tok/s, blocking {a['blocking_tok_s']:.1f} / {b['blocking_tok_s']:.1f} tok/s (plain: streaming {plain['decode_tok_s']:.1f}, blocking {plain['blocking_tokens'] / plain['blocking_s']:.1f})")
  echo_dir, echo_draft = ROOT / "build" / "smoke_echo_ckpt", ROOT / "build" / "smoke_echo_draft"
  try:
    write_s = write_checkpoint(torch, echo_dir, echo=True) + write_checkpoint(torch, echo_draft, layers=DRAFT_LAYERS, echo=True)
    log(f"[spec] wrote the echo checkpoint (peaked_echo_params of the same seeded weights) and its {DRAFT_LAYERS}-layer echo draft in {write_s:.1f} s")
    echo_plain = None
    for name, env in ECHO_PASSES.items():
      res = out[name] = _spec_pass(torch, echo_dir, echo_draft, name, env, echo_plain)
      if echo_plain is None:
        echo_plain = dict(greedy_tokens_default=res["greedy_blocking"], decode_tok_s=res["decode_tok_s"], blocking_tokens=len(res["greedy_blocking"]), blocking_s=res["blocking_s"])
  finally:
    shutil.rmtree(echo_dir, ignore_errors=True)
    shutil.rmtree(echo_draft, ignore_errors=True)
  for name in ECHO_PASSES:
    r = out[name]
    cal = r["calibration"]
    verdict = "A/B off" if cal is None else f"A/B {cal['verdict']}: {cal['spec_tok_s']:.1f} (captured rounds) vs {cal['plain_tok_s']:.1f} (captured steps) tok/s"
    acc = "n/a" if r["acceptance"] is None else f"{r['acceptance']:.3f}"
    log(f"[spec] ceiling pass={name}: acceptance {acc}; streaming {r['decode_tok_s']:.1f} tok/s ({r['decode_tok_s'] / echo_plain['decode_tok_s']:.3f}x the echo checkpoint's plain {echo_plain['decode_tok_s']:.1f}), blocking {r['blocking_tok_s']:.1f} tok/s ({r['blocking_tok_s'] * echo_plain['blocking_s'] / echo_plain['blocking_tokens']:.3f}x); {verdict}")
  return out


def _spec_pass(torch, ckpt: Path, draft_dir: Path, name: str, env: dict, plain):
  from xotorch_support_jetson_tpu_torch import main as tmain

  args, port = _daemon_args(tmain, ckpt)
  env = {k: (str(draft_dir) if k == "XOT_TPU_SPEC_DRAFT" else v) for k, v in env.items()}
  os.environ.update(env)
  t0 = time.perf_counter()
  try:
    return asyncio.run(_serve_spec(torch, tmain, args, port, name, env, plain))
  finally:
    log(f"[spec] pass={name}: {time.perf_counter() - t0:.1f} s with the daemon's start and load")
    for knob in env:
      os.environ.pop(knob, None)
    gc.collect()
    torch.cuda.empty_cache()


def _spy_solo_spec(engine, dec, rec):
  """Count what the solo programs launch, until the returned function
  removes the spies: every graph run (utils/programs.py ``Graph.run``: its
  family, whether it was the graph's first run, its K1 launches; a draft
  round's are its verify window and its catch-up), each n-gram chunk
  (``fused_spec_batch_decode``: rounds, depth cap, K1 launches), each draft
  prefill (K1), each dispatch's kind, each acceptance the draft policy
  folds in, and each n-gram session's depth after a read."""
  from xotorch_support_jetson_tpu_torch.utils import programs

  orig_run, orig_batch = programs.Graph.run, dec.fused_spec_batch_decode
  orig_note, orig_read = engine._note_spec_acceptance, engine._read_chunk_sync

  def graph_run(graph, device, family=None, seed=None):
    new, k1 = graph.graph is None, _launched("flash_prefill")
    orig_run(graph, device, family, seed)
    rec["graph_runs"].append(dict(family=family or graph.family, new=new, k1=_launched("flash_prefill") - k1))

  def counted(fn, key, **extra):
    def run(*a, **kw):
      k1 = _launched("flash_prefill")
      res = fn(*a, **kw)
      rec[key].append(dict(k1=_launched("flash_prefill") - k1, **{k: f(a, kw, res) for k, f in extra.items()}))
      return res

    return run

  programs.Graph.run = graph_run
  dec.fused_spec_batch_decode = counted(orig_batch, "ngram_chunks", rounds=lambda a, kw, r: int(a[13]), gmax=lambda a, kw, r: int(a[14]))
  engine._ensure_draft_cache = counted(engine._ensure_draft_cache, "draft_prefills")
  engine._dispatch_chunk_sync = counted(engine._dispatch_chunk_sync, "dispatches", kind=lambda a, kw, h: "none" if h is None else (h[0] if isinstance(h, tuple) else "plain"))
  engine._generate_speculative_sync = counted(engine._generate_speculative_sync, "oneshots")

  def note(emitted, rounds, gamma):
    rec["acceptance"].append((emitted, rounds, gamma))
    return orig_note(emitted, rounds, gamma)

  def read(handle):
    toks = orig_read(handle)
    if isinstance(handle, tuple) and handle[0] == "ngram":
      session = engine.sessions.get(handle[1])
      rec["ngram_depths"].append(None if session is None else session.ngram_gamma)
    return toks

  engine._note_spec_acceptance, engine._read_chunk_sync = note, read

  def remove():
    programs.Graph.run, dec.fused_spec_batch_decode = orig_run, orig_batch
    for name in ("_ensure_draft_cache", "_dispatch_chunk_sync", "_generate_speculative_sync", "_note_spec_acceptance", "_read_chunk_sync"):
      delattr(engine, name)

  return remove


def _agreement(a, b) -> float:
  """Share of ``b``'s positions where ``a`` holds the same token."""
  return sum(x == y for x, y in zip(a, b)) / max(len(b), 1)


async def _serve_spec(torch, tmain, args, port, name, env, plain):
  """One speculation pass (``plain`` None: the plain pass on the echo
  checkpoint, whose ids the passes after it are held to). The program
  ledger starts empty, as in a fresh daemon."""
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard
  from xotorch_support_jetson_tpu_torch.models import decoder as dec
  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa
  from xotorch_support_jetson_tpu_torch.utils import programs
  from xotorch_support_jetson_tpu_torch.utils.metrics import metrics, snapshot_delta

  base = name.removeprefix("echo_")
  programs.ledger.reset()
  node, api, engine, _ = tmain.build_components(args, tokenizer=ByteTokenizer())
  server = await api.run(host="127.0.0.1", port=port)
  try:
    t0 = time.perf_counter()
    await engine.ensure_shard(Shard("llama-3.2-1b", 0, 15, 16))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cal = engine.spec_calibration
    draft = engine._draft_params is not None
    L_t = engine.cfg.n_layers
    L_d = (engine._draft_cfg or engine.cfg).n_layers
    res = dict(env=env, load_s=load_s, calibration=cal, draft_loaded=draft, draft_layers=L_d if draft else None)
    if base == "int8_autocal":
      if cal is None:
        raise SystemExit(f"chip_smoke: spec {name}: the load-time A/B did not run")
      log(f"[spec] pass={name}: load-time A/B verdict {cal['verdict']}: speculative {cal['spec_tok_s']:.1f} tok/s (captured rounds) vs plain {cal['plain_tok_s']:.1f} tok/s (captured steps) (64 greedy tokens, 256-slot cache pair, best of two after a warm-up run that captures); load {load_s:.1f} s")
    elif not draft and base not in ("ngram", "plain"):
      raise SystemExit(f"chip_smoke: spec {name}: the draft did not load")
    if base == "cross" and L_d != DRAFT_LAYERS:
      raise SystemExit(f"chip_smoke: spec {name}: the draft has {L_d} layers, expected {DRAFT_LAYERS}")
    # Warm-up: the counted requests once, so their graphs exist when the
    # counted ones run (a daemon past its first traffic); then the draft's
    # depth policy restarts where a load leaves it.
    await _serve_requests(torch, node, engine, port, [("warmup streaming", _chat_body(True, 0)), ("warmup blocking", _chat_body(False, 0))])
    engine._spec_ewma, engine._spec_gamma_live, engine._spec_plain_streak = None, engine.spec_gamma, 0
    rec = {k: [] for k in ("graph_runs", "ngram_chunks", "draft_prefills", "dispatches", "acceptance", "ngram_depths", "oneshots")}
    remove = _spy_solo_spec(engine, dec, rec)
    before = metrics.snapshot()
    _reset_launches()  # ---- this pass's main path, counted
    try:
      # Streaming first: it opens at the full depth, whatever the blocking
      # request's acceptance then makes of it.
      run = await _serve_requests(torch, node, engine, port, [("greedy streaming", _chat_body(True, 0)), ("greedy blocking", _chat_body(False, 0))])
      launches = {n: _launched(n) for n in ("flash_prefill", "flash_decode")}  # ---- read just after
      host_k1 = fa.LAUNCHES["flash_prefill"]
    finally:
      remove()
    delta = snapshot_delta(before, metrics.snapshot())
    fams = programs.ledger.snapshot()["families"]
    streaming, blocking = run
    if plain is None:
      plain = dict(greedy_tokens_default=blocking["tokens"], decode_tok_s=_decode_rate(streaming))
    kinds = [d["kind"] for d in rec["dispatches"]]
    spec_kind = "ngram" if not draft else "spec"
    rounds = [r for r in rec["graph_runs"] if r["family"] in ("spec.chunk", "spec.generate")]
    res.update(
      launches=launches, greedy_blocking=blocking["tokens"], greedy_streaming=streaming["tokens"], kinds=kinds,
      ttft_s=streaming["ttft_s"], decode_tok_s=_decode_rate(streaming), blocking_s=blocking["total_s"], blocking_tok_s=len(blocking["tokens"]) / blocking["total_s"],
      agreement_streaming_vs_plain=_agreement(streaming["tokens"], plain["greedy_tokens_default"]), agreement_blocking_vs_plain=_agreement(blocking["tokens"], plain["greedy_tokens_default"]),
      draft_rounds=len(rounds), draft_prefills=len(rec["draft_prefills"]), ngram_chunks=rec["ngram_chunks"], ngram_depths=rec["ngram_depths"],
      speculative_oneshots=len(rec["oneshots"]), acceptance=None,
      programs={f: {k: fams.get(f, {}).get(k, 0) for k in ("compiles", "dispatches", "captures", "replays", "graph_kernels")} for f in sorted(fams)},
      graph_runs=len(rec["graph_runs"]), graph_first_runs=sum(r["new"] for r in rec["graph_runs"]), host_k1=host_k1,
    )
    # Every launch of the counted requests ran inside a graph run, and every
    # host launch in the eager first run of a graph this pass captured: each
    # dispatch was a replay, or the first run of a new graph.
    in_runs, in_first = sum(r["k1"] for r in rec["graph_runs"]), sum(r["k1"] for r in rec["graph_runs"] if r["new"])
    over = {f: v for f, v in res["programs"].items() if v["captures"] > v["compiles"]}
    log(f"[graphs] spec pass={name}: {len(rec['graph_runs'])} graph runs, {res['graph_first_runs']} of them first runs; K1 {launches['flash_prefill']} launches, {in_runs} inside graph runs, host {host_k1} (first runs {in_first}); GET /v1/programs families {res['programs']}")
    if launches["flash_prefill"] != in_runs or host_k1 != in_first or over:
      raise SystemExit(f"chip_smoke: spec {name}: a dispatch ran outside its programs (K1 {launches['flash_prefill']} against {in_runs} in graph runs, host {host_k1} against {in_first} in first runs) or captured more than it built {over}")
    if base == "int8" and not rec["oneshots"]:
      raise SystemExit(f"chip_smoke: spec {name}: the blocking request did not run fused_speculative_generate")
    if base not in ("int8_autocal", "plain") and spec_kind not in kinds:
      raise SystemExit(f"chip_smoke: spec {name}: no {spec_kind} chunk was dispatched ({kinds})")
    if draft:
      # Every round launches K1 once per target layer (the verify window)
      # and once per draft layer (the catch-up); every draft prefill once
      # per draft layer; every request's prefill once per target layer.
      bad = [r for r in rounds if r["k1"] != L_t + L_d] + [p for p in rec["draft_prefills"] if p["k1"] not in (0, L_d)]
      expect = 2 * L_t + sum(p["k1"] for p in rec["draft_prefills"]) + len(rounds) * (L_t + L_d)
      if bad or not rounds or launches["flash_prefill"] != expect:
        raise SystemExit(f"chip_smoke: spec {name}: K1 launches {launches} against {expect} expected ({len(rounds)} rounds of {L_t} + {L_d} layers; off: {bad[:4]})")
      if blocking["tokens"] != streaming["tokens"]:
        raise SystemExit(f"chip_smoke: spec {name}: greedy blocking and streaming differ:\n{blocking['tokens']}\n{streaming['tokens']}")
      emitted, n_rounds = sum(x[0] for x in rec["acceptance"]), sum(x[1] for x in rec["acceptance"])
      res["acceptance"] = (emitted - n_rounds) / max(sum(x[1] * x[2] for x in rec["acceptance"]), 1)  # accepted over proposed
      res["acceptance_calls"] = rec["acceptance"]
    elif base == "plain":
      if blocking["tokens"] != streaming["tokens"] or launches["flash_prefill"] != 2 * L_t or kinds.count("plain") != len([k for k in kinds if k != "none"]):
        raise SystemExit(f"chip_smoke: spec {name}: greedy blocking and streaming differ, or K1 launches {launches} against {2 * L_t}, or kinds {kinds}")
    else:
      spec_chunks = [c for c in rec["ngram_chunks"] if c["gmax"] > 0]
      bad = [c for c in rec["ngram_chunks"] if c["k1"] != (L_t * c["rounds"] if c["gmax"] > 0 else 0)]
      if bad or launches["flash_prefill"] != 2 * L_t + sum(c["k1"] for c in rec["ngram_chunks"]):
        raise SystemExit(f"chip_smoke: spec {name}: K1 launches {launches} (n-gram chunks {rec['ngram_chunks']})")
      accepted = _by_label(delta, "spec_accepted_tokens_total", "proposer").get("ngram", 0)
      proposed = _by_label(delta, "spec_proposed_tokens_total", "proposer").get("ngram", 0)
      res.update(acceptance=accepted / max(proposed, 1), accepted=accepted, proposed=proposed, verify_rounds=sum(c["rounds"] for c in spec_chunks))
      if base == "ngram":
        res["teacher_forced"] = teacher_forced(torch, engine, streaming["tokens"])
        if not spec_chunks or res["teacher_forced"]["agreement"] < 0.9:
          raise SystemExit(f"chip_smoke: spec {name}: {len(spec_chunks)} spec chunks; the streaming ids agree with plain single-token greedy on {res['teacher_forced']['agreement']:.3f} of their positions (gate 0.9)")
      if blocking["tokens"] != plain["greedy_tokens_default"]:
        raise SystemExit(f"chip_smoke: spec {name}: blocking requests must stay plain, and their ids equal the plain pass's")
    acc = "n/a" if res["acceptance"] is None else f"{res['acceptance']:.3f}"
    log(f"[spec] pass={name}: {kinds.count(spec_kind)} {spec_kind} chunks of {len(kinds)} dispatches ({kinds}); {len(rec['oneshots'])} speculative blocking requests; acceptance {acc}; K1 launches {launches['flash_prefill']} ({res['draft_rounds']} draft rounds, {len(rec['ngram_chunks'])} n-gram chunks {[(c['rounds'], c['gmax']) for c in rec['ngram_chunks']]}); n-gram depths after each read {rec['ngram_depths']}")
    log(f"[spec] pass={name}: streaming TTFT {res['ttft_s']:.4f} s, decode {res['decode_tok_s']:.1f} tok/s (plain {plain['decode_tok_s']:.1f}); blocking {res['blocking_tok_s']:.1f} tok/s; ids agree position by position with the plain pass's greedy ids: streaming {res['agreement_streaming_vs_plain']:.3f}, blocking {res['agreement_blocking_vs_plain']:.3f}; blocking == streaming: {blocking['tokens'] == streaming['tokens']}")
    if "teacher_forced" in res:
      tf = res["teacher_forced"]
      log(f"[spec] pass={name}: the streaming ids are the plain single-token greedy choice, given their own prefix, at {tf['agreement']:.3f} of the positions; mismatches (position, token and logit, plain's token and logit): {[(m['position'], m['token'], round(m['logit'], 5), m['plain'], round(m['plain_logit'], 5)) for m in tf['mismatches']]}")
    return res
  finally:
    server.close()
    await server.wait_closed()
    engine.executor.shutdown(wait=True)


def teacher_forced(torch, engine, stream):
  """The served weights' plain greedy choice at every position of
  ``stream`` (the streaming greedy answer to ``CHAT``), given the stream's
  own prefix: one prefill and single-token steps, the plain decode path.
  Returns the share of positions where the stream holds that choice, and
  each mismatch with the two logits. Once a stream takes the other side of
  a near-tie it follows its own greedy trajectory, so its positional
  agreement with another greedy stream says nothing past that point; this
  asks, at each position, whether the token is the plain path's greedy
  token there."""
  from xotorch_support_jetson_tpu_torch.models.decoder import init_kv_cache, shard_forward

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  prompt = torch.tensor([ByteTokenizer().encode(ByteTokenizer().apply_chat_template(CHAT))], dtype=torch.int32, device="cuda")
  S = prompt.shape[1]
  cache = init_kv_cache(cfg, cfg.n_layers, 1, CACHE, device="cuda")
  logits, _ = shard_forward(params, cfg, shard, prompt, torch.arange(S, dtype=torch.int32, device="cuda")[None], cache)
  rows = [logits[0, -1].float()]
  for j, t in enumerate(stream[:-1]):
    step, _ = shard_forward(params, cfg, shard, torch.tensor([[t]], dtype=torch.int32, device="cuda"), torch.tensor([[S + j]], dtype=torch.int32, device="cuda"), cache)
    rows.append(step[0, 0].float())
  logits = torch.stack(rows)
  best = logits.argmax(dim=-1).tolist()
  mism = [dict(position=j, token=t, logit=logits[j, t].item(), plain=best[j], plain_logit=logits[j, best[j]].item()) for j, t in enumerate(stream) if best[j] != t]
  return dict(agreement=1 - len(mism) / len(stream), mismatches=mism)


def profile_ngram_chunk(torch, engine):
  """One n-gram spec chunk as a 32-token streaming dispatch makes it: B=1,
  3 rounds at depth 8 (W = 9) at position 100 of a 4096-slot cache, a
  35-token proposal stream (the device work does not depend on it)."""
  from xotorch_support_jetson_tpu_torch.models.decoder import fused_spec_batch_decode, init_kv_cache

  cfg, shard = engine.cfg, engine._effective_shard
  cache = init_kv_cache(cfg, cfg.n_layers, 1, CACHE, device="cuda")
  one = lambda v, dt: torch.full((1,), v, dtype=dt, device="cuda")  # noqa: E731
  tok = torch.full((1, 1), 65, dtype=torch.int32, device="cuda")
  props = torch.full((1, 35), 65, dtype=torch.int32, device="cuda")

  def chunk():
    out = fused_spec_batch_decode(engine.params, cfg, shard, None, cfg, shard, tok, cache, None, one(100, torch.int32), one(True, torch.bool), one(8, torch.int32), one(0.0, torch.float32), 3, 8, top_k=1, k_max=1, props=props, prop_counts=one(35, torch.int32))
    out[1].cpu()  # the read a chunk ends with

  return _profile(torch, "n-gram spec chunk, B=1, 3 rounds at depth 8 (W=9; eager)", chunk, 3)


def profile_draft_round(torch, engine, what="int8-draft"):
  """One draft round as the draft chain runs it, eagerly: 4 draft steps,
  the verify window (W = 5) and the draft's catch-up at position 100 of
  4096-slot caches, and the read-back that ends a block."""
  from xotorch_support_jetson_tpu_torch.models.decoder import fused_speculative_generate, init_kv_cache

  cfg, shard = engine.cfg, engine._effective_shard
  cfg_d, shard_d = engine._draft_cfg or cfg, engine._draft_shard or shard
  ct = init_kv_cache(cfg, cfg.n_layers, 1, CACHE, device="cuda")
  cd = init_kv_cache(cfg_d, cfg_d.n_layers, 1, CACHE, device="cuda")
  tok = torch.full((1, 1), 65, dtype=torch.int32, device="cuda")

  def one_round():
    fused_speculative_generate(engine.params, cfg, shard, engine._draft_params, cfg_d, shard_d, tok, ct, cd, 100, 1, gamma=4)

  # One repetition: the eager round is host-bound and steady, and each
  # repetition costs the profiler ~10,000 launches to sort.
  return _profile(torch, f"{what} round, depth 4 (4 draft steps, W=5 verify, W=5 catch-up; eager)", one_round, 1)


# ------------------------------------------------------------- 6. batched


SYSTEM_PREFIX = "You are a careful assistant. Answer in plain words, keep every answer short, and say when you do not know an answer."


SPEC_ROUNDS, SPEC_GAMMA = 8, 8  # one spec chunk at the server's shape: XOT_TPU_BATCH_CHUNK rounds at depth XOT_TPU_SPEC_NGRAM_MAX
# The priority pass holds its batch rows for a known time: a spec chunk
# emits at most SPEC_ROUNDS × (SPEC_GAMMA + 1) = 72 tokens a row, so a
# batch answer of 10 chunks' worth needs at least 10 captured chunks even
# at full n-gram acceptance; the interactive wave, sent once the eighth
# batch row streams, arrives while all eight are held.
PRIORITY_HELD_CHUNKS = 10
PRIORITY_BATCH_TOKENS = PRIORITY_HELD_CHUNKS * SPEC_ROUNDS * (SPEC_GAMMA + 1)


def batched_bodies(n=16, priority=None, variant=0):
  """16 greedy streaming chat requests. The byte-level chat template puts
  BOS + "<|system|>" + the 116-byte system prompt + newline first: the
  same 128 tokens (two full 64-token pages) in every prompt. The user
  suffixes are distinct, 16 to 400 bytes, longest last. Answers are 29 to
  64 tokens, so rows free one at a time and requests sent after the first
  eight admit while the others stream — the admissions mixed ticks slice.
  With a ``priority`` no row frees early, so a later request of a higher
  class finds no free slot and preempts: a ``batch`` answer is
  ``PRIORITY_BATCH_TOKENS`` long (at least ``PRIORITY_HELD_CHUNKS`` spec
  chunks even if every proposal is accepted), any other 64. Another
  ``variant`` starts each suffix elsewhere in the word list: the same
  lengths (the same dispatch shapes) with other tokens, so no prompt page
  but the system prefix is a prefix-cache hit for the other variant."""
  if len(ByteTokenizer().encode(f"<|system|>{SYSTEM_PREFIX}\n")) != 2 * PAGE:
    raise SystemExit("chip_smoke: the shared system prefix must be exactly two pages")
  words = "the quick brown fox jumps over a lazy dog while seven tired owls count the stars above an old mill".split()
  bodies = []
  for i in range(n):
    size = 16 + (384 * i) // (n - 1)
    text = f"request {i}: " + " ".join(words[(i + j + 7 * variant) % len(words)] for j in range(size))
    msgs = [{"role": "system", "content": SYSTEM_PREFIX}, {"role": "user", "content": text[:size]}]
    body = {"model": "llama-3.2-1b", "messages": msgs, "stream": True, "temperature": 0, "max_tokens": MAX_TOKENS - 5 * (i % 8)}
    if priority:
      body.update(priority=priority, max_tokens=PRIORITY_BATCH_TOKENS if priority == "batch" else MAX_TOKENS)
    bodies.append(body)
  return bodies


def _pctl(xs, q):
  xs = sorted(xs)
  return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]  # nearest rank


# Batched daemon passes: (name, KV pool type, environment). On bf16 weights:
# the defaults (batched n-gram speculation, QoS and mixed ticks on) per pool
# type, the same bf16 pass with XOT_TPU_SPEC_BATCH=0 (no speculation), with
# XOT_TPU_MIXED_TICK=0 (the alternating schedule mixed ticks replace), with
# QoS and the SLO engine off as well (the FIFO scheduler of earlier slices),
# and the priority pass (12 batch requests, then 4 interactive ones).
BATCHED_PASSES = [
  ("bf16", "", {}), ("bf16_nospec", "", {"XOT_TPU_SPEC_BATCH": "0"}), ("int8", "int8", {}), ("int4", "int4", {}), ("bf16_alternating", "", {"XOT_TPU_MIXED_TICK": "0"}),
  ("bf16_fifo", "", {"XOT_TPU_MIXED_TICK": "0", "XOT_TPU_QOS": "0", "XOT_TPU_SLO": "0"}), ("bf16_priority", "", {}),
]
PASS_KNOBS = ("XOT_TPU_MIXED_TICK", "XOT_TPU_QOS", "XOT_TPU_SLO", "XOT_TPU_SPEC_BATCH")
MEASURED_PASSES = ("bf16", "bf16_nospec", "bf16_alternating")  # their rates are compared: build rounds first


def phase_batched(torch, ckpt: Path, weights: str = "bf16"):
  """The batched daemon: the passes of ``BATCHED_PASSES`` on the bf16
  weights, or (``weights="int4"``) one default pass with XOT_TPU_QUANT=int4
  and bf16 pages."""
  from xotorch_support_jetson_tpu_torch import main as tmain

  args, port = _daemon_args(tmain, ckpt, max_tokens=PRIORITY_BATCH_TOKENS)  # the priority pass's batch answers; every other request names its own
  os.environ.update(XOT_TPU_BATCHED="1", XOT_TPU_BATCH_SLOTS=str(BATCH_SLOTS), XOT_TPU_PAGE_SIZE=str(PAGE))
  if weights != "bf16":
    os.environ["XOT_TPU_QUANT"] = weights
  try:
    return asyncio.run(_serve_batched(torch, tmain, args, port, weights))
  finally:
    for knob in ("XOT_TPU_BATCHED", "XOT_TPU_BATCH_SLOTS", "XOT_TPU_PAGE_SIZE", "XOT_TPU_KV_QUANT", "XOT_TPU_QUANT", *PASS_KNOBS):
      os.environ.pop(knob, None)
    gc.collect()
    torch.cuda.empty_cache()


def _spy_mixed(engine, fa, paged, slices):
  """Record each mixed dispatch's slice (pad, offset, length) and the K1 /
  K3 launches made inside it (the dispatch enqueues its kernels on the
  host, so the counters move during the call) until the returned function
  removes the spy."""
  ops = engine.batch_ops
  orig = ops.mixed_paged_batch_decode

  def spy(*args, **kw):
    k1, k3 = _launched("flash_prefill"), _launched("paged_decode")
    out = orig(*args, **kw)
    start, end = int(kw["pf_prefix"][0]), int(kw["pf_end"][0])
    slices.append(dict(pad=int(kw["pf_tokens"].shape[1]), offset=start, tokens=end - start, k1=_launched("flash_prefill") - k1, k3=_launched("paged_decode") - k3))
    return out

  ops.mixed_paged_batch_decode = spy
  return lambda: delattr(ops, "mixed_paged_batch_decode")


def _spy_spec(engine, paged, k4, records):
  """Record each spec dispatch (its depth cap, the rows that proposed) and
  the K3 / K4 launches made inside it, until the returned function removes
  the spy."""
  ops = engine.batch_ops
  orig = ops.spec_paged_batch_decode

  def spy(*args, **kw):
    k3, n4 = _launched("paged_decode"), _launched("int4_matmul")
    out = orig(*args, **kw)
    pc = kw.get("prop_counts")
    records.append(dict(gmax=int(args[10]), rounds=int(args[9]), proposing=0 if pc is None else int((np.asarray(pc) > 0).sum()), k3=_launched("paged_decode") - k3, k4=_launched("int4_matmul") - n4))
    return out

  ops.spec_paged_batch_decode = spy
  return lambda: delattr(ops, "spec_paged_batch_decode")


def _hold_wave(bserver, n: int, arrivals: list):
  """Hold the batched server's first ``n`` submissions until all ``n`` have
  reached it, then let them in together, shortest prompt first (the order
  ``batched_bodies`` sends them): the wave admits in one pass whatever the
  client threads' timing, and ``arrivals`` gets the seconds from the first
  submission to each later one. Later submissions pass straight through.
  Returns the function that removes the hold."""
  orig = bserver.submit
  held: list = []
  t0: list[float] = []

  async def submit(request_id, tokens, **kw):
    if len(held) >= n:
      return await orig(request_id, tokens, **kw)
    go = asyncio.Event()
    t0 or t0.append(time.perf_counter())
    arrivals.append(time.perf_counter() - t0[0])
    held.append((len(tokens), go))
    if len(held) == n:
      # Set from a callback, so this submission waits like the others: the
      # waiters resume in this order, each enqueued before the scheduler's
      # loop (woken by the first) runs.
      asyncio.get_running_loop().call_soon(lambda: [ev.set() for _, ev in sorted(held, key=lambda h: h[0])])
    await go.wait()
    return await orig(request_id, tokens, **kw)

  bserver.submit = submit
  return lambda: delattr(bserver, "submit")


def _by_label(delta, name, label):
  """A labelled counter's growth in a registry delta, by one label's value."""
  return {dict(map(tuple, k)).get(label): v for k, v in delta["labeled_counters"].get(name, [])}


async def _serve_batched(torch, tmain, args, port, weights):
  from concurrent.futures import ThreadPoolExecutor

  from xotorch_support_jetson_tpu_torch.inference.shard import Shard
  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa, int4_matmul as k4, paged
  from xotorch_support_jetson_tpu_torch.orchestration import slo
  from xotorch_support_jetson_tpu_torch.utils import programs
  from xotorch_support_jetson_tpu_torch.utils.metrics import metrics, snapshot_delta

  node, api, engine, _ = tmain.build_components(args, tokenizer=ByteTokenizer())
  await node.start()  # as main.async_main: the SLO engine's tick task, whose slo_burn_rate gauge sets the mixed budget
  server = await api.run(host="127.0.0.1", port=port)
  clients = ThreadPoolExecutor(max_workers=16)  # one client thread per concurrent request
  loop = asyncio.get_running_loop()
  try:
    await engine.ensure_shard(Shard("llama-3.2-1b", 0, 15, 16))
    ids: dict[str, list[int]] = {}
    node.on_token.register("chip_smoke").on_next(lambda rid, toks, fin: ids.setdefault(rid, []).extend(toks))
    passes = {}
    plan = BATCHED_PASSES if weights == "bf16" else [("bf16", "", {})]
    for name, quant, env in plan:
      t_pass = time.perf_counter()
      engine._drop_batched_server()  # a fresh pool (and QoS / mixed-tick verdict) for this pass
      os.environ["XOT_TPU_KV_QUANT"] = quant
      for knob in PASS_KNOBS:
        os.environ.pop(knob, None)
      os.environ.update(env)
      # Each pass's server has a fresh pool and fresh graphs: the ledger
      # starts with it, so its captures and builds count alike.
      programs.ledger.reset()
      memory = dict(allocated=torch.cuda.memory_allocated(), reserved=torch.cuda.memory_reserved())
      warm = {"model": "llama-3.2-1b", "messages": [{"role": "user", "content": "warm up"}], "stream": True, "temperature": 0, "max_tokens": 9}
      await loop.run_in_executor(clients, _post, port, warm)  # first cuBLAS/kernel work off the clock
      bserver = engine.get_batched_server()
      priority = name == "bf16_priority"
      # The passes whose rates are compared (PERF.md §5-§6) first serve a
      # build round, its traffic on other text: the dispatch shapes are
      # built (captured) before the measured round, as a served daemon's
      # are once traffic of those shapes has passed.
      build = [await _build_round(loop, clients, port, ids, priority, variant, bserver) for variant in ((1,) if name in MEASURED_PASSES else ())]
      graphs0 = {id(g) for g in engine.batch_ops.programs.graphs()}
      slices: list[dict] = []
      unspy = _spy_mixed(engine, fa, paged, slices)
      spec_records: list[dict] = []
      unspy_spec = _spy_spec(engine, paged, k4, spec_records)
      admissions: list[dict] = []
      unspy_adm = _spy_admissions(bserver, admissions)
      hits0 = bserver.prefix_hit_pages
      snap0, burn0 = metrics.snapshot(), _interactive_burn(metrics, slo)
      # Two waves: the first reaches the scheduler together (``_hold_wave``),
      # the second is sent once every slot streams, so it admits as rows
      # free — while the others keep decoding.
      waves = (batched_bodies(12, "batch"), batched_bodies(4, "interactive")) if priority else (batched_bodies()[:8], batched_bodies()[8:])
      bodies = waves[0] + waves[1]
      arrivals: list[float] = []
      unhold = _hold_wave(bserver, len(waves[0]), arrivals)
      _reset_launches()  # ---- this pass's main path, counted
      t0 = time.perf_counter()
      before = set(ids)
      first = [loop.run_in_executor(clients, _post, port, b) for b in waves[0]]
      try:
        while sum(1 for rid, t in ids.items() if t and rid not in before) < BATCH_SLOTS:
          if time.perf_counter() - t0 > 120 or any(f.done() for f in first):
            failed = [repr(f.exception()) for f in first if f.done() and f.exception() is not None]
            ended = [round(f.result()[3], 3) for f in first if f.done() and f.exception() is None]
            raise SystemExit(f"chip_smoke: batched {name}: the first wave's rows did not all stream (failed requests: {failed}; ended after {ended} s; {len(arrivals)} of {len(first)} reached the scheduler, at {[round(a, 3) for a in arrivals]} s after the first; rows streaming {[len(t) for rid, t in ids.items() if rid not in before]} tokens)")
          await asyncio.sleep(0.005)
      finally:
        unhold()
      second_s = time.perf_counter() - t0
      second = [loop.run_in_executor(clients, _post, port, b) for b in waves[1]]
      endpoints = await asyncio.to_thread(_read_endpoints, port) if name == "bf16" else None  # its own thread: the 16 client threads are busy
      replies = await asyncio.gather(*first, *second)
      wall = time.perf_counter() - t0
      unspy()
      unspy_spec()
      unspy_adm()
      launches = {"flash_prefill": _launched("flash_prefill"), "flash_decode": _launched("flash_decode"), "paged_decode": _launched("paged_decode"), "int4_matmul": _launched("int4_matmul")}  # ---- read just after
      host = {"flash_prefill": fa.LAUNCHES["flash_prefill"], "paged_decode": paged.LAUNCHES["paged_decode"], "int4_matmul": k4.LAUNCHES["int4_matmul"]}
      graphs = _pass_graphs(engine.batch_ops.programs, graphs0, host, launches, await asyncio.to_thread(_get_json, port, "/v1/programs"))
      two_dot = k4.CALLS["int4_two_dot"]
      delta, burn1 = snapshot_delta(snap0, metrics.snapshot()), _interactive_burn(metrics, slo)
      sched = {h: _hist_mean_ms(delta, h) for h in ("decode_chunk_seconds", "mixed_tick_seconds", "sched_host_gap_seconds")}
      preemptions = int(delta["counters"].get("qos_preemptions_total", 0))
      mixed = sched["mixed_tick_seconds"]["count"]
      slo_on = env.get("XOT_TPU_SLO") != "0"
      budget_from = "XOT_TPU_SLO=0 (no burn signal)" if not slo_on else "slo_burn_rate gauge" if burn0 is not None else "fallback (interactive ITL median) until the first tick" if burn1 is not None else "fallback (interactive ITL median): no tick"
      hits = bserver.prefix_hit_pages - hits0
      tiered = dict(
        on=bserver.tier is not None, spilled_pages=delta["counters"].get("kv_tier_spilled_pages_total", 0.0), restored_pages=delta["counters"].get("kv_tier_restored_pages_total", 0.0),
        failures=_tier_failures(metrics), host_pages=bserver.tier.host_pages if bserver.tier is not None else None,
      )
      # A preempted row's resume (carried tokens) must admit with every full
      # page of its absorbed stream as a prefix: its prompt's and the ones
      # its generated tokens filled (donated under extended chain keys).
      resumes = [dict(rid=a["rid"], tokens=len(a["tokens"]), carried=a["carry"], prefix=a["prefix"], full=((len(a["tokens"]) - 1) // PAGE) * PAGE) for a in admissions if a["carry"]]
      spec = dict(
        on=bserver.spec, proposers=list(bserver.spec_proposers), dispatches=len(spec_records), proposing_rows=sum(x["proposing"] for x in spec_records),
        gmax=sorted({x["gmax"] for x in spec_records}), launches={"paged_decode": sum(x["k3"] for x in spec_records), "int4_matmul": sum(x["k4"] for x in spec_records)},
        accepted=_by_label(delta, "spec_accepted_tokens_total", "proposer"), proposed=_by_label(delta, "spec_proposed_tokens_total", "proposer"),
        chunks_by_path=_by_label(delta, "decode_chunks_total", "path"), tokens_by_path=_by_label(delta, "decode_tokens_total", "path"),
      )
      reqs, streams = [], []
      for (text, finish, ttft, total, n_events, rid), b in zip(replies, bodies):
        toks = ids.get(rid, [])
        if not toks or len(toks) > b["max_tokens"] or finish not in ("stop", "length") or (finish == "length" and len(toks) != b["max_tokens"]):
          raise SystemExit(f"chip_smoke: batched {name}: request {rid} gave {len(toks)} of {b['max_tokens']} tokens, finish {finish}")
        reqs.append(dict(rid=rid, priority=b.get("priority", "standard"), tokens=len(toks), ttft_s=ttft, total_s=total, decode_tok_s=(len(toks) - 1) / max(total - ttft, 1e-9), user_bytes=len(b["messages"][1]["content"])))
        streams.append(list(toks))
      n_tok = sum(r["tokens"] for r in reqs)
      res = dict(
        weights=weights, kv=quant or "bf16", env=env, requests=len(reqs), wall_s=wall, tokens=n_tok, aggregate_tok_s=n_tok / wall,
        ttft_p50_s=_pctl([r["ttft_s"] for r in reqs], 0.5), ttft_p95_s=_pctl([r["ttft_s"] for r in reqs], 0.95),
        decode_tok_s_p50=_pctl([r["decode_tok_s"] for r in reqs], 0.5), decode_tok_s_min=min(r["decode_tok_s"] for r in reqs),
        launches=launches, int4_two_dot_calls=two_dot, prefix_hit_pages=hits, pool_pages=bserver.allocator.n_pages,
        mixed_dispatches=mixed, preemptions=preemptions, qos=bserver.qos is not None, mixed_ticks=bserver._mixed_active(), scheduler_ms=sched,
        budget_from=budget_from, interactive_burn=dict(start=burn0, end=burn1), endpoints=endpoints,
        kv_tier=tiered, resumes=resumes, mixed_slices=slices, mixed_launches={"flash_prefill": sum(x["k1"] for x in slices), "paged_decode": sum(x["k3"] for x in slices)},
        ttft_p50_by_class={c: _pctl([r["ttft_s"] for r in reqs if r["priority"] == c], 0.5) for c in sorted({r["priority"] for r in reqs})},
        spec=spec, per_request=reqs, streams=streams, graphs=graphs, memory_at_start=memory, build_rounds=build, first_wave_arrivals_s=arrivals,
      )
      need_k1 = quant != "int4"  # int4 pages prefill through the plain attention, as the reference gates K1
      need_k4 = weights == "int4"
      if launches["paged_decode"] == 0 or (need_k1 and launches["flash_prefill"] == 0) or hits == 0 or launches["flash_decode"] != 0 or (launches["int4_matmul"] == 0) == need_k4 or two_dot:
        raise SystemExit(f"chip_smoke: batched {weights} weights, pass {name}: launches {launches}, shared-page hits {hits}, {two_dot} int4_two_dot calls")
      if res["qos"] == (env.get("XOT_TPU_QOS") == "0") or res["mixed_ticks"] == (env.get("XOT_TPU_MIXED_TICK") == "0"):
        raise SystemExit(f"chip_smoke: batched {name}: QoS {res['qos']}, mixed ticks {res['mixed_ticks']} (expected the defaults unless the pass sets them)")
      if name == "bf16" and (mixed == 0 or len(slices) != mixed):
        raise SystemExit(f"chip_smoke: batched {weights} weights, default bf16 pass: {mixed} mixed dispatches settled, {len(slices)} dispatched")
      off_k1 = [x for x in slices if x["k3"] == 0 or x["k1"] != (engine.cfg.n_layers if quant != "int4" else 0)]
      if off_k1:  # every slice prefills through K1 once per layer (int4 pages: the plain path) and decodes through K3
        raise SystemExit(f"chip_smoke: batched {name}: mixed dispatches off their kernels: {off_k1[:4]}")
      if slo_on and burn0 is None:
        raise SystemExit(f"chip_smoke: batched {name}: no slo_burn_rate gauge when the pass began (the node's SLO tick task did not run)")
      if env.get("XOT_TPU_MIXED_TICK") == "0" and (mixed or slices):
        raise SystemExit(f"chip_smoke: batched {name}: {mixed} mixed dispatches with XOT_TPU_MIXED_TICK=0")
      spec_off = env.get("XOT_TPU_SPEC_BATCH") == "0"
      if spec["on"] == spec_off or (not spec_off and spec["proposers"] != ["ngram"]):
        raise SystemExit(f"chip_smoke: batched {name}: speculation {spec['on']} with proposers {spec['proposers']} (the default is draft-free n-gram speculation)")
      if spec_off and spec_records:
        raise SystemExit(f"chip_smoke: batched {name}: {len(spec_records)} spec dispatches with XOT_TPU_SPEC_BATCH=0")
      if name == "bf16" and weights == "bf16" and not spec_records:
        raise SystemExit(f"chip_smoke: batched {weights} weights, default bf16 pass: no spec dispatch")
      off_k3 = [x for x in spec_records if x["k3"] != engine.cfg.n_layers * x["rounds"] or (x["k4"] == 0) == (weights == "int4")]
      if off_k3:  # every round's verify window through K3 once per layer (and K4 on int4 weights)
        raise SystemExit(f"chip_smoke: batched {name}: spec dispatches off their kernels: {off_k3[:4]}")
      if priority and preemptions < 1:
        ends = sorted(round(r[3], 3) for r in replies[: len(first)])
        raise SystemExit(f"chip_smoke: batched {name}: no preemption (interactive requests arrived while {BATCH_SLOTS} batch rows streamed); the interactive wave sent {second_s:.3f} s after the first, the batch requests' ends {ends} s, the interactive TTFTs {[round(r[2], 3) for r in replies[len(first):]]} s, {graphs['captures']} captures ({graphs['capture_s']:.3f} s) in the pass, {len(spec_records)} spec dispatches")
      if not tiered["on"] or any(tiered["failures"].values()) or len(resumes) != preemptions or any(r["prefix"] != r["full"] for r in resumes):
        raise SystemExit(f"chip_smoke: batched {name}: host KV tier {tiered}; {preemptions} preemptions, resumes (prefix against the victim's full pages) {resumes}")
      if bserver.busy() or bserver.allocator.audit()["referenced"]:
        raise SystemExit(f"chip_smoke: batched {name}: the server did not drain: {bserver.allocator.audit()}")
      if not graphs["ok"]:
        raise SystemExit(f"chip_smoke: batched {name}: a dispatch ran outside its graph, or captures and builds differ: {graphs}")
      passes[name] = res
      rounds = "; ".join(f"{b['tokens']} tokens in {b['wall_s']:.3f} s, aggregate {b['aggregate_tok_s']:.1f} tok/s, TTFT p50 {b['ttft_p50_s']:.4f} s p95 {b['ttft_p95_s']:.4f} s, captures {b['captures']} ({b['capture_s']:.3f} s)" for b in build) or "none"
      log(f"[graphs] batched pass={name}: build rounds (the same shapes on other text): {rounds} | measured round: captures {graphs['captures']} ({graphs['capture_s']:.3f} s), per family (captures, builds, replays over every round; graphs new in the measured round; their eager first runs' K3 launches) {graphs['families']} | host launches {host} = the new graphs' first runs {graphs['first_runs']}; launches inside replays {graphs['replayed']} | device memory at the pass's start {memory}")
      pads = sorted({x["pad"] for x in slices})
      log(f"[batched] pass={name} spec: on {spec['on']} | {spec['dispatches']} spec dispatches (depth caps {spec['gmax']}, {spec['proposing_rows']} proposing rows in all; launches inside them {spec['launches']}) | accepted {spec['accepted']} of proposed {spec['proposed']} tokens by proposer | decode chunks by path {spec['chunks_by_path']}, tokens by path {spec['tokens_by_path']}")
      log(f"[batched] weights={weights} pass={name} kv={res['kv']}{' ' + str(env) if env else ''}: {len(reqs)} streaming requests, {n_tok} tokens in {wall:.3f} s: aggregate {res['aggregate_tok_s']:.1f} tok/s | TTFT p50 {res['ttft_p50_s']:.4f} s p95 {res['ttft_p95_s']:.4f} s | per-request decode p50 {res['decode_tok_s_p50']:.2f} tok/s (min {res['decode_tok_s_min']:.2f}) | launches {launches} | mixed dispatches {mixed} (slice pads {pads}, offsets {min((x['offset'] for x in slices), default=None)}..{max((x['offset'] for x in slices), default=None)}; launches inside them {res['mixed_launches']}) | preemptions {preemptions} | mixed budget from {budget_from} (interactive burn {burn0} -> {burn1}) | scheduler ms (registry, mean over the pass): {', '.join(f'{h} {v['mean_ms']} x{v['count']}' for h, v in sched.items())} | shared prefix pages {hits} | pool {res['pool_pages']} pages | host KV tier: spilled {tiered['spilled_pages']:.0f} restored {tiered['restored_pages']:.0f} pages, failures {tiered['failures']}")
      if endpoints is not None:
        log(f"[batched] pass={name}: GET /metrics and /v1/slo mid-pass: {endpoints}")
      if priority:
        log(f"[batched] pass={name}: TTFT p50 by class {res['ttft_p50_by_class']} | resumes (tokens, prefix at admission, the victim's full pages): {[(r['tokens'], r['prefix'], r['full']) for r in resumes]}")
      log(f"[time] batched {weights} weights, pass {name}: {time.perf_counter() - t_pass:.1f} s")
    for knob in ("XOT_TPU_KV_QUANT", *PASS_KNOBS):
      os.environ.pop(knob, None)
    node.on_token.deregister("chip_smoke")
    out = dict(passes=passes)
    t_tail = time.perf_counter()
    if weights == "bf16":
      out["warmup"] = await asyncio.to_thread(_batched_warmup_twice, port)
      out["logprobs"] = await _batched_logprobs(torch, node, engine, port)  # after the gated windows
      log(f"[time] batched {weights} weights: warmup and logprobs {time.perf_counter() - t_tail:.1f} s")
    if "bf16_nospec" in passes:
      # Greedy tokens the speculating default pass and the XOT_TPU_SPEC_BATCH=0
      # pass agree on, position by position (reported, not gated: bf16 sums
      # of a 9-token window and of one token may round apart).
      a, b = passes["bf16"]["streams"], passes["bf16_nospec"]["streams"]
      same = sum(sum(1 for x, y in zip(s, t) if x == y) for s, t in zip(a, b))
      out["spec_agreement"] = dict(tokens_agreeing=same, tokens=sum(max(len(s), len(t)) for s, t in zip(a, b)), share=same / max(sum(max(len(s), len(t)) for s, t in zip(a, b)), 1))
      on, off = passes["bf16"], passes["bf16_nospec"]
      log(f"[batched] speculation on (defaults) vs XOT_TPU_SPEC_BATCH=0, bf16: aggregate {on['aggregate_tok_s']:.1f} vs {off['aggregate_tok_s']:.1f} tok/s | TTFT p50 {on['ttft_p50_s']:.4f} vs {off['ttft_p50_s']:.4f} s, p95 {on['ttft_p95_s']:.4f} vs {off['ttft_p95_s']:.4f} s | per-request decode p50 {on['decode_tok_s_p50']:.2f} vs {off['decode_tok_s_p50']:.2f} tok/s | greedy tokens agreeing {out['spec_agreement']['share']:.3f}")
    if weights == "bf16":  # what one SLO tick costs (on the node's worker thread) over the registry these passes filled
      t = time.perf_counter()
      slo.slo_engine.tick()
      out["slo_tick_ms"] = (time.perf_counter() - t) * 1e3
      log(f"[batched] one SLO engine tick (registry snapshot, every window, the gauges) after the passes: {out['slo_tick_ms']:.3f} ms of host time")
    if weights == "bf16":
      out["check"] = check_batched_against_plain(torch, engine)
      log(f"[batched] one decode step through K3 vs the gather path on the same pool (rel L2 of logits): {out['check']}")
      out["window_check"] = check_window_against_plain(torch, engine)
      out["spec_chunk"] = check_spec_chunk_accepts(torch, engine)
      out["mixed_check"] = check_mixed_against_alternating(torch, engine)
      log(f"[time] batched {weights} weights: to the checks' end {time.perf_counter() - t_tail:.1f} s")
      out["profile"] = profile_batched(torch, engine)
      log(f"[time] batched {weights} weights: to the profile's end {time.perf_counter() - t_tail:.1f} s")
    engine._drop_batched_server()  # its pool and graphs: the checks below bring their own
    gc.collect()
    torch.cuda.empty_cache()
    t_graphs = time.perf_counter()
    out["graphs"] = batched_graphs_against_eager(torch, engine, weights)
    log(f"[time] batched {weights} weights: graphs against eager {time.perf_counter() - t_graphs:.1f} s")
    if weights == "bf16":
      out["graphs_profile"] = profile_batched_graphs(torch, engine, _smi(), out["profile"])
      log(f"[time] batched {weights} weights: to the graphs profile's end {time.perf_counter() - t_tail:.1f} s")
    return out
  finally:
    await node.stop()
    await asyncio.to_thread(clients.shutdown, True)  # off the loop: requests still in flight get their answers
    server.close()
    await server.wait_closed()
    engine.executor.shutdown(wait=True)


async def _build_round(loop, clients, port, ids, priority, variant, bserver) -> dict:
  """A batched pass's traffic on other text (``batched_bodies`` of
  ``variant``): two waves as the measured round sends them. Every request
  must end with tokens. Unlike the measured round, a first-wave request
  that ends with its tokens before the eighth row streams does not fail
  the round: here the rows decode while the pool's graphs are first
  captured. Each round logs when the eighth row's first token came, the
  captures before it and the first wave's earliest end, and lists the
  requests that ended first. Returns those, its wall, tokens, aggregate,
  TTFT and the captures (and their seconds) the ledger counted during it."""
  from xotorch_support_jetson_tpu_torch.utils.programs import ledger

  waves = (batched_bodies(12, "batch", variant), batched_bodies(4, "interactive", variant)) if priority else (batched_bodies(variant=variant)[:8], batched_bodies(variant=variant)[8:])
  fams = ledger.snapshot()["families"]
  c0, s0 = sum(f["captures"] for f in fams.values()), sum(f["capture_s"] for f in fams.values())
  arrivals: list[float] = []
  unhold = _hold_wave(bserver, len(waves[0]), arrivals)  # as the measured round sends it
  t0 = time.perf_counter()
  before = set(ids)
  first = [loop.run_in_executor(clients, _post, port, b) for b in waves[0]]
  ended: dict[int, float] = {}  # first-wave request -> seconds from the first send to when the poll saw it end
  while sum(1 for rid, t in list(ids.items()) if t and rid not in before) < BATCH_SLOTS:
    now = time.perf_counter() - t0
    if now > 120 or any(f.done() and f.exception() is not None for f in first):
      failed = [repr(f.exception()) for f in first if f.done() and f.exception() is not None]
      raise SystemExit(f"chip_smoke: batched build round: the first wave's rows did not all stream (failed requests: {failed})")
    ended.update((i, now) for i, f in enumerate(first) if f.done() and i not in ended)
    await asyncio.sleep(0.005)
  unhold()
  eighth_s = time.perf_counter() - t0
  fams = ledger.snapshot()["families"]
  c8, s8 = sum(f["captures"] for f in fams.values()) - c0, sum(f["capture_s"] for f in fams.values()) - s0
  replies = await asyncio.gather(*first, *(loop.run_in_executor(clients, _post, port, b) for b in waves[1]))
  wall = time.perf_counter() - t0
  tokens = [len(ids.get(rid, [])) for *_, rid in replies]
  if not all(tokens):
    raise SystemExit(f"chip_smoke: batched build round: tokens per request {tokens}")
  early = [dict(ended_s=ended[i], tokens=tokens[i], ttft_s=replies[i][2]) for i in sorted(ended, key=ended.get)]
  earliest = min(r[3] for r in replies[: len(first)])
  log(f"[batched] build round {variant}: the first wave reached the scheduler over {arrivals[-1]:.3f} s; the eighth row's first token {eighth_s:.3f} s after the first send, {c8} captures ({s8:.3f} s) before it; the first wave's earliest end {earliest:.3f} s; ended before the eighth row streamed: {early or 'none'}")
  fams = ledger.snapshot()["families"]
  ttfts = [r[2] for r in replies]
  return dict(
    wall_s=wall, tokens=sum(tokens), aggregate_tok_s=sum(tokens) / wall, ttft_p50_s=_pctl(ttfts, 0.5), ttft_p95_s=_pctl(ttfts, 0.95),
    captures=sum(f["captures"] for f in fams.values()) - c0, capture_s=sum(f["capture_s"] for f in fams.values()) - s0,
    first_wave_arrivals_s=arrivals, eighth_first_token_s=eighth_s, captures_before_eighth=c8, capture_s_before_eighth=s8, first_wave_earliest_end_s=earliest, ended_before_eighth=early,
  )


def _pass_graphs(progs, before: set, host: dict, launches: dict, snap: dict) -> dict:
  """A served pass's graph bookkeeping: per batched family the ledger's
  captures, builds and replays (``GET /v1/programs``) and the graphs the
  pass captured; the kernel launches their eager first runs made. ``ok``
  when every host launch of K1, K3 and K4 came from such a first run (every
  other launch was inside a replay) and each family captured one graph per
  build."""
  new = [g for g in progs.graphs() if id(g) not in before]
  first_runs = {k: sum(g.kernels.get(k, 0) for g in new) for k in host}
  fams = {}
  for f in BATCHED_FAMILIES:
    st = snap["families"].get(f, {})
    mine = [g for g in new if g.family == f]
    fams[f] = dict(captures=st.get("captures", 0), compiles=st.get("compiles", 0), replays=st.get("replays", 0), new_graphs=len(mine), first_run_k3=sum(g.kernels.get("paged_decode", 0) for g in mine))
  replayed = {k: launches[k] - host[k] for k in host}
  ok = host == first_runs and all(v["captures"] == v["compiles"] for v in fams.values()) and launches["paged_decode"] > host["paged_decode"]
  return dict(ok=ok, families=fams, first_runs=first_runs, replayed=replayed, captures=len(new), capture_s=sum(g.capture_s for g in new))


def _batched_warmup_twice(port) -> dict:
  """``POST /v1/warmup`` twice on the last pass's server: the first builds
  and captures what its synthetic traffic needs, the second (the same
  traffic) must build and capture nothing and replay instead; every
  batched family keeps one capture per build."""
  w1 = _post_json(port, "/v1/warmup", {})
  s1 = _get_json(port, "/v1/programs")
  w2 = _post_json(port, "/v1/warmup", {})
  s2 = _get_json(port, "/v1/programs")
  fam = lambda snap, f, k: snap["families"].get(f, {}).get(k, 0)  # noqa: E731
  res = dict(
    manifest=[(e["family"], e["warmed"]) for e in w1["manifest"]], errors=w1["errors"] + w2["errors"], steady_compiles=s2["totals"]["steady_compiles"],
    families={f: dict(captures=fam(s2, f, "captures"), compiles=fam(s2, f, "compiles"), new_captures=fam(s2, f, "captures") - fam(s1, f, "captures"), new_replays=fam(s2, f, "replays") - fam(s1, f, "replays")) for f in BATCHED_FAMILIES},
  )
  log(f"[graphs] batched daemon: POST /v1/warmup twice -> manifest {res['manifest']}, errors {res['errors']}; after the second: steady_compiles {res['steady_compiles']}, per family {res['families']}")
  warmed = [f for f, ok in res["manifest"] if ok]
  if res["errors"] or res["steady_compiles"] or any(v["new_captures"] or v["captures"] != v["compiles"] for v in res["families"].values()) or any(not res["families"][f]["new_replays"] for f in warmed):
    raise SystemExit(f"chip_smoke: [graphs] batched daemon: the repeated warmup built or captured, or a family's captures differ from its builds: {res}")
  return res


def _interactive_burn(metrics, slo):
  """The SLO engine's interactive fast-window burn gauge, which the
  scheduler's mixed budget reads (None before the engine's first tick)."""
  return metrics.gauge_value("slo_burn_rate", labels={"class": "interactive", "window": f"{int(min(slo.slo_windows_s()))}s"})


def _hist_mean_ms(delta, name):
  """Count and mean (ms) of one unlabelled histogram in a registry delta."""
  h = delta["histograms"].get(name)
  n = sum(h["counts"]) if h else 0
  return dict(count=n, mean_ms=h["sum"] * 1e3 / n if n else None)


def _read_endpoints(port):
  """GET /metrics and /v1/slo on the daemon: both answer 200, the text
  carries the scheduler's and the SLO engine's series, the report is the
  local one with every class."""
  with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as resp:
    text = resp.read().decode()
  with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/slo", timeout=60) as resp:
    report = json.loads(resp.read())
  series = ("xot_tpu_qos_ttft_seconds_bucket", "xot_tpu_decode_chunk_seconds_count", "xot_tpu_slo_burn_rate", "xot_tpu_scheduler_batch_occupancy")
  missing = [x for x in series if x not in text]
  if missing or report.get("scope") != "local" or not report.get("enabled") or set(report.get("classes", {})) != {"interactive", "standard", "batch"}:
    raise SystemExit(f"chip_smoke: /metrics lacks {missing} or /v1/slo gave {str(report)[:300]}")
  std = report["classes"]["standard"]["windows"]
  fast = min(std, key=int)
  return dict(metrics_lines=len(text.splitlines()), slo_windows=sorted(std, key=int), standard_fast_window=dict(ttft=std[fast]["ttft"], itl=std[fast]["itl"], availability=std[fast]["availability"]))


def _batched_rows(torch, engine, B=BATCH_SLOTS, mp=16, quant="", extra_pages=0):
  """A pool holding B prefilled rows (prompt lengths 150..600, shuffled
  pages; ``extra_pages`` more after them): (pool, block tables, next
  tokens, positions)."""
  from xotorch_support_jetson_tpu_torch.models.decoder import prefill_into_pages_many
  from xotorch_support_jetson_tpu_torch.ops.paged import init_paged_pool

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
  pool = init_paged_pool(cfg, cfg.n_layers, B * mp + 1 + extra_pages, PAGE, quant=quant, device="cuda")
  bt = (torch.randperm(B * mp, generator=gen, device="cuda").to(torch.int32) + 1).reshape(B, mp)
  lens = torch.linspace(150, 600, B, device="cuda").to(torch.int32)
  toks = torch.randint(0, 256, (B, 640), generator=gen, device="cuda", dtype=torch.int32)
  zeros = torch.zeros(B, dtype=torch.int32, device="cuda")
  last, pool = prefill_into_pages_many(params, cfg, shard, toks, pool, bt, zeros, lens, PAGE)
  return pool, bt, last.argmax(-1).to(torch.int32)[:, None], lens


def check_batched_against_plain(torch, engine):
  """One batched decode step (B=8) through K3 and through the gather path
  (paged_gqa_attention_ref) on copies of the same pool, per pool type."""
  from xotorch_support_jetson_tpu_torch.models.decoder import paged_decode_forward

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  res = {}
  for kv, quant in KV_MODES.items():
    pool, bt, tok, lens = _batched_rows(torch, engine, quant=quant)
    out = {}
    for use_kernel in (True, False):
      copy = {k: v.clone() for k, v in pool.items()}
      out[use_kernel], _ = paged_decode_forward(params, cfg, shard, tok, lens[:, None], copy, bt, PAGE, use_kernel)
    got, want = out[True], out[False]
    if tuple(got.shape) != (BATCH_SLOTS, 1, cfg.vocab_size) or not torch.isfinite(got).all():
      raise SystemExit(f"chip_smoke: batched step logits: shape {tuple(got.shape)} or non-finite values")
    res[kv] = dict(rel_err=_rel_err(got, want), argmax_agree=float((got.argmax(-1) == want.argmax(-1)).float().mean()))
    # Same criterion as the solo check: bf16 over 16 layers, 5e-2 relative.
    if not res[kv]["rel_err"] < 5e-2:
      raise SystemExit(f"chip_smoke: batched decode step through K3 disagrees with the gather path ({kv}): {res[kv]}")
  return res


def check_window_against_plain(torch, engine):
  """The verify window of batched speculation at full width, per pool type:
  8 rows at lengths 150..600 (``_batched_rows``) each feed a W = 9 window
  (its next token and 8 seeded ones). ``paged_window_forward`` through K3
  must agree with the gather route on a copy of the pool, and with 9
  successive single-token ``paged_decode_forward`` steps fed the same
  tokens on another copy, within 5e-2 relative L2 of the logits (the
  criterion of the batched step check); the launch counters, zeroed just
  before the K3 window and read just after, must show K3 once per layer."""
  from xotorch_support_jetson_tpu_torch.models.decoder import paged_decode_forward, paged_window_forward
  from xotorch_support_jetson_tpu_torch.ops import paged

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
  W = VERIFY_W
  res = {}
  for kv, quant in KV_MODES.items():
    pool, bt, tok, lens = _batched_rows(torch, engine, quant=quant)
    window = torch.cat([tok, torch.randint(0, 256, (BATCH_SLOTS, W - 1), generator=gen, device="cuda", dtype=torch.int32)], dim=1)
    positions = lens[:, None] + torch.arange(W, dtype=torch.int32, device="cuda")[None, :]
    copies = [{k: v.clone() for k, v in pool.items()} for _ in range(3)]
    torch.cuda.synchronize()
    _reset_launches()
    got, _ = paged_window_forward(params, cfg, shard, window, positions, copies[0], bt, PAGE, True)
    torch.cuda.synchronize()
    launches = _launched("paged_decode")
    gathered, _ = paged_window_forward(params, cfg, shard, window, positions, copies[1], bt, PAGE, False)
    steps = torch.cat([paged_decode_forward(params, cfg, shard, window[:, j : j + 1], positions[:, j : j + 1], copies[2], bt, PAGE, True)[0] for j in range(W)], dim=1)
    if tuple(got.shape) != (BATCH_SLOTS, W, cfg.vocab_size) or not torch.isfinite(got).all():
      raise SystemExit(f"chip_smoke: verify window logits: shape {tuple(got.shape)} or non-finite values")
    res[kv] = dict(
      rel_err_gather=_rel_err(got, gathered), rel_err_steps=_rel_err(got, steps), k3_launches=launches,
      argmax_agree_steps=float((got.argmax(-1) == steps.argmax(-1)).float().mean()),
    )
    if not (res[kv]["rel_err_gather"] < 5e-2 and res[kv]["rel_err_steps"] < 5e-2) or launches != cfg.n_layers:
      raise SystemExit(f"chip_smoke: the verify window through K3 ({kv}, B={BATCH_SLOTS}, W={W}) disagrees or is not one K3 launch per layer: {res[kv]}")
  log(f"[batched] verify window B={BATCH_SLOTS} W={W} through K3 (rel L2 of logits against the gather route / against {W} single-token steps; K3 launches): {res}")
  return res




def check_spec_chunk_accepts(torch, engine):
  """One spec chunk that should accept (bf16 pool, 8 rows at lengths
  150..600, 8 rounds at depth 8): a plain 72-step greedy decode on a copy
  of the pool gives each row's stream, which ``fused_spec_paged_batch_decode``
  on another copy takes as its proposals. Accepted over proposed must reach
  0.9, and each row's emitted tokens must equal the plain stream up to the
  row's first divergence (where a bf16 window sum and a single-token sum
  round apart, the target's own greedy choice wins); the counters, zeroed
  just before the chunk and read just after, must show K3 once per layer
  per round."""
  from xotorch_support_jetson_tpu_torch.models.decoder import fused_paged_batch_decode, fused_spec_paged_batch_decode
  from xotorch_support_jetson_tpu_torch.ops import paged

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  pool, bt, tok, lens = _batched_rows(torch, engine)
  n = SPEC_ROUNDS * (SPEC_GAMMA + 1)
  active = torch.ones(BATCH_SLOTS, dtype=torch.bool, device="cuda")
  temps = torch.zeros(BATCH_SLOTS, dtype=torch.float32, device="cuda")
  plain, _, _, _ = fused_paged_batch_decode(params, cfg, shard, tok, {k: v.clone() for k, v in pool.items()}, bt, lens, active, temps, n, page_size=PAGE)
  gammas = torch.full((BATCH_SLOTS,), SPEC_GAMMA, dtype=torch.int32, device="cuda")
  prop_counts = torch.full((BATCH_SLOTS,), n, dtype=torch.int32, device="cuda")
  copy = {k: v.clone() for k, v in pool.items()}
  torch.cuda.synchronize()
  _reset_launches()
  buf, counts, n_prop, _, next_pos, _, _ = fused_spec_paged_batch_decode(
    params, cfg, shard, None, None, None, tok, copy, None, bt, lens, active, gammas, temps, SPEC_ROUNDS, SPEC_GAMMA, page_size=PAGE, props=plain, prop_counts=prop_counts,
  )
  torch.cuda.synchronize()
  launches = _launched("paged_decode")
  counts_l, buf_h, plain_h = counts.tolist(), buf.cpu().numpy(), plain.cpu().numpy()
  accepted, proposed = sum(c - SPEC_ROUNDS for c in counts_l), int(n_prop.sum())
  divergences = []
  for i, c in enumerate(counts_l):
    diff = np.nonzero(buf_h[i, :c] != plain_h[i, :c])[0]
    divergences.append(int(diff[0]) if len(diff) else None)
  res = dict(accepted=accepted, proposed=proposed, acceptance=accepted / max(proposed, 1), counts=counts_l, first_divergence=divergences, k3_launches=launches, positions_advanced=(next_pos - lens).tolist())
  log(f"[batched] spec chunk fed the plain greedy streams (B={BATCH_SLOTS}, {SPEC_ROUNDS} rounds, depth {SPEC_GAMMA}): accepted {accepted} of {proposed} proposed ({res['acceptance']:.3f}) | counts {counts_l} | first divergence from the plain stream {divergences} | K3 launches {launches}")
  # A row leaves the stream at its first divergence and accepts nothing
  # after it: its accepted tokens all lie before the divergence.
  off_stream = [i for i, (c, d) in enumerate(zip(counts_l, divergences)) if d is not None and c - SPEC_ROUNDS > d]
  if not res["acceptance"] >= 0.9 or launches != cfg.n_layers * SPEC_ROUNDS or res["positions_advanced"] != counts_l or off_stream:
    raise SystemExit(f"chip_smoke: the accepting spec chunk: {res}")
  return res


MIXED_PREFIX, MIXED_SLICE, MIXED_PAD = 1024, 200, 256  # the full-width mixed slice: tokens [1024, 1224), padded to 256


def _mixed_rows(torch, engine, quant=""):
  """``_batched_rows`` (B=8 decode rows) plus one admission whose first
  1024 prompt tokens are prefilled into 32 more pages, and the operands of
  its next mixed slice: (pool, bt, tok, lens, slice operands, prompt,
  admission pages)."""
  from xotorch_support_jetson_tpu_torch.models.decoder import prefill_into_pages_many

  B, mp = BATCH_SLOTS, 16
  pool, bt, tok, lens = _batched_rows(torch, engine, quant=quant, extra_pages=32)
  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
  prompt = torch.randint(0, 256, (1, MIXED_PREFIX + MIXED_SLICE + 64), generator=gen, device="cuda", dtype=torch.int32)
  adm = (torch.arange(32, device="cuda", dtype=torch.int32) + B * mp + 1)[None]
  one = lambda v: torch.tensor([v], dtype=torch.int32, device="cuda")  # noqa: E731
  prefill_into_pages_many(params, cfg, shard, prompt[:, :MIXED_PREFIX], pool, adm[:, :16], one(0), one(MIXED_PREFIX), PAGE)
  pf_tokens = torch.zeros((1, MIXED_PAD), dtype=torch.int32, device="cuda")
  pf_tokens[:, :MIXED_SLICE] = prompt[:, MIXED_PREFIX : MIXED_PREFIX + MIXED_SLICE]
  window = 1 << math.ceil(math.log2(-(-(MIXED_PREFIX + MIXED_PAD) // PAGE)))  # the scheduler's pow2 page window
  pf = dict(pf_tokens=pf_tokens, pf_bt=adm[:, :window].contiguous(), pf_prefix=one(MIXED_PREFIX), pf_end=one(MIXED_PREFIX + MIXED_SLICE))
  return pool, bt, tok, lens, pf, prompt, adm


def check_mixed_against_alternating(torch, engine):
  """One ``fused_mixed_paged_batch_decode`` call at full width (8 decode
  rows at lengths 150..600, one step; the admission's slice of 200 tokens
  at offset 1024, pad 256) against the alternating equivalent on a copy of
  the same pool: ``prefill_into_pages_many`` on the slice, then
  ``fused_paged_batch_decode``. The decode logits, and the logits of the
  admission's final 64 tokens prefilled over each pool, must agree within
  5e-2 relative L2; the launch counters, zeroed just before the fused call
  and read just after, must show K1 (the slice) and K3 (the decode half)."""
  from xotorch_support_jetson_tpu_torch.models import decoder
  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa, paged

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  pool, bt, tok, lens, pf, prompt, adm = _mixed_rows(torch, engine)
  active = torch.ones(BATCH_SLOTS, dtype=torch.bool, device="cuda")
  temps = torch.zeros(BATCH_SLOTS, dtype=torch.float32, device="cuda")
  seen = []
  plain_next = decoder._next_token_batched

  def capture(rows, *a, **kw):
    seen.append(rows.float().clone())
    return plain_next(rows, *a, **kw)

  one = lambda v: torch.tensor([v], dtype=torch.int32, device="cuda")  # noqa: E731
  end = MIXED_PREFIX + MIXED_SLICE
  final = prompt[:, end:]
  res = {}
  decoder._next_token_batched = capture
  try:
    pools = {"mixed": {k: v.clone() for k, v in pool.items()}, "alternating": {k: v.clone() for k, v in pool.items()}}
    torch.cuda.synchronize()
    _reset_launches()
    t_mixed = decoder.fused_mixed_paged_batch_decode(params, cfg, shard, tok, pools["mixed"], bt, lens, active, temps, n_steps=1, page_size=PAGE, **pf)[0]
    torch.cuda.synchronize()
    res["launches"] = {"flash_prefill": _launched("flash_prefill"), "paged_decode": _launched("paged_decode")}
    decoder.prefill_into_pages_many(params, cfg, shard, pf["pf_tokens"], pools["alternating"], pf["pf_bt"], pf["pf_prefix"], pf["pf_end"], PAGE)
    t_alt = decoder.fused_paged_batch_decode(params, cfg, shard, tok, pools["alternating"], bt, lens, active, temps, 1, page_size=PAGE)[0]
  finally:
    decoder._next_token_batched = plain_next
  got, want = seen[0], seen[-1]
  finals = [decoder.prefill_into_pages_many(params, cfg, shard, final, pools[k], adm, one(end), one(prompt.shape[1]), PAGE)[0] for k in ("mixed", "alternating")]
  res.update(
    decode_rel_err=_rel_err(got, want), decode_argmax_agree=float((t_mixed == t_alt).float().mean()),
    final_prefill_rel_err=_rel_err(finals[0], finals[1]), shapes=dict(B=BATCH_SLOTS, slice=MIXED_SLICE, pad=MIXED_PAD, offset=MIXED_PREFIX, window=int(pf["pf_bt"].shape[1]) * PAGE),
  )
  n_layers = cfg.n_layers
  log(f"[batched] mixed call vs alternating at full width (B={BATCH_SLOTS}, slice {MIXED_SLICE} tokens at offset {MIXED_PREFIX}, pad {MIXED_PAD}): decode logits rel L2 {res['decode_rel_err']:.3e}, greedy agree {res['decode_argmax_agree']:.3f}, final-prefill logits rel L2 {res['final_prefill_rel_err']:.3e} | launches in the mixed call {res['launches']}")
  if not (res["decode_rel_err"] < 5e-2 and res["final_prefill_rel_err"] < 5e-2) or not torch.isfinite(got).all():
    raise SystemExit(f"chip_smoke: the mixed call disagrees with the alternating one: {res}")
  if res["launches"] != {"flash_prefill": n_layers, "paged_decode": n_layers}:
    raise SystemExit(f"chip_smoke: the mixed call did not run K1 and K3 once per layer: {res['launches']}")
  return res


PROFILE_EAGER_REPS = 1  # an eager profile's repetitions: under torch.profiler each costs seconds, and the kernels repeat within a call


def profile_batched(torch, engine, steps=8):
  """One batched decode chunk (B=8, bf16 pool, prompts 150..600) through
  the engine's batch ops with K3, eagerly, ``PROFILE_EAGER_REPS`` calls:
  the eager side of the captured plain chunk in ``profile_batched_graphs``
  (the mixed and spec chunks are profiled captured only)."""
  pool, bt, tok, lens = _batched_rows(torch, engine)
  ops = engine.batch_ops
  active = torch.ones(BATCH_SLOTS, dtype=torch.bool, device="cuda")
  temps = torch.zeros(BATCH_SLOTS, dtype=torch.float32, device="cuda")
  top_ks = torch.full((BATCH_SLOTS,), 35, dtype=torch.int32, device="cuda")

  def chunk():
    ops.paged_batch_decode(tok, pool, bt, lens, active, temps, top_ks, steps, k_max=64, page_size=PAGE, key=SEED)

  return {"decode_k3": _profile(torch, f"batched decode chunk with K3, B={BATCH_SLOTS}, {steps} steps", chunk, PROFILE_EAGER_REPS)}


# ---------------------------------------------- 6b. batched graphs


def batched_traffic(ops, pool, seed, lens, page=PAGE, mp=16, steps=8, gamma=SPEC_GAMMA, slice_tokens=MIXED_SLICE, slice_pad=MIXED_PAD):
  """One round of the batched server's dispatches through ``ops`` (a
  ``DecoderBatchOps``) against ``pool``, whose rows hold ``mp`` pages of
  ``page`` tokens each (pages 1 … B·mp, shuffled) and one admission's pages
  after them. B is ``len(lens) + 1``: the prompts of ``lens`` tokens and an
  inactive last row (the padding row of the admission bucket). In order:
  the admission prefill (the bucket of B rows, sampling the first tokens);
  a plain chunk of ``steps`` steps; a plain chunk chained on its
  device-resident next token; a spec chunk of ``steps // 2`` rounds at
  depth ``gamma`` with n-gram proposals, chained on that; a chained spec
  chunk at depth ``gamma - 1`` without proposals (device positions too);
  and a mixed chunk of ``steps - 1`` steps (host positions) with a
  ``slice_tokens``-token slice of another prompt padded to ``slice_pad``.
  Rows 1, 4, … sample (temperature 0.8, top_k 5), the others are greedy.
  Every output is copied on the device right after its dispatch (before the
  next dispatch overwrites it) and returned as numpy, without what the
  server never reads: the padding row's first token and a spec chunk's
  slots past each row's count (an inactive row's window reads the trash
  page, which duplicate junk writes leave in any order)."""
  import torch

  rng = np.random.default_rng(seed)
  B = len(lens) + 1
  outs = []

  def keep(kind, *ts):
    outs.append((kind, [t.clone() for t in ts]))

  bt = (np.arange(B * mp, dtype=np.int32).reshape(B, mp) + 1)[rng.permutation(B)]
  lens = np.asarray([*lens, 1], np.int32)
  sampled = np.arange(B) % 3 == 1
  temps, top_ks = np.where(sampled, 0.8, 0.0).astype(np.float32), np.where(sampled, 5, 1).astype(np.int32)
  s_pad = -(-int(lens.max()) // 64) * 64
  window = 1 << math.ceil(math.log2(-(-s_pad // page)))
  tokens = np.zeros((B, s_pad), np.int32)
  bts = np.zeros((B, window), np.int32)
  for i in range(B - 1):
    tokens[i, : lens[i]] = rng.integers(3, 256, lens[i])
    bts[i] = bt[i, :window]
  firsts, pool = ops.prefill_into_pages_many_sampled(tokens, pool, bts, np.zeros(B, np.int32), lens, page, temps, top_ks, 64, seed)
  keep("prefill", firsts)
  active = np.arange(B) < B - 1
  tok = firsts.cpu().numpy().reshape(B, 1)
  tok[-1] = 7  # the inactive row holds its token
  pos = lens.copy()
  for key in (seed + 1, seed + 2):
    toks, nxt, npos, pool = ops.paged_batch_decode(tok, pool, bt, pos, active, temps, top_ks, steps, 64, page, key)
    keep("plain", toks, nxt, npos)
    tok, pos = nxt, (pos + steps * active).astype(np.int32)
  rounds = steps // 2
  width = rounds * (gamma + 1) + gamma
  props = rng.integers(3, 256, (B, width)).astype(np.int32)
  kinds = np.where(active & ~sampled, np.arange(B) % 3, -1)
  gammas = np.where(kinds >= 0, gamma, 0).astype(np.int32)
  counts = np.select([kinds == 0, kinds == 2], [width, 5], 0).astype(np.int32)
  res = ops.spec_paged_batch_decode(tok, pool, None, bt, pos, active, gammas, temps, top_ks, rounds, gamma, 64, page, seed + 3, props=props, prop_counts=counts)
  keep("spec", *res[:5])
  res = ops.spec_paged_batch_decode(res[3], pool, None, bt, res[4], active, np.maximum(gammas - 1, 0), temps, top_ks, rounds, gamma - 1, 64, page, seed + 4)
  keep("spec", *res[:5])
  pf_tokens = np.zeros((1, slice_pad), np.int32)
  pf_tokens[0, :slice_tokens] = rng.integers(3, 256, slice_tokens)
  pf_bt = (np.arange(-(-slice_pad // page), dtype=np.int32) + B * mp + 1)[None]
  toks, nxt, npos, pool = ops.mixed_paged_batch_decode(
    res[3], pool, bt, res[4].cpu().numpy(), active, temps, top_ks, steps - 1, 64, page, seed + 5,
    pf_tokens=pf_tokens, pf_bt=pf_bt, pf_prefix=np.array([0], np.int32), pf_end=np.array([slice_tokens], np.int32),
  )
  keep("mixed", toks, nxt, npos)
  read = []
  for kind, ts in outs:
    ts = [t.cpu().numpy() for t in ts]
    if kind == "prefill":
      ts = [ts[0][: B - 1]]
    if kind == "spec":
      ts[0] = np.where(np.arange(ts[0].shape[1])[None, :] < ts[1][:, None], ts[0], -1)
    read.append((kind, ts))
  return read


BATCHED_FAMILIES = ("prefill.pages_many_sampled", "decode.paged_batch", "decode.mixed_paged_batch", "spec.paged_batch")
GRAPH_LENS = [int(x) for x in np.linspace(150, 600, BATCH_SLOTS - 1)]  # 7 prompts and the bucket's padding row


def batched_graphs_against_eager(torch, engine, weights):
  """The batched dispatches captured against uncaptured at full width, per
  KV pool type (bf16, int8, int4 pages on bf16 weights; bf16 pages on int4
  weights): ``batched_traffic`` (B=8, 64-token pages, 16 a row, prompts
  150..600; plain chunks of 8 steps, spec chunks of 4 rounds at depth 8 and
  7, a mixed chunk with a 200-token slice) through the pool ``init_pool``
  made (one CUDA-graph replay per dispatch) and through the eager functions
  on an identical pool, in a round that builds every graph and one that
  replays them on other rows, positions, tables, proposals and keys. Every
  token must be identical, greedy and seeded sampled rows alike, each graph
  must hold its kernels (K3 in every chunk, K1 in the prefill and the
  slice on bf16 and int8 pages, K4 everywhere on int4 weights), and the
  replays must launch them (``REPLAYED``)."""
  from xotorch_support_jetson_tpu_torch.inference.batch_ops import DecoderBatchOps
  from xotorch_support_jetson_tpu_torch.utils import programs

  modes = KV_MODES if weights == "bf16" else {"bf16": ""}
  res = {}
  L = engine.cfg.n_layers
  for kv, quant in modes.items():
    os.environ["XOT_TPU_KV_QUANT"] = quant
    try:
      ops = DecoderBatchOps(engine)
      captured = ops.init_pool(BATCH_SLOTS * 16 + 1 + MIXED_PAD // PAGE, PAGE)
    finally:
      os.environ.pop("XOT_TPU_KV_QUANT", None)
    eager = {k: v.clone() for k, v in captured.items()}
    _reset_launches()
    n = 0
    for rnd, seed in enumerate((SEED + 20, SEED + 21)):
      got, want = batched_traffic(ops, captured, seed, GRAPH_LENS), batched_traffic(ops, eager, seed, GRAPH_LENS)
      for (kind, g), (_, w) in zip(got, want):
        n += 1
        if not all(np.array_equal(a, b) for a, b in zip(g, w)):
          raise SystemExit(f"chip_smoke: [graphs] batched {weights} weights, {kv} pages, round {rnd}: the captured {kind} dispatch differs from the uncaptured one:\n{g}\n{w}")
    graphs = ops.programs.graphs()
    by_family = {f: [dict(kernel_nodes=g.kernel_nodes, capture_s=g.capture_s, kernels=dict(g.kernels)) for g in graphs if g.family == f] for f in BATCHED_FAMILIES}
    replayed = dict(programs.REPLAYED)
    res[kv] = dict(dispatches=n, identical=True, graphs=by_family, replayed=replayed, pool_bytes=programs.pool_bytes(ops.programs.graph_pool))
    log(f"[graphs] batched {weights} weights, {kv} pages: {n} dispatches over 2 rounds (a build round, a replay round; greedy and sampled rows) token-identical to the uncaptured functions | graphs per family {{{', '.join(f'{f}: {len(v)}' for f, v in by_family.items())}}} | kernel nodes {[g.kernel_nodes for g in graphs]} | launches inside replays {replayed} | graph pool {res[kv]['pool_bytes']} bytes")
    k1 = 0 if quant == "int4" else L
    bad = [g.family for g in graphs if (g.family != "prefill.pages_many_sampled" and g.kernels.get("paged_decode", 0) < L) or (g.family in ("prefill.pages_many_sampled", "decode.mixed_paged_batch") and g.kernels.get("flash_prefill", 0) != k1) or ((weights == "int4") != (g.kernels.get("int4_matmul", 0) > 0))]
    if bad or sorted({g.family for g in graphs}) != sorted(BATCHED_FAMILIES) or not replayed.get("paged_decode"):
      raise SystemExit(f"chip_smoke: [graphs] batched {weights} weights, {kv} pages: graphs off their kernels {bad}: {by_family}, replayed {replayed}")
    del ops, captured, eager
    gc.collect()
    torch.cuda.empty_cache()
  return res


def profile_batched_graphs(torch, engine, smi, eager):
  """Wall and device ms of one dispatch per batched family, captured (one
  replay each, ``_replay_ms``: device from CUDA events around a call queued
  behind a spin kernel), with torch.profiler's device sum beside it, the
  graph's kernel nodes, its capture seconds and the graph pool's bytes; the
  same rows as ``profile_batched`` (the eager functions, ``eager``): a
  decode chunk (B=8, 8 steps), a mixed chunk (a 200-token slice at 1024),
  a spec chunk (8 rounds at depth 8), and an admission prefill (8 rows of
  256 tokens after a 128-token cached prefix)."""
  from xotorch_support_jetson_tpu_torch.models.decoder import BatchedPrograms
  from xotorch_support_jetson_tpu_torch.utils import programs

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  pool, bt, tok, lens = _batched_rows(torch, engine, extra_pages=8 * 6)
  progs = BatchedPrograms(params, cfg, shard, pool)
  B = BATCH_SLOTS
  active = np.ones(B, bool)
  temps, top_ks = np.zeros(B, np.float32), np.full(B, 35, np.int32)
  gammas = np.full(B, SPEC_GAMMA, np.int32)
  mpool, mbt, mtok, mlens, pf, _, _ = _mixed_rows(torch, engine)
  mprogs = BatchedPrograms(params, cfg, shard, mpool)
  adm_bt = (np.arange(B * 6, dtype=np.int32) + B * 16 + 1).reshape(B, 6)
  adm_bt = np.concatenate([adm_bt, np.zeros((B, 2), np.int32)], axis=1)  # the page window rounds 6 pages up to 8
  adm_tokens = np.random.default_rng(SEED + 23).integers(3, 256, (B, 256)).astype(np.int32)
  pre = np.full(B, 2 * PAGE, np.int32)
  fns = {
    "decode.paged_batch": (progs, lambda: progs.decode(tok, bt, lens, active, temps, top_ks, 8, 64, PAGE, SEED), "decode_k3"),
    "decode.mixed_paged_batch": (mprogs, lambda: mprogs.mixed(mtok, mbt, mlens, active, temps, top_ks, 8, 64, PAGE, SEED, **pf), "mixed_k1_k3"),
    "spec.paged_batch": (progs, lambda: progs.spec(tok, bt, lens, active, gammas, temps, top_ks, SPEC_ROUNDS, SPEC_GAMMA, 64, PAGE, SEED), "spec_k3"),
    "prefill.pages_many_sampled": (progs, lambda: progs.prefill(adm_tokens, adm_bt, pre, pre + 256, PAGE, temps, top_ks, 64, SEED), None),
  }
  res = {}
  for fam, (owner, fn, eager_key) in fns.items():
    wall, device = _replay_ms(torch, fn, 1)
    prof = _profile(torch, f"graphs batched {fam} (one replay a call)", fn, 3)
    graph = next(g for g in owner.graphs() if g.family == fam)
    e = eager.get(eager_key) if eager_key else None
    res[fam] = dict(
      captured_wall_ms=wall, captured_device_ms=device, captured_profiler_device_ms=prof["device_ms"] or None, kernel_nodes=graph.kernel_nodes, capture_s=graph.capture_s,
      eager_wall_ms=e["wall_ms"] if e else None, eager_device_ms=e["device_ms"] if e else None, eager_launches=e["launches"] if e else None,
    )
    seen = "not measured (no device events)" if not prof["device_ms"] else f"{prof['device_ms']:.3f} ms"
    eager_txt = f" | eager wall {e['wall_ms']:.3f} ms, device {e['device_ms']:.3f} ms, {e['launches']:.0f} launches" if e else ""
    log(f"[profile] graphs batched {fam}: captured wall {wall:.3f} ms, device {device:.3f} ms (wall/device {wall / device:.3f}; profiler's device sum {seen}) | {graph.kernel_nodes} kernel nodes, capture {graph.capture_s:.3f} s{eager_txt} | {smi}")
  res["graph_pool_bytes"] = {"rows pool": programs.pool_bytes(progs.graph_pool), "mixed pool": programs.pool_bytes(mprogs.graph_pool)}
  log(f"[profile] graphs batched: graph memory pools {res['graph_pool_bytes']} bytes")
  del progs, mprogs, pool, mpool
  gc.collect()
  torch.cuda.empty_cache()
  return res


# ------------------------------------------------- 7. tiered batched serving

TIER_PAGES = 32  # pages per round trip: 2,048 tokens at 64-token pages
TIER_PROMPT, TIER_SUFFIX = 1536, 64  # the model-level restore: a 24-page prefix, then one page more
TIER_POOL_PAGES = 257  # XOT_TPU_BATCH_PAGES of the multi-turn pass: 256 usable pages (16,384 tokens)
TIER_CONVERSATIONS, TIER_ANSWER, TIER_FOLLOWUP = 16, 32, 64
TIER_SPIN_CYCLES = 200_000_000  # ~0.1 s on the card: longer than any copy's host-side staging


def _stream_ms(torch, fn, end_stream=None, reps=3):
  """Median device ms from the compute stream reaching ``fn``'s work to
  ``end_stream`` (default: the compute stream) finishing it, with CUDA
  events. A spin kernel ahead of each rep lets the host stage and enqueue
  everything before the card gets there, so host-side staging (a pinned
  stack, index uploads) is not counted as device time."""
  times = []
  for _ in range(reps):
    torch.cuda.synchronize()
    torch.cuda._sleep(TIER_SPIN_CYCLES)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record(end_stream if end_stream is not None else torch.cuda.current_stream())
    end.synchronize()
    times.append(start.elapsed_time(end))
  return sorted(times)[len(times) // 2]


def _filled_pool(torch, cfg, n_layers, kv, n_pages, gen):
  """A page pool at ``cfg``'s geometry filled from ``gen``: bf16 values, or
  int8 / packed int4 codes with f32 scales."""
  from xotorch_support_jetson_tpu_torch.ops.paged import init_paged_pool

  pool = init_paged_pool(cfg, n_layers, n_pages, PAGE, dtype=torch.bfloat16, quant=KV_MODES[kv], device="cuda")
  for name, leaf in pool.items():
    if name.endswith("_scale"):
      leaf.uniform_(0.005, 0.05, generator=gen)
    elif leaf.dtype == torch.int8:
      leaf.copy_(torch.randint(-128, 128, leaf.shape, generator=gen, device="cuda", dtype=torch.int8))
    else:
      leaf.normal_(generator=gen)
  return pool


def tier_round_trip(torch, ops, cfg, n_layers, kv, n=TIER_PAGES, seed=SEED + 3):
  """The host KV tier's page round trip on the card: ``n`` pages of a
  seeded pool spill through ``KvTierManager`` with the real
  ``ops.read_pages`` and restore into ``n`` other pages with the real
  ``ops.write_pages``. Checks every leaf ``torch.equal`` to the source
  pages, the host entries pageable (only staging is pinned), and one K3
  step per layer over block tables on the restored pages bit-identical to
  the same step on the originals (four rows of n/4 pages). Times the
  spill's host enqueue, the device ms of the spill (gather + D2H) and of the
  restore (H2D + scatter), and a plain pinned copy of the same bytes each
  way (the link's bound)."""
  from xotorch_support_jetson_tpu_torch.inference.kv_tier import KvTierManager
  from xotorch_support_jetson_tpu_torch.ops import paged

  gen = torch.Generator(device="cuda").manual_seed(seed)
  pool = _filled_pool(torch, cfg, n_layers, kv, 2 * n + 1, gen)
  perm = (torch.randperm(2 * n, generator=gen, device="cuda") + 1).tolist()
  src, dst = perm[:n], perm[n:]
  tier = KvTierManager(page_size=PAGE, read_pages=lambda p: ops.read_pages(pool, p), write_pages=lambda p, d: ops.write_pages(pool, p, d), budget_bytes=1 << 40)
  tier.kv_quant = KV_MODES[kv]
  keys = [f"{kv}-{i}".encode() for i in range(n)]
  golden = {name: leaf[:, src].clone() for name, leaf in pool.items()}
  tier.spill([(b"warm-" + k, p) for k, p in zip(keys, src)])  # the first pinned blocks and the copy stream
  tier.restore_into([b"warm-" + k for k in keys], dst)
  torch.cuda.synchronize()
  for leaf in pool.values():
    leaf[:, dst] = 0
  t0 = time.perf_counter()
  tier.spill(list(zip(keys, src)))
  spill_host_ms = (time.perf_counter() - t0) * 1e3
  t0 = time.perf_counter()
  tier.restore_into(keys, dst)  # materializes the pending spill (waits on its copy), stacks, enqueues
  restore_host_ms = (time.perf_counter() - t0) * 1e3
  torch.cuda.synchronize()
  leaves_equal = {name: bool(torch.equal(pool[name][:, dst], golden[name])) for name in pool}
  entry = tier._entries[keys[0]]["data"]
  pageable = not any(t.is_pinned() for t in entry.values())
  entries_equal = all(torch.equal(tier._entries[k]["data"][name].cuda(), golden[name][:, i]) for i, k in enumerate(keys) for name in pool)
  rows = 4
  bt_src = torch.tensor(src, dtype=torch.int32, device="cuda").reshape(rows, n // rows)
  bt_dst = torch.tensor(dst, dtype=torch.int32, device="cuda").reshape(rows, n // rows)
  lens = torch.full((rows,), (n // rows) * PAGE, dtype=torch.int32, device="cuda")
  q = torch.randn((rows, cfg.n_heads, cfg.head_dim), generator=gen, device="cuda").to(torch.bfloat16)
  k3_equal = True
  for layer in range(n_layers):
    scales = dict(k_scale_pool_l=pool["k_scale"][layer], v_scale_pool_l=pool["v_scale"][layer]) if "k_scale" in pool else {}
    a = paged.paged_decode_attention(q, pool["k"][layer], pool["v"][layer], bt_src, lens, PAGE, **scales)
    b = paged.paged_decode_attention(q, pool["k"][layer], pool["v"][layer], bt_dst, lens, PAGE, **scales)
    k3_equal = k3_equal and bool(torch.isfinite(a).all()) and bool(torch.equal(a, b))
  page_bytes = tier.stats()["page_nbytes"]
  nbytes = n * page_bytes
  spill_ms = _stream_ms(torch, lambda: ops.read_pages(pool, src), end_stream=ops._copy_stream)
  restore_ms = _stream_ms(torch, lambda: tier.restore_into(keys, dst))
  dbuf = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
  hbuf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
  link_d2h_ms = _stream_ms(torch, lambda: hbuf.copy_(dbuf, non_blocking=True))
  link_h2d_ms = _stream_ms(torch, lambda: dbuf.copy_(hbuf, non_blocking=True))
  gbs = lambda ms: nbytes / (ms * 1e6)  # noqa: E731
  res = dict(
    kv=kv, pages=n, page_bytes=page_bytes, bytes=nbytes, leaves_equal=leaves_equal, host_entries_equal=entries_equal, host_entries_pageable=pageable,
    k3_bit_identical=k3_equal, k3_rows=rows, k3_window=(n // rows) * PAGE, spill_enqueue_host_ms=spill_host_ms, restore_host_ms=restore_host_ms,
    spill_device_ms=spill_ms, restore_device_ms=restore_ms, spill_ms_per_page=spill_ms / n, restore_ms_per_page=restore_ms / n,
    spill_gb_s=gbs(spill_ms), restore_gb_s=gbs(restore_ms), link_d2h_ms=link_d2h_ms, link_h2d_ms=link_h2d_ms, link_d2h_gb_s=gbs(link_d2h_ms), link_h2d_gb_s=gbs(link_h2d_ms),
  )
  del pool, dbuf, hbuf
  tier.clear()
  return res


def tier_prefill_ms(torch, engine, n=TIER_PAGES):
  """Device ms of prefilling the tokens ``n`` pages hold (one row of
  ``n * PAGE`` tokens, K1 in every layer): what restoring them saves."""
  from xotorch_support_jetson_tpu_torch.models.decoder import prefill_into_pages_many
  from xotorch_support_jetson_tpu_torch.ops.paged import init_paged_pool

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
  pool = init_paged_pool(cfg, cfg.n_layers, n + 1, PAGE, quant="", device="cuda")
  toks = torch.randint(0, 256, (1, n * PAGE), generator=gen, device="cuda", dtype=torch.int32)
  bt = torch.arange(1, n + 1, dtype=torch.int32, device="cuda")[None]
  zero, end = torch.zeros(1, dtype=torch.int32, device="cuda"), torch.full((1,), n * PAGE, dtype=torch.int32, device="cuda")
  run = lambda: prefill_into_pages_many(params, cfg, shard, toks, pool, bt, zero, end, PAGE)  # noqa: E731
  run()
  return _stream_ms(torch, run)


async def tier_restore_logits(torch, engine):
  """The restore on the served path: one 1,536-token prompt prefills into
  the daemon's pool (its 24 full pages donated to the prefix cache); the
  prompt plus a 64-token suffix admits over those cached pages (the
  never-evicted run); an eviction run then forces every cached page out
  (the spill hook fires); the same prompt plus suffix admits again and
  restores the 24 pages from the host. The suffix prefill's last logits of
  the two admissions must be bit-identical (the same K1 prefill over the
  same bytes), and the second must have restored 24 pages. The served
  prefill is a graph replay whose logits stay inside the graph, so each
  admission's dispatch is also run, with its exact operands, through the
  uncaptured ``prefill_into_pages_many`` on a copy of the pool as the
  dispatch finds it; K1's launches are counted around the served call
  alone."""
  from xotorch_support_jetson_tpu_torch.models import decoder
  from xotorch_support_jetson_tpu_torch.utils.metrics import metrics

  bserver = engine.get_batched_server()
  rng = np.random.default_rng(SEED + 5)
  prompt = [ByteTokenizer.bos_token_id] + rng.integers(32, 127, TIER_PROMPT - 1).tolist()
  longer = prompt + rng.integers(32, 127, TIER_SUFFIX).tolist()
  seen, k1s = [], []
  ops = bserver.ops
  served = ops.prefill_into_pages_many_sampled

  def spy(tokens, pool, bt_rows, prefix_lens, prompt_lens, page_size, *rest):
    dev = lambda x: torch.from_numpy(np.asarray(x)).cuda()  # noqa: E731
    copy = {k: v.clone() for k, v in pool.items()}
    logits, _ = decoder.prefill_into_pages_many(engine.params, engine.cfg, engine._effective_shard, dev(tokens), copy, dev(bt_rows), dev(prefix_lens), dev(prompt_lens), page_size)
    seen.append(logits.float())
    del copy
    k1 = _launched("flash_prefill")
    out = served(tokens, pool, bt_rows, prefix_lens, prompt_lens, page_size, *rest)
    k1s.append(_launched("flash_prefill") - k1)
    return out

  async def admit(rid, toks):
    r0 = metrics.counter_value("kv_tier_restored_pages_total")
    n_seen = len(seen)
    await bserver.submit(rid, np.asarray(toks, np.int32), max_tokens=1, temp=0.0, top_k=1, eos_ids=(), emit=lambda *a: None)
    return seen[n_seen], k1s[n_seen], metrics.counter_value("kv_tier_restored_pages_total") - r0

  ops.prefill_into_pages_many_sampled = spy
  try:
    await admit("tier-prompt", prompt)
    cached, k1_cached, _ = await admit("tier-cached", longer)
    s0 = metrics.counter_value("kv_tier_spilled_pages_total")
    alloc = bserver.allocator
    evicted = alloc.n_available - alloc.n_free
    alloc.free(alloc.alloc(alloc.n_available))  # an eviction run over every cached page
    spilled = metrics.counter_value("kv_tier_spilled_pages_total") - s0
    restored_logits, k1_restored, restored = await admit("tier-restored", longer)
  finally:
    del ops.prefill_into_pages_many_sampled
  res = dict(
    prompt_tokens=TIER_PROMPT, suffix_tokens=TIER_SUFFIX, evicted_pages=evicted, spilled_pages=spilled, restored_pages=restored,
    logits_bit_identical=bool(torch.equal(cached, restored_logits)), max_abs_diff=float((cached - restored_logits).abs().max()),
    k1_launches=dict(cached=k1_cached, restored=k1_restored), host=bserver.tier.stats(),
  )
  log(f"[tiered] restore on the served path: a {TIER_PROMPT}-token prompt, then it plus {TIER_SUFFIX} tokens over its cached pages, then an eviction run ({evicted} cached pages, {spilled:.0f} spilled) and the same admission again: {restored:.0f} pages restored, suffix-prefill logits bit-identical {res['logits_bit_identical']} (max |diff| {res['max_abs_diff']:.3e}), K1 launches {res['k1_launches']}")
  need = TIER_PROMPT // PAGE
  if not res["logits_bit_identical"] or restored != need or spilled < need or k1_cached != engine.cfg.n_layers or k1_restored != engine.cfg.n_layers:
    raise SystemExit(f"chip_smoke: the restored prefix did not serve like the cached one: {res}")
  return res


def tier_bodies(turn1_replies=None):
  """The multi-turn traffic: 16 conversations. Turn 1 is a distinct prompt
  of 1,024 to 1,504 tokens (byte tokens: BOS, the chat template, and
  ``conversation i:`` first, so no two share a page) with a greedy
  32-token answer: about 330 pages of history against the pass's 256. Turn 2 (given turn 1's replies) carries the turn-1
  message, the answer text and a 64-token follow-up."""
  words = "a quiet harbour keeps its boats tied while the tide turns and gulls argue over the morning catch".split()
  bodies = []
  for i in range(TIER_CONVERSATIONS):
    size = 1001 + 32 * i  # plus BOS, "<|user|>" and "\n<|assistant|>": 1,024 + 32 i tokens
    text = f"conversation {i}: " + " ".join(words[(i + j) % len(words)] for j in range(size))
    msgs = [{"role": "user", "content": text[:size]}]
    if turn1_replies is not None:
      follow = f"follow-up {i}: " + " ".join(words[(3 * i + j) % len(words)] for j in range(TIER_FOLLOWUP))
      msgs += [{"role": "assistant", "content": turn1_replies[i][0]}, {"role": "user", "content": follow[:TIER_FOLLOWUP]}]
    bodies.append({"model": "llama-3.2-1b", "messages": msgs, "stream": True, "temperature": 0, "max_tokens": TIER_ANSWER})
  return bodies


def _spy_admissions(bserver, records):
  """Record each admission the scheduler prepares (request id, prompt ids
  — the absorbed stream of a resumed row —, carried tokens, and the prefix
  its pages cover: device hits plus host restores) until the returned
  function removes the spy."""
  orig = bserver._prepare

  def spy(req, row, **kw):
    status, r = orig(req, row, **kw)
    if r is not None:
      records.append(dict(rid=req.request_id, tokens=[int(t) for t in req.tokens], carry=len(req.carry_tokens), prefix=r.prefix_len))
    return status, r

  bserver._prepare = spy
  return lambda: delattr(bserver, "_prepare")


def _read_kv_tier(port):
  with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/kv/tier", timeout=60) as resp:
    return json.loads(resp.read())


def _tier_failures(metrics):
  return {k: metrics.counter_sum(k) for k in ("kv_tier_spill_failures_total", "kv_tier_restore_failures_total")}


def _lcp(a, b):
  n = 0
  for x, y in zip(a, b):
    if x != y:
      break
    n += 1
  return n


async def _tier_turns(torch, engine, port, clients, ids, name):
  """Both turns of the multi-turn traffic through the daemon, the launch
  counters zeroed just before and read just after. Returns per-turn TTFT,
  prefix pages per turn-2 admission against the pages its token ids could
  match, the tier's traffic and the turn-2 token ids."""
  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa, int4_matmul as k4, paged
  from xotorch_support_jetson_tpu_torch.utils.metrics import metrics, snapshot_delta

  loop = asyncio.get_running_loop()
  warm = {"model": "llama-3.2-1b", "messages": [{"role": "user", "content": "warm up"}], "stream": True, "temperature": 0, "max_tokens": 9}
  await loop.run_in_executor(clients, _post, port, warm)
  bserver = engine.get_batched_server()
  records: list[dict] = []
  unspy = _spy_admissions(bserver, records)
  snap0 = metrics.snapshot()
  _reset_launches()  # ---- this pass's main path, counted
  t0 = time.perf_counter()
  turn1 = await asyncio.gather(*(loop.run_in_executor(clients, _post, port, b) for b in tier_bodies()))
  t1 = time.perf_counter()
  second = [loop.run_in_executor(clients, _post, port, b) for b in tier_bodies(turn1)]
  mid = await asyncio.to_thread(_read_kv_tier, port)
  turn2 = await asyncio.gather(*second)
  wall = time.perf_counter() - t0
  launches = {"flash_prefill": _launched("flash_prefill"), "flash_decode": _launched("flash_decode"), "paged_decode": _launched("paged_decode"), "int4_matmul": _launched("int4_matmul")}  # ---- read just after
  unspy()
  full_delta = snapshot_delta(snap0, metrics.snapshot())
  delta = full_delta["counters"]
  host_ms = {h: _hist_mean_ms(full_delta, h) for h in ("kv_tier_spill_seconds", "kv_tier_restore_seconds", "prefill_chunk_seconds", "mixed_tick_seconds", "decode_chunk_seconds")}
  by_rid = {r["rid"]: r for r in records}
  for turn, replies in ((1, turn1), (2, turn2)):
    for text, finish, ttft, total, n_events, rid in replies:
      toks = ids.get(rid, [])
      if not toks or len(toks) > TIER_ANSWER or finish not in ("stop", "length") or (finish == "length" and len(toks) != TIER_ANSWER) or rid not in by_rid:
        raise SystemExit(f"chip_smoke: tiered {name}, turn {turn}: request {rid} gave {len(toks)} of {TIER_ANSWER} tokens, finish {finish}")
  matchable = []
  for r1, r2 in zip(turn1, turn2):
    a1, a2 = by_rid[r1[5]], by_rid[r2[5]]
    history = a1["tokens"] + ids[r1[5]]
    donated = len(history) - 1  # the turn-1 row's written KV: its last token has none
    matchable.append(min(_lcp(a2["tokens"], history), donated, len(a2["tokens"]) - 1) // PAGE)
  prefix_pages = [by_rid[r[5]]["prefix"] // PAGE for r in turn2]
  tier = bserver.tier
  res = dict(
    kv_tier=tier is not None, conversations=TIER_CONVERSATIONS, pool_pages=bserver.allocator.n_pages, wall_s=wall, turn1_s=t1 - t0,
    turn1_prompt_tokens=[len(by_rid[r[5]]["tokens"]) for r in turn1], turn2_prompt_tokens=[len(by_rid[r[5]]["tokens"]) for r in turn2],
    ttft_turn1_p50_s=_pctl([r[2] for r in turn1], 0.5), ttft_turn2_p50_s=_pctl([r[2] for r in turn2], 0.5), ttft_turn2_p95_s=_pctl([r[2] for r in turn2], 0.95),
    turn2_prefix_pages=sum(prefix_pages), turn2_matchable_pages=sum(matchable), turn2_prefill_tokens_skipped=sum(p * PAGE for p in prefix_pages),
    spilled_pages=delta.get("kv_tier_spilled_pages_total", 0.0), restored_pages=delta.get("kv_tier_restored_pages_total", 0.0),
    host_evictions=delta.get("kv_tier_host_evictions_total", 0.0), failures=_tier_failures(metrics),
    host_mib=(tier.host_bytes / 2**20) if tier is not None else 0.0, host_pages=tier.host_pages if tier is not None else 0,
    mid_pass_endpoint=dict(host=mid["host"], spilled_pages_total=mid["spilled_pages_total"], restored_pages_total=mid["restored_pages_total"], enabled=mid["enabled"]),
    launches=launches, scheduler_ms=host_ms,
    turn2_ids=[ids[r[5]] for r in turn2],
  )
  log(f"[tiered] pass={name}: {2 * TIER_CONVERSATIONS} streaming requests in {wall:.3f} s (turn 1 {res['turn1_s']:.3f} s) | turn-1 TTFT p50 {res['ttft_turn1_p50_s']:.4f} s | turn-2 TTFT p50 {res['ttft_turn2_p50_s']:.4f} s p95 {res['ttft_turn2_p95_s']:.4f} s | turn-2 prefix pages {res['turn2_prefix_pages']} of {res['turn2_matchable_pages']} the token ids could match ({res['turn2_prefill_tokens_skipped']} prefill tokens skipped) | spilled {res['spilled_pages']:.0f} restored {res['restored_pages']:.0f} host evictions {res['host_evictions']:.0f} pages | host store {res['host_pages']} pages, {res['host_mib']:.1f} MiB | failures {res['failures']} | GET /v1/kv/tier mid-pass: {res['mid_pass_endpoint']} | launches {launches} | pool {res['pool_pages']} pages | host ms (registry, mean over the pass): {', '.join(f"{h} {v['mean_ms']} x{v['count']}" for h, v in host_ms.items())}")
  bad = [k for k, v in res["failures"].items() if v]
  if res["kv_tier"]:
    if not (res["spilled_pages"] > 0 and res["restored_pages"] > 0) or bad or launches["flash_prefill"] == 0 or launches["paged_decode"] == 0 or not mid["host"]["host_pages"] > 0:
      raise SystemExit(f"chip_smoke: tiered {name}: spilled {res['spilled_pages']}, restored {res['restored_pages']}, failures {res['failures']}, launches {launches}, mid-pass host pages {mid['host']}")
  elif res["spilled_pages"] or res["restored_pages"] or mid["enabled"]:
    raise SystemExit(f"chip_smoke: tiered {name}: XOT_TPU_KV_TIER=0 moved pages or reads enabled: {res['spilled_pages']}, {res['restored_pages']}, {mid}")
  if bserver.busy() or bserver.allocator.audit()["referenced"]:
    raise SystemExit(f"chip_smoke: tiered {name}: the server did not drain: {bserver.allocator.audit()}")
  return res


def phase_tiered(torch, ckpt: Path):
  """The batched daemon at the defaults (the host KV tier on) with
  XOT_TPU_BATCH_PAGES=257: the page round trip per pool type, the restore
  on the served path, then the multi-turn traffic with the tier on and
  with XOT_TPU_KV_TIER=0."""
  from xotorch_support_jetson_tpu_torch import main as tmain

  args, port = _daemon_args(tmain, ckpt)
  os.environ.update(XOT_TPU_BATCHED="1", XOT_TPU_BATCH_SLOTS=str(BATCH_SLOTS), XOT_TPU_PAGE_SIZE=str(PAGE), XOT_TPU_BATCH_PAGES=str(TIER_POOL_PAGES))
  try:
    return asyncio.run(_serve_tiered(torch, tmain, args, port))
  finally:
    for knob in ("XOT_TPU_BATCHED", "XOT_TPU_BATCH_SLOTS", "XOT_TPU_PAGE_SIZE", "XOT_TPU_BATCH_PAGES", "XOT_TPU_KV_TIER"):
      os.environ.pop(knob, None)
    gc.collect()
    torch.cuda.empty_cache()


async def _serve_tiered(torch, tmain, args, port):
  from concurrent.futures import ThreadPoolExecutor

  from xotorch_support_jetson_tpu_torch.inference.shard import Shard

  node, api, engine, _ = tmain.build_components(args, tokenizer=ByteTokenizer())
  await node.start()
  server = await api.run(host="127.0.0.1", port=port)
  clients = ThreadPoolExecutor(max_workers=TIER_CONVERSATIONS)
  try:
    await engine.ensure_shard(Shard("llama-3.2-1b", 0, 15, 16))
    out = {"round_trip": {}}
    prefill_ms = tier_prefill_ms(torch, engine)
    for kv in KV_MODES:
      r = tier_round_trip(torch, engine.batch_ops, engine.cfg, engine.cfg.n_layers, kv)
      r["prefill_device_ms_same_tokens"] = prefill_ms
      out["round_trip"][kv] = r
      log(f"[tiered] round trip {kv}: {r['pages']} pages of {r['page_bytes']} bytes | every leaf equal {r['leaves_equal']}, host entries equal {r['host_entries_equal']} and pageable {r['host_entries_pageable']} | K3 over the restored pages bit-identical {r['k3_bit_identical']} ({r['k3_rows']} rows at {r['k3_window']} tokens, every layer) | spill: host enqueue {r['spill_enqueue_host_ms']:.3f} ms, device {r['spill_device_ms']:.4f} ms ({r['spill_ms_per_page']:.5f} ms/page, {r['spill_gb_s']:.2f} GB/s) | restore: host {r['restore_host_ms']:.3f} ms, device {r['restore_device_ms']:.4f} ms ({r['restore_ms_per_page']:.5f} ms/page, {r['restore_gb_s']:.2f} GB/s) | plain pinned copy of the same bytes: D2H {r['link_d2h_ms']:.4f} ms ({r['link_d2h_gb_s']:.2f} GB/s), H2D {r['link_h2d_ms']:.4f} ms ({r['link_h2d_gb_s']:.2f} GB/s) | prefill of the {r['pages'] * PAGE} tokens they hold: {prefill_ms:.4f} ms of device time")
      if not (all(r["leaves_equal"].values()) and r["host_entries_equal"] and r["host_entries_pageable"] and r["k3_bit_identical"]):
        raise SystemExit(f"chip_smoke: the {kv} page round trip through the host tier is not byte-identical: {r}")
    out["restore"] = await tier_restore_logits(torch, engine)
    ids: dict[str, list[int]] = {}
    node.on_token.register("chip_smoke").on_next(lambda rid, toks, fin: ids.setdefault(rid, []).extend(toks))
    out["passes"] = {}
    # In turns (on, off, off, on): host-bound TTFT moves between passes, and
    # when the 16 simultaneous requests reach the first admission pass decides
    # how the rest are sliced. The first tier-on pass is the counted main path.
    for name, env in (("tier_on", {}), ("tier_off", {"XOT_TPU_KV_TIER": "0"}), ("tier_off_2", {"XOT_TPU_KV_TIER": "0"}), ("tier_on_2", {})):
      engine._drop_batched_server()  # a fresh pool and tier for this pass
      os.environ.pop("XOT_TPU_KV_TIER", None)
      os.environ.update(env)
      out["passes"][name] = await _tier_turns(torch, engine, port, clients, ids, name)
    node.on_token.deregister("chip_smoke")
    turn2 = {k: p.pop("turn2_ids") for k, p in out["passes"].items()}

    def agree(a, b):
      return sum(x == y for r, q in zip(turn2[a], turn2[b]) for x, y in zip(r, q)) / sum(max(len(r), len(q)) for r, q in zip(turn2[a], turn2[b]))

    out["turn2_greedy_agreement"] = {"tier_on_vs_off": agree("tier_on", "tier_off"), "tier_on_vs_on": agree("tier_on", "tier_on_2"), "tier_off_vs_off": agree("tier_off", "tier_off_2")}
    log(f"[tiered] share of turn-2 greedy tokens that agree (not gated: decode-written bf16 KV differs in its last bits from a full prefill's, and slicing varies between passes): {out['turn2_greedy_agreement']}")
    log(f"[tiered] turn-2 TTFT p50 / p95 s in turns: {[(k, round(p['ttft_turn2_p50_s'], 4), round(p['ttft_turn2_p95_s'], 4)) for k, p in out['passes'].items()]}")
    return out
  finally:
    await node.stop()
    await asyncio.to_thread(clients.shutdown, True)  # off the loop: requests still in flight get their answers
    server.close()
    await server.wait_closed()
    engine.executor.shutdown(wait=True)


# ------------------------------------------------- 9. gemma2 (gemma-2-9b)

GEMMA_MAX_SEQ = 8192  # XOT_TPU_MAX_SEQ of the gemma2 daemon: room beyond the 4,096-token window
GEMMA_LONG_TOKENS = 6000  # the long prompt (bucket 6016): every query past 4,096 slides on the even layers
GEMMA_LONG_HEAD = 2000  # its first tokens are text of another kind, so the window changes what the last query attends
GEMMA_ANSWER = 32
GEMMA_LONG_ANSWER = 16
GEMMA_CHECK_TOL = 5e-2  # relative L2 of the served logits against the plain f32 forward (PERF.md §2's tolerance)
GEMMA_MODEL = "gemma2-9b"
# 8 of gemma-2-9b's 42 layers (4 sliding, 4 global): every check of the
# phase runs at full width, and the MoE phase gets the time the cut frees
# within the run's 1,200 s (``scripts/gemma2_phase.py --layers 42`` runs
# the full depth).
GEMMA_LAYERS = 8


def write_gemma_checkpoint(torch, path: Path, seed: int = SEED + 9, layers: int = GEMMA_LAYERS) -> float:
  """Seeded random bf16 weights at gemma-2-9b's shapes and ``layers`` of its
  depth, HF names, one .safetensors file written tensor by tensor (the
  weights never sit in host memory at once). N(0, 1/fan_in) projections,
  N(0, 0.02) embeddings, zero-centred norm gains N(0, 0.05)."""
  import struct

  t0 = time.perf_counter()
  c = dict(GEMMA_2_9B, num_hidden_layers=layers)
  D, F_, V, L = c["hidden_size"], c["intermediate_size"], c["vocab_size"], c["num_hidden_layers"]
  qd, kd = c["num_attention_heads"] * c["head_dim"], c["num_key_value_heads"] * c["head_dim"]
  shapes = {"model.embed_tokens.weight": (V, D), "model.norm.weight": (D,)}
  for i in range(L):
    p = f"model.layers.{i}."
    shapes.update({p + n: (D,) for n in ("input_layernorm.weight", "post_attention_layernorm.weight", "pre_feedforward_layernorm.weight", "post_feedforward_layernorm.weight")})
    shapes.update({
      p + "self_attn.q_proj.weight": (qd, D), p + "self_attn.k_proj.weight": (kd, D), p + "self_attn.v_proj.weight": (kd, D), p + "self_attn.o_proj.weight": (D, qd),
      p + "mlp.gate_proj.weight": (F_, D), p + "mlp.up_proj.weight": (F_, D), p + "mlp.down_proj.weight": (D, F_),
    })
  header, offset = {"__metadata__": {"format": "pt"}}, 0
  for name, shape in shapes.items():
    n = math.prod(shape) * 2
    header[name] = {"dtype": "BF16", "shape": list(shape), "data_offsets": [offset, offset + n]}
    offset += n
  raw = json.dumps(header, separators=(",", ":")).encode()
  raw += b" " * (-len(raw) % 8)
  gen = torch.Generator(device="cuda").manual_seed(seed)
  path.mkdir(parents=True, exist_ok=True)
  (path / "config.json").write_text(json.dumps(c, indent=1))
  with open(path / "model.safetensors", "wb") as f:
    f.write(struct.pack("<Q", len(raw)))
    f.write(raw)
    for name, shape in shapes.items():
      scale = 0.05 if len(shape) == 1 else 0.02 if name == "model.embed_tokens.weight" else shape[1] ** -0.5
      t = (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)
      f.write(t.view(torch.uint8).cpu().numpy().data)
  return time.perf_counter() - t0


def gemma_long_prompt() -> tuple[list[int], str]:
  """(ids, user text) of a prompt of ``GEMMA_LONG_TOKENS`` byte-tokenizer
  ids (BOS, the chat template, the text): its first ~``GEMMA_LONG_HEAD``
  text bytes are upper-case words and digits, the rest lower-case words,
  so a query past position 4,096 sees other text with the window than
  without it."""
  tok = ByteTokenizer()
  overhead = len(tok.encode(tok.apply_chat_template([{"role": "user", "content": ""}])))
  head = " ".join(f"LEDGER {i:04d} ENTRY" for i in range(GEMMA_LONG_HEAD // 17 + 1))[:GEMMA_LONG_HEAD]
  words = "the quick brown fox jumps over a lazy dog while seven tired owls count the stars above an old mill".split()
  tail = " ".join(words[i % len(words)] for i in range(GEMMA_LONG_TOKENS))
  text = (head + " " + tail)[: GEMMA_LONG_TOKENS - overhead]
  ids = tok.encode(tok.apply_chat_template([{"role": "user", "content": text}]))
  if len(ids) != GEMMA_LONG_TOKENS:
    raise SystemExit(f"chip_smoke: [gemma2] the long prompt is {len(ids)} tokens, expected {GEMMA_LONG_TOKENS}")
  return ids, text


def gemma_plain_f32(torch, params, cfg, ids: list[int], window: bool = True, n_last: int = 2):
  """A plain f32 forward of gemma2 over the served weights, written out
  here from the published architecture (each layer's weights cast to f32
  as it runs): the embed times bf16(sqrt(D)), per layer the pre-attention
  norm, q/k/v, HF rope, scores scaled by 1/sqrt(query_pre_attn_scalar),
  ``cap·tanh(s/cap)``, the causal mask and on even layers (``window``) the
  last ``sliding_window`` positions only, softmax, o, the post-attention
  norm; the pre-MLP norm, GeGLU (tanh GELU), the post-MLP norm; the final
  norm, the tied head and the final softcap. Logits [n_last, V] f32 of the
  last ``n_last`` positions."""
  lay = params["layers"]
  S, H, Hkv, hd = len(ids), cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
  dev = params["embed"].device
  x = torch.tensor(ids, device=dev)

  def rms(v, w):
    return v * torch.rsqrt(v.pow(2).mean(-1, keepdim=True) + cfg.norm_eps) * w.float()

  inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, hd, 2, device=dev, dtype=torch.float32) / hd))
  ang = torch.arange(S, device=dev, dtype=torch.float32)[:, None] * inv[None, :]
  cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]

  def rope(v):
    a, b = v.chunk(2, dim=-1)
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)

  pos = torch.arange(S, device=dev)
  causal = pos[None, :] <= pos[:, None]
  slide = causal & (pos[None, :] > pos[:, None] - cfg.sliding_window)
  h = params["embed"][x].float() * torch.tensor(math.sqrt(cfg.dim), dtype=torch.bfloat16).item()
  for i in range(lay["wq"].shape[0]):
    p = {k: v[i] for k, v in lay.items()}
    a = rms(h, p["attn_norm"])
    q = rope((a @ p["wq"].float()).view(S, H, hd))
    k = rope((a @ p["wk"].float()).view(S, Hkv, hd)).repeat_interleave(H // Hkv, dim=1)
    v = (a @ p["wv"].float()).view(S, Hkv, hd).repeat_interleave(H // Hkv, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(cfg.query_pre_attn_scalar)
    s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    mask = slide if (window and float(p["is_sliding"]) > 0) else causal
    s = torch.softmax(s.masked_fill(~mask[None], -math.inf), dim=-1)
    o = torch.einsum("hqk,khd->qhd", s, v).reshape(S, H * hd)
    del s, q, k, v
    h = h + rms(o @ p["wo"].float(), p["post_attn_norm"])
    m = rms(h, p["mlp_norm"])
    g = torch.nn.functional.gelu(m @ p["w_gate"].float(), approximate="tanh") * (m @ p["w_up"].float())
    h = h + rms(g @ p["w_down"].float(), p["post_mlp_norm"])
  out = rms(h[-n_last:], params["final_norm"]) @ params["embed"].float().T
  return cfg.final_logit_softcap * torch.tanh(out / cfg.final_logit_softcap)


def _gemma_chat(stream: bool, content=None, max_tokens: int = GEMMA_ANSWER, **extra) -> dict:
  return {"model": GEMMA_MODEL, "messages": [{"role": "user", "content": content or CHAT[0]["content"]}], "stream": stream, "temperature": 0, "max_tokens": max_tokens, **extra}


def _attn_ms(torch, cfg, Sq: int, offset: int, cache: int, sliding: bool) -> float:
  """Device ms of one layer's plain attention (``gqa_attention`` with the
  config's options) at Sq queries from ``offset`` over a ``cache``-slot
  bf16 cache: what a gemma2 step or prefill spends on attention per layer."""
  from xotorch_support_jetson_tpu_torch.models.decoder import _attn_opts
  from xotorch_support_jetson_tpu_torch.ops.attention import gqa_attention

  gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
  q = _rand(torch, (1, Sq, cfg.n_heads, cfg.head_dim), gen, torch.bfloat16)
  k, v = (_rand(torch, (1, cache, cfg.n_kv_heads, cfg.head_dim), gen, torch.bfloat16) for _ in range(2))
  qpos = torch.arange(offset, offset + Sq, dtype=torch.int32, device="cuda")[None]
  kvpos = torch.arange(cache, dtype=torch.int32, device="cuda")
  opts = _attn_opts(cfg, torch.tensor(1.0 if sliding else 0.0, device="cuda"))
  ms = _cuda_ms(torch, lambda: gqa_attention(q, k, v, qpos, kvpos, **opts), iters=5, warmup=1)
  del q, k, v
  return ms


def phase_gemma2(torch, ckpt: Path, smi: str):
  """gemma-2-9b at full width (``GEMMA_LAYERS`` deep) through the daemon: solo bf16
  (captured, ``XOT_TPU_MAX_SEQ`` 8192) then batched at the defaults on the
  same engine, then solo with ``XOT_TPU_QUANT=int4``."""
  from xotorch_support_jetson_tpu_torch import main as tmain

  out = {}
  args, port = _daemon_args(tmain, ckpt, max_tokens=4 * MAX_TOKENS, model=GEMMA_MODEL)  # the batched pass's answers (``_batched_defaults`` answer_scale)
  os.environ["XOT_TPU_MAX_SEQ"] = str(GEMMA_MAX_SEQ)
  try:
    out["bf16"] = asyncio.run(_gemma_bf16(torch, tmain, args, port, smi))
  finally:
    for knob in ("XOT_TPU_MAX_SEQ", "XOT_TPU_BATCHED", "XOT_TPU_BATCH_SLOTS", "XOT_TPU_PAGE_SIZE"):
      os.environ.pop(knob, None)
    gc.collect()
    torch.cuda.empty_cache()
  args, port = _daemon_args(tmain, ckpt, model=GEMMA_MODEL)
  os.environ["XOT_TPU_QUANT"] = "int4"
  try:
    out["int4"] = asyncio.run(_gemma_int4(torch, tmain, args, port))
  finally:
    os.environ.pop("XOT_TPU_QUANT", None)
    gc.collect()
    torch.cuda.empty_cache()
  return out


def _kernel_launches() -> dict:
  return {n: _launched(n) for n in ("flash_prefill", "flash_decode", "paged_decode", "int4_matmul")}


async def _daemon_up(torch, tmain, args, port, tag, model, label, check_cfg, preload=None, tokenizer=None):
  """The daemon's components for ``model`` (its registry card's depth,
  remapped by the engine onto the checkpoint's), started as
  ``main.async_main`` starts them, the shard loaded; ``check_cfg(cfg)``
  returns what is wrong with the loaded config, or nothing. ``preload``
  (cfg, params) at the card's full depth is put into the engine instead of
  a checkpoint read from disk (the daemon then finds its shard loaded).
  ``tokenizer`` defaults to the ``ByteTokenizer``."""
  from xotorch_support_jetson_tpu_torch import registry
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard

  tokenizer = tokenizer or ByteTokenizer()
  node, api, engine, _ = tmain.build_components(args, tokenizer=tokenizer)
  if engine.device.type != "cuda":
    raise SystemExit(f"chip_smoke: [{tag}] the engine did not choose the card")
  if os.getenv("XOT_TPU_MAX_SEQ"):
    # The engine module read XOT_TPU_MAX_SEQ when this process imported it
    # (the llama phases); a daemon process started with the knob has this.
    engine.max_seq_len = int(os.environ["XOT_TPU_MAX_SEQ"])
  await node.start()  # as main.async_main: the SLO engine ticks for the batched pass
  server = await api.run(host="127.0.0.1", port=port)
  t0 = time.perf_counter()
  layers = registry.model_cards[model].layers
  if preload is not None:
    import dataclasses

    cfg, params = preload
    engine.load_test_model(Shard(model, 0, layers - 1, layers), dataclasses.replace(cfg, max_seq_len=engine._serving_cap(cfg)), params, tokenizer=tokenizer)
  await engine.ensure_shard(Shard(model, 0, layers - 1, layers))
  torch.cuda.synchronize()
  load_s = time.perf_counter() - t0
  wrong = check_cfg(engine.cfg)
  if wrong:
    raise SystemExit(f"chip_smoke: [{tag}] the loaded config: {wrong}: {engine.cfg}")
  log(f"[{tag}] {label} daemon up on 127.0.0.1:{port}; {sum(t.numel() * t.element_size() for t in _leaves(engine.params)) / 1e9:.2f} GB of weights loaded to the card in {load_s:.1f} s; device memory allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")
  return node, server, engine, load_s


def _gemma_cfg_problem(cfg) -> str:
  return "" if cfg.family == "gemma2" and not cfg.plain_attention and cfg.sliding_window == 4096 and cfg.head_dim == 256 else "not gemma2's"



def _leaves(params):
  for v in params.values() if isinstance(params, dict) else params:
    yield from (_leaves(v) if isinstance(v, (dict, list)) else [v])


async def _daemon_down(node, server, engine):
  await node.stop()
  server.close()
  await server.wait_closed()
  engine.executor.shutdown(wait=True)


def _no_attention_kernels(label: str, launches: dict) -> None:
  """K1, K2 and K3 implement no softcap or window: gemma2 attends through
  the plain route everywhere, as the reference routes it."""
  if launches["flash_prefill"] or launches["flash_decode"] or launches["paged_decode"]:
    raise SystemExit(f"chip_smoke: [gemma2] {label}: an attention kernel launched on gemma2 ({launches})")


async def _gemma_bf16(torch, tmain, args, port, smi):
  from xotorch_support_jetson_tpu_torch.utils import programs

  node, server, engine, load_s = await _daemon_up(torch, tmain, args, port, "gemma2", GEMMA_MODEL, "bf16", _gemma_cfg_problem)
  res = dict(load_s=load_s, card=smi)
  try:
    cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
    log(f"[gemma2] config: google/gemma-2-9b's published shapes (hidden 3584, {cfg.n_layers} of its 42 layers, 16/8 heads, head_dim 256, ffn 14336, vocab 256000, query_pre_attn_scalar 256, softcaps 50/30, sliding_window 4096, rms eps 1e-6, tied), random bf16 weights; bos/eos/pad written as the byte tokenizer's 128000/128009/128009 (the published 2/1/0 are bytes here); serving cap {engine.max_seq_len}")
    await _serve_requests(torch, node, engine, port, [("warmup", _gemma_chat(False, max_tokens=8))])
    long_ids, long_content = gemma_long_prompt()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # ---- the solo gemma2 path, counted
    fam0 = programs.ledger.snapshot()["families"]
    chat = await _serve_requests(torch, node, engine, port, [("greedy blocking", _gemma_chat(False)), ("greedy streaming", _gemma_chat(True))])
    t_long = time.perf_counter()
    long = await _serve_requests(torch, node, engine, port, [("long greedy blocking", _gemma_chat(False, long_content, GEMMA_LONG_ANSWER)), ("long greedy streaming", _gemma_chat(True, long_content, GEMMA_LONG_ANSWER))])
    long_s = time.perf_counter() - t_long
    peak_long = torch.cuda.max_memory_allocated()
    lp_ids: dict[str, list[int]] = {}
    node.on_token.register("chip_smoke_lp").on_next(lambda rid, toks, fin: lp_ids.setdefault(rid, []).extend(toks))
    try:
      st, raw = await asyncio.to_thread(_http, port, "POST", "/v1/chat/completions", _gemma_chat(False, max_tokens=16, logprobs=True, top_logprobs=5))
    finally:
      node.on_token.deregister("chip_smoke_lp")
    engine.spec_decode, engine._spec_ngram_on = "ngram", True  # the n-gram chain for one request (XOT_TPU_SPEC_DECODE=ngram)
    try:
      rep = "the fox jumps over the dog. " * 24
      ngram = await _serve_requests(torch, node, engine, port, [("n-gram greedy streaming", _gemma_chat(True, rep, 48))])
    finally:
      engine.spec_decode, engine._spec_ngram_on = None, False
    plain_rep = await _serve_requests(torch, node, engine, port, [("plain greedy blocking (the n-gram prompt)", _gemma_chat(False, rep, 48))])
    launches = _kernel_launches()  # ---- read just after
    fam1 = programs.ledger.snapshot()["families"]
    _no_attention_kernels("solo bf16", launches)
    for a, b, what in ((chat[0], chat[1], "chat"), (long[0], long[1], "long prompt")):
      if a["tokens"] != b["tokens"]:
        raise SystemExit(f"chip_smoke: [gemma2] {what}: greedy blocking and streaming differ:\n{a['tokens']}\n{b['tokens']}")
    if st != 200:
      raise SystemExit(f"chip_smoke: [gemma2] logprobs: HTTP {st} {raw[:300]}")
    data = json.loads(raw)
    lp = data["choices"][0]["logprobs"]
    check_lp = _check_logprobs("gemma2 chat", lp, lp_ids[data["id"].split("-", 1)[1]], {ByteTokenizer.eos_token_id}, ByteTokenizer().decode, True) if lp else None
    spec_n = fam1.get("spec.batch", {}).get("dispatches", 0) - fam0.get("spec.batch", {}).get("dispatches", 0)
    scored = fam1.get("prefill.score_last", {}).get("dispatches", 0) - fam0.get("prefill.score_last", {}).get("dispatches", 0)
    if check_lp is None or scored != 1 or spec_n < 1:
      raise SystemExit(f"chip_smoke: [gemma2] logprobs {check_lp}, {scored} prefill.score_last dispatches, {spec_n} n-gram chunks (spec.batch dispatches)")
    agree = _agreement(ngram[0]["tokens"], plain_rep[0]["tokens"])
    res.update(
      launches=launches, chat_tokens=chat[0]["tokens"], decode_tok_s=_decode_rate(chat[1]), ttft_s=chat[1]["ttft_s"], long_ttft_s=long[1]["ttft_s"], long_decode_tok_s=_decode_rate(long[1]),
      long_tokens=long[0]["tokens"], long_requests_s=long_s, peak_allocated_long=peak_long, logprobs=check_lp, ngram_chunks=spec_n, ngram_agreement=agree,
      ngram_decode_tok_s=_decode_rate(ngram[0]),
    )
    log(f"[gemma2] solo bf16: greedy blocking == streaming ({len(chat[0]['tokens'])} tokens; TTFT {chat[1]['ttft_s']:.4f} s, decode {res['decode_tok_s']:.1f} tok/s) | long prompt of {len(long_ids)} tokens (bucket 6016): blocking == streaming ({len(long[0]['tokens'])} tokens), TTFT {long[1]['ttft_s']:.4f} s, decode {res['long_decode_tok_s']:.1f} tok/s, peak device memory {peak_long / 1e9:.2f} GB | logprobs {check_lp} | n-gram chain: {spec_n} spec.batch dispatches, {res['ngram_decode_tok_s']:.1f} tok/s, ids agreeing with plain {agree:.3f} | launches {launches} (K1/K2/K3 none: the plain route) | {smi}")
    # The served logits beyond position 4,096 against the plain f32 forward,
    # with and without the window: the captured 6016 prefill's last token
    # and one captured decode step after it.
    served_pre, _ = engine._infer_tensor_sync("gemma-check", np.asarray([long_ids], np.int32), None)
    nxt = int(np.argmax(served_pre[0]))
    served_step, _ = engine._infer_tensor_sync("gemma-check", np.asarray([[nxt]], np.int32), None)
    engine.end_request("gemma-check")
    served = torch.from_numpy(np.stack([served_pre[0], served_step[0]])).cuda().float()
    t0 = time.perf_counter()
    with torch.no_grad():
      ref = gemma_plain_f32(torch, params, cfg, long_ids + [nxt])
      ref_nowin = gemma_plain_f32(torch, params, cfg, long_ids + [nxt], window=False)
    ref_s = time.perf_counter() - t0
    err = [_rel_err(served[i], ref[i]) for i in range(2)]
    err_nowin = [_rel_err(served[i], ref_nowin[i]) for i in range(2)]
    win_vs_nowin = [_rel_err(ref_nowin[i], ref[i]) for i in range(2)]
    res["check"] = dict(positions=[len(long_ids) - 1, len(long_ids)], rel_err=err, rel_err_without_window=err_nowin, f32_window_vs_no_window=win_vs_nowin, argmax_agree=[int(served[i].argmax()) == int(ref[i].argmax()) for i in range(2)], ref_s=ref_s)
    log(f"[gemma2] served logits at positions {len(long_ids) - 1} (captured prefill) and {len(long_ids)} (captured step) against a plain f32 forward on the same weights: rel L2 {err[0]:.3e} / {err[1]:.3e} (limit {GEMMA_CHECK_TOL}); against the same forward without the window {err_nowin[0]:.3e} / {err_nowin[1]:.3e} (must exceed {GEMMA_CHECK_TOL}); f32 with vs without the window {win_vs_nowin[0]:.3e} / {win_vs_nowin[1]:.3e}; argmax agree {res['check']['argmax_agree']} ({ref_s:.1f} s for both f32 forwards)")
    del ref, ref_nowin
    if not max(err) < GEMMA_CHECK_TOL or not min(err_nowin) > GEMMA_CHECK_TOL:
      raise SystemExit(f"chip_smoke: [gemma2] served logits: {res['check']}")
    res["graphs"] = _gemma_graphs_against_eager(torch, engine, long_ids)
    res["profile"] = _gemma_profile(torch, engine, long_ids, smi)
    # Batched at the defaults on the same engine: its solo caches and their
    # graphs go first (the page pool takes their room).
    engine._cache_pool.clear()
    engine._graph_pool = None
    gc.collect()
    torch.cuda.empty_cache()
    # Answers 4x as long (116-256 tokens): the random gemma copies its last
    # token, so every n-gram proposal is accepted and, at GEMMA_LAYERS deep,
    # the first wave's 29-64-token answers end in two spec chunks, before the
    # second wave's requests arrive: no admission would find a decoding row
    # to share a mixed tick with.
    res["batched"] = await _batched_defaults(torch, node, engine, port, smi, GEMMA_MODEL, "gemma2", "gather", answer_scale=4)
    _no_attention_kernels("batched", res["batched"]["launches"])
    return res
  finally:
    await _daemon_down(node, server, engine)


def _gemma_graphs_against_eager(torch, engine, long_ids):
  """Captured equals eager on gemma2: the engine's captured 128-bucket
  prefill and blocking / chunked greedy decode against the uncaptured
  functions on a fresh cache of the same size (ids identical, prefill
  logits within 5e-2 relative L2), and the captured 6016 bucket's logits
  against an eager ``shard_forward`` of the long prompt."""
  from xotorch_support_jetson_tpu_torch.models.decoder import init_kv_cache, shard_forward

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  prompt = np.asarray([ByteTokenizer().encode(CHECK_PROMPT)], dtype=np.int32)
  rows = []
  for rnd, chunks in enumerate(((), (16, 16))):
    want_logits, want = _eager_solo(torch, engine, prompt, 0.0, 0, chunks, cache=GEMMA_MAX_SEQ, steps=GEMMA_ANSWER)
    got_logits, got = _captured_solo(torch, engine, f"gemma-graphs-{rnd}", prompt, 0.0, 0, chunks, steps=GEMMA_ANSWER)
    err = _rel_err(got_logits.cuda(), want_logits)
    rows.append(dict(kind="streaming" if chunks else "blocking", identical=got == want, prefill_rel_err=err))
    if got != want or not err < 5e-2:
      raise SystemExit(f"chip_smoke: [gemma2] captured differs from uncaptured ({rows[-1]}):\n{got}\n{want}")
  S = len(long_ids)
  pad_to = -(-S // 128) * 128
  x = torch.zeros((1, pad_to), dtype=torch.int32, device="cuda")
  x[0, :S] = torch.tensor(long_ids, device="cuda")
  cache = init_kv_cache(cfg, cfg.n_layers, 1, GEMMA_MAX_SEQ, device="cuda")
  torch.cuda.reset_peak_memory_stats()
  base = torch.cuda.memory_allocated()
  eager, _ = shard_forward(params, cfg, shard, x, torch.arange(pad_to, dtype=torch.int32, device="cuda")[None], cache, head_pos=torch.tensor([S - 1], device="cuda"))
  eager_peak = torch.cuda.max_memory_allocated() - base
  del cache
  captured, _ = engine._infer_tensor_sync("gemma-long-graph", np.asarray([long_ids], np.int32), None)
  engine.end_request("gemma-long-graph")
  err_long = _rel_err(torch.from_numpy(captured).cuda(), eager[:, 0])
  graphs = [g for free in engine._cache_pool.values() for p in free for g in p.graphs()]
  from xotorch_support_jetson_tpu_torch.utils import programs

  pool = programs.pool_bytes(engine._graph_pool)
  log(f"[gemma2] captured against uncaptured: {rows}; the captured 6016 bucket's logits within {err_long:.3e} rel L2 of an eager shard_forward (eager peak {eager_peak / 1e9:.2f} GB above what was allocated) | {len(graphs)} graphs, the engine's graph pool {pool} bytes, kernel nodes {[(g.family, g.kernel_nodes, round(g.capture_s, 3)) for g in graphs]}")
  if not err_long < 5e-2:
    raise SystemExit(f"chip_smoke: [gemma2] the captured long prefill differs from eager: {err_long}")
  return dict(rows=rows, long_rel_err=err_long, eager_long_peak_bytes=eager_peak, graph_pool_bytes=pool, graphs=[(g.family, g.kernel_nodes, g.capture_s) for g in graphs])


def _gemma_profile(torch, engine, long_ids, smi):
  """Where a gemma2 step's device time goes: the captured decode step at
  position 6000 of the 8192-slot cache (wall and device ms,
  ``_replay_ms``), one layer's plain attention at that step on a sliding
  and a global layer (``_attn_ms``) times 21 each against it; the same for
  the served 6016 prefill (its device time from torch.profiler)."""
  from xotorch_support_jetson_tpu_torch.models.decoder import fused_decode

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  session = engine._new_session("gemma-profile", 1)
  progs = session.programs
  try:
    n = GRAPH_PROFILE_STEPS
    wall, device = _replay_ms(torch, lambda: fused_decode(params, cfg, shard, 65, progs.cache, 6000, n, programs=progs), n)
  finally:
    engine.end_request("gemma-profile")
  half = cfg.n_layers // 2
  step_attn = half * (_attn_ms(torch, cfg, 1, 6000, GEMMA_MAX_SEQ, True) + _attn_ms(torch, cfg, 1, 6000, GEMMA_MAX_SEQ, False))

  def prefill():
    engine._infer_tensor_sync("gemma-profile-long", np.asarray([long_ids], np.int32), None)
    engine.end_request("gemma-profile-long")

  prof = _profile(torch, "gemma2 prefill (6000-token prompt, 6016 bucket, captured)", prefill, 2)
  pre_attn = half * (_attn_ms(torch, cfg, 6016, 0, GEMMA_MAX_SEQ, True) + _attn_ms(torch, cfg, 6016, 0, GEMMA_MAX_SEQ, False))
  res = dict(
    step_wall_ms=wall, step_device_ms=device, step_attention_ms=step_attn, step_attention_share=step_attn / device,
    prefill_wall_ms=prof["wall_ms"], prefill_device_ms=prof["device_ms"], prefill_attention_ms=pre_attn, prefill_attention_share=pre_attn / prof["device_ms"] if prof["device_ms"] else None,
  )
  log(f"[profile] gemma2 decode step at position 6000 of {GEMMA_MAX_SEQ} slots (captured): wall {wall:.3f} ms, device {device:.3f} ms; plain attention {step_attn:.3f} ms of it ({cfg.n_layers} layers, from one layer's time on a sliding and a global layer: share {res['step_attention_share']:.3f}) | {smi}")
  share = "not measured (no device events)" if res["prefill_attention_share"] is None else f"{res['prefill_attention_share']:.3f}"
  log(f"[profile] gemma2 prefill of 6000 tokens (6016 bucket, captured): wall {prof['wall_ms']:.3f} ms, device {prof['device_ms']:.3f} ms; plain attention {pre_attn:.3f} ms (share {share}) | {smi}")
  return res


async def _batched_defaults(torch, node, engine, port, smi, model, tag, route, answer_scale: int = 1, spec_and_mixed: bool = True):
  """``model`` on the batched server at its defaults (n-gram speculation,
  QoS, mixed ticks; 8 slots, 64-token pages) on the solo daemon's engine:
  the 16 streams of ``batched_bodies`` in two waves (their answers
  ``answer_scale`` times as long), the launch counts zeroed just before and
  read just after. Gates: every request ends with all its tokens, spec and
  mixed dispatches ran (none at all without ``spec_and_mixed``: an MLA
  model's server runs neither, as the reference's), and the plain decode
  chunks took ``route`` ("kernel": K3; "gather"); the caller gates the
  kernels' launches."""
  from concurrent.futures import ThreadPoolExecutor

  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa, int4_matmul as k4, paged
  from xotorch_support_jetson_tpu_torch.utils import programs
  from xotorch_support_jetson_tpu_torch.utils.metrics import metrics, snapshot_delta

  os.environ.update(XOT_TPU_BATCHED="1", XOT_TPU_BATCH_SLOTS=str(BATCH_SLOTS), XOT_TPU_PAGE_SIZE=str(PAGE))
  programs.ledger.reset()
  clients = ThreadPoolExecutor(max_workers=16)
  loop = asyncio.get_running_loop()
  ids: dict[str, list[int]] = {}
  node.on_token.register("chip_smoke_batched").on_next(lambda rid, toks, fin: ids.setdefault(rid, []).extend(toks))
  try:
    await loop.run_in_executor(clients, _post, port, {"model": model, "messages": [{"role": "user", "content": "warm up"}], "stream": True, "temperature": 0, "max_tokens": 9})
    bserver = engine.get_batched_server()
    slices, spec_records = [], []
    unspy, unspy_spec = _spy_mixed(engine, fa, paged, slices), _spy_spec(engine, paged, k4, spec_records)
    bodies = [dict(b, model=model, max_tokens=b["max_tokens"] * answer_scale) for b in batched_bodies()]
    snap0 = metrics.snapshot()
    _reset_launches()  # ---- the batched pass, counted
    t0 = time.perf_counter()
    before = set(ids)
    first = [loop.run_in_executor(clients, _post, port, b) for b in bodies[:8]]
    while sum(1 for rid, t in list(ids.items()) if t and rid not in before) < BATCH_SLOTS:
      if time.perf_counter() - t0 > 300 or any(f.done() and f.exception() is not None for f in first):
        raise SystemExit(f"chip_smoke: [{tag}] batched: the first wave's rows did not all stream ({[repr(f.exception()) for f in first if f.done() and f.exception() is not None]})")
      await asyncio.sleep(0.005)
    replies = await asyncio.gather(*first, *(loop.run_in_executor(clients, _post, port, b) for b in bodies[8:]))
    wall = time.perf_counter() - t0
    unspy()
    unspy_spec()
    launches, moe_paths = _kernel_launches(), _moe_path_counts()  # ---- read just after
    delta = snapshot_delta(snap0, metrics.snapshot())
    chunks = {path: n for path, n in _by_label(delta, "decode_chunks_total", "path").items() if n}  # the registry keeps earlier passes' paths at 0
    toks = []
    for (_, finish, ttft, total, _, rid), b in zip(replies, bodies):
      n = len(ids.get(rid, []))
      if not n or n > b["max_tokens"] or finish not in ("stop", "length") or (finish == "length" and n != b["max_tokens"]):
        raise SystemExit(f"chip_smoke: [{tag}] batched: request {rid} gave {n} of {b['max_tokens']} tokens, finish {finish}")
      toks.append(n)
    ran = (bool(spec_records), bool(slices))
    if ran != (spec_and_mixed, spec_and_mixed) or set(chunks) - {route, "spec"} or bserver.decode_path != route:
      raise SystemExit(f"chip_smoke: [{tag}] batched: {len(spec_records)} spec and {len(slices)} mixed dispatches, decode chunks by path {chunks}, decode path {bserver.decode_path}; tokens and finish per request {[(n, r[1]) for n, r in zip(toks, replies)]}")
    ttfts = [r[2] for r in replies]
    res = dict(
      requests=len(replies), tokens=sum(toks), wall_s=wall, aggregate_tok_s=sum(toks) / wall, ttft_p50_s=_pctl(ttfts, 0.5), ttft_p95_s=_pctl(ttfts, 0.95),
      spec_dispatches=len(spec_records), mixed_dispatches=len(slices), chunks_by_path=chunks, launches=launches, pool_pages=bserver.allocator.n_pages,
      accepted=_by_label(delta, "spec_accepted_tokens_total", "proposer"), proposed=_by_label(delta, "spec_proposed_tokens_total", "proposer"),
      captures=sum(f["captures"] for f in programs.ledger.snapshot()["families"].values()), capture_s=sum(f["capture_s"] for f in programs.ledger.snapshot()["families"].values()),
    )
    res["moe_paths"] = moe_paths
    log(f"[{tag}] batched at the defaults: {len(replies)} streaming requests, {res['tokens']} tokens in {wall:.3f} s: aggregate {res['aggregate_tok_s']:.1f} tok/s | TTFT p50 {res['ttft_p50_s']:.4f} s p95 {res['ttft_p95_s']:.4f} s | {len(spec_records)} spec dispatches (accepted {res['accepted']} of proposed {res['proposed']}), {len(slices)} mixed dispatches, decode chunks by path {chunks}, decode path {bserver.decode_path} | {res['captures']} captures ({res['capture_s']:.1f} s) | pool {res['pool_pages']} pages | launches {launches} | {smi}")
    engine._drop_batched_server()
    return res
  finally:
    node.on_token.deregister("chip_smoke_batched")
    await asyncio.to_thread(clients.shutdown, True)
    for knob in ("XOT_TPU_BATCHED", "XOT_TPU_BATCH_SLOTS", "XOT_TPU_PAGE_SIZE"):
      os.environ.pop(knob, None)


async def _gemma_int4(torch, tmain, args, port):
  """gemma-2-9b with ``XOT_TPU_QUANT=int4`` (quantized on the card at
  load, the tied head's quantized copy included): greedy blocking and
  streaming ids equal, K4 once per quantized product per forward (7 a
  layer and the head), no non-kernel int4 product, no attention kernel."""
  from xotorch_support_jetson_tpu_torch.ops import int4_matmul as k4

  node, server, engine, load_s = await _daemon_up(torch, tmain, args, port, "gemma2", GEMMA_MODEL, "int4", _gemma_cfg_problem)
  try:
    per_forward = 7 * engine.cfg.n_layers + 1
    if "lm_head_scale" not in engine.params:
      raise SystemExit("chip_smoke: [gemma2] int4: the tied head has no quantized copy")
    await _serve_requests(torch, node, engine, port, [("warmup", _gemma_chat(False, max_tokens=8))])
    two_dot0 = k4.CALLS["int4_two_dot"]
    _reset_launches()  # ---- the int4 gemma2 path, counted
    run = await _serve_requests(torch, node, engine, port, [("int4 greedy blocking", _gemma_chat(False)), ("int4 greedy streaming", _gemma_chat(True))])
    launches = _kernel_launches()  # ---- read just after
    two_dot = k4.CALLS["int4_two_dot"] - two_dot0
    _no_attention_kernels("int4", launches)
    if run[0]["tokens"] != run[1]["tokens"]:
      raise SystemExit(f"chip_smoke: [gemma2] int4: greedy blocking and streaming differ:\n{run[0]['tokens']}\n{run[1]['tokens']}")
    if launches["int4_matmul"] == 0 or launches["int4_matmul"] % per_forward or two_dot:
      raise SystemExit(f"chip_smoke: [gemma2] int4: K4 launches {launches['int4_matmul']} (not a multiple of {per_forward} per forward), {two_dot} int4_two_dot calls")
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(engine.params))
    res = dict(load_s=load_s, launches=launches, per_forward=per_forward, forwards=launches["int4_matmul"] // per_forward, weight_bytes=weight_bytes, tokens=run[0]["tokens"], ttft_s=run[1]["ttft_s"], decode_tok_s=_decode_rate(run[1]))
    log(f"[gemma2] solo int4 weights ({weight_bytes / 1e9:.2f} GB on the card): greedy blocking == streaming ({len(run[0]['tokens'])} tokens), TTFT {res['ttft_s']:.4f} s, decode {res['decode_tok_s']:.1f} tok/s | K4 {launches['int4_matmul']} launches = {res['forwards']} forwards × {per_forward} | launches {launches}")
    return res
  finally:
    await _daemon_down(node, server, engine)


# ---------------------------------------------------------------- MoE


# Qwen/Qwen3-30B-A3B's published config.json, but for the bos / eos ids,
# which take the byte tokenizer's (151643 / 151645 are not its ids), and
# the depth, which the phase cuts (``MOE_LAYERS``).
QWEN3_30B_A3B = {
  "architectures": ["Qwen3MoeForCausalLM"], "model_type": "qwen3_moe", "vocab_size": 151936, "hidden_size": 2048, "intermediate_size": 6144,
  "moe_intermediate_size": 768, "num_hidden_layers": 48, "num_attention_heads": 32, "num_key_value_heads": 4, "head_dim": 128, "num_experts": 128,
  "num_experts_per_tok": 8, "norm_topk_prob": True, "decoder_sparse_step": 1, "mlp_only_layers": [], "rms_norm_eps": 1e-6, "rope_theta": 1000000.0,
  "max_position_embeddings": 40960, "tie_word_embeddings": False, "attention_bias": False, "router_aux_loss_coef": 0.001,
  "bos_token_id": 128000, "eos_token_id": 128009, "torch_dtype": "bfloat16",
}
MOE_MODEL = "qwen-3-30b-a3b"
# 12 of the 48 layers (~16.2 GB of bf16 weights): the whole smoke run must
# end within the 1,200 s it is given; scripts/moe_phase.py --layers 48 runs
# the full depth (~61 GB) in a call of its own.
MOE_LAYERS = 12
MOE_PATH_TS = (1, 2, 4, 8, 16, 32, 72, 128)  # token counts at which both MoE paths are timed
MOE_CHECK_TOL = 5e-2  # relative L2 of the served logits against the plain f32 forward (PERF.md §2)
MOE_ROUTER_STD = 3.0  # the random routers' logit scale (``write_moe_checkpoint``)
QWEN3_MOE_FFN = dict(E=128, k=8, D=2048, F=768, norm_topk=True)  # Qwen3-30B-A3B's routed experts
# Qwen3-30B-A3B's weight products outside the experts, (in, out), for K4
# under int4 weights: q, k/v, o and the untied head; one decode step makes
# each once a layer (k/v twice) and the head once.
QWEN3_MOE_MATMULS = {"wq": (2048, 4096), "wk/wv": (2048, 512), "wo": (4096, 2048), "lm_head": (2048, 151936)}


def moe_shapes(layers: int = MOE_LAYERS) -> dict:
  """HF tensor name → shape of the Qwen3-MoE checkpoint at ``layers``."""
  c = QWEN3_30B_A3B
  D, V, E, Fm, hd = c["hidden_size"], c["vocab_size"], c["num_experts"], c["moe_intermediate_size"], c["head_dim"]
  qd, kd = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd
  shapes = {"model.embed_tokens.weight": (V, D), "model.norm.weight": (D,), "lm_head.weight": (V, D)}
  for i in range(layers):
    p = f"model.layers.{i}."
    shapes.update({p + "input_layernorm.weight": (D,), p + "post_attention_layernorm.weight": (D,), p + "self_attn.q_norm.weight": (hd,), p + "self_attn.k_norm.weight": (hd,)})
    shapes.update({p + "self_attn.q_proj.weight": (qd, D), p + "self_attn.k_proj.weight": (kd, D), p + "self_attn.v_proj.weight": (kd, D), p + "self_attn.o_proj.weight": (D, qd), p + "mlp.gate.weight": (E, D)})
    for e in range(E):
      shapes.update({f"{p}mlp.experts.{e}.gate_proj.weight": (Fm, D), f"{p}mlp.experts.{e}.up_proj.weight": (Fm, D), f"{p}mlp.experts.{e}.down_proj.weight": (D, Fm)})
  return shapes


def write_moe_checkpoint(torch, path: Path, layers: int = MOE_LAYERS, seed: int = SEED + 17) -> float:
  """Seeded random bf16 weights at Qwen3-30B-A3B's shapes and ``layers``
  of its depth, HF names, one .safetensors file written tensor by tensor
  (the weights never sit in host memory at once). N(0, 1/fan_in)
  projections and head, N(0, 0.02) embeddings, unit norm gains, and
  routers N(0, (MOE_ROUTER_STD)²/fan_in): router logits of std 3 on the
  normed hidden state, so the top 8 of 128 experts hold most of the
  probability and the 8th's renormalised weight is small, as a trained
  router's are. With std-1 logits (flat routing) the 8th and 9th experts
  are near-tied in about one decision in seven, bf16 and f32 route such a
  token apart, and each such token's FFN output moves by about an eighth:
  the served step's logits then sat 3e-2 to 5.3e-2 from the plain f32
  forward (PERF.md §6)."""
  return _write_seeded_checkpoint(torch, path, dict(QWEN3_30B_A3B, num_hidden_layers=layers), moe_shapes(layers), seed, MOE_ROUTER_STD)


def _write_seeded_checkpoint(torch, path: Path, config: dict, shapes: dict, seed: int, router_std: float = 1.0) -> float:
  """``config.json`` and one .safetensors file of seeded random bf16
  tensors of ``shapes``, written tensor by tensor: N(0, 1/fan_in)
  projections, head and convolutions (fan_in: every axis after the first),
  N(0, 0.02) embeddings (and llava's class embedding and image newline),
  unit norm gains, zero biases, routers (``mlp.gate.weight``)
  N(0, router_std²/fan_in). Returns the seconds."""
  import struct

  t0 = time.perf_counter()
  header, offset = {"__metadata__": {"format": "pt"}}, 0
  for name, shape in shapes.items():
    n = math.prod(shape) * 2
    header[name] = {"dtype": "BF16", "shape": list(shape), "data_offsets": [offset, offset + n]}
    offset += n
  raw = json.dumps(header, separators=(",", ":")).encode()
  raw += b" " * (-len(raw) % 8)
  gen = torch.Generator(device="cuda").manual_seed(seed)
  path.mkdir(parents=True, exist_ok=True)
  (path / "config.json").write_text(json.dumps(config, indent=1))
  with open(path / "model.safetensors", "wb") as f:
    f.write(struct.pack("<Q", len(raw)))
    f.write(raw)
    small = ("embed_tokens.weight", "class_embedding", "image_newline")
    for name, shape in shapes.items():
      if name.endswith(".bias"):
        t = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
      elif len(shape) == 1 and not name.endswith(small):
        t = torch.ones(shape, dtype=torch.bfloat16, device="cuda")
      else:
        fan_in = math.prod(shape[1:])
        scale = 0.02 if name.endswith(small) else router_std * fan_in**-0.5 if name.endswith("mlp.gate.weight") else fan_in**-0.5
        t = (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)
      f.write(t.view(torch.uint8).cpu().numpy().data)
  return time.perf_counter() - t0


def moe_params_on_card(torch, layers: int, seed: int = SEED + 17):
  """(cfg, params): the port's parameter tree of a random Qwen3-30B-A3B at
  ``layers`` deep, drawn on the card from ``write_moe_checkpoint``'s
  distributions (other draws), one layer slice at a time, for a depth
  whose checkpoint is too large to write for one run (48 layers: ~61 GB)."""
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard
  from xotorch_support_jetson_tpu_torch.models.config import config_from_hf
  from xotorch_support_jetson_tpu_torch.models.loader import check_shard_params

  cfg = config_from_hf(dict(QWEN3_30B_A3B, num_hidden_layers=layers))
  D, V, E, F, hd = cfg.dim, cfg.vocab_size, cfg.n_experts, cfg.moe_hidden_dim, cfg.head_dim
  gen = torch.Generator(device="cuda").manual_seed(seed)

  def w(shape, scale, L=layers):
    out = torch.empty((L, *shape), dtype=torch.bfloat16, device="cuda")
    for i in range(L):
      out[i].copy_(torch.randn(shape, generator=gen, device="cuda") * scale)
    return out

  def ones(*shape):
    return torch.ones(shape, dtype=torch.bfloat16, device="cuda")

  lay = {
    "attn_norm": ones(layers, D), "mlp_norm": ones(layers, D), "q_norm": ones(layers, hd), "k_norm": ones(layers, hd),
    "wq": w((D, cfg.q_dim), D**-0.5), "wk": w((D, cfg.kv_dim), D**-0.5), "wv": w((D, cfg.kv_dim), D**-0.5), "wo": w((cfg.q_dim, D), cfg.q_dim**-0.5),
    "w_router": w((D, E), MOE_ROUTER_STD * D**-0.5),
    "w_experts_gate": w((E, D, F), D**-0.5), "w_experts_up": w((E, D, F), D**-0.5), "w_experts_down": w((E, F, D), F**-0.5),
  }
  params = {"moe_layers": lay, "embed": w((V, D), 0.02, L=1)[0], "final_norm": ones(D), "lm_head": w((D, V), D**-0.5, L=1)[0]}
  check_shard_params(params, cfg, Shard(MOE_MODEL, 0, layers - 1, layers))
  return cfg, params


def moe_plain_f32(torch, params, cfg, ids: list[int], n_last: int = 2):
  """A plain f32 forward of Qwen3-MoE over the served weights, written out
  here from the published architecture (each layer's weights cast to f32
  as it runs): per layer the pre-attention norm, q/k/v, the per-head q/k
  norms, HF rope, causal GQA softmax attention, o; the pre-MLP norm, the
  router's softmax over the experts, the top k renormalised, and each
  expert's SwiGLU on the tokens routed to it (gathered on the host: this
  is no serving path); the final norm and the untied head. Also counts
  the routing decisions whose k-th and (k+1)-th scores lie within 1 % of
  each other (near-ties, where bf16 and f32 may route differently).
  Returns (logits [n_last, V] f32 of the last positions, near-ties,
  routing decisions)."""
  lay = params["moe_layers"]
  S, H, Hkv, hd, k = len(ids), cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_active_experts
  dev = params["embed"].device
  x = torch.tensor(ids, device=dev)

  def rms(v, w):
    return v * torch.rsqrt(v.pow(2).mean(-1, keepdim=True) + cfg.norm_eps) * w.float()

  inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, hd, 2, device=dev, dtype=torch.float32) / hd))
  ang = torch.arange(S, device=dev, dtype=torch.float32)[:, None] * inv[None, :]
  cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]

  def rope(v):
    a, b = v.chunk(2, dim=-1)
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)

  pos = torch.arange(S, device=dev)
  causal = pos[None, :] <= pos[:, None]
  h = params["embed"][x].float()
  ties = 0
  for i in range(lay["wq"].shape[0]):
    p = {key: v[i] for key, v in lay.items()}
    a = rms(h, p["attn_norm"])
    q = rope(rms((a @ p["wq"].float()).view(S, H, hd), p["q_norm"]))
    kk = rope(rms((a @ p["wk"].float()).view(S, Hkv, hd), p["k_norm"])).repeat_interleave(H // Hkv, dim=1)
    v = (a @ p["wv"].float()).view(S, Hkv, hd).repeat_interleave(H // Hkv, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, kk) / math.sqrt(hd)
    s = torch.softmax(s.masked_fill(~causal[None], -math.inf), dim=-1)
    h = h + torch.einsum("hqk,khd->qhd", s, v).reshape(S, H * hd) @ p["wo"].float()
    m = rms(h, p["mlp_norm"])
    probs = torch.softmax(m @ p["w_router"].float(), dim=-1)
    top = torch.topk(probs, k + 1, dim=-1)
    ties += int((top.values[:, k - 1] - top.values[:, k] < 1e-2 * top.values[:, k - 1]).sum())
    w, idx = top.values[:, :k], top.indices[:, :k]
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(m)
    for e in idx.unique().tolist():
      rows, slot = (idx == e).nonzero(as_tuple=True)
      xe = m[rows]
      ye = (torch.nn.functional.silu(xe @ p["w_experts_gate"][e].float()) * (xe @ p["w_experts_up"][e].float())) @ p["w_experts_down"][e].float()
      out.index_add_(0, rows, ye * w[rows, slot][:, None])
    h = h + out
  return rms(h[-n_last:], params["final_norm"]) @ params["lm_head"].float(), ties, S * lay["wq"].shape[0]


def _moe_weights(torch, gen, weights: str, ffn: dict):
  """One layer's router and experts at ``ffn``'s shapes, seeded random
  bf16 (N(0, 1/fan_in)), optionally quantized as the served model
  quantizes them: (router, gate, up, down, scales)."""
  from xotorch_support_jetson_tpu_torch.models.quantize import quantize_params

  D, E, F = ffn["D"], ffn["E"], ffn["F"]
  router = _rand(torch, (D, E), gen, torch.float32).mul_(D**-0.5).to(torch.bfloat16)
  w = {"w_experts_gate": (E, D, F), "w_experts_up": (E, D, F), "w_experts_down": (E, F, D)}
  w = {k: _rand(torch, shape, gen, torch.float32).mul_(shape[1] ** -0.5).to(torch.bfloat16) for k, shape in w.items()}
  scales = {}
  if weights != "bf16":
    q = quantize_params({"moe_layers": {k: v[None] for k, v in w.items()}}, weights)["moe_layers"]
    w = {k: q[k][0] for k in w}
    scales = dict(gate_scale=q["w_experts_gate_scale"][0], up_scale=q["w_experts_up_scale"][0], down_scale=q["w_experts_down_scale"][0])
  return router, w["w_experts_gate"], w["w_experts_up"], w["w_experts_down"], scales


def moe_path_rows(torch, weights: str = "bf16", Ts=MOE_PATH_TS, ffn: dict | None = None):
  """Device ms of one layer's routed FFN (ops/moe.py ``moe_ffn``) at
  ``ffn``'s shapes (default Qwen3-30B-A3B's, ``QWEN3_MOE_FFN``: 128 experts
  of 2048 → 768, top-8 renormalised; DeepSeek-V2-Lite's ``MLA_FFN``: 64 of
  2048 → 1408, top-6 not renormalised) on both paths, at each token count
  in ``Ts``, the experts in ``weights``
  ("bf16", "int8", "int4"; dequantized next to the product as served), with
  the two outputs' relative L2 and the bytes each path must move: the
  einsum path reads every expert once (and, quantized, writes and reads
  the dequantized stacks), the gather path reads its routed slabs, writes
  the gathered copy and reads it again. Returns the rows and the largest
  T up to which the gather path was faster at every measured T (the H100
  table's entry, ops/moe.py ``H100_GATHER_MAX``)."""
  from xotorch_support_jetson_tpu_torch.ops import moe

  ffn = ffn or QWEN3_MOE_FFN
  D, E, F, k, norm = ffn["D"], ffn["E"], ffn["F"], ffn["k"], ffn["norm_topk"]
  gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
  router, g, u, d, scales = _moe_weights(torch, gen, weights, ffn)
  expert_bytes = sum(t.numel() * t.element_size() for t in (g, u, d, *scales.values()))
  slab = expert_bytes / E
  deq = 0 if weights == "bf16" else 2 * 3 * E * D * F * 2  # the dequantized stacks written and read again
  rows, saved = [], (os.environ.get("XOT_TPU_MOE_GATHER"), moe.REFERENCE_GATHER_MAX)
  moe.REFERENCE_GATHER_MAX = 1 << 20  # XOT_TPU_MOE_GATHER=1: the gather path at any T
  try:
    for T in Ts:
      x = _rand(torch, (T, D), gen, torch.bfloat16)

      def run(knob):
        os.environ["XOT_TPU_MOE_GATHER"] = knob
        return moe.moe_ffn(x, router, g, u, d, k=k, norm_topk=norm, hidden_dim=F, **scales)

      err = _rel_err(run("1"), run("0"))
      os.environ["XOT_TPU_MOE_GATHER"] = "1"
      gather_ms = _cuda_ms(torch, lambda: moe.moe_ffn(x, router, g, u, d, k=k, norm_topk=norm, hidden_dim=F, **scales), iters=20)
      os.environ["XOT_TPU_MOE_GATHER"] = "0"
      einsum_ms = _cuda_ms(torch, lambda: moe.moe_ffn(x, router, g, u, d, k=k, norm_topk=norm, hidden_dim=F, **scales), iters=20)
      gbytes = T * k * (slab + (2 * 3 * D * F * 2))  # routed slabs read, their dequantized/gathered copies written and read
      ebytes = expert_bytes + deq
      rows.append(dict(T=T, E=E, k=k, F=F, weights=weights, gather_ms=gather_ms, einsum_ms=einsum_ms, rel_err=err, gather_bytes=gbytes, einsum_bytes=ebytes,
                       gather_bound_ms=gbytes / HBM_BYTES_PER_S * 1e3, einsum_bound_ms=ebytes / HBM_BYTES_PER_S * 1e3))
      log(f"[moe] paths, {E} experts of {F} top-{k}, {weights} experts, T={T}: gather {gather_ms:.4f} ms (bytes bound {rows[-1]['gather_bound_ms']:.4f}), einsum {einsum_ms:.4f} ms (bound {rows[-1]['einsum_bound_ms']:.4f}); outputs rel L2 {err:.2e}")
      del x
  finally:
    moe.REFERENCE_GATHER_MAX = saved[1]
    if saved[0] is None:
      os.environ.pop("XOT_TPU_MOE_GATHER", None)
    else:
      os.environ["XOT_TPU_MOE_GATHER"] = saved[0]
  best = 0
  for r in rows:
    if r["gather_ms"] >= r["einsum_ms"]:
      break
    best = r["T"]
  bad = [r for r in rows if not r["rel_err"] < 1e-2]
  if bad:
    raise SystemExit(f"chip_smoke: [moe] the two MoE paths disagree: {bad}")
  del router, g, u, d, scales
  torch.cuda.empty_cache()
  return rows, best


def _moe_path_counts() -> dict:
  """MoE calls by path and token count since the last ``_reset_launches()``
  (ops/moe.py ``PATHS``, plus those made inside replayed CUDA graphs)."""
  from xotorch_support_jetson_tpu_torch.ops import moe
  from xotorch_support_jetson_tpu_torch.utils import programs

  out = dict(moe.PATHS)
  for key, n in programs.REPLAYED.items():
    if "@" in key:
      out[key] = out.get(key, 0) + n
  return out


def _check_moe_paths(tag: str, counts: dict, weights: str, ffn: dict | None = None) -> dict:
  """Every MoE call took the path the H100 table (ops/moe.py
  ``gather_max``) gives its token count at ``ffn``'s expert count and top-k
  (default Qwen3-30B-A3B's): the gather path up to the table's T, the
  einsum path up to 256 tokens, chunks of 256 beyond. Returns the calls by
  path."""
  from xotorch_support_jetson_tpu_torch.ops.moe import gather_max

  ffn = ffn or QWEN3_MOE_FFN
  limit = gather_max("cuda", ffn["E"], ffn["k"], weights)

  def want(T):
    return "gather" if T <= limit else "einsum" if T <= 256 else "chunked"

  wrong = {k: n for k, n in counts.items() if k.split("@")[0] != want(int(k.split("@")[1]))}
  if not counts or wrong:
    raise SystemExit(f"chip_smoke: [{tag}] MoE paths against the H100 table (gather up to T = {limit}, {weights} experts): {counts}; off the table: {wrong}")
  by_path: dict[str, int] = {}
  for k, n in counts.items():
    by_path[k.split("@")[0]] = by_path.get(k.split("@")[0], 0) + n
  return by_path


def _moe_chat(stream: bool, max_tokens: int = MAX_TOKENS) -> dict:
  return {"model": MOE_MODEL, "messages": CHAT, "stream": stream, "temperature": 0, "max_tokens": max_tokens}


def _moe_cfg_problem(cfg) -> str:
  ok = cfg.family == "qwen3-moe" and cfg.n_experts == 128 and cfg.n_active_experts == 8 and cfg.moe_hidden_dim == 768 and cfg.norm_topk_prob and cfg.qk_norm and cfg.head_dim == 128
  return "" if ok else "not Qwen3-30B-A3B's"


def phase_moe(torch, ckpt: Path | None, smi: str, full: bool = True, preload=None):
  """Qwen3-30B-A3B at full width (the checkpoint's depth): the two MoE
  paths timed at Qwen3-30B-A3B's expert shapes (bf16 and int4 experts),
  then the daemon: solo bf16 (captured) and batched at the defaults on the
  same engine, then solo with ``XOT_TPU_QUANT=int4``. Without ``full``
  (a depth whose bf16 stacks and int4 codes would not fit on the card
  together), the solo bf16 daemon alone; ``preload`` as in
  ``_daemon_up`` (no checkpoint then)."""
  from xotorch_support_jetson_tpu_torch import main as tmain
  from xotorch_support_jetson_tpu_torch.ops import moe

  out: dict = {"paths": {}}
  for weights in ("bf16", "int4") if full else ():
    rows, best = moe_path_rows(torch, weights)
    out["paths"][weights] = dict(rows=rows, gather_max=best, table=moe.H100_GATHER_MAX.get((128, 8, weights)))
    log(f"[moe] {weights} experts: the gather path was faster up to T = {best} in this run; ops/moe.py's H100 table holds {out['paths'][weights]['table']} | {smi}")
  args, port = _daemon_args(tmain, ckpt or ROOT / "build" / "no_checkpoint", model=MOE_MODEL)
  try:
    out["bf16"] = asyncio.run(_moe_bf16(torch, tmain, args, port, smi, batched=full, preload=preload))
  finally:
    for knob in ("XOT_TPU_BATCHED", "XOT_TPU_BATCH_SLOTS", "XOT_TPU_PAGE_SIZE"):
      os.environ.pop(knob, None)
    gc.collect()
    torch.cuda.empty_cache()
  if not full:
    return out
  args, port = _daemon_args(tmain, ckpt, model=MOE_MODEL)
  os.environ["XOT_TPU_QUANT"] = "int4"
  try:
    out["int4"] = asyncio.run(_moe_int4(torch, tmain, args, port, smi))
  finally:
    os.environ.pop("XOT_TPU_QUANT", None)
    gc.collect()
    torch.cuda.empty_cache()
  return out


async def _moe_counted(torch, node, engine, port, label):
  """Greedy blocking and streaming chat after a warm-up pair of the same
  kinds, the launch and MoE path counts zeroed just before and read just
  after; (replies, launches, MoE path counts, builds and captures made by
  the counted requests, by family)."""
  from xotorch_support_jetson_tpu_torch.utils import programs

  await _serve_requests(torch, node, engine, port, [("warmup blocking", _moe_chat(False)), ("warmup streaming", _moe_chat(True))])
  fam0 = programs.ledger.snapshot()["families"]
  _reset_launches()  # ---- the solo MoE path, counted
  run = await _serve_requests(torch, node, engine, port, [(f"{label} greedy blocking", _moe_chat(False)), (f"{label} greedy streaming", _moe_chat(True))])
  launches, paths = _kernel_launches(), _moe_path_counts()  # ---- read just after
  fam1 = programs.ledger.snapshot()["families"]
  built = {f: (v["compiles"] - fam0.get(f, {}).get("compiles", 0), v["captures"] - fam0.get(f, {}).get("captures", 0)) for f, v in fam1.items()}
  built = {f: bc for f, bc in built.items() if any(bc)}
  if run[0]["tokens"] != run[1]["tokens"]:
    raise SystemExit(f"chip_smoke: [moe] {label}: greedy blocking and streaming differ:\n{run[0]['tokens']}\n{run[1]['tokens']}")
  if built:
    raise SystemExit(f"chip_smoke: [moe] {label}: the counted requests built or captured programs after the warm-up (family: builds, captures): {built}")
  return run, launches, paths


async def _moe_bf16(torch, tmain, args, port, smi, batched: bool = True, preload=None):
  node, server, engine, load_s = await _daemon_up(torch, tmain, args, port, "moe", MOE_MODEL, "bf16", _moe_cfg_problem, preload)
  res = dict(load_s=load_s, card=smi, weight_bytes=sum(t.numel() * t.element_size() for t in _leaves(engine.params)))
  try:
    cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
    L = cfg.n_layers
    log(f"[moe] config: Qwen/Qwen3-30B-A3B's published shapes (hidden 2048, {L} of its 48 layers, 32/4 heads, head_dim 128, 128 experts of 768, top-8 renormalised, qk-norm, vocab 151936, untied head, rope theta 1e6), random bf16 weights; bos/eos written as the byte tokenizer's 128000/128009; serving cap {engine.max_seq_len}")
    run, launches, paths = await _moe_counted(torch, node, engine, port, "bf16")
    by_path = _check_moe_paths("moe", paths, "bf16")
    prefills = 2
    if launches["flash_prefill"] != L * prefills or launches["flash_decode"] or launches["paged_decode"] or launches["int4_matmul"]:
      raise SystemExit(f"chip_smoke: [moe] solo bf16: launches {launches}, expected K1 {L} per prefill ({prefills} prefills) and nothing else")
    res.update(launches=launches, moe_paths=paths, moe_by_path=by_path, tokens=run[0]["tokens"], ttft_s=run[1]["ttft_s"], decode_tok_s=_decode_rate(run[1]), peak_allocated=torch.cuda.max_memory_allocated())
    log(f"[moe] solo bf16: greedy blocking == streaming ({len(run[0]['tokens'])} tokens); TTFT {res['ttft_s']:.4f} s, decode {res['decode_tok_s']:.1f} tok/s | launches {launches} (K1 {L} a prefill) | MoE calls by path and T {paths}, each on the H100 table's path | no build or capture after the warm-up | {smi}")
    # The served logits against the plain f32 forward: the captured prefill's
    # last token and one captured decode step after it.
    ids = ByteTokenizer().encode(ByteTokenizer().apply_chat_template(CHAT))
    served_pre, _ = engine._infer_tensor_sync("moe-check", np.asarray([ids], np.int32), None)
    nxt = int(np.argmax(served_pre[0]))
    served_step, _ = engine._infer_tensor_sync("moe-check", np.asarray([[nxt]], np.int32), None)
    engine.end_request("moe-check")
    served = torch.from_numpy(np.stack([served_pre[0], served_step[0]])).cuda().float()
    t0 = time.perf_counter()
    with torch.no_grad():
      ref, ties, decisions = moe_plain_f32(torch, params, cfg, ids + [nxt])
    err = [_rel_err(served[i], ref[i]) for i in range(2)]
    res["check"] = dict(positions=[len(ids) - 1, len(ids)], rel_err=err, near_ties=ties, routing_decisions=decisions, argmax_agree=[int(served[i].argmax()) == int(ref[i].argmax()) for i in range(2)], ref_s=time.perf_counter() - t0)
    log(f"[moe] served logits at positions {len(ids) - 1} (captured prefill) and {len(ids)} (captured step) against a plain f32 forward on the same weights: rel L2 {err[0]:.3e} / {err[1]:.3e} (limit {MOE_CHECK_TOL}); argmax agree {res['check']['argmax_agree']}; near-tied routing decisions (k-th and (k+1)-th scores within 1 %) {ties} of {decisions}")
    del ref
    if not max(err) < MOE_CHECK_TOL:
      raise SystemExit(f"chip_smoke: [moe] served logits: {res['check']}")
    res["graphs"] = _moe_graphs_against_eager(torch, engine)
    res["profile"] = _moe_profile(torch, engine, smi)
    if not batched:
      return res
    engine._cache_pool.clear()
    engine._graph_pool = None
    gc.collect()
    torch.cuda.empty_cache()
    res["batched"] = b = await _batched_defaults(torch, node, engine, port, smi, MOE_MODEL, "moe", "kernel")
    bl = b["launches"]
    if not bl["flash_prefill"] or bl["flash_prefill"] % L or not bl["paged_decode"] or bl["paged_decode"] % L or bl["flash_decode"] or bl["int4_matmul"]:
      raise SystemExit(f"chip_smoke: [moe] batched: launches {bl}, expected K1 and K3 in whole multiples of {L} (once per layer per forward) and no K2 / K4")
    b["moe_by_path"] = _check_moe_paths("moe", b["moe_paths"], "bf16")
    log(f"[moe] batched: MoE calls by path and T {b['moe_paths']}, each on the H100 table's path; K1 {bl['flash_prefill']} and K3 {bl['paged_decode']} launches, once per layer per forward")
    return res
  finally:
    await _daemon_down(node, server, engine)


def _moe_graphs_against_eager(torch, engine):
  """Captured equals uncaptured on the MoE model: the engine's captured
  128-bucket prefill and greedy blocking / chunked decode (64 tokens)
  against the uncaptured functions on a fresh 4096-slot cache (ids
  identical, prefill logits within 5e-2 relative L2)."""
  prompt = np.asarray([ByteTokenizer().encode(CHECK_PROMPT)], dtype=np.int32)
  rows = []
  for rnd, chunks in enumerate(((), (32, 32))):
    want_logits, want = _eager_solo(torch, engine, prompt, 0.0, 0, chunks)
    got_logits, got = _captured_solo(torch, engine, f"moe-graphs-{rnd}", prompt, 0.0, 0, chunks)
    err = _rel_err(got_logits.cuda(), want_logits)
    rows.append(dict(kind="streaming" if chunks else "blocking", identical=got == want, prefill_rel_err=err))
    if got != want or not err < 5e-2:
      raise SystemExit(f"chip_smoke: [moe] captured differs from uncaptured ({rows[-1]}):\n{got}\n{want}")
  log(f"[moe] captured against uncaptured: {rows}")
  return rows


def _moe_profile(torch, engine, smi):
  """The captured decode step at position 100 of the 4096-slot cache
  (wall and device ms, ``_replay_ms``; torch.profiler's kernels over its
  replays), and the step's routed FFN alone: the layers' ``_moe_block``
  at T = 1 captured as one CUDA graph on the step's shapes and timed the
  same way, its share of the step's device time."""
  from xotorch_support_jetson_tpu_torch.models.decoder import _moe_block, fused_decode

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  session = engine._new_session("moe-profile", 1)
  progs = session.programs
  n = GRAPH_PROFILE_STEPS
  try:
    step = lambda: fused_decode(params, cfg, shard, 65, progs.cache, 100, n, programs=progs)  # noqa: E731
    wall, device = _replay_ms(torch, step, n)
    prof = _profile(torch, f"moe decode, {n} captured steps", step, 2)
  finally:
    engine.end_request("moe-profile")
  gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
  x = _rand(torch, (1, 1, cfg.dim), gen, cfg.dtype)
  out = torch.empty_like(x)
  layers = [{k: v[i] for k, v in params["moe_layers"].items()} for i in range(cfg.n_layers)]

  def ffn():
    for p in layers:
      out.copy_(_moe_block(x, p, cfg))

  ffn_device = _captured_ms(torch, ffn)
  res = dict(step_wall_ms=wall, step_device_ms=device, step_profiler_device_ms=prof["device_ms"] / n if prof["device_ms"] else None, moe_ffn_device_ms=ffn_device, moe_ffn_share=ffn_device / device, top_device_ops=prof["top_device_ops"])
  log(f"[profile] moe decode step at position 100 of {CACHE} slots (captured, {cfg.n_layers} layers): wall {wall:.3f} ms, device {device:.3f} ms; the routed FFN of the {cfg.n_layers} layers captured alone at T = 1 (gather path) {ffn_device:.3f} ms device: share {res['moe_ffn_share']:.3f} | {smi}")
  return res


def _captured_ms(torch, fn) -> float:
  """Device ms of ``fn`` captured alone as one CUDA graph and replayed
  (``_replay_ms``): a part of a step timed on the step's own shapes."""
  fn()
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph()
  stream = torch.cuda.Stream()
  stream.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(stream):
    graph.capture_begin()
    fn()
    graph.capture_end()
  torch.cuda.current_stream().wait_stream(stream)
  device = _replay_ms(torch, graph.replay, 1)[1]
  del graph
  return device


async def _moe_int4(torch, tmain, args, port, smi):
  """Qwen3-30B-A3B with ``XOT_TPU_QUANT=int4`` (quantized on the card at
  load): greedy blocking and streaming ids equal, K4 once per
  two-dimensional quantized product per forward (q, k, v, o a layer and the
  head: the experts are dequantized next to their product, as in the
  reference), no non-kernel int4 product, the MoE calls on the table's int4
  paths."""
  from xotorch_support_jetson_tpu_torch.ops import int4_matmul as k4

  node, server, engine, load_s = await _daemon_up(torch, tmain, args, port, "moe", MOE_MODEL, "int4", _moe_cfg_problem)
  try:
    L = engine.cfg.n_layers
    per_forward = 4 * L + 1
    lay = engine.params["moe_layers"]
    if "lm_head_scale" not in engine.params or "w_experts_gate_scale" not in lay or lay["w_experts_gate"].shape[-2] * 2 != engine.cfg.dim:
      raise SystemExit("chip_smoke: [moe] int4: the head or the experts are not int4")
    two_dot0 = k4.CALLS["int4_two_dot"]
    run, launches, paths = await _moe_counted(torch, node, engine, port, "int4")
    two_dot = k4.CALLS["int4_two_dot"] - two_dot0
    by_path = _check_moe_paths("moe", paths, "int4")
    if launches["int4_matmul"] == 0 or launches["int4_matmul"] % per_forward or two_dot or launches["flash_prefill"] != 2 * L:
      raise SystemExit(f"chip_smoke: [moe] int4: launches {launches} (K4 not a multiple of {per_forward} per forward, or K1 not {L} per prefill), {two_dot} int4_two_dot calls")
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(engine.params))
    res = dict(load_s=load_s, launches=launches, per_forward=per_forward, forwards=launches["int4_matmul"] // per_forward, weight_bytes=weight_bytes, moe_paths=paths, moe_by_path=by_path, tokens=run[0]["tokens"], ttft_s=run[1]["ttft_s"], decode_tok_s=_decode_rate(run[1]))
    log(f"[moe] solo int4 weights ({weight_bytes / 1e9:.2f} GB on the card): greedy blocking == streaming ({len(run[0]['tokens'])} tokens), TTFT {res['ttft_s']:.4f} s, decode {res['decode_tok_s']:.1f} tok/s | K4 {launches['int4_matmul']} launches = {res['forwards']} forwards × {per_forward} | launches {launches} | MoE calls by path and T {paths}, each on the H100 table's int4 path | {smi}")
    return res
  finally:
    await _daemon_down(node, server, engine)


# ---------------------------------------------------------------- 8d. mla


# deepseek-ai/DeepSeek-Coder-V2-Lite-Instruct's published config.json (the
# deepseek-coder-v2-lite card; its bos / eos 100000 / 100001 are the
# ``DeepseekByteTokenizer``'s).
DEEPSEEK_CODER_V2_LITE = {
  "architectures": ["DeepseekV2ForCausalLM"], "model_type": "deepseek_v2", "vocab_size": 102400, "hidden_size": 2048, "intermediate_size": 10944,
  "moe_intermediate_size": 1408, "num_hidden_layers": 27, "num_attention_heads": 16, "num_key_value_heads": 16, "n_shared_experts": 2, "n_routed_experts": 64,
  "routed_scaling_factor": 1.0, "kv_lora_rank": 512, "q_lora_rank": None, "qk_rope_head_dim": 64, "v_head_dim": 128, "qk_nope_head_dim": 128,
  "topk_method": "greedy", "n_group": 1, "topk_group": 1, "num_experts_per_tok": 6, "moe_layer_freq": 1, "first_k_dense_replace": 1, "norm_topk_prob": False,
  "scoring_func": "softmax", "aux_loss_alpha": 0.001, "seq_aux": True, "hidden_act": "silu", "max_position_embeddings": 163840, "rms_norm_eps": 1e-6,
  "rope_theta": 10000, "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707, "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096, "type": "yarn"},
  "attention_bias": False, "tie_word_embeddings": False, "torch_dtype": "bfloat16", "bos_token_id": 100000, "eos_token_id": 100001,
}
# deepseek-ai/DeepSeek-V3's published config.json (one attention layer of it
# is held at full width: ``mla_v3_attention_check``).
DEEPSEEK_V3 = {
  "architectures": ["DeepseekV3ForCausalLM"], "model_type": "deepseek_v3", "vocab_size": 129280, "hidden_size": 7168, "intermediate_size": 18432,
  "moe_intermediate_size": 2048, "num_hidden_layers": 61, "num_attention_heads": 128, "num_key_value_heads": 128, "n_shared_experts": 1, "n_routed_experts": 256,
  "routed_scaling_factor": 2.5, "kv_lora_rank": 512, "q_lora_rank": 1536, "qk_rope_head_dim": 64, "v_head_dim": 128, "qk_nope_head_dim": 128,
  "topk_method": "noaux_tc", "n_group": 8, "topk_group": 4, "num_experts_per_tok": 8, "moe_layer_freq": 1, "first_k_dense_replace": 3, "norm_topk_prob": True,
  "scoring_func": "sigmoid", "max_position_embeddings": 163840, "rms_norm_eps": 1e-6, "rope_theta": 10000,
  "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 1.0, "mscale_all_dim": 1.0, "original_max_position_embeddings": 4096, "type": "yarn"},
  "tie_word_embeddings": False, "torch_dtype": "bfloat16", "bos_token_id": 0, "eos_token_id": 1,
}
MLA_MODEL = "deepseek-coder-v2-lite"
# 8 of the 27 layers (layer 0 dense, seven MoE layers; ~9.2 GB of bf16
# weights): the whole smoke run must end within the 1,200 s it is given,
# and a call may write 45 GiB beside the llama, gemma2 and MoE
# checkpoints. scripts/mla_phase.py --layers 27 serves the full depth
# (~31.4 GB, drawn on the card) in a call of its own.
MLA_LAYERS = 8
MLA_CHECK_TOL = 5e-2  # relative L2 of the served logits against the naive f32 forward, and of the V3-width layer
MLA_ROUTER_STD = 3.0  # the random routers' logit scale, as ``MOE_ROUTER_STD``
MLA_FFN = dict(E=64, k=6, D=2048, F=1408, norm_topk=False)  # DeepSeek-V2-Lite's routed experts
MLA_NORM_EPS = 1e-6  # HF deepseek's q_a / kv_a layernorm eps, whatever rms_norm_eps says
# DeepSeek-Coder-V2-Lite's two-dimensional weight products, (in, out), for
# K4 under int4 weights: q, the latent projection, o (every layer), layer
# 0's dense MLP, the shared experts (every MoE layer) and the untied head.
# kv_b and the routed experts are dequantized next to their use, as in the
# reference.
DEEPSEEK_V2_LITE_MATMULS = {
  "wq": (2048, 3072), "wkv_a": (2048, 576), "wo": (2048, 2048), "w_gate/w_up": (2048, 10944), "w_down": (10944, 2048),
  "w_shared_gate/w_shared_up": (2048, 2816), "w_shared_down": (2816, 2048), "lm_head": (2048, 102400),
}


class DeepseekByteTokenizer(ByteTokenizer):
  """The byte tokenizer with DeepSeek-Coder-V2-Lite's published BOS / EOS
  ids (128000 / 128009 lie past its 102,400-token vocabulary)."""

  bos_token_id = 100000
  eos_token_id = 100001


def mla_shapes(layers: int = MLA_LAYERS) -> dict:
  """HF tensor name → shape of the DeepSeek-Coder-V2-Lite checkpoint at
  ``layers``: a direct q_proj (no q LoRA), the latent projection with its
  MQA rope channel, the latent norm, kv_b, o; layer 0's dense MLP, then
  per MoE layer the router, two shared experts (one fused 2816-wide MLP in
  HF's layout) and 64 routed experts."""
  c = DEEPSEEK_CODER_V2_LITE
  D, V, F, Fm, E, H = c["hidden_size"], c["vocab_size"], c["intermediate_size"], c["moe_intermediate_size"], c["n_routed_experts"], c["num_attention_heads"]
  rank, rope, nope, vd = c["kv_lora_rank"], c["qk_rope_head_dim"], c["qk_nope_head_dim"], c["v_head_dim"]
  Fs = c["n_shared_experts"] * Fm
  shapes = {"model.embed_tokens.weight": (V, D), "model.norm.weight": (D,), "lm_head.weight": (V, D)}
  for i in range(layers):
    p = f"model.layers.{i}."
    shapes.update({
      p + "input_layernorm.weight": (D,), p + "post_attention_layernorm.weight": (D,), p + "self_attn.q_proj.weight": (H * (nope + rope), D),
      p + "self_attn.kv_a_proj_with_mqa.weight": (rank + rope, D), p + "self_attn.kv_a_layernorm.weight": (rank,),
      p + "self_attn.kv_b_proj.weight": (H * (nope + vd), rank), p + "self_attn.o_proj.weight": (D, H * vd),
    })
    if i < c["first_k_dense_replace"]:
      shapes.update({p + "mlp.gate_proj.weight": (F, D), p + "mlp.up_proj.weight": (F, D), p + "mlp.down_proj.weight": (D, F)})
      continue
    shapes.update({p + "mlp.gate.weight": (E, D), p + "mlp.shared_experts.gate_proj.weight": (Fs, D), p + "mlp.shared_experts.up_proj.weight": (Fs, D), p + "mlp.shared_experts.down_proj.weight": (D, Fs)})
    for e in range(E):
      shapes.update({f"{p}mlp.experts.{e}.gate_proj.weight": (Fm, D), f"{p}mlp.experts.{e}.up_proj.weight": (Fm, D), f"{p}mlp.experts.{e}.down_proj.weight": (D, Fm)})
  return shapes


def write_mla_checkpoint(torch, path: Path, layers: int = MLA_LAYERS, seed: int = SEED + 18) -> float:
  """Seeded random bf16 weights at DeepSeek-Coder-V2-Lite's shapes and
  ``layers`` of its depth, HF names, written tensor by tensor
  (``_write_seeded_checkpoint``; routers of logit std ``MLA_ROUTER_STD``,
  as the MoE checkpoint's: flat random routers near-tie too often for a
  bf16 forward to route as the f32 one does)."""
  return _write_seeded_checkpoint(torch, path, dict(DEEPSEEK_CODER_V2_LITE, num_hidden_layers=layers), mla_shapes(layers), seed, MLA_ROUTER_STD)


def mla_params_on_card(torch, layers: int, seed: int = SEED + 18):
  """(cfg, params): the port's parameter tree of a random
  DeepSeek-Coder-V2-Lite at ``layers`` deep, drawn on the card from
  ``write_mla_checkpoint``'s distributions (other draws), one layer slice
  at a time: the full depth's checkpoint (~31.4 GB) is not written for one
  run."""
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard
  from xotorch_support_jetson_tpu_torch.models.config import config_from_hf
  from xotorch_support_jetson_tpu_torch.models.loader import check_shard_params

  cfg = config_from_hf(dict(DEEPSEEK_CODER_V2_LITE, num_hidden_layers=layers))
  D, V, F, E, Fm, Fs, H = cfg.dim, cfg.vocab_size, cfg.hidden_dim, cfg.n_experts, cfg.moe_hidden_dim, cfg.shared_expert_dim, cfg.n_heads
  rank, rope, qk, vd = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.qk_head_dim, cfg.v_head_dim
  gen = torch.Generator(device="cuda").manual_seed(seed)

  def w(shape, scale, L):
    out = torch.empty((L, *shape), dtype=torch.bfloat16, device="cuda")
    for i in range(L):
      out[i].copy_(torch.randn(shape, generator=gen, device="cuda") * scale)
    return out

  def ones(*shape):
    return torch.ones(shape, dtype=torch.bfloat16, device="cuda")

  def attn(L):
    return {
      "attn_norm": ones(L, D), "mlp_norm": ones(L, D), "kv_a_norm": ones(L, rank), "wq": w((D, H * qk), D**-0.5, L), "wkv_a": w((D, rank + rope), D**-0.5, L),
      "wkv_b": w((rank, H * (cfg.qk_nope_head_dim + vd)), rank**-0.5, L), "wo": w((H * vd, D), (H * vd) ** -0.5, L),
    }

  n_dense, Lm = cfg.first_k_dense, layers - cfg.first_k_dense
  dense = {**attn(n_dense), "w_gate": w((D, F), D**-0.5, n_dense), "w_up": w((D, F), D**-0.5, n_dense), "w_down": w((F, D), F**-0.5, n_dense)}
  moe = {
    **attn(Lm), "w_router": w((D, E), MLA_ROUTER_STD * D**-0.5, Lm),
    "w_experts_gate": w((E, D, Fm), D**-0.5, Lm), "w_experts_up": w((E, D, Fm), D**-0.5, Lm), "w_experts_down": w((E, Fm, D), Fm**-0.5, Lm),
    "w_shared_gate": w((D, Fs), D**-0.5, Lm), "w_shared_up": w((D, Fs), D**-0.5, Lm), "w_shared_down": w((Fs, D), Fs**-0.5, Lm),
  }
  params = {"layers": dense, "moe_layers": moe, "embed": w((V, D), 0.02, 1)[0], "final_norm": ones(D), "lm_head": w((D, V), D**-0.5, 1)[0]}
  check_shard_params(params, cfg, Shard(MLA_MODEL, 0, layers - 1, layers))
  return cfg, params


def _yarn_plain(torch, c: dict, dev):
  """(inverse frequencies [rope/2], cos/sin factor) of the published
  ``rope_scaling`` (yarn), written out from its definition: NTK-by-parts
  between the beta_fast / beta_slow correction dims (floored / ceiled),
  interpolated by ``factor`` below, and the attention factor
  mscale(factor, mscale) / mscale(factor, mscale_all_dim)."""
  rs, dim, base = c["rope_scaling"], c["qk_rope_head_dim"], float(c["rope_theta"])

  def corr(rot):
    return dim * math.log(rs["original_max_position_embeddings"] / (rot * 2 * math.pi)) / (2 * math.log(base))

  low, high = max(math.floor(corr(rs["beta_fast"])), 0), min(math.ceil(corr(rs["beta_slow"])), dim - 1)
  freqs = base ** (torch.arange(0, dim, 2, device=dev, dtype=torch.float32) / dim)
  ramp = torch.clamp((torch.arange(dim // 2, device=dev, dtype=torch.float32) - low) / max(high - low, 1e-3), 0, 1)
  inv = (1.0 / (rs["factor"] * freqs)) * ramp + (1.0 / freqs) * (1 - ramp)

  def mscale(m):
    return 0.1 * m * math.log(rs["factor"]) + 1.0

  return inv, mscale(rs["mscale"]) / mscale(rs["mscale_all_dim"])


def _rope_interleaved_plain(torch, v, cos, sin):
  """deepseek's rope: channels (2i, 2i+1) rotate as one complex number."""
  a, b = v[..., 0::2], v[..., 1::2]
  return torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1).flatten(-2)


def mla_plain_f32(torch, params, cfg, ids: list[int], n_last: int = 2, hf: dict = DEEPSEEK_CODER_V2_LITE):
  """A plain f32 forward of DeepSeek-V2 over the served weights, written
  out here from the published architecture (each layer's weights cast to
  f32 as it runs), in the naive per-head form: per layer the pre-attention
  norm, q (direct), the latent projection and its norm (eps 1e-6), yarn's
  interleaved rope on the rope channels, per-head k / v from the latent
  through kv_b, causal softmax attention scaled by 1/sqrt(nope + rope) (the
  JAX package's scale), o; the pre-MLP norm, then layer 0's SwiGLU MLP or
  the router's softmax over the 64 experts, the top 6 unrenormalised, each
  expert's SwiGLU on the tokens routed to it (gathered on the host: this
  is no serving path) and the shared experts; the final norm and the
  untied head (``hf``: the published config whose rope scaling it
  applies). Also counts the routing decisions whose k-th and (k+1)-th
  scores lie within 1 % of each other. Returns (logits [n_last, V] f32 of
  the last positions, near-ties, routing decisions)."""
  S, H, nope, rope, vd, rank, k = len(ids), cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank, cfg.n_active_experts
  dev = params["embed"].device
  x = torch.tensor(ids, device=dev)

  def rms(v, w, eps=cfg.norm_eps):
    return v * torch.rsqrt(v.pow(2).mean(-1, keepdim=True) + eps) * w.float()

  inv, af = _yarn_plain(torch, hf, dev)
  ang = torch.arange(S, device=dev, dtype=torch.float32)[:, None] * inv[None, :]
  cos, sin = (torch.cos(ang) * af)[:, None, :], (torch.sin(ang) * af)[:, None, :]
  pos = torch.arange(S, device=dev)
  causal = pos[None, :] <= pos[:, None]
  h = params["embed"][x].float()
  ties = decisions = 0
  for stack in ("layers", "moe_layers"):
    lay = params[stack]
    for i in range(lay["wkv_a"].shape[0]):
      p = {key: v[i] for key, v in lay.items()}
      a = rms(h, p["attn_norm"])
      q = (a @ p["wq"].float()).view(S, H, nope + rope)
      kv_a = a @ p["wkv_a"].float()
      latent = rms(kv_a[:, :rank], p["kv_a_norm"], MLA_NORM_EPS)
      k_pe = _rope_interleaved_plain(torch, kv_a[:, None, rank:], cos, sin)
      kv = (latent @ p["wkv_b"].float()).view(S, H, nope + vd)
      qq = torch.cat([q[..., :nope], _rope_interleaved_plain(torch, q[..., nope:], cos, sin)], dim=-1)
      kk = torch.cat([kv[..., :nope], k_pe.expand(S, H, rope)], dim=-1)
      s = torch.einsum("qhd,khd->hqk", qq, kk) / math.sqrt(nope + rope)
      s = torch.softmax(s.masked_fill(~causal[None], -math.inf), dim=-1)
      o = torch.einsum("hqk,khd->qhd", s, kv[..., nope:]).reshape(S, H * vd)
      del s, qq, kk, kv
      h = h + o @ p["wo"].float()
      m = rms(h, p["mlp_norm"])
      if "w_router" not in p:
        h = h + (torch.nn.functional.silu(m @ p["w_gate"].float()) * (m @ p["w_up"].float())) @ p["w_down"].float()
        continue
      probs = torch.softmax(m @ p["w_router"].float(), dim=-1)
      top = torch.topk(probs, k + 1, dim=-1)
      ties += int((top.values[:, k - 1] - top.values[:, k] < 1e-2 * top.values[:, k - 1]).sum())
      decisions += S
      wts, idx = top.values[:, :k] * cfg.routed_scaling_factor, top.indices[:, :k]
      out = (torch.nn.functional.silu(m @ p["w_shared_gate"].float()) * (m @ p["w_shared_up"].float())) @ p["w_shared_down"].float()
      for e in idx.unique().tolist():
        rows, slot = (idx == e).nonzero(as_tuple=True)
        xe = m[rows]
        ye = (torch.nn.functional.silu(xe @ p["w_experts_gate"][e].float()) * (xe @ p["w_experts_up"][e].float())) @ p["w_experts_down"][e].float()
        out.index_add_(0, rows, ye * wts[rows, slot][:, None])
      h = h + out
  return rms(h[-n_last:], params["final_norm"]) @ params["lm_head"].float(), ties, decisions


def mla_v3_attention_check(torch, smi: str, hf: dict = DEEPSEEK_V3, slots: int = CACHE, dev: str = "cuda") -> dict:
  """One MLA attention layer at DeepSeek-V3's published widths (hidden
  7168, 128 heads, q LoRA 1536, latent 512, rope 64, nope 128, v 128; yarn
  factor 40), seeded random bf16 weights drawn on the card, over a
  4,096-slot bf16 latent cache whose first 4,095 slots hold seeded random
  latents: the port's cached branch (``decoder._mla_attention``: the q
  LoRA, the latent written at position 4,095, the absorbed op over every
  slot) against the naive per-head form in f32 written out here (q through
  wq_a → norm → wq_b, k / v per head from the cache's latents through
  kv_b, softmax at 1/sqrt(192), o), both then through o. Also times the
  absorbed op alone (``mla_absorbed_attention`` on the cache) beside the
  bytes it must move. (``hf``, ``slots`` and ``dev`` rehearse it on the
  CPU at small widths.)"""
  from xotorch_support_jetson_tpu_torch.models import decoder
  from xotorch_support_jetson_tpu_torch.models.config import config_from_hf
  from xotorch_support_jetson_tpu_torch.ops.attention import mla_absorbed_attention
  from xotorch_support_jetson_tpu_torch.ops.rope import rope_inv_freq

  cfg = config_from_hf(dict(hf, num_hidden_layers=1))
  D, H, rank, rope, nope, vd, ql = cfg.dim, cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.q_lora_rank
  gen = torch.Generator(device=dev).manual_seed(SEED + 71)

  def w(*shape):
    return (torch.randn(shape, generator=gen, device=dev) * shape[0] ** -0.5).to(torch.bfloat16)

  def ones(n):
    return torch.ones(n, dtype=torch.bfloat16, device=dev)

  p = {
    "attn_norm": ones(D), "wq_a": w(D, ql), "q_a_norm": ones(ql), "wq_b": w(ql, H * (nope + rope)),
    "wkv_a": w(D, rank + rope), "kv_a_norm": ones(rank), "wkv_b": w(rank, H * (nope + vd)), "wo": w(H * vd, D),
  }
  cache = decoder.init_kv_cache(cfg, 1, 1, slots, dtype=torch.bfloat16, device=dev)
  latent = torch.randn((slots - 1, rank), generator=gen, device=dev)
  cache["k"][0, 0, : slots - 1, 0] = (latent * torch.rsqrt(latent.pow(2).mean(-1, keepdim=True) + MLA_NORM_EPS)).to(torch.bfloat16)
  cache["v"][0, 0, : slots - 1, 0] = torch.randn((slots - 1, rope), generator=gen, device=dev).to(torch.bfloat16)
  x = torch.randn((1, 1, D), generator=gen, device=dev).to(torch.bfloat16)
  pos = torch.full((1, 1), slots - 1, dtype=torch.int32, device=dev)
  kv_pos = torch.arange(slots, dtype=torch.int32, device=dev)
  kv = {key: val[0] for key, val in cache.items()}
  got = decoder._mla_attention(x, p, kv, pos, kv_pos, rope_inv_freq(cfg, dev), cfg)  # [1, 1, H, v]
  got_o = got.reshape(1, H * vd) @ p["wo"]
  # The naive f32 form over the cache as the port wrote it.
  f = {key: val.float() for key, val in p.items()}
  xf = x.float()[0]
  inv, af = _yarn_plain(torch, hf, dev)
  ang = float(slots - 1) * inv
  cos, sin = (torch.cos(ang) * af)[None, :], (torch.sin(ang) * af)[None, :]

  def rms(v, g, eps=MLA_NORM_EPS):
    return v * torch.rsqrt(v.pow(2).mean(-1, keepdim=True) + eps) * g

  q = (rms(xf @ f["wq_a"], f["q_a_norm"]) @ f["wq_b"]).view(H, nope + rope)
  q = torch.cat([q[:, :nope], _rope_interleaved_plain(torch, q[:, nope:], cos, sin)], dim=-1)
  kvf = (cache["k"][0, 0, :, 0].float() @ f["wkv_b"]).view(slots, H, nope + vd)
  k = torch.cat([kvf[..., :nope], cache["v"][0, 0, :, 0].float()[:, None, :].expand(slots, H, rope)], dim=-1)
  s = torch.softmax(torch.einsum("hd,khd->hk", q, k) / math.sqrt(nope + rope), dim=-1)
  want = torch.einsum("hk,khd->hd", s, kvf[..., nope:])
  want_o = want.reshape(1, H * vd) @ f["wo"]
  err, err_o = _rel_err(got[0, 0], want), _rel_err(got_o, want_o)
  ckv, kpe = cache["k"][0, :, :, 0], cache["v"][0, :, :, 0]
  nbytes = (ckv.numel() + kpe.numel() + p["wkv_b"].numel() + H * (nope + rope) + H * vd) * 2  # cache, kv_b, q in, out
  ms = None
  if dev == "cuda":  # the absorbed op alone, as a decode step calls it
    q_nope = _rand(torch, (1, 1, H, nope), gen, torch.bfloat16)
    q_pe = _rand(torch, (1, 1, H, rope), gen, torch.bfloat16)
    ms = _cuda_ms(torch, lambda: mla_absorbed_attention(q_nope, q_pe, ckv, kpe, p["wkv_b"], pos, kv_pos, vd))
  res = dict(
    widths=dict(hidden=D, heads=H, q_lora_rank=ql, kv_lora_rank=rank, rope=rope, nope=nope, v=vd), cache=slots, rel_err=err, rel_err_after_o=err_o,
    absorbed_ms=ms, absorbed_bytes=nbytes, absorbed_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, card=smi,
  )
  log(f"[mla] one attention layer at DeepSeek-V3's widths (hidden {D}, {H} heads, q LoRA {ql}, latent {rank}, rope {rope}, nope {nope}, v {vd}) over a {slots}-slot bf16 latent cache: the port's absorbed op against the naive f32 per-head form: rel L2 {err:.3e} ({err_o:.3e} after o; limit {MLA_CHECK_TOL}) | the absorbed op alone {ms} ms against a bytes bound of {res['absorbed_bound_ms']:.4f} ms | {smi}")
  del p, cache, f, kvf, k
  torch.cuda.empty_cache()
  if not max(err, err_o) < MLA_CHECK_TOL:
    raise SystemExit(f"chip_smoke: [mla] the V3-width attention layer: {res}")
  return res


def mla_long_prompt() -> tuple[list[int], str]:
  """(ids, user text) of a ``LONG_PROMPT_TOKENS``-token prompt under the
  ``DeepseekByteTokenizer`` (BOS, the chat template, the text)."""
  tok = DeepseekByteTokenizer()
  overhead = len(tok.encode(tok.apply_chat_template([{"role": "user", "content": ""}])))
  words = "the quick brown fox jumps over a lazy dog while seven tired owls count the stars above an old mill".split()
  text = " ".join(words[i % len(words)] for i in range(LONG_PROMPT_TOKENS))[: LONG_PROMPT_TOKENS - overhead]
  ids = tok.encode(tok.apply_chat_template([{"role": "user", "content": text}]))
  if len(ids) != LONG_PROMPT_TOKENS:
    raise SystemExit(f"chip_smoke: [mla] the long prompt is {len(ids)} tokens, expected {LONG_PROMPT_TOKENS}")
  return ids, text


def _mla_chat(stream: bool, content=None, max_tokens: int = MAX_TOKENS, **extra) -> dict:
  return {"model": MLA_MODEL, "messages": [{"role": "user", "content": content or CHAT[0]["content"]}], "stream": stream, "temperature": 0, "max_tokens": max_tokens, **extra}


def _mla_cfg_problem(cfg) -> str:
  ok = (
    cfg.is_mla and cfg.family == "deepseek-v2" and cfg.kv_lora_rank == 512 and cfg.q_lora_rank == 0 and cfg.qk_head_dim == 192 and cfg.v_head_dim == 128 and cfg.n_heads == 16
    and cfg.n_experts == 64 and cfg.n_active_experts == 6 and cfg.moe_hidden_dim == 1408 and cfg.shared_expert_dim == 2816 and cfg.first_k_dense == 1
    and not cfg.norm_topk_prob and cfg.vocab_size == 102400 and getattr(cfg.rope_scaling, "factor", None) == 40
  )
  return "" if ok else "not DeepSeek-Coder-V2-Lite's"


def _nothing_built(label: str, fam0: dict, fam1: dict, tag: str = "mla") -> None:
  """No program family built or captured between two ledger snapshots
  (the counted requests after their warm-up)."""
  built = {f: (v["compiles"] - fam0.get(f, {}).get("compiles", 0), v["captures"] - fam0.get(f, {}).get("captures", 0)) for f, v in fam1.items()}
  built = {f: bc for f, bc in built.items() if any(bc)}
  if built:
    raise SystemExit(f"chip_smoke: [{tag}] {label}: the counted requests built or captured programs after the warm-up (family: builds, captures): {built}")


def _no_mla_attention_kernels(label: str, launches: dict) -> None:
  """K1, K2 and K3 never run on MLA: the absorbed op, the naive cache-less
  form and the paged gather are plain, as the reference routes them."""
  if launches["flash_prefill"] or launches["flash_decode"] or launches["paged_decode"]:
    raise SystemExit(f"chip_smoke: [mla] {label}: an attention kernel launched on MLA ({launches})")


def phase_mla(torch, ckpt: Path | None, smi: str, full: bool = True, preload=None):
  """DeepSeek-Coder-V2-Lite at full width (the checkpoint's depth): one
  attention layer at DeepSeek-V3's widths, then the daemon: solo bf16
  (captured) and batched at the defaults on the same engine, then solo
  with ``XOT_TPU_QUANT=int4``. Without ``full`` (the full depth, drawn on
  the card: ``preload`` as in ``_daemon_up``), the solo bf16 daemon
  alone."""
  from xotorch_support_jetson_tpu_torch import main as tmain

  out: dict = {}
  if full:
    out["v3_attention"] = mla_v3_attention_check(torch, smi)
  args, port = _daemon_args(tmain, ckpt or ROOT / "build" / "no_checkpoint", model=MLA_MODEL)
  try:
    out["bf16"] = asyncio.run(_mla_bf16(torch, tmain, args, port, smi, batched=full, preload=preload))
  finally:
    for knob in ("XOT_TPU_BATCHED", "XOT_TPU_BATCH_SLOTS", "XOT_TPU_PAGE_SIZE"):
      os.environ.pop(knob, None)
    gc.collect()
    torch.cuda.empty_cache()
  if not full:
    return out
  args, port = _daemon_args(tmain, ckpt, model=MLA_MODEL)
  os.environ["XOT_TPU_QUANT"] = "int4"
  try:
    out["int4"] = asyncio.run(_mla_int4(torch, tmain, args, port, smi))
  finally:
    os.environ.pop("XOT_TPU_QUANT", None)
    gc.collect()
    torch.cuda.empty_cache()
  return out


def _mla_plan(long_text: str) -> list:
  """The solo requests of the MLA phase, in order: greedy blocking and
  streaming chat, the long prompt blocking and streaming, one n-gram
  streaming request (its repetitive prompt) and the same prompt plain."""
  rep = "the fox jumps over the dog. " * 24
  return [
    ("greedy blocking", _mla_chat(False)), ("greedy streaming", _mla_chat(True)),
    ("long greedy blocking", _mla_chat(False, long_text)), ("long greedy streaming", _mla_chat(True, long_text)),
    ("n-gram greedy streaming", _mla_chat(True, rep, 48)), ("plain greedy blocking (the n-gram prompt)", _mla_chat(False, rep, 48)),
  ]


async def _mla_requests(torch, node, engine, port, long_text: str) -> tuple[list, tuple]:
  """``_mla_plan``'s requests (the n-gram one through the n-gram chain, as
  ``XOT_TPU_SPEC_DECODE=ngram`` sets it), then one logprobs request:
  (replies, (HTTP status, body, the logprobs request's ids))."""
  plan = _mla_plan(long_text)
  run = await _serve_requests(torch, node, engine, port, plan[:4])
  engine.spec_decode, engine._spec_ngram_on = "ngram", True
  try:
    run += await _serve_requests(torch, node, engine, port, plan[4:5])
  finally:
    engine.spec_decode, engine._spec_ngram_on = None, False
  run += await _serve_requests(torch, node, engine, port, plan[5:])
  lp_ids: dict[str, list[int]] = {}
  node.on_token.register("chip_smoke_lp").on_next(lambda rid, toks, fin: lp_ids.setdefault(rid, []).extend(toks))
  try:
    st, raw = await asyncio.to_thread(_http, port, "POST", "/v1/chat/completions", _mla_chat(False, max_tokens=16, logprobs=True, top_logprobs=5))
  finally:
    node.on_token.deregister("chip_smoke_lp")
  return run, (st, raw, lp_ids)


async def _mla_bf16(torch, tmain, args, port, smi, batched: bool = True, preload=None):
  from xotorch_support_jetson_tpu_torch.utils import programs

  node, server, engine, load_s = await _daemon_up(torch, tmain, args, port, "mla", MLA_MODEL, "bf16", _mla_cfg_problem, preload, tokenizer=DeepseekByteTokenizer())
  res = dict(load_s=load_s, card=smi, weight_bytes=sum(t.numel() * t.element_size() for t in _leaves(engine.params)))
  try:
    cfg, params = engine.cfg, engine.params
    L = cfg.n_layers
    log(f"[mla] config: deepseek-ai/DeepSeek-Coder-V2-Lite-Instruct's published shapes (hidden 2048, {L} of its 27 layers: layer 0 dense (10944), then MoE layers of 64 experts of 1408 top-6 unrenormalised and 2 shared; 16 heads, MLA latent 512, rope 64, nope 128, v 128, no q LoRA; yarn factor 40; vocab 102400, untied head), random bf16 weights; bos/eos 100000/100001; serving cap {engine.max_seq_len}")
    long_ids, long_text = mla_long_prompt()
    await _mla_requests(torch, node, engine, port, long_text)  # the warm-up: every request kind once
    fam0 = programs.ledger.snapshot()["families"]
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # ---- the solo MLA path, counted
    run, (st, raw, lp_ids) = await _mla_requests(torch, node, engine, port, long_text)
    launches, paths = _kernel_launches(), _moe_path_counts()  # ---- read just after
    fam1 = programs.ledger.snapshot()["families"]
    peak = torch.cuda.max_memory_allocated()
    _no_mla_attention_kernels("solo bf16", launches)
    if launches["int4_matmul"]:
      raise SystemExit(f"chip_smoke: [mla] solo bf16: K4 launched on bf16 weights ({launches})")
    _nothing_built("solo bf16", fam0, fam1)
    for a, b, what in ((run[0], run[1], "chat"), (run[2], run[3], "long prompt")):
      if a["tokens"] != b["tokens"]:
        raise SystemExit(f"chip_smoke: [mla] {what}: greedy blocking and streaming differ:\n{a['tokens']}\n{b['tokens']}")
    if st != 200:
      raise SystemExit(f"chip_smoke: [mla] logprobs: HTTP {st} {raw[:300]}")
    data = json.loads(raw)
    lp = data["choices"][0]["logprobs"]
    tok = DeepseekByteTokenizer()
    check_lp = _check_logprobs("mla chat", lp, lp_ids[data["id"].split("-", 1)[1]], {tok.eos_token_id}, tok.decode, True) if lp else None
    spec_n = fam1.get("spec.batch", {}).get("dispatches", 0) - fam0.get("spec.batch", {}).get("dispatches", 0)
    scored = fam1.get("prefill.score_last", {}).get("dispatches", 0) - fam0.get("prefill.score_last", {}).get("dispatches", 0)
    if check_lp is None or scored != 1 or spec_n < 1:
      raise SystemExit(f"chip_smoke: [mla] logprobs {check_lp}, {scored} prefill.score_last dispatches, {spec_n} n-gram chunks (spec.batch dispatches)")
    by_path = _check_moe_paths("mla", paths, "bf16", MLA_FFN)
    agree = _agreement(run[4]["tokens"], run[5]["tokens"])
    res.update(
      launches=launches, moe_paths=paths, moe_by_path=by_path, tokens=run[0]["tokens"], ttft_s=run[1]["ttft_s"], decode_tok_s=_decode_rate(run[1]),
      long_prompt_tokens=len(long_ids), long_ttft_s=run[3]["ttft_s"], long_decode_tok_s=_decode_rate(run[3]), peak_allocated=peak, logprobs=check_lp,
      ngram_chunks=spec_n, ngram_agreement=agree, ngram_decode_tok_s=_decode_rate(run[4]),
    )
    log(f"[mla] solo bf16: greedy blocking == streaming ({len(run[0]['tokens'])} tokens; TTFT {res['ttft_s']:.4f} s, decode {res['decode_tok_s']:.1f} tok/s) | long prompt of {len(long_ids)} tokens (bucket 3072): blocking == streaming, TTFT {res['long_ttft_s']:.4f} s, decode {res['long_decode_tok_s']:.1f} tok/s | peak device memory {peak / 1e9:.2f} GB | logprobs {check_lp} | n-gram chain: {spec_n} spec.batch dispatches, {res['ngram_decode_tok_s']:.1f} tok/s, ids agreeing with plain {agree:.3f} | launches {launches} (K1/K2/K3/K4 none) | MoE calls by path and T {paths}, each on the H100 table's path | no build or capture after the warm-up | {smi}")
    # The served logits against the naive f32 forward: the long prompt's
    # last token (the captured 3072 prefill) and one captured step after it.
    served_pre, _ = engine._infer_tensor_sync("mla-check", np.asarray([long_ids], np.int32), None)
    nxt = int(np.argmax(served_pre[0]))
    served_step, _ = engine._infer_tensor_sync("mla-check", np.asarray([[nxt]], np.int32), None)
    engine.end_request("mla-check")
    served = torch.from_numpy(np.stack([served_pre[0], served_step[0]])).cuda().float()
    t0 = time.perf_counter()
    with torch.no_grad():
      ref, ties, decisions = mla_plain_f32(torch, params, cfg, long_ids + [nxt])
    err = [_rel_err(served[i], ref[i]) for i in range(2)]
    res["check"] = dict(positions=[len(long_ids) - 1, len(long_ids)], rel_err=err, near_ties=ties, routing_decisions=decisions, argmax_agree=[int(served[i].argmax()) == int(ref[i].argmax()) for i in range(2)], ref_s=time.perf_counter() - t0)
    log(f"[mla] served logits at positions {len(long_ids) - 1} (captured prefill) and {len(long_ids)} (captured step) against the naive f32 forward on the same weights: rel L2 {err[0]:.3e} / {err[1]:.3e} (limit {MLA_CHECK_TOL}); argmax agree {res['check']['argmax_agree']}; near-tied routing decisions {ties} of {decisions}")
    del ref
    if not max(err) < MLA_CHECK_TOL:
      raise SystemExit(f"chip_smoke: [mla] served logits: {res['check']}")
    res["graphs"] = _mla_graphs_against_eager(torch, engine)
    res["profile"] = _mla_profile(torch, engine, smi)
    if not batched:
      return res
    engine._cache_pool.clear()
    engine._graph_pool = None
    gc.collect()
    torch.cuda.empty_cache()
    res["batched"] = b = await _batched_defaults(torch, node, engine, port, smi, MLA_MODEL, "mla", "gather", spec_and_mixed=False)
    _no_mla_attention_kernels("batched", b["launches"])
    b["moe_by_path"] = _check_moe_paths("mla", b["moe_paths"], "bf16", MLA_FFN)
    log(f"[mla] batched: {b['spec_dispatches']} spec and {b['mixed_dispatches']} mixed dispatches (none, as the reference's MLA server); decode chunks by path {b['chunks_by_path']}; MoE calls by path and T {b['moe_paths']}, each on the H100 table's path; launches {b['launches']}")
    return res
  finally:
    await _daemon_down(node, server, engine)


def _mla_graphs_against_eager(torch, engine):
  """Captured equals uncaptured on the MLA model: the engine's captured
  128-bucket prefill and greedy blocking / chunked decode (64 tokens)
  against the uncaptured functions on a fresh 4096-slot latent cache (ids
  identical, prefill logits within 5e-2 relative L2)."""
  prompt = np.asarray([DeepseekByteTokenizer().encode(CHECK_PROMPT)], dtype=np.int32)
  rows = []
  for rnd, chunks in enumerate(((), (32, 32))):
    want_logits, want = _eager_solo(torch, engine, prompt, 0.0, 0, chunks)
    got_logits, got = _captured_solo(torch, engine, f"mla-graphs-{rnd}", prompt, 0.0, 0, chunks)
    err = _rel_err(got_logits.cuda(), want_logits)
    rows.append(dict(kind="streaming" if chunks else "blocking", identical=got == want, prefill_rel_err=err))
    if got != want or not err < 5e-2:
      raise SystemExit(f"chip_smoke: [mla] captured differs from uncaptured ({rows[-1]}):\n{got}\n{want}")
  log(f"[mla] captured against uncaptured: {rows}")
  return rows


def _mla_profile(torch, engine, smi):
  """The captured decode step at position 100 of the 4096-slot latent
  cache (wall and device ms, ``_replay_ms``; torch.profiler's kernels over
  its replays), and two parts of it captured alone on the step's shapes
  (``_captured_ms``): every layer's absorbed op (``mla_absorbed_attention``
  over the 4,096 latent slots, its f32 copies of the cache and of kv_b
  included) and the MoE layers' FFN (``_moe_block``, routed and shared
  experts at T = 1); each one's share of the step's device time."""
  from xotorch_support_jetson_tpu_torch.models.decoder import _mla_w_kv_b, _moe_block, fused_decode, layer_params
  from xotorch_support_jetson_tpu_torch.ops.attention import mla_absorbed_attention

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  session = engine._new_session("mla-profile", 1)
  progs = session.programs
  n = GRAPH_PROFILE_STEPS
  try:
    step = lambda: fused_decode(params, cfg, shard, 65, progs.cache, 100, n, programs=progs)  # noqa: E731
    wall, device = _replay_ms(torch, step, n)
    prof = _profile(torch, f"mla decode, {n} captured steps", step, 2)
    cache = progs.cache
    gen = torch.Generator(device="cuda").manual_seed(SEED + 72)
    H = cfg.n_heads
    q_nope = _rand(torch, (1, 1, H, cfg.qk_nope_head_dim), gen, cfg.dtype)
    q_pe = _rand(torch, (1, 1, H, cfg.qk_rope_head_dim), gen, cfg.dtype)
    pos = torch.full((1, 1), 100, dtype=torch.int32, device="cuda")
    kv_pos = torch.arange(cache["k"].shape[2], dtype=torch.int32, device="cuda")
    layers = list(layer_params(params))

    def attention():
      for i, p in enumerate(layers):
        mla_absorbed_attention(q_nope, q_pe, cache["k"][i, :, :, 0], cache["v"][i, :, :, 0], _mla_w_kv_b(p, cfg.dtype), pos, kv_pos, cfg.v_head_dim)

    attn_device = _captured_ms(torch, attention)
    x = _rand(torch, (1, 1, cfg.dim), gen, cfg.dtype)
    moe = [p for p in layers if "w_router" in p]

    def ffn():
      for p in moe:
        _moe_block(x, p, cfg)

    ffn_device = _captured_ms(torch, ffn)
  finally:
    engine.end_request("mla-profile")
  res = dict(
    step_wall_ms=wall, step_device_ms=device, step_profiler_device_ms=prof["device_ms"] / n if prof["device_ms"] else None, absorbed_attention_device_ms=attn_device,
    absorbed_attention_share=attn_device / device, moe_ffn_device_ms=ffn_device, moe_ffn_share=ffn_device / device, top_device_ops=prof["top_device_ops"],
  )
  log(f"[profile] mla decode step at position 100 of {progs.cache['k'].shape[2]} slots (captured, {cfg.n_layers} layers): wall {wall:.3f} ms, device {device:.3f} ms; the absorbed op of the {cfg.n_layers} layers captured alone {attn_device:.3f} ms device (share {res['absorbed_attention_share']:.3f}); the MoE FFN of the {len(moe)} MoE layers (routed + shared) {ffn_device:.3f} ms (share {res['moe_ffn_share']:.3f}) | {smi}")
  return res


async def _mla_int4(torch, tmain, args, port, smi):
  """DeepSeek-Coder-V2-Lite with ``XOT_TPU_QUANT=int4`` (quantized on the
  card at load): after a warm-up pair, greedy blocking and streaming ids
  equal and nothing built or captured, K4 once per
  two-dimensional quantized product per forward (q, the latent projection
  and o in every layer, layer 0's MLP, the shared experts of every MoE
  layer, the head: 6 a layer and the head), no non-kernel int4 product, no
  attention kernel, the MoE calls on the table's int4 paths."""
  from xotorch_support_jetson_tpu_torch.ops import int4_matmul as k4
  from xotorch_support_jetson_tpu_torch.utils import programs

  node, server, engine, load_s = await _daemon_up(torch, tmain, args, port, "mla", MLA_MODEL, "int4", _mla_cfg_problem, tokenizer=DeepseekByteTokenizer())
  try:
    L = engine.cfg.n_layers
    per_forward = 6 * L + 1
    lay = engine.params["moe_layers"]
    if "lm_head_scale" not in engine.params or "wkv_b_scale" not in lay or lay["wkv_a"].shape[-2] * 2 != engine.cfg.dim:
      raise SystemExit("chip_smoke: [mla] int4: the head or the latent projections are not int4")
    await _serve_requests(torch, node, engine, port, [("warmup blocking", _mla_chat(False)), ("warmup streaming", _mla_chat(True))])
    two_dot0, fam0 = k4.CALLS["int4_two_dot"], programs.ledger.snapshot()["families"]
    _reset_launches()  # ---- the solo int4 MLA path, counted
    run = await _serve_requests(torch, node, engine, port, [("int4 greedy blocking", _mla_chat(False)), ("int4 greedy streaming", _mla_chat(True))])
    launches, paths = _kernel_launches(), _moe_path_counts()  # ---- read just after
    two_dot = k4.CALLS["int4_two_dot"] - two_dot0
    _nothing_built("int4", fam0, programs.ledger.snapshot()["families"])
    _no_mla_attention_kernels("int4", launches)
    if run[0]["tokens"] != run[1]["tokens"]:
      raise SystemExit(f"chip_smoke: [mla] int4: greedy blocking and streaming differ:\n{run[0]['tokens']}\n{run[1]['tokens']}")
    by_path = _check_moe_paths("mla", paths, "int4", MLA_FFN)
    if launches["int4_matmul"] == 0 or launches["int4_matmul"] % per_forward or two_dot:
      raise SystemExit(f"chip_smoke: [mla] int4: launches {launches} (K4 not a multiple of {per_forward} per forward), {two_dot} int4_two_dot calls")
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(engine.params))
    res = dict(
      load_s=load_s, launches=launches, per_forward=per_forward, forwards=launches["int4_matmul"] // per_forward, products=DEEPSEEK_V2_LITE_MATMULS, weight_bytes=weight_bytes,
      moe_paths=paths, moe_by_path=by_path, tokens=run[0]["tokens"], ttft_s=run[1]["ttft_s"], decode_tok_s=_decode_rate(run[1]),
    )
    log(f"[mla] solo int4 weights ({weight_bytes / 1e9:.2f} GB on the card): greedy blocking == streaming ({len(run[0]['tokens'])} tokens), TTFT {res['ttft_s']:.4f} s, decode {res['decode_tok_s']:.1f} tok/s | K4 {launches['int4_matmul']} launches = {res['forwards']} forwards × {per_forward} (wq, wkv_a, wo × {L}; layer 0's w_gate, w_up, w_down; w_shared_gate, w_shared_up, w_shared_down × {L - 1}; the head) | launches {launches} | MoE calls by path and T {paths}, each on the H100 table's int4 path | {smi}")
    return res
  finally:
    await _daemon_down(node, server, engine)


# ---------------------------------------------------------------- main


# ---------------------------------------------------------------- 5c. graphs


class _CkptDir:
  """The engine's downloader interface over one local checkpoint."""

  def __init__(self, path: Path) -> None:
    self.path = path

  async def ensure_shard(self, shard, engine_classname):
    return self.path


GRAPH_MODES = {"bf16": {}, "int8_kv": {"XOT_TPU_KV_QUANT": "int8"}, "int4": {"XOT_TPU_QUANT": "int4"}}
GRAPH_PROFILE_STEPS = 8
SPIN_CYCLES_PER_S = 2.0e9  # torch.cuda._sleep cycles per second, an upper bound at the H100's clocks


def phase_graphs(torch, ckpt: Path, draft_dir: Path, smi: str):
  """The captured solo programs (models/decoder.py ``SoloPrograms``) on the
  full-width checkpoint, per weight / KV mode, against the uncaptured
  functions called directly; K1, K2, K3 and K4 inside replays against their
  plain versions; wall and device ms, captured and eager; the captured
  speculation (``spec_graphs``); then the solo daemon through ``POST
  /v1/warmup`` and ``GET /v1/programs``."""
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard
  from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine

  out = {"modes": {}, "card": smi}
  t0 = time.perf_counter()
  for mode, knobs in GRAPH_MODES.items():
    for knob in SERVING_KNOBS:
      os.environ.pop(knob, None)
    os.environ.update(knobs)
    engine = TorchShardedInferenceEngine(_CkptDir(ckpt), device="cuda", tokenizer=ByteTokenizer())
    try:
      asyncio.run(engine.ensure_shard(Shard("llama-3.2-1b", 0, 15, 16)))
      t_mode = time.perf_counter()
      res = out["modes"][mode] = graphs_against_eager(torch, engine, mode)
      log(f"[time] graphs {mode}: against eager {time.perf_counter() - t_mode:.1f} s")
      res["profile"] = profile_graphs(torch, engine, mode, smi)
      if mode == "bf16":
        out["k2"] = k2_under_graphs(torch, engine, smi)
      log(f"[time] graphs {mode}: with the profiles {time.perf_counter() - t_mode:.1f} s")
    finally:
      engine.executor.shutdown(wait=True)
      for knob in knobs:
        os.environ.pop(knob, None)
      del engine
      gc.collect()
      torch.cuda.empty_cache()
  log(f"[time] graphs: the three modes {time.perf_counter() - t0:.1f} s")
  t0 = time.perf_counter()
  out["kernels_in_replay"] = kernels_in_replay(torch)
  log(f"[time] graphs: kernels in replays {time.perf_counter() - t0:.1f} s")
  out["spec"] = spec_graphs(torch, ckpt, draft_dir, smi)
  log(f"[time] graphs: kernels in replays and the spec cell {time.perf_counter() - t0:.1f} s")
  t0 = time.perf_counter()
  out["daemon"] = asyncio.run(_graphs_daemon(torch, ckpt))
  log(f"[time] graphs: the daemon and the API phase {time.perf_counter() - t0:.1f} s")
  return out


def _eager_solo(torch, engine, prompt, temp, seed, chunks, cache=CACHE, steps=MAX_TOKENS):
  """The uncaptured path on a fresh cache of ``cache`` slots: the prefill
  (``shard_forward`` at the 128 bucket), then ``fused_generate`` of
  ``steps`` (blocking) or ``fused_decode`` chunks (streaming) from the
  argmax token, sampling from a generator seeded ``seed``."""
  from xotorch_support_jetson_tpu_torch.models.decoder import fused_decode, fused_generate, init_kv_cache, shard_forward

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  L = prompt.shape[1]
  pad = torch.zeros((1, 128), dtype=torch.int32, device="cuda")
  pad[:, :L] = torch.from_numpy(prompt).cuda()
  cache = init_kv_cache(cfg, cfg.n_layers, 1, cache, device="cuda")
  logits, _ = shard_forward(params, cfg, shard, pad, torch.arange(128, dtype=torch.int32, device="cuda")[None], cache, head_pos=torch.tensor([L - 1], device="cuda"))
  first = int(torch.argmax(logits[0, 0]))
  gen = torch.Generator(device="cuda").manual_seed(seed)
  tok = torch.tensor([[first]], dtype=torch.int32, device="cuda")
  if not chunks:
    buf, n, _ = fused_generate(params, cfg, shard, tok, cache, torch.tensor([L], dtype=torch.int32, device="cuda"), steps, (), temp=temp, top_k=35, generator=gen, n_limit=steps)
    return logits[:, 0, :], [first] + buf[0, :n].tolist()
  toks, pos = [], L
  for n in chunks:
    t, _ = fused_decode(params, cfg, shard, tok, cache, torch.tensor([pos], dtype=torch.int32, device="cuda"), n, temp=temp, top_k=35, generator=gen)
    toks += t[0].tolist()
    tok, pos = t[:, -1:], pos + n
  return logits[:, 0, :], [first] + toks


def _captured_solo(torch, engine, rid, prompt, temp, seed, chunks, steps=MAX_TOKENS):
  """The same through the engine's own entry points: the captured prefill,
  then ``generate_oneshot``'s or ``dispatch_chunk``'s captured steps."""
  out, _ = engine._infer_tensor_sync(rid, prompt, None)
  first = int(np.argmax(out[0]))
  engine.generator.manual_seed(seed)
  if not chunks:
    toks = engine._generate_oneshot_sync(rid, first, steps, (), temp, 35)
  else:
    handles = [engine._dispatch_chunk_sync(rid, chunks[0], temp, 35, first)] + [engine._dispatch_chunk_sync(rid, n, temp, 35, None) for n in chunks[1:]]
    toks = [t for h in handles for t in engine._read_chunk_sync(h)]
  engine.end_request(rid)
  return torch.from_numpy(out), [first] + toks


GRAPH_TRANSCRIPT = 32  # tokens a transcript of graphs_against_eager: a step graph replays many times either way


def graphs_against_eager(torch, engine, mode):
  """Greedy and seeded sampled (temp 0.6, top_k 35) transcripts, blocking
  (``GRAPH_TRANSCRIPT`` tokens) and streaming (two chunks of half that),
  captured against uncaptured: the first round builds every graph with all four, the
  second only replays, with greedy streaming and sampled blocking (each
  graph replayed at least once). Transcripts must be token-identical; the
  captured prefill's logits must be within the serving phase's 5e-2
  relative L2 of the uncaptured ones."""
  from xotorch_support_jetson_tpu_torch.utils import programs

  prompt = np.asarray([ByteTokenizer().encode(CHECK_PROMPT)], dtype=np.int32)
  rows, worst = [], 0.0
  _reset_launches()
  for rnd in range(2):
    for temp, seed in ((0.0, 0), (0.6, SEED + 100 + rnd)):
      for chunks in ((), (GRAPH_TRANSCRIPT // 2,) * 2):
        if rnd == 1 and (temp == 0.0) != bool(chunks):
          continue
        kind = "streaming" if chunks else "blocking"
        want_logits, want = _eager_solo(torch, engine, prompt, temp, seed, chunks, steps=GRAPH_TRANSCRIPT)
        got_logits, got = _captured_solo(torch, engine, f"graphs-{mode}-{rnd}-{temp}-{kind}", prompt, temp, seed, chunks, steps=GRAPH_TRANSCRIPT)
        err = _rel_err(got_logits.cuda(), want_logits)
        worst = max(worst, err)
        rows.append(dict(round=rnd, temp=temp, kind=kind, tokens=len(got), identical=got == want, prefill_rel_err=err))
        if got != want or not err < 5e-2:
          raise SystemExit(f"chip_smoke: [graphs] {mode} round {rnd} temp {temp} {kind}: captured differs from uncaptured (prefill rel err {err:.3e}):\n{got}\n{want}")
  greedy = [r for r in rows if r["temp"] == 0.0]
  programs_ = [p for free in engine._cache_pool.values() for p in free]
  graphs = [g for p in programs_ for g in p.graphs()]
  nodes = {f"{g.family}:{'prefill' if g.family == 'decode.shard_forward' else 'step'}": g.kernel_nodes for g in graphs}
  launches = {n: _launched(n) for n in ("flash_prefill", "flash_decode", "int4_matmul")}
  replayed = dict(programs.REPLAYED)
  log(f"[graphs] {mode}: {len(rows)} transcripts (greedy and sampled at temp 0.6 / top_k 35, blocking and streaming in the build round, greedy streaming and sampled blocking in the replay round) token-identical to the uncaptured functions; prefill logits rel err max {worst:.3e}; {len(graphs)} graphs on {len(programs_)} pooled cache(s), kernel nodes {nodes}; launches {launches}, of which in replays {replayed}")
  if launches["flash_prefill"] == 0 or replayed.get("flash_prefill", 0) == 0:
    raise SystemExit(f"chip_smoke: [graphs] {mode}: K1 did not run inside a prefill replay ({launches}, {replayed})")
  if mode == "int4" and replayed.get("int4_matmul", 0) == 0:
    raise SystemExit(f"chip_smoke: [graphs] int4: K4 did not run inside a step replay ({replayed})")
  return dict(rows=rows, prefill_rel_err_max=worst, graphs=len(graphs), kernel_nodes=nodes, launches=launches, replayed=replayed, greedy_identical=all(r["identical"] for r in greedy))


def _replay_ms(torch, fn, steps, reps=5):
  """(wall ms, device ms) per step of ``fn``, a call of ``steps`` graph
  replays: wall is the host's clock over ``reps`` calls with the card
  synchronised at the end; device is CUDA events around one call queued
  behind a spin kernel long enough for the host to enqueue the whole call
  first (a replay is one launch, so the launch queue holds a call), so the
  events see the card from the call's first kernel to its last."""
  fn()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(reps):
    fn()
  torch.cuda.synchronize()
  wall_s = (time.perf_counter() - t0) / reps
  total = 0.0
  for _ in range(reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 2.0 * wall_s + 0.005) * SPIN_CYCLES_PER_S))
    start.record()
    fn()
    end.record()
    end.synchronize()
    total += start.elapsed_time(end)
  return wall_s * 1e3 / steps, total / reps / steps


def profile_graphs(torch, engine, mode, smi):
  """Wall and device ms per 128-token prefill and per decode step
  (``GRAPH_PROFILE_STEPS`` steps a call) on a 4096-slot cache, captured
  (one replay each: ``_replay_ms``) and eager (the same functions without
  ``programs``: ``_profile``, whose device time is torch.profiler's sum of
  device events — an eager call's ~1,300 launches overflow the launch
  queue, so events behind a spin would time the host). torch.profiler's
  device sum over the replays is reported too, where it sees them. Only
  the bf16 mode profiles (captured and eager); the other modes time their
  replays alone."""
  from xotorch_support_jetson_tpu_torch.models.decoder import fused_decode, init_kv_cache, shard_forward

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  prompt = np.asarray([ByteTokenizer().encode("<|user|>Write a short poem about a fox who learns to fly.\n<|assistant|>")], dtype=np.int32)
  L = prompt.shape[1]
  pad = np.zeros((1, 128), dtype=np.int32)
  pad[:, :L] = prompt
  session = engine._new_session("profile", 1)
  progs = session.programs
  eager_cache = init_kv_cache(cfg, cfg.n_layers, 1, CACHE, device="cuda")
  x = torch.from_numpy(pad).cuda()
  positions = torch.arange(128, dtype=torch.int32, device="cuda")[None]
  head = torch.tensor([L - 1], device="cuda")
  tok = torch.full((1, 1), 65, dtype=torch.int32, device="cuda")
  start = torch.tensor([100], dtype=torch.int32, device="cuda")
  n = GRAPH_PROFILE_STEPS
  fns = {
    "prefill": (1, lambda: progs.prefill(pad, L), lambda: shard_forward(params, cfg, shard, x, positions, eager_cache, head_pos=head)),
    "decode": (n, lambda: fused_decode(params, cfg, shard, 65, progs.cache, 100, n, programs=progs), lambda: fused_decode(params, cfg, shard, tok, eager_cache, start, n)),
  }
  res = {}
  try:
    for what, (steps, captured, eager) in fns.items():
      cw, cd = _replay_ms(torch, captured, steps)
      unit = "128-token prefill" if what == "prefill" else "decode step"
      if mode != "bf16":
        res[what] = dict(captured_wall_ms=cw, captured_device_ms=cd)
        log(f"[profile] graphs {mode} {unit}: captured wall {cw:.3f} ms, device {cd:.3f} ms (wall/device {cw / cd:.2f}) | {smi}")
        continue
      cp = _profile(torch, f"graphs {mode} {what} (captured, {steps} replay(s) a call)", captured, 3)
      ep = _profile(torch, f"graphs {mode} {what} (eager, {steps} step(s) a call)", eager, PROFILE_EAGER_REPS)
      ew, ed = ep["wall_ms"] / steps, ep["device_ms"] / steps
      prof = cp["device_ms"] / steps if cp["device_ms"] else None
      res[what] = dict(captured_wall_ms=cw, captured_device_ms=cd, captured_profiler_device_ms=prof, eager_wall_ms=ew, eager_device_ms=ed, eager_launches=ep["launches"] / steps)
      seen = "not measured (no device events)" if prof is None else f"{prof:.3f} ms"
      log(f"[profile] graphs {mode} {unit}: captured wall {cw:.3f} ms, device {cd:.3f} ms (wall/device {cw / cd:.2f}; profiler's device sum {seen}) | eager wall {ew:.3f} ms, device {ed:.3f} ms (wall/device {ew / ed:.2f}, {ep['launches'] / steps:.0f} launches) | {smi}")
  finally:
    engine.end_request("profile")
  return res


def k2_under_graphs(torch, engine, smi):
  """The captured bf16 decode step on a 4096-slot cache at positions 128
  and 4000, with K2 (``XOT_TPU_FLASH_DECODE=1``, ``_MIN`` 4096) and with
  the default plain attention over every slot. Recorded, not gated."""
  from xotorch_support_jetson_tpu_torch.models.decoder import fused_decode

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  session = engine._new_session("k2", 1)
  progs = session.programs
  n = GRAPH_PROFILE_STEPS
  res = {}
  try:
    for k2 in (False, True):
      if k2:
        os.environ.update(XOT_TPU_FLASH_DECODE="1", XOT_TPU_FLASH_DECODE_MIN=str(CACHE))
      for pos in (128, 4000):
        res[f"{'k2' if k2 else 'plain'}@{pos}"] = _replay_ms(torch, lambda: fused_decode(params, cfg, shard, 65, progs.cache, pos, n, programs=progs), n)
  finally:
    os.environ.pop("XOT_TPU_FLASH_DECODE", None)
    os.environ.pop("XOT_TPU_FLASH_DECODE_MIN", None)
    engine.end_request("k2")
  for pos in (128, 4000):
    (pw, pd), (kw, kd) = res[f"plain@{pos}"], res[f"k2@{pos}"]
    log(f"[profile] graphs bf16 decode step at position {pos} of a {CACHE}-slot cache: K2 wall {kw:.3f} ms, device {kd:.3f} ms | plain attention wall {pw:.3f} ms, device {pd:.3f} ms | K2/plain device {kd / pd:.3f} | {smi}")
  return {k: dict(wall_ms=v[0], device_ms=v[1]) for k, v in res.items()}


def kernels_in_replay(torch):
  """K1, K2, K3 and K4 at the main path's shapes inside a captured graph
  (utils/programs.py ``Graph``): the first run captures, then the inputs
  are refilled in place and the replay's output is held against the
  kernel's plain version on the new inputs, with the kernel rows'
  tolerances; each replay must count its launch. K3 twice: one query per
  row (B=8, the batched decode step) and the flattened verify window (B=8
  rows × W=9), both over 64-page tables of bf16 pages, with new queries,
  lengths and tables for the replay."""
  from xotorch_support_jetson_tpu_torch.models.quantize import quantize_weight_int4
  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa, int4_matmul as k4, paged
  from xotorch_support_jetson_tpu_torch.utils import programs

  gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
  q1, k1, v1 = _rand(torch, (1, 128, 32, 64), gen, torch.bfloat16), _rand(torch, (1, CACHE, 8, 64), gen, torch.bfloat16), _rand(torch, (1, CACHE, 8, 64), gen, torch.bfloat16)
  off = torch.zeros((1,), dtype=torch.int32, device="cuda")
  q2 = _rand(torch, (1, 1, 32, 64), gen, torch.bfloat16)
  pos2 = torch.tensor([[4000]], dtype=torch.int32, device="cuda")
  x4 = _rand(torch, (1, 2048), gen, torch.bfloat16)
  w4, s4 = quantize_weight_int4(_rand(torch, (2048, 8192), gen, torch.float32))
  mp, n_pages = 64, BATCH_SLOTS * 64 + 1
  kp, vp = _rand(torch, (n_pages, 8, PAGE, 64), gen, torch.bfloat16), _rand(torch, (n_pages, 8, PAGE, 64), gen, torch.bfloat16)
  k3 = {}
  for W in (1, VERIFY_W):
    rows = BATCH_SLOTS * W
    k3[W] = (_rand(torch, (rows, 32, 64), gen, torch.bfloat16), torch.zeros((rows, mp), dtype=torch.int32, device="cuda"), torch.zeros((rows,), dtype=torch.int32, device="cuda"))

  def refill_k3(W):
    q, bt, lengths = k3[W]
    q.copy_(torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype))
    tables = (torch.randperm(n_pages - 1, generator=gen, device="cuda")[: BATCH_SLOTS * mp].to(torch.int32) + 1).reshape(BATCH_SLOTS, mp)
    bt.copy_(paged.window_block_tables(tables, W))
    starts = torch.randint(1, mp * PAGE - W, (BATCH_SLOTS, 1), generator=gen, device="cuda")
    lengths.copy_((starts + torch.arange(W, device="cuda")[None, :]).reshape(-1).to(torch.int32))

  def k3_case(W):
    q, bt, lengths = k3[W]
    return (lambda: refill_k3(W), lambda: paged.paged_decode_attention(q, kp, vp, bt, lengths, PAGE), lambda: paged.paged_decode_attention_ref(q, kp, vp, bt, lengths, PAGE), (K3_ATOL, K3_RTOL), "paged_decode")

  def refill(*inputs):
    for t in inputs:
      t.copy_(torch.randn(t.shape, generator=gen, device="cuda", dtype=torch.float32).to(t.dtype))

  refill_k3(1)
  refill_k3(VERIFY_W)
  cases = {
    "flash_prefill": (lambda: refill(q1), lambda: fa.flash_attention_prefill(q1, k1, v1, q_offset=off), lambda: fa.flash_attention_prefill_ref(q1, k1, v1, q_offset=off), (K1_EW_ATOL, K1_RTOL), "flash_prefill"),
    "flash_decode": (lambda: refill(q2), lambda: fa.flash_decode_attention(q2, k1, v1, pos2), lambda: fa.flash_decode_attention_ref(q2, k1, v1, pos2), (K2_ATOL, 2.0**-7), "flash_decode"),
    "paged_decode": k3_case(1),
    f"paged_decode verify window B={BATCH_SLOTS}×W={VERIFY_W}": k3_case(VERIFY_W),
    "int4_matmul": (lambda: refill(x4), lambda: k4.int4_matmul(x4, w4, s4), lambda: k4.int4_matmul_ref(x4, w4, s4), (1e-4, 2.0**-7), "int4_matmul"),
  }
  res = {}
  for name, (refill_inputs, kernel, plain, (atol, rtol), kname) in cases.items():
    out = kernel().clone()
    graph = programs.Graph(f"check.{kname}", lambda: out.copy_(kernel()))
    graph.run(torch.device("cuda"))  # eager, then the capture
    refill_inputs()
    out.zero_()
    before = programs.REPLAYED.get(kname, 0)
    graph.run(torch.device("cuda"))  # the replay, on the refilled inputs
    torch.cuda.synchronize()
    want = plain().float()
    err = (out.float() - want).abs()
    used = float((err / (atol + rtol * want.abs())).max())
    res[name] = dict(max_abs_err=float(err.max()), bound_used=used, kernel_nodes=graph.kernel_nodes, replay_launches=programs.REPLAYED.get(kname, 0) - before)
    log(f"[graphs] {name} inside a replay (refilled inputs): max|err| {res[name]['max_abs_err']:.3e} against its plain version ({used:.3f} of atol {atol} + rtol {rtol:.3g}·|ref|); the graph holds {graph.kernel_nodes} kernel node(s); launches counted for the replay: {res[name]['replay_launches']}")
    if not used <= 1.0 or (kname == "flash_prefill" and not res[name]["max_abs_err"] <= K1_ATOL) or res[name]["replay_launches"] != 1:
      raise SystemExit(f"chip_smoke: [graphs] {name} inside a replay: {res[name]}")
  return res


SPEC_GRAPH_ROUNDS = 2  # captured against uncaptured: a round that builds the graphs, one that replays them on refilled buffers


def spec_graphs(torch, ckpt: Path, draft_dir: Path, smi: str):
  """The ``[graphs] spec`` cell: solo speculation's captured programs at
  full width (models/decoder.py ``SoloPrograms`` on a pooled 4096-slot
  cache pair, taken as a session takes one) against the uncaptured
  functions on an identical pair of caches, with the int8 self-draft and
  with the 2-layer cross draft; then K1 at the verify windows inside a
  replay on refilled inputs."""
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard
  from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine

  out = {}
  for draft, knobs in (("int8", {}), ("cross", {"XOT_TPU_SPEC_DRAFT": str(draft_dir)})):
    for knob in SERVING_KNOBS:
      os.environ.pop(knob, None)
    os.environ.update(XOT_TPU_SPEC_DECODE="int8", XOT_TPU_SPEC_AUTOCAL="0", **knobs)
    engine = TorchShardedInferenceEngine(_CkptDir(ckpt), device="cuda", tokenizer=ByteTokenizer())
    try:
      asyncio.run(engine.ensure_shard(Shard("llama-3.2-1b", 0, 15, 16)))
      out[draft] = _spec_graph_cases(torch, engine, draft, smi)
    finally:
      engine.executor.shutdown(wait=True)
      for knob in SPEC_KNOBS:
        os.environ.pop(knob, None)
      del engine
      gc.collect()
      torch.cuda.empty_cache()
  out["k1_in_replay"] = k1_verify_in_replay(torch)
  return out


def _spec_graph_cases(torch, engine, draft: str, smi: str):
  """Captured against uncaptured over ``SPEC_GRAPH_ROUNDS`` rounds, each
  dispatch chained on the last one's device outputs (so every round after
  the first refills the graphs' buffers): the draft's prefill at the 128
  bucket (logits within 5e-2 relative L2, the same argmax), draft-chain
  chunks of 8 tokens at depth 4, and with the int8 self-draft n-gram
  chunks of 3 rounds at depth 8 on a 35-token proposal stream, with the
  cross draft 64-token speculative oneshots: tokens, counts and chained
  outputs identical. Then wall and device ms of one captured dispatch
  (``_replay_ms``) beside the eager function's (``_profile``): the n-gram
  chunk, one draft round and the draft prefill, and the captured oneshot
  alone, with each graph's kernel nodes and capture seconds and the graph
  pool's bytes."""
  from xotorch_support_jetson_tpu_torch.models import decoder as dec
  from xotorch_support_jetson_tpu_torch.utils import programs

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  cfg_d, shard_d, params_d = engine._draft_cfg or cfg, engine._draft_shard or shard, engine._draft_params
  L_t, L_d = cfg.n_layers, cfg_d.n_layers
  progs, _ = engine._take_programs(1, CACHE)
  ct, cd = dec.init_kv_cache(cfg, L_t, 1, CACHE, device="cuda"), dec.init_kv_cache(cfg_d, L_d, 1, CACHE, device="cuda")
  prompt = np.asarray([ByteTokenizer().encode(CHECK_PROMPT)], dtype=np.int32)
  L = prompt.shape[1]
  pad = np.zeros((1, 128), dtype=np.int32)
  pad[:, :L] = prompt
  x, positions, head = torch.from_numpy(pad).cuda(), torch.arange(128, dtype=torch.int32, device="cuda")[None], torch.tensor([L - 1], device="cuda")
  one = lambda v, dt=torch.int32: torch.full((1,), v, dtype=dt, device="cuda")  # noqa: E731
  gen = np.random.default_rng(SEED + 31)
  res, errs, t0 = {"rounds": []}, [], time.perf_counter()
  for rnd in range(SPEC_GRAPH_ROUNDS):
    row = dict(round=rnd)
    got_t, want_t = progs.prefill(pad, L), dec.shard_forward(params, cfg, shard, x, positions, ct, head_pos=head)[0][:, 0, :]
    got_d, want_d = progs.draft.prefill(pad, L), dec.shard_forward(params_d, cfg_d, shard_d, x, positions, cd, head_pos=head)[0][:, 0, :]
    row["prefill_rel_err"], row["draft_prefill_rel_err"] = _rel_err(got_t, want_t), _rel_err(got_d, want_d)
    if int(got_t.argmax()) != int(want_t.argmax()) or int(got_d.argmax()) != int(want_d.argmax()) or not max(row["prefill_rel_err"], row["draft_prefill_rel_err"]) < 5e-2:
      errs.append(("prefill", rnd, row))
    first = int(want_t.argmax())
    # Draft-chain chunks, chained on the device seed and position.
    g_in = e_in = (torch.full((1, 1), first, dtype=torch.int32, device="cuda"), L)
    chunks = []
    for c in range(3):
      g = dec.fused_speculative_chunk(params, cfg, shard, params_d, g_in[0], progs.cache, progs.draft.cache, g_in[1], 8, gamma=4, n_limit=8, cfg_d=cfg_d, shard_d=shard_d, pos_hi=L + 13 * c, programs=progs)
      e = dec.fused_speculative_chunk(params, cfg, shard, params_d, e_in[0], ct, cd, e_in[1], 8, gamma=4, n_limit=8, cfg_d=cfg_d, shard_d=shard_d, pos_hi=L + 13 * c)
      gp, ep = g[0].tolist(), e[0].tolist()
      chunks.append(gp[: 2 + gp[0]])
      if gp[: 2 + gp[0]] != ep[: 2 + ep[0]] or int(g[1]) != int(e[1]) or int(g[2]) != int(e[2]):
        errs.append(("chunk", rnd, c, gp[: 2 + gp[0]], ep[: 2 + ep[0]]))
      g_in, e_in = (g[1], g[2]), (e[1], e[2])
    row["chunks"] = chunks
    start = int(e_in[1])
    if draft == "int8":
      # n-gram chunks on the target alone, chained likewise.
      g_in = e_in = (torch.full((1, 1), first, dtype=torch.int32, device="cuda"), one(start))
      ngram = []
      for c in range(3):
        props = torch.from_numpy(gen.integers(3, 256, (1, 35)).astype(np.int32)).cuda()
        common = (params, cfg, shard, None, cfg, shard)
        tail = (one(True, torch.bool), one(8), one(0.0, torch.float32), 3, 8)
        g = dec.fused_spec_batch_decode(*common, g_in[0], progs.cache, None, g_in[1], *tail, top_k=1, k_max=1, props=props, prop_counts=one(35), programs=progs)
        e = dec.fused_spec_batch_decode(*common, e_in[0], ct, None, e_in[1], *tail, top_k=1, k_max=1, props=props, prop_counts=one(35))
        n = int(e[1][0])
        ngram.append(g[0][0, : int(g[1][0])].tolist())
        if any(not torch.equal(a, b) for a, b in zip(g[1:5], e[1:5])) or not torch.equal(g[0][:, :n], e[0][:, :n]):
          errs.append(("ngram", rnd, c, ngram[-1], e[0][0, :n].tolist()))
        g_in, e_in = (g[3], g[4]), (e[3], e[4])
      row["ngram"] = ngram
    else:
      # Speculative oneshots from 64 tokens on.
      at = start + 100 * rnd
      tok = torch.full((1, 1), first, dtype=torch.int32, device="cuda")
      g = dec.fused_speculative_generate(params, cfg, shard, params_d, cfg_d, shard_d, first, progs.cache, progs.draft.cache, at, 64, gamma=4, programs=progs)
      e = dec.fused_speculative_generate(params, cfg, shard, params_d, cfg_d, shard_d, tok, ct, cd, at, 64, gamma=4)
      row["oneshot"] = g[0][: g[1]].tolist()
      if g[1:3] != e[1:3] or row["oneshot"] != e[0][: e[1]].tolist():
        errs.append(("oneshot", rnd, g[1:3], e[1:3]))
    res["rounds"].append(row)
  if errs:
    raise SystemExit(f"chip_smoke: [graphs] spec {draft}: captured differs from uncaptured: {errs[:3]}")
  graphs = {g.family: g for g in progs.graphs() if g.family in SPEC_FAMILIES}
  round_graph = graphs.get("spec.chunk") or graphs["spec.generate"]
  bad = {f: g.kernels for f, g in graphs.items() if f != "spec.batch" and g.kernels.get("flash_prefill") != L_t + L_d}
  if "spec.batch" in graphs and graphs["spec.batch"].kernels.get("flash_prefill") != 3 * L_t:
    bad["spec.batch"] = graphs["spec.batch"].kernels
  if bad:
    raise SystemExit(f"chip_smoke: [graphs] spec {draft}: K1 is not once per layer per window in the captured rounds: {bad}")
  log(f"[graphs] spec {draft}: {SPEC_GRAPH_ROUNDS} rounds captured against uncaptured token-identical in {time.perf_counter() - t0:.1f} s (draft prefill rel err max {max(r['draft_prefill_rel_err'] for r in res['rounds']):.3e}; chained draft-chain chunks, {'n-gram chunks' if draft == 'int8' else 'oneshots'}); graphs {[(g.family, g.kernel_nodes, round(g.capture_s, 3), g.kernels) for g in progs.graphs() + progs.draft.graphs()]}")
  # Timing: one captured dispatch against the eager function.
  tok = torch.full((1, 1), 65, dtype=torch.int32, device="cuda")
  props = torch.full((1, 35), 65, dtype=torch.int32, device="cuda")
  rows = {
    "draft prefill, 128-token bucket": (lambda: progs.draft.prefill(pad, L), lambda: dec.shard_forward(params_d, cfg_d, shard_d, x, positions, cd, head_pos=head), progs.draft.graphs()[0], None, 5),
    f"{draft} round, depth 4": (
      lambda: dec.fused_speculative_chunk(params, cfg, shard, params_d, 65, progs.cache, progs.draft.cache, 100, 8, gamma=4, n_limit=1, cfg_d=cfg_d, shard_d=shard_d, programs=progs)[0].cpu(),
      None, round_graph, lambda: profile_draft_round(torch, engine, f"{draft} draft"), 5,
    ),
  }
  if draft == "int8":
    rows["n-gram chunk, 3 rounds at depth 8"] = (
      lambda: dec.fused_spec_batch_decode(params, cfg, shard, None, cfg, shard, tok, progs.cache, None, one(100), one(True, torch.bool), one(8), one(0.0, torch.float32), 3, 8, top_k=1, k_max=1, props=props, prop_counts=one(35), programs=progs)[1].cpu(),
      None, graphs["spec.batch"], lambda: profile_ngram_chunk(torch, engine), 5,
    )
  else:
    # The eager oneshot is not timed (PERF.md keeps its time): its profile
    # of ~150,000 launches took ~40 s of each run.
    rows["speculative oneshot, 64 tokens at depth 4"] = (
      lambda: dec.fused_speculative_generate(params, cfg, shard, params_d, cfg_d, shard_d, 65, progs.cache, progs.draft.cache, 100, 64, gamma=4, programs=progs)[0].cpu(),
      None, round_graph, None, 3,
    )
  res["profile"] = {}
  for label, (captured, eager, graph, eager_profile, reps) in rows.items():
    t0 = time.perf_counter()
    wall, device = _replay_ms(torch, captured, 1, reps=reps)
    if eager_profile:
      ep = eager_profile()
    elif eager is None:
      ep = dict(wall_ms=None, device_ms=None, launches=None)
    else:
      ep = _profile(torch, f"graphs spec {draft}: {label} (eager)", eager, PROFILE_EAGER_REPS)
    res["profile"][label] = dict(
      captured_wall_ms=wall, captured_device_ms=device, wall_over_device=wall / device, kernel_nodes=graph.kernel_nodes, capture_s=graph.capture_s,
      eager_wall_ms=ep["wall_ms"], eager_device_ms=ep["device_ms"], eager_launches=ep["launches"],
    )
    eager_text = "eager not measured in this run" if ep["wall_ms"] is None else f"eager wall {ep['wall_ms']:.3f} ms, device {ep['device_ms']:.3f} ms, {ep['launches']:.0f} launches"
    log(f"[profile] graphs spec {draft}: {label}: captured wall {wall:.3f} ms, device {device:.3f} ms (wall/device {wall / device:.3f}) | {graph.kernel_nodes} kernel nodes, capture {graph.capture_s:.3f} s | {eager_text} | {smi} ({time.perf_counter() - t0:.1f} s)")
  res["graph_pool_bytes"] = programs.pool_bytes(engine._graph_pool)
  log(f"[profile] graphs spec {draft}: the engine's graph memory pool holds {res['graph_pool_bytes']} bytes (the pair's prefill, step and speculation graphs)")
  del progs, ct, cd
  return res


def k1_verify_in_replay(torch):
  """K1 at the solo verify windows (B=1, Sq 5 and 9: the draft chain's and
  the n-gram chain's windows, and the draft's catch-up) over the 4096-slot
  bf16 cache inside a captured graph, its query and offset refilled after
  the capture: the replay's output within K1's bounds of its plain version
  on the new inputs, one kernel node, one launch counted."""
  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa
  from xotorch_support_jetson_tpu_torch.utils import programs

  gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
  k, v = _rand(torch, (1, CACHE, 8, 64), gen, torch.bfloat16), _rand(torch, (1, CACHE, 8, 64), gen, torch.bfloat16)
  res = {}
  for Sq in (5, 9):
    q = _rand(torch, (1, Sq, 32, 64), gen, torch.bfloat16)
    off = torch.tensor([72], dtype=torch.int32, device="cuda")
    out = fa.flash_attention_prefill(q, k, v, q_offset=off).clone()
    graph = programs.Graph("check.flash_prefill", lambda q=q, off=off, out=out: out.copy_(fa.flash_attention_prefill(q, k, v, q_offset=off)))
    graph.run(torch.device("cuda"))  # eager, then the capture
    q.copy_(torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype))
    off.fill_(CACHE - 10)
    out.zero_()
    before = programs.REPLAYED.get("flash_prefill", 0)
    graph.run(torch.device("cuda"))  # the replay, on the refilled inputs
    torch.cuda.synchronize()
    want = fa.flash_attention_prefill_ref(q, k, v, q_offset=off).float()
    err = (out.float() - want).abs()
    used = float((err / (K1_EW_ATOL + K1_RTOL * want.abs())).max())
    r = res[Sq] = dict(max_abs_err=float(err.max()), bound_used=used, kernel_nodes=graph.kernel_nodes, replay_launches=programs.REPLAYED.get("flash_prefill", 0) - before)
    log(f"[graphs] spec: K1 at Sq {Sq} (B=1, offset 72 at capture, {CACHE - 10} at the replay) inside a replay on refilled inputs: max|err| {r['max_abs_err']:.3e} ({used:.3f} of atol {K1_EW_ATOL} + rtol {K1_RTOL:.3g}·|ref|; cap {K1_ATOL}); {graph.kernel_nodes} kernel node(s); launches counted for the replay: {r['replay_launches']}")
    if not used <= 1.0 or not r["max_abs_err"] <= K1_ATOL or r["kernel_nodes"] != 1 or r["replay_launches"] != 1:
      raise SystemExit(f"chip_smoke: [graphs] spec: K1 at Sq {Sq} inside a replay: {r}")
  return res


def _get_json(port: int, path: str):
  with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as resp:
    return json.loads(resp.read())


def _post_json(port: int, path: str, body: dict):
  req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
  with urllib.request.urlopen(req, timeout=600) as resp:
    return json.loads(resp.read())


SOLO_FAMILIES = ("decode.shard_forward", "decode.fused", "decode.fused_generate")


async def _graphs_daemon(torch, ckpt: Path):
  """The solo daemon at its defaults: four requests (greedy and sampled,
  blocking and streaming) build its programs, ``POST /v1/warmup`` warms
  the batched manifest and marks the ledger steady, the same four requests
  again, then ``GET /v1/programs``: no steady build, no new capture, the
  solo families replaying, greedy ids equal to the first pass's."""
  from xotorch_support_jetson_tpu_torch import main as tmain
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard

  args, port = _daemon_args(tmain, ckpt)
  node, api, engine, _ = tmain.build_components(args, tokenizer=ByteTokenizer())
  server = await api.run(host="127.0.0.1", port=port)
  plan = [("greedy blocking", _chat_body(False, 0)), ("greedy streaming", _chat_body(True, 0)), ("sampled blocking", _chat_body(False, 0.8)), ("sampled streaming", _chat_body(True, 0.8))]
  try:
    await engine.ensure_shard(Shard("llama-3.2-1b", 0, 15, 16))
    _reset_launches()  # ---- the graphs daemon's path, counted
    first = await _serve_requests(torch, node, engine, port, plan)
    cold = await asyncio.to_thread(_get_json, port, "/v1/programs")
    warm = await asyncio.to_thread(_post_json, port, "/v1/warmup", {})
    after_warm = await asyncio.to_thread(_get_json, port, "/v1/programs")
    again = await _serve_requests(torch, node, engine, port, plan)
    snap = await asyncio.to_thread(_get_json, port, "/v1/programs")
    launches = {n: _launched(n) for n in ("flash_prefill", "flash_decode", "paged_decode", "int4_matmul")}  # ---- read just after
    cluster = await asyncio.to_thread(_get_json, port, "/v1/programs?scope=cluster")
    # The API phase after the windows the gates below read: its scoring
    # forward is a program the warmup manifest does not hold (as in the
    # reference), so it builds after warmup.
    api_res = await _api_phase(torch, node, engine, port)
  finally:
    server.close()
    await server.wait_closed()
    await asyncio.get_running_loop().run_in_executor(engine.executor, engine._drop_batched_server)
    engine.executor.shutdown(wait=True)
  fams = snap["families"]
  summary = {f: {k: fams.get(f, {}).get(k) for k in ("compiles", "dispatches", "captures", "replays", "graph_kernels", "steady_compiles")} for f in SOLO_FAMILIES}
  new_captures = {f: fams.get(f, {}).get("captures", 0) - after_warm["families"].get(f, {}).get("captures", 0) for f in SOLO_FAMILIES}
  log(f"[graphs] daemon: POST /v1/warmup -> manifest {[(e['family'], e['warmed']) for e in warm['manifest']]}, {warm['warmup_s']:.3f} s, errors {warm['errors']}; GET /v1/programs after the repeat: steady {snap['steady']}, steady_compiles {snap['totals']['steady_compiles']}, totals {snap['totals']}; solo families {summary}; captures during the repeat {new_captures}; launches {launches}")
  for a, b in ((first[0], again[0]), (first[1], again[1]), (first[0], first[1])):
    if a["tokens"] != b["tokens"]:
      raise SystemExit(f"chip_smoke: [graphs] daemon: greedy ids differ ({a['label']} / {b['label']}):\n{a['tokens']}\n{b['tokens']}")
  if not warm.get("steady") or warm.get("errors") or not snap["steady"] or snap["totals"]["steady_compiles"] != 0 or any(new_captures.values()):
    raise SystemExit(f"chip_smoke: [graphs] daemon: the repeat built programs after warmup: {snap['totals']}, captures {new_captures}, warmup {warm}")
  if any(not fams.get(f, {}).get("replays") for f in SOLO_FAMILIES) or cold["steady"] or cluster.get("unreachable") != [] or cluster["totals"]["dispatches"] != snap["totals"]["dispatches"]:
    raise SystemExit(f"chip_smoke: [graphs] daemon: unexpected ledger {summary} (cold steady {cold['steady']}; cluster {cluster.get('unreachable')})")
  if launches["flash_prefill"] == 0:
    raise SystemExit(f"chip_smoke: [graphs] daemon: K1 never launched {launches}")
  return dict(warmup=warm, programs=snap, solo_families=summary, launches=launches, greedy_tokens=first[0]["tokens"], api=api_res)


# ------------------------------------------------------- 5d. the API surface

# Top-1 of a scored row must be the greedy token wherever the runner-up
# trails it by more than this (nats). Generation and scoring reach the same
# logits through different routes (a 4096-slot cache and the plain decode
# attention against K1 over the sequence's own K/V), each in bf16: the
# served logits differ from the plain path's by ~1.6e-2 relative L2 (the
# serving phase's check), ~0.013 nats at these logits' scale, and each logit
# is rounded to bf16 (2^-6 near 4); 0.1 is about eight such steps. A wrong
# row or an off-by-one position misses by whole nats.
SCORE_GAP_TOL = 0.1
# The scorer's K1 route against its plain route (``_scoring_against_plain``):
# the top log-prob rows' relative L2 (the chosen ones measured 1.3e-3 and
# 1.8e-3 on the H100 at S_pad 3072 and 256), and a runner-up's distance
# below its row's top in nats: eight bf16 steps of a logit in [2, 4).
SCORE_ROUTE_TOP_REL = 1e-2
SCORE_ROUTE_NATS = 0.125
THROWAWAY = "qwen-3-0.6b"  # the card whose directory the API phase creates, downloads and deletes
HOME_NEEDLES = ('id="model"', 'id="dl-btn"', 'id="del-btn"', 'id="attach"', 'id="stop"', 'id="topology"', "/v1/download/progress")  # tests/test_api.py


def _http(port: int, method: str, path: str, body=None, timeout=600):
  """(status, body text) of one request; an HTTP error status is returned, not raised."""
  data = None if body is None else json.dumps(body).encode()
  req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method, headers={"Content-Type": "application/json"})
  try:
    with urllib.request.urlopen(req, timeout=timeout) as resp:
      return resp.status, resp.read().decode()
  except urllib.error.HTTPError as e:
    return e.code, e.read().decode()


def _sse(raw: str) -> list[dict]:
  events = [line[6:] for line in raw.split("\n") if line.startswith("data: ")]
  if not events or events[-1] != "[DONE]":
    raise SystemExit(f"chip_smoke: [api] an SSE stream did not end with [DONE]: {raw[-300:]!r}")
  return [json.loads(e) for e in events[:-1]]


def _spy_scoring(torch, records):
  """Wrap ``decoder.score_last_tokens`` (the engine looks it up at each
  call): per call its K1 launches, wall and device ms (CUDA events), peak
  device memory above what was allocated before it, the thread it ran on,
  and its inputs and chosen log-probs for the plain-route check."""
  from xotorch_support_jetson_tpu_torch.models import decoder as dec

  orig = dec.score_last_tokens

  def spy(params, cfg, shard, tokens, seq_len, n_scored, top_n):
    torch.cuda.synchronize()
    k1, base = _launched("flash_prefill"), torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = orig(params, cfg, shard, tokens, seq_len, n_scored, top_n)
    end.record()
    torch.cuda.synchronize()
    records.append(dict(
      S_pad=tokens.shape[1], seq_len=int(seq_len), n_bucket=n_scored, k1=_launched("flash_prefill") - k1, wall_ms=(time.perf_counter() - t0) * 1e3,
      device_ms=start.elapsed_time(end), peak_bytes=torch.cuda.max_memory_allocated() - base, thread=threading.get_ident(),
      call=(params, cfg, shard, tokens, seq_len, n_scored, top_n), chosen=out[0].clone(), top=out[2].clone(),
    ))
    return out

  dec.score_last_tokens = spy
  return lambda: setattr(dec, "score_last_tokens", orig)


def _scoring_against_plain(torch, records):
  """Each recorded scoring call again through the plain attention
  (``XOT_TPU_NO_FLASH``): no K1 launch, chosen log-probs within 5e-2
  relative L2 of the K1 route's (PERF.md §2's logits gate), and its wall
  ms. Every log-prob carries its row's -log Z (several nats on the seeded
  weights), which that relative measure divides by, so two
  more: the top-``top_n`` log-prob rows within ``SCORE_ROUTE_TOP_REL``
  relative L2, and each runner-up's distance below its row's top, where
  -log Z cancels, within ``SCORE_ROUTE_NATS`` nats of the K1 route's (the
  chosen token's own distance is 0 on both routes wherever it is the
  top, as greedy tokens nearly always are)."""
  from xotorch_support_jetson_tpu_torch.models import decoder as dec

  out = []
  os.environ["XOT_TPU_NO_FLASH"] = "1"
  try:
    for r in records:
      torch.cuda.synchronize()
      k1, t0 = _launched("flash_prefill"), time.perf_counter()
      chosen, _, top = dec.score_last_tokens(*r["call"])
      torch.cuda.synchronize()
      below = float(((r["top"] - r["top"][:, :1]) - (top - top[:, :1])).abs().max())
      res = dict(
        S_pad=r["S_pad"], top_n=r["call"][6], plain_wall_ms=(time.perf_counter() - t0) * 1e3, k1_launches=_launched("flash_prefill") - k1, rel_err=_rel_err(r["chosen"], chosen),
        top_rel_err=_rel_err(r["top"], top), below_top_max_abs_nats=below,
      )
      if res["k1_launches"] or not (res["rel_err"] < 5e-2 and res["top_rel_err"] < SCORE_ROUTE_TOP_REL and below <= SCORE_ROUTE_NATS):
        raise SystemExit(f"chip_smoke: [api] the scorer's K1 route and its plain route disagree (or the plain route launched K1): {res}")
      out.append(res)
  finally:
    os.environ.pop("XOT_TPU_NO_FLASH")
  return out


def _check_logprobs(label, entries, ids, eos, decode, chat: bool) -> dict:
  """The logprobs of one response against its generated ids: entries one
  for one with the returned tokens (chat: every generated token, as the
  reference; completions: EOS dropped), each chosen log-prob <= 0, each
  top list sorted, top-1 the greedy token wherever the runner-up trails by
  more than ``SCORE_GAP_TOL``."""
  kept = ids if chat else [t for t in ids if t not in eos]
  if chat:
    toks, chosen, tops = [e["token"] for e in entries["content"]], [e["logprob"] for e in entries["content"]], [[(t["token"], t["logprob"]) for t in e["top_logprobs"]] for e in entries["content"]]
  else:
    toks, chosen, tops = entries["tokens"], entries["token_logprobs"], [list(d.items()) for d in entries["top_logprobs"]]
  if toks != [decode([t]) for t in kept] or len(chosen) != len(kept) or len(tops) != len(kept):
    raise SystemExit(f"chip_smoke: [api] {label}: logprobs entries do not line up with the {len(kept)} returned tokens ({len(toks)} entries)")
  near, worst = 0, 0.0
  for tok, lp, top in zip(toks, chosen, tops):
    vals = [v for _, v in top]
    if lp > 0 or vals != sorted(vals, reverse=True):
      raise SystemExit(f"chip_smoke: [api] {label}: chosen log-prob {lp} > 0 or an unsorted top list {top}")
    gap = vals[0] - vals[1] if len(vals) > 1 else math.inf
    if top[0][0] != tok:
      if gap > SCORE_GAP_TOL:
        raise SystemExit(f"chip_smoke: [api] {label}: top-1 {top[0]} is not the greedy token {tok!r} ({lp}) with a gap of {gap} > {SCORE_GAP_TOL}")
      near, worst = near + 1, max(worst, gap)
  return dict(entries=len(kept), top1_not_greedy_within_tol=near, largest_gap_there=worst, min_chosen=min(chosen, default=None))


async def _api_phase(torch, node, engine, port):
  """The default daemon's API surface on the bf16 solo daemon, after its
  gated passes: ``/v1/completions`` (blocking and streaming greedy on the
  72-token prompt, ``echo``, a ``stop`` cut, the 400s), OpenAI logprobs
  (chat ``top_logprobs`` 5 and completions ``logprobs`` 3 on that prompt
  and on the 3,000-token one), token encode, the model lists and pool, a
  download of a local model directory and its progress, the delete of it,
  and the web page. The counters are zeroed just before and read just
  after."""
  from xotorch_support_jetson_tpu_torch.download.downloader import get_models_dir, repo_to_dirname
  from xotorch_support_jetson_tpu_torch.models.loader import save_safetensors
  from xotorch_support_jetson_tpu_torch import registry

  tok = ByteTokenizer()
  eos = {tok.eos_token_id, *engine.cfg.eos_token_ids}
  n_layers = engine.cfg.n_layers
  prompt72 = tok.apply_chat_template(CHAT)
  long_body = long_prompt_body(False)
  prompt_long = tok.apply_chat_template(long_body["messages"])
  if len(tok.encode(prompt72)) != 72 or len(tok.encode(prompt_long)) != LONG_PROMPT_TOKENS:
    raise SystemExit("chip_smoke: [api] unexpected prompt lengths")
  ids: dict[str, list[int]] = {}
  node.on_token.register("chip_smoke_api").on_next(lambda rid, toks, fin: ids.setdefault(rid, []).extend(toks))
  call = lambda method, path, body=None: asyncio.to_thread(_http, port, method, path, body)  # noqa: E731
  res: dict = {}

  def tokens_of(body: dict) -> list[int]:
    rid = body["id"].split("-", 1)[1]
    return ids[rid]

  records: list[dict] = []
  unspy = _spy_scoring(torch, records)
  fam0 = (await asyncio.to_thread(_get_json, port, "/v1/programs"))["families"].get("prefill.score_last", {})
  _reset_launches()  # ---- the API phase, counted
  try:
    t0 = time.perf_counter()
    comp = {"model": "llama-3.2-1b", "prompt": prompt72, "max_tokens": MAX_TOKENS, "temperature": 0}
    st, raw = await call("POST", "/v1/completions", comp)
    blocking = json.loads(raw)
    st_s, raw_s = await call("POST", "/v1/completions", {**comp, "stream": True})
    events = _sse(raw_s)
    stream_text = "".join(c["text"] for e in events for c in e["choices"])
    stream_rid = events[0]["id"].split("-", 1)[1]
    text = blocking["choices"][0]["text"]
    if st != 200 or st_s != 200 or tokens_of(blocking) != ids[stream_rid] or text != stream_text or len(tokens_of(blocking)) != blocking["usage"]["completion_tokens"] or blocking["usage"]["prompt_tokens"] != 72:
      raise SystemExit(f"chip_smoke: [api] /v1/completions: blocking and streaming greedy differ or a bad body ({st}, {st_s}): {raw[:300]}")
    st_e, raw_e = await call("POST", "/v1/completions", {**comp, "echo": True})
    stop = text[len(text) // 2 : len(text) // 2 + 3]
    st_c, raw_c = await call("POST", "/v1/completions", {**comp, "stop": stop})
    cut = json.loads(raw_c)["choices"][0]
    if st_e != 200 or json.loads(raw_e)["choices"][0]["text"] != prompt72 + text or st_c != 200 or cut["text"] != text[: text.find(stop)] or cut["finish_reason"] != "stop":
      raise SystemExit(f"chip_smoke: [api] /v1/completions echo or stop cut wrong: {raw_e[:200]} | stop {stop!r}: {raw_c[:300]}")
    refused = {}
    for name, body in (("two prompts", {**comp, "prompt": ["a", "b"]}), ("empty prompt", {**comp, "prompt": ""}), ("logprobs 50", {**comp, "logprobs": 50}), ("logprobs with stream", {**comp, "logprobs": 2, "stream": True}), ("stream_options not an object", {"messages": CHAT, "stream": True, "stream_options": "usage"})):
      st_r, raw_r = await call("POST", "/v1/chat/completions" if "messages" in body else "/v1/completions", body)
      refused[name] = (st_r, json.loads(raw_r)["error"])
      if st_r != 400:
        raise SystemExit(f"chip_smoke: [api] {name}: {st_r} {raw_r[:200]}, expected 400")
    res["completions"] = dict(tokens=len(tokens_of(blocking)), finish=blocking["choices"][0]["finish_reason"], stop=stop, refused=refused, s=time.perf_counter() - t0)
    log(f"[api] /v1/completions on the 72-token prompt: blocking == streaming greedy ({res['completions']['tokens']} tokens, finish {res['completions']['finish']}); echo prepends the prompt; stop {stop!r} cuts to {len(cut['text'])} chars (finish stop); 400s: {refused}")

    # Logprobs: chat top_logprobs 5 and completions logprobs 3, on both prompts.
    scored = []
    plans = [
      ("chat, 72-token prompt", "/v1/chat/completions", {"model": "llama-3.2-1b", "messages": CHAT, "max_tokens": MAX_TOKENS, "temperature": 0, "logprobs": True, "top_logprobs": 5}, True),
      ("completions, 72-token prompt", "/v1/completions", {**comp, "logprobs": 3}, False),
      ("chat, 3,000-token prompt", "/v1/chat/completions", {**long_body, "logprobs": True, "top_logprobs": 5}, True),
      ("completions, 3,000-token prompt", "/v1/completions", {"model": "llama-3.2-1b", "prompt": prompt_long, "max_tokens": MAX_TOKENS, "temperature": 0, "logprobs": 3}, False),
    ]
    for label, path, body, chat in plans:
      n_rec = len(records)
      st_l, raw_l = await call("POST", path, body)
      if st_l != 200:
        raise SystemExit(f"chip_smoke: [api] logprobs {label}: HTTP {st_l} {raw_l[:300]}")
      data = json.loads(raw_l)
      lp = data["choices"][0]["logprobs"]
      if lp is None or len(records) != n_rec + 1:
        raise SystemExit(f"chip_smoke: [api] logprobs {label}: no logprobs in the body ({len(records) - n_rec} scoring calls)")
      rec = records[-1]
      check = _check_logprobs(label, lp, tokens_of(data), eos, tok.decode, chat)
      if rec["k1"] != n_layers:
        raise SystemExit(f"chip_smoke: [api] logprobs {label}: the scoring forward launched K1 {rec['k1']} times, expected {n_layers} (once per layer)")
      scored.append(dict(label=label, **check, **{k: rec[k] for k in ("S_pad", "seq_len", "n_bucket", "k1", "wall_ms", "device_ms", "peak_bytes")}))
      log(f"[api] logprobs {label}: {check['entries']} entries aligned, min chosen {check['min_chosen']:.4f}, top-1 not the greedy token at {check['top1_not_greedy_within_tol']} near-ties (largest gap there {check['largest_gap_there']:.4f} <= {SCORE_GAP_TOL}) | scoring forward S_pad {rec['S_pad']} n_bucket {rec['n_bucket']}: K1 {rec['k1']} launches, wall {rec['wall_ms']:.3f} ms, device span (CUDA events, idle gaps included) {rec['device_ms']:.3f} ms, peak {rec['peak_bytes'] / 2**20:.1f} MiB above the allocated")
    fam1 = (await asyncio.to_thread(_get_json, port, "/v1/programs"))["families"].get("prefill.score_last", {})
    launches = {n: _launched(n) for n in ("flash_prefill", "flash_decode", "paged_decode", "int4_matmul")}  # ---- read just after
    ledger = {k: fam1.get(k, 0) - fam0.get(k, 0) for k in ("compiles", "dispatches", "steady_compiles", "captures")}
    if ledger["dispatches"] != len(plans):
      raise SystemExit(f"chip_smoke: [api] the ledger shows {ledger['dispatches']} prefill.score_last dispatches for {len(plans)} scored requests: {fam1}")
    res.update(logprobs=scored, ledger=ledger, launches=launches)
    log(f"[api] ledger prefill.score_last over the {len(plans)} scored requests (after POST /v1/warmup): {ledger}; signatures {fam1.get('signatures')}; launches in the phase {launches}")
    unspy()
    res["plain_route"] = _scoring_against_plain(torch, records)
    for r in res["plain_route"]:
      log(f"[api] scoring forward S_pad {r['S_pad']}: plain attention route (XOT_TPU_NO_FLASH) wall {r['plain_wall_ms']:.3f} ms, chosen log-probs within {r['rel_err']:.2e} relative L2 of the K1 route (limit 5e-2), top-{r['top_n']} rows within {r['top_rel_err']:.2e} (limit {SCORE_ROUTE_TOP_REL}), runners-up's distances below the top within {r['below_top_max_abs_nats']:.4f} nats (limit {SCORE_ROUTE_NATS})")
    # Where a scoring call's time goes: host wall against the device's busy
    # time (torch.profiler), one call per bucket.
    from xotorch_support_jetson_tpu_torch.models import decoder as dec

    firsts = {r["S_pad"]: r["call"] for r in records}
    res["profile"] = {S: _profile(torch, f"scoring forward S_pad {S} (n bucket {c[5]}, eager)", lambda c=c: dec.score_last_tokens(*c), 3) for S, c in firsts.items()}

    # The other routes.
    st, raw = await call("POST", "/v1/chat/token/encode", {"model": "llama-3.2-1b", "messages": CHAT})
    enc = json.loads(raw)
    st_i, raw_i = await call("GET", "/initial_models")
    st_p, raw_p = await call("GET", "/modelpool")
    pool = _sse(raw_p)
    if st != 200 or enc["num_tokens"] != 72 or enc["encoded_prompt"] != prompt72 or st_i != 200 or "llama-3.2-1b" not in json.loads(raw_i) or st_p != 200 or "llama-3.2-1b" not in [e["model"] for e in pool]:
      raise SystemExit(f"chip_smoke: [api] token encode / initial_models / modelpool: {raw[:200]} | {raw_i[:200]} | {raw_p[:200]}")
    home = ROOT / "build" / "smoke_home"
    shutil.rmtree(home, ignore_errors=True)
    saved = {k: os.environ.get(k) for k in ("XOT_TPU_HOME", "XOT_TPU_MODEL_DIR")}
    os.environ["XOT_TPU_HOME"] = str(home)
    try:
      throwaway = get_models_dir() / repo_to_dirname(registry.get_repo(THROWAWAY, "TorchShardedInferenceEngine"))
      throwaway.mkdir(parents=True)
      (throwaway / "config.json").write_text("{}")
      save_safetensors(throwaway / "model.safetensors", {"w": torch.zeros(4, dtype=torch.bfloat16)})
      st_m, raw_m = await call("GET", "/v1/models")
      downloaded = [m["id"] for m in json.loads(raw_m)["data"] if m["downloaded"]]
      os.environ.pop("XOT_TPU_MODEL_DIR")  # the served model stays loaded; the download resolves the throw-away directory
      st_d, raw_d = await call("POST", "/download", {"model": THROWAWAY})
      for _ in range(100):
        if node.node_download_progress:
          break
        await asyncio.sleep(0.05)
      os.environ["XOT_TPU_MODEL_DIR"] = saved["XOT_TPU_MODEL_DIR"]
      st_g, raw_g = await call("GET", "/v1/download/progress")
      progress = json.loads(raw_g).get(str(node.id), {})
      st_x, raw_x = await call("DELETE", f"/models/{THROWAWAY}")
      st_y, raw_y = await call("DELETE", f"/models/{THROWAWAY}")
    finally:
      for k, v in saved.items():
        if v is None:
          os.environ.pop(k, None)
        else:
          os.environ[k] = v
      shutil.rmtree(home, ignore_errors=True)
    served = Path(saved["XOT_TPU_MODEL_DIR"])
    if st_m != 200 or downloaded != [THROWAWAY] or st_d != 200 or progress.get("status") != "complete" or progress.get("total_files") != 2 or st_x != 200 or st_y != 404 or throwaway.exists() or not (served / "model.safetensors").exists():
      raise SystemExit(f"chip_smoke: [api] models / download / progress / delete: downloaded {downloaded}; {raw_d}; progress {progress}; delete {st_x} {raw_x} then {st_y} {raw_y}; served checkpoint present {(served / 'model.safetensors').exists()}")
    st_h, page = await call("GET", "/")
    missing = [n for n in HOME_NEEDLES if n not in page]
    if st_h != 200 or missing:
      raise SystemExit(f"chip_smoke: [api] GET /: {st_h}, missing {missing}")
    res["routes"] = dict(encode_tokens=enc["num_tokens"], initial_models=len(json.loads(raw_i)), modelpool_events=len(pool), downloaded=downloaded, progress={k: progress[k] for k in ("status", "total_files", "total_bytes", "repo_id")}, delete=(st_x, st_y), page_bytes=len(page))
    log(f"[api] token encode {enc['num_tokens']} tokens; /initial_models {res['routes']['initial_models']} cards, /modelpool {len(pool)} events; /v1/models downloaded {downloaded}; POST /download {THROWAWAY} (local directory) -> progress {res['routes']['progress']}; DELETE /models/{THROWAWAY} {st_x} then {st_y}, the served checkpoint untouched; GET / {len(page)} bytes with every needle")
  finally:
    node.on_token.deregister("chip_smoke_api")
    unspy()
  return res


async def _batched_logprobs(torch, node, engine, port):
  """One chat request with logprobs on the batched daemon, after its gated
  windows: generated by the batched server, scored on the engine's one
  executor thread (the thread of the batched replays), K1 once per layer
  in the scoring forward, one ``prefill.score_last`` dispatch. The counters
  are zeroed just before and read just after."""
  tok = ByteTokenizer()
  ids: dict[str, list[int]] = {}
  node.on_token.register("chip_smoke_lp").on_next(lambda rid, toks, fin: ids.setdefault(rid, []).extend(toks))
  records: list[dict] = []
  unspy = _spy_scoring(torch, records)
  fam0 = (await asyncio.to_thread(_get_json, port, "/v1/programs"))["families"].get("prefill.score_last", {})
  _reset_launches()  # ---- the batched logprobs request, counted
  try:
    st, raw = await asyncio.to_thread(_http, port, "POST", "/v1/chat/completions", {"model": "llama-3.2-1b", "messages": CHAT, "max_tokens": 32, "temperature": 0, "logprobs": True, "top_logprobs": 5})
  finally:
    unspy()
    node.on_token.deregister("chip_smoke_lp")
  launches = {n: _launched(n) for n in ("flash_prefill", "flash_decode", "paged_decode", "int4_matmul")}  # ---- read just after
  executor_thread = await asyncio.get_running_loop().run_in_executor(engine.executor, threading.get_ident)
  fam1 = (await asyncio.to_thread(_get_json, port, "/v1/programs"))["families"].get("prefill.score_last", {})
  if st != 200:
    raise SystemExit(f"chip_smoke: [api] batched logprobs: HTTP {st} {raw[:300]}")
  data = json.loads(raw)
  lp = data["choices"][0]["logprobs"]
  if lp is None or len(records) != 1:
    raise SystemExit(f"chip_smoke: [api] batched logprobs: logprobs {lp is not None}, {len(records)} scoring calls")
  rid = data["id"].split("-", 1)[1]
  check = _check_logprobs("batched chat", lp, ids[rid], {tok.eos_token_id, *engine.cfg.eos_token_ids}, tok.decode, True)
  rec = records[0]
  dispatches = fam1.get("dispatches", 0) - fam0.get("dispatches", 0)
  if rec["k1"] != engine.cfg.n_layers or rec["thread"] != executor_thread or dispatches != 1:
    raise SystemExit(f"chip_smoke: [api] batched logprobs: K1 {rec['k1']} launches, scored on the executor thread {rec['thread'] == executor_thread}, {dispatches} prefill.score_last dispatches")
  if launches["paged_decode"] == 0:
    raise SystemExit(f"chip_smoke: [api] batched logprobs: the request did not decode on the batched server (launches {launches})")
  res = dict(**check, k1=rec["k1"], wall_ms=rec["wall_ms"], device_ms=rec["device_ms"], peak_bytes=rec["peak_bytes"], S_pad=rec["S_pad"], dispatches=dispatches, launches=launches)
  log(f"[api] batched chat with logprobs: {check['entries']} entries aligned ({check['top1_not_greedy_within_tol']} near-ties); scored on the engine's executor thread, serialised with the batched replays; K1 {rec['k1']} launches; wall {rec['wall_ms']:.3f} ms, device span {rec['device_ms']:.3f} ms; one prefill.score_last dispatch")
  return res


# The run command and /quit against daemon processes (a SIGINT in this
# process would stop the smoke run): the checkpoint gets tokenizer files,
# since a process resolves its tokenizer from the checkpoint directory.
QUIT_EXIT_S = 60  # a daemon that got POST /quit must have exited within this


def write_tokenizer(path: Path) -> None:
  """A word-level tokenizer over llama-3.2-1b's 128,256 ids ("t<id>"; BOS
  128000, EOS 128009) with a plain chat template, as HF files."""
  from tokenizers import Tokenizer, models, pre_tokenizers
  from transformers import PreTrainedTokenizerFast

  vocab = {f"t{i}": i for i in range(LLAMA_3_2_1B["vocab_size"])}
  vocab["<|begin_of_text|>"] = vocab.pop("t128000")
  vocab["<|eot_id|>"] = vocab.pop("t128009")
  tm = Tokenizer(models.WordLevel(vocab, unk_token="t0"))
  tm.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
  tok = PreTrainedTokenizerFast(tokenizer_object=tm, unk_token="t0", bos_token="<|begin_of_text|>", eos_token="<|eot_id|>")
  tok.chat_template = "{% for m in messages %}{{ m['role'] }}: {{ m['content'] }} {% endfor %}assistant:"
  tok.save_pretrained(path)


def phase_processes(ckpt: Path):
  """``python -m xotorch_support_jetson_tpu_torch.main run llama-3.2-1b``
  prints tokens and exits 0; a daemon process serves a completion, gets
  ``POST /quit`` and exits 0 within ``QUIT_EXIT_S``. The daemon loads its
  model at its first request, so it starts first, the tokenizer files are
  written while it starts, and its completion is sent while the run
  command runs (the two loads overlap)."""
  from concurrent.futures import ThreadPoolExecutor

  from xotorch_support_jetson_tpu_torch.utils.helpers import find_available_port

  env = {k: v for k, v in os.environ.items() if k not in SERVING_KNOBS}
  env.update(XOT_TPU_MODEL_DIR=str(ckpt))
  cmd = [sys.executable, "-m", "xotorch_support_jetson_tpu_torch.main"]
  port = find_available_port("127.0.0.1")
  t_up = time.perf_counter()
  proc = subprocess.Popen([*cmd, "--discovery-module", "none", "--chatgpt-api-host", "127.0.0.1", "--chatgpt-api-port", str(port), "--max-generate-tokens", "16"], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  try:
    t0 = time.perf_counter()
    write_tokenizer(ckpt)
    tokenizer_s = time.perf_counter() - t0

    def run_command():
      t0 = time.perf_counter()
      run = subprocess.run([*cmd, "run", "llama-3.2-1b", "--discovery-module", "none", "--prompt", CHAT[0]["content"], "--temp", "0", "--max-generate-tokens", "32"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
      return run, time.perf_counter() - t0

    with ThreadPoolExecutor(1) as pool:
      running = pool.submit(run_command)
      while True:
        if proc.poll() is not None or time.perf_counter() - t_up > 300:
          raise SystemExit(f"chip_smoke: [api] the daemon process did not come up (exit {proc.poll()})")
        try:
          if _http(port, "GET", "/healthcheck", timeout=5)[0] == 200:
            break
        except OSError:
          time.sleep(0.5)
      up_s = time.perf_counter() - t_up
      t0 = time.perf_counter()
      st, raw = _http(port, "POST", "/v1/completions", {"model": "llama-3.2-1b", "prompt": "t1 t2 t3", "max_tokens": 8, "temperature": 0})
      served_s = time.perf_counter() - t0
      if st != 200 or json.loads(raw)["usage"]["completion_tokens"] < 1:
        raise SystemExit(f"chip_smoke: [api] the daemon process did not serve: {st} {raw[:300]}")
      run, run_s = running.result()
    stats = run.stdout.rstrip().rsplit("\n", 1)[-1]
    if run.returncode != 0 or not stats.startswith("[") or " tokens in " not in stats or int(stats[1:].split(" ")[0]) < 1:
      raise SystemExit(f"chip_smoke: [api] the run command exited {run.returncode}: {run.stdout[-600:]} {run.stderr[-1500:]}")
    log(f"[api] tokenizer files written in {tokenizer_s:.1f} s (while the daemon process started); run command (a process): exit 0 in {run_s:.1f} s; it printed {run.stdout.strip()[:160]!r} ... {stats}")
    t1 = time.perf_counter()
    st_q, raw_q = _http(port, "POST", "/quit")
    try:
      rc = proc.wait(timeout=QUIT_EXIT_S)
    except subprocess.TimeoutExpired:
      raise SystemExit(f"chip_smoke: [api] the daemon process did not exit within {QUIT_EXIT_S} s of POST /quit") from None
    quit_s = time.perf_counter() - t1
    if st_q != 200 or rc != 0:
      raise SystemExit(f"chip_smoke: [api] POST /quit: {st_q} {raw_q}; the process exited {rc}: {proc.stdout.read()[-600:]}")
  finally:
    if proc.poll() is None:
      proc.kill()
    proc.communicate()
  log(f"[api] daemon process (started first): up {up_s:.1f} s after its start, served a completion in {served_s:.1f} s (its model loaded beside the run command's), POST /quit -> exit 0 in {quit_s:.2f} s (limit {QUIT_EXIT_S} s)")
  return dict(tokenizer_s=tokenizer_s, run_s=run_s, run_stats=stats, up_s=up_s, served_s=served_s, quit_exit_s=quit_s)


# ---------------------------------------------------------------- 8b. ring

RING_MODEL = "llama-3.2-1b"
RING_BIG_MODEL = ("llama-3.1-8b", {**LLAMA_3_2_1B, "hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 32, "head_dim": 128, "tie_word_embeddings": False})
# The three daemons: id, layers and reported memory (MB). Memories in a
# 2 : 1 : 1 ratio give 0-7 / 8-11 / 12-15; the middle reports 1 MB more, so
# the ring's order (memory descending) puts it before the tail.
RING_NODES = (("ring-head", (0, 7), 4800), ("ring-middle", (8, 11), 2401), ("ring-tail", (12, 15), 2400))
RING_WORDS = 70  # the chat content: 70 words of the word-level tokenizer, a 72-token prompt with the template's two
RING_STEPS = MAX_TOKENS
RING_FLASH_STEPS = 8
RING_LAP_REPS = 3
RING_UP_S = 240  # the three daemons up, their views converged
RING_DEVICE = "cuda"


def ring_chat(stream: bool, model: str = RING_MODEL) -> dict:
  content = " ".join(f"t{(1000 + 7919 * i) % 120000}" for i in range(RING_WORDS))
  return {"model": model, "messages": [{"role": "user", "content": content}], "stream": stream, "temperature": 0, "max_tokens": RING_STEPS}


def ring_ids(text: str) -> list[int]:
  """Token ids of a completion of the word-level tokenizer (``write_tokenizer``)."""
  special = {"<|begin_of_text|>": 128000, "<|eot_id|>": 128009}
  return [special[w] if w in special else int(w[1:]) for w in text.split()]


def phase_ring(torch, ckpt: Path, smi: str, solo: dict | None):
  """The ring: llama-3.2-1b split over three partial shards, in this
  process (part a) and as three daemon processes (part b). The daemons
  start first, and their start-up and warm-up request overlap part a's
  loads and checks; part a's timing waits for them."""
  daemons = _start_ring_daemons(ckpt)
  warm = threading.Thread(target=_warm_ring_daemons, args=(daemons,), daemon=True)
  warm.start()
  try:
    os.environ["XOT_TPU_MODEL_DIR"] = str(ckpt)
    for knob in SERVING_KNOBS:
      os.environ.pop(knob, None)
    part_a = asyncio.run(_ring_in_process(torch, smi, quiet=lambda: warm.join(RING_UP_S)))
    os.environ.pop("XOT_TPU_MODEL_DIR", None)
    part_b = _ring_daemons(daemons, smi, part_a, solo)
  finally:
    _stop_ring_daemons(daemons)
  return dict(in_process=part_a, daemons=part_b, launches={k: part_a["launches"].get(k, 0) for k in ("flash_prefill", "flash_decode", "int4_matmul")}, daemon_launches=part_b["launches"])


async def _ring_engines(shards):
  from xotorch_support_jetson_tpu_torch.download.downloader import new_shard_downloader
  from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine

  engines = [TorchShardedInferenceEngine(new_shard_downloader()) for _ in shards]
  for e, s in zip(engines, shards):
    await e.ensure_shard(s)
  return engines


async def _ring_lap(engines, shards, rid, x, state, hops=None):
  """One hop through each shard, each hidden state moved to the host as
  the peer transport moves it."""
  for e, s in zip(engines, shards):
    x, state = await e.infer_tensor(rid, s, x, state)
    if hops is not None:
      hops.append(x)
  return x, state


async def _ring_generate(engines, shards, rid, ids, steps, hops=None, lap_s=None):
  """Greedy ids of ``steps`` laps (the prefill's and each step's), chained
  by hand; each lap's host seconds go to ``lap_s``."""
  import torch

  logits, state = await _ring_lap(engines, shards, rid, np.asarray([ids], np.int32), None, hops)
  first_logits, out = logits, [int(np.argmax(logits[0]))]
  for _ in range(steps - 1):
    t0 = time.perf_counter()
    logits, state = await _ring_lap(engines, shards, rid, np.asarray([[out[-1]]], np.int32), state, hops)
    out.append(int(np.argmax(logits[0])))
    if lap_s is not None:
      torch.cuda.synchronize()
      lap_s.append(time.perf_counter() - t0)
  for e in engines:
    e.end_request(rid)
  return out, first_logits


def _first_difference(got: list[int], ref: list[int], gaps: list[float], valid: int) -> tuple[int, bool]:
  """(positions that agree before the first difference, whether that
  difference is allowed): ``got`` may leave ``ref`` only at a near-tie of
  the whole model, a position whose top-2 gap (``gaps``, along the whole
  model's trajectory, which ``ref`` follows over its first ``valid``
  positions) is within SCORE_GAP_TOL; past ``valid`` the gaps say nothing
  and a difference is reported, not gated."""
  k = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b), None)
  if k is None:
    return min(len(got), len(ref)), True
  return k, k >= valid or gaps[k] <= SCORE_GAP_TOL


async def _ring_in_process(torch, smi, quiet=None):
  """Part a; ``quiet`` (blocking) returns once the daemons' warm-up has
  ended, before the timed laps."""
  from xotorch_support_jetson_tpu_torch.api.chatgpt_api import Message, build_prompt
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard
  from xotorch_support_jetson_tpu_torch.models.decoder import init_kv_cache, shard_forward
  from xotorch_support_jetson_tpu_torch.networking.tcp.serialization import encode_frame, state_fields
  from xotorch_support_jetson_tpu_torch.utils.programs import ledger

  shards = [Shard(RING_MODEL, a, b, 16) for _, (a, b), _ in RING_NODES]
  full_shard = Shard(RING_MODEL, 0, 15, 16)
  t0 = time.perf_counter()
  (full,) = await _ring_engines([full_shard])
  prompt = build_prompt(full.tokenizer, [Message("user", ring_chat(False)["messages"][0]["content"])])
  ids = [int(t) for t in full.tokenizer.encode(prompt)]
  if len(ids) != RING_WORDS + 2:
    raise SystemExit(f"chip_smoke: [ring] the chat prompt has {len(ids)} tokens, expected {RING_WORDS + 2}")
  # The whole model's reference: its captured prefill's logits, its greedy
  # ids, and the top-2 gap of the plain forward at every answer position.
  ref_logits, _ = await full.infer_tensor("ring-ref", full_shard, np.asarray([ids], np.int32))
  first = int(np.argmax(ref_logits[0]))
  ref_ids = [first] + await full.generate_oneshot("ring-ref", full_shard, first, RING_STEPS - 1, (), 0.0, 35)
  full.end_request("ring-ref")
  seq = torch.tensor([ids + ref_ids[:-1]], dtype=torch.int32, device=RING_DEVICE)
  with torch.no_grad():
    all_logits, _ = shard_forward(full.params, full.cfg, full._effective_shard, seq, torch.arange(seq.shape[1], dtype=torch.int32, device=RING_DEVICE)[None], None)
  top2 = all_logits[0, len(ids) - 1 :].float().topk(2, dim=-1).values
  gaps = (top2[:, 0] - top2[:, 1]).tolist()
  eos = set(full.cfg.eos_token_ids)
  del full, all_logits
  gc.collect()
  torch.cuda.empty_cache()
  engines = await _ring_engines(shards)
  load_s = time.perf_counter() - t0
  # Warm-up: one chained request builds and captures every program.
  await _ring_generate(engines, shards, "ring-warm", ids, 4)
  snap0 = ledger.snapshot()["families"]
  builds0 = {f: (snap0.get(f, {}).get("compiles", 0), snap0.get(f, {}).get("captures", 0)) for f in ("ring.prefill", "ring.step")}
  _reset_launches()  # ---- the ring's main path, counted
  hops = []
  ring_ids_, tail_logits = await _ring_generate(engines, shards, "ring-a", ids, RING_STEPS, hops=hops)
  launches = {n: _launched(n) for n in ("flash_prefill", "flash_decode", "int4_matmul")}  # ---- read just after
  snap1 = ledger.snapshot()["families"]
  builds1 = {f: (snap1[f]["compiles"], snap1[f].get("captures", 0)) for f in ("ring.prefill", "ring.step")}
  if builds1 != builds0:
    raise SystemExit(f"chip_smoke: [ring] programs were built after the warm-up: {builds0} -> {builds1}")
  if launches["flash_prefill"] != 16 or launches["flash_decode"] or launches["int4_matmul"]:
    raise SystemExit(f"chip_smoke: [ring] launches of one chained request {launches}: K1 must run once per layer of each shard's prefill (8 + 4 + 4)")
  err = _rel_err(torch.from_numpy(tail_logits), torch.from_numpy(ref_logits))
  if not err < 5e-2:
    raise SystemExit(f"chip_smoke: [ring] the tail's prefill logits are {err:.3e} (relative L2) from the whole model's")
  n_gate, ok = _first_difference(ring_ids_, ref_ids, gaps, len(ref_ids))
  if not ok:
    raise SystemExit(f"chip_smoke: [ring] chained greedy ids leave the whole model's at position {n_gate}, where its top-2 gap {gaps[n_gate]:.4f} is above {SCORE_GAP_TOL}:\n{ring_ids_}\n{ref_ids}")
  log(f"[ring] in-process: shards {[(s.start_layer, s.end_layer) for s in shards]} loaded (and the whole model for the reference) in {load_s:.1f} s; a 72-token prompt, {RING_STEPS} greedy laps chained by hand")
  log(f"[ring] launches of the counted request: {launches} (K1 8 + 4 + 4 = 16 per chained prefill; no build or capture after the warm-up: {builds1})")
  log(f"[ring] tail prefill logits vs the whole model's: {err:.3e} relative L2 (gate 5e-2); ids equal the whole model's over the first {n_gate} of {len(ref_ids)} (a difference is allowed only at a near-tie, a top-2 gap within {SCORE_GAP_TOL}; {sum(g <= SCORE_GAP_TOL for g in gaps)} of the {len(gaps)} positions are, the smallest gap {min(gaps):.4f} at {int(np.argmin(gaps))})")
  # Captured against uncaptured, per shard: the prefill and one step on a
  # fresh cache, from the same inputs the counted request's hops had.
  x_pre = np.zeros((1, 128), np.int32)
  x_pre[0, : len(ids)] = ids
  inputs = [torch.from_numpy(x_pre).to(RING_DEVICE), hops[0].to(RING_DEVICE), hops[1].to(RING_DEVICE)]
  step_inputs = [torch.tensor([[ring_ids_[0]]], dtype=torch.int32, device=RING_DEVICE), hops[3].to(RING_DEVICE), hops[4].to(RING_DEVICE)]
  captured = [hops[0], hops[1], torch.from_numpy(tail_logits)], [hops[3], hops[4], torch.from_numpy(np.asarray(hops[5]))]
  checks = []
  for i, e in enumerate(engines):
    cfg, shard, params = e.cfg, e._effective_shard, e.params
    cache = init_kv_cache(cfg, shard.n_shard_layers, 1, CACHE, device=RING_DEVICE)
    last = shard.is_last_layer
    with torch.no_grad():
      y, _ = shard_forward(params, cfg, shard, inputs[i], torch.arange(128, dtype=torch.int32, device=RING_DEVICE)[None], cache, head_pos=torch.tensor([len(ids) - 1], device=RING_DEVICE) if last else None)
      y = y[:, 0, :].float().cpu() if last else y.cpu()
      z, _ = shard_forward(params, cfg, shard, step_inputs[i], torch.tensor([[len(ids)]], dtype=torch.int32, device=RING_DEVICE), cache)
      z = z[:, 0, :].float().cpu() if last else z.cpu()
    pe, se = _rel_err(captured[0][i].float(), y.float()), _rel_err(captured[1][i].float(), z.float())
    if not (pe < 5e-2 and se < 5e-2) or (not last and (hops[i].dtype != torch.bfloat16 or hops[3 + i].dtype != torch.bfloat16)):
      raise SystemExit(f"chip_smoke: [ring] shard {i}: captured prefill / step {pe:.3e} / {se:.3e} from the uncaptured forward, or a hop not in bf16")
    checks.append(dict(shard=(shard.start_layer, shard.end_layer), prefill_rel_err=pe, step_rel_err=se, prefill_equal=bool(torch.equal(captured[0][i].float(), y.float())), step_equal=bool(torch.equal(captured[1][i].float(), z.float()))))
  log(f"[ring] captured vs uncaptured per shard (prefill, step; relative L2, bit-equal): {[(c['shard'], round(c['prefill_rel_err'], 6), round(c['step_rel_err'], 6), c['prefill_equal'], c['step_equal']) for c in checks]}")
  # The bytes each hop carries: the hidden state (bf16) and the frame the
  # peer transport sends with it (the state's token history included).
  _, st = await engines[0].infer_tensor("ring-bytes", shards[0], np.asarray([ids], np.int32), None)
  prefill_frame = len(encode_frame({"state": state_fields(st)[0]}, {"tensor": hops[0], "state_tokens": st.tokens}))
  step_frame = len(encode_frame({"state": state_fields(st)[0]}, {"tensor": hops[3], "state_tokens": st.tokens}))
  engines[0].end_request("ring-bytes")
  hop_bytes = dict(prefill_tensor=hops[0].numel() * hops[0].element_size(), step_tensor=hops[3].numel() * hops[3].element_size(), prefill_frame=prefill_frame, step_frame_at_prompt=step_frame)
  log(f"[ring] bytes per hop: prefill hidden state {hop_bytes['prefill_tensor']} B ({hop_bytes['prefill_tensor'] / 1024:.0f} KiB, 128 x 2048 bf16), a step's {hop_bytes['step_tensor']} B; frames with the state: {prefill_frame} B and {step_frame} B")
  # K2 on the ring: each shard's step with XOT_TPU_FLASH_DECODE=1.
  os.environ.update(XOT_TPU_FLASH_DECODE="1", XOT_TPU_FLASH_DECODE_MIN=str(CACHE))
  try:
    _reset_launches()
    flash_ids, _ = await _ring_generate(engines, shards, "ring-k2", ids, RING_FLASH_STEPS + 1)
    launches["flash_decode"] = _launched("flash_decode")
    launches["flash_prefill"] += _launched("flash_prefill")
  finally:
    os.environ.pop("XOT_TPU_FLASH_DECODE"), os.environ.pop("XOT_TPU_FLASH_DECODE_MIN")
  if launches["flash_decode"] != 16 * RING_FLASH_STEPS:
    raise SystemExit(f"chip_smoke: [ring] K2 launched {launches['flash_decode']} times in {RING_FLASH_STEPS} ring steps (16 per lap)")
  log(f"[ring] XOT_TPU_FLASH_DECODE=1: K2 {launches['flash_decode']} launches in {RING_FLASH_STEPS} laps (once per layer of each shard's step); ids agree with the default ring's on {sum(a == b for a, b in zip(flash_ids, ring_ids_))}/{len(flash_ids)}")
  # K4 on the ring: the three shards loaded again with XOT_TPU_QUANT=int4.
  os.environ["XOT_TPU_QUANT"] = "int4"
  try:
    int4_engines = await _ring_engines(shards)
    _reset_launches()
    int4_ids, _ = await _ring_generate(int4_engines, shards, "ring-int4", ids, RING_FLASH_STEPS + 1)
    launches["int4_matmul"] = _launched("int4_matmul")
    launches["flash_prefill"] += _launched("flash_prefill")
    for e in int4_engines:
      e.executor.shutdown(wait=True)
    del int4_engines
  finally:
    os.environ.pop("XOT_TPU_QUANT")
  gc.collect()
  torch.cuda.empty_cache()
  if not launches["int4_matmul"]:
    raise SystemExit("chip_smoke: [ring] K4 never launched on int4 shards")
  log(f"[ring] XOT_TPU_QUANT=int4: K4 {launches['int4_matmul']} launches in a prefill and {RING_FLASH_STEPS} laps (7 products per layer and the tail's head: 113 a lap); ids agree with bf16 on {sum(a == b for a, b in zip(int4_ids, ring_ids_))}/{len(int4_ids)}")
  # Timing, on a quiet card (the daemons' warm-up request has ended): the
  # per-token lap of a chained request against each shard's captured step,
  # device time (CUDA events behind a spin kernel), summed over the three.
  if quiet is not None:
    await asyncio.to_thread(quiet)
  lap_s = []
  await _ring_generate(engines, shards, "ring-lap", ids, RING_STEPS, lap_s=lap_s)
  step_ms = []
  for i, e in enumerate(engines):
    await e.infer_tensor("ring-time", shards[i], np.asarray([ids], np.int32) if i == 0 else hops[i - 1], None)
    progs, x = e.sessions["ring-time"].programs, step_inputs[i].cpu() if i else np.asarray([[ring_ids_[0]]], np.int32)
    wall, dev = _replay_ms(torch, lambda: progs.forward(x, len(ids)), 1)
    step_ms.append(dict(wall_ms=wall, device_ms=dev))
    e.end_request("ring-time")
  lap_ms = sorted(1e3 * s for s in lap_s)
  lap = dict(median_ms=lap_ms[len(lap_ms) // 2], mean_ms=sum(lap_ms) / len(lap_ms), min_ms=lap_ms[0], device_sum_ms=sum(s["device_ms"] for s in step_ms), steps=step_ms)
  log(f"[ring] per-token lap (3 hops chained by hand, hidden states through the host; {smi}): median {lap['median_ms']:.3f} ms, mean {lap['mean_ms']:.3f}, min {lap['min_ms']:.3f} against the three captured steps' device time {lap['device_sum_ms']:.3f} ms ({', '.join(f'{s['device_ms']:.3f}' for s in step_ms)}; wall {', '.join(f'{s['wall_ms']:.3f}' for s in step_ms)})")
  for e in engines:
    e.executor.shutdown(wait=True)
  del engines
  gc.collect()
  torch.cuda.empty_cache()
  return dict(prompt_tokens=len(ids), ids=ring_ids_, ref_ids=ref_ids, gaps=gaps, gated=n_gate, tail_rel_err=err, launches=launches, checks=checks, hop_bytes=hop_bytes, lap=lap, load_s=load_s, eos=sorted(eos))


def _ring_metrics_launches(port: int) -> dict:
  _, text = _http(port, "GET", "/metrics", timeout=60)
  out = {}
  for line in text.splitlines():
    if line.startswith("xot_tpu_kernel_launches_total{"):
      name = line.split('kernel="', 1)[1].split('"', 1)[0]
      out[name] = int(float(line.rsplit(" ", 1)[1]))
  return out


def _ring_request(port: int, body: dict) -> dict:
  """One chat request: its ids, and for a stream the client's TTFT and
  decode rate."""
  t0 = time.perf_counter()
  st, raw = _http(port, "POST", "/v1/chat/completions", body)
  total = time.perf_counter() - t0
  if st != 200:
    raise SystemExit(f"chip_smoke: [ring] chat on port {port}: {st} {raw[:600]}")
  if not body["stream"]:
    return dict(ids=ring_ids(json.loads(raw)["choices"][0]["message"]["content"]), total_s=total)
  # A stream read whole here: its TTFT comes from a second, streamed read.
  text = "".join(ev["choices"][0]["delta"].get("content") or "" for ev in _sse(raw) if ev.get("choices"))
  return dict(ids=ring_ids(text), total_s=total)


def _start_ring_daemons(ckpt: Path) -> dict:
  """Start three daemon processes on the card, a ring through manual
  discovery on 127.0.0.1, the weights found under their ``XOT_TPU_HOME``
  (with llama-3.1-8b's ``config.json`` alone beside them)."""
  from xotorch_support_jetson_tpu_torch import registry
  from xotorch_support_jetson_tpu_torch.download.downloader import repo_to_dirname
  from xotorch_support_jetson_tpu_torch.utils.helpers import find_available_port

  home = ROOT / "build" / "ring_home"
  shutil.rmtree(home, ignore_errors=True)
  downloads = home / "downloads"
  downloads.mkdir(parents=True)
  (downloads / repo_to_dirname(registry.get_repo(RING_MODEL, "TorchShardedInferenceEngine"))).symlink_to(ckpt.resolve(), target_is_directory=True)
  big = downloads / repo_to_dirname(registry.get_repo(RING_BIG_MODEL[0], "TorchShardedInferenceEngine"))
  big.mkdir()
  (big / "config.json").write_text(json.dumps(RING_BIG_MODEL[1]))  # its geometry only: the 507 request loads nothing
  node_ports = [find_available_port("127.0.0.1") for _ in RING_NODES]
  api_ports = [find_available_port("127.0.0.1") for _ in RING_NODES]
  config = home / "ring.json"
  config.write_text(json.dumps({"peers": {nid: {"address": "127.0.0.1", "port": p, "device_capabilities": {"model": "H100", "chip": "gpu", "memory": mb, "flops": {"fp32": 0, "fp16": 0, "int8": 0}}} for (nid, _, mb), p in zip(RING_NODES, node_ports)}}))
  env = {k: v for k, v in os.environ.items() if k not in SERVING_KNOBS and k != "XOT_TPU_MODEL_DIR"}
  env["XOT_TPU_HOME"] = str(home)
  daemons = dict(home=home, api_ports=api_ports, procs=[], logs=[], t_up=time.perf_counter())
  for (nid, _, mb), np_, ap in zip(RING_NODES, node_ports, api_ports):
    log_f = open(home / f"{nid}.log", "w")
    daemons["logs"].append(log_f)
    daemons["procs"].append(subprocess.Popen(
      [sys.executable, "-m", "xotorch_support_jetson_tpu_torch.main", "--discovery-module", "manual", "--discovery-config-path", str(config), "--node-id", nid,
       "--node-host", "127.0.0.1", "--node-port", str(np_), "--chatgpt-api-host", "127.0.0.1", "--chatgpt-api-port", str(ap),
       "--max-generate-tokens", str(RING_STEPS), "--temp", "0", "--default-model", RING_MODEL],
      cwd=ROOT, env={**env, "XOT_TPU_MEMORY_MB": str(mb)}, stdout=log_f, stderr=subprocess.STDOUT,
    ))
  return daemons


def _stop_ring_daemons(daemons: dict) -> None:
  """Kill whatever still runs, and keep the daemons' logs."""
  for p in daemons["procs"]:
    if p.poll() is None:
      p.kill()
    p.wait()
  for f in daemons["logs"]:
    f.close()
  out = ROOT / "chiprun_out" / "ring_daemons"
  out.mkdir(parents=True, exist_ok=True)
  for nid, _, _ in RING_NODES:
    src = daemons["home"] / f"{nid}.log"
    if src.exists():
      shutil.copyfile(src, out / f"{nid}.log")


def _warm_ring_daemons(daemons: dict) -> None:
  """Wait until every daemon is up and their views converged (every
  ``/v1/topology`` lists the three with their memories), then send one
  warm-up request, which loads each shard and captures its programs. Runs
  on a thread; its outcome goes to ``daemons``."""
  try:
    home, procs, api_ports, t_up = daemons["home"], daemons["procs"], daemons["api_ports"], daemons["t_up"]
    want = {nid for nid, _, _ in RING_NODES}
    while True:
      for p, (nid, _, _) in zip(procs, RING_NODES):
        if p.poll() is not None:
          raise RuntimeError(f"daemon {nid} exited {p.returncode}: {(home / f'{nid}.log').read_text()[-1500:]}")
      if time.perf_counter() - t_up > RING_UP_S:
        raise RuntimeError("the daemons did not come up and converge")
      try:
        views = [json.loads(_http(ap, "GET", "/v1/topology", timeout=5)[1]) for ap in api_ports]
        if all(set(v["nodes"]) == want and all(v["nodes"][nid]["memory"] == mb for nid, _, mb in RING_NODES) for v in views):
          break
      except (OSError, ValueError, KeyError):
        pass
      time.sleep(0.5)
    daemons["up_s"] = time.perf_counter() - t_up
    t0 = time.perf_counter()
    _ring_request(api_ports[0], {**ring_chat(True), "max_tokens": 4})
    daemons["warm_s"] = time.perf_counter() - t0
  except BaseException as e:  # noqa: BLE001 — reported by the main thread
    daemons["error"] = e


def _ring_daemons(daemons: dict, smi: str, part_a: dict, solo: dict | None):
  """Part b, after the warm-up: the counted requests and the gates."""
  procs, api_ports = daemons["procs"], daemons["api_ports"]
  if "error" in daemons or "warm_s" not in daemons:
    raise SystemExit(f"chip_smoke: [ring] the daemons' start-up or warm-up failed: {daemons.get('error', 'it did not end in time')!r}")
  up_s, warm_s = daemons["up_s"], daemons["warm_s"]
  want = {nid for nid, _, _ in RING_NODES}
  log(f"[ring] three daemons up and converged {up_s:.1f} s after their start, their warm-up request (shard loads, captures) {warm_s:.1f} s, both beside part a: every /v1/topology listed {sorted(want)} with memories {[mb for _, _, mb in RING_NODES]} MB")
  head, tail = api_ports[0], api_ports[-1]
  before = [_ring_metrics_launches(p) for p in api_ports]  # ---- the daemons' main path, counted
  t0 = time.perf_counter()
  stream = _post(head, ring_chat(True))
  stream_ids = ring_ids(stream[0])
  answers = {"head streaming": stream_ids, "head blocking": _ring_request(head, ring_chat(False))["ids"], "tail streaming": _ring_request(tail, ring_chat(True))["ids"]}
  served_s = time.perf_counter() - t0
  after = [_ring_metrics_launches(p) for p in api_ports]  # ---- read just after
  per_node = [{k: a.get(k, 0) - b.get(k, 0) for k in a} for a, b in zip(after, before)]
  launches = {k: sum(n.get(k, 0) for n in per_node) for k in ("flash_prefill", "flash_decode", "paged_decode", "int4_matmul")}
  want_k1 = [8 * 3, 4 * 3, 4 * 3]
  if [n.get("flash_prefill", 0) for n in per_node] != want_k1:
    raise SystemExit(f"chip_smoke: [ring] K1 launches per daemon {[n.get('flash_prefill', 0) for n in per_node]}, expected {want_k1} (its layers, once per prefill of 3 requests)")
  # Each answer against the in-process ring's ids (which follow the whole
  # model's over their first ``gated``): it may leave them only at a
  # near-tie, and without one it ends where they reach an EOS (the text
  # holds none) or the 64 tokens.
  ref, eos = part_a["ids"], set(part_a["eos"])
  ref_text = ref[: next((i for i, t in enumerate(ref) if t in eos), len(ref))]
  agree = {}
  for label, got in answers.items():
    k, ok = _first_difference(got, ref_text, part_a["gaps"], part_a["gated"])
    agree[label] = k
    if not ok or (k == min(len(got), len(ref_text)) and len(got) != len(ref_text)):
      raise SystemExit(f"chip_smoke: [ring] {label}: its ids leave the in-process ring's at {k} (not a near-tie of the whole model), or end elsewhere:\n{got}\n{ref_text}")
  for ap in api_ports:
    if set(json.loads(_http(ap, "GET", "/v1/topology")[1])["nodes"]) != want:
      raise SystemExit(f"chip_smoke: [ring] GET /v1/topology on port {ap} does not list the three nodes")
  st, raw = _http(head, "POST", "/v1/chat/completions", ring_chat(False, RING_BIG_MODEL[0]))
  if st != 507 or json.loads(raw)["error"]["type"] != "insufficient_resources":
    raise SystemExit(f"chip_smoke: [ring] a request for {RING_BIG_MODEL[0]} on the ring answered {st}: {raw[:400]}")
  ttft, total = stream[2], stream[3]
  rate = (len(stream_ids) - 1) / max(total - ttft, 1e-9)
  log(f"[ring] daemons ({smi}): 3 requests in {served_s:.2f} s; positions equal to the in-process ring's ids, of the answer's tokens: {[(k, agree[k], len(v)) for k, v in answers.items()]}")
  log(f"[ring] launches in the daemons (GET /metrics deltas per node): {per_node}; totals {launches}")
  solo_line = f"TTFT {solo['ttft_s']:.4f} s, decode {solo['decode_tok_s']:.1f} tok/s" if solo else "not measured in this run"
  log(f"[ring] streaming on the head: TTFT {ttft:.4f} s, decode {rate:.1f} tok/s over {len(stream_ids)} tokens | the solo phase in this run: {solo_line}")
  log(f"[ring] a {RING_BIG_MODEL[0]} request (its config under XOT_TPU_HOME, no weights): HTTP {st} insufficient_resources: {json.loads(raw)['error']['message'][:200]}")
  t1 = time.perf_counter()
  for ap in api_ports:
    _http(ap, "POST", "/quit", timeout=30)
  rcs = [p.wait(timeout=QUIT_EXIT_S) for p in procs]
  quit_s = time.perf_counter() - t1
  if any(rcs):
    raise SystemExit(f"chip_smoke: [ring] the daemons exited {rcs} after POST /quit")
  return dict(up_s=up_s, warm_s=warm_s, served_s=served_s, answers=answers, agree=agree, launches=launches, per_node=per_node, ttft_s=ttft, decode_tok_s=rate, solo_ttft_s=solo and solo["ttft_s"], solo_decode_tok_s=solo and solo["decode_tok_s"], status_big=st, quit_s=quit_s)


# ------------------------------------------------ the batched layouts

# The dense layout and the batched draft-model proposer on the llama
# checkpoint, each pass 16 streaming greedy requests in two waves as the
# batched phase sends them: (name, draft loaded, environment). The dense
# passes set K2's minimum at the window, so K2 runs in every decode.batch
# replay (and in the draft's proposal steps).
DENSE_ENV = {"XOT_TPU_PAGED": "0", "XOT_TPU_FLASH_DECODE": "1", "XOT_TPU_FLASH_DECODE_MIN": str(CACHE)}
LAYOUT_PASSES = [("bf16_dense", False, DENSE_ENV), ("bf16_draft", True, {}), ("bf16_dense_draft", True, DENSE_ENV)]
LAYOUT_KNOBS = ("XOT_TPU_PAGED", "XOT_TPU_FLASH_DECODE", "XOT_TPU_FLASH_DECODE_MIN", "XOT_TPU_KV_QUANT", *PASS_KNOBS)
DENSE_FAMILIES = ("prefill.slots_sampled", "decode.batch", "spec.batch")


def phase_batched_layouts(torch, ckpt: Path, draft_dir: Path, paged_streams: list | None):
  """The batched daemon in the dense layout and with a draft model
  (``LAYOUT_PASSES``), the ``XOT_TPU_PAGED=auto`` verdict, each pass's
  greedy streams against the default paged pass's (reported)."""
  from xotorch_support_jetson_tpu_torch import main as tmain

  out = {}
  try:
    for draft in (False, True):
      args, port = _daemon_args(tmain, ckpt)  # unsets the serving knobs: the batched ones go after it
      os.environ.update(XOT_TPU_BATCHED="1", XOT_TPU_BATCH_SLOTS=str(BATCH_SLOTS), XOT_TPU_PAGE_SIZE=str(PAGE))
      if draft:
        os.environ.update(XOT_TPU_SPEC_DECODE="int8", XOT_TPU_SPEC_DRAFT=str(draft_dir), XOT_TPU_SPEC_AUTOCAL="0")
      out.update(asyncio.run(_serve_layouts(torch, tmain, args, port, [p for p in LAYOUT_PASSES if p[1] == draft], draft, paged_streams)))
      for knob in ("XOT_TPU_SPEC_DECODE", "XOT_TPU_SPEC_DRAFT", "XOT_TPU_SPEC_AUTOCAL"):
        os.environ.pop(knob, None)
  finally:
    for knob in ("XOT_TPU_BATCHED", "XOT_TPU_BATCH_SLOTS", "XOT_TPU_PAGE_SIZE", "XOT_TPU_SPEC_DECODE", "XOT_TPU_SPEC_DRAFT", "XOT_TPU_SPEC_AUTOCAL", *LAYOUT_KNOBS):
      os.environ.pop(knob, None)
    gc.collect()
    torch.cuda.empty_cache()
  return out


def _layout_graphs(progs, before_build: set, before: set, host: dict, launches: dict, snap: dict, fams) -> dict:
  """``_pass_graphs`` for any layout: per family in ``fams`` (and the
  draft's ``prefill.slots``) the ledger's captures, builds and replays
  over the pass, the graphs the measured round captured, and the kernels
  each graph captured since ``before_build`` (the build round's and the
  measured round's) records per replay. ``ok`` when every host launch of
  the measured round came from one of its new graphs' first runs and each
  family of ``fams`` captured one graph per build (``prefill.slots`` also
  counts the builds nested in ``prefill.slots_sampled``, which capture
  nothing of their own, as ``prefill.pages_many`` is nested in the paged
  prefill)."""
  new = [g for g in progs.graphs() if id(g) not in before]
  built = [g for g in progs.graphs() if id(g) not in before_build]
  first_runs = {k: sum(g.kernels.get(k, 0) for g in new) for k in host}
  per = {}
  for f in (*fams, "prefill.slots"):
    st = snap["families"].get(f, {})
    mine = [g for g in new if g.family == f]
    per[f] = dict(captures=st.get("captures", 0), compiles=st.get("compiles", 0), replays=st.get("replays", 0), dispatches=st.get("dispatches", 0), new_graphs=len(mine), kernels=[g.kernels for g in built if g.family == f])
  ok = host == first_runs and all(per[f]["captures"] == per[f]["compiles"] for f in fams)
  return dict(ok=ok, families=per, first_runs=first_runs, replayed={k: launches[k] - host[k] for k in host}, captures=len(new), capture_s=sum(g.capture_s for g in new))


async def _serve_layouts(torch, tmain, args, port, passes, draft: bool, paged_streams):
  from concurrent.futures import ThreadPoolExecutor

  from xotorch_support_jetson_tpu_torch.inference.paging import select_decode_path
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard
  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa, int4_matmul as k4, paged
  from xotorch_support_jetson_tpu_torch.utils import programs
  from xotorch_support_jetson_tpu_torch.utils.metrics import metrics, snapshot_delta

  node, api, engine, _ = tmain.build_components(args, tokenizer=ByteTokenizer())
  await node.start()
  server = await api.run(host="127.0.0.1", port=port)
  clients = ThreadPoolExecutor(max_workers=16)
  loop = asyncio.get_running_loop()
  out = {}
  try:
    await engine.ensure_shard(Shard("llama-3.2-1b", 0, 15, 16))
    L = engine.cfg.n_layers
    if draft and (engine._draft_params is None or engine._draft_cfg is None):
      raise SystemExit(f"chip_smoke: [layouts] the {DRAFT_LAYERS}-layer draft did not load (XOT_TPU_SPEC_DRAFT)")
    L_d = engine._draft_cfg.n_layers if draft else 0
    ids: dict[str, list[int]] = {}
    node.on_token.register("chip_smoke").on_next(lambda rid, toks, fin: ids.setdefault(rid, []).extend(toks))
    warm = {"model": "llama-3.2-1b", "messages": [{"role": "user", "content": "warm up"}], "stream": True, "temperature": 0, "max_tokens": 9}
    if not draft:
      # XOT_TPU_PAGED=auto: the server resolves its layout from the decode-path
      # table at pool build (a warm request builds it).
      engine._drop_batched_server()
      os.environ["XOT_TPU_PAGED"] = "auto"
      await loop.run_in_executor(clients, _post, port, warm)
      bs = engine.get_batched_server()
      verdict = select_decode_path(BATCH_SLOTS, bs.max_seq, bs.kv_quant or "", device=engine.device)
      out["auto"] = dict(table_verdict=verdict, paged=bs.paged, decode_path=bs.decode_path, slots=BATCH_SLOTS, window=bs.max_seq)
      log(f"[layouts] XOT_TPU_PAGED=auto: the H100 table answers {verdict!r} at B={BATCH_SLOTS}, window {bs.max_seq}, bf16 KV; the server built the {'paged' if bs.paged else 'dense'} layout, decode path {bs.decode_path!r}")
      if bs.paged != (verdict != "dense"):
        raise SystemExit(f"chip_smoke: [layouts] XOT_TPU_PAGED=auto built paged={bs.paged} against the verdict {verdict!r}")
    for name, _, env in passes:
      t_pass = time.perf_counter()
      engine._drop_batched_server()
      for knob in LAYOUT_KNOBS:
        os.environ.pop(knob, None)
      os.environ.update(env)
      programs.ledger.reset()
      await loop.run_in_executor(clients, _post, port, warm)
      bserver = engine.get_batched_server()
      dense = "XOT_TPU_PAGED" in env
      if bserver.paged == dense:
        raise SystemExit(f"chip_smoke: [layouts] {name}: the server built paged={bserver.paged}")
      progs = engine.batch_ops.programs
      # A build round first, on other text, as the measured paged passes
      # serve one (MEASURED_PASSES): the dispatch shapes are captured before
      # the measured round, whose rates are compared with theirs.
      graphs_build0 = {id(g) for g in progs.graphs()}
      build = await _build_round(loop, clients, port, ids, False, 1, bserver)
      graphs0 = {id(g) for g in progs.graphs()}
      snap0 = metrics.snapshot()
      prog0 = await asyncio.to_thread(_get_json, port, "/v1/programs")
      waves = (batched_bodies()[:8], batched_bodies()[8:])
      bodies = waves[0] + waves[1]
      arrivals: list[float] = []
      unhold = _hold_wave(bserver, len(waves[0]), arrivals)
      _reset_launches()  # ---- this pass's main path, counted
      t0 = time.perf_counter()
      before = set(ids)
      first = [loop.run_in_executor(clients, _post, port, b) for b in waves[0]]
      try:
        while sum(1 for rid, t in ids.items() if t and rid not in before) < BATCH_SLOTS:
          if time.perf_counter() - t0 > 120 or any(f.done() for f in first):
            failed = [repr(f.exception()) for f in first if f.done() and f.exception() is not None]
            raise SystemExit(f"chip_smoke: [layouts] {name}: the first wave's rows did not all stream (failed requests: {failed}; {len(arrivals)} of {len(first)} reached the scheduler)")
          await asyncio.sleep(0.005)
      finally:
        unhold()
      second = [loop.run_in_executor(clients, _post, port, b) for b in waves[1]]
      replies = await asyncio.gather(*first, *second)
      wall = time.perf_counter() - t0
      launches = {k: _launched(k) for k in ("flash_prefill", "flash_decode", "paged_decode", "int4_matmul")}  # ---- read just after
      host = {"flash_prefill": fa.LAUNCHES["flash_prefill"], "flash_decode": fa.LAUNCHES["flash_decode"], "paged_decode": paged.LAUNCHES["paged_decode"], "int4_matmul": k4.LAUNCHES["int4_matmul"]}
      snap1 = await asyncio.to_thread(_get_json, port, "/v1/programs")
      fams = DENSE_FAMILIES if dense else BATCHED_FAMILIES
      graphs = _layout_graphs(progs, graphs_build0, graphs0, host, launches, snap1, fams)
      dispatches = {f: snap1["families"].get(f, {}).get("dispatches", 0) - prog0["families"].get(f, {}).get("dispatches", 0) for f in sorted(snap1["families"])}
      dispatches = {f: n for f, n in dispatches.items() if n}
      delta = snapshot_delta(snap0, metrics.snapshot())
      gauges = {g: metrics.gauge_value(g) for g in ("kv_draft_bytes", "kv_draft_slots", "kv_draft_pages_equivalent")}
      spec = dict(
        proposers=list(bserver.spec_proposers), accepted=_by_label(delta, "spec_accepted_tokens_total", "proposer"), proposed=_by_label(delta, "spec_proposed_tokens_total", "proposer"),
        chunks_by_path=_by_label(delta, "decode_chunks_total", "path"), tokens_by_path=_by_label(delta, "decode_tokens_total", "path"),
      )
      streams, n_tok, ttfts = [], 0, []
      for (text, finish, ttft, total, n_events, rid), b in zip(replies, bodies):
        toks = ids.get(rid, [])
        if not toks or len(toks) > b["max_tokens"] or finish not in ("stop", "length") or (finish == "length" and len(toks) != b["max_tokens"]):
          raise SystemExit(f"chip_smoke: [layouts] {name}: request {rid} gave {len(toks)} of {b['max_tokens']} tokens, finish {finish}")
        streams.append(list(toks))
        n_tok += len(toks)
        ttfts.append(ttft)
      agree = None
      if paged_streams is not None:
        same = sum(sum(1 for x, y in zip(s, t) if x == y) for s, t in zip(streams, paged_streams))
        agree = same / max(sum(max(len(s), len(t)) for s, t in zip(streams, paged_streams)), 1)
      res = dict(
        env=env, draft=draft, paged=bserver.paged, decode_path=bserver.decode_path, requests=len(bodies), tokens=n_tok, wall_s=wall, aggregate_tok_s=n_tok / wall,
        ttft_p50_s=_pctl(ttfts, 0.5), ttft_p95_s=_pctl(ttfts, 0.95), launches=launches, dispatches=dispatches, spec=spec, kv_draft=gauges, graphs=graphs,
        agreement_with_paged_default=agree, pool_pages=None if bserver.allocator is None else bserver.allocator.n_pages, build=build,
      )
      # Gates: the pass's kernels and its path label, the proposers and the
      # draft's cache, every dispatch a replay or a new graph's first run.
      problems = []
      if dense:
        # K2 wherever a step runs on the slot cache (decode.batch, and the
        # draft's proposal steps); K1 in every admission and verify window.
        plain_steps = dispatches.get("decode.batch") or (draft and dispatches.get("spec.batch"))
        if launches["paged_decode"] or not launches["flash_prefill"] or bool(launches["flash_decode"]) != bool(plain_steps) or bserver.decode_path != "dense":
          problems.append(f"dense launches {launches} over dispatches {dispatches}, decode path {bserver.decode_path}")
        if dispatches.get("decode.batch") and not spec["chunks_by_path"].get("dense"):
          problems.append(f"decode chunks by path {spec['chunks_by_path']}: no dense chunk")
        for k in graphs["families"]["decode.batch"]["kernels"]:
          if k.get("flash_decode") != L * 8:
            problems.append(f"a decode.batch graph records {k} (K2 {L * 8} expected: once per layer per step)")
        rounds_k1 = {8 * L, 8 * (L + L_d)}  # a chunk with no model-drafted row runs no draft
        for k in graphs["families"]["spec.batch"]["kernels"]:
          if k.get("flash_prefill", 0) not in rounds_k1 or k.get("paged_decode"):
            problems.append(f"a spec.batch graph records {k} (K1 {sorted(rounds_k1)} expected: every verify window{' and catch-up' if draft else ''})")
      elif not launches["paged_decode"] or not launches["flash_prefill"]:
        problems.append(f"paged launches {launches}")
      if draft:
        if "model" not in spec["proposers"] or not spec["proposed"].get("model") or gauges["kv_draft_slots"] != BATCH_SLOTS or not gauges["kv_draft_bytes"] or not dispatches.get("prefill.slots"):
          problems.append(f"draft: proposers {spec['proposers']}, proposed {spec['proposed']}, gauges {gauges}, dispatches {dispatches}")
        if not dispatches.get("spec.batch" if dense else "spec.paged_batch"):
          problems.append(f"no spec dispatch ({dispatches})")
        for k in graphs["families"]["prefill.slots"]["kernels"]:
          if k.get("flash_prefill") != L_d:
            problems.append(f"a draft prefill graph records {k} (K1 {L_d} expected)")
      elif any(gauges.values()):
        problems.append(f"kv_draft gauges {gauges} without a draft")
      if bserver.busy() or (bserver.allocator is not None and bserver.allocator.audit()["referenced"]):
        problems.append("the server did not drain")
      if not graphs["ok"]:
        problems.append(f"a dispatch ran outside its graph, or captures and builds differ: {graphs}")
      if problems:
        raise SystemExit(f"chip_smoke: [layouts] {name}: " + "; ".join(problems))
      out[name] = res
      log(f"[batched] pass={name} ({'dense' if dense else 'paged'} layout{', draft model' if draft else ''}) {env}: {len(bodies)} streaming requests, {n_tok} tokens in {wall:.3f} s: aggregate {res['aggregate_tok_s']:.1f} tok/s | TTFT p50 {res['ttft_p50_s']:.4f} s p95 {res['ttft_p95_s']:.4f} s | launches {launches} | dispatches by program {dispatches} | proposers {spec['proposers']}: accepted {spec['accepted']} of proposed {spec['proposed']} | kv_draft gauges {gauges} | decode chunks by path {spec['chunks_by_path']} | greedy tokens agreeing with the paged default pass {agree if agree is None else round(agree, 3)} | captures {graphs['captures']} ({graphs['capture_s']:.3f} s; the build round before it: {build['captures']} captures, {build['capture_s']:.3f} s, {build['wall_s']:.3f} s wall) | {_smi()}")
      log(f"[time] layouts, pass {name}: {time.perf_counter() - t_pass:.1f} s")
    node.on_token.deregister("chip_smoke")
    engine._drop_batched_server()
    return out
  finally:
    await node.stop()
    await asyncio.to_thread(clients.shutdown, True)
    server.close()
    await server.wait_closed()
    engine.executor.shutdown(wait=True)


# ------------------------------------------------------------ hub fetch

HUB_REPO_MODEL = "llama-3.2-1b"  # the card the fetched daemon serves (its layers remapped onto the checkpoint's)


class _LoopbackHub:
  """A hub in the API's shape on 127.0.0.1, serving one repo from a
  directory: ``/api/models/{repo}/tree/main`` listings and
  ``/{repo}/resolve/main/{file}`` with Range. ``served`` counts bytes."""

  def __init__(self, repo: str, root: Path):
    import http.server

    hub = self
    self.repo, self.root, self.requests, self.served = repo, root, [], 0

    class Handler(http.server.BaseHTTPRequestHandler):
      def log_message(self, *a):
        pass

      def do_GET(self):  # noqa: N802
        hub.requests.append(self.path)
        tree, resolve = f"/api/models/{hub.repo}/tree/main", f"/{hub.repo}/resolve/main/"
        if self.path.startswith(tree):
          sub = self.path[len(tree):].strip("/")
          base = hub.root / sub
          entries = [{"type": "directory" if p.is_dir() else "file", "path": p.relative_to(hub.root).as_posix(), "size": 0 if p.is_dir() else p.stat().st_size} for p in sorted(base.iterdir())]
          body = json.dumps(entries).encode()
          self.send_response(200)
        elif self.path.startswith(resolve) and (hub.root / self.path[len(resolve):]).is_file():
          data = (hub.root / self.path[len(resolve):]).read_bytes()
          start = int(self.headers["Range"].split("=")[1].split("-")[0]) if self.headers.get("Range") else 0
          body = data[start:]
          self.send_response(206 if start else 200)
        else:
          body = b""
          self.send_response(404)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        hub.served += len(body)

    self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    self.httpd.daemon_threads = True
    self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
    self.thread.start()
    self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

  def close(self) -> None:
    self.httpd.shutdown()
    self.httpd.server_close()


def phase_fetch(torch, draft_dir: Path):
  """A daemon whose downloads home is empty serves a model it first fetches
  through the hub API from a loopback hub (``_LoopbackHub``: the
  ``DRAFT_LAYERS``-layer checkpoint at llama-3.2-1b's widths under the
  card's repo), and answers one chat request on the card. Gates: every
  file of the checkpoint fetched whole, the downloader's last progress
  event complete, tokens answered, K1 in the prefill."""
  from xotorch_support_jetson_tpu_torch import main as tmain, registry
  from xotorch_support_jetson_tpu_torch.utils.helpers import find_available_port

  home = ROOT / "build" / "fetch_home"
  shutil.rmtree(home, ignore_errors=True)
  repo = registry.get_repo(HUB_REPO_MODEL, "TorchShardedInferenceEngine")
  hub = _LoopbackHub(repo, draft_dir)
  saved = {k: os.environ.get(k) for k in ("XOT_TPU_HOME", "HF_ENDPOINT", "HF_HUB_OFFLINE", "XOT_TPU_MODEL_DIR")}
  os.environ.update(XOT_TPU_HOME=str(home), HF_ENDPOINT=hub.url)
  os.environ.pop("HF_HUB_OFFLINE", None)
  os.environ.pop("XOT_TPU_MODEL_DIR", None)
  try:
    port = find_available_port("127.0.0.1")
    args = tmain.build_parser().parse_args(["--discovery-module", "none", "--chatgpt-api-port", str(port), "--default-model", HUB_REPO_MODEL, "--max-generate-tokens", "16", "--node-id", "chip-smoke-fetch"])
    return asyncio.run(_serve_fetched(torch, tmain, args, port, hub, home, repo, draft_dir))
  finally:
    hub.close()
    for k, v in saved.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v
    shutil.rmtree(home, ignore_errors=True)


async def _serve_fetched(torch, tmain, args, port, hub, home: Path, repo: str, draft_dir: Path):
  from concurrent.futures import ThreadPoolExecutor

  from xotorch_support_jetson_tpu_torch.download.downloader import get_models_dir, repo_to_dirname

  node, api, engine, _ = tmain.build_components(args, tokenizer=ByteTokenizer())
  events = []
  node.shard_downloader.on_progress.register("chip_smoke").on_next(lambda shard, ev: events.append(ev.to_dict()))
  await node.start()
  server = await api.run(host="127.0.0.1", port=port)
  clients = ThreadPoolExecutor(max_workers=2)
  loop = asyncio.get_running_loop()
  ids: list[int] = []
  node.on_token.register("chip_smoke").on_next(lambda rid, toks, fin: ids.extend(toks))
  try:
    _reset_launches()  # ---- the fetch and the request, counted
    t0 = time.perf_counter()
    text, finish, ttft, total, n_events, rid = await loop.run_in_executor(clients, _post, port, {"model": HUB_REPO_MODEL, "messages": CHAT, "stream": True, "temperature": 0, "max_tokens": 16})
    wall = time.perf_counter() - t0
    launches = {k: _launched(k) for k in ("flash_prefill", "flash_decode", "paged_decode", "int4_matmul")}  # ---- read just after
    model_dir = get_models_dir() / repo_to_dirname(repo)
    want = sorted(p.relative_to(draft_dir).as_posix() for p in draft_dir.rglob("*") if p.is_file())
    got = sorted(p.relative_to(model_dir).as_posix() for p in model_dir.rglob("*") if p.is_file()) if model_dir.is_dir() else []
    whole = got == want and all((model_dir / n).read_bytes() == (draft_dir / n).read_bytes() for n in got)  # config.json and model.safetensors
    nbytes = sum((model_dir / n).stat().st_size for n in got)
    res = dict(
      repo=repo, files=got, bytes=nbytes, wall_s=wall, ttft_s=ttft, tokens=len(ids), finish=finish, events=len(events), last_event=events[-1]["status"] if events else None,
      hub_requests=len(hub.requests), hub_bytes=hub.served, launches=launches, home_is_empty_first=True,
    )
    log(f"[fetch] an empty XOT_TPU_HOME ({home.name}): the daemon fetched {repo} ({len(got)} files, {nbytes / 1e9:.3f} GB) through the hub API from a 127.0.0.1 hub ({len(hub.requests)} requests, {hub.served / 1e9:.3f} GB served; {len(events)} progress events, the last {res['last_event']!r}) and answered one chat request: {len(ids)} tokens, finish {finish}, TTFT {ttft:.3f} s (the fetch and the load included), {wall:.3f} s in all | launches {launches} | {_smi()}")
    if not got or not whole or not any(n.endswith(".safetensors") for n in got) or "config.json" not in got or res["last_event"] != "complete" or not ids or finish not in ("stop", "length") or not launches["flash_prefill"]:
      raise SystemExit(f"chip_smoke: [fetch] the fetched daemon: {res}")
    return res
  finally:
    await node.stop()
    await asyncio.to_thread(clients.shutdown, True)
    server.close()
    await server.wait_closed()
    engine.executor.shutdown(wait=True)


# ------------------------------------------------------------ 8e. multi-LoRA

LORA_COUNT, LORA_RANK, LORA_SLOTS = 10, 16, 8  # XOT_TPU_LORA_RANK / _SLOTS: slot 0 is the base, 7 adapters resident
LORA_NAMES = [f"lora{i}" for i in range(LORA_COUNT)]
LORA_WAVE1, LORA_WAVE2 = LORA_NAMES[:6], LORA_NAMES[6:]  # the second wave's four are not resident yet: swaps
# The adapter rows' hook path (bf16 weights and factors, K1) against a
# plain f32 forward on merged weights W + 2·A·B through 16 layers: the
# tolerance the gemma2, MoE and MLA phases hold their plain f32 forwards to.
LORA_TOL = 5e-2
# (name, environment, kernels the pass must launch): the paged default
# (K1 admissions, K3 decode and n-gram verify windows), the dense layout
# with K2 (K1 admissions), int4 base weights (K4 beside the delta).
LORA_PASSES = [("paged", {}, ("flash_prefill", "paged_decode")), ("dense", DENSE_ENV, ("flash_prefill", "flash_decode")), ("int4", {"XOT_TPU_QUANT": "int4"}, ("int4_matmul",))]
LORA_KNOBS = ("XOT_TPU_LORA", "XOT_TPU_LORA_DIR", "XOT_TPU_LORA_RANK", "XOT_TPU_LORA_SLOTS")


def write_lora_adapters(path: Path, seed: int = SEED + 20) -> dict:
  """``LORA_COUNT`` seeded adapters on wq and wv at llama-3.2-1b's widths,
  ranks 16 and 8 alternating, in the adapter npz format (f32): A ~ N(0,
  1/D), B ~ N(0, 0.25/r), so the delta 2·x·A·B is about as large as the
  base product (the checkpoint's weights are N(0, 1/D)) and an adapter
  row's greedy tokens leave the base row's. Returns name → arrays."""
  from xotorch_support_jetson_tpu_torch.inference.adapters import save_adapter

  c = LLAMA_3_2_1B
  L, D = c["num_hidden_layers"], c["hidden_size"]
  outs = {"wq": c["num_attention_heads"] * c["head_dim"], "wv": c["num_key_value_heads"] * c["head_dim"]}
  rng = np.random.default_rng(seed)
  adapters = {}
  for i, name in enumerate(LORA_NAMES):
    r = LORA_RANK if i % 2 == 0 else LORA_RANK // 2
    per = {t: (rng.normal(0, D**-0.5, (L, D, r)).astype(np.float32), rng.normal(0, 0.5 / r**0.5, (L, r, o)).astype(np.float32)) for t, o in outs.items()}
    adapters[name] = {"layers": per}
    save_adapter(path / name, adapters[name])
  return adapters


def _lora_plain_params(torch, engine):
  """The served params as a plain f32 model: every quantized leaf
  dequantized, the adapter stacks dropped."""
  from xotorch_support_jetson_tpu_torch.models.quantize import dequantize_leaf

  cfg = engine.cfg
  ins = {"wo": cfg.n_heads * cfg.head_dim, "w_down": cfg.hidden_dim, "lm_head": cfg.dim}

  def f32(group: dict) -> dict:
    out = {}
    for k, v in group.items():
      if k.endswith("_scale") or "_alora_" in k:
        continue
      out[k] = dequantize_leaf(v, group[f"{k}_scale"], ins.get(k, cfg.dim), torch.float32) if f"{k}_scale" in group else v.float()
    return out

  params = f32({k: v for k, v in engine.params.items() if not isinstance(v, dict)})
  params.update({k: f32(v) for k, v in engine.params.items() if isinstance(v, dict)})
  return params


def _last_logits(torch, cfg, shard, params, ids: list[int], adapter_slot=None):
  """Cache-less forward over ``ids`` (K1 where the environment allows):
  the last position's logits [V] in f32."""
  from xotorch_support_jetson_tpu_torch.models.decoder import shard_forward

  toks = torch.tensor([ids], dtype=torch.int32, device="cuda")
  pos = torch.arange(len(ids), dtype=torch.int32, device="cuda")[None]
  aid = None if adapter_slot is None else torch.tensor([adapter_slot], dtype=torch.int32, device="cuda")
  logits, _ = shard_forward(params, cfg, shard, toks, pos, None, adapter_ids=aid)
  return logits[0, -1].float()


def lora_logit_checks(torch, engine, adapters: dict, prompts: dict, firsts: dict | None = None) -> dict:
  """Per adapter, on its row's prompt: the served weights through the hook
  (bf16 or int4 base, K1) against the plain f32 forward on merged weights
  (relative L2 ≤ ``LORA_TOL``, ``XOT_TPU_NO_FLASH`` for the plain one),
  whether its greedy token leaves the base model's, and with ``firsts``
  (the served first tokens) each one's logit gap below the hook path's
  greedy token (0 where they agree)."""
  import dataclasses

  reg, cfg, shard = engine.adapter_registry, engine.cfg, engine._effective_shard
  cfg32 = dataclasses.replace(cfg, dtype=torch.float32, quant_compute="")
  out = {}
  base_plain = _lora_plain_params(torch, engine)
  for name, ids in prompts.items():
    slot = reg.acquire(name, holder="chip_smoke")
    pending = reg.pending_install(slot)  # acquired on the event loop: the write is queued on the engine's executor
    if pending is not None:
      pending.result()
    try:
      served = _last_logits(torch, cfg, shard, engine.params, ids, slot)
      base = _last_logits(torch, cfg, shard, engine.params, ids)
    finally:
      reg.unpin("chip_smoke")
    merged = dict(base_plain, layers=dict(base_plain["layers"]))
    for t, (a, b) in adapters[name]["layers"].items():
      merged["layers"][t] = base_plain["layers"][t] + 2.0 * torch.from_numpy(a).cuda() @ torch.from_numpy(b).cuda()
    os.environ["XOT_TPU_NO_FLASH"] = "1"
    try:
      plain = _last_logits(torch, cfg32, shard, merged, ids)
    finally:
      os.environ.pop("XOT_TPU_NO_FLASH", None)
    out[name] = dict(rel_err=_rel_err(served, plain), argmax_agree=int(served.argmax()) == int(plain.argmax()), moves_off_base=int(served.argmax()) != int(base.argmax()), first=int(served.argmax()))
    if firsts is not None:
      out[name]["first_gap"] = float(served.max() - served[firsts[name]])
  bad = {n: r for n, r in out.items() if not r["rel_err"] <= LORA_TOL}
  if bad or not any(r["moves_off_base"] for r in out.values()):
    raise SystemExit(f"chip_smoke: [lora] adapter logits against the merged plain f32 forward (tolerance {LORA_TOL}): {out}")
  del base_plain
  torch.cuda.empty_cache()
  return out


LORA_ANSWER = 32  # answer cap of the phase's batched waves (the batched phase's answers run 29 to 64 tokens)


def _lora_bodies(names: list, variant: int = 0) -> list:
  """``batched_bodies`` with each row's adapter named in its ``model``
  field (None: the base model), answers capped at ``LORA_ANSWER``."""
  bodies = batched_bodies(variant=variant)
  for b, name in zip(bodies, names):
    b["max_tokens"] = min(b["max_tokens"], LORA_ANSWER)
    if name:
      b["model"] = name
  return bodies


def _lora_wave_names(wave: list) -> list:
  """16 rows: per eight, the wave's adapters in turn and base rows after."""
  return [wave[i % 8 % len(wave)] if i % 8 < 6 else None for i in range(16)]


def _prompt_ids(body) -> list[int]:
  return ByteTokenizer().encode("".join(f"<|{m['role']}|>{m['content']}\n" for m in body["messages"]) + "<|assistant|>")


def phase_lora(torch, ckpt: Path, smi: str) -> dict:
  """Multi-LoRA serving on the llama-3.2-1b checkpoint: ``LORA_COUNT``
  adapters served from ``XOT_TPU_LORA_DIR``, solo (``XOT_TPU_LORA=0``
  first, for the base tokens), then batched (``LORA_PASSES``), then the
  hook's device time in a captured solo step and a captured B=8 chunk."""
  from xotorch_support_jetson_tpu_torch import main as tmain

  lora_dir = ROOT / "build" / "smoke_lora"
  shutil.rmtree(lora_dir, ignore_errors=True)
  t0 = time.perf_counter()
  adapters = write_lora_adapters(lora_dir)
  n_bytes = sum(f.stat().st_size for f in lora_dir.iterdir())
  log(f"[lora] wrote {LORA_COUNT} seeded adapters on wq/wv (ranks {LORA_RANK} and {LORA_RANK // 2}, f32 npz, {n_bytes / 1e6:.1f} MB) in {time.perf_counter() - t0:.1f} s")
  out: dict = {"adapters_bytes": n_bytes}
  env = dict(XOT_TPU_LORA_DIR=str(lora_dir), XOT_TPU_LORA_RANK=str(LORA_RANK), XOT_TPU_LORA_SLOTS=str(LORA_SLOTS))
  try:
    args, port = _daemon_args(tmain, ckpt)
    os.environ.update(env, XOT_TPU_LORA="0")
    out["off"] = asyncio.run(_lora_solo(torch, tmain, args, port, adapters, None, smi))
    args, port = _daemon_args(tmain, ckpt)
    os.environ.pop("XOT_TPU_LORA")
    out["solo"] = asyncio.run(_lora_solo(torch, tmain, args, port, adapters, out["off"], smi))
    out["passes"] = {}
    for weights in ("bf16", "int4"):
      args, port = _daemon_args(tmain, ckpt)  # unsets the serving knobs: the pass's go after it
      os.environ.update(env, XOT_TPU_BATCHED="1", XOT_TPU_BATCH_SLOTS=str(BATCH_SLOTS), XOT_TPU_PAGE_SIZE=str(PAGE))
      if weights == "int4":
        os.environ["XOT_TPU_QUANT"] = "int4"  # read when the engine is built
      passes = [p for p in LORA_PASSES if (p[0] == "int4") == (weights == "int4")]
      out["passes"].update(asyncio.run(_lora_batched(torch, tmain, args, port, adapters, passes, smi)))
  finally:
    for knob in (*LORA_KNOBS, "XOT_TPU_BATCHED", "XOT_TPU_BATCH_SLOTS", "XOT_TPU_PAGE_SIZE", "XOT_TPU_QUANT", *LAYOUT_KNOBS):
      os.environ.pop(knob, None)
    shutil.rmtree(lora_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
  launches = {k: out["solo"]["launches"].get(k, 0) + sum(p["launches"][k] for p in out["passes"].values()) for k in ("flash_prefill", "flash_decode", "paged_decode", "int4_matmul")}
  if not all(launches.values()):
    raise SystemExit(f"chip_smoke: [lora] a kernel never launched on the lora path: {launches}")
  out["launches"] = launches
  return out


async def _lora_solo(torch, tmain, args, port, adapters, off, smi) -> dict:
  """The solo daemon: with ``off`` None it runs with ``XOT_TPU_LORA=0``
  (no registry, ``/v1/adapters`` off, the base tokens); else the adapters
  are registered and listed, an adapter selected by the ``model`` field
  and one by ``x-adapter`` leave the base tokens, the base request's tokens
  equal the ``XOT_TPU_LORA=0`` daemon's, an unknown name answers 400
  ``unknown_adapter``, and each selected adapter's logits agree with the
  merged plain forward. Then the hook's share of a captured solo step."""
  node, server, engine, load_s = await _daemon_up(torch, tmain, args, port, "lora", "llama-3.2-1b", "bf16", lambda cfg: "")
  try:
    base_body = {"model": "llama-3.2-1b", "messages": CHAT, "stream": False, "temperature": 0, "max_tokens": 24}
    listed = await asyncio.to_thread(_get_json, port, "/v1/adapters")
    if off is None:
      if engine.adapter_registry is not None or listed.get("enabled") is not False:
        raise SystemExit(f"chip_smoke: [lora] XOT_TPU_LORA=0 built a registry ({listed})")
      run = await _serve_requests(torch, node, engine, port, [("base", base_body)])
      return dict(load_s=load_s, base_tokens=run[0]["tokens"], adapters_listed=listed)
    reg = engine.adapter_registry
    if reg is None or reg.names() != LORA_NAMES or sorted(listed.get("adapters", {})) != sorted(LORA_NAMES) or reg.rank != LORA_RANK or reg.capacity != LORA_SLOTS:
      raise SystemExit(f"chip_smoke: [lora] the registry or GET /v1/adapters does not hold the {LORA_COUNT} adapters at rank {LORA_RANK}, {LORA_SLOTS} slots: {listed}")
    stacked = sum(v.numel() * v.element_size() for k, v in engine.params["layers"].items() if "_alora_" in k)
    await _serve_requests(torch, node, engine, port, [("warm", dict(base_body, max_tokens=4))])
    _reset_launches()  # ---- the solo adapter path, counted
    run = await _serve_requests(torch, node, engine, port, [
      ("base", base_body), ("model field", dict(base_body, model="lora3")), ("x-adapter", base_body, {"x-adapter": "lora4"}),
    ])
    launches = {k: _launched(k) for k in ("flash_prefill", "flash_decode", "paged_decode", "int4_matmul")}  # ---- read just after
    base, by_model, by_header = (r["tokens"] for r in run)
    try:
      await asyncio.to_thread(_post, port, dict(base_body, max_tokens=4), {"x-adapter": "nope"})
      unknown = "answered"
    except RuntimeError as e:
      unknown = str(e)
    problems = []
    if base != off["base_tokens"]:
      problems.append(f"the base request's tokens {base} differ from the XOT_TPU_LORA=0 daemon's {off['base_tokens']}")
    if by_model == base or by_header == base:
      problems.append("an adapter request gave the base tokens")
    if "HTTP 400" not in unknown or "unknown_adapter" not in unknown:
      problems.append(f"an unknown adapter: {unknown}")
    if reg.pinned_holders():
      problems.append(f"pins left: {reg.pinned_holders()}")
    if problems:
      raise SystemExit("chip_smoke: [lora] solo: " + "; ".join(problems))
    ids = _prompt_ids(base_body)
    checks = lora_logit_checks(torch, engine, adapters, {"lora3": ids, "lora4": ids})
    profile = profile_lora_solo(torch, engine)
    res = dict(load_s=load_s, stacked_bytes=stacked, launches=launches, tokens={"base": base, "lora3": by_model, "lora4": by_header}, logits=checks, unknown=unknown[:160], profile=profile)
    log(f"[lora] solo: registry of {LORA_COUNT} adapters (rank {LORA_RANK}, {LORA_SLOTS} slots, stacked leaves {stacked / 1e6:.1f} MB on the card); base tokens == the XOT_TPU_LORA=0 daemon's; 'model': 'lora3' and x-adapter: lora4 leave them; unknown name → 400 unknown_adapter | logits vs merged plain f32 (tol {LORA_TOL}): " + ", ".join(f"{n} {c['rel_err']:.4f}" for n, c in checks.items()) + f" | launches {launches} | captured step at position {LORA_PROFILE_POS}: hook off {profile['off_ms']:.4f} ms, on {profile['on_ms']:.4f} ms (delta {profile['delta_ms']:.4f} ms, {100 * profile['share']:.1f}% of the step) | {smi}")
    return res
  finally:
    await _daemon_down(node, server, engine)


LORA_PROFILE_POS = 512


def _off_on(times: list) -> dict:
  """Timings taken off, on, on, off: the means, the hook's delta and its
  share of the step with the hook on."""
  off, on = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
  return dict(off_ms=off, on_ms=on, delta_ms=on - off, share=(on - off) / on, runs_ms=times)


def profile_lora_solo(torch, engine) -> dict:
  """Device ms of one captured solo decode step at ``LORA_PROFILE_POS``
  (the plain attention) with the hook off and on (slot 1), in turns (off,
  on, on, off): the delta's device time is their difference, its share
  that over the step."""
  from xotorch_support_jetson_tpu_torch.models.decoder import init_kv_cache, shard_forward

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  cache = init_kv_cache(cfg, cfg.n_layers, 1, CACHE, device="cuda")
  tok = torch.ones((1, 1), dtype=torch.int32, device="cuda")
  pos = torch.full((1, 1), LORA_PROFILE_POS, dtype=torch.int32, device="cuda")
  aid = torch.ones((1,), dtype=torch.int32, device="cuda")
  step = {False: lambda: shard_forward(params, cfg, shard, tok, pos, cache), True: lambda: shard_forward(params, cfg, shard, tok, pos, cache, adapter_ids=aid)}
  return _off_on([_captured_ms(torch, step[hook]) for hook in (False, True, True, False)])


def profile_lora_chunk(torch, engine) -> dict:
  """Device ms per step of the served B=8 ``decode.paged_batch`` chunk (a
  ``BatchedPrograms`` replay: 8 steps, K3, rows at position 512) with the
  hook off and on (slots 1..7 and a base row), in turns; and the bytes the
  gathers read per layer."""
  from xotorch_support_jetson_tpu_torch.models.decoder import BatchedPrograms
  from xotorch_support_jetson_tpu_torch.ops.paged import init_paged_pool

  cfg, shard, params = engine.cfg, engine._effective_shard, engine.params
  B, mp, steps = BATCH_SLOTS, 16, 8
  progs = BatchedPrograms(params, cfg, shard, init_paged_pool(cfg, cfg.n_layers, B * mp + 1, PAGE, device="cuda"))
  bt = (1 + np.arange(B * mp, dtype=np.int32)).reshape(B, mp)
  rows = (np.ones((B, 1), np.int32), bt, np.full((B,), LORA_PROFILE_POS, np.int32), np.ones(B, bool), np.zeros(B, np.float32), np.ones(B, np.int32))
  aid = np.array([1, 2, 3, 4, 5, 6, 7, 0], np.int32)
  try:
    times = [_replay_ms(torch, lambda ids=ids: progs.decode(*rows, steps, 64, PAGE, 0, adapter_ids=ids), steps, reps=20)[1] for ids in (None, aid, aid, None)]
  finally:
    progs.close()
  lay = params["layers"]
  gather_bytes = sum(B * lay[k].shape[2] * lay[k].shape[3] * lay[k].element_size() for k in lay if "_alora_" in k)  # per layer
  return dict(_off_on(times), gather_bytes_per_layer=gather_bytes)


async def _lora_batched(torch, tmain, args, port, adapters, passes, smi) -> dict:
  """One batched daemon, one pass per ``passes`` entry (the server rebuilt
  between): a 16-request wave naming ``LORA_WAVE1``'s six adapters beside
  base rows, then one naming ``LORA_WAVE2``'s four, not resident, so the
  registry swaps them in (no 429). On the paged pass a base-only wave
  comes first, and after the adapter waves the first adapter wave and the
  base-only wave are served again, their rates compared: the first
  rounds capture their dispatch shapes (an adapter row's prompt hits no
  base page, so adapter waves capture prefill shapes of their own), the
  repeated ones run on captured graphs. Each adapter row's first token
  checks against its logits on the served weights, those against the
  merged plain forward; no pin is left; the pass's kernels launch."""
  from concurrent.futures import ThreadPoolExecutor

  from xotorch_support_jetson_tpu_torch.utils.metrics import metrics, snapshot_delta

  weights = "int4" if os.getenv("XOT_TPU_QUANT") == "int4" else "bf16"
  node, server, engine, load_s = await _daemon_up(torch, tmain, args, port, "lora", "llama-3.2-1b", weights, lambda cfg: "")
  clients = ThreadPoolExecutor(max_workers=16)
  loop = asyncio.get_running_loop()
  res = {}
  try:
    reg = engine.adapter_registry
    if reg is None:
      raise SystemExit("chip_smoke: [lora] the batched daemon built no registry")
    ids: dict[str, list[int]] = {}
    node.on_token.register("chip_smoke").on_next(lambda rid, toks, fin: ids.setdefault(rid, []).extend(toks))
    for name, env, kernels in passes:
      t_pass = time.perf_counter()
      engine._drop_batched_server()
      for knob in LAYOUT_KNOBS:
        os.environ.pop(knob, None)
      os.environ.update(env)
      await loop.run_in_executor(clients, _post, port, {"model": "llama-3.2-1b", "messages": CHAT, "stream": True, "temperature": 0, "max_tokens": 9})
      bserver = engine.get_batched_server()
      if not bserver._lora_active() or bserver.paged == (name == "dense"):
        raise SystemExit(f"chip_smoke: [lora] {name}: the server is not adapter-aware, or built paged={bserver.paged}")

      async def wave(bodies):
        t0 = time.perf_counter()
        replies = await asyncio.gather(*(loop.run_in_executor(clients, _post, port, b) for b in bodies))
        wall = time.perf_counter() - t0
        streams = []
        for (_, finish, _, _, _, rid), b in zip(replies, bodies):
          toks = ids.get(rid, [])
          if not toks or len(toks) > b["max_tokens"] or finish not in ("stop", "length"):
            raise SystemExit(f"chip_smoke: [lora] {name}: request {rid} ({b['model']}) gave {len(toks)} tokens, finish {finish}")
          streams.append(toks)
        return streams, sum(map(len, streams)) / wall, wall

      base_rate = None
      if name == "paged":
        await wave(_lora_bodies([None] * 16, variant=1))
      names1, names2 = _lora_wave_names(LORA_WAVE1), _lora_wave_names(LORA_WAVE2)
      bodies1, bodies2 = _lora_bodies(names1), _lora_bodies(names2, variant=2)
      snap0 = metrics.snapshot()
      prog0 = await asyncio.to_thread(_get_json, port, "/v1/programs")
      _reset_launches()  # ---- this pass's adapter waves, counted
      s1, rate1, wall1 = await wave(bodies1)
      s2, rate2, wall2 = await wave(bodies2)
      launches = {k: _launched(k) for k in ("flash_prefill", "flash_decode", "paged_decode", "int4_matmul")}  # ---- read just after
      prog1 = await asyncio.to_thread(_get_json, port, "/v1/programs")
      delta = snapshot_delta(snap0, metrics.snapshot())
      lora_rate = repeat = None
      if name == "paged":
        # Per repeated wave: its rate, graph captures, prefix pages hit and
        # dispatches by family (what sets the two rates apart).
        repeat = {}
        for label, bodies in (("lora", bodies1), ("base", _lora_bodies([None] * 16, variant=1))):
          p0, hits0 = await asyncio.to_thread(_get_json, port, "/v1/programs"), bserver.prefix_hit_pages
          _, rate, _ = await wave(bodies)
          p1 = await asyncio.to_thread(_get_json, port, "/v1/programs")
          repeat[label] = dict(
            tok_s=rate, prefix_pages=bserver.prefix_hit_pages - hits0, captures=sum(f.get("captures", 0) for f in p1["families"].values()) - sum(f.get("captures", 0) for f in p0["families"].values()),
            dispatches={f: v["dispatches"] - p0["families"].get(f, {}).get("dispatches", 0) for f, v in p1["families"].items() if v["dispatches"] - p0["families"].get(f, {}).get("dispatches", 0)},
          )
        lora_rate, base_rate = repeat["lora"]["tok_s"], repeat["base"]["tok_s"]
      dispatches = {f: prog1["families"][f]["dispatches"] - prog0["families"].get(f, {}).get("dispatches", 0) for f in prog1["families"]}
      dispatches = {f: n for f, n in dispatches.items() if n}
      swaps = _by_label(delta, "lora_swaps_total", "direction")
      swap_h = delta["histograms"].get("lora_swap_seconds", {})
      prompts = {}
      firsts = {}
      for nm, b, s in [*zip(names1, bodies1, s1), *zip(names2, bodies2, s2)]:
        if nm and nm not in prompts:
          prompts[nm], firsts[nm] = _prompt_ids(b), s[0]
      checks = lora_logit_checks(torch, engine, adapters, prompts, firsts)
      problems = []
      if not all(launches[k] for k in kernels):
        problems.append(f"launches {launches}: {kernels} expected")
      if name == "paged" and not dispatches.get("spec.paged_batch"):
        problems.append(f"no n-gram spec dispatch with adapter rows ({dispatches})")
      if not swaps.get("in") or not swaps.get("out"):
        problems.append(f"the second wave swapped nothing in or out: {swaps}")
      if reg.pinned_holders() or bserver.busy():
        problems.append(f"pins left {reg.pinned_holders()}, or the server did not drain")
      # A served first token may leave the hook path's greedy token only at
      # a near-tie (the ring phase's SCORE_GAP_TOL): the batched prefill's
      # padded, paged forward and the cache-less one round apart (K4 also
      # runs other tilings at their token counts on int4 weights).
      disagree = {n: (firsts[n], c["first"], round(c["first_gap"], 4)) for n, c in checks.items() if firsts[n] != c["first"]}
      if any(gap > SCORE_GAP_TOL for _, _, gap in disagree.values()):
        problems.append(f"first tokens against the hook path's greedy tokens (served, hook path, logit gap; limit {SCORE_GAP_TOL}): {disagree}")
      if problems:
        raise SystemExit(f"chip_smoke: [lora] {name}: " + "; ".join(problems))
      n_tok = sum(map(len, s1 + s2))
      res[name] = dict(
        env=env, weights=weights, paged=bserver.paged, launches=launches, dispatches=dispatches, swaps=swaps, swap_seconds=swap_h,
        tokens=n_tok, aggregate_tok_s=n_tok / (wall1 + wall2), wave1_tok_s=rate1, wave2_tok_s=rate2, repeated_lora_tok_s=lora_rate, repeated_base_only_tok_s=base_rate,
        captures=sum(f.get("captures", 0) for f in prog1["families"].values()) - sum(f.get("captures", 0) for f in prog0["families"].values()), repeated=repeat,
        logits=checks, first_token_disagreements=disagree, pool_pages=None if bserver.allocator is None else bserver.allocator.n_pages,
      )
      if name == "paged":
        res[name]["profile_chunk"] = profile_lora_chunk(torch, engine)
      swap_ms = 1e3 * swap_h.get("sum", 0.0) / max(sum(swap_h.get("counts", [])), 1)
      pc = res[name].get("profile_chunk")
      log(f"[lora] pass={name} ({weights} weights, {'paged' if bserver.paged else 'dense'}) {env}: 2 × 16 streaming requests (6 adapters + base rows, then 4 cold adapters), {n_tok} tokens: aggregate {res[name]['aggregate_tok_s']:.1f} tok/s (waves {rate1:.1f} / {rate2:.1f})" + f", {res[name]['captures']} captures" + (f"; served again (rate, captures, prefix pages hit, dispatches): the first adapter wave {repeat['lora']}, the base-only wave {repeat['base']}" if repeat else "") + f" | swaps {swaps}, lora_swap_seconds mean {swap_ms:.2f} ms | logits vs merged plain f32 max rel {max(c['rel_err'] for c in checks.values()):.4f} (tol {LORA_TOL}), first tokens off the hook path {disagree} | launches {launches} | dispatches {dispatches}" + (f" | captured B=8 chunk per step: hook off {pc['off_ms']:.4f} ms, on {pc['on_ms']:.4f} ms (delta {pc['delta_ms']:.4f} ms, {100 * pc['share']:.1f}%; gathers {pc['gather_bytes_per_layer'] / 1e6:.2f} MB a layer)" if pc else "") + f" | {smi}")
      log(f"[time] lora, pass {name}: {time.perf_counter() - t_pass:.1f} s")
    node.on_token.deregister("chip_smoke")
    engine._drop_batched_server()
    return res
  finally:
    await asyncio.to_thread(clients.shutdown, True)
    await _daemon_down(node, server, engine)


# ------------------------------------------------------------ 10. llava
# llava-hf/llava-1.5-7b-hf's published config.json: a CLIP ViT-L/14 tower
# at 336 px (24 layers; the features enter the last, so 23 run; 576
# patches), a 1024 → 4096 → 4096 projector, and a llama-2-7b decoder
# (hidden 4096, 32 / 32 heads of 128, FFN 11008, vocab 32064 holding the
# image placeholder 32000, rope θ 1e4).
LLAVA_15 = {
  "architectures": ["LlavaForConditionalGeneration"], "model_type": "llava", "image_token_index": 32000, "pad_token_id": 32001,
  "projector_hidden_act": "gelu", "vision_feature_layer": -2, "vision_feature_select_strategy": "default", "tie_word_embeddings": False,
  "text_config": {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "hidden_size": 4096, "intermediate_size": 11008, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 32, "vocab_size": 32064, "max_position_embeddings": 4096, "rms_norm_eps": 1e-05,
    "rope_theta": 10000.0, "torch_dtype": "float16", "bos_token_id": 1, "eos_token_id": 2, "tie_word_embeddings": False,
  },
  "vision_config": {
    "model_type": "clip_vision_model", "hidden_size": 1024, "intermediate_size": 4096, "num_hidden_layers": 24, "num_attention_heads": 16,
    "image_size": 336, "patch_size": 14, "projection_dim": 768, "layer_norm_eps": 1e-05,
  },
}
# llava-hf/llava-v1.6-vicuna-7b-hf: the same tower and decoder widths, any-res
# over five pinpoints with a learned image newline (scripts/llava_phase.py).
LLAVA_16_VICUNA = dict(
  LLAVA_15, architectures=["LlavaNextForConditionalGeneration"], model_type="llava_next", use_image_newline_parameter=True,
  image_grid_pinpoints=[[336, 672], [672, 336], [672, 672], [1008, 336], [336, 1008]],
)
LLAVA_MODEL = "llava-1.5-7b-hf"
LLAVA_NEXT_MODEL = "llava-1.6-vicuna-7b"
LLAVA_LAYERS = 8  # of the decoder's 32 (the run's time limit); the tower runs at full depth
LLAVA_ANSWER = 32
LLAVA_CHECK_TOL = 5e-2  # relative L2: the tower's features and the served prefill logits against plain f32 (PERF.md §2)
LLAVA_IMAGE_ID = 32000
CLIP_MEAN, CLIP_STD = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)
# K4 at llava-1.5-7b's decoder products (the int4 pass), solo decode (T = 1).
LLAVA_MATMULS = {"wq/wk/wv/wo": (4096, 4096), "w_gate/w_up": (4096, 11008), "w_down": (11008, 4096), "lm_head": (4096, 32064)}


class LlavaByteProcessor(ByteTokenizer):
  """Script glue for the random llava checkpoints: the byte tokenizer with
  llama-2's BOS / EOS ids (1 / 2, inside the 32,064-token vocabulary), and,
  called as a processor, what HF's llava-1.5 processor does with a prompt
  and its Pillow images: each image resized to 336×336 (bicubic) and
  normalized with CLIP's mean and std, each ``<image>`` expanded into the
  image's 576 placeholder ids."""

  bos_token_id = 1
  eos_token_id = 2

  def ids(self, text: str, n_features: int = 576) -> list[int]:
    parts = text.split("<image>")
    out = [self.bos_token_id]
    for i, part in enumerate(parts):
      out += list(part.encode("utf-8"))
      if i < len(parts) - 1:
        out += [LLAVA_IMAGE_ID] * n_features
    return out

  def __call__(self, text: str, images, return_tensors: str = "np") -> dict:
    from PIL import Image

    mean, std = np.asarray(CLIP_MEAN, np.float32), np.asarray(CLIP_STD, np.float32)
    px = [((np.asarray(im.convert("RGB").resize((336, 336), Image.BICUBIC), np.float32) / 255.0 - mean) / std).transpose(2, 0, 1) for im in images]
    return {"input_ids": np.asarray([self.ids(text)], np.int32), "pixel_values": np.stack(px).astype(np.float32)}


def llava_shapes(config: dict, layers: int) -> dict:
  """HF tensor name → shape of a llava checkpoint (the published key names:
  the decoder under ``language_model.``, the tower, the projector, and
  llava-next's ``image_newline``) at ``layers`` of its decoder's depth."""
  t, v = config["text_config"], config["vision_config"]
  D, F, V = t["hidden_size"], t["intermediate_size"], t["vocab_size"]
  Dv, Fv, P = v["hidden_size"], v["intermediate_size"], v["patch_size"]
  shapes = {"language_model.model.embed_tokens.weight": (V, D), "language_model.model.norm.weight": (D,), "language_model.lm_head.weight": (V, D)}
  for i in range(layers):
    p = f"language_model.model.layers.{i}."
    shapes.update({
      p + "input_layernorm.weight": (D,), p + "post_attention_layernorm.weight": (D,),
      **{p + f"self_attn.{n}_proj.weight": (D, D) for n in "qkvo"},
      p + "mlp.gate_proj.weight": (F, D), p + "mlp.up_proj.weight": (F, D), p + "mlp.down_proj.weight": (D, F),
    })
  vp = "vision_tower.vision_model."
  shapes.update({
    vp + "embeddings.class_embedding": (Dv,), vp + "embeddings.patch_embedding.weight": (Dv, 3, P, P),
    vp + "embeddings.position_embedding.weight": ((v["image_size"] // P) ** 2 + 1, Dv),
    vp + "pre_layrnorm.weight": (Dv,), vp + "pre_layrnorm.bias": (Dv,), vp + "post_layernorm.weight": (Dv,), vp + "post_layernorm.bias": (Dv,),
  })
  for j in range(v["num_hidden_layers"]):
    p = f"{vp}encoder.layers.{j}."
    for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
      shapes.update({f"{p}self_attn.{n}.weight": (Dv, Dv), f"{p}self_attn.{n}.bias": (Dv,)})
    shapes.update({
      p + "layer_norm1.weight": (Dv,), p + "layer_norm1.bias": (Dv,), p + "layer_norm2.weight": (Dv,), p + "layer_norm2.bias": (Dv,),
      p + "mlp.fc1.weight": (Fv, Dv), p + "mlp.fc1.bias": (Fv,), p + "mlp.fc2.weight": (Dv, Fv), p + "mlp.fc2.bias": (Dv,),
    })
  shapes.update({
    "multi_modal_projector.linear_1.weight": (D, Dv), "multi_modal_projector.linear_1.bias": (D,),
    "multi_modal_projector.linear_2.weight": (D, D), "multi_modal_projector.linear_2.bias": (D,),
  })
  if config.get("image_grid_pinpoints"):
    shapes["image_newline"] = (D,)
  return shapes


def write_llava_checkpoint(torch, path: Path, layers: int = LLAVA_LAYERS, config: dict = LLAVA_15, seed: int = SEED + 21) -> float:
  """Seeded random bf16 weights at a llava checkpoint's published shapes
  (``_write_seeded_checkpoint``: N(0, 1/fan_in) projections, convolution
  and head, N(0, 0.02) embeddings, unit norm gains, zero biases),
  ``layers`` of its decoder's depth and its whole tower."""
  cfg = dict(config, text_config=dict(config["text_config"], num_hidden_layers=layers))
  return _write_seeded_checkpoint(torch, path, cfg, llava_shapes(config, layers), seed)


def _llava_cfg_problem(cfg) -> str:
  v = cfg.vision
  ok = (
    v is not None and (v.hidden_size, v.intermediate_size, v.n_layers, v.n_run, v.n_heads, v.image_size, v.patch_size, v.n_patches, v.projector_dim) == (1024, 4096, 24, 23, 16, 336, 14, 576, 4096)
    and v.drop_cls and cfg.image_token_id == LLAVA_IMAGE_ID and (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.hidden_dim, cfg.vocab_size) == (4096, 32, 32, 128, 11008, 32064)
    and cfg.rope_theta == 10000.0 and not cfg.tied_embedding and cfg.family == "llama"
  )
  return "" if ok else "not llava-1.5-7b's"


def _llava_png(seed: int = SEED + 21) -> str | None:
  """A seeded 512×384 RGB noise image as base64 PNG, or None without Pillow."""
  try:
    from PIL import Image
  except ImportError:
    return None
  import base64
  import io

  arr = np.random.default_rng(seed).integers(0, 256, (384, 512, 3), dtype=np.uint8)
  buf = io.BytesIO()
  Image.fromarray(arr).save(buf, format="PNG")
  return base64.b64encode(buf.getvalue()).decode()


def _llava_chat(stream: bool, png: str | None, max_tokens: int = LLAVA_ANSWER, text: str = "Describe the picture in one line.", model: str = LLAVA_MODEL) -> dict:
  content = text if png is None else [{"type": "text", "text": text}, {"type": "image_url", "image_url": {"url": f"data:image/png;base64,{png}"}}]
  return {"model": model, "messages": [{"role": "user", "content": content}], "stream": stream, "temperature": 0, "max_tokens": max_tokens}


def _pil_and_transformers() -> str:
  """What ``python3 -c "import PIL, transformers; print(...)"`` prints here."""
  r = subprocess.run([sys.executable, "-c", "import PIL, transformers; print(PIL.__version__, transformers.__version__)"], capture_output=True, text=True, timeout=300)
  return r.stdout.strip() if r.returncode == 0 else (r.stderr.strip().splitlines() or ["import failed"])[-1]


def phase_llava(torch, ckpt: Path, smi: str, layers: int = LLAVA_LAYERS) -> dict:
  """llava-1.5-7b at full width (the checkpoint's depth of its decoder, the
  whole tower) through the daemon with ``XOT_TPU_FLASH_DECODE=1`` (K2 from
  position 0 of the 4096-slot cache): image, text and batched requests
  (``_llava_serve``), then the same solo requests with
  ``XOT_TPU_QUANT=int4``."""
  from concurrent.futures import ThreadPoolExecutor

  from xotorch_support_jetson_tpu_torch import main as tmain

  out = {}
  with ThreadPoolExecutor(1) as probe:  # a separate interpreter's imports, beside the serving
    versions = probe.submit(_pil_and_transformers)
    for name, quant in (("bf16", None), ("int4", "int4")):
      args, port = _daemon_args(tmain, ckpt, model=LLAVA_MODEL)
      os.environ.update(XOT_TPU_FLASH_DECODE="1", XOT_TPU_FLASH_DECODE_MIN=str(CACHE), **({"XOT_TPU_QUANT": quant} if quant else {}))
      try:
        out[name] = asyncio.run(_llava_serve(torch, tmain, args, port, smi, layers, quant))
      finally:
        for knob in ("XOT_TPU_FLASH_DECODE", "XOT_TPU_FLASH_DECODE_MIN", "XOT_TPU_QUANT"):
          os.environ.pop(knob, None)
        gc.collect()
        torch.cuda.empty_cache()
    out["pil_transformers"] = versions.result()
  log(f"[llava] python3 -c \"import PIL, transformers; print(PIL.__version__, transformers.__version__)\": {out['pil_transformers']}")
  return out


def phase_llava_next(torch, ckpt: Path, smi: str, layers: int) -> dict:
  """llava-1.6-vicuna-7b (``LLAVA_16_VICUNA``, the checkpoint's depth): one
  any-res request through the daemon's engine (``_llava_next``)."""
  from xotorch_support_jetson_tpu_torch import main as tmain

  args, port = _daemon_args(tmain, ckpt, model=LLAVA_NEXT_MODEL)
  os.environ.update(XOT_TPU_FLASH_DECODE="1", XOT_TPU_FLASH_DECODE_MIN=str(CACHE))
  try:
    return asyncio.run(_llava_next(torch, tmain, args, port, smi, layers))
  finally:
    for knob in ("XOT_TPU_FLASH_DECODE", "XOT_TPU_FLASH_DECODE_MIN"):
      os.environ.pop(knob, None)
    gc.collect()
    torch.cuda.empty_cache()


def _spy_multimodal(engine, seen: list):
  """Record the device half's inputs (ids, pixels, sizes) of each image request."""
  orig = engine._infer_multimodal_sync

  def spy(request_id, tokens, pixel_values, image_sizes, state):
    seen.append((tokens, pixel_values, image_sizes))
    return orig(request_id, tokens, pixel_values, image_sizes, state)

  engine._infer_multimodal_sync = spy
  return lambda: setattr(engine, "_infer_multimodal_sync", orig)


async def _llava_image(torch, node, engine, port, png, label: str, seen: list) -> dict:
  """One greedy streaming image request: over HTTP with the PNG, or, without
  Pillow on this machine, through the engine's device half with seeded
  pixels and the ids a processor would give (after the HTTP request is
  refused with a 400 naming Pillow). Returns ``_serve_requests``' record."""
  if png is not None:
    return (await _serve_requests(torch, node, engine, port, [(label, _llava_chat(True, png))]))[0]
  st, raw = await asyncio.to_thread(_http, port, "POST", "/v1/chat/completions", _llava_chat(True, "iVBORw0KGgo="))
  if st != 400 or "Pillow" not in raw:
    raise SystemExit(f"chip_smoke: [llava] without Pillow an image request must answer a 400 naming it; got {st} {raw[:300]!r}")
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard

  tok = LlavaByteProcessor()
  ids = np.asarray([tok.ids(tok.apply_chat_template([{"role": "user", "content": "Describe the picture in one line. <image>"}]))], np.int32)
  px = torch.randn((1, 3, 336, 336), generator=torch.Generator().manual_seed(SEED + 21)).numpy()
  shard = Shard(LLAVA_MODEL, 0, 31, 32)
  t0 = time.perf_counter()
  logits, _ = await engine.infer_image_tokens(label, shard, ids, px)
  ttft = time.perf_counter() - t0
  toks = [int(np.argmax(logits[0]))] + await engine.generate_oneshot(label, shard, int(np.argmax(logits[0])), LLAVA_ANSWER - 1, eos_ids=(tok.eos_token_id,), temp=0.0)
  engine.end_request(label)
  return dict(label=label, stream=False, temperature=0.0, tokens=toks, text=tok.decode(toks), finish_reason=None, ttft_s=ttft, total_s=time.perf_counter() - t0)


def llava_plain_tokens(torch, engine, tokens, pixel_values, image_sizes, n: int) -> list[int]:
  """Greedy ids of an uncaptured forward of the same merged embeddings on
  the served weights: the tower eagerly, the merge, the prefill of the
  padded prompt and ``n - 1`` single-token steps, each op by op (no
  program, no graph) on a fresh cache of the session's size, through the
  kernels the served path takes."""
  from xotorch_support_jetson_tpu_torch.models import decoder as dec, vision

  cfg, params, shard = engine.cfg, engine.params, engine._effective_shard
  S = tokens.shape[1]
  pad = -(-S // 128) * 128
  tok = torch.zeros((1, pad), dtype=torch.int32, device="cuda")
  tok[0, :S] = torch.from_numpy(tokens[0]).cuda()
  feats = engine.image_features(pixel_values, image_sizes)
  merged = vision.merge_image_embeddings(params["embed"][tok].to(cfg.dtype), tok, feats, cfg.image_token_id)
  cache = dec.init_kv_cache(cfg, shard.n_shard_layers, 1, min(engine.max_seq_len, cfg.max_seq_len), device="cuda")
  positions = torch.arange(pad, dtype=torch.int32, device="cuda")[None]
  logits, _ = dec.shard_forward(params, cfg, shard, merged, positions, cache, head_pos=torch.tensor([S - 1], device="cuda"))
  first = int(logits[0, 0].argmax())
  steps, _ = dec.fused_decode(params, cfg, shard, torch.tensor([[first]], dtype=torch.int32, device="cuda"), cache, torch.tensor([S], dtype=torch.int32, device="cuda"), n - 1, temp=0.0)
  return [first] + [int(t) for t in steps[0].tolist()]


def llava_plain_f32(torch, engine, tokens, pixel_values, image_sizes) -> tuple:
  """(features, last-position logits) of a plain f32 forward on the same
  weights upcast: the tower and projector in f32 (K1-K4 never run on f32),
  the merge, and a cache-less forward of the prompt, with TF32 off for its
  products and the patch convolution."""
  import dataclasses

  from xotorch_support_jetson_tpu_torch.models import decoder as dec, vision

  cfg, shard = engine.cfg, engine._effective_shard

  def f32(tree):
    return {k: f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}

  vp, p32 = f32(engine._vision_params), f32(engine.params)
  cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
  tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
  try:
    feats = vision.encode_images(vp["vision"], vp["projector"], cfg.vision, torch.from_numpy(pixel_values).cuda())[None].reshape(1, -1, cfg.dim)
    tok = torch.from_numpy(tokens).cuda()
    merged = vision.merge_image_embeddings(p32["embed"][tok], tok, feats, cfg.image_token_id)
    S = tokens.shape[1]
    logits, _ = dec.shard_forward(p32, cfg32, shard, merged, torch.arange(S, dtype=torch.int32, device="cuda")[None], None, head_pos=torch.tensor([S - 1], device="cuda"))
  finally:
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
  return feats, logits[0, 0]


async def _llava_serve(torch, tmain, args, port, smi, layers: int, quant: str | None) -> dict:
  """The llava daemon: a warm-up round (an image request and a text one),
  then the counted round, each request's launches zeroed just before it and
  read just after: the image request (K1 exactly once per layer in its
  prefill, K2 in its decode, K3 never, K4 only on int4 weights; its greedy
  ids equal to ``llava_plain_tokens``'s), then a text-only request (K1 once
  per layer). Nothing is built or captured after the warm-up. On bf16
  weights also: the tower's features and the served prefill's logits
  against ``llava_plain_f32`` within ``LLAVA_CHECK_TOL``, the tower's time
  per image and its share of the image request's TTFT, and one batched
  wave of 16 text requests at the defaults (K3, spec and mixed
  dispatches)."""
  from xotorch_support_jetson_tpu_torch.utils import programs

  tag = "llava" if quant is None else f"llava {quant}"
  node, server, engine, load_s = await _daemon_up(torch, tmain, args, port, "llava", LLAVA_MODEL, tag, _llava_cfg_problem, tokenizer=LlavaByteProcessor())
  res = dict(load_s=load_s, card=smi, weight_bytes=sum(t.numel() * t.element_size() for t in _leaves(engine.params)), tower_bytes=sum(t.numel() * t.element_size() for t in _leaves(engine._vision_params)))
  seen: list = []
  unspy = _spy_multimodal(engine, seen)
  try:
    L = engine.cfg.n_layers
    if L != layers:
      raise SystemExit(f"chip_smoke: [llava] {L} decoder layers loaded, expected {layers}")
    if quant and engine._vision_params["vision"]["layers"]["wq"].dtype != torch.bfloat16:
      raise SystemExit("chip_smoke: [llava] the tower was quantized (the reference keeps it in the model dtype)")
    log(f"[llava] {tag}: llava-hf/llava-1.5-7b-hf's published shapes (CLIP ViT-L/14-336: hidden 1024, 24 layers of which 23 run, 16 heads, FFN 4096, 576 patches; projector 1024 → 4096 → 4096; llama-2-7b decoder: hidden 4096, {L} of its 32 layers, 32/32 heads of 128, FFN 11008, vocab 32064, image token 32000), random bf16 weights; bos/eos 1/2; {res['weight_bytes'] / 1e9:.2f} GB decoder + {res['tower_bytes'] / 1e9:.2f} GB tower and projector")
    png = _llava_png()
    text_body = _llava_chat(True, None)
    await _llava_image(torch, node, engine, port, png, "warmup image", seen)  # the warm-up: every request kind once
    await _serve_requests(torch, node, engine, port, [("warmup text", text_body)])
    fam0 = programs.ledger.snapshot()["families"]
    _reset_launches()  # ---- the image request, counted
    img = await _llava_image(torch, node, engine, port, png, "image greedy streaming", seen)
    launches = _kernel_launches()  # ---- read just after
    _reset_launches()  # ---- the text request, counted
    txt = (await _serve_requests(torch, node, engine, port, [("text greedy streaming", text_body)]))[0]
    launches_text = _kernel_launches()  # ---- read just after
    fam1 = programs.ledger.snapshot()["families"]
    _nothing_built(tag, fam0, fam1, "llava")
    k4 = bool(quant)
    for what, got in (("image request", launches), ("text request", launches_text)):
      if got["flash_prefill"] != L or not got["flash_decode"] or got["paged_decode"] or bool(got["int4_matmul"]) != k4:
        raise SystemExit(f"chip_smoke: [llava] {tag} {what}: launches {got}; expected K1 exactly {L} (one prefill), K2 in the decode, K3 none, K4 {'in every product' if k4 else 'none'}")
    if fam1["prefill.embeds"]["dispatches"] - fam0.get("prefill.embeds", {}).get("dispatches", 0) != 1 or fam1["vision.encode"]["dispatches"] - fam0.get("vision.encode", {}).get("dispatches", 0) != 1:
      raise SystemExit(f"chip_smoke: [llava] {tag}: the image request must run one vision.encode and one prefill.embeds dispatch: {fam1}")
    ids, px, sizes = seen[-1]
    plain = llava_plain_tokens(torch, engine, ids, px, sizes, len(img["tokens"]))
    if plain[: len(img["tokens"])] != img["tokens"]:
      raise SystemExit(f"chip_smoke: [llava] {tag}: the served image answer differs from the uncaptured forward of the same merged embeddings:\n{img['tokens']}\n{plain}")
    res.update(
      launches=launches, launches_text=launches_text, image_tokens=img["tokens"], prompt_tokens=int(ids.shape[1]), image_placeholders=int((ids == LLAVA_IMAGE_ID).sum()),
      image_ttft_s=img["ttft_s"], image_decode_tok_s=_decode_rate(img) if img["stream"] else None, text_ttft_s=txt["ttft_s"], text_decode_tok_s=_decode_rate(txt),
      http=png is not None,
    )
    log(f"[llava] {tag}: image request ({'HTTP, a 512×384 PNG' if png else 'the device half: no Pillow here'}; prompt {res['prompt_tokens']} tokens of which {res['image_placeholders']} image placeholders, prefill bucket {-(-res['prompt_tokens'] // 128) * 128}): TTFT {img['ttft_s']:.4f} s, decode {res['image_decode_tok_s'] or float('nan'):.1f} tok/s, {len(img['tokens'])} tokens equal to the uncaptured forward's | launches {launches} | text request: TTFT {txt['ttft_s']:.4f} s, decode {res['text_decode_tok_s']:.1f} tok/s, launches {launches_text} | no build or capture after the warm-up | {smi}")
    if quant is None:
      feats_bf16 = engine.image_features(px, sizes).reshape(1, -1, engine.cfg.dim)
      feats32, ref = llava_plain_f32(torch, engine, ids, px, sizes)
      served, _ = await asyncio.get_running_loop().run_in_executor(engine.executor, engine._infer_multimodal_sync, "llava-check", ids, px, sizes, None)
      engine.end_request("llava-check")
      served = torch.from_numpy(served[0]).cuda()
      check = dict(feature_rel_err=_rel_err(feats_bf16, feats32), logits_rel_err=_rel_err(served, ref), argmax_agree=int(served.argmax()) == int(ref.argmax()))
      res["check"] = check
      del feats32, ref
      if not (check["feature_rel_err"] < LLAVA_CHECK_TOL and check["logits_rel_err"] < LLAVA_CHECK_TOL):
        raise SystemExit(f"chip_smoke: [llava] against the plain f32 forward: {check}")
      tower = [0.0] * 5
      for i in range(len(tower)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.image_features(px, sizes)
        torch.cuda.synchronize()
        tower[i] = time.perf_counter() - t0
      res["tower_ms"] = min(tower) * 1e3
      res["tower_share_of_ttft"] = res["tower_ms"] / 1e3 / img["ttft_s"]
      res["tower_profile"] = _profile(torch, "llava tower and projector, one 336 px image (eager)", lambda: engine.image_features(px, sizes), 3)
      log(f"[llava] the tower's 576 features (bf16, eager) against the plain f32 tower: rel L2 {check['feature_rel_err']:.3e}; the served prefill's logits (captured, K1) against the plain f32 forward: rel L2 {check['logits_rel_err']:.3e} (limit {LLAVA_CHECK_TOL}), argmax agree {check['argmax_agree']} | the tower and projector: {res['tower_ms']:.3f} ms an image (best of 5, host clock around a synchronised call), {res['tower_share_of_ttft']:.3f} of the image request's TTFT | {smi}")
      engine._cache_pool.clear()
      engine._graph_pool = None
      gc.collect()
      torch.cuda.empty_cache()
      res["batched"] = b = await _batched_defaults(torch, node, engine, port, smi, LLAVA_MODEL, "llava", "kernel")
      if not b["launches"]["paged_decode"] or not b["launches"]["flash_prefill"]:
        raise SystemExit(f"chip_smoke: [llava] batched text wave: launches {b['launches']}; K1 and K3 must run")
    return res
  finally:
    unspy()
    await _daemon_down(node, server, engine)


async def _llava_next(torch, tmain, args, port, smi, layers: int) -> dict:
  """llava-1.6-vicuna-7b: one any-res request through the device half (a
  672×672 image: 1 base tile and a 2×2 grid, 2,928 features with the 48
  newlines), after a warm-up one: K1 exactly once per layer, greedy ids
  equal to the uncaptured forward's; the tower's time for its 5 tiles."""
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard
  from xotorch_support_jetson_tpu_torch.models.vision import anyres_grid_shape

  node, server, engine, load_s = await _daemon_up(torch, tmain, args, port, "llava", LLAVA_NEXT_MODEL, "llava-next bf16", lambda cfg: "" if cfg.vision is not None and cfg.vision.anyres else "not llava-next", tokenizer=LlavaByteProcessor())
  try:
    vcfg = engine.cfg.vision
    size = (672, 672)
    gh, gw = anyres_grid_shape(size, vcfg.grid_pinpoints, vcfg.image_size)
    side = vcfg.image_size // vcfg.patch_size
    n_feat = vcfg.n_patches + gh * side * (gw * side + 1)
    tok = LlavaByteProcessor()
    ids = np.asarray([tok.ids(tok.apply_chat_template([{"role": "user", "content": "Describe the picture in one line. <image>"}]), n_feat)], np.int32)
    px = torch.randn((1, 1 + gh * gw, 3, 336, 336), generator=torch.Generator().manual_seed(SEED + 22)).numpy()
    sizes = np.asarray([size], np.int64)
    shard = Shard(LLAVA_NEXT_MODEL, 0, 31, 32)
    out = {}
    for rid in ("next-warmup", "next-counted"):
      _reset_launches()
      t0 = time.perf_counter()
      logits, _ = await engine.infer_image_tokens(rid, shard, ids, px, sizes)
      ttft = time.perf_counter() - t0
      first = int(np.argmax(logits[0]))
      toks = [first] + await engine.generate_oneshot(rid, shard, first, LLAVA_ANSWER - 1, eos_ids=(), temp=0.0)
      wall = time.perf_counter() - t0
      engine.end_request(rid)
      out = dict(launches=_kernel_launches(), ttft_s=ttft, wall_s=wall, tokens=toks, features=n_feat, tiles=1 + gh * gw, prompt_tokens=int(ids.shape[1]))
    if out["launches"]["flash_prefill"] != layers:
      raise SystemExit(f"chip_smoke: [llava] llava-next: launches {out['launches']}; K1 exactly {layers}")
    plain = llava_plain_tokens(torch, engine, ids, px, sizes, len(out["tokens"]))
    if plain != out["tokens"]:
      raise SystemExit(f"chip_smoke: [llava] llava-next: the served answer differs from the uncaptured forward's:\n{out['tokens']}\n{plain}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.image_features(px, sizes)
    torch.cuda.synchronize()
    out["tower_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"[llava] llava-1.6-vicuna-7b any-res ({out['tiles']} tiles of 336, {n_feat} features with the newlines; prompt {out['prompt_tokens']} tokens, bucket {-(-out['prompt_tokens'] // 128) * 128}): time to the first token {ttft:.4f} s (device half), the tower and packing {out['tower_ms']:.3f} ms, {len(out['tokens'])} tokens equal to the uncaptured forward's | launches {out['launches']} | {smi}")
    return out
  finally:
    await _daemon_down(node, server, engine)


# -------------------------------------------------------------- 11. diffusion

DIFFUSION_MODEL = "stable-diffusion-2-1-base"
DIFFUSION_STEPS = 20
DIFFUSION_CHECK_TOL = 5e-2  # relative L2: CLIP, one UNet call and one VAE decode in bf16 against plain f32 (PERF.md §2)
DIFFUSION_PROMPT = "a photograph of an astronaut riding a horse on the moon"
DIFFUSION_IMG2IMG_SIZE = (500, 380)  # (width, height) of the init PNG: off the 64 px grid both ways


def sd21_base_config():
  """stabilityai/stable-diffusion-2-1-base's published shapes (its
  text_encoder, unet, vae and scheduler config files): OpenCLIP-H's text
  tower (1024 wide, 23 layers, 16 heads, FFN 4096, gelu, 77 positions), a
  UNet of channels 320 / 640 / 1280 / 1280 with 5 / 10 / 20 / 20 heads and
  1024-wide cross-attention, a VAE of 128 / 256 / 512 / 512, 64 × 64
  latents (512 px), DDIM with steps_offset 1."""
  from xotorch_support_jetson_tpu_torch.models import diffusion as d

  return d.DiffusionConfig(
    clip=d.ClipTextConfig(vocab_size=49408, hidden_size=1024, intermediate_size=4096, n_layers=23, n_heads=16, max_positions=77, act="gelu"),
    unet=d.UNetConfig(block_out_channels=(320, 640, 1280, 1280), layers_per_block=2, cross_attention_dim=1024, attn_heads=(5, 10, 20, 20)),
    vae=d.VaeConfig(block_out_channels=(128, 256, 512, 512), layers_per_block=2),
    sample_size=64, steps_offset=1,
  )


def write_diffusion_checkpoint(torch, path: Path, seed: int = SEED + 22) -> float:
  """A seeded random bf16 SD-2.1-base checkpoint in the diffusers layout
  (no tokenizer: the pipeline's crc32 fallback tokenizes), drawn on the
  card and written by the port's exporter; the seconds it took."""
  from xotorch_support_jetson_tpu_torch.models import diffusion_loader as dl

  t0 = time.perf_counter()
  params = dl.init_diffusion_params(torch.Generator(device="cuda").manual_seed(seed), sd21_base_config(), dtype=torch.bfloat16, device="cuda")
  dl.export_diffusers_checkpoint(path, sd21_base_config(), params)
  del params
  gc.collect()
  torch.cuda.empty_cache()
  return time.perf_counter() - t0


def _png_data_url(width: int, height: int, seed: int) -> str:
  """A seeded RGB image (a smooth gradient under noise) as a PNG data URL."""
  import base64
  import io

  from PIL import Image

  rng = np.random.default_rng(seed)
  yy, xx = np.mgrid[0:height, 0:width]
  arr = np.stack([xx * 255 // width, yy * 255 // height, (xx + yy) * 127 // (width + height)], axis=-1) + rng.integers(0, 40, (height, width, 3))
  buf = io.BytesIO()
  Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(buf, format="PNG")
  return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _decode_png(raw: bytes) -> np.ndarray:
  import io

  from PIL import Image

  img = Image.open(io.BytesIO(raw))
  if img.mode != "RGB":
    raise SystemExit(f"chip_smoke: [diffusion] a PNG in mode {img.mode}, not RGB")
  return np.asarray(img)


def _image_request(port: int, path: str, body: dict) -> dict:
  """One image request: its status, wall seconds, progress steps and the
  decoded images (the streaming route's URLs fetched, or the b64 PNGs)."""
  import base64

  t0 = time.perf_counter()
  status, raw = _http(port, "POST", path, body, timeout=900)
  wall = time.perf_counter() - t0
  if status != 200:
    raise SystemExit(f"chip_smoke: [diffusion] {path}: HTTP {status}: {raw[:400]}")
  if path == "/v1/images/generations":
    data = json.loads(raw)["data"]
    return dict(wall_s=wall, steps=[], images=[_decode_png(base64.b64decode(e["b64_json"])) for e in data])
  lines = [json.loads(line) for line in raw.split("\n") if line.strip()]
  errors = [line["error"] for line in lines if "error" in line]
  if errors:
    raise SystemExit(f"chip_smoke: [diffusion] {path}: {errors}")
  final = [line for line in lines if "images" in line]
  images = []
  for entry in final[0]["images"]:
    url = entry["url"]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{url[url.index('/images/'):]}", timeout=120) as resp:
      images.append(_decode_png(resp.read()))
  return dict(wall_s=wall, steps=[line["step"] for line in lines if "progress" in line], total=[line["total_steps"] for line in lines if "progress" in line][-1:], images=images)


def diffusion_component_checks(torch, pipe, smi: str) -> dict:
  """CLIP, one UNet call (t = 500, the guidance batch of 2, 64 × 64
  latents) and one VAE decode of the loaded bf16 pipeline against the same
  weights in plain f32 (TF32 off), each on the same inputs: relative L2
  within DIFFUSION_CHECK_TOL. Then where the time goes: a denoise step's,
  the UNet's, CLIP's and the VAE decode's wall (host clock, synchronized)
  against the profiler's device time, and their launches. The step is also
  timed with CUDA events; the 2 ms spin ahead of each call does not cover
  the host's enqueue of its ~1,800 eager launches, so that figure spans the
  host's work too and is printed as such, not as device time."""
  from xotorch_support_jetson_tpu_torch.inference.diffusion_pipeline import _cast
  from xotorch_support_jetson_tpu_torch.models import diffusion as d

  cfg = pipe.cfg
  gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
  tokens = torch.from_numpy(np.concatenate([pipe._tokenize(""), pipe._tokenize(DIFFUSION_PROMPT)])).long().cuda()
  x = torch.randn((2, cfg.unet.in_channels, cfg.sample_size, cfg.sample_size), generator=gen, device="cuda")
  t = torch.full((2,), 500, dtype=torch.int32, device="cuda")
  z = torch.randn((1, cfg.vae.latent_channels, cfg.sample_size, cfg.sample_size), generator=gen, device="cuda")
  with torch.no_grad():
    got = {"clip": d.clip_text_encode(pipe.params["clip"], cfg.clip, tokens)}
    f32 = _cast(pipe.params, torch.float32, pipe.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # a true f32 reference
    try:
      want = {"clip": d.clip_text_encode(f32["clip"], cfg.clip, tokens)}
      want["unet"] = d.unet_apply(f32["unet"], cfg.unet, x, t, want["clip"])
      want["vae_decode"] = d.vae_decode(f32["vae"], cfg.vae, z)
    finally:
      torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del f32
    ctx = want["clip"].to(torch.bfloat16)  # each component on the same inputs
    got["unet"] = d.unet_apply(pipe.params["unet"], cfg.unet, x.to(torch.bfloat16), t, ctx)
    got["vae_decode"] = d.vae_decode(pipe.params["vae"], cfg.vae, z.to(torch.bfloat16))
    errs = {k: _rel_err(got[k], want[k]) for k in want}
    for k, e in errs.items():
      log(f"[diffusion] {k} bf16 against plain f32: relative L2 {e:.3e} (shape {tuple(got[k].shape)}; limit {DIFFUSION_CHECK_TOL})")
      if not (math.isfinite(e) and e <= DIFFUSION_CHECK_TOL) or not torch.isfinite(got[k].float()).all():
        raise SystemExit(f"chip_smoke: [diffusion] {k} in bf16 is {e:.3e} from plain f32 (limit {DIFFUSION_CHECK_TOL})")
    del want, got
    gc.collect()
    torch.cuda.empty_cache()

    ts, a_ts, a_prevs = pipe._schedule(DIFFUSION_STEPS)
    a_ts_d, a_prevs_d = torch.from_numpy(a_ts).cuda(), torch.from_numpy(a_prevs).cuda()
    ctx_pair = pipe.encode_prompt(DIFFUSION_PROMPT)
    lat = x[:1].to(torch.bfloat16)

    def step():
      return d.sample_chunk(pipe.params["unet"], cfg, lat, ctx_pair, ts[:1], a_ts_d[:1], a_prevs_d[:1], 7.5)

    def unet():
      return d.unet_apply(pipe.params["unet"], cfg.unet, x.to(torch.bfloat16), t, ctx_pair)

    prof_step = _profile(torch, "diffusion denoise step (eager, CFG batch 2, 64x64 latents)", step, reps=5)
    step_events_ms = _cuda_ms(torch, step, iters=5, warmup=1)
    prof_unet = _profile(torch, "diffusion unet call", unet, reps=3)
    prof_clip = _profile(torch, "diffusion CLIP (the prompt pair)", lambda: d.clip_text_encode(pipe.params["clip"], cfg.clip, tokens), reps=10)
    prof_vae = _profile(torch, "diffusion VAE decode (512 px)", lambda: d.vae_decode(pipe.params["vae"], cfg.vae, z.to(torch.bfloat16)), reps=3)
  parts = "; ".join(f"{name}: wall {p['wall_ms']:.3f} ms, device {p['device_ms']:.3f} ms, {p['launches']:.0f} launches" for name, p in (("a denoise step", prof_step), ("the UNet", prof_unet), ("CLIP (the prompt pair)", prof_clip), ("VAE decode (512 px)", prof_vae)))
  log(f"[diffusion] {parts} (wall: host clock, synchronized; device: the profiler's); a denoise step by CUDA events {step_events_ms:.3f} ms (host-bound: it spans the enqueue) | {smi}")
  return dict(errors=errs, step=prof_step, step_events_ms=step_events_ms, unet=prof_unet, clip=prof_clip, vae_decode=prof_vae)


def phase_diffusion(torch, ckpt: Path, smi: str) -> dict:
  """stable-diffusion-2-1-base at full width through the daemon (module
  docstring, phase 11): the checkpoint loaded by the port's loader, the
  image routes over HTTP, the component checks; K1-K4 never launch."""
  from xotorch_support_jetson_tpu_torch import main as tmain

  home = ROOT / "build" / "smoke_sd_home"
  saved = os.environ.get("XOT_TPU_HOME")
  os.environ["XOT_TPU_HOME"] = str(home)  # the saved PNGs land under the checkout
  args, port = _daemon_args(tmain, ckpt, model=DIFFUSION_MODEL)
  torch.cuda.reset_peak_memory_stats()
  try:
    out = asyncio.run(_diffusion_serve(torch, tmain, args, port, smi))
  finally:
    if saved is None:
      os.environ.pop("XOT_TPU_HOME", None)
    else:
      os.environ["XOT_TPU_HOME"] = saved
    shutil.rmtree(home, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
  out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
  log(f"[diffusion] peak device memory allocated over the phase {out['peak_allocated_bytes'] / 1e9:.2f} GB | {smi}")
  return out


async def _diffusion_serve(torch, tmain, args, port, smi) -> dict:
  from xotorch_support_jetson_tpu_torch.inference.diffusion_pipeline import DiffusionPipeline
  from xotorch_support_jetson_tpu_torch.inference.shard import Shard

  node, api, engine, _ = tmain.build_components(args)
  if engine.device.type != "cuda":
    raise SystemExit("chip_smoke: [diffusion] the engine did not choose the card")
  await node.start()
  server = await api.run(host="127.0.0.1", port=port)
  out: dict = {}
  try:
    _reset_launches()
    t0 = time.perf_counter()
    await engine.ensure_shard(Shard(DIFFUSION_MODEL, 0, 30, 31))
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    pipe = engine.diffusion
    if not isinstance(pipe, DiffusionPipeline) or pipe.dtype != torch.bfloat16 or pipe.device.type != "cuda" or engine.params is not None:
      raise SystemExit(f"chip_smoke: [diffusion] the engine did not load a bf16 pipeline on the card: {pipe}")
    if pipe.cfg != sd21_base_config():
      raise SystemExit(f"chip_smoke: [diffusion] the loaded config is not SD-2.1-base's: {pipe.cfg}")
    weights = sum(t.numel() * t.element_size() for t in _leaves(pipe.params))
    log(f"[diffusion] {DIFFUSION_MODEL} daemon up on 127.0.0.1:{port}; {weights / 1e9:.2f} GB of bf16 weights loaded to the card by the port's loader in {out['load_s']:.1f} s")

    body = {"model": DIFFUSION_MODEL, "prompt": DIFFUSION_PROMPT, "size": [512, 512], "steps": DIFFUSION_STEPS, "guidance": 7.5, "seed": 1}
    reqs = {}
    reqs["txt2img"] = await asyncio.to_thread(_image_request, port, "/v1/image/generations", body)
    reqs["txt2img_again"] = await asyncio.to_thread(_image_request, port, "/v1/image/generations", body)
    reqs["openai_n2_b64"] = await asyncio.to_thread(_image_request, port, "/v1/images/generations", {"model": DIFFUSION_MODEL, "prompt": DIFFUSION_PROMPT, "n": 2, "size": "512x512", "steps": DIFFUSION_STEPS, "seed": 2, "response_format": "b64_json"})
    init = _png_data_url(*DIFFUSION_IMG2IMG_SIZE, seed=SEED + 24)
    reqs["img2img"] = await asyncio.to_thread(_image_request, port, "/v1/image/generations", {**body, "size": None, "image_url": init, "strength": 0.5, "seed": 3})
    t0 = time.perf_counter()
    euler = await asyncio.get_running_loop().run_in_executor(engine.executor, lambda: pipe.generate(DIFFUSION_PROMPT, steps=DIFFUSION_STEPS, seed=4, n=2, method="euler"))
    reqs["euler_n2_engine"] = dict(wall_s=time.perf_counter() - t0, steps=[], images=list(euler))
    chat_status, chat_raw = await asyncio.to_thread(_http, port, "POST", "/v1/chat/completions", {"model": DIFFUSION_MODEL, "messages": [{"role": "user", "content": "hello"}]})
    out["launches"] = _kernel_launches()

    # gates
    if reqs["txt2img"]["steps"] != list(range(0, DIFFUSION_STEPS + 1, 5)) or reqs["txt2img"]["total"] != [DIFFUSION_STEPS]:
      raise SystemExit(f"chip_smoke: [diffusion] progress steps {reqs['txt2img']['steps']} of {reqs['txt2img']['total']}")
    shapes = {k: [im.shape for im in r["images"]] for k, r in reqs.items()}
    want_shapes = {"txt2img": [(512, 512, 3)], "txt2img_again": [(512, 512, 3)], "openai_n2_b64": [(512, 512, 3)] * 2, "img2img": [(384, 512, 3)], "euler_n2_engine": [(512, 512, 3)] * 2}
    if shapes != want_shapes:
      raise SystemExit(f"chip_smoke: [diffusion] image shapes {shapes}, expected {want_shapes}")
    if reqs["img2img"]["steps"][-1] != DIFFUSION_STEPS // 2:
      raise SystemExit(f"chip_smoke: [diffusion] img2img at strength 0.5 ran {reqs['img2img']['steps']}")
    if not np.array_equal(reqs["txt2img"]["images"][0], reqs["txt2img_again"]["images"][0]):
      raise SystemExit("chip_smoke: [diffusion] the same request twice gave different pixels")
    for k in ("openai_n2_b64", "euler_n2_engine"):
      a, b = reqs[k]["images"]
      if np.array_equal(a, b):
        raise SystemExit(f"chip_smoke: [diffusion] {k}: the two candidates are identical")
    if chat_status != 501 or "image-generation model" not in chat_raw:
      raise SystemExit(f"chip_smoke: [diffusion] a chat request to the SD model answered {chat_status}: {chat_raw[:300]}")
    if any(out["launches"].values()):
      raise SystemExit(f"chip_smoke: [diffusion] K1-K4 launched on the diffusion path: {out['launches']}")
    for k, r in reqs.items():
      spread = [float(np.std(im)) for im in r["images"]]
      log(f"[diffusion] {k}: {len(r['images'])} image(s) {shapes[k][0]}, wall {r['wall_s']:.3f} s, progress {r['steps']}, pixel std {[round(s, 2) for s in spread]}")
    log(f"[diffusion] the same request twice: identical pixels; the candidates of each n=2 request differ; a chat request: HTTP {chat_status} ({json.loads(chat_raw)['detail'][:80]}); K1-K4 launches over the requests {out['launches']}")
    out["requests"] = {k: dict(wall_s=r["wall_s"], steps=r["steps"], shapes=shapes[k]) for k, r in reqs.items()}
    out["chat_status"] = chat_status
    out["checks"] = diffusion_component_checks(torch, pipe, smi)
    if any(_kernel_launches().values()):
      raise SystemExit(f"chip_smoke: [diffusion] K1-K4 launched in the component checks: {_kernel_launches()}")
  finally:
    await _daemon_down(node, server, engine)
  return out


def main() -> int:
  try:
    import torch

    from xotorch_support_jetson_tpu_torch.ops import flash_attention  # noqa: F401 — the port must be importable here
  except ImportError as e:
    print(f"chip_smoke: cannot import the PyTorch port ({e}); run from the repository root", file=sys.stderr)
    return 2
  phase_s: dict[str, float] = {}
  # No phase reaches a hub over the network: the fetch phase points its own
  # daemon at the script's 127.0.0.1 hub, every other one fetches nothing.
  os.environ["HF_HUB_OFFLINE"] = "1"
  os.environ["HF_ENDPOINT"] = "http://127.0.0.1:9"

  def timed(name, fn, *args, **kwargs):
    """Run one phase; its wall seconds go to the log (``[time]``) and the record."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    phase_s[name] = time.perf_counter() - t0
    log(f"[time] {name}: {phase_s[name]:.1f} s")
    return out

  smi = phase_device(torch)
  build_s = timed("build", phase_build)
  kern = timed("kernels", phase_kernels, torch)
  ckpt, draft_dir, gemma_dir, moe_dir, mla_dir, llava_dir, sd_dir = (ROOT / "build" / name for name in ("smoke_ckpt", "smoke_draft", "smoke_gemma2", "smoke_moe", "smoke_mla", "smoke_llava", "smoke_sd"))
  try:
    write_s = write_checkpoint(torch, ckpt)
    log(f"[serving] wrote a random bf16 llama-3.2-1b checkpoint ({sum(f.stat().st_size for f in ckpt.iterdir()) / 1e9:.2f} GB) in {write_s:.1f} s")
    serving = timed("serving", phase_serving, torch, ckpt)
    quant = timed("quant", phase_quant_serving, torch, ckpt, serving.pop("_bf16_logits"))
    write_checkpoint(torch, draft_dir, layers=DRAFT_LAYERS)
    spec = timed("spec", phase_spec_serving, torch, ckpt, draft_dir, serving)
    graphs = timed("graphs and api", phase_graphs, torch, ckpt, draft_dir, smi)
    # The int4-weights daemon first: the metrics registry and the SLO
    # engine are the process's, so a daemon started after the priority
    # pass would inherit its interactive burn (and the smallest budget).
    batched_int4 = timed("batched int4 weights", phase_batched, torch, ckpt, weights="int4")
    # The tiered pass before the priority pass too: its long prompts are
    # sliced by the interactive burn's budget.
    tiered = timed("tiered", phase_tiered, torch, ckpt)
    batched = timed("batched", phase_batched, torch, ckpt)
    layouts = timed("batched layouts", phase_batched_layouts, torch, ckpt, draft_dir, batched["passes"]["bf16"]["streams"])
    fetch = timed("fetch", phase_fetch, torch, draft_dir)
    processes = timed("processes", phase_processes, ckpt)
    ring = timed("ring", phase_ring, torch, ckpt, smi, serving)
    lora = timed("lora", phase_lora, torch, ckpt, smi)
    shutil.rmtree(ckpt, ignore_errors=True)
    write_s = timed("llava checkpoint", write_llava_checkpoint, torch, llava_dir)
    log(f"[llava] wrote a random bf16 llava-1.5-7b checkpoint ({sum(f.stat().st_size for f in llava_dir.iterdir()) / 1e9:.2f} GB, full width, the whole tower and {LLAVA_LAYERS} of the decoder's 32 layers) in {write_s:.1f} s")
    llava = timed("llava", phase_llava, torch, llava_dir, smi)
    shutil.rmtree(llava_dir, ignore_errors=True)
    write_s = timed("diffusion checkpoint", write_diffusion_checkpoint, torch, sd_dir)
    log(f"[diffusion] wrote a random bf16 {DIFFUSION_MODEL} checkpoint ({sum(f.stat().st_size for f in sd_dir.rglob('*') if f.is_file()) / 1e9:.2f} GB, full width, the diffusers layout, no tokenizer) in {write_s:.1f} s")
    diffusion = timed("diffusion", phase_diffusion, torch, sd_dir, smi)
    diffusion["write_s"] = write_s
    shutil.rmtree(sd_dir, ignore_errors=True)
    write_s = timed("moe checkpoint", write_moe_checkpoint, torch, moe_dir)
    log(f"[moe] wrote a random bf16 Qwen3-30B-A3B checkpoint ({sum(f.stat().st_size for f in moe_dir.iterdir()) / 1e9:.2f} GB, full width, {MOE_LAYERS} of 48 layers) in {write_s:.1f} s")
    moe_res = timed("moe", phase_moe, torch, moe_dir, smi)
    shutil.rmtree(moe_dir, ignore_errors=True)
    write_s = timed("mla checkpoint", write_mla_checkpoint, torch, mla_dir)
    log(f"[mla] wrote a random bf16 DeepSeek-Coder-V2-Lite checkpoint ({sum(f.stat().st_size for f in mla_dir.iterdir()) / 1e9:.2f} GB, full width, {MLA_LAYERS} of 27 layers) in {write_s:.1f} s")
    mla_res = timed("mla", phase_mla, torch, mla_dir, smi)
    shutil.rmtree(mla_dir, ignore_errors=True)
    write_s = timed("gemma2 checkpoint", write_gemma_checkpoint, torch, gemma_dir)
    log(f"[gemma2] wrote a random bf16 gemma-2-9b checkpoint ({sum(f.stat().st_size for f in gemma_dir.iterdir()) / 1e9:.2f} GB, full width, {GEMMA_LAYERS} of 42 layers) in {write_s:.1f} s")
    gemma = timed("gemma2", phase_gemma2, torch, gemma_dir, smi)
  finally:
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(draft_dir, ignore_errors=True)
    shutil.rmtree(gemma_dir, ignore_errors=True)
    shutil.rmtree(moe_dir, ignore_errors=True)
    shutil.rmtree(mla_dir, ignore_errors=True)
    shutil.rmtree(llava_dir, ignore_errors=True)
    shutil.rmtree(sd_dir, ignore_errors=True)
  # Launches per kernel on each main path (the tiered multi-turn pass with
  # the tier on is "batched_tiered": K1, K3): the solo bf16 daemon run (K1,
  # K2), the solo quantized runs (K1; K4 under int4 weights), the solo
  # speculation runs ("solo_spec": K1 in prefills, verify windows and draft
  # catch-ups; "solo_spec_ceiling": the same on the echo checkpoint), the batched
  # runs on bf16 weights at the defaults (K1, K3; summed over the three pool
  # types), the same with XOT_TPU_MIXED_TICK=0, the priority pass, and the
  # batched run on int4 weights (K1, K3, K4). Of the batched default runs'
  # launches, those inside mixed dispatches are listed apart as well.
  # "batched_spec" is the part of every batched pass's launches made inside
  # spec dispatches (K3, and K4 on int4 weights): a path of its own within
  # those passes, so the total does not count it twice. "solo_api" is the
  # API phase on the solo daemon (K1 in its prefills and once per layer in
  # each logprobs scoring forward), "batched_api" the batched logprobs
  # request (K1, K3). The gemma2 paths: "gemma2" is the solo bf16 daemon's
  # counted requests and its batched pass (no K1-K3: the plain route),
  # "gemma2_int4" the int4-weights daemon (K4). The MoE paths: "moe" is the
  # solo bf16 daemon's counted requests (K1) and its batched pass (K1, K3),
  # "moe_int4" the int4-weights daemon (K1, K4). The MLA paths: "mla" is the
  # solo bf16 daemon's counted requests and its batched pass (no K1-K3: the
  # absorbed op, the naive cache-less form and the paged gather are plain),
  # "mla_int4" the int4-weights daemon (K4). "lora" is the multi-LoRA
  # phase: its solo adapter requests (K1) and its batched adapter waves
  # (paged: K1, K3; dense: K1, K2; int4 weights: K4 with K1, K3). "llava"
  # is the llava phase on bf16 weights: its counted image and text requests
  # (K1, K2) and its batched text wave (K1, K3); "llava_int4" the same two
  # requests on int4 weights (K1, K2, K4). "diffusion" is the
  # stable-diffusion phase's requests, where no kernel may launch.
  bp = batched["passes"]
  paths = {
    "solo": [serving["launches"]], "solo_long_prompt": [serving["long"]["launches"]], "solo_quant": [q["launches"] for q in quant.values()],
    "batched": [bp[k]["launches"] for k in ("bf16", "int8", "int4")], "batched_nospec": [bp["bf16_nospec"]["launches"]], "batched_alternating": [bp["bf16_alternating"]["launches"]],
    "batched_fifo": [bp["bf16_fifo"]["launches"]], "batched_priority": [bp["bf16_priority"]["launches"]], "batched_int4_weights": [p["launches"] for p in batched_int4["passes"].values()],
    "batched_tiered": [tiered["passes"]["tier_on"]["launches"]], "solo_spec": [spec[k]["launches"] for k in SPEC_PASSES],
    "solo_spec_ceiling": [spec[k]["launches"] for k in ECHO_PASSES],
    "batched_spec": [p["spec"]["launches"] for p in [*bp.values(), *batched_int4["passes"].values()]],
    "solo_graphs": [graphs["daemon"]["launches"]], "solo_api": [graphs["daemon"]["api"]["launches"]], "batched_api": [batched["logprobs"]["launches"]],
    "gemma2": [gemma["bf16"]["launches"], gemma["bf16"]["batched"]["launches"]], "gemma2_int4": [gemma["int4"]["launches"]],
    "ring": [ring["launches"]], "ring_daemons": [ring["daemon_launches"]],
    "moe": [moe_res["bf16"]["launches"], moe_res["bf16"]["batched"]["launches"]], "moe_int4": [moe_res["int4"]["launches"]],
    "mla": [mla_res["bf16"]["launches"], mla_res["bf16"]["batched"]["launches"]], "mla_int4": [mla_res["int4"]["launches"]],
    "batched_dense": [layouts["bf16_dense"]["launches"]], "batched_draft": [layouts["bf16_draft"]["launches"]], "batched_dense_draft": [layouts["bf16_dense_draft"]["launches"]],
    "fetch": [fetch["launches"]], "lora": [lora["solo"]["launches"], *(p["launches"] for p in lora["passes"].values())],
    "llava": [llava["bf16"]["launches"], llava["bf16"]["launches_text"], llava["bf16"]["batched"]["launches"]], "llava_int4": [llava["int4"]["launches"], llava["int4"]["launches_text"]],
    "diffusion": [diffusion["launches"]],
  }
  by_path = {name: {path: sum(x.get(name, 0) for x in runs) for path, runs in paths.items()} for name in ("flash_prefill", "flash_decode", "paged_decode", "int4_matmul")}
  for name in ("flash_prefill", "paged_decode"):
    by_path[name]["of_batched_inside_mixed_dispatches"] = sum(bp[k]["mixed_launches"][name] for k in ("bf16", "int8", "int4"))

  def entry(name, source, replaces, rows, head):
    r = rows[head]
    return {
      "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": sum(v for k, v in by_path[name].items() if not k.startswith("of_") and k != "batched_spec"),
      "launches_by_path": by_path[name],
      "max_abs_err": max(x["max_abs_err"] for x in rows), "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
      "bound_by": r["bound_by"], "library_ms": r["library_ms"], "at": {k: r[k] for k in r if k in ("Sq", "q_offset", "kv", "B", "positions", "cache", "lengths", "weight", "T", "d_in", "d_out")},
    }

  k4_head = next(i for i, r in enumerate(kern["int4_matmul"]) if r["weight"] == "w_gate/w_up" and r["T"] == 1)
  kernels_line = {"kernels": [
    # Head row: Sq 128 at offset 0 against the 4096-slot cache; the solo
    # verify-window and scoring-shape rows' errors count too.
    {**entry("flash_prefill", "xotorch_support_jetson_tpu_torch/csrc/flash_prefill.cu", "xotorch_support_jetson_tpu/ops/pallas_attention.py:32", kern["flash_prefill"] + kern["flash_prefill_verify"] + kern["flash_prefill_scoring"] + kern["flash_prefill_moe"] + kern["flash_prefill_b8_verify"] + kern["flash_prefill_llava"], 0),
     "llava_rows": [{k: r[k] for k in ("Sq", "q_offset", "kv", "hd", "heads", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")} for r in kern["flash_prefill_llava"]],
     "b8_verify_windows": [{k: r[k] for k in ("B", "Sq", "q_offset", "kv", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")} for r in kern["flash_prefill_b8_verify"]],
     "moe_rows": [{k: r[k] for k in ("Sq", "q_offset", "kv", "hd", "heads", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")} for r in kern["flash_prefill_moe"]],
     "verify_windows": [{k: r[k] for k in ("Sq", "q_offset", "kv", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")} for r in kern["flash_prefill_verify"]],
     "scoring_rows": [{k: r[k] for k in ("Sq", "skv", "q_offset", "kv", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")} for r in kern["flash_prefill_scoring"]]},
    {**entry("flash_decode", "xotorch_support_jetson_tpu_torch/csrc/flash_decode.cu", "xotorch_support_jetson_tpu/ops/pallas_attention.py:190", kern["flash_decode"] + kern["flash_decode_b8"] + kern["flash_decode_llava"], 0),
     "llava_rows": [{k: r[k] for k in ("B", "positions", "cache", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")} for r in kern["flash_decode_llava"]],
     "b8_rows": [{k: r[k] for k in ("B", "positions", "cache", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")} for r in kern["flash_decode_b8"]]},
    # Head row: B=8 at mixed lengths, bf16 pages (the batched path's geometry);
    # the verify-window rows' errors count too.
    {**entry("paged_decode", "xotorch_support_jetson_tpu_torch/csrc/paged_decode.cu", "xotorch_support_jetson_tpu/ops/paged.py:236", kern["paged_decode"] + kern["paged_window"] + kern["paged_window_w5"] + kern["paged_decode_moe"] + kern["paged_decode_llava"], 12),
     "llava_rows": [{k: r[k] for k in ("B", "kv", "hd", "heads", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")} for r in kern["paged_decode_llava"]],
     "drafted_verify_windows": [{k: r[k] for k in ("B", "W", "starts", "kv", "max_abs_err", "ms", "w1_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")} for r in kern["paged_window_w5"]],
     "moe_rows": [{k: r[k] for k in ("B", "kv", "hd", "heads", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")} for r in kern["paged_decode_moe"]],
     "verify_window": {k: kern["paged_window"][0][k] for k in ("B", "W", "starts", "kv", "ms", "w1_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}},
    # Head row: one MLP projection (in 2048, out 8192) at T=1, solo decode;
    # the per-step sums are in chip_smoke.json's int4_matmul_bound. The
    # gemma-2-9b, Qwen3-30B-A3B and DeepSeek-Coder-V2-Lite rows (T=1) count
    # toward the error too.
    {**entry("int4_matmul", "xotorch_support_jetson_tpu_torch/csrc/int4_matmul.cu", "xotorch_support_jetson_tpu/ops/pallas_int4.py:36", kern["int4_matmul"] + kern["int4_matmul_gemma2"] + kern["int4_matmul_moe"] + kern["int4_matmul_mla"] + kern["int4_matmul_llava"], k4_head),
     "llava_rows": [{k: r[k] for k in ("weight", "T", "d_in", "d_out", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")} for r in kern["int4_matmul_llava"]],
     "mla_rows": [{k: r[k] for k in ("weight", "T", "d_in", "d_out", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")} for r in kern["int4_matmul_mla"]],
     "moe_rows": [{k: r[k] for k in ("weight", "T", "d_in", "d_out", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")} for r in kern["int4_matmul_moe"]],
     "gemma2_rows": [{k: r[k] for k in ("weight", "T", "d_in", "d_out", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")} for r in kern["int4_matmul_gemma2"]]},
  ]}
  record = dict(card=smi, phase_s=phase_s, build_s=build_s, kernels=kern, serving=serving, quant=quant, spec=spec, graphs=graphs, batched=batched, batched_int4_weights=batched_int4, tiered=tiered, layouts=layouts, fetch=fetch, processes=processes, ring=ring, lora=lora, llava=llava, diffusion=diffusion, moe=moe_res, mla=mla_res, gemma2=gemma, summary=kernels_line)
  out = ROOT / "chiprun_out"
  out.mkdir(exist_ok=True)
  (out / "chip_smoke.json").write_text(json.dumps(record, indent=1, default=float))
  if not all(math.isfinite(x["ms"]) for x in kernels_line["kernels"]):
    raise SystemExit("chip_smoke: non-finite kernel time")
  print(json.dumps(kernels_line), flush=True)
  print(smi, flush=True)
  print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
