#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

It builds the port's kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a,
into ``build/repro_torch/``) and drives the training path and the serving
paths:

1. card     — the card's name and power limit as nvidia-smi gives them,
              then the build of every kernel (seconds, and the registers
              and spills of K3's bf16 <128, 128> and <192, 128>, of K4's
              split kernel <bf16, 128, 128>, of K5's bf16 split kernel
              <256, 32> and <512, 64> and of K6's bf16 chunk and output
              kernels at N = 128), and the count of tensor-core
              instructions (HMMA, HGMMA) in the SASS of K3's, K5's and
              K6's bf16 libraries where cuobjdump is on the machine; K1's
              and K2's registers and their loads in SASS (LDG, LDGSTS,
              UBLKCP/UTMALDG, the cp.async waits, and the first reader of
              each LDG);
2. returns  — K1 (n-step returns) against its plain PyTorch version on the
              card over E in {1, 8, 31, 32, 33, 256, 4096, 4097}, T in {1,
              5, 64}, on both sides of the short kernel's last T (16, 17)
              and around the longest chunk TC (TC - 1, TC, TC + 1, 2 TC +
              3), T=4096 at E=256 and misaligned views (one element past an
              aligned address) at E=256, gamma in {0, 0.99, 1}, dones at a
              10% rate plus an all-done and a never-done row (|err| <= 1e-5
              + 1e-5 |ref|, and bitwise: any nonzero error fails), with
              CUDA-event times (median of 30, L2 flushed) of the kernel,
              the plain version and the launch floor (an empty kernel of
              the same library at the same grid, launched the same way) at
              (T, E) = (5, 32), the training path's, (5, 256), (64, 4096)
              and (4096, 256), and the wrapper's host microseconds a call
              (1,000 calls on a busy card) at (5, 32);
   vtrace   — K2 (V-trace targets) the same way, over the same E and T
              around its own chunk, (rho_bar, c_bar) in {(1, 1), (2, 1),
              (1e9, 1e9), (inf, inf)} and gamma in {0, 0.99, 1}; rho =
              exp(N(0, 0.5)) with a row of rho = 50, dones at 10% with an
              all-done and a never-done row (bitwise; where unclipped c on
              the rho = 50 row overflows float32 in the plain version, the
              kernel must give the same inf or nan), timed at (5, 32), the
              one-actor pipeline's, (5, 8), (5, 256), (64, 4096) and
              (4096, 256);
3. kernels  — K3 and K4 against their plain versions on the card, at the
              serving paths' shapes and at the widths the TPU kernels
              take (K3 q/k and v 112/112 and 192/128, causal, ragged S,
              windowed, dbrx-132b's 48/8 heads and deepseek-v2-236b's
              full 128 MLA heads; K4 at D = 112, v narrower and wider
              than k, per-row pos from 0 to S - 1, S not a multiple of
              K4's split, 16 (glm4-9b, K4's GMAX), 6 (dbrx-132b) and 7
              (deepseek-coder-33b) query heads a KV head), in fp32 (atol
              1e-4) and bf16 (|err| <= 2e-2 + 2e-2 |ref| against the
              plain version in fp32 on the same bf16 inputs), with
              CUDA-event times of the kernel, the plain version and
              scaled_dot_product_attention (a yardstick only) for K3 at
              the 512-token prefills of qwen2-7b, dbrx-132b,
              deepseek-v2-236b and zamba2-7b (32/32 heads, D 112) and K4
              at W=8 S=1024 and at the serving decode steps of qwen2-7b,
              dbrx-132b and zamba2-7b (W=4 S=544, pos 256-264; zamba2's
              one query head a KV head); then K3 at MLA prefill's
              shape (B=1 S=512 H=40, q/k 96 wide, v 64), K5 at the
              decode shapes of minicpm3-4b (W=4 S=544 H=40 R=256
              Rr=32) and deepseek-v2-236b (H=128
              R=512 Rr=64), per-row and scalar pos (yardstick: SDPA on
              (q_lat || q_rope) against (c || kr) with v = c), and at the
              split design's edges (K5_EDGES: R = 512 with H = 128, H = 1
              and 17, S = 1, 63, 65, pos past the capacity, negative pos
              giving zeros), and K6 at mamba2-370m's prefill shape (B=1
              S=512 H=32 P=64 N=128, chunk 128; y and the final state,
              fp32 within 1e-4 + 1e-4 |ref|; no single PyTorch call
              computes it), at K6_EDGES (every N, chunks 7, 32, 100,
              128, two rows) and at zamba2-7b's prefill shape (H=112
              N=64), with the same tolerances and times; K3 also at
              pixtral-12b's prefill (B=4, 1024 patches + 512 tokens, 32/8
              heads of 128), seamless-m4t-large-v2's encoder (B=4 S=1024,
              16 heads of 64) and a windowed 512-token prefill (window
              256), and non-causal with Sq != Sk (the cross-attention:
              seamless's B=4 Sq=128 Sk=1024, timed; Sq < Sk and Sq > Sk
              ragged); then K4 and K5 with a window (F18: the TPU kernels
              take none) against their plain versions in fp32 and bf16,
              windows 1, 7, 64 and 256 on a cache of 1024 at a scalar pos
              not wrapped, one wrapped five times and per-row positions
              (one negative: zeros), K4 at G = 1, 4 and 7, K5 at
              minicpm3-4b's and deepseek-v2-236b's widths, each holding
              window 0 bitwise against window 1024 (the same slots); both
              timed at window 256 beside window 0 (W=4, pos 600-900);
              every K3 case also launched with its log-sum-exp: the
              output bitwise the launch without it, the LSE (B, Sq, H)
              fp32 within the same tolerances of the plain version's, and
              the time with the LSE beside the time without at the timed
              shapes; then K3's gradient (``ops.FlashAttention``: K3 with
              its LSE and the plain backward ``ref.flash_attention_bwd``)
              against autograd through the plain version in fp32 (atol
              1e-4 + rtol 1e-4 on dq, dk, dv) over FLASH_GRAD: GQA causal
              at qwen2-7b's training shape (B=4 T=512), windowed, MLA's
              96/64 (minicpm3-4b, B=4 T=512) and 192/128, non-causal with
              Sq < Sk and keys past one 512-key block; the backward alone
              timed in bf16 at the two training shapes beside autograd
              through the plain version and SDPA's backward; then K6's
              gradient (``ops.SSDScan``: K6, then the plain backward
              ``ref.ssd_scan_bwd``, exponents in float64) against autograd
              through the plain version in fp32 over SSD_GRAD: K6's y
              and state within 1e-4 (absolute and relative) of the
              plain version's, all six gradients with cotangents on y
              and on the state, finite and within 1e-4 (1 + max
              |grad|), at mamba2-370m's and
              zamba2-7b's training shapes (B=4 T=512, H 32 N 128 and H
              112 N 64), one chunk, and one chunk past e^88 of decay
              (F21: ``ssd_chunked``'s gradient is NaN there); the bf16
              y within 2e-2 and state within 1e-4 of the plain
              version's, and the forward with a gradient bitwise the one
              without; the
              forward and the backward alone timed in bf16 at the two
              training shapes beside autograd through the plain version;
4. rl_model — paac_nature at full size in fp32, one set of weights on the
              CPU and on the card: logits and values of 32 frames agree
              within 1e-4, and one PAAC update on the same replayed
              trajectory agrees within 1e-4 on the loss, the global grad
              norm (relative) and every new parameter;
5. training — the paper's setting through ``launch/paper_atari.py``'s code
              path: FrameStack(AtariLike(32)), paac_nature, t_max 5,
              RMSProp, lr 0.0224, seed 0; 10 warm-up iterations, then 200
              timed ones, which must launch K1 exactly once each, keep
              every loss finite, change the parameters and keep the mean
              entropy in (0, log 3]; timesteps/s and the wall of an
              iteration, then a torch.profiler window of 10 iterations
              (device-busy share, device time and launches by kernel
              class), then each layer of an iteration alone (env steps,
              acting forwards, learning pass, K1, optimizer: wall ms,
              device-busy ms, launches); then the entry point itself,
              ``paper_atari --arch paac_nature --n-envs 32 --iters 50``;
              then n_e = 256 for timesteps/s;
   pipeline — the pipelined actor/learner (``PipelinedRL``, device ring,
              thread actors) in the paper's setting (paac_nature,
              FrameStack(AtariLike(32)), fp32): (a) two same-seed
              ParallelRL runs agree bitwise, then lockstep at depth 1 with
              rho_bar = c_bar = inf for 20 iterations equals ParallelRL
              bitwise (metrics and every parameter) and launches K1 20
              times and K2 never (cuDNN deterministic for this part);
              (b) one actor at depth 2, clips 1: 10 warm-up and 200 timed
              updates, K2 launched 200 times and K1 never, losses finite,
              parameters changed, every (actor_id, seq) learned once,
              mean staleness > 0 and the largest <= depth + 1; (c) four
              actors of 8 envs at depth 4, the same checks but the
              staleness bound; timesteps/s, actor/learner idle and a
              profiler window (device-busy share, time two streams are
              busy at once) for (b), (c) and ParallelRL at n_e = 32; then
              ``paper_atari --arch paac_nature --n-envs 32 --iters 50
              --pipeline``;
   mesh     — the mesh rollout plane at mesh_shape 1 (one lane, the mesh
              ring, the sharded learner step) in the same setting: (a)
              lockstep at depth 1, clips 1, 20 updates equal to the device
              plane's bitwise (metrics and every parameter; cuDNN
              deterministic), K2 launched 20 times and K1 never; (b) the
              device and the mesh plane at depth 2 in turns (device, mesh,
              mesh, device), 60 timed updates after 10 warm-up each:
              updates/s, timesteps/s, staleness and learner idle, K2 60
              times a run, every lane seq learned once, the plain V-trace
              never called; (c) ``launch/train.py --arch paac_vector
              --pipeline --rollout-plane mesh --mesh 1 --iterations 20``
              (K2 20);
   agents   — the framework's other agents in the paper's setting
              (paac_nature, FrameStack(AtariLike(32)), fp32, RMSProp, lr
              0.0224, seed 0): (a) one update of DQN (a replayed batch of
              128, a target network unlike the params), lagged PAAC in
              "grad" and "act" mode (a replayed 5x32 trajectory, a stale
              copy unlike the params) and PPO (16x32, 4 epochs) on the CPU
              and on the card: the loss, the global grad norm (relative)
              and every new parameter within 1e-4; (b) each through
              ParallelRL: two same-seed runs of 10 iterations agree
              bitwise (cuDNN deterministic), then 10 warm-up and 50 timed
              iterations with every loss finite, the parameters changed,
              K1 launched once an iteration for lagged PAAC and never for
              DQN and PPO, K2 never; timesteps/s, DQN's replay bytes
              (50,000 transitions) and a profiler window of 10 iterations;
              (c) ``evaluate`` (3 seeds x 30 runs, greedy, max_steps 1,000)
              on the training phase's parameters: best_of_k, mean,
              per_seed and its wall time; (d) ``launch/train.py`` with
              ``--arch paac_vector --n-envs 32 --t-max 5 --iterations 50``,
              then with ``--pipeline`` and with ``--algo dqn``: K1 50
              times, K2 50 times and neither, each with its timesteps/s;
              (e) ``examples/compare_baselines_torch.py`` at 100
              iterations, its four scores in their order;
   host     — the paper's host env plane: a ``HostEnvPool`` of 32
              stand-in emulators (``FrameEnv``: 84x84x4 fp32 frames from
              numpy, 6 actions, ``delay`` s of GIL-free sleep a step) over
              8 worker threads, paac_nature fp32, RMSProp lr 0.0224, t_max
              5: (a) sync ``ParallelRL`` at delay 0, then at the update's
              time over (5 steps x 4 envs a worker) rounded up to 0.1 ms:
              10 warm-up and 100 timed iterations each, K1 once an
              iteration and K2 never, timesteps/s, the collect/update
              split, the update alone, a profiler window (busy share, H2D
              copies); (b) with cuDNN deterministic: two same-seed sync
              runs, lockstep ``PipelinedRL`` (depth 1, inf clips) on the
              same pool recipe and the forced host plane on
              FrameStack(AtariLike(32)) against ``ParallelRL``, bitwise;
              (c) ``PipelinedRL`` on the pool, clips 1, one actor at depth
              2 and four actors on its shards at depth 4, at both delays:
              100 timed updates, K2 once each and K1 never, every
              (actor_id, seq) learned once, staleness within the bound,
              idle shares, spans and busy share; (d) the GIL: one step of
              32 ``PyBoundEnv``s (spin 2000) on 8 workers and on 1, then
              ``launch/train.py --host-env`` sync (K1 50), ``--pipeline``
              (K2 50) and ``--pipeline --metrics-jsonl F --stall-timeout
              30`` (the heartbeat's lines carry the reference's keys); (e)
              ``HostEnvPool.step()`` tensors on the card unchanged by the
              next step, and staging sets overwritten with NaN when
              released change no lockstep update (bitwise); (f) the
              four-actor cell at delay 0 again under
              ``sys.setswitchinterval(0.0005)`` (restored after), its
              timesteps/s and learner update span beside the default's;
              the process actor plane (``actor_backend="process"``:
              spawned workers, each its own interpreter and CUDA context,
              over shared-memory staging sets and a shared-memory param
              slot), on ``HostEnvSpec``s of the same 32 ``FrameEnv``s:
              (g) one worker at depth 2 and four of 8 envs at depth 4,
              clips 1, at both delays: 100 timed updates, K2 once each
              and K1 never, every (actor_id, seq) learned once,
              timesteps/s beside sync and the thread plane, the learner's
              update span and idle share, staleness, the workers' shipped
              spans, the card memory a worker takes, a profiler window of
              the parent's device work (busy share, H2D ms a payload from
              pageable shared memory), and after close() no worker alive
              and no segment of the plane left in /dev/shm; (h) 32
              ``PyBoundEnv``s (spin 2000) on 1, 2, 4 and 8 workers:
              timesteps/s and the workers' own stepping rate; (i) lockstep
              (depth 1, inf clips) on one worker ≡ the thread host plane,
              bitwise with the acting generator's state; (j)
              ``launch/train.py --pipeline --actor-backend process
              --host-env`` (K2 50);
   replay   — the replay plane in the paper's setting (paac_nature,
              FrameStack(AtariLike(32)), fp32): (a) with cuDNN
              deterministic, depth-1 lockstep pipelined DQN ≡
              ``SyncReplayDQN`` over two runs (no kernel), and PAAC at
              capacity 1 (staleness 0) ≡ the FIFO device plane's lockstep
              run at clips 1 (K2) and ≡ ``ParallelRL`` at clips inf; (b)
              one actor on a ring of 64 rollouts (21.7 MB each, ~1.4 GB
              when full): DQN, DQN prioritized at batch 2 and V-trace
              PAAC, 100 timed updates each (K2 once a PAAC update, none for
              DQN), timesteps/s, staleness, learner idle, the update and
              sample spans, peak device memory; (c) ``launch/train.py
              --pipeline --replay`` (K2 50) and ``--pipeline --algo dqn
              --replay`` (none) on TokenEnv;
   faults   — fault tolerance in the paper's setting (paac_nature,
              84x84x4 fp32 frames, n_e = 32, t_max 5, RMSProp lr
              0.0007 n_e): (a) with cuDNN deterministic, depth-1 lockstep
              on the thread device plane, 12 updates, a checkpoint every
              4 and an injected kill after 9 rollouts, then a resume from
              the newest checkpoint: params, RMSProp state and total_steps
              bitwise the uninterrupted run's and the seqs continued, at
              clips inf (K1) and 1 (K2); (b) four actors of 8 envs,
              elastic, an "error" kill of slot 1: the full quota, each
              (actor_id, seq) once, one respawn, timesteps/s beside the
              same call's run with no fault, detect -> respawn from the
              fault.* spans; (c) restart_budget 0: the survivors absorb
              the dead slot's quota; (d) a process plane of four workers
              on a HostEnvSpec of 32 FrameEnvs: an "error" kill (the child
              reused), then an "exit" kill (one fresh spawn), each timed
              beside the un-faulted run, and after close() no worker
              alive and no segment in /dev/shm, graveyard included; (e) a
              dropped release and a 0.5 s learner stall on the thread
              host plane: the run completes and the stall shows in the
              actor's waits; (f) a pipeline checkpoint's ms and bytes,
              its share of the learner's time at checkpoint_every = 100,
              and its round trip on the card (each tensor on its device,
              bitwise); (g) ``launch/train.py --pipeline --elastic
              --fault-kill 0:3 --checkpoint-dir D --checkpoint-every 10``
              (K2 50), then ``--resume`` on D (K2 25: the remainder) and
              ``--checkpoint D2`` on the synchronous path (K1 50);
   analysis — the analysis plane (``repro_torch.analysis``) in the same
              setting: (a) ``python -m repro_torch.analysis.lint`` and the
              reference's ``python -m repro.analysis.lint`` (run as a file
              tool) over ``src/repro_torch``, both clean; (b) four thread
              actors of 8 envs at depth 4, clips 1, 100 timed updates under
              ``locks,transfers`` in turns with the same run unsanitized
              (off, on, on, off): K2 100 a run, the learner's 99 guarded
              iterations and the guarded collects, 200 in-place probes, a
              clean lock-order report, timesteps/s on and off; depth-1
              lockstep sanitized ≡ unsanitized bitwise at clips 1 (K2)
              and (c) at clips inf (K1), cuDNN deterministic; a process
              plane of four ``FrameEnv`` workers, sanitized, 60 updates
              (K2), the shm slot's ``mp`` condition wrapped; (d) pipelined
              replay DQN, capacity 16, batch 2, 50 updates, no kernel;
              ``launch/train.py --pipeline --sanitize locks,transfers`` at
              the reference CI's shape for PAAC (K2 8) and replay DQN; (e)
              the sync mode read on another thread, which host-sync forms
              torch reports inside a guard, a guarded thread's ``.item()``
              refused while another thread's ``.cpu()`` passes at once,
              the thread host plane's learner guarded while its actor reads
              back, a stray ``.item()`` in the learner step raising on the
              learner, and a lock inversion between two sites on two
              threads flagged as a cycle; every ``allowed`` edge that fired
              with its count; (f) ``launch/serve.py --arch qwen2-7b
              --continuous --requests 8 --slots 4 --prompt-len 512 --gen
              32`` with and without ``--trace``/``--metrics-jsonl`` in
              turns (K3, K4): tokens bitwise equal, the trace's admit,
              prefill and decode spans, at least 2 heartbeat lines with
              ``serve_queue_depth``, tok/s and p50/p99 on and off;
6. model    — reduced qwen2-7b, glm4-9b, deepseek-coder-33b, minicpm3-4b
              (absorbed and naive decode), mamba2-370m, dbrx-132b,
              deepseek-v2-236b (absorbed and naive; both MoE trunks at
              capacity factor 16) and zamba2-7b (5 layers: two groups of
              2 and a tail of 1; also with 4 experts, top 2, its shared
              block dense at the config's d_ff and an MoE block of
              128-wide experts at d_ff 0, cf 16, each with one
              make_llm_train_step card vs CPU within 1e-4, moe_aux 0) in
              fp32, one set of weights on the CPU
              (plain versions) and on the card (kernels): prefill and
              four decode steps (per-row and scalar pos) must agree within
              1e-4 on the logits, and each kernel of the path must launch
              once a layer a call (zamba2: K6 once a Mamba2 layer, K3 and
              K4 once an application of the shared block), every other
              kernel never; also qwen2-7b and minicpm3-4b (absorbed) with
              a window of 16 (a ring the prompt wraps), pixtral-12b (8
              patches before the text) and seamless-m4t-large-v2 (16
              frames through the encoder; K3 once an encoder layer and
              twice a decoder layer, K4 twice a decoder layer);
   token training — right after phase 1: (a) qwen2-7b at every
              published width (d_model 3584, 28/4 heads, d_ff 18944,
              vocab 152064, bf16, remat "full") cut to 13 of 28 layers
              and minicpm3-4b (d_model 2560, 40 MLA heads, vocab 73448)
              cut to 58 of 62, the depth one card holds under the
              functional RMSProp update, mamba2-370m at full depth (48
              layers) and zamba2-7b cut to 45 of 81 (7 groups of 6 and
              the tail of 3), each in a fresh process
              (``--train-cell``, expandable segments: a cell needs ~77 GB
              and one long process fragments), 4 steps at B=4 T=512
              through ``launch/train.py``'s synthetic code: K3 exactly
              twice an attention layer (zamba2: a group) a step (the
              forward and remat's recompute) and its backward once, K6
              twice a Mamba2 layer a step and its backward once, K1 once,
              nothing else; tokens/s,
              a step's wall ms, a profiled step's busy ms, the peak
              memory, every loss and global grad norm finite and the loss
              changing; (b) one ``make_llm_train_step`` (RMSProp) of
              reduced qwen2-7b, minicpm3-4b, dbrx-132b, deepseek-v2-236b,
              pixtral-12b and seamless-m4t-large-v2 in fp32 on the card
              (K3 with its LSE and backward, K1) and on the CPU from the
              same weights and batch (also mamba2-370m and zamba2-7b: K6
              and its backward): metrics and new parameters within
              1e-4, K3 once an attention layer, K6 once a Mamba2 layer and
              K1 once; (c) one step
              each of reduced dbrx-132b and deepseek-v2-236b in bf16 with
              remat, and of pixtral-12b (1024 patches + 128 tokens) and
              seamless-m4t-large-v2 (1024 frames, 128 tokens) at every
              published width cut to 2 (2 + 2) layers;
   token cli — ``launch/train.py --arch qwen2-7b --reduced --iterations
              20`` (K1 20), the same with ``--pipeline`` (K2 20) and
              ``--mode synthetic --iterations 5 --t-max 64`` (K1 5, K3 10),
              each with K3 launched; ``--arch mamba2-370m --reduced``
              (K1 20, K6), ``--arch zamba2-7b --reduced --pipeline`` (K2
              20, K6, K3) and ``--mode synthetic --arch zamba2-7b
              --reduced --t-max 64`` (K1 5, K6 10, K3 5); the reference's
              default command, ``--iterations 20`` with no ``--arch``
              (mamba2-370m at full width on the TokenEnv: K1 20, K6; its
              timesteps/s); and ``examples/train_llm_rl_torch.py --smoke``
              (300 iterations, K1 300);
7. serving  — six cells, each at full width with random bf16 weights
              from a seed: qwen2-7b (28 layers, d_model 3584; K3
              prefill, K4 decode), minicpm3-4b with the absorbed decode
              (31 of 62 layers, d_model 2560, MLA; K3 prefill with q/k 96
              and v 64 wide, K5 decode), mamba2-370m (48 layers, d_model
              1024; K6 prefill, recurrent decode in plain PyTorch), and
              the MoE cells at the depth one card holds: deepseek-v2-236b
              (8 of 60 layers: the dense first layer and 7 MoE layers of
              160 experts, top-6, 2 shared; MLA with the absorbed decode; K3
              with q/k 192 and v 128, K5 at R 512) and dbrx-132b (8 of 40
              layers, 16 experts, top-4; K3, K4), and the hybrid
              zamba2-7b cut to 45 of 81 layers (7 groups of 6 Mamba2
              layers, each followed by the one shared attention block, 32
              heads of 112, and the tail of 3; K6 45 and K3 7 times a
              prefill, K4 7 times a step). Each: the peak memory of the
              init beside the parameters' bytes (at most 12 GB over;
              zamba2: one group of Mamba2 layers), 8 requests over 4
              slots, prompts of 128 to 512 tokens (whole 128-token chunks
              for mamba2 and zamba2), 16 to 32 new
              tokens each, burst arrival, through the port's
              continuous-batching entry point after a warm-up; every
              request must finish with tokens in [0, vocab), the prefill
              kernel must launch once a layer per admitted request, the
              decode kernel once a layer per decode step and every other
              kernel never, and one request rerun alone on a fresh engine
              must give bitwise the same tokens (an MoE cell: on a second
              continuous call at capacity factor E / k, where no
              assignment can drop, after the timed one at the published
              1.25; and an admit and a decode step under the transfers
              guard with no host sync, and the share of a step's
              assignments dropped at 1.25; zamba2: the same guarded
              admit and step); a torch.profiler window of 8
              decode steps gives the device-busy share of a step and the
              decode kernel's share of it (an MoE cell: also its MoE
              layers alone, CUDA events, beside the bound of reading
              their weights; zamba2: its Mamba2 layers alone in a
              profiler window), one of 3 prefills of 512 tokens the
              prefill's device time and each prefill kernel's share; then
              the lockstep demo, whose decode runs with a scalar
              position. zamba2 ends with F14 at full width in fp32 (TF32
              off): its prefill of 256 tokens and 8 decode steps against
              a decode loop over the 264 tokens from the zero cache,
              logits within 1e-3 + 1e-3 |logit|. qwen2-7b, minicpm3-4b
              and zamba2-7b then serve the same parameters with a sliding
              window of 256, a functional check at no published window
              (``window_cell``: rings of 256 slots, four
              requests of prompts 128, 200, 333 and 512 tokens, zamba2
              128 and 512, 64 new tokens each, so the ring wraps in the
              prefill and in the decode; launches, tok/s, peak memory, a
              profiled step's busy share and its decode kernel's share),
              and qwen2-7b checks the window in fp32 at full width cut to
              4 layers (``window_parity``: prefill of 333 tokens + 16
              steps vs the decode loop, on the ring and with window=64 a
              call on a full cache, 1e-3 + 1e-3 |logit|);
8. prefixed — pixtral-12b (all 40 layers, ~24.5 GB) and
              seamless-m4t-large-v2 (24 + 24 layers) at every published
              width through ``policy_prefill`` with ``prefix_embeds`` and
              ``policy_decode`` (the engine refuses both, as the
              reference's does): four rows, 1024 random patch or frame
              embeddings of width 1024, text of 128 and 512 (pixtral) or
              64 and 128 tokens (seamless), 32 lockstep greedy steps each;
              K3 once a layer a prefill (seamless: 24 encoder, 24 self, 24
              cross), K4 once a layer a step (seamless: twice); prefill
              ms, ms a step, tok/s, a profiled step's busy share; then
              seamless in fp32 at 2 + 2 layers (``encdec_parity``: prefill
              of 64 tokens + 8 steps vs a one-token prefill and the decode
              loop, 1e-3 + 1e-3 |logit|).

TF32 is off for matmuls and convolutions throughout. The line before the
last is a JSON object with each kernel's numbers and its launches on each
main path (training, pipeline, mesh, mesh train cli, agents, train cli,
host sync, host pipeline, host train cli, host process, host process
train cli, replay, replay train cli, faults, faults train cli, the analysis legs, token
training, the token cli legs and the token example, the six serving
cells, the three window cells and the two prefixed cells, each read with
the counts set to 0 just before it); K3's row also carries its time with
the LSE, the LSE's error and, under ``"backward"``, the plain backward's
numbers and its calls on each path, and so does K6's;
the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or when any
phase fails, it exits non-zero and prints no result. ``--trace-dir DIR``
also writes the pipeline runs' Chrome traces (actor, ring and learner
spans) there.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; fp32 off the tensor cores
FP32_ATOL = 1e-4
BF16_TOL = 2e-2
MODEL_ATOL = 1e-4
SSD_TOL = 1e-4  # K6 fp32, absolute and relative: C.B^T sums reach |y| ~ 100
RETURNS_TOL = 1e-5
RL_TOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


SPIN_CYCLES = 1_000_000  # ~0.5 ms of the card's clock


def time_ms(torch, fn, flush, iters: int = 30) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` launches, each after
    an L2 flush (the serving path meets each layer's cache cold) and a spin
    of the card (``torch.cuda._sleep``) that lasts longer than the host
    takes to enqueue ``fn``: the start event then fires when ``fn``'s
    launches already wait in the stream, so a wrapper's host time is not
    counted as the kernel's."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def host_us(torch, fn, calls: int = 1000, batch: int = 100) -> float:
    """Host microseconds a call of ``fn``: ``calls`` calls in batches of
    ``batch``, each batch enqueued while the card spins (~10 ms, longer
    than a batch takes to enqueue), so no call waits on the card, and no
    synchronize between the calls of a batch."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // batch):
        torch.cuda._sleep(20 * SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / calls * 1e6


def floor_launch(torch, build, lib: str, shape, T: int, E: int):
    """A function that launches ``lib``'s empty kernel (``<lib>_floor``) at
    the grid, block and shared memory of its real launch at (T, E), through
    ctypes on the current stream, as the wrapper launches the real one: the
    launch floor of a K1 or K2 time."""
    import ctypes

    fn = getattr(build.library(lib), f"{lib}_floor")
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tile, chunk, _, _ = shape(T, E)

    def launch():
        rc = fn(T, E, tile, chunk, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"{lib}_floor launch failed: CUDA error {rc}")
    return launch


def bound(nbytes: float, flops: float, dtype: str):
    """(least time in ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_pairs(np, Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave visible."""
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    return int(mask.sum())


def tolerance(dtype: str) -> str:
    return (f"atol {FP32_ATOL}" if dtype == "float32" else
            f"atol {BF16_TOL} + rtol {BF16_TOL}")


def within(torch, out, ref, dtype: str) -> float:
    err = (out.float() - ref).abs()
    if dtype == "float32":
        ok = bool((err <= FP32_ATOL).all())
    else:
        ok = bool((err <= BF16_TOL + BF16_TOL * ref.abs()).all())
    check(bool(torch.isfinite(out.float()).all()), "non-finite kernel output")
    check(ok, f"kernel disagrees with its plain version: max err {err.max().item():.3g}")
    return err.max().item()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_card(torch, build):
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = out.splitlines()[0]
    print(card, flush=True)
    say("card", f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"device 0: {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.library(name)
        regs = [ln.strip() for ln in build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln]
        took = build.build_seconds.get(name)
        say("card", f"built {name}"
            + (f" (nvcc done {took:.1f} s after the build began)" if took else
               " (reused)") + ": " + " | ".join(regs[:4]))
    say("card", f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for src, keys in (("flash_attention_bf16", ("ILi128ELi128E", "ILi192ELi128E")),
                      ("decode_attention", ("I13__nv_bfloat16Li128ELi128E",)),
                      ("mla_decode_bf16", ("ILi256ELi32E", "ILi512ELi64E")),
                      ("ssd_scan_bf16", ("chunk_kernelILi128E",
                                         "out_kernelILi128E"))):
        for key, line in ptxas_lines(build, src, keys):
            say("card", f"{src} {key} {line}")
    for src in ("flash_attention_bf16", "mla_decode_bf16", "ssd_scan_bf16"):
        sass_counts(build, src)
    for src, kernels in (("nstep_returns", ("nstep_kernel",
                                            "nstep_short_kernel")),
                         ("vtrace", ("vtrace_kernel", "vtrace_short_kernel"))):
        for key, line in ptxas_lines(build, src, kernels):
            say("card", f"{src} {key} {line} (dynamic shared memory: "
                "launch_shape's smem_bytes, printed with each time)")
        for kernel in kernels:
            sass_loads(build, src, kernel)
    return card


def ptxas_lines(build, name: str, keys):
    """(instantiation key, "registers | spills") of ``name``'s build log for
    each mangled template key given, e.g. "ILi128ELi128E" for <128, 128>."""
    lines = build.build_log(name).splitlines()
    out = []
    for key in keys:
        for i, ln in enumerate(lines):
            if "Compiling entry" in ln and key in ln:
                info = [x.strip() for x in lines[i + 1:i + 4]
                        if "registers" in x or "spill" in x]
                out.append((f"<{key}>", " | ".join(info)))
                break
    return out


def sass_counts(build, name: str) -> None:
    """Tensor-core instructions in ``name``'s library, where cuobjdump is on
    the machine: HMMA (mma.sync) and HGMMA (wgmma)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        say("card", f"{name}: cuobjdump not found; SASS not inspected")
        return
    sass = subprocess.run([tool, "-sass", str(build.target(name))],
                          capture_output=True, text=True, check=True).stdout
    hmma = sum(1 for ln in sass.splitlines() if "HMMA" in ln)
    hgmma = sum(1 for ln in sass.splitlines() if "HGMMA" in ln)
    check(hmma + hgmma > 0, f"{name}: no tensor-core instruction in its SASS")
    say("card", f"{name} SASS: {hmma} HMMA, {hgmma} HGMMA instructions")


SASS_LOADS = ("LDG", "LDGSTS", "LDGDEPBAR", "DEPBAR", "UBLKCP", "UTMALDG",
              "LDS", "STS", "STG", "BAR")


def sass_loads(build, name: str, kernel: str) -> None:
    """The loads of ``kernel`` in ``name``'s SASS, where cuobjdump is on the
    machine: the counts of LDG (a load into registers), LDGSTS (cp.async),
    UBLKCP/UTMALDG (bulk and TMA copies) and the rest of SASS_LOADS, each
    DEPBAR (a wait on the cp.async groups) as written, and for each LDG the
    first later instruction that reads its register: what that load's
    latency stalls."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        say("card", f"{name}: cuobjdump not found; SASS not inspected")
        return
    sass = subprocess.run([tool, "-sass", str(build.target(name))],
                          capture_output=True, text=True, check=True).stdout
    body, inside = [], False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = f"{len(kernel)}{kernel}E" in ln  # the mangled name
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?)\s*;", ln)
        if inside and m:
            body.append(m.group(1))

    def opcode(ins):
        words = ins.split()
        return words[1] if words[0].startswith("@") else words[0]

    counts = {op: sum(1 for ins in body if opcode(ins).split(".")[0] == op)
              for op in SASS_LOADS}
    check(body, f"{name}: {kernel} not found in its SASS")
    waits = sorted({ins for ins in body if opcode(ins).startswith("DEPBAR")})
    consumers = []
    for i, ins in enumerate(body):
        if opcode(ins).split(".")[0] != "LDG":
            continue
        operands = ins.split(None, 2 if ins.startswith("@") else 1)[-1]
        reg = re.search(r"\bR\d+\b", operands).group(0)
        use = next((f"{opcode(nxt)} (+{j})" for j, nxt in
                    enumerate(body[i + 1:], 1)
                    if re.search(rf"\b{reg}\b", nxt)), "none")
        consumers.append(f"{opcode(ins)} {reg} -> {use}")
    say("card", f"{name} SASS {kernel}: " + ", ".join(
        f"{n} {op}" for op, n in counts.items()) + f"; waits: {waits}")
    say("card", f"{name} SASS {kernel} LDG -> first reader: " + "; ".join(consumers))


FLASH_SWEEP = (  # (B, S, H, Hkv, D, Dv, window, timed in bf16 as), causal
    (1, 512, 28, 4, 128, 128, 0, "qwen2-7b prefill"),
    (1, 77, 28, 4, 128, 128, 0, ""),   # ragged S
    (1, 512, 28, 4, 128, 128, 100, ""),
    (1, 333, 16, 4, 112, 112, 0, ""),  # zamba2-7b's width, ragged S
    (1, 200, 16, 4, 112, 112, 64, ""),
    (1, 130, 16, 16, 192, 128, 0, ""),  # deepseek-v2's MLA prefill, ragged S
    (1, 300, 16, 16, 192, 128, 90, ""),
    # the MoE serving cells' prefills: dbrx-132b's GQA heads and
    # deepseek-v2-236b's full MLA heads (q/k 192, v 128)
    (1, 512, 48, 8, 128, 128, 0, "dbrx-132b prefill"),
    (1, 333, 48, 8, 128, 128, 0, ""),
    (1, 512, 128, 128, 192, 128, 0, "deepseek-v2-236b prefill"),
    # zamba2-7b's shared attention block: 32 query heads over 32 KV heads
    (1, 512, 32, 32, 112, 112, 0, "zamba2-7b prefill"),
    # the window cells' 512-token prefill into a ring of 256
    (1, 512, 28, 4, 128, 128, 256, "qwen2-7b prefill, window 256"),
    # pixtral-12b: 1024 patches + 512 text tokens, four rows; the
    # seamless-m4t-large-v2 encoder over 1024 frames (causal, F17)
    (4, 1536, 32, 8, 128, 128, 0, "pixtral-12b prefill"),
    (4, 1024, 16, 16, 64, 64, 0, "seamless-m4t-large-v2 encoder"),
)
FLASH_CROSS = (  # (B, Sq, Sk, H, Hkv, D, timed in bf16 as), non-causal
    (4, 128, 1024, 16, 16, 64, "seamless-m4t-large-v2 cross prefill"),
    (2, 37, 300, 32, 8, 128, ""),  # ragged, Sq < Sk
    (1, 200, 90, 16, 4, 112, ""),  # Sq > Sk
)
DECODE_SWEEP = (  # (W, S, H, Hkv, D, Dv, pos, timed in bf16 as)
    (8, 1024, 28, 4, 128, 128, [0, 1, 63, 64, 300, 777, 1000, 1023],
     "qwen2-7b W=8"),
    (8, 1024, 28, 4, 128, 128, 600, ""),
    # qwen2-7b's serving decode step: 4 rows at pos 256-264 of a cache of
    # max_len = 512 + 32 slots, as phase 7's engine allocates it
    (4, 544, 28, 4, 128, 128, [256, 259, 262, 264],
     "qwen2-7b serving decode step"),
    (4, 544, 28, 4, 128, 128, [127, 250, 399, 543], ""),
    (4, 300, 16, 4, 112, 112, [0, 63, 64, 299], ""),  # S % SPLIT != 0
    (4, 300, 16, 4, 112, 64, [299, 0, 150, 65], ""),  # v narrower than k
    (3, 100, 16, 2, 64, 112, [99, 0, 40], ""),  # v wider than k
    (2, 40, 16, 4, 112, 128, 39, ""),  # S below one split, scalar pos
    # 16 query heads a KV head (glm4-9b, K4's GMAX), 6 (dbrx-132b's
    # serving decode step) and 7 (deepseek-coder-33b)
    (4, 544, 32, 2, 128, 128, [127, 250, 399, 543], ""),
    (4, 544, 48, 8, 128, 128, [256, 259, 262, 264],
     "dbrx-132b serving decode step"),
    (4, 544, 56, 8, 128, 128, [0, 250, 399, 543], ""),
    # zamba2-7b's serving decode step: one query head a KV head (G = 1)
    (4, 544, 32, 32, 112, 112, [256, 259, 262, 264],
     "zamba2-7b serving decode step"),
)


def lse_check(torch, fa, q, k, v, out, plain_lse, dtype: str, *,
              causal: bool, window: int) -> float:
    """K3 launched again with the LSE: its output must be bitwise ``out``
    (the launch without one) and its LSE within ``within``'s tolerance of
    the plain version's. Returns the LSE's max error."""
    out_l, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window, return_lse=True)
    check(torch.equal(out_l, out), "K3's output with the lse differs from "
          "its output without it")
    check(lse.dtype == torch.float32 and lse.shape == plain_lse.shape,
          f"K3 lse {lse.dtype} {tuple(lse.shape)}")
    return within(torch, lse, plain_lse, dtype)


def phase_kernels(torch, np, F, ref, fa, da):
    """K3 and K4 against their plain versions on the card over their sweeps
    (qwen2-7b's shapes and the widths of the TPU kernels), and timed at the
    serving path's shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(getattr(torch, dtype))

    rows = {}
    for dtype in ("float32", "bfloat16"):
        for B, S, H, Hkv, D, Dv, window, timed in FLASH_SWEEP:
            q = randn(B, S, H, D, dtype=dtype)
            k = randn(B, S, Hkv, D, dtype=dtype)
            v = randn(B, S, Hkv, Dv, dtype=dtype)
            out = fa.flash_attention_cuda(q, k, v, causal=True, window=window)
            check(tuple(out.shape) == (B, S, H, Dv), f"K3 out {tuple(out.shape)}")
            plain, plain_lse = ref.flash_attention_ref(
                q.float(), k.float(), v.float(), causal=True, window=window,
                return_lse=True)
            err = within(torch, out, plain, dtype)
            lse_err = lse_check(torch, fa, q, k, v, out, plain_lse, dtype,
                                causal=True, window=window)
            say("kernels", f"K3 flash_attention {dtype} B={B} S={S} H={H} "
                f"Hkv={Hkv} D={D} Dv={Dv} causal window={window}: max_abs_err "
                f"{err:.3g}, lse {lse_err:.3g} ({tolerance(dtype)}); output "
                "with the lse bitwise the output without")
            row = rows.setdefault("flash_attention", {"max_abs_err": 0.0,
                                                      "lse_max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["lse_max_abs_err"] = max(row["lse_max_abs_err"], lse_err)
            if dtype == "bfloat16" and timed:
                ms = time_ms(torch, lambda: fa.flash_attention_cuda(
                    q, k, v, window=window), flush)
                lse_ms = time_ms(torch, lambda: fa.flash_attention_cuda(
                    q, k, v, window=window, return_lse=True), flush)
                plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(
                    q, k, v, window=window), flush)
                qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                if window:  # SDPA takes no window: the mask, made once
                    i = torch.arange(S, device=dev)
                    wmask = ((i[None, :] <= i[:, None])
                             & (i[None, :] > i[:, None] - window))
                    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=wmask, enable_gqa=True), flush)
                else:
                    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True), flush)
                nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
                flops = 2 * (D + Dv) * flash_pairs(np, S, S, True, window) * H * B
                b_ms, b_by = bound(nbytes, flops, dtype)
                t = dict(ms=ms, lse_ms=lse_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         shape=f"bf16 B={B} S={S} H={H} Hkv={Hkv} D={D} "
                         f"Dv={Dv} causal window={window} ({timed})")
                if "ms" in row:  # a later timed shape, beside the first
                    row.setdefault("other", []).append(t)
                else:
                    row.update(t)
                say("kernels", f"K3 timed ({t['shape']}): kernel {ms:.4f} ms, "
                    f"with the lse {lse_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    for dtype in ("float32", "bfloat16"):
        for B, Sq, Sk, H, Hkv, D, timed in FLASH_CROSS:
            q = randn(B, Sq, H, D, dtype=dtype)
            k, v = randn(B, Sk, Hkv, D, dtype=dtype), randn(B, Sk, Hkv, D, dtype=dtype)
            out = fa.flash_attention_cuda(q, k, v, causal=False)
            check(tuple(out.shape) == (B, Sq, H, D), f"K3 out {tuple(out.shape)}")
            plain, plain_lse = ref.flash_attention_ref(
                q.float(), k.float(), v.float(), causal=False,
                return_lse=True)
            err = within(torch, out, plain, dtype)
            lse_err = lse_check(torch, fa, q, k, v, out, plain_lse, dtype,
                                causal=False, window=0)
            row = rows["flash_attention"]
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["lse_max_abs_err"] = max(row["lse_max_abs_err"], lse_err)
            say("kernels", f"K3 flash_attention {dtype} B={B} Sq={Sq} Sk={Sk} "
                f"H={H} Hkv={Hkv} D={D} non-causal (cross): max_abs_err "
                f"{err:.3g}, lse {lse_err:.3g} ({tolerance(dtype)}); output "
                "with the lse bitwise the output without")
            if dtype == "bfloat16" and timed:
                ms = time_ms(torch, lambda: fa.flash_attention_cuda(
                    q, k, v, causal=False), flush)
                plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(
                    q, k, v, causal=False), flush)
                qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=True), flush)
                nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
                b_ms, b_by = bound(nbytes, 2 * 2 * D * Sq * Sk * H * B, dtype)
                t = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         shape=f"bf16 B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} "
                         f"D={D} non-causal ({timed})")
                rows["flash_attention"].setdefault("other", []).append(t)
                say("kernels", f"K3 timed ({t['shape']}): kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                    f"{b_ms:.4f} ms ({b_by})")

    for dtype in ("float32", "bfloat16"):
        for W, S, H, Hkv, D, Dv, pos, timed in DECODE_SWEEP:
            q = randn(W, H, D, dtype=dtype)
            kc = randn(W, S, Hkv, D, dtype=dtype)
            vc = randn(W, S, Hkv, Dv, dtype=dtype)
            p = (torch.tensor(pos, dtype=torch.int32, device=dev)
                 if isinstance(pos, list) else pos)
            out = da.decode_attention_cuda(q, kc, vc, p)
            check(tuple(out.shape) == (W, H, Dv), f"K4 out {tuple(out.shape)}")
            plain = ref.decode_attention_ref(q.float(), kc.float(), vc.float(), p)
            err = within(torch, out, plain, dtype)
            say("kernels", f"K4 decode_attention {dtype} W={W} S={S} H={H} "
                f"Hkv={Hkv} D={D} Dv={Dv} pos={pos}: max_abs_err {err:.3g} "
                f"({tolerance(dtype)})")
            row = rows.setdefault("decode_attention", {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if dtype == "bfloat16" and timed:
                ms = time_ms(torch, lambda: da.decode_attention_cuda(q, kc, vc, p), flush)
                plain_ms = time_ms(torch, lambda: ref.decode_attention_ref(q, kc, vc, p), flush)
                mask = (torch.arange(S, device=dev)[None, :] <= p[:, None])[:, None, None, :]
                q4, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
                lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q4, kt, vt, attn_mask=mask, enable_gqa=True), flush)
                keys = sum(min(x + 1, S) for x in pos)
                nbytes = 2 * (q.numel() + out.numel() + keys * Hkv * (D + Dv)) + 4 * W
                flops = 2 * H * (D + Dv) * keys
                b_ms, b_by = bound(nbytes, flops, dtype)
                t = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         shape=f"bf16 W={W} S={S} H={H} Hkv={Hkv} D={D} "
                         f"pos={pos} ({timed})")
                if "ms" in row:  # a later timed shape, beside the first
                    row.setdefault("other", []).append(t)
                else:
                    row.update(t)
                say("kernels", f"K4 timed ({t['shape']}): kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                    f"{b_ms:.4f} ms ({b_by})")
    del flush
    return rows


def within_rel(torch, out, ref, atol: float, rtol: float, what: str) -> float:
    """Max |out - ref|; fails unless every |out - ref| <= atol + rtol |ref|."""
    err = (out.float() - ref).abs()
    check(bool(torch.isfinite(out.float()).all()), f"{what}: non-finite output")
    check(bool((err <= atol + rtol * ref.abs()).all()),
          f"{what} disagrees with its plain version: max err "
          f"{err.max().item():.3g}")
    return err.max().item()


K5_EDGES = (  # (W, S, H, R, Rr, per-row pos)
    (2, 544, 128, 512, 64, [543, 100]),  # deepseek-v2's widths
    (3, 65, 17, 128, 16, [64, -1, 31]),  # H % 16 != 0, S just past a split
    (2, 63, 40, 32, 32, [62, 0]),        # S below one split, R = 32
    (1, 1, 1, 64, 64, [0]),              # one slot, one head
    (2, 100, 40, 256, 32, [5000, -3]),   # pos past the capacity: all slots
)
K6_EDGES = (  # (B, S, H, N, chunk)
    (2, 200, 6, 16, 100),
    (2, 96, 8, 32, 32),
    (2, 21, 4, 64, 7),
    (2, 256, 4, 128, 128),
)


def phase_latent_kernels(torch, np, F, ref, fa, mk, sk, rows, dev="cuda"):
    """K3 at MLA prefill's shape, K5 at minicpm3-4b's decode shape and K6 at
    mamba2-370m's prefill shape, against their plain versions on the card,
    then timed as ``phase_kernels`` times K3 and K4. Adds to ``rows``."""
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)

    def randn(*shape, dtype="float32"):
        return torch.randn(*shape, generator=g, device=dev).to(getattr(torch, dtype))

    # K3 as MLA prefill runs it: q/k 96 wide (qk_nope 64 + qk_rope 32), v 64
    B, S, H, D, Dv = 1, 512, 40, 96, 64
    k3 = rows["flash_attention"]
    for dtype in ("float32", "bfloat16"):
        q, k = randn(B, S, H, D, dtype=dtype), randn(B, S, H, D, dtype=dtype)
        v = randn(B, S, H, Dv, dtype=dtype)
        out = fa.flash_attention_cuda(q, k, v, causal=True)
        check(tuple(out.shape) == (B, S, H, Dv), f"K3 MLA out {tuple(out.shape)}")
        plain = ref.flash_attention_ref(q.float(), k.float(), v.float())
        err = within(torch, out, plain, dtype)
        k3["max_abs_err"] = max(k3["max_abs_err"], err)
        say("kernels", f"K3 flash_attention {dtype} MLA B={B} S={S} H={H} D={D} "
            f"Dv={Dv} causal: max_abs_err {err:.3g} ({tolerance(dtype)})")
    ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v), flush)
    plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v), flush)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), flush)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
    flops = 2 * (D + Dv) * flash_pairs(np, S, S, True, 0) * H * B
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    shape = f"bf16 B={B} S={S} H={H} D={D} Dv={Dv} causal (MLA prefill)"
    k3.setdefault("other", []).append(
        {"shape": shape, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
         "bound_ms": b_ms, "bound_by": b_by})
    say("kernels", f"K3 timed ({shape}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    # K5 at the serving decode shapes, scalar and per-row pos: minicpm3-4b's
    # (the main row) and deepseek-v2-236b's (R = 512, Rr = 64, H = 128)
    row = {"max_abs_err": 0.0}

    def k5_at(W, S, H, R, Rr, scale, per_row, label):
        """K5 against its plain version in fp32 and bf16, then timed in
        bf16 beside the plain version and masked SDPA."""
        for dtype in ("float32", "bfloat16"):
            ql, qr = randn(W, H, R, dtype=dtype), randn(W, H, Rr, dtype=dtype)
            c, kr = randn(W, S, R, dtype=dtype), randn(W, S, Rr, dtype=dtype)
            for pos in (per_row, 300):
                p = (torch.tensor(pos, dtype=torch.int32, device=dev)
                     if isinstance(pos, list) else pos)
                out = mk.mla_decode_attention_cuda(ql, qr, c, kr, p, scale)
                plain = ref.mla_decode_attention_ref(
                    ql.float(), qr.float(), c.float(), kr.float(), p, scale)
                err = within(torch, out, plain, dtype)
                row["max_abs_err"] = max(row["max_abs_err"], err)
                say("kernels", f"K5 mla_decode_attention {dtype} W={W} S={S} "
                    f"H={H} R={R} Rr={Rr} pos={pos}: max_abs_err {err:.3g} "
                    f"({tolerance(dtype)})")
        p = torch.tensor(per_row, dtype=torch.int32, device=dev)
        ms = time_ms(torch, lambda: mk.mla_decode_attention_cuda(
            ql, qr, c, kr, p, scale), flush)
        plain_ms = time_ms(torch, lambda: ref.mla_decode_attention_ref(
            ql, qr, c, kr, p, scale), flush)
        # SDPA on (q_lat || q_rope) against (c || kr) with v = c: one KV
        # head shared by the H query heads, the per-row bound as a mask; the
        # concatenations are made once, outside the timed call
        qcat = torch.cat([ql, qr], dim=-1)[:, :, None]
        kcat = torch.cat([c, kr], dim=-1)[:, None]
        mask = (torch.arange(S, device=dev)[None, :]
                <= p[:, None])[:, None, None, :]
        lib = F.scaled_dot_product_attention(qcat, kcat, c[:, None],
                                             attn_mask=mask, scale=scale,
                                             enable_gqa=True)
        lib_err = (lib[:, :, 0].float() - ref.mla_decode_attention_ref(
            ql.float(), qr.float(), c.float(), kr.float(), p,
            scale)).abs().max().item()
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qcat, kcat, c[:, None], attn_mask=mask, scale=scale,
            enable_gqa=True), flush)
        keys = sum(min(x + 1, S) for x in per_row)
        nbytes = (2 * (ql.numel() + qr.numel() + out.numel()
                       + keys * (R + Rr)) + 4 * W)
        flops = 2 * H * keys * (R + Rr) + 2 * H * keys * R
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        t = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                 bound_by=b_by, shape=f"bf16 W={W} S={S} H={H} R={R} Rr={Rr} "
                 f"pos={per_row} ({label})")
        say("kernels", f"K5 timed ({t['shape']}): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (max |sdpa - plain| "
            f"{lib_err:.3g}), bound {b_ms:.4f} ms ({b_by})")
        return t

    row.update(k5_at(4, 544, 40, 256, 32, 1.0 / math.sqrt(64 + 32),
                     [127, 250, 399, 543], "minicpm3-4b serving decode step"))
    # the split design's edges: deepseek-v2's widths, H % 16 != 0, S below
    # and just past one split, one slot, pos past the capacity, and a row
    # with a negative pos (no slot: zeros)
    scale = 1.0 / math.sqrt(64 + 32)
    for dtype in ("float32", "bfloat16"):
        for W2, S2, H2, R2, Rr2, pos in K5_EDGES:
            a, a_r = randn(W2, H2, R2, dtype=dtype), randn(W2, H2, Rr2, dtype=dtype)
            c2, kr2 = randn(W2, S2, R2, dtype=dtype), randn(W2, S2, Rr2, dtype=dtype)
            p2 = torch.tensor(pos, dtype=torch.int32, device=dev)
            out2 = mk.mla_decode_attention_cuda(a, a_r, c2, kr2, p2, scale)
            live = p2 >= 0
            check(bool((out2[~live] == 0).all()), "K5: a row with a negative "
                  "pos is not zeros")
            plain = ref.mla_decode_attention_ref(a.float(), a_r.float(),
                                                 c2.float(), kr2.float(), p2,
                                                 scale)
            err = within(torch, out2[live], plain[live], dtype)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            say("kernels", f"K5 mla_decode_attention {dtype} W={W2} S={S2} "
                f"H={H2} R={R2} Rr={Rr2} pos={pos}: max_abs_err {err:.3g} "
                f"({tolerance(dtype)}; negative pos: zeros)")
    row["other"] = [k5_at(4, 544, 128, 512, 64, 1.0 / math.sqrt(128 + 64),
                          [256, 259, 262, 264],
                          "deepseek-v2-236b serving decode step")]
    rows["mla_decode_attention"] = row

    # K6 at mamba2-370m's prefill shape: y and the final state
    B, S, H, P, N, Q = 1, 512, 32, 64, 128, 128
    A = torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=dev))
    Dh = torch.ones(H, device=dev)
    row = {"max_abs_err": 0.0, "library_ms": None}
    for dtype in ("float32", "bfloat16"):
        x = randn(B, S, H, P, dtype=dtype)
        dts = F.softplus(randn(B, S, H) - 2.0)
        Bm, Cm = randn(B, S, N, dtype=dtype), randn(B, S, N, dtype=dtype)
        y, st = sk.ssd_scan_cuda(x, dts, A, Bm, Cm, Dh, chunk=Q)
        y_ref, st_ref = ref.ssd_scan_ref(x.float(), dts, A, Bm.float(),
                                         Cm.float(), Dh, chunk=Q)
        tol = SSD_TOL if dtype == "float32" else BF16_TOL
        err = max(within_rel(torch, y, y_ref, tol, tol, f"K6 y {dtype}"),
                  within_rel(torch, st, st_ref, SSD_TOL, SSD_TOL,
                             f"K6 state {dtype}"))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        say("kernels", f"K6 ssd_scan {dtype} B={B} S={S} H={H} P={P} N={N} "
            f"chunk={Q}: max_abs_err {err:.3g} over y and the final state "
            f"(y: atol {tol} + rtol {tol}; state: atol {SSD_TOL} + rtol "
            f"{SSD_TOL}); max |y| {y_ref.abs().max().item():.3g}")
    # every state width, chunks that are not multiples of 16, two rows
    for dtype in ("float32", "bfloat16"):
        for B2, S2, H2, N2, Q2 in K6_EDGES:
            A2 = torch.log(torch.arange(1, H2 + 1, dtype=torch.float32,
                                        device=dev))
            D2 = torch.ones(H2, device=dev)
            x2 = randn(B2, S2, H2, P, dtype=dtype)
            dt2 = F.softplus(randn(B2, S2, H2) - 2.0)
            B2m, C2m = randn(B2, S2, N2, dtype=dtype), randn(B2, S2, N2, dtype=dtype)
            y2, st2 = sk.ssd_scan_cuda(x2, dt2, A2, B2m, C2m, D2, chunk=Q2)
            y2_ref, st2_ref = ref.ssd_scan_ref(x2.float(), dt2, A2, B2m.float(),
                                               C2m.float(), D2, chunk=Q2)
            tol = SSD_TOL if dtype == "float32" else BF16_TOL
            err = max(within_rel(torch, y2, y2_ref, tol, tol, f"K6 y {dtype}"),
                      within_rel(torch, st2, st2_ref, SSD_TOL, SSD_TOL,
                                 f"K6 state {dtype}"))
            row["max_abs_err"] = max(row["max_abs_err"], err)
            say("kernels", f"K6 ssd_scan {dtype} B={B2} S={S2} H={H2} P={P} "
                f"N={N2} chunk={Q2}: max_abs_err {err:.3g} (as above)")
    def k6_timed(x, dts, A, Bm, Cm, Dh, Q, label):
        """K6 in bf16 beside its plain version, and its bound."""
        B, S, H, P = x.shape
        N = Bm.shape[-1]
        ms = time_ms(torch, lambda: sk.ssd_scan_cuda(x, dts, A, Bm, Cm, Dh,
                                                     chunk=Q), flush)
        plain_ms = time_ms(torch, lambda: ref.ssd_scan_ref(
            x, dts, A, Bm, Cm, Dh, chunk=Q), flush)
        nc = S // Q
        tri = Q * (Q + 1) // 2
        flops = B * H * (nc * (2 * N * tri + 2 * P * tri + 2 * Q * P * N)
                         + (nc - 1) * 2 * Q * N * P)  # C.state is 0 in chunk 0
        nbytes = (2 * (2 * x.numel() + Bm.numel() + Cm.numel())
                  + 4 * (dts.numel() + 2 * H + B * H * P * N))
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        t = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 library_ms=None,
                 shape=f"bf16 B={B} S={S} H={H} P={P} N={N} chunk={Q} "
                 f"({label})")
        say("kernels", f"K6 timed ({t['shape']}): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4g} ms ({b_by}), library none")
        return t

    row.update(k6_timed(x, dts, A, Bm, Cm, Dh, Q, "mamba2-370m prefill"))
    # zamba2-7b's prefill: 112 heads at N = 64, checked and timed as above
    B, S, H, N = 1, 512, 112, 64
    A = torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=dev))
    Dh = torch.ones(H, device=dev)
    for dtype in ("float32", "bfloat16"):
        x = randn(B, S, H, P, dtype=dtype)
        dts = F.softplus(randn(B, S, H) - 2.0)
        Bm, Cm = randn(B, S, N, dtype=dtype), randn(B, S, N, dtype=dtype)
        y, st = sk.ssd_scan_cuda(x, dts, A, Bm, Cm, Dh, chunk=Q)
        y_ref, st_ref = ref.ssd_scan_ref(x.float(), dts, A, Bm.float(),
                                         Cm.float(), Dh, chunk=Q)
        tol = SSD_TOL if dtype == "float32" else BF16_TOL
        err = max(within_rel(torch, y, y_ref, tol, tol, f"K6 y {dtype}"),
                  within_rel(torch, st, st_ref, SSD_TOL, SSD_TOL,
                             f"K6 state {dtype}"))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        say("kernels", f"K6 ssd_scan {dtype} B={B} S={S} H={H} P={P} N={N} "
            f"chunk={Q}: max_abs_err {err:.3g} (as above); max |y| "
            f"{y_ref.abs().max().item():.3g}")
    row["other"] = [k6_timed(x, dts, A, Bm, Cm, Dh, Q, "zamba2-7b prefill")]
    rows["ssd_scan"] = row
    del flush


WINDOWS = (1, 7, 64, 256)  # K4/K5 window sweeps, on a cache of WINDOW_S
WINDOW_S = 1024
WINDOW_POS = (  # a ring not yet wrapped, one wrapped several times, per row
    500, 5 * WINDOW_S + 321,
    [0, 6, 63, 300, WINDOW_S - 1, WINDOW_S + 17, 3 * WINDOW_S + 700, -1])
K4_WINDOW_HEADS = ((4, 4), (16, 4), (28, 4))  # (H, Hkv): G = 1, 4, 7
K5_WINDOW_WIDTHS = ((40, 256, 32, 1.0 / math.sqrt(64 + 32), "minicpm3-4b"),
                    (128, 512, 64, 1.0 / math.sqrt(128 + 64),
                     "deepseek-v2-236b"))


def window_keys(pos, S: int, window: int) -> int:
    """Live slots a decode reads, summed over the rows (the age rule)."""
    rows = pos if isinstance(pos, list) else [pos]
    return sum(min(window or S, p + 1, S) for p in rows if p >= 0)


def phase_window_kernels(torch, np, F, ref, da, mk, rows, dev="cuda"):
    """K4 and K5 with a window (the extension F18) against their plain
    versions on the card in fp32 and bf16: windows WINDOWS on a cache of
    WINDOW_S slots, at WINDOW_POS (scalar not wrapped, scalar wrapped five
    times, per row with a negative row), K4 at G = 1, 4 and 7, K5 at
    minicpm3-4b's and deepseek-v2-236b's widths. Each case
    also holds window = 0 bitwise against window = WINDOW_S, whose live
    slots are the same (the kernels' windowed path adds nothing where the
    window covers the cache). Then both timed in bf16 at window 256 beside
    window 0 on the same cache. Adds to ``rows``."""
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    S = WINDOW_S

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(getattr(torch, dtype))

    def as_pos(pos):
        return (torch.tensor(pos, dtype=torch.int32, device=dev)
                if isinstance(pos, list) else pos)

    def live_rows(out, pos):
        """Rows with a live slot (a negative pos gives zeros)."""
        if not isinstance(pos, list):
            return slice(None)
        keep = torch.tensor([p >= 0 for p in pos], device=dev)
        check(bool((out[~keep] == 0).all()), "a row with a negative pos is "
              "not zeros")
        return keep

    k4, k5 = rows["decode_attention"], rows["mla_decode_attention"]
    cases = 0
    for dtype in ("float32", "bfloat16"):
        for H, Hkv in K4_WINDOW_HEADS:
            D = 128
            W = 8
            q = randn(W, H, D, dtype=dtype)
            kc, vc = randn(W, S, Hkv, D, dtype=dtype), randn(W, S, Hkv, D, dtype=dtype)
            for pos in WINDOW_POS:
                p = as_pos(pos)
                if not isinstance(pos, list):
                    q1, kc1, vc1 = q[:2], kc[:2], vc[:2]
                else:
                    q1, kc1, vc1 = q, kc, vc
                for window in WINDOWS:
                    out = da.decode_attention_cuda(q1, kc1, vc1, p,
                                                   window=window)
                    plain = ref.decode_attention_ref(
                        q1.float(), kc1.float(), vc1.float(), p, window=window)
                    keep = live_rows(out, pos)
                    err = within(torch, out[keep], plain[keep], dtype)
                    k4["max_abs_err"] = max(k4["max_abs_err"], err)
                    cases += 1
                same = torch.equal(da.decode_attention_cuda(q1, kc1, vc1, p),
                                   da.decode_attention_cuda(q1, kc1, vc1, p,
                                                            window=S))
                check(same, f"K4 {dtype} H={H} Hkv={Hkv} pos={pos}: window 0 "
                      f"and window {S} (the same slots) differ in bits")
            say("kernels", f"K4 decode_attention {dtype} W=8 S={S} H={H} "
                f"Hkv={Hkv} D={D}, windows {WINDOWS} at pos {WINDOW_POS}: "
                f"within {tolerance(dtype)}; window 0 bitwise window {S}")
        for H, R, Rr, scale, label in K5_WINDOW_WIDTHS:
            W = 8
            ql, qr = randn(W, H, R, dtype=dtype), randn(W, H, Rr, dtype=dtype)
            c, kr = randn(W, S, R, dtype=dtype), randn(W, S, Rr, dtype=dtype)
            for pos in WINDOW_POS:
                p = as_pos(pos)
                args = ((ql, qr, c, kr) if isinstance(pos, list) else
                        (ql[:2], qr[:2], c[:2], kr[:2]))
                for window in WINDOWS:
                    out = mk.mla_decode_attention_cuda(*args, p, scale, window)
                    plain = ref.mla_decode_attention_ref(
                        *(a.float() for a in args), p, scale, window)
                    keep = live_rows(out, pos)
                    err = within(torch, out[keep], plain[keep], dtype)
                    k5["max_abs_err"] = max(k5["max_abs_err"], err)
                    cases += 1
                same = torch.equal(
                    mk.mla_decode_attention_cuda(*args, p, scale),
                    mk.mla_decode_attention_cuda(*args, p, scale, S))
                check(same, f"K5 {dtype} {label} pos={pos}: window 0 and "
                      f"window {S} (the same slots) differ in bits")
            say("kernels", f"K5 mla_decode_attention {dtype} W=8 S={S} H={H} "
                f"R={R} Rr={Rr} ({label}), windows {WINDOWS} at pos "
                f"{WINDOW_POS}: within {tolerance(dtype)}; window 0 bitwise "
                f"window {S}")

    # timed in bf16: the serving steps' rows at pos 600-900 of a 1024-slot
    # cache, window 256 beside window 0 (every slot <= pos)
    pos = [600, 700, 800, 900]
    p = as_pos(pos)
    H, Hkv, D = 28, 4, 128
    q = randn(4, H, D, dtype="bfloat16")
    kc = randn(4, S, Hkv, D, dtype="bfloat16")
    vc = randn(4, S, Hkv, D, dtype="bfloat16")
    for window in (256, 0):
        ms = time_ms(torch, lambda: da.decode_attention_cuda(
            q, kc, vc, p, window=window), flush)
        plain_ms = time_ms(torch, lambda: ref.decode_attention_ref(
            q, kc, vc, p, window=window), flush)
        live = ref.live_slots(p, S, window, dev)[:, None, None, :]
        q4, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=live, enable_gqa=True), flush)
        keys = window_keys(pos, S, window)
        nbytes = 2 * (q.numel() * 2 + keys * Hkv * 2 * D) + 4 * 4
        b_ms, b_by = bound(nbytes, 2 * H * 2 * D * keys, "bfloat16")
        t = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                 bound_by=b_by, shape=f"bf16 W=4 S={S} H={H} Hkv={Hkv} D={D} "
                 f"pos={pos} window={window} (qwen2-7b widths)")
        k4.setdefault("other", []).append(t)
        say("kernels", f"K4 timed ({t['shape']}): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}; {keys} live slots)")
    H, R, Rr, scale, label = K5_WINDOW_WIDTHS[0]
    ql, qr = randn(4, H, R, dtype="bfloat16"), randn(4, H, Rr, dtype="bfloat16")
    c, kr = randn(4, S, R, dtype="bfloat16"), randn(4, S, Rr, dtype="bfloat16")
    qcat = torch.cat([ql, qr], dim=-1)[:, :, None]
    kcat = torch.cat([c, kr], dim=-1)[:, None]
    for window in (256, 0):
        ms = time_ms(torch, lambda: mk.mla_decode_attention_cuda(
            ql, qr, c, kr, p, scale, window), flush)
        plain_ms = time_ms(torch, lambda: ref.mla_decode_attention_ref(
            ql, qr, c, kr, p, scale, window), flush)
        live = ref.live_slots(p, S, window, dev)[:, None, None, :]
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qcat, kcat, c[:, None], attn_mask=live, scale=scale,
            enable_gqa=True), flush)
        keys = window_keys(pos, S, window)
        nbytes = 2 * (ql.numel() * 2 + qr.numel() + keys * (R + Rr)) + 4 * 4
        flops = 2 * H * keys * (R + Rr) + 2 * H * keys * R
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        t = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                 bound_by=b_by, shape=f"bf16 W=4 S={S} H={H} R={R} Rr={Rr} "
                 f"pos={pos} window={window} ({label} widths)")
        k5.setdefault("other", []).append(t)
        say("kernels", f"K5 timed ({t['shape']}): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}; {keys} live slots)")
    say("kernels", f"window sweeps: {cases} windowed cases of K4 and K5 "
        "against their plain versions")
    del flush


def raw_events(prof):
    """The profiler's own records of a finished window, read without
    building torch's event tree (``prof.events()``, which over a training
    step's ~22,000 kernels and their ops takes longer than the step:
    PERF.md §6, PR 29)."""
    return getattr(prof, "profiler", prof).kineto_results.events()


def device_window(prof, n: int):
    """Device activity of a profiler window of ``n`` iterations: (busy ms an
    iteration as the union of the kernels' and copies' intervals on the
    card, {name: [ms an iteration, launches an iteration]})."""
    from torch.autograd import DeviceType

    events = [e for e in raw_events(prof)
              if e.device_type() == DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.start_ns() / 1e3, e.end_ns() / 1e3)
                              for e in events):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name = {}
    for e in events:
        row = by_name.setdefault(e.name(), [0.0, 0])
        row[0] += e.duration_ns() / n / 1e6
        row[1] += 1
    for row in by_name.values():
        row[1] /= n
    return busy / n / 1e3, by_name


WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
         "cuCtxSynchronize")  # runtime calls that wait on the card


def host_window(prof) -> dict:
    """The host's runtime calls in a profiler window: the kernel launches,
    the calls that wait on the card (``WAITS``: their count and host ms),
    and the three runtime calls with the most host ms."""
    from torch.autograd import DeviceType

    launches = waits = 0
    wait_ms = 0.0
    runtime = {}
    for e in raw_events(prof):
        name = e.name()
        if e.device_type() != DeviceType.CPU or not name.startswith("cu"):
            continue
        ms = e.duration_ns() / 1e6
        launches += "LaunchKernel" in name
        if name in WAITS:
            waits += 1
            wait_ms += ms
        runtime[name] = runtime.get(name, 0.0) + ms
    top = sorted(runtime.items(), key=lambda kv: -kv[1])[:3]
    return {"launches": launches, "waits": waits, "wait_ms": wait_ms,
            "top_runtime_ms": dict(top)}


def kernel_class(name: str) -> str:
    n = name.lower()
    if "nstep" in n:
        return "K1 nstep_returns"
    if any(k in n for k in ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                            "implicit", "winograd", "fft")):
        return "convolution"
    if any(k in n for k in ("gemm", "nvjet", "cublas", "cutlass", "splitk")):
        return "GEMM"
    if "memcpy" in n or "memset" in n:
        return "copy/set"
    return "elementwise/reduction (env, losses, optimizer)"


RETURNS_E = (1, 8, 31, 32, 33, 256, 4096, 4097)
VTRACE_E = (1, 8, 31, 32, 33, 256, 4096, 4097)
# (T, E) timed, the main path's shape first: K1 at the training path's
# n_e = 32 and 256, K2 at the one-actor and four-actor pipelines and at
# n_e = 256; both at T=64 E=4096 and at the TPU kernel's design point
# T=4096 E=256 (src/repro/kernels/nstep_returns.py:9)
K1_TIMED = ((5, 32), (5, 256), (64, 4096), (4096, 256))
K2_TIMED = ((5, 32), (5, 8), (5, 256), (64, 4096), (4096, 256))


def chunk_edges(mod) -> tuple:
    """T in {1, 5, 64}, both sides of the short kernel's last T (SHORT_T,
    SHORT_T + 1), and around the longest chunk TC: TC - 1, TC, TC + 1 and
    2 TC + 3."""
    tc, st = mod.launch_shape(10**6, 32)[1], mod.column_scan.SHORT_T
    return tuple(sorted({1, 5, 64, st, st + 1, tc - 1, tc, tc + 1,
                         2 * tc + 3}))


def unaligned(torch, x):
    """``x`` copied into a view that starts one element past an aligned
    allocation: contiguous, but not 16-byte (floats) or 4-byte (bytes)
    aligned, so the kernels take their cp.async and byte-load routes."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


def timed_rows(torch, phase, name, timed, data, kernel, plain, floor, nbytes,
               flops, shape, flush):
    """CUDA-event times of ``kernel``, its plain version and the launch
    floor at each (T, E) of ``timed``; the first is the main path's shape
    and also gets the wrapper's host microseconds a call."""
    row = {"other": []}
    for i, (T, E) in enumerate(timed):
        args = data[(E, T)]
        ms = time_ms(torch, lambda: kernel(*args), flush)
        # the plain version walks T in Python: fewer repeats at T = 4096
        plain_ms = time_ms(torch, lambda: plain(*args), flush,
                           iters=30 if T < 1000 else 5)
        floor_ms = time_ms(torch, floor(T, E), flush)
        b_ms, b_by = bound(nbytes(T, E), flops(T, E), "float32")
        tile, chunk, blocks, smem = shape(T, E)
        entry = {"shape": f"fp32 T={T} E={E}", "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "launch_floor_ms": floor_ms}
        msg = (f"{name} timed (fp32 T={T} E={E}; tile {tile}, chunk {chunk}, "
               f"{blocks} blocks, {smem} B shared): kernel {ms:.5f} ms, launch "
               f"floor {floor_ms:.5f} ms, plain {plain_ms:.4f} ms, bound "
               f"{b_ms:.3g} ms ({b_by}), library none")
        if i == 0:
            entry["host_us"] = host_us(torch, lambda: kernel(*args))
            msg += f", host {entry['host_us']:.2f} us a call"
            row.update(entry, bound_by=b_by)
        else:
            row["other"].append(entry)
        say(phase, msg)
    return row


def phase_returns(torch, ref, nr, dev="cuda"):
    """K1 against its plain version over the sweep (bitwise), then timed."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    worst, n_cases = 0.0, 0
    data = {}
    T_SWEEP = chunk_edges(nr)
    shapes = [(E, T) for E in RETURNS_E for T in T_SWEEP]
    shapes += [(E, T) for T, E in K1_TIMED if (E, T) not in shapes]
    cases = [(E, T, False) for E, T in shapes] + [
        (256, 5, True), (256, 259, True)]  # misaligned views, E % 16 == 0
    for E, T, view in cases:
        r = torch.randn(T, E, generator=g, device=dev)
        d = torch.rand(T, E, generator=g, device=dev) < 0.1
        if E >= 2:
            d[:, 0], d[:, 1] = True, False  # all done, never done
        b = torch.randn(E, generator=g, device=dev)
        if view:
            r, d = unaligned(torch, r), unaligned(torch, d)
        else:
            data[(E, T)] = (r, d, b, 0.99)
        for gamma in (0.0, 0.99, 1.0):
            out = nr.nstep_returns_cuda(r, d, b, gamma)
            plain = ref.nstep_returns_ref(r, d, b, gamma)
            err = (out - plain).abs()
            check(bool(torch.isfinite(out).all()), "K1: non-finite output")
            check(bool((err <= RETURNS_TOL + RETURNS_TOL * plain.abs()).all()),
                  f"K1 disagrees with its plain version at E={E} T={T} "
                  f"gamma={gamma}: max err {err.max().item():.3g}")
            check(err.max().item() == 0.0,
                  f"K1 is not bitwise its plain version at E={E} T={T} "
                  f"gamma={gamma}: max err {err.max().item():.3g}")
            worst = max(worst, err.max().item())
            n_cases += 1
    say("returns", f"K1 nstep_returns fp32, {n_cases} cases (E in "
        f"{'/'.join(map(str, RETURNS_E))}, T in {'/'.join(map(str, T_SWEEP))}"
        f", T=4096 at E=256, misaligned views at E=256 T=5/259, gamma "
        f"0/0.99/1): max_abs_err {worst:.3g} (atol {RETURNS_TOL} + rtol "
        f"{RETURNS_TOL}; bitwise required)")
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    row = timed_rows(
        torch, "returns", "K1", K1_TIMED, data, nr.nstep_returns_cuda,
        ref.nstep_returns_ref,
        lambda T, E: floor_launch(torch, nr._build, "nstep_returns",
                                  nr.launch_shape, T, E),
        lambda T, E: T * E * (4 + 1 + 4) + 4 * E, lambda T, E: 3 * T * E,
        nr.launch_shape, flush)
    row.update(max_abs_err=worst, library_ms=None)
    del flush
    return row


def phase_vtrace(torch, ref, vt, dev="cuda"):
    """K2 against its plain version over the sweep (bitwise), then timed."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    inf = float("inf")
    worst, n_cases, overflow = 0.0, 0, 0
    data = {}
    T_SWEEP = chunk_edges(vt)
    shapes = [(E, T) for E in VTRACE_E for T in T_SWEEP]
    shapes += [(E, T) for T, E in K2_TIMED if (E, T) not in shapes]
    cases = [(E, T, False) for E, T in shapes] + [
        (256, 5, True), (256, 131, True)]  # misaligned views, E % 16 == 0
    for E, T, view in cases:
        r = torch.randn(T, E, generator=g, device=dev)
        d = torch.rand(T, E, generator=g, device=dev) < 0.1
        v = torch.randn(T, E, generator=g, device=dev)
        rho = torch.exp(0.5 * torch.randn(T, E, generator=g, device=dev))
        if E >= 3:  # all done, never done, rho far above every clip
            d[:, 0], d[:, 1], rho[:, 2] = True, False, 50.0
        b = torch.randn(E, generator=g, device=dev)
        if view:
            r, d, v, rho = (unaligned(torch, x) for x in (r, d, v, rho))
        else:
            data[(E, T)] = (r, d, v, b, rho, 0.99, 1.0, 1.0)
        for rho_bar, c_bar in ((1.0, 1.0), (2.0, 1.0), (1e9, 1e9),
                               (inf, inf)):
            for gamma in (0.0, 0.99, 1.0):
                args = (r, d, v, b, rho, gamma, rho_bar, c_bar)
                for out, plain in zip(vt.vtrace_returns_cuda(*args),
                                      ref.vtrace_returns_ref(*args)):
                    # unclipped c over the rho = 50 row overflows float32 in
                    # both versions (50^T): there the kernel must give
                    # exactly the plain version's inf or nan
                    fin = torch.isfinite(plain)
                    check(bool((torch.isfinite(out) == fin).all())
                          and bool((out[~fin].nan_to_num(0.0, 1.0, -1.0)
                                    == plain[~fin].nan_to_num(
                                        0.0, 1.0, -1.0)).all()),
                          f"K2 non-finite where its plain version is not "
                          f"(or the other way) at E={E} T={T} clips="
                          f"({rho_bar}, {c_bar}) gamma={gamma}")
                    overflow += int((~fin).sum())
                    err = (out[fin] - plain[fin]).abs()
                    check(bool((err <= RETURNS_TOL
                                + RETURNS_TOL * plain[fin].abs()).all()),
                          f"K2 disagrees with its plain version at E={E} "
                          f"T={T} clips=({rho_bar}, {c_bar}) gamma="
                          f"{gamma}: max err {err.max().item():.3g}")
                    if err.numel():
                        check(err.max().item() == 0.0,
                              f"K2 is not bitwise its plain version at E={E} "
                              f"T={T} clips=({rho_bar}, {c_bar}) gamma="
                              f"{gamma}: max err {err.max().item():.3g}")
                        worst = max(worst, err.max().item())
                n_cases += 1
    say("vtrace", f"K2 vtrace_returns fp32, {n_cases} cases (E in "
        f"{'/'.join(map(str, VTRACE_E))}, T in "
        f"{'/'.join(map(str, T_SWEEP))}, T=4096 at E=256, misaligned views "
        "at E=256 T=5/131, clips (1,1)/(2,1)/(1e9,1e9)/(inf,inf), gamma "
        "0/0.99/1, a row of rho=50): "
        f"max_abs_err {worst:.3g} over vs and pg_adv (atol {RETURNS_TOL} + "
        f"rtol {RETURNS_TOL}; bitwise required); {overflow} entries overflow "
        "float32 in both versions (unclipped c on the rho=50 row) and match "
        "exactly")
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    row = timed_rows(
        torch, "vtrace", "K2", K2_TIMED, data, vt.vtrace_returns_cuda,
        ref.vtrace_returns_ref,
        lambda T, E: floor_launch(torch, vt._build, "vtrace", vt.launch_shape,
                                  T, E),
        lambda T, E: T * E * (4 + 1 + 4 + 4) + 2 * T * E * 4 + 4 * E,
        lambda T, E: 15 * T * E, vt.launch_shape, flush)
    row.update(max_abs_err=worst, library_ms=None)
    del flush
    return row


def phase_rl_model(torch, configs, models, envs, paac, optim, tree,
                   dev="cuda"):
    """paac_nature at full size, fp32: the CPU against the card."""
    cfg = configs.get_config("paac_nature").replace(num_actions=3)
    check((cfg.cnn_spec, cfg.cnn_dense, cfg.obs_shape, cfg.param_dtype)
          == (((32, 8, 4), (64, 4, 2), (64, 3, 1)), 512, (84, 84, 4),
              "float32"), f"not the full paac_nature config: {cfg}")
    cpu = models.init_policy(cfg, generator=torch.Generator().manual_seed(SEED),
                             device="cpu")
    gpu = tree.tree_map(lambda t: t.to(dev), cpu)
    n_params = sum(t.numel() for t in tree.tree_leaves(cpu))

    env = envs.FrameStack(envs.AtariLike(32, device="cpu"), 4)
    hp = paac.PAACConfig(gamma=0.99, entropy_beta=0.01, t_max=5)
    agent = paac.PAACAgent(cfg, hp)
    g = torch.Generator().manual_seed(SEED)
    state = env.reset(g)
    _, _, traj, boot = agent.make_collect_step(env)(
        cpu, state, env.observe(state), torch.Generator().manual_seed(SEED + 1),
        g)
    traj_g = type(traj)(*(x.to(dev) for x in traj))
    boot_g = boot.to(dev)

    obs = traj.obs[1]  # 32 frames a few steps into episodes
    lc, vc, _ = models.policy_apply(cpu, cfg, obs)
    lg, vg, _ = models.policy_apply(gpu, cfg, obs.to(dev))
    fwd = max((lc - lg.cpu()).abs().max().item(),
              (vc - vg.cpu()).abs().max().item())
    check(fwd <= RL_TOL, f"paac_nature logits/values: card vs CPU {fwd:.3g}")

    loss_c, _, grads_c = paac.loss_and_grads(cpu, cfg, hp, traj, boot)
    loss_g, _, grads_g = paac.loss_and_grads(gpu, cfg, hp, traj_g, boot_g)
    gn_c = tree.tree_global_norm(grads_c).item()
    gn_g = tree.tree_global_norm(grads_g).item()
    opt = optim.make_optimizer("rmsprop")
    update = agent.make_update_step(opt, optim.constant(0.0007 * 32))
    new_c, _, _ = update(cpu, opt.init(cpu), traj, boot, 0)
    new_g, _, _ = update(gpu, opt.init(gpu), traj_g, boot_g, 0)
    d_loss = abs(loss_c.item() - loss_g.item())
    d_norm = abs(gn_c - gn_g) / max(1.0, abs(gn_c))
    d_param = max((a - b.cpu()).abs().max().item() for a, b in
                  zip(tree.tree_leaves(new_c), tree.tree_leaves(new_g)))
    moved = max((a - b).abs().max().item() for a, b in
                zip(tree.tree_leaves(new_c), tree.tree_leaves(cpu)))
    check(d_loss <= RL_TOL, f"PAAC loss: card vs CPU {d_loss:.3g}")
    check(d_norm <= RL_TOL, f"global grad norm: card {gn_g} vs CPU {gn_c}")
    check(d_param <= RL_TOL, f"new parameters: card vs CPU {d_param:.3g}")
    check(moved > 10 * RL_TOL, f"the update moved no parameter ({moved:.3g})")
    say("rl_model", f"paac_nature full size fp32 ({n_params / 1e6:.2f} M "
        f"parameters): logits/values of 32 frames card vs CPU max {fwd:.3g}; "
        f"one update on a replayed 5x32 trajectory: loss {loss_c.item():.6f} "
        f"(|d| {d_loss:.3g}), grad norm {gn_c:.6f} (rel d {d_norm:.3g}), new "
        f"params max |d| {d_param:.3g} (largest step {moved:.3g}); all <= "
        f"{RL_TOL}")


def measure(torch, fn, n: int):
    """(host wall ms a call over ``n`` calls ended by a device drain,
    device-busy ms a call, device activities a call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy_ms, by_name = device_window(prof, n)
    return host_ms, busy_ms, sum(c for _, c in by_name.values())


def layer_costs(torch, rl, n: int):
    """The layers of one iteration, each run alone: the env steps and the
    acting forwards of a rollout, the learning pass (forward over all
    frames, K1, losses, backward), K1 alone and the optimizer."""
    from repro_torch.core.agents.paac import loss_and_grads
    from repro_torch.kernels import ops
    from repro_torch.utils.sampling import categorical

    agent, env, hp = rl.agent, rl.env, rl.agent.hp
    act = agent.act_fn()
    g = torch.Generator(device=rl.device).manual_seed(SEED)
    _, _, traj, boot = agent.make_collect_step(env)(
        rl.params, rl.env_state, rl.obs, g, g)
    _, _, grads = loss_and_grads(rl.params, agent.cfg, hp, traj, boot)
    lr = rl.lr_schedule(0)

    def env_steps():
        for t in range(hp.t_max):
            env.step(rl.env_state, traj.action[t], g)

    def acting():
        with torch.no_grad():
            for _ in range(hp.t_max + 1):  # the last one is the bootstrap
                categorical(act(rl.params, rl.obs)[0], g)

    fns = {
        f"env step x{hp.t_max}": env_steps,
        f"acting forward + draw x{hp.t_max + 1}": acting,
        "learning pass": lambda: loss_and_grads(rl.params, agent.cfg, hp,
                                                traj, boot),
        "K1": lambda: ops.nstep_returns(traj.reward, traj.done, boot,
                                        hp.gamma),
        "optimizer": lambda: rl.optimizer.update(grads, rl.opt_state,
                                                 rl.params, lr),
    }
    return {k: measure(torch, fn, n) for k, fn in fns.items()}


def phase_training(torch, paper_atari, ops, tree, card, dev="cuda",
                   n_envs=32, warmup=10, iters=200, window=10, wide=256,
                   wide_iters=50):
    """The paper's setting, timed; returns the launch counts of the run and
    the trained ``(agent, params)``."""
    from torch.profiler import ProfilerActivity, profile

    rl = paper_atari.build("paac_nature", n_envs, SEED, dev)
    check(rl.lr_schedule(0) == 0.0007 * n_envs, "lr is not 0.0007 n_e")
    check(rl.env.obs_shape == (84, 84, 4) and rl.env.num_actions == 3,
          f"env obs {rl.env.obs_shape}, {rl.env.num_actions} actions")
    rl.run(warmup)
    before = [t.clone() for t in tree.tree_leaves(rl.params)]
    ops.reset_launches()
    res = rl.run(iters)
    counts = dict(ops.launches)
    m = res.mean_metrics
    check(counts["nstep_returns"] == iters,
          f"K1 launched {counts['nstep_returns']} times in {iters} iterations")
    # a non-finite loss in any iteration makes the mean non-finite
    check(all(math.isfinite(v) for v in m.values()),
          f"non-finite training metrics: {m}")
    changed = max((a - b).abs().max().item() for a, b in
                  zip(before, tree.tree_leaves(rl.params)))
    check(changed > 0, "the parameters did not change")
    check(0 < m["entropy"] <= math.log(3) + 1e-6,
          f"mean entropy {m['entropy']} outside (0, log 3]")
    iter_ms = 1e3 * n_envs * rl.agent.hp.t_max / res.timesteps_per_sec
    say("training", f"paac_nature on FrameStack(AtariLike({n_envs})), t_max 5, "
        f"RMSProp lr {0.0007 * n_envs:g}: {iters} iterations after {warmup} "
        f"warm-up, K1 launched {counts['nstep_returns']} times; "
        f"{res.timesteps_per_sec:.1f} timesteps/s, {iter_ms:.2f} ms an "
        f"iteration; mean loss {m['loss']:.4f}, entropy {m['entropy']:.4f}, "
        f"reward/iter {m['reward_sum']:+.3f}, episodes {res.episodes:.0f}; "
        f"largest parameter change {changed:.3g} ({card})")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rl.run(window)
        torch.cuda.synchronize()
    busy_ms, by_name = device_window(prof, window)
    classes = {}
    for name, (ms, n) in by_name.items():
        row = classes.setdefault(kernel_class(name), [0.0, 0.0])
        row[0] += ms
        row[1] += n
    launches = sum(n for _, n in by_name.values())
    busy = (f"device busy {busy_ms:.3f} ms an iteration "
            f"({100 * busy_ms / iter_ms:.1f}% of the unprofiled {iter_ms:.2f} "
            "ms)" if busy_ms > 0 else "device time not measured (the "
            "profiler saw no device activity)")
    say("training", f"torch.profiler window of {window} iterations: {busy}, "
        f"{launches:.0f} device activities an iteration; by class (ms, "
        "launches an iteration): "
        + "; ".join(f"{k} {ms:.3f} x{n:.0f}" for k, (ms, n) in
                    sorted(classes.items(), key=lambda kv: -kv[1][0])))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    say("training", "top device activities (ms, launches an iteration): "
        + "; ".join(f"{k[:60]} {ms:.3f} x{n:.0f}" for k, (ms, n) in top))

    layers = layer_costs(torch, rl, window)
    say("training", "each layer alone, at the state the run reached (host "
        "wall ms with the device drained, device-busy ms, launches; a "
        "call): " + "; ".join(f"{k} {h:.3f} / {b:.3f} / {n:.0f}" for k, (h, b, n)
                              in layers.items()))

    trained = (rl.agent, rl.params)
    del rl
    argv = ["--arch", "paac_nature", "--n-envs", str(n_envs), "--iters", "50",
            "--seed", str(SEED), "--device", str(dev)]
    cli = paper_atari.main(argv)
    check(len(cli) == 2 and cli[-1].steps == 50 * n_envs * 5
          and all(math.isfinite(v) for r in cli for v in r.mean_metrics.values()),
          f"paper_atari {' '.join(argv)}: {cli}")
    say("training", f"entry point: python -m repro_torch.launch.paper_atari "
        f"{' '.join(argv)}: {cli[-1].steps} steps in 2 epochs, "
        f"{cli[-1].timesteps_per_sec:.1f} timesteps/s in the second")

    wide_rl = paper_atari.build("paac_nature", wide, SEED, dev)
    wide_rl.run(warmup)
    wres = wide_rl.run(wide_iters)
    check(all(math.isfinite(v) for v in wres.mean_metrics.values()),
          f"non-finite metrics at n_e={wide}")
    say("training", f"n_e={wide} (lr {0.0007 * wide:g}): {wide_iters} "
        f"iterations after {warmup} warm-up, {wres.timesteps_per_sec:.1f} "
        f"timesteps/s, {1e3 * wide * 5 / wres.timesteps_per_sec:.2f} ms an "
        "iteration")
    return counts, trained


SHARED_METRICS = ("loss", "policy_loss", "value_loss", "entropy",
                  "reward_sum", "episodes")


DQN_METRICS = ("loss", "q_mean", "td_abs", "reward_sum", "episodes")


def check_bitwise(torch, tree, ra, a, rb, b, what: str,
                  keys=SHARED_METRICS) -> None:
    """Two runs' mean metrics ``keys`` and every parameter leaf are
    equal."""
    for k in keys:
        check(ra.mean_metrics[k] == rb.mean_metrics[k],
              f"{what}: mean {k} {ra.mean_metrics[k]!r} != "
              f"{rb.mean_metrics[k]!r}")
    diff = [i for i, (x, y) in enumerate(zip(tree.tree_leaves(a.params),
                                             tree.tree_leaves(b.params)))
            if not torch.equal(x, y)]
    check(not diff, f"{what}: parameter leaves {diff} differ")


def _merge(intervals):
    """Sorted, merged copies of ``(start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def stream_overlap(prof, n: int):
    """(ms an iteration during which work of two or more CUDA streams runs
    at once, {stream id: busy ms an iteration}) of a profiler window."""
    from torch.autograd import DeviceType

    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per.setdefault(e.device_resource_id, []).append(
                (e.time_range.start, e.time_range.end))
    busy, edges = {}, []
    for sid, iv in per.items():
        merged = _merge(iv)
        busy[sid] = sum(b - a for a, b in merged) / n / 1e3
        edges += [(a, 1) for a, _ in merged] + [(b, -1) for _, b in merged]
    both, depth, last = 0.0, 0, 0.0
    for t, step in sorted(edges):
        if depth >= 2:
            both += t - last
        depth, last = depth + step, t
    return both / n / 1e3, busy


def span_overlap(hub) -> float:
    """Share of the learner's update spans (host clock) during which some
    actor was inside its collect span."""
    from repro_torch.telemetry.spans import COLLECT, LEARNER_UPDATE

    updates, collects = [], []
    for _, _, em in hub.tracks():
        for cat, t0, t1 in em.snapshot():
            if em.name == "learner" and cat == LEARNER_UPDATE:
                updates.append((t0, t1))
            elif em.name.startswith("actor") and cat == COLLECT:
                collects.append((t0, t1))
    merged = _merge(collects)
    inter = sum(max(0.0, min(b, d) - max(a, c))
                for a, b in updates for c, d in merged)
    total = sum(b - a for a, b in updates)
    return inter / total if total > 0 else 0.0


def span_means(hub) -> str:
    """Mean host ms of each (track, stage) span of a run: the learner's
    ring wait, lease wait, update and publish, the actors' collect and
    ring wait."""
    from repro_torch.telemetry.spans import CATEGORIES

    sums = {}
    for _, _, em in hub.tracks():
        who = "actors" if em.name.startswith("actor") else em.name
        if who in ("ring", "queue"):  # the parties' own waits, again
            continue
        for cat, t0, t1 in em.snapshot():
            row = sums.setdefault((who, CATEGORIES[cat]), [0.0, 0])
            row[0] += (t1 - t0) * 1e3
            row[1] += 1
    return ", ".join(f"{who} {cat} {ms / n:.3f} x{n}"
                     for (who, cat), (ms, n) in sorted(sums.items()))


def span_stat(hub, track: str, stage: str):
    """(mean host ms, count) of the ``stage`` spans of the tracks whose
    name starts with ``track`` (shipped worker rings included)."""
    ms, n = 0.0, 0
    for _, _, em in hub.tracks():
        if em.name.startswith(track):
            for cat, t0, t1 in em.snapshot():
                if em.categories[cat] == stage:
                    ms += (t1 - t0) * 1e3
                    n += 1
    return (ms / n if n else float("nan")), n


def phase_pipeline(torch, paper_atari, configs, ops, tree, card, dev="cuda",
                   n_envs=32, warmup=10, iters=200, lock_iters=20, window=10,
                   trace_dir=None):
    """The pipelined actor/learner in the paper's setting: lockstep against
    ParallelRL bitwise, then one and four actors timed beside ParallelRL.
    Returns K2's launches in the one-actor run."""
    from torch.profiler import ProfilerActivity, profile

    PipelineConfig = configs.PipelineConfig
    leaves = tree.tree_leaves
    inf = float("inf")

    def bitwise(ra, a, rb, b, what):
        check_bitwise(torch, tree, ra, a, rb, b, what)

    # (a) lockstep, infinite clips: the synchronous update, bit for bit
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        sync = [paper_atari.build("paac_nature", n_envs, SEED, dev)
                for _ in range(2)]
        sync_res = [rl.run(lock_iters) for rl in sync]
        bitwise(sync_res[0], sync[0], sync_res[1], sync[1],
                "two same-seed ParallelRL runs on the card")
        lock = paper_atari.build("paac_nature", n_envs, SEED, dev,
                                 PipelineConfig(queue_depth=1, lockstep=True,
                                                rho_bar=inf, c_bar=inf))
        ops.reset_launches()
        lock_res = lock.run(lock_iters)
        counts = dict(ops.launches)
        check(counts["nstep_returns"] == lock_iters
              and counts["vtrace_returns"] == 0,
              f"lockstep launches {counts}, not K1 x{lock_iters} and no K2")
        check(lock.staleness == [0.0] * lock_iters,
              f"lockstep staleness {lock.staleness}")
        bitwise(lock_res, lock, sync_res[0], sync[0],
                "lockstep PipelinedRL vs ParallelRL")
    finally:
        torch.backends.cudnn.deterministic = False
    say("pipeline", f"(a) two same-seed ParallelRL runs of {lock_iters} "
        "iterations agree bitwise; lockstep PipelinedRL (depth 1, rho_bar = "
        f"c_bar = inf) equals them bitwise in every metric and all "
        f"{len(leaves(lock.params))} parameter leaves; launches K1 "
        f"{counts['nstep_returns']}, K2 {counts['vtrace_returns']}")
    del sync, lock

    def timed(label, key, rl, expect):
        rl.run(warmup)
        before = [t.clone() for t in leaves(rl.params)]
        ops.reset_launches()
        res = rl.run(iters)
        counts = dict(ops.launches)
        m = res.mean_metrics
        check(all(math.isfinite(v) for v in m.values()),
              f"{label}: non-finite metrics {m}")
        changed = max((a - b).abs().max().item() for a, b in
                      zip(before, leaves(rl.params)))
        check(changed > 0, f"{label}: the parameters did not change")
        expect(rl, res, counts)
        hub = getattr(rl, "telemetry", None)
        host_overlap = span_overlap(hub) if hub is not None else None
        if hub is not None:
            say("pipeline", f"{label}: mean host ms of each span (track, "
                f"stage, count): {span_means(hub)}")
        if trace_dir and hub is not None:
            hub.write_trace(os.path.join(trace_dir, f"pipeline_{key}.json"))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rl.run(window)
            torch.cuda.synchronize()
        busy_ms, _ = device_window(prof, window)
        both_ms, streams = stream_overlap(prof, window)
        per_iter = rl._steps_per_iter  # timesteps an update
        iter_ms = 1e3 * per_iter / res.timesteps_per_sec
        wall_s = iters * iter_ms / 1e3
        n_act = len(res.per_actor_idle_s) or 1
        row = dict(tps=res.timesteps_per_sec, iter_ms=iter_ms,
                   busy_ms=busy_ms, both_ms=both_ms,
                   actor_idle=res.actor_idle_s / (n_act * wall_s),
                   learner_idle=res.learner_idle_s / wall_s)
        say("pipeline", f"{label}: {iters} updates after {warmup} warm-up, "
            f"launches K1 {counts['nstep_returns']} K2 "
            f"{counts['vtrace_returns']}; {res.timesteps_per_sec:.1f} "
            f"timesteps/s, {iter_ms:.2f} ms an update of {per_iter} "
            f"timesteps; mean loss {m['loss']:.4f}, entropy "
            f"{m['entropy']:.4f}, rho_mean {m.get('rho_mean', 1.0):.4f}, "
            f"rho_clip_frac {m.get('rho_clip_frac', 0.0):.4f}, staleness "
            f"{m.get('staleness', 0.0):.3f}; actor idle {res.actor_idle_s:.3f}"
            f" s ({100 * row['actor_idle']:.1f}% of each actor's wall), "
            f"learner idle {res.learner_idle_s:.3f} s "
            f"({100 * row['learner_idle']:.1f}%); learner update spans "
            "overlapping an actor's collect span: "
            + ("n/a" if host_overlap is None else f"{100 * host_overlap:.1f}%")
            + f"; profiler window of {window}: device busy {busy_ms:.3f} ms "
            f"an update ({100 * busy_ms / iter_ms:.1f}% of the unprofiled "
            f"{iter_ms:.2f} ms), two or more streams busy at once "
            f"{both_ms:.3f} ms; busy ms by stream "
            + ", ".join(f"{k}: {v:.3f}" for k, v in sorted(streams.items()))
            + f" ({card})")
        return row, counts

    def one_actor(rl, res, counts):
        check(counts["vtrace_returns"] == iters
              and counts["nstep_returns"] == 0,
              f"one actor: launches {counts}, not K2 x{iters} and no K1")
        check(sorted(rl.learned_ids) == [(0, s) for s in range(iters)],
              "one actor: an (actor_id, seq) was dropped or learned twice")
        check(res.mean_metrics["staleness"] > 0
              and max(rl.staleness) <= rl.pipeline.queue_depth + 1,
              f"one actor: staleness mean {res.mean_metrics['staleness']} "
              f"max {max(rl.staleness)}")
        check(0 < res.mean_metrics["rho_mean"] < math.inf,
              f"one actor: rho_mean {res.mean_metrics['rho_mean']}")

    def four_actors(rl, res, counts):
        check(counts["vtrace_returns"] == iters
              and counts["nstep_returns"] == 0,
              f"four actors: launches {counts}, not K2 x{iters} and no K1")
        check(sorted(rl.learned_ids) == [(a, s) for a in range(4)
                                         for s in range(iters // 4)],
              "four actors: an (actor_id, seq) was dropped or learned twice")
        check(0 < res.mean_metrics["rho_mean"] < math.inf,
              f"four actors: rho_mean {res.mean_metrics['rho_mean']}")

    def synchronous(rl, res, counts):
        check(counts["nstep_returns"] == iters
              and counts["vtrace_returns"] == 0,
              f"ParallelRL: launches {counts}")

    rows = {}
    rows["sync"], _ = timed(f"ParallelRL n_e={n_envs}", "sync",
                            paper_atari.build("paac_nature", n_envs, SEED, dev),
                            synchronous)
    rows["one"], counts = timed(
        "(b) one actor, depth 2", "one_actor",
        paper_atari.build("paac_nature", n_envs, SEED, dev,
                          PipelineConfig(queue_depth=2)), one_actor)
    rows["four"], _ = timed(
        f"(c) four actors of {n_envs // 4} envs, depth 4", "four_actors",
        paper_atari.build("paac_nature", n_envs, SEED, dev,
                          PipelineConfig(queue_depth=4, num_actors=4)),
        four_actors)
    say("pipeline", "timesteps/s: " + ", ".join(
        f"{k} {r['tps']:.1f} ({r['tps'] / rows['sync']['tps']:.2f}x sync)"
        for k, r in rows.items()))

    argv = ["--arch", "paac_nature", "--n-envs", str(n_envs), "--iters", "50",
            "--seed", str(SEED), "--device", str(dev), "--pipeline"]
    cli = paper_atari.main(argv)
    check(len(cli) == 2 and cli[-1].steps == 50 * n_envs * 5
          and all(math.isfinite(v) for r in cli for v in r.mean_metrics.values()),
          f"paper_atari {' '.join(argv)}: {cli}")
    say("pipeline", f"entry point: python -m repro_torch.launch.paper_atari "
        f"{' '.join(argv)}: {cli[-1].steps} steps in 2 epochs, "
        f"{cli[-1].timesteps_per_sec:.1f} timesteps/s in the second, "
        f"staleness {cli[-1].mean_metrics['staleness']:.2f}")
    return counts["vtrace_returns"]


def phase_mesh(torch, paper_atari, configs, ops, tree, train, card,
               dev="cuda", n_envs=32, warmup=10, iters=60, lock_iters=20,
               cli_iters=20):
    """The mesh rollout plane at mesh_shape 1 (one card) in the paper's
    setting: (a) lockstep at depth 1, clips 1, on the mesh plane against
    the device plane, bitwise (cuDNN deterministic); (b) the device and
    the mesh plane at depth 2 in turns (device, mesh, mesh, device), each
    ``iters`` timed updates after ``warmup``: K2 once an update on the
    mesh, K1 never, and the plain V-trace never called; (c)
    ``launch/train.py --pipeline --rollout-plane mesh --mesh 1``. Returns
    K2's launches in (b)'s first mesh run and in (c)."""
    PipelineConfig = configs.PipelineConfig
    real_plain = ops._ref.vtrace_returns_ref
    plain_calls = []

    def plain(rewards, *a, **kw):
        plain_calls.append(rewards.device.type)
        return real_plain(rewards, *a, **kw)

    def build(plane, **kw):
        return paper_atari.build("paac_nature", n_envs, SEED, dev,
                                 PipelineConfig(rollout_plane=plane, **kw))

    ops._ref.vtrace_returns_ref = plain
    try:
        # (a) lockstep, clips 1: the same K2 path on both planes
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            runs = {}
            for plane in ("device", "mesh"):
                rl = build(plane, queue_depth=1, lockstep=True)
                ops.reset_launches()
                runs[plane] = (rl.run(lock_iters), rl, dict(ops.launches))
        finally:
            torch.backends.cudnn.deterministic = False
        (rd, d, _), (rm, m, counts) = runs["device"], runs["mesh"]
        check(m._plane == "mesh" and m._n_actors == 1,
              f"mesh plane: plane {m._plane}, lanes {m._n_actors}")
        check(counts["vtrace_returns"] == lock_iters
              and counts["nstep_returns"] == 0,
              f"mesh lockstep launches {counts}")
        check(m.learned_ids == [(-1, s) for s in range(lock_iters)]
              and m.staleness == [0.0] * lock_iters,
              f"mesh lockstep: ids {m.learned_ids}, staleness {m.staleness}")
        check_bitwise(torch, tree, rm, m, rd, d,
                      "mesh plane (mesh_shape 1) vs device plane, lockstep")
        say("mesh", f"(a) lockstep depth 1, clips 1, {lock_iters} updates: "
            "the mesh plane (mesh_shape 1: one lane, the mesh ring, the "
            "sharded step) equals the device plane bitwise in every metric "
            f"and all {len(tree.tree_leaves(m.params))} parameter leaves; "
            f"launches K2 {counts['vtrace_returns']}, K1 "
            f"{counts['nstep_returns']}")
        del runs, d, m

        # (b) depth 2 in turns: the planes' timesteps/s at the same shape
        rates = {"device": [], "mesh": []}
        k2 = None
        for plane in ("device", "mesh", "mesh", "device"):
            rl = build(plane, queue_depth=2)
            rl.run(warmup)
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            res = rl.run(iters)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(ops.launches)
            check(counts["vtrace_returns"] == iters
                  and counts["nstep_returns"] == 0,
                  f"{plane} plane depth 2: launches {counts}")
            check(all(math.isfinite(v) for v in res.mean_metrics.values()),
                  f"{plane} plane: non-finite metrics {res.mean_metrics}")
            if plane == "mesh":
                check(rl.learned_ids == [(-1, s) for s in range(iters)],
                      "mesh plane: a lane's seq was dropped or learned twice")
                check(max(rl.staleness) <= 3,
                      f"mesh plane: staleness {max(rl.staleness)} > depth + 1")
                if k2 is None:
                    k2 = counts["vtrace_returns"]
            rates[plane].append(res.timesteps_per_sec)
            say("mesh", f"(b) {plane} plane, depth 2, clips 1: {iters} "
                f"updates after {warmup} warm-up in {wall:.3f} s, "
                f"{iters / wall:.1f} updates/s, {res.timesteps_per_sec:.1f} "
                f"timesteps/s, staleness {res.mean_metrics['staleness']:.3f}"
                f", learner idle {res.learner_idle_s:.3f} s; launches K2 "
                f"{counts['vtrace_returns']} ({card})")
            del rl
        check(not plain_calls, f"the plain V-trace ran on {plain_calls}")
        lo, hi = min(rates["device"]), max(rates["device"])
        say("mesh", "timesteps/s, device plane "
            + ", ".join(f"{r:.1f}" for r in rates["device"])
            + "; mesh plane " + ", ".join(f"{r:.1f}" for r in rates["mesh"])
            + f"; mesh / device means "
            f"{sum(rates['mesh']) / sum(rates['device']):.3f}, the device "
            f"runs' own spread {(hi - lo) / lo:.3f}; the plain V-trace "
            "called 0 times")

        # (c) the trainer's mesh leg
        argv = ["--arch", "paac_vector", "--pipeline", "--rollout-plane",
                "mesh", "--mesh", "1", "--iterations", str(cli_iters),
                "--device", str(dev)]
        ops.reset_launches()
        t0 = time.perf_counter()
        out = train.main(argv)
        wall = time.perf_counter() - t0
        cli = dict(ops.launches)
        check(cli["vtrace_returns"] == cli_iters
              and cli["nstep_returns"] == 0, f"train mesh: launches {cli}")
        check(len(out) == 1 and out[0].steps == cli_iters * 16 * 8
              and all(math.isfinite(v) for v in out[0].mean_metrics.values()),
              f"train mesh: {out}")
        check(not plain_calls, f"the plain V-trace ran on {plain_calls}")
        say("mesh", f"(c) python -m repro_torch.launch.train "
            f"{' '.join(argv)}: {out[0].steps} steps in {wall:.2f} s, "
            f"{out[0].timesteps_per_sec:.1f} timesteps/s, launches K2 "
            f"{cli['vtrace_returns']}")
    finally:
        ops._ref.vtrace_returns_ref = real_plain
    return k2, cli["vtrace_returns"]


def _grad_norm(torch, tree, loss_fn, params) -> float:
    """Global L2 norm of the gradient of ``loss_fn(params)[0]`` (zero for the
    leaves the loss does not reach)."""
    leaves = [p.detach().requires_grad_(True) for p in tree.tree_leaves(params)]
    with torch.enable_grad():
        loss, _ = loss_fn(tree.tree_unflatten(params, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return tree.tree_global_norm(list(grads)).item()


AGENT_NAMES = ("dqn", "lagged grad", "lagged act", "ppo")


def make_agent(A, name: str, cfg):
    """The agents of the ``agents`` phase, each with the reference's
    default hyperparameters (lagged PAAC: t_max 5, delay 4; DQN: t_max 5,
    batch 128, target sync 100; PPO: t_max 16, 4 epochs)."""
    if name == "dqn":
        return A.DQNAgent(cfg, A.DQNConfig())
    if name == "ppo":
        return A.PPOAgent(cfg, A.PPOConfig())
    return A.LaggedPAACAgent(cfg, A.LaggedConfig(), name.split()[1])


def agents_card_vs_cpu(torch, configs, models, envs, A, replay, core, optim,
                       tree, dev="cuda"):
    """(a) One update of each agent on the same replayed data, on the CPU
    and on the card."""
    cfg = configs.get_config("paac_nature").replace(num_actions=3)
    cpu = models.init_policy(cfg, generator=torch.Generator().manual_seed(SEED),
                             device="cpu")
    # the stale copy of lagged PAAC and DQN's target network
    other = models.init_policy(
        cfg, generator=torch.Generator().manual_seed(SEED + 2), device="cpu")
    env = envs.FrameStack(envs.AtariLike(32, device="cpu"), 4)
    g = torch.Generator().manual_seed(SEED)
    state = env.reset(g)
    collect = A.PAACAgent(cfg, A.PAACConfig(t_max=16)).make_collect_step(env)
    _, _, traj, boot = collect(cpu, state, env.observe(state),
                               torch.Generator().manual_seed(SEED + 1), g)
    buf = replay.replay_init(16 * 32, env.obs_shape, device="cpu")
    for t in range(15):
        replay.replay_add(buf, traj.obs[t], traj.action[t], traj.reward[t],
                          traj.obs[t + 1], traj.done[t])
    batch = replay.replay_sample(buf, torch.Generator().manual_seed(SEED), 128)
    rms = optim.make_optimizer("rmsprop")
    lr = optim.constant(0.0007 * 32)
    to = lambda d: (lambda x: tree.tree_map(lambda t: t.to(d), x))  # noqa: E731
    Tr = type(traj)

    def run(name, d):
        mv = to(d)
        p, o, tr = mv(cpu), mv(other), Tr(*(x.to(d) for x in traj))
        agent = make_agent(A, name, cfg)
        if name == "dqn":
            bt = mv(batch)
            new, _, _, m = agent.make_update_step(rms, lr)(
                p, rms.init(p), {"target": o, "updates": 0}, bt, 0)
            gn = _grad_norm(torch, tree, lambda q: A.dqn.dqn_loss(
                q, o, bt, cfg, agent.hp.gamma), p)
        elif name == "ppo":
            b = boot.to(d)
            new, _, m = agent.make_update_step(rms, lr)(p, rms.init(p), tr, b,
                                                        0)
            adv, ret = core.gae_advantages(tr.reward, tr.done, tr.value, b,
                                           agent.hp.gamma, agent.hp.lam)
            gn = _grad_norm(torch, tree, lambda q: A.ppo.ppo_loss(
                q, cfg, agent.hp, tr, adv, ret), p)  # the first epoch's
        else:  # t_max 5: the first five steps, bootstrapped by V(s_6)
            short, sb = Tr(*(x[:5] for x in tr)), tr.value[5]
            new, _, _, m = agent.make_lagged_update(rms, lr)(
                p, rms.init(p), {"stale": o, "since": 0}, short, sb, 0)
            _, _, grads = A.paac.loss_and_grads(
                o if agent.mode == "grad" else p, cfg, agent.hp, short, sb)
            gn = tree.tree_global_norm(grads).item()
        return m["loss"].item(), gn, new

    for name in AGENT_NAMES:
        loss_c, gn_c, new_c = run(name, "cpu")
        loss_g, gn_g, new_g = run(name, dev)
        d_loss = abs(loss_c - loss_g)
        d_norm = abs(gn_c - gn_g) / max(1.0, abs(gn_c))
        d_param = max((a - b.cpu()).abs().max().item() for a, b in
                      zip(tree.tree_leaves(new_c), tree.tree_leaves(new_g)))
        moved = max((a - b).abs().max().item() for a, b in
                    zip(tree.tree_leaves(new_c), tree.tree_leaves(cpu)))
        check(d_loss <= RL_TOL, f"{name} loss: card vs CPU {d_loss:.3g}")
        check(d_norm <= RL_TOL, f"{name} grad norm: card {gn_g} vs CPU {gn_c}")
        check(d_param <= RL_TOL, f"{name} new parameters: card vs CPU "
              f"{d_param:.3g}")
        check(moved > 10 * RL_TOL, f"{name}: the update moved no parameter "
              f"({moved:.3g})")
        say("agents", f"(a) {name}, paac_nature full size fp32, one update "
            + ("on a replayed batch of 128" if name == "dqn" else
               "on a replayed 16x32 trajectory, 4 epochs" if name == "ppo"
               else "on a replayed 5x32 trajectory, stale copy unlike the "
               "params")
            + f": loss {loss_c:.6f} (|d| {d_loss:.3g}), grad norm {gn_c:.6f} "
            f"(rel d {d_norm:.3g}), new params max |d| {d_param:.3g} (largest "
            f"step {moved:.3g}); all <= {RL_TOL}")


def phase_agents(torch, configs, models, envs, A, replay, core, optim, tree,
                 ops, train, card, trained, dev="cuda", n_envs=32, warmup=10,
                 iters=50, lock_iters=10, window=10, replay_capacity=50_000,
                 eval_steps=1_000, cli_iters=50, compare_iters=100):
    """The framework's other agents in the paper's setting, ``evaluate`` on
    the parameters the training phase trained, the trainer's three legs and
    the baselines example. Returns the launch counts of the agents' timed
    runs and of the trainer's legs."""
    from torch.profiler import ProfilerActivity, profile

    leaves = tree.tree_leaves
    agents_card_vs_cpu(torch, configs, models, envs, A, replay, core, optim,
                       tree, dev)

    def build(name):
        env = envs.FrameStack(envs.AtariLike(n_envs, device=dev), 4)
        cfg = configs.get_config("paac_nature").replace(
            obs_shape=env.obs_shape, num_actions=env.num_actions)
        return core.ParallelRL(env, make_agent(A, name, cfg),
                               optimizer="rmsprop",
                               lr_schedule=optim.constant(0.0007 * n_envs),
                               seed=SEED, replay_capacity=replay_capacity,
                               device=dev)

    # (b) each agent through ParallelRL: one seed, one run (cuDNN
    # deterministic for this part), then timed
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for name in AGENT_NAMES:
            runs = []
            for _ in range(2):
                rl = build(name)
                res = rl.run(lock_iters)
                runs.append((res.mean_metrics, [t.clone() for t in
                                                leaves(rl.params)]))
                del rl
            (ma, pa), (mb, pb) = runs
            check(ma == mb, f"{name}: same-seed metrics {ma} != {mb}")
            diff = [i for i, (x, y) in enumerate(zip(pa, pb))
                    if not torch.equal(x, y)]
            check(not diff, f"{name}: same-seed parameter leaves {diff} "
                  "differ")
            del runs, pa, pb
    finally:
        torch.backends.cudnn.deterministic = False
    say("agents", f"(b) two same-seed ParallelRL runs of {lock_iters} "
        "iterations agree bitwise (every metric and parameter) for "
        + ", ".join(AGENT_NAMES))

    path = {k: 0 for k in ops.launches}
    for name in AGENT_NAMES:
        rl = build(name)
        rl.run(warmup)
        before = [t.clone() for t in leaves(rl.params)]
        ops.reset_launches()
        res = rl.run(iters)
        counts = dict(ops.launches)
        want = {k: 0 for k in counts}
        if name.startswith("lagged"):
            want["nstep_returns"] = iters
        check(counts == want, f"{name}: launches {counts}, expected {want}")
        for k, v in counts.items():
            path[k] += v
        m = res.mean_metrics
        check(all(math.isfinite(v) for v in m.values()),
              f"{name}: non-finite metrics {m}")
        changed = max((a - b).abs().max().item() for a, b in
                      zip(before, leaves(rl.params)))
        check(changed > 0, f"{name}: the parameters did not change")
        t_max = rl.agent.hp.t_max
        iter_ms = 1e3 * n_envs * t_max / res.timesteps_per_sec
        extra = ""
        if name == "dqn":
            buf = rl.agent_state["replay"]
            extra = (f"; replay buffer of {replay_capacity} transitions "
                     f"({tuple(buf['obs'].shape[1:])} {buf['obs'].dtype} obs "
                     f"and next_obs): {replay.replay_nbytes(buf)} bytes on "
                     f"the card, {buf['size']} filled")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rl.run(window)
            torch.cuda.synchronize()
        busy_ms, by_name = device_window(prof, window)
        classes = {}
        for k, (ms, n) in by_name.items():
            row = classes.setdefault(kernel_class(k), [0.0, 0.0])
            row[0] += ms
            row[1] += n
        say("agents", f"(b) {name}: {iters} iterations of {n_envs}x{t_max} "
            f"after {warmup} warm-up, launches K1 {counts['nstep_returns']} "
            f"K2 {counts['vtrace_returns']}; {res.timesteps_per_sec:.1f} "
            f"timesteps/s, {iter_ms:.2f} ms an iteration; mean loss "
            f"{m['loss']:.4f}, reward/iter {m['reward_sum']:+.3f}; largest "
            f"parameter change {changed:.3g}{extra}; profiler window of "
            f"{window}: device busy {busy_ms:.3f} ms an iteration "
            f"({100 * busy_ms / iter_ms:.1f}% of the unprofiled "
            f"{iter_ms:.2f} ms), {sum(n for _, n in by_name.values()):.0f} "
            "device activities an iteration; by class (ms, launches an "
            "iteration): " + "; ".join(
                f"{k} {ms:.3f} x{n:.0f}" for k, (ms, n) in
                sorted(classes.items(), key=lambda kv: -kv[1][0]))
            + f" ({card})")
        del rl
        if dev != "cpu":
            torch.cuda.empty_cache()

    # (c) the paper's Table-1 protocol on the trained PAAC parameters
    agent, params = trained
    env = envs.FrameStack(envs.AtariLike(n_envs, device=dev), 4)
    t0 = time.perf_counter()
    ev = core.evaluate(agent.act_fn(), env, params,
                       torch.Generator(device=dev).manual_seed(SEED),
                       n_runs=30, n_actor_seeds=3, max_steps=eval_steps)
    wall = time.perf_counter() - t0
    check(len(ev["per_seed"]) == 3
          and all(math.isfinite(v) for v in ev["per_seed"])
          and ev["best_of_k"] >= ev["mean"], f"evaluate: {ev}")
    say("agents", f"(c) evaluate, greedy, 3 seeds x 30 runs, max_steps "
        f"{eval_steps}, on FrameStack(AtariLike({n_envs})) with the "
        f"training phase's paac_nature parameters: best_of_k "
        f"{ev['best_of_k']:.4f}, mean {ev['mean']:.4f}, per_seed "
        f"{[round(v, 4) for v in ev['per_seed']]}; {wall:.2f} s ({card})")

    # (d) the trainer itself: its three legs
    base = ["--arch", "paac_vector", "--n-envs", "32", "--t-max", "5",
            "--iterations", str(cli_iters), "--device", str(dev)]
    legs = (("sync PAAC", [], "nstep_returns"),
            ("--pipeline", ["--pipeline"], "vtrace_returns"),
            ("--algo dqn", ["--algo", "dqn"], None))
    cli = {k: 0 for k in ops.launches}
    for label, extra, kernel in legs:
        ops.reset_launches()
        res = train.main(base + extra)
        counts = dict(ops.launches)
        want = {k: cli_iters if k == kernel else 0 for k in counts}
        check(counts == want, f"train {label}: launches {counts}, expected "
              f"{want}")
        check(len(res) == 1 and res[0].steps == cli_iters * 32 * 5
              and all(math.isfinite(v) for v in res[0].mean_metrics.values()),
              f"train {label}: {res}")
        for k, v in counts.items():
            cli[k] += v
        say("agents", f"(d) python -m repro_torch.launch.train "
            f"{' '.join(base + extra)}: {res[0].steps} steps, launches K1 "
            f"{counts['nstep_returns']} K2 {counts['vtrace_returns']}, "
            f"{res[0].timesteps_per_sec:.1f} timesteps/s (first run included),"
            f" reward/iter {res[0].mean_metrics['reward_sum']:+.3f} ({card})")

    # (e) the paper's stability argument, the order reported
    spec = importlib.util.spec_from_file_location(
        "compare_baselines_torch",
        Path(__file__).resolve().parent / "examples"
        / "compare_baselines_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    t0 = time.perf_counter()
    scores = example.run(iters=compare_iters, device=dev)
    check(len(scores) == 4 and all(math.isfinite(v) for v in scores.values()),
          f"compare_baselines_torch: {scores}")
    say("agents", f"(e) examples/compare_baselines_torch.py at "
        f"{compare_iters} iterations on Catch(32), reward an iteration over "
        "40 more (best first): " + ", ".join(
            f"{k} {v:+.3f}" for k, v in
            sorted(scores.items(), key=lambda kv: -kv[1]))
        + f"; {time.perf_counter() - t0:.1f} s")
    return ({k: v for k, v in path.items() if v},
            {k: v for k, v in cli.items() if v})


K3 = ("flash_attention",)
HYBRID_EXPERTS = {"num_layers": 5, "num_experts": 4, "num_experts_per_tok": 2}
MODEL_CASES = (  # (arch, config changes, prompt length, prefill kernels,
    #                decode kernel)
    ("qwen2-7b", {}, 37, K3, "decode_attention"),
    ("minicpm3-4b", {"mla_absorb": True}, 37, K3, "mla_decode_attention"),
    ("minicpm3-4b", {"mla_absorb": False}, 37, K3, None),
    ("mamba2-370m", {}, 64, ("ssd_scan",), None),  # two chunks of 32
    ("glm4-9b", {}, 37, K3, "decode_attention"),
    ("deepseek-coder-33b", {}, 37, K3, "decode_attention"),
    # the MoE trunks at capacity factor 16, as the reference's decode
    # consistency test runs them: no token drops on either side
    ("dbrx-132b", {"moe_capacity_factor": 16.0}, 37, K3, "decode_attention"),
    ("deepseek-v2-236b", {"mla_absorb": True, "moe_capacity_factor": 16.0},
     37, K3, "mla_decode_attention"),
    ("deepseek-v2-236b", {"mla_absorb": False, "moe_capacity_factor": 16.0},
     37, K3, None),
    # the hybrid: two groups of 2 Mamba2 layers and a tail of 1 (K6 five
    # times a prefill), the shared block applied twice (K3 twice a
    # prefill, K4 twice a step); two chunks of 32
    ("zamba2-7b", {"num_layers": 5}, 64, ("ssd_scan", "flash_attention"),
     "decode_attention"),
    # the hybrid with experts (4, top 2), the shared block as the
    # reference builds it: dense while d_ff is set (the experts ignored),
    # the MoE block at d_ff 0 (experts 128 wide, cf 16: no drops on
    # either side)
    ("zamba2-7b", HYBRID_EXPERTS, 64, ("ssd_scan", "flash_attention"),
     "decode_attention"),
    ("zamba2-7b", dict(HYBRID_EXPERTS, d_ff=0, moe_d_ff=128,
                       moe_capacity_factor=16.0), 64,
     ("ssd_scan", "flash_attention"), "decode_attention"),
    # a ring of 16 slots, wrapped by the prompt and the steps (K3 windowed)
    ("qwen2-7b", {"sliding_window": 16}, 37, K3, "decode_attention"),
    ("minicpm3-4b", {"mla_absorb": True, "sliding_window": 16}, 37, K3,
     "mla_decode_attention"),
    # a prefix of 8 patches; 16 frames through the encoder, each decoder
    # layer's cross-attention (K3 and K4 twice a decoder layer)
    ("pixtral-12b", {}, 37, K3, "decode_attention"),
    ("seamless-m4t-large-v2", {}, 37, K3, "decode_attention"),
)


def kernel_layers(cfg, kernel: str) -> int:
    """Launches of ``kernel`` in one prefill or decode step of ``cfg``: a
    hybrid runs K6 in each Mamba2 layer and its attention kernels once an
    application of the shared block; an encoder-decoder runs K3 in each
    encoder layer and twice in each decoder layer (self and cross), K4
    twice a decoder layer; every other trunk runs its kernel in every
    layer."""
    if cfg.family == "hybrid" and kernel != "ssd_scan":
        return cfg.num_layers // cfg.shared_attn_every
    if cfg.is_encoder_decoder:
        enc = cfg.encoder_layers if kernel == "flash_attention" else 0
        return enc + 2 * cfg.num_layers
    return cfg.num_layers


def front_embeds(torch, cfg, batch: int, generator, dev, dtype=None):
    """Random front-end embeddings from ``generator`` for a vision trunk's
    prefix (prefix_len patches) or an encoder-decoder's encoder
    (encoder_seq_len frames), (batch, n, frontend_dim); None for a text
    trunk."""
    if not cfg.frontend_dim:
        return None
    n = cfg.prefix_len if cfg.family == "vlm" else cfg.encoder_seq_len
    x = torch.randn((batch, n, cfg.frontend_dim), generator=generator,
                    device=dev)
    return x if dtype is None else x.to(dtype)


def prefix_offset(cfg) -> int:
    """Positions a vision trunk's patches take before the text."""
    return cfg.prefix_len if cfg.family == "vlm" else 0


def phase_model(torch, np, configs, models, ops, paac, optim, tree,
                dev="cuda"):
    """Each of ``MODEL_CASES`` reduced, fp32: CPU (plain versions) against
    the card (kernels), prefill and four decode steps with per-row and
    scalar positions; the hybrid with experts also one train step."""
    for arch, change, S, pre, dec in MODEL_CASES:
        cfg = configs.get_config(arch).reduced().replace(**change)
        cpu = models.init_policy(
            cfg, generator=torch.Generator().manual_seed(SEED), device="cpu")
        gpu = tree.tree_map(lambda t: t.to(dev), cpu)
        rng = np.random.default_rng(SEED)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S)))
        front = front_embeds(torch, cfg, 2,
                             torch.Generator().manual_seed(SEED), "cpu")
        front_g = None if front is None else front.to(dev)
        off = prefix_offset(cfg)
        ops.reset_launches()
        lc, _, cache_c = models.policy_prefill(cpu, cfg, toks, front,
                                               max_len=off + S + 11)
        lg, _, cache_g = models.policy_prefill(gpu, cfg, toks.to(dev),
                                               front_g, max_len=off + S + 11)
        worst = (lc - lg.cpu()).abs().max().item()
        S = off + S  # the decode positions follow the patch prefix
        steps = [torch.tensor([S, S + 3], dtype=torch.int32), S + 4, S + 5,
                 torch.tensor([S + 6, S + 1], dtype=torch.int32)]
        for pos in steps:
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
            pos_g = pos.to(dev) if isinstance(pos, torch.Tensor) else pos
            lc, _, cache_c = models.policy_decode(cpu, cfg, cache_c, tok, pos)
            lg, _, cache_g = models.policy_decode(gpu, cfg, cache_g,
                                                  tok.to(dev), pos_g)
            worst = max(worst, (lc - lg.cpu()).abs().max().item())
        counts = dict(ops.launches)
        L = cfg.num_layers
        want = {name: 0 for name in counts}
        for name in pre:
            want[name] = kernel_layers(cfg, name)
        if dec:
            want[dec] = kernel_layers(cfg, dec) * len(steps)
        check(counts == want, f"reduced {arch} {change}: launches {counts}, "
              f"expected {want}")
        check(worst <= MODEL_ATOL, f"reduced {arch} {change} logits: card vs "
              f"CPU {worst:.3g}")
        say("model", f"reduced {arch} {change} fp32 (L={L} d={cfg.d_model}): "
            f"prefill of {S - off} tokens after {off} patches + 4 decode "
            "steps (per-row "
            "and scalar pos), card "
            f"vs CPU max |dlogit| {worst:.3g} <= {MODEL_ATOL}; launches "
            + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
        if cfg.family == "hybrid" and cfg.num_experts:
            shared = gpu["trunk"]["shared"]
            check(("moe" in shared) == (cfg.d_ff == 0),
                  f"reduced {arch} {change}: shared block {sorted(shared)}")
            train_step_card_vs_cpu(torch, np, models, ops, paac, optim, tree,
                                   cfg, "model", dev)


FLASH_GRAD = (  # (B, Sq, Sk, H, Hkv, D, Dv, causal, window, timed in bf16 as)
    # qwen2-7b's and minicpm3-4b's attention in the training cells
    (4, 512, 512, 28, 4, 128, 128, True, 0, "qwen2-7b training, B=4 T=512"),
    (2, 512, 512, 28, 4, 128, 128, True, 100, ""),  # windowed
    (4, 512, 512, 40, 40, 96, 64, True, 0, "minicpm3-4b training, B=4 T=512"),
    (1, 300, 300, 16, 16, 192, 128, True, 0, ""),  # deepseek-v2's MLA, ragged
    (2, 128, 1024, 16, 16, 64, 64, False, 0, ""),  # cross-attention, Sq < Sk
    (1, 700, 700, 8, 2, 64, 64, True, 0, ""),  # two 512-key blocks
)
GRAD_TOL = 1e-4  # absolute + relative, fp32, TF32 off


def phase_flash_grad(torch, np, F, ref, ops, rows, dev="cuda"):
    """K3's gradient (``ops.FlashAttention``: K3 with its LSE, then the
    plain backward ``ref.flash_attention_bwd``) against torch's autograd
    through ``flash_attention_ref`` on the card in fp32, over
    ``FLASH_GRAD``; the backward alone timed in bf16 at the training cells'
    shapes beside autograd through the plain version and SDPA's backward.
    The numbers go into the K3 row as ``"backward"``."""
    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    back = {"route": "torch", "source": "src/repro_torch/kernels/ref.py",
            "ports": "src/repro/models/attention.py:109", "max_abs_err": 0.0,
            "tolerance": f"atol {GRAD_TOL} + rtol {GRAD_TOL} (fp32)"}
    for B, Sq, Sk, H, Hkv, D, Dv, causal, window, timed in FLASH_GRAD:
        shapes = ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, Dv))
        base = [torch.randn(s, generator=g, device=dev) for s in shapes]
        do = torch.randn((B, Sq, H, Dv), generator=g, device=dev)
        x = [t.clone().requires_grad_(True) for t in base]
        y = [t.clone().requires_grad_(True) for t in base]
        before = ops.launches["flash_attention"]
        out = ops.flash_attention(*x, causal=causal, window=window)
        check(ops.launches["flash_attention"] == before + 1,
              "the differentiable K3 did not launch the kernel")
        out.backward(do)
        ref.flash_attention_ref(*y, causal=causal, window=window).backward(do)
        worst = 0.0
        for name, a, b in zip("qkv", x, y):
            err = (a.grad - b.grad).abs()
            ok = bool((err <= GRAD_TOL + GRAD_TOL * b.grad.abs()).all())
            check(bool(torch.isfinite(a.grad).all()) and ok,
                  f"K3's d{name} disagrees with autograd through the plain "
                  f"version: max err {err.max().item():.3g}")
            worst = max(worst, err.max().item())
        back["max_abs_err"] = max(back["max_abs_err"], worst)
        say("flash grad", f"fp32 B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} D={D} "
            f"Dv={Dv} {'causal' if causal else 'non-causal'} window={window}: "
            f"dq, dk, dv max_abs_err {worst:.3g} (atol {GRAD_TOL} + rtol "
            f"{GRAD_TOL})")
        if not timed:
            continue
        bf = [t.to(torch.bfloat16) for t in base]
        dob = do.to(torch.bfloat16)
        with torch.no_grad():
            o, lse = ops.flash_attention_cuda(*bf, causal=causal,
                                              window=window, return_lse=True)
        ms = time_ms(torch, lambda: ref.flash_attention_bwd(
            *bf, o, lse, dob, causal=causal, window=window), flush, iters=10)
        p = [t.clone().requires_grad_(True) for t in bf]
        o_ref = ref.flash_attention_ref(*p, causal=causal, window=window)
        plain_ms = time_ms(torch, lambda: torch.autograd.grad(
            o_ref, p, dob, retain_graph=True), flush, iters=10)
        st = [t.transpose(1, 2).detach().requires_grad_(True) for t in bf]
        o_lib = F.scaled_dot_product_attention(*st, is_causal=causal,
                                               enable_gqa=True)
        lib_ms = time_ms(torch, lambda: torch.autograd.grad(
            o_lib, st, dob.transpose(1, 2), retain_graph=True), flush,
            iters=10)
        pairs = flash_pairs(np, Sq, Sk, causal, window)
        # read q, k, v, o, dO (bf16) and the lse; write dq, dk, dv
        nbytes = (2 * (2 * sum(t.numel() for t in bf) + o.numel()
                       + dob.numel()) + 4 * lse.numel())
        flops = 2 * (3 * D + 2 * Dv) * pairs * H * B
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        t = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                 bound_by=b_by, shape=f"bf16 B={B} S={Sq} H={H} Hkv={Hkv} "
                 f"D={D} Dv={Dv} causal ({timed})")
        if "ms" in back:
            back.setdefault("other", []).append(t)
        else:
            back.update(t)
        say("flash grad", f"K3 backward timed ({t['shape']}): "
            f"ref.flash_attention_bwd {ms:.4f} ms, autograd through the plain "
            f"version {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        del p, o_ref, st, o_lib
    rows["flash_attention"]["backward"] = back
    del flush


SSD_GRAD = (  # (B, S, H, P, N, chunk, timed in bf16 as)
    # mamba2-370m's and zamba2-7b's Mamba2 layers in the training cells
    (4, 512, 32, 64, 128, 128, "mamba2-370m training, B=4 T=512"),
    (4, 512, 112, 64, 64, 128, "zamba2-7b training, B=4 T=512"),
    (2, 64, 8, 64, 16, 64, ""),  # one chunk
    (1, 128, 112, 64, 64, 128, ""),  # F21: past e^88 in one chunk
)
SSD_DT_MAX = 0.1  # dt in [1e-3, 0.1), the span init_mamba2 gives dt


def ssd_grad_inputs(torch, g, dev, B, S, H, P, N):
    """A Mamba2 layer's scan inputs as the model feeds them (dt in
    [1e-3, SSD_DT_MAX), A_log = log(1..H) as ``init_mamba2`` sets it) and
    the two cotangents, fp32."""
    return ([torch.randn(B, S, H, P, generator=g, device=dev),
             1e-3 + (SSD_DT_MAX - 1e-3) * torch.rand(B, S, H, generator=g,
                                                      device=dev),
             torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                    device=dev)),
             torch.randn(B, S, N, generator=g, device=dev) / N ** 0.5,
             torch.randn(B, S, N, generator=g, device=dev) / N ** 0.5,
             torch.randn(H, generator=g, device=dev)],
            torch.randn(B, S, H, P, generator=g, device=dev),
            torch.randn(B, H, P, N, generator=g, device=dev))


def phase_ssd_grad(torch, ref, ops, rows, dev="cuda"):
    """K6's gradient (``ops.SSDScan``: K6 forward, the plain backward
    ``ref.ssd_scan_bwd``) against torch's autograd through
    ``ssd_scan_ref`` on the card in fp32, over ``SSD_GRAD``: K6's y and
    state within SSD_TOL of the plain version's; all six gradients,
    cotangents on y and on the state, finite and within GRAD_TOL of each
    gradient's largest value; the largest decay a chunk sums (past 88,
    ``ssd_chunked``'s gradient is NaN: F21). At the training shapes, in
    bf16: K6's y within BF16_TOL and its state within SSD_TOL of the plain
    version's, the forward with a gradient bitwise the one without, the
    forward (K6) and the backward alone timed beside autograd through the
    plain version. The numbers go into the K6 row as ``"backward"``; the
    forwards' errors into its ``max_abs_err``."""
    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    back = {"route": "torch", "source": "src/repro_torch/kernels/ref.py",
            "ports": "src/repro/models/ssm.py:71", "max_abs_err": 0.0,
            "tolerance": f"{GRAD_TOL} (1 + max |grad|) (fp32)"}
    for B, S, H, P, N, Q, timed in SSD_GRAD:
        base, dy, ds = ssd_grad_inputs(torch, g, dev, B, S, H, P, N)
        a = (-torch.exp(base[2]) * base[1]).reshape(B, S // Q, Q, H)
        decay = float(-a.sum(2).min())
        x = [t.clone().requires_grad_(True) for t in base]
        y = [t.clone().requires_grad_(True) for t in base]
        before = ops.launches["ssd_scan"]
        out = ops.ssd_scan(*x, chunk=Q)
        check(ops.launches["ssd_scan"] == before + 1,
              "the differentiable K6 did not launch the kernel")
        out_ref = ref.ssd_scan_ref(*y, chunk=Q)
        fwd_err = max(within_rel(torch, o.detach(), r.detach(), SSD_TOL,
                                 SSD_TOL, f"K6 {what} fp32")
                      for what, o, r in zip(("y", "state"), out, out_ref))
        rows["ssd_scan"]["max_abs_err"] = max(
            rows["ssd_scan"]["max_abs_err"], fwd_err)
        torch.autograd.backward(out, (dy, ds))
        torch.autograd.backward(out_ref, (dy, ds))
        worst = 0.0
        for name, u, v in zip(("x", "dt", "A_log", "B", "C", "D"), x, y):
            err = (u.grad - v.grad).abs().max().item()
            scale = 1.0 + v.grad.abs().max().item()
            check(bool(torch.isfinite(u.grad).all())
                  and err <= GRAD_TOL * scale,
                  f"K6's d{name} disagrees with autograd through the plain "
                  f"version: max err {err:.3g} at max |grad| {scale - 1:.3g}")
            worst = max(worst, err / scale)
        back["max_abs_err"] = max(back["max_abs_err"], worst)
        say("ssd grad", f"fp32 B={B} S={S} H={H} P={P} N={N} chunk={Q}, dt "
            f"up to {SSD_DT_MAX}: largest decay a chunk sums {decay:.1f} "
            f"({'past' if decay > 88 else 'below'} e^88); K6's y and state "
            f"max_abs_err {fwd_err:.3g} (atol {SSD_TOL} + rtol {SSD_TOL}); "
            f"all six gradients finite, max err {worst:.3g} of (1 + max "
            f"|grad|) (<= {GRAD_TOL})")
        if not timed:
            continue
        bf = [t.to(torch.bfloat16) if i in (0, 3, 4) else t
              for i, t in enumerate(base)]
        dyb = dy.to(torch.bfloat16)
        with torch.no_grad():
            y0, s0 = ops.ssd_scan(*bf, chunk=Q)
            y_ref, s_ref = ref.ssd_scan_ref(*[t.float() for t in bf],
                                            chunk=Q)
        bf_err = max(within_rel(torch, y0, y_ref, BF16_TOL, BF16_TOL,
                                "K6 y bf16"),
                     within_rel(torch, s0, s_ref, SSD_TOL, SSD_TOL,
                                "K6 state bf16"))
        rows["ssd_scan"]["max_abs_err"] = max(
            rows["ssd_scan"]["max_abs_err"], bf_err)
        p = [t.clone().requires_grad_(True) for t in bf]
        y1, s1 = ops.ssd_scan(*p, chunk=Q)
        check(torch.equal(y1.detach(), y0) and torch.equal(s1.detach(), s0),
              "K6's bf16 forward with a gradient differs from the one "
              "without")
        fwd_ms = time_ms(torch, lambda: ops.ssd_scan_cuda(*bf, chunk=Q),
                         flush, iters=10)
        ms = time_ms(torch, lambda: ref.ssd_scan_bwd(*bf, dyb, ds, chunk=Q),
                     flush, iters=10)
        q = [t.clone().requires_grad_(True) for t in bf]
        out = ref.ssd_scan_ref(*q, chunk=Q)
        plain_ms = time_ms(torch, lambda: torch.autograd.grad(
            out, q, (dyb, ds), retain_graph=True), flush, iters=10)
        # read the six inputs and both cotangents, write the six gradients
        nbytes = 2 * sum(t.numel() * t.element_size() for t in bf) + (
            dyb.numel() * 2 + ds.numel() * 4)
        nc, tri = S // Q, Q * (Q + 1) // 2
        fwd_flops = B * H * (nc * (2 * N * tri + 2 * P * tri + 2 * Q * P * N)
                             + (nc - 1) * 2 * Q * N * P)
        b_ms, b_by = bound(nbytes, 2 * fwd_flops, "bfloat16")
        t = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                 bound_by=b_by, forward_ms=fwd_ms,
                 shape=f"bf16 B={B} S={S} H={H} P={P} N={N} chunk={Q} "
                 f"({timed})")
        if "ms" in back:
            back.setdefault("other", []).append(t)
        else:
            back.update(t)
        say("ssd grad", f"K6 forward and backward timed ({t['shape']}): K6's "
            f"y and state max_abs_err {bf_err:.3g} (y: atol {BF16_TOL} + rtol "
            f"{BF16_TOL}; state: atol {SSD_TOL} + rtol {SSD_TOL}); K6 "
            f"{fwd_ms:.4f} ms; ref.ssd_scan_bwd (exponents in float64) {ms:.4f} "
            f"ms, autograd through the plain version (fp32) {plain_ms:.4f} "
            f"ms, bound {b_ms:.4f} ms ({b_by}), library none; the forward "
            "with a gradient bitwise the one without")
        del p, q, out, y1, s1, y_ref, s_ref
    rows["ssd_scan"]["backward"] = back
    del flush


TRAIN_TOL = 1e-4  # card (kernels) vs CPU (plain versions), fp32, TF32 off
TRAIN_ARCHS = ("qwen2-7b", "minicpm3-4b", "dbrx-132b", "deepseek-v2-236b",
               "pixtral-12b", "seamless-m4t-large-v2", "mamba2-370m",
               "zamba2-7b")
# The full-width training cells: (arch, layers kept, B, T, steps). Depth is
# what one card's 80 GB forces under the functional RMSProp update, whose
# peak holds params, grads, their clipped copy, the old and new fp32
# squares and the new params, about 18.7 bytes a parameter in all: 13 of
# qwen2-7b's 28 layers peak at 77.3 GB and 14 do not fit; minicpm3-4b's
# peak grows 1.24 GB a layer, 74.7 GB at 56 (PERF.md §4). mamba2-370m
# trains at full depth; zamba2-7b at 45 of 81 layers, 7 groups of 6 and
# the published tail of 3 (~3.9 B parameters, beside qwen2-7b's 4.1 B at
# 77.3 GB; scripts/train_depth_probe.py).
TRAIN_CELLS = (
    ("qwen2-7b", 13, 4, 512, 4),
    ("minicpm3-4b", 58, 4, 512, 4),
    ("mamba2-370m", 48, 4, 512, 4),
    ("zamba2-7b", 45, 4, 512, 4),
)
# One step each of the other attention families on the card: a reduced
# MoE in bf16 with remat, and pixtral-12b and seamless-m4t-large-v2 at
# every published width, cut to 2 layers (2 + 2), with 1024 patch or
# frame embeddings before or beside 128 text tokens.
TRAIN_ONE_STEP = (
    ("dbrx-132b", "reduced", 4, 512),
    ("deepseek-v2-236b", "reduced", 4, 512),
    ("pixtral-12b", {"num_layers": 2}, 2, 128),
    ("seamless-m4t-large-v2", {"num_layers": 2, "encoder_layers": 2}, 2, 128),
)


def train_batch(torch, np, cfg, B: int, T: int, seed: int):
    """A numpy-drawn trajectory batch, dones at a 20% rate, and the
    prefix or frames a vision or encoder-decoder trunk reads."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T + 1)),
             "rewards": rng.random((B, T), dtype=np.float32),
             "dones": rng.random((B, T)) < 0.2}
    if cfg.modality == "vision":
        batch["prefix"] = rng.standard_normal(
            (B, cfg.prefix_len, cfg.frontend_dim), dtype=np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.frontend_dim), dtype=np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def train_counts(cfg):
    """(launches, backward calls) of one ``make_llm_train_step`` of
    ``cfg``, by kernel. K3 runs in each attention layer's forward (an
    encoder-decoder's encoder layers, self and cross in each decoder
    layer; a hybrid's shared block once a group), K6 in each Mamba2
    layer's, each twice under remat (the backward runs the layer or the
    group again); each plain backward runs once a layer; K1 once; every
    other kernel never."""
    twice = 2 if cfg.remat != "none" else 1
    mamba = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    attn = (0 if cfg.family == "ssm"
            else kernel_layers(cfg, "flash_attention"))
    return ({"flash_attention": twice * attn, "ssd_scan": twice * mamba,
             "nstep_returns": 1}, {"flash_attention": attn, "ssd_scan": mamba})


def train_step_card_vs_cpu(torch, np, models, ops, paac, optim, tree, cfg,
                           phase: str, dev="cuda") -> None:
    """One ``make_llm_train_step`` (RMSProp) of ``cfg`` in fp32 on the CPU
    (plain versions) and on the card (kernels) from the same weights and
    batch: metrics and new params within ``TRAIN_TOL``, the kernels
    launched as ``train_counts`` says."""
    cpu = models.init_policy(
        cfg, generator=torch.Generator().manual_seed(SEED), device="cpu")
    gpu = tree.tree_map(lambda t: t.to(dev), cpu)
    batch = train_batch(torch, np, cfg, 2, 16, SEED)
    out = {}
    for where, params, d in (("cpu", cpu, "cpu"), ("card", gpu, dev)):
        opt = optim.make_optimizer("rmsprop")
        step = paac.PAACAgent(cfg, paac.PAACConfig()).make_llm_train_step(
            opt, optim.constant(1e-3))
        ops.reset_launches()
        new, _, m = step(params, opt.init(params),
                         {k: v.to(d) for k, v in batch.items()}, 0)
        out[where] = (new, m, dict(ops.launches))
    (pc, mc, _), (pg, mg, counts) = out["cpu"], out["card"]
    want = {k: 0 for k in counts}
    want.update(train_counts(cfg)[0])
    what = f"reduced {cfg.name}"
    check(counts == want, f"{what} train step launches {counts}, expected "
          f"{want}")
    dl = max(abs(float(mc[k]) - float(mg[k])) / max(abs(float(mc[k])), 1.0)
             for k in mc)
    dp = max((a - b.cpu()).abs().max().item() for a, b in
             zip(tree.tree_leaves(pc), tree.tree_leaves(pg)))
    check(dl <= TRAIN_TOL and dp <= TRAIN_TOL,
          f"{what} train step: card vs CPU metrics {dl:.3g}, params {dp:.3g}")
    say(phase, f"{what} fp32 (L={cfg.num_layers} d={cfg.d_model}"
        f"{', %d experts top %d, d_ff %d' % (cfg.num_experts, cfg.num_experts_per_tok, cfg.d_ff) if cfg.num_experts else ''}"
        "), one make_llm_train_step (RMSProp) at B=2 T=16, card vs CPU: loss "
        f"{float(mg['loss']):.5f}, moe_aux {float(mg.get('moe_aux', 0.0)):.3g}"
        f", metrics within {dl:.3g}, new parameters within {dp:.3g} (<= "
        f"{TRAIN_TOL}); launches " + ", ".join(
            f"{k} {v}" for k, v in counts.items() if v))


def phase_token_training(torch, np, configs, models, ops, paac, optim, train,
                         tree, card, first_cell, dev="cuda"):
    """The token policies' training path: (a) the full-width cells
    ``TRAIN_CELLS`` through ``launch/train.py``'s synthetic code, each in
    a fresh process (``first_cell``, from ``start_train_cell``, is the
    first's; each starts the next while it runs); (b) one ``make_llm_train_step``
    of each of ``TRAIN_ARCHS`` reduced, fp32, on the card (kernels) and on
    the CPU (plain versions) from the same weights and batch; (c) one step
    of each of ``TRAIN_ONE_STEP``. Returns the launch counts of (a) and
    (c)."""
    gc.collect()
    torch.cuda.empty_cache()  # the cells' processes need the card's memory
    path = {}

    def add(counts, backward):
        for name, n in counts.items():
            path[name] = path.get(name, 0) + n
        for name, n in backward.items():
            path[f"{name} backward"] = path.get(f"{name} backward", 0) + n

    proc = first_cell
    for i, spec in enumerate(TRAIN_CELLS):
        arch, layers = spec[:2]
        cfg = configs.get_config(arch)
        cfg = cfg.replace(num_layers=layers) if layers else cfg
        cell, proc = run_train_cell(proc, spec, TRAIN_CELLS[i + 1]
                                    if i + 1 < len(TRAIN_CELLS) else None)
        check_train_cell(cell, cfg, card)
        add(cell["counts"], cell["backward_calls"])

    for arch in TRAIN_ARCHS:
        train_step_card_vs_cpu(torch, np, models, ops, paac, optim, tree,
                               configs.get_config(arch).reduced(),
                               "token training", dev)

    with grad_norms() as norms:
        for arch, change, B, T in TRAIN_ONE_STEP:
            cfg = configs.get_config(arch)
            if change == "reduced":
                cfg = cfg.reduced().replace(param_dtype="bfloat16",
                                            compute_dtype="bfloat16",
                                            remat="full")
            else:
                cfg = cfg.replace(**change)
            norms.clear()
            ops.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            res = train.synthetic_steps(cfg, B, T, 1, SEED, dev)
            counts = dict(ops.launches)
            add(counts, ops.backward_calls)
            gn = float(norms[0])
            want, _ = train_counts(cfg)
            check(all(counts[k] == n for k, n in want.items()),
                  f"{arch} one training step launched {counts}")
            check(math.isfinite(res["losses"][0]) and math.isfinite(gn),
                  f"{arch} one training step: loss {res['losses']}, grad "
                  f"norm {gn}")
            say("token training", f"{arch} ({change}) bf16, remat "
                f"{cfg.remat!r}: one step at B={B} T={T}, loss "
                f"{res['losses'][0]:.4f}, grad norm {gn:.4g}, K3 "
                f"{counts['flash_attention']}, K1 {counts['nstep_returns']}, "
                f"{res['seconds'] * 1e3:.0f} ms with the batch, peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            torch.cuda.empty_cache()
    return path


@contextlib.contextmanager
def grad_norms():
    """Yields a list that gets the global gradient norm of each optimizer
    update inside the block, read where the optimizer clips."""
    from repro_torch.optim import optimizer as opt_mod

    norms = []
    real_clip = opt_mod.clip_by_global_norm

    def watched_clip(grads, max_norm):
        grads, norm = real_clip(grads, max_norm)
        norms.append(norm)
        return grads, norm

    opt_mod.clip_by_global_norm = watched_clip
    try:
        yield norms
    finally:
        opt_mod.clip_by_global_norm = real_clip


def train_cell(torch, configs, ops, train, spec, dev="cuda") -> dict:
    """One full-width training cell of ``TRAIN_CELLS``, ``spec`` = (arch,
    layers kept, B, T, steps): the steps through ``train.synthetic_steps``
    with the launches read after each, the global grad norm read where
    RMSProp clips, step 3 in a profiler window, and the peak memory.
    Returns the numbers as a JSON-able dict."""
    from torch.profiler import ProfilerActivity, profile

    t_run = time.perf_counter()
    arch, layers, B, T, iters = spec
    cfg = configs.get_config(arch)
    full = cfg.num_layers
    cfg = cfg.replace(num_layers=layers) if layers else cfg
    steps = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = []

    def on_step(i, metrics):
        steps.append((time.perf_counter(), dict(ops.launches)))
        if i == 1:  # profile step 3 alone
            prof.__enter__()
            window.append(i)
        elif i == 2:
            prof.__exit__(None, None, None)
            window.append(i)

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with grad_norms() as norms:
            res = train.synthetic_steps(cfg, B, T, iters, SEED, dev,
                                        on_step=on_step)
    finally:
        if len(window) == 1:
            prof.__exit__(None, None, None)
    wall = time.perf_counter() - t0

    def per_step(name):
        before = [{name: 0}] + [c for _, c in steps[:-1]]
        return [c[name] - b[name] for b, (_, c) in zip(before, steps)]

    walls = [b[0] - a[0] for a, b in zip(steps, steps[1:])]
    t_read = time.perf_counter()
    busy_ms, host = device_window(prof, 1)[0], host_window(prof)
    return {"arch": arch, "layers": cfg.num_layers, "of": full, "B": B,
            "T": T, "steps": iters, "n_params": res["n_params"],
            "losses": res["losses"], "grad_norms": [float(n) for n in norms],
            "a_step": {name: per_step(name) for name in ops.launches},
            "counts": dict(ops.launches),
            "backward_calls": dict(ops.backward_calls),
            "step_ms": 1e3 * sum(walls) / len(walls), "busy_ms": busy_ms,
            "host": host, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "wall_s": wall, "read_s": time.perf_counter() - t_read,
            "run_s": time.perf_counter() - t_run}


def start_train_cell(spec):
    """Starts ``train_cell`` for ``spec`` in a fresh process
    (``chip_smoke.py --train-cell``) on the caching allocator's expandable
    segments: a cell needs all but a few GB of the card, and in one long
    process its peak met the fragmentation of the blocks around it. The
    process imports what it needs, then waits for ``run_train_cell`` before
    it touches the card, so its start overlaps the work before it."""
    env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--train-cell",
         ",".join(map(str, spec))], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def run_train_cell(proc, spec, next_spec=None):
    """Lets the process ``start_train_cell`` gave run its cell, starts
    ``next_spec``'s while it runs, and returns (the cell's numbers, the
    next cell's process)."""
    t0 = time.perf_counter()
    proc.stdin.write("go\n")
    proc.stdin.flush()
    nxt = start_train_cell(next_spec) if next_spec else None
    out, err = proc.communicate(timeout=900)
    check(proc.returncode == 0, f"training cell {spec} failed (exit "
          f"{proc.returncode}):\n{out[-2000:]}\n{err[-4000:]}")
    cell = json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])
    cell["process_s"] = time.perf_counter() - t0
    return cell, nxt


KERNEL_NAMES = {"flash_attention": "K3", "ssd_scan": "K6",
                "nstep_returns": "K1"}


def check_train_cell(cell, cfg, card) -> None:
    """The gates of a training cell, then its report line: each kernel's
    launches in every step and each plain backward's calls as
    ``train_counts`` gives them, every other kernel never."""
    arch, iters = cell["arch"], cell["steps"]
    launches, backward = train_counts(cfg)
    for name, steps in cell["a_step"].items():
        n = launches.get(name, 0)
        check(steps == [n] * iters, f"{arch} training: {name} launches a "
              f"step {steps}, expected {n}")
    for name, n in backward.items():
        got = cell["backward_calls"][name]
        check(got == iters * n, f"{arch} training: {name}'s backward ran "
              f"{got} times, expected {iters * n}")
    losses, gn, host = cell["losses"], cell["grad_norms"], cell["host"]
    check(len(gn) == iters and all(math.isfinite(x) for x in losses + gn),
          f"{arch} training: losses {losses}, grad norms {gn}")
    check(len(set(losses)) > 1, f"{arch} training: the loss did not "
          f"change: {losses}")
    B, T = cell["B"], cell["T"]
    widths = (f"d_model {cfg.d_model}, vocab {cfg.vocab_size}"
              + (f", {cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff "
                 f"{cfg.d_ff}" if cfg.family != "ssm" else "")
              + (f", {cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} "
                 f"SSD heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}"
                 if cfg.family in ("ssm", "hybrid") else ""))
    kernels = "; ".join(
        f"{KERNEL_NAMES[k]} {n} a step" + (
            f" (the forward and the remat recompute) and its backward "
            f"{backward[k]}" if backward.get(k) else "")
        for k, n in launches.items() if n)
    say("token training", f"{arch} bf16 at every published width "
        f"({widths}), {cell['layers']} of {cell['of']} layers, "
        f"{cell['n_params'] / 1e9:.3f} B params, remat {cfg.remat!r}, "
        f"RMSProp, in a fresh process: {iters} steps at B={B} T={T}: "
        f"{kernels}; "
        f"{B * T / (cell['step_ms'] / 1e3):.1f} tokens/s, a step "
        f"{cell['step_ms']:.1f} ms wall (steps 2-{iters}), profiled step 3 "
        f"busy {cell['busy_ms']:.1f} ms; {host['launches']} kernel "
        f"launches in it, " + (
            f"{cell['step_ms'] * 1e3 / host['launches']:.1f} us"
            if host["launches"] else "no time") + " "
        f"of the unprofiled step's wall a launch; {host['waits']} runtime "
        f"calls that wait on the card, {host['wait_ms']:.1f} ms in all; most "
        "host ms: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                host["top_runtime_ms"].items())
        + f"; peak memory {cell['peak_gb']:.2f} "
        "GB; losses " + ", ".join(f"{x:.4f}" for x in losses)
        + "; global grad norms " + ", ".join(f"{x:.4g}" for x in gn)
        + f"; {cell['wall_s']:.1f} s with the init, {cell['read_s']:.1f} s "
        f"reading the profile, {cell['run_s']:.1f} s in train_cell, "
        f"{cell['process_s']:.1f} s from its go to its exit ({card})")


def phase_token_cli(torch, ops, train, root, example_iters: int = 300,
                    example_argv=()):
    """``launch/train.py`` with a token arch, ``--mode rl`` synchronous and
    ``--pipeline`` and ``--mode synthetic`` (qwen2-7b, mamba2-370m and
    zamba2-7b reduced), the reference's default command (``--iterations
    20`` and no ``--arch``: mamba2-370m at full width on the TokenEnv), and
    ``examples/train_llm_rl_torch.py --smoke --iters example_iters`` (and
    ``example_argv``); the launches of each."""
    by_path = {}
    # (path, argv, exact launches, kernels that must launch); a reduced
    # mamba2-370m or zamba2-7b acts and learns at ctx 32 (one chunk)
    legs = (
        ("token train cli", ["--arch", "qwen2-7b", "--reduced",
                             "--iterations", "20"], {"nstep_returns": 20},
         K3),
        ("token train cli pipeline", ["--arch", "qwen2-7b", "--reduced",
                                      "--iterations", "20", "--pipeline"],
         {"vtrace_returns": 20}, K3),
        ("token train cli synthetic", ["--arch", "qwen2-7b", "--reduced",
                                       "--mode", "synthetic", "--iterations",
                                       "5", "--t-max", "64"],
         {"nstep_returns": 5, "flash_attention": 5 * 2}, K3),
        ("ssm train cli", ["--arch", "mamba2-370m", "--reduced",
                           "--iterations", "20"],
         {"nstep_returns": 20, "flash_attention": 0}, ("ssd_scan",)),
        ("hybrid train cli pipeline", ["--arch", "zamba2-7b", "--reduced",
                                       "--iterations", "20", "--pipeline"],
         {"vtrace_returns": 20}, ("ssd_scan", "flash_attention")),
        # one group of 2 Mamba2 layers and the shared block, no remat,
        # over 64 tokens (two chunks of 32)
        ("hybrid train cli synthetic", ["--mode", "synthetic", "--arch",
                                        "zamba2-7b", "--reduced",
                                        "--iterations", "5", "--t-max",
                                        "64"],
         {"nstep_returns": 5, "ssd_scan": 5 * 2, "flash_attention": 5},
         ("ssd_scan",)),
        ("default train cli", ["--iterations", "20"],
         {"nstep_returns": 20, "flash_attention": 0}, ("ssd_scan",)),
    )
    for name, argv, want, kernels in legs:
        ops.reset_launches()
        t0 = time.perf_counter()
        out = train.main(argv)
        counts = dict(ops.launches)
        by_path[name] = counts
        for k, n in want.items():
            check(counts[k] == n, f"{name}: {k} launched {counts[k]}, "
                  f"expected {n}")
        for k in kernels:
            check(counts[k] > 0, f"{name}: {k} never launched")
        if isinstance(out, dict):
            detail = (f"{out['tokens_per_s']:.1f} tokens/s, losses "
                      + ", ".join(f"{x:.4f}" for x in out["losses"]))
        else:
            (res,) = out
            check(all(math.isfinite(v) for v in res.mean_metrics.values()),
                  f"{name}: metrics {res.mean_metrics}")
            detail = (f"{res.timesteps_per_sec:.1f} timesteps/s, mean loss "
                      f"{res.mean_metrics['loss']:.4f}")
        say("token cli", f"train.py {' '.join(argv)}: {detail}; launches "
            + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
            + f"; {time.perf_counter() - t0:.1f} s")
    spec = importlib.util.spec_from_file_location(
        "train_llm_rl_torch", root / "examples" / "train_llm_rl_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ops.reset_launches()
    t0 = time.perf_counter()
    results = mod.main(["--smoke", "--iters", str(example_iters),
                        *example_argv])
    counts = dict(ops.launches)
    by_path["token example"] = counts
    iters = example_iters
    check(counts["nstep_returns"] == iters and counts["flash_attention"] > 0,
          f"train_llm_rl_torch --smoke launches {counts}")
    last = results[-1].mean_metrics
    check(math.isfinite(last["loss"]), f"example metrics {last}")
    say("token cli", f"examples/train_llm_rl_torch.py --smoke: {iters} "
        f"iterations, last chunk reward/step "
        f"{last['reward_sum'] / (8 * 4):.3f}, loss {last['loss']:.4f}; "
        "launches " + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
        + f"; {time.perf_counter() - t0:.1f} s")
    return by_path


SERVING_CELLS = (
    {"arch": "qwen2-7b", "change": {},
     "full": {"num_layers": 28, "d_model": 3584, "num_heads": 28,
              "num_kv_heads": 4, "head_dim": 128, "param_dtype": "bfloat16"},
     "prompt_lens": (128, 200, 333, 512), "prefill": K3,
     "decode": "decode_attention",
     # the ring wraps in prefill (333, 512) and in decode (200 + 64)
     "window": {"prompt_lens": (128, 200, 333, 512), "gen": 64,
                "parity": True}},
    # minicpm3-4b and zamba2-7b at every published width, cut in depth for
    # the smoke run's time limit: each cell's time is host-bound a layer
    # (84.5 s at 62 layers, 137.0 s at 81; PERF.md §4)
    {"arch": "minicpm3-4b", "change": {"mla_absorb": True, "num_layers": 31},
     "reduced": "num_layers 62 -> 31",
     "full": {"d_model": 2560, "num_heads": 40,
              "q_lora_rank": 768, "kv_lora_rank": 256, "qk_nope_dim": 64,
              "qk_rope_dim": 32, "v_head_dim": 64, "d_ff": 6400,
              "param_dtype": "bfloat16"},
     "prompt_lens": (128, 200, 333, 512), "prefill": K3,
     "decode": "mla_decode_attention",
     "window": {"prompt_lens": (128, 200, 333, 512), "gen": 64}},
    {"arch": "mamba2-370m", "change": {},
     "full": {"num_layers": 48, "d_model": 1024, "ssm_state": 128,
              "ssm_head_dim": 64, "ssm_expand": 2, "ssm_chunk": 128,
              "param_dtype": "bfloat16"},
     # whole 128-token chunks: a longer prompt must be a multiple
     "prompt_lens": (128, 256, 384, 512), "prefill": ("ssd_scan",),
     "decode": None},
    # the MoE cells: every published width, the depth cut to what one card
    # holds beside the cache and the init's transients (the dense first
    # layer and 7 MoE layers, ~58 GB of bf16 parameters; 8 of dbrx's, ~55
    # GB)
    {"arch": "deepseek-v2-236b", "change": {"num_layers": 8,
                                            "mla_absorb": True},
     "reduced": "num_layers 60 -> 8 (the dense first layer + 7 MoE layers)",
     "full": {"d_model": 5120, "num_heads": 128, "q_lora_rank": 1536,
              "kv_lora_rank": 512, "qk_nope_dim": 128, "qk_rope_dim": 64,
              "v_head_dim": 128, "num_experts": 160, "num_experts_per_tok": 6,
              "num_shared_experts": 2, "moe_d_ff": 1536,
              "first_dense_layers": 1, "dense_d_ff": 12288,
              "vocab_size": 102400, "moe_capacity_factor": 1.25,
              "param_dtype": "bfloat16"},
     "prompt_lens": (128, 200, 333, 512), "prefill": K3,
     "decode": "mla_decode_attention"},
    {"arch": "dbrx-132b", "change": {"num_layers": 8},
     "reduced": "num_layers 40 -> 8",
     "full": {"d_model": 6144, "num_heads": 48, "num_kv_heads": 8,
              "head_dim": 128, "num_experts": 16, "num_experts_per_tok": 4,
              "moe_d_ff": 10752, "vocab_size": 100352,
              "moe_capacity_factor": 1.25, "param_dtype": "bfloat16"},
     "prompt_lens": (128, 200, 333, 512), "prefill": K3,
     "decode": "decode_attention"},
    # the hybrid cut to 45 of 81 layers: 7 groups of 6 Mamba2 layers, each
    # followed by the one shared attention block, and the published tail
    # of 3, so K6, K3 and K4 run on the same paths as at 81
    {"arch": "zamba2-7b", "change": {"num_layers": 45},
     "reduced": "num_layers 81 -> 45 (7 groups of 6 and the tail of 3)",
     "full": {"d_model": 3584, "num_heads": 32,
              "num_kv_heads": 32, "head_dim": 112, "d_ff": 14336,
              "ssm_state": 64, "ssm_head_dim": 64, "ssm_expand": 2,
              "ssm_chunk": 128, "shared_attn_every": 6, "vocab_size": 32000,
              "param_dtype": "bfloat16"},
     # whole 128-token chunks, as for mamba2-370m
     "prompt_lens": (128, 256, 384, 512),
     "prefill": ("ssd_scan", "flash_attention"),
     "decode": "decode_attention",
     # the window on the shared block; whole 128-token chunks
     "window": {"prompt_lens": (128, 512, 128, 512), "gen": 64}},
)
# the window cells' sliding_window: no published config of these models
# sets one, so 256 is a functional choice, small enough that prompts up to
# 512 tokens wrap the ring; their tok/s describe no deployment
WINDOW = 256


def phase_serving(torch, np, configs, models, ops, serve, serving, tree,
                  card, cell, analysis, sanitize, dev="cuda"):
    """One serving cell at full width: the continuous entry point on 8
    requests over 4 slots, a solo rerun, a profiled decode step and the
    lockstep demo. An MoE cell runs the timed call at the published
    capacity factor, where a decode step's rows compete for expert slots,
    and the bitwise solo pin on a second continuous call at capacity factor
    E / k, where none can drop; it also runs an admit and a decode step
    under the transfers guard, counts the step's dropped assignments and
    times its MoE layers alone. A hybrid cell (zamba2-7b) runs the guarded
    admit and step too, times its Mamba2 layers alone, and ends with the
    F14 check (``hybrid_f14``). A cell with a ``"window"`` then serves the
    same parameters with ``sliding_window`` = WINDOW (``window_cell``), and
    qwen2-7b's checks the window's parity (``window_parity``). Returns the
    launch counts of each path: the continuous run at the published factor
    and the window cell's run."""
    from repro_torch.pipeline.queue import TrajectoryQueue

    arch = cell["arch"]
    cfg = configs.get_config(arch).replace(**cell["change"])
    check(all(getattr(cfg, k) == v for k, v in cell["full"].items()),
          f"not the full {arch} config: {cfg}")
    moe = bool(cfg.num_experts)
    hybrid = cfg.family == "hybrid"
    L = cfg.num_layers
    pre, dec = cell["prefill"], cell["decode"]
    t_cell = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = models.init_policy(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    torch.cuda.synchronize()
    leaves = tree.tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    p_bytes = sum(t.numel() * t.element_size() for t in leaves)
    peak = torch.cuda.max_memory_allocated() - base
    over, over_what = 12e9, "12 GB"
    if hybrid:  # the stack of groups is built a layer at a time
        groups = params["trunk"]["groups"]
        over = sum(t[0].numel() * t.element_size()
                   for t in tree.tree_leaves(groups))
        over_what = (f"one group of {cfg.shared_attn_every} Mamba2 layers, "
                     f"{over / 1e9:.3f} GB")
    say("serving", f"{arch} {cell['change'] or ''}: "
        f"{n_params / 1e9:.2f} B parameters (bf16, {p_bytes / 1e9:.2f} GB) "
        f"initialised on the card from seed {SEED} in "
        f"{time.perf_counter() - t_cell:.1f} s; peak allocated during the "
        f"init {peak / 1e9:.2f} GB, {(peak - p_bytes) / 1e9:.3f} GB over the "
        f"parameters (<= {over_what})"
        + (f"; reduced: {cell['reduced']}, every width as published"
           if "reduced" in cell else ""))
    check(peak <= p_bytes + over, f"{arch}: the init's peak {peak / 1e9:.2f} "
          f"GB is more than {over_what} over the parameters' "
          f"{p_bytes / 1e9:.2f}")

    def expected(n_prefill, n_steps):
        want = {name: 0 for name in ops.launches}
        for name in pre:
            want[name] = kernel_layers(cfg, name) * n_prefill
        if dec:
            want[dec] = kernel_layers(cfg, dec) * n_steps
        return want

    slots, prompt_lens, gen_range = 4, cell["prompt_lens"], (16, 32)
    max_len = max(prompt_lens) + gen_range[1]
    kw = dict(slots=slots, max_len=max_len, prompt_lens=prompt_lens,
              gen_range=gen_range, rate_hz=0.0, device=dev)
    serve.serve_continuous(cfg, params, requests=2, seed=SEED + 1, **kw)  # warm-up

    def continuous(c, what):
        ops.reset_launches()
        res = serve.serve_continuous(c, params, requests=8, seed=SEED, **kw)
        counts = dict(ops.launches)
        reqs = res["requests"]
        check(len(reqs) == 8, f"{len(reqs)} of 8 requests came back")
        for r in reqs:
            check(r.status == "done", f"request {r.rid} {r.status}: {r.error}")
            check(len(r.tokens) == r.max_new_tokens,
                  f"request {r.rid}: {len(r.tokens)} of {r.max_new_tokens} "
                  "tokens")
            check(bool(((r.tokens >= 0) & (r.tokens < c.vocab_size)).all()),
                  f"request {r.rid}: token out of [0, {c.vocab_size})")
        check(res["admitted"] == 8, f"{res['admitted']} requests admitted")
        check(counts == expected(res["admitted"], res["steps"]),
              f"{arch}: launches {counts} for {res['admitted']} prefills and "
              f"{res['steps']} decode steps of {L} layers; expected "
              f"{expected(res['admitted'], res['steps'])}")
        say("serving", f"{arch} continuous{what}: 8/8 requests done, "
            f"{res['tokens']} tokens, {res['steps']} decode steps, launches "
            + " ".join(f"{k} {counts[k]} (= {kernel_layers(c, k)} x "
                       f"{res['admitted']} prefills)" for k in pre)
            + (f" {dec} {counts[dec]} (= {kernel_layers(c, dec)} x "
               f"{res['steps']} steps)" if dec
               else " (decode runs no kernel)") + ", every other kernel 0")
        say("serving", f"{arch} bf16{what}, {slots} slots, burst of 8: "
            f"{res['tok_s']:.1f} tok/s aggregate, latency p50 "
            f"{res['p50_ms']:.1f} ms p99 {res['p99_ms']:.1f} ms, wall "
            f"{res['wall_s']:.3f} s ({card})")
        return res, counts

    cf_what = (f" at capacity factor {cfg.moe_capacity_factor}" if moe
               else "")
    res, counts = continuous(cfg, cf_what)
    solo_cfg = cfg
    if hybrid:
        guard_probe(torch, np, serving, analysis, sanitize, cfg, params,
                    slots, max_len, dev)
    if moe:
        moe_probe(torch, np, serving, models, analysis, sanitize, cfg,
                  params, slots, max_len, dev)
        # capacity = ceil(W k (E / k) / E) = W: every row keeps its experts
        solo_cfg = cfg.replace(moe_capacity_factor=cfg.num_experts
                               / cfg.num_experts_per_tok)
        res, _ = continuous(solo_cfg, " at capacity factor E / k = "
                            f"{solo_cfg.moe_capacity_factor:.4g} (no drop)")

    probe = max(res["requests"], key=lambda r: (r.t_admit, r.rid))  # joined mid-flight
    solo = serving.Request(rid=probe.rid, prompt=probe.prompt.copy(),
                           max_new_tokens=probe.max_new_tokens, seed=probe.seed)
    q = TrajectoryQueue(depth=2)
    q.put(solo)
    q.producer_done()
    engine = serving.DecodeEngine(solo_cfg, params, max_slots=slots,
                                  max_len=max_len, device=dev)
    serving.Scheduler(engine, q, continuous=False).run()
    check(solo.status == "done" and np.array_equal(solo.tokens, probe.tokens),
          f"{arch} request {probe.rid}: continuous {probe.tokens.tolist()} != "
          f"solo {None if solo.tokens is None else solo.tokens.tolist()}")
    say("serving", f"{arch} request {probe.rid} (prompt {len(probe.prompt)}, "
        f"{probe.max_new_tokens} tokens) rerun solo on a fresh {slots}-slot "
        "engine: bitwise equal"
        + (f" (capacity factor {solo_cfg.moe_capacity_factor:.4g})" if moe
           else ""))
    del engine

    wall_ms, busy_ms, summed_ms, top, by_name = profile_decode(
        torch, np, serving, cfg, params, slots, max_len, dev=dev)
    busy = (f"device busy {busy_ms:.2f} ms a step ({100 * busy_ms / wall_ms:.0f}%"
            " of the unprofiled step; the sum of self device times over "
            f"key_averages, which counts a kernel under its op too, gives "
            f"{summed_ms:.2f} ms)" if busy_ms > 0 else
            "device time not measured (the profiler saw no device activity)")
    say("serving", f"{arch} decode step, {slots} rows at pos 256-264, "
        f"torch.profiler window of 8 steps: wall {wall_ms:.2f} ms a step "
        f"without the profiler, {busy}; top kernels (ms a step, launches a "
        "step): " + "; ".join(f"{k[:60]} {ms:.3f} x{n:.0f}"
                              for k, (ms, n) in top))
    if dec and busy_ms > 0:
        k_ms, k_n = kernel_time(by_name, dec)
        say("serving", f"{arch} decode step: {dec} {k_ms:.3f} ms a step "
            f"x{k_n:.0f} ({100 * k_ms / busy_ms:.1f}% of the busy "
            f"{busy_ms:.2f} ms)")
    if moe:
        moe_share(torch, models, tree, cfg, params, slots, busy_ms, dev)
    if hybrid:
        mamba_share(torch, models, tree, cfg, params, slots, busy_ms, dev)
    p_wall, p_busy, p_by = profile_prefill(
        torch, np, serving, cfg, params, slots, max_len,
        prompt_len=max(prompt_lens), dev=dev)
    shares = []
    for name in pre:
        k_ms, k_n = kernel_time(p_by, name)
        shares.append(f"{name} {k_ms:.3f} ms x{k_n:.0f} "
                      f"({100 * k_ms / max(p_busy, 1e-9):.1f}% of the busy "
                      "time)")
    say("serving", f"{arch} prefill of {max(prompt_lens)} tokens through "
        f"DecodeEngine.admit, torch.profiler window of 3: wall "
        f"{p_wall:.2f} ms without the profiler, device busy {p_busy:.2f} ms; "
        + "; ".join(shares))

    _, prompt_gen, decode_gen = serve.demo_generators(SEED, dev)
    ops.reset_launches()
    lock = serve.run_lockstep(cfg, params, batch=4, prompt_len=128, gen=8,
                              prompt_gen=prompt_gen, decode_gen=decode_gen,
                              device=dev)
    lock_counts = dict(ops.launches)
    check(lock["logits_finite"], f"{arch} lockstep prefill logits not finite")
    check(lock["tokens"].shape == (4, 9),
          f"{arch} lockstep tokens {lock['tokens'].shape}")
    check(bool(((lock["tokens"] >= 0) & (lock["tokens"] < cfg.vocab_size)).all()),
          f"{arch} lockstep token out of range")
    check(lock_counts == expected(1, 8),
          f"{arch} lockstep launches {lock_counts}, expected {expected(1, 8)}")
    say("serving", f"{arch} lockstep demo (scalar pos): batch 4, prompt 128, 8 "
        f"steps, launches {lock_counts}; prefill "
        f"{lock['prefill_s'] * 1e3:.1f} ms, decode "
        f"{lock['decode_s'] * 1e3:.1f} ms")
    paths = {f"{arch} serving": counts}
    if "window" in cell:
        paths[f"{arch} window serving"] = window_cell(
            torch, np, serving, ops, card, cfg, params, slots, expected,
            **{k: v for k, v in cell["window"].items() if k != "parity"},
            dev=dev)
    del params
    torch.cuda.empty_cache()
    if hybrid:
        hybrid_f14(torch, np, models, cfg, dev=dev)
    if cell.get("window", {}).get("parity"):
        window_parity(torch, np, models, cfg, dev=dev)
    say("serving", f"{arch} cell took {time.perf_counter() - t_cell:.1f} s")
    return paths


def window_cell(torch, np, serving, ops, card, cfg, params, slots, expected,
                prompt_lens, gen: int, dev="cuda"):
    """The cell's parameters served with ``sliding_window`` = WINDOW (a
    window changes no parameter's shape): one request a prompt length, each
    ``gen`` new tokens, through the continuous scheduler on a fresh engine,
    whose attention caches are rings of WINDOW slots. Every request must
    finish with tokens in range, the prefill kernels launch once a layer
    (K3 windowed) per request and the decode kernel once a layer per step;
    tok/s, the peak memory, and a profiled decode step's busy share and
    decode kernel's share. Returns the run's launch counts."""
    from repro_torch.pipeline.queue import TrajectoryQueue

    t0 = time.perf_counter()
    wcfg = cfg.replace(sliding_window=WINDOW)
    max_len = max(prompt_lens) + gen
    rng = np.random.default_rng(SEED + 3)
    reqs = [serving.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n),
                            max_new_tokens=gen,
                            seed=int(rng.integers(0, 2**31 - 1)))
            for i, n in enumerate(prompt_lens)]
    q = TrajectoryQueue(depth=max(2, len(reqs)))
    for r in reqs:
        q.put(r)
    q.producer_done()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    engine = serving.DecodeEngine(wcfg, params, max_slots=slots,
                                  max_len=max_len, device=dev)
    rings = attn_slots(engine._cache)
    check(rings and set(rings) == {WINDOW},
          f"{cfg.name}: attention caches of {sorted(set(rings))} slots, not "
          f"rings of {WINDOW}")
    ops.reset_launches()
    t1 = time.perf_counter()
    sched = serving.Scheduler(engine, q, continuous=True)
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() - base
    check(len(done) == len(reqs), f"{len(done)} of {len(reqs)} requests")
    for r in done:
        check(r.status == "done" and len(r.tokens) == gen,
              f"{cfg.name} window request {r.rid} {r.status}: {r.error}")
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()),
              f"{cfg.name} window request {r.rid}: token out of range")
    want = expected(len(reqs), sched.steps)
    check(counts == want, f"{cfg.name} window: launches {counts}, expected "
          f"{want}")
    tokens = sum(len(r.tokens) for r in done)
    del engine
    # a profiler window of 2 steps: its event processing is most of a
    # window's cost at these launch counts
    wall_ms, busy_ms, _, _, by_name = profile_decode(
        torch, np, serving, wcfg, params, slots, max_len, steps=2, dev=dev)
    dec = [k for k, v in want.items() if v and k != "flash_attention"
           and k != "ssd_scan"]
    share = ""
    if busy_ms > 0 and dec:
        k_ms, k_n = kernel_time(by_name, dec[0])
        share = (f", {dec[0]} {k_ms:.3f} ms x{k_n:.0f} "
                 f"({100 * k_ms / busy_ms:.1f}% of it)")
    say("serving", f"{cfg.name} window {WINDOW}, functional: no published "
        f"window (rings of {WINDOW} slots, "
        f"{len(rings)} leaves): {len(reqs)} requests, prompts "
        f"{list(prompt_lens)}, {gen} new tokens each, {tokens} tokens in "
        f"{sched.steps} decode steps: {tokens / wall:.1f} tok/s, wall "
        f"{wall:.3f} s; peak {peak / 1e9:.3f} GB over the parameters (engine "
        f"and run); launches " + " ".join(f"{k} {v}" for k, v in
                                          counts.items() if v)
        + f"; decode step at pos 256-264 (wrapped), a profiler window of 2: "
        f"wall {wall_ms:.2f} ms, "
        f"busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.0f}%){share}; "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    return counts


def attn_slots(cache) -> list:
    """The slot count of every attention cache leaf: the axis after the
    rows, (..., rows, slots, Hkv, D) for GQA's k/v and (..., rows, slots,
    width) for MLA's c/kr."""
    out = []
    for key, val in cache.items():
        if key == "attn":
            out += [t.shape[-3] if name in ("k", "v") else t.shape[-2]
                    for name, t in val.items()]
        elif isinstance(val, dict):
            out += attn_slots(val)
    return out


PREFIX_CELLS = (
    # every published width and all 40 layers (about 24.5 GB in bf16): a
    # prefix of 1024 patch embeddings of width 1024 before the text
    {"arch": "pixtral-12b",
     "full": {"num_layers": 40, "d_model": 5120, "num_heads": 32,
              "num_kv_heads": 8, "head_dim": 128, "d_ff": 14336,
              "vocab_size": 131072, "prefix_len": 1024, "frontend_dim": 1024,
              "param_dtype": "bfloat16"},
     "text_lens": (128, 512), "steps": 32},
    # every published width, 24 encoder and 24 decoder layers: 1024 frame
    # embeddings of width 1024 through the (causal, F17) encoder
    {"arch": "seamless-m4t-large-v2",
     "full": {"num_layers": 24, "encoder_layers": 24, "d_model": 1024,
              "num_heads": 16, "num_kv_heads": 16, "head_dim": 64,
              "d_ff": 8192, "mlp": "gelu", "vocab_size": 256206,
              "encoder_seq_len": 1024, "frontend_dim": 1024,
              "is_encoder_decoder": True, "param_dtype": "bfloat16"},
     "text_lens": (64, 128), "steps": 32, "parity": True},
)


def phase_prefixed(torch, np, configs, models, ops, tree, card, cell,
                   dev="cuda"):
    """A vision or encoder-decoder model at full width through
    ``policy_prefill`` (with ``prefix_embeds``) and ``policy_decode``: the
    engine refuses both, as the reference's does. Four rows, random front-end
    embeddings from the seed, one prefill a text length, then ``steps``
    lockstep greedy decode steps at pos = prefix + text + t. Each prefill
    must launch K3 once a layer (an encoder-decoder: once an encoder layer,
    twice a decoder layer) and each step K4 once a layer (twice a decoder
    layer), the logits must be finite; prefill ms, ms a step, tok/s and a
    profiled step's busy share. An encoder-decoder cell ends with
    ``encdec_parity``. Returns the launch counts of the timed calls."""
    from torch.profiler import ProfilerActivity, profile

    arch = cell["arch"]
    cfg = configs.get_config(arch)
    check(all(getattr(cfg, k) == v for k, v in cell["full"].items()),
          f"not the full {arch} config: {cfg}")
    t_cell = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = models.init_policy(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    torch.cuda.synchronize()
    leaves = tree.tree_leaves(params)
    p_bytes = sum(t.numel() * t.element_size() for t in leaves)
    peak = torch.cuda.max_memory_allocated() - base
    check(peak <= p_bytes + 12e9, f"{arch}: the init's peak {peak / 1e9:.2f} "
          f"GB is more than 12 GB over the parameters' {p_bytes / 1e9:.2f}")
    say("serving", f"{arch}: {sum(t.numel() for t in leaves) / 1e9:.2f} B "
        f"parameters (bf16, {p_bytes / 1e9:.2f} GB) initialised on the card "
        f"from seed {SEED} in {time.perf_counter() - t_cell:.1f} s; peak "
        f"allocated during the init {peak / 1e9:.2f} GB; every published "
        f"width, {cfg.num_layers} layers"
        + (f" + {cfg.encoder_layers} encoder layers"
           if cfg.is_encoder_decoder else ""))
    B, steps = 4, cell["steps"]
    pre = front_embeds(torch, cfg, B,
                       torch.Generator(device=dev).manual_seed(SEED + 6), dev,
                       torch.bfloat16)
    off = prefix_offset(cfg)
    rng = np.random.default_rng(SEED + 6)
    k3, k4 = "flash_attention", "decode_attention"
    want_pre = {name: 0 for name in ops.launches}
    want_pre[k3] = kernel_layers(cfg, k3)
    want_step = {name: 0 for name in ops.launches}
    want_step[k4] = kernel_layers(cfg, k4)

    def run(text_len, n_steps):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (B, text_len))).to(dev)
        ML = off + text_len + n_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _, cache = models.policy_prefill(params, cfg, toks, pre,
                                                 max_len=ML)
        last = logits[:, -1]
        check(tuple(logits.shape) == (B, off + text_len, cfg.actions()),
              f"{arch} prefill logits {tuple(logits.shape)}")
        del logits
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok = last.argmax(-1, keepdim=True)
        for t in range(n_steps):
            lg, _, cache = models.policy_decode(params, cfg, cache, tok,
                                                off + text_len + t)
            tok = lg.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(bool(torch.isfinite(last).all() and torch.isfinite(lg).all()),
              f"{arch}: non-finite logits")
        return t1 - t0, t2 - t1, cache, tok

    run(16, 2)  # warm-up
    total = {name: 0 for name in ops.launches}
    for text_len in cell["text_lens"]:
        ops.reset_launches()
        pre_s, dec_s, cache, tok = run(text_len, steps)
        counts = dict(ops.launches)
        want = {k: want_pre[k] + steps * want_step[k] for k in counts}
        check(counts == want, f"{arch} text {text_len}: launches {counts}, "
              f"expected {want}")
        for k, v in counts.items():
            total[k] += v
        say("serving", f"{arch} bf16, {B} rows, "
            + (f"{off} patches + " if off else
               f"{cfg.encoder_seq_len} frames through the encoder, ")
            + f"{text_len} text tokens: prefill {pre_s * 1e3:.1f} ms, then "
            f"{steps} lockstep decode steps {dec_s / steps * 1e3:.2f} ms a "
            f"step, {B * steps / dec_s:.1f} tok/s; launches {k3} "
            f"{counts[k3]} (= {want_pre[k3]} a prefill), {k4} {counts[k4]} "
            f"(= {want_step[k4]} x {steps} steps), every other kernel 0 "
            f"({card})")
    # a profiled window of 4 steps at the last cache (the timed run's)
    pos = off + cell["text_lens"][-1] + steps - 4
    cache_len = cache["layers"]["attn"]["k"].shape[2]
    check(pos + 3 < cache_len, f"{arch}: no room for the profiled steps")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(4):
            lg, _, cache = models.policy_decode(params, cfg, cache, tok, pos + t)
        torch.cuda.synchronize()
    busy_ms, by_name = device_window(prof, 4)
    k_ms, k_n = kernel_time(by_name, k4)
    say("serving", f"{arch} decode step (torch.profiler window of 4): device "
        f"busy {busy_ms:.2f} ms a step; {k4} {k_ms:.3f} ms x{k_n:.0f} "
        f"({100 * k_ms / max(busy_ms, 1e-9):.1f}% of it)")
    del params, cache, pre
    torch.cuda.empty_cache()
    if cell.get("parity"):
        encdec_parity(torch, np, models, cfg, dev=dev)
    say("serving", f"{arch} cell took {time.perf_counter() - t_cell:.1f} s")
    return total


def encdec_parity(torch, np, models, cfg, layers: int = 2, prompt_len: int = 64,
                  steps: int = 8, dev="cuda"):
    """The encoder-decoder at full width in fp32 with TF32 off, cut to
    ``layers`` encoder and ``layers`` decoder layers: its prefill of a
    ``prompt_len``-token prompt with 1024 frames, then ``steps`` decode
    steps, against the decode loop: a prefill of the first token (which
    fills the cross cache) and decode steps over the rest. Logits within
    F14_TOL + F14_TOL |ref|."""
    t0 = time.perf_counter()
    c32 = cfg.replace(num_layers=layers, encoder_layers=layers,
                      param_dtype="float32", compute_dtype="float32")
    params = models.init_policy(
        c32, generator=torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    frames = front_embeds(torch, c32, 2,
                          torch.Generator(device=dev).manual_seed(SEED + 7),
                          dev)
    S, ML = prompt_len, prompt_len + steps
    toks = torch.from_numpy(np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab_size, (2, ML))).to(dev)
    logits, _, cache = models.policy_prefill(params, c32, toks[:, :S], frames,
                                             max_len=ML)
    got = [logits]
    for t in range(S, ML):
        lg, _, cache = models.policy_decode(params, c32, cache,
                                            toks[:, t:t + 1], t)
        got.append(lg[:, None])
    got = torch.cat(got, dim=1)
    logits, _, cache = models.policy_prefill(params, c32, toks[:, :1], frames,
                                             max_len=ML)
    want = [logits]
    for t in range(1, ML):
        lg, _, cache = models.policy_decode(params, c32, cache,
                                            toks[:, t:t + 1], t)
        want.append(lg[:, None])
    want = torch.cat(want, dim=1)
    e_pre = within_rel(torch, got[:, :S], want[:, :S], F14_TOL, F14_TOL,
                       "encoder-decoder parity: prefill vs decode loop")
    e_dec = within_rel(torch, got[:, S:], want[:, S:], F14_TOL, F14_TOL,
                       "encoder-decoder parity: steps vs decode loop")
    say("serving", f"{cfg.name} parity, {layers} + {layers} layers at full "
        f"width, fp32, TF32 off, 1024 frames: prefill of {S} tokens then "
        f"{steps} steps vs a one-token prefill and a decode loop over the "
        f"{ML} tokens: max |dlogit| {e_pre:.3g} over the prompt, {e_dec:.3g} "
        f"over the steps (<= {F14_TOL} + {F14_TOL} |logit|; max |logit| "
        f"{want.abs().max().item():.3g}); {time.perf_counter() - t0:.1f} s")
    del params, cache
    torch.cuda.empty_cache()


def window_parity(torch, np, models, cfg, layers: int = 4,
                  prompt_len: int = 333, steps: int = 16, dev="cuda"):
    """The window at full width in fp32 with TF32 off, cut to ``layers``
    layers: the port's prefill of a ``prompt_len``-token prompt, then
    ``steps`` decode steps, against a decode loop over the same tokens from
    the zero cache. Twice: on a ring of WINDOW slots (``sliding_window``),
    and with ``window=64`` per call on a full-length cache, where K4 reads
    its age mask. The logits at every prompt position and at every step
    must agree within F14_TOL + F14_TOL |ref|."""
    t0 = time.perf_counter()
    c32 = cfg.replace(num_layers=layers, param_dtype="float32",
                      compute_dtype="float32")
    params = models.init_policy(
        c32, generator=torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    S, ML = prompt_len, prompt_len + steps
    toks = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (1, ML))).to(dev)
    for what, ccfg, window in (
            (f"ring of {WINDOW}", c32.replace(sliding_window=WINDOW), None),
            ("window=64 a call, full cache", c32, 64)):
        logits, _, cache = models.policy_prefill(
            params, ccfg, toks[:, :S], window=window, max_len=ML)
        got = [logits[0]]
        for t in range(S, ML):
            lg, _, cache = models.policy_decode(
                params, ccfg, cache, toks[:, t:t + 1], t, window=window)
            got.append(lg)
        got = torch.cat(got)
        slots = cache["layers"]["attn"]["k"].shape[2]
        cache = models.init_policy_cache(ccfg, 1, ML, device=dev)
        want = []
        for t in range(ML):
            lg, _, cache = models.policy_decode(
                params, ccfg, cache, toks[:, t:t + 1], t, window=window)
            want.append(lg)
        want = torch.cat(want)
        e_pre = within_rel(torch, got[:S], want[:S], F14_TOL, F14_TOL,
                           f"window parity ({what}): prefill vs decode loop")
        e_dec = within_rel(torch, got[S:], want[S:], F14_TOL, F14_TOL,
                           f"window parity ({what}): steps vs decode loop")
        say("serving", f"{cfg.name} window parity, {what} ({slots} slots), "
            f"{layers} layers at full width, fp32, TF32 off: prefill of {S} "
            f"tokens then {steps} steps vs a decode loop over the {ML} tokens "
            f"from the zero cache: max |dlogit| {e_pre:.3g} over the prompt, "
            f"{e_dec:.3g} over the steps (<= {F14_TOL} + {F14_TOL} |logit|; "
            f"max |logit| {want.abs().max().item():.3g})")
    del params, cache
    torch.cuda.empty_cache()
    say("serving", f"{cfg.name} window parity took "
        f"{time.perf_counter() - t0:.1f} s")


def guard_probe(torch, np, serving, analysis, sanitize, cfg, params, slots,
                max_len, dev="cuda"):
    """An engine with every slot leased at pos 256: three admits and a step
    unguarded (the first calls), then the fourth admit and a decode step
    under the transfers guard, where any host sync torch reports raises.
    Returns the engine."""
    engine = serving.DecodeEngine(cfg, params, max_slots=slots,
                                  max_len=max_len, device=dev)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, 256) for _ in range(slots)]
    for slot in range(slots - 1):
        engine.admit(slot, prompts[slot], seed=slot)
    engine.step()
    torch.cuda.synchronize()
    analysis.enable_sanitizers("transfers")
    sanitize.reset_stats()
    try:
        with sanitize.guard():
            engine.admit(slots - 1, prompts[-1], seed=slots - 1)
            engine.step()
        torch.cuda.synchronize()
        refused, guarded = sanitize.host_syncs["refused"], sanitize.stats["guarded"]
    finally:
        analysis.disable_sanitizers()
    check(refused == 0 and guarded == 1,
          f"{cfg.name}: {refused} host syncs refused in {guarded} guards")
    say("serving", f"{cfg.name} one admit (256 tokens) and one decode step "
        "under sanitize.guard() with the transfers mode on: no host sync "
        f"({guarded} guarded scope, {refused} refused)")
    return engine


def moe_probe(torch, np, serving, models, analysis, sanitize, cfg, params,
              slots, max_len, dev="cuda"):
    """``guard_probe``, then one step with ``_route_group`` watched: the
    share of the step's assignments that capacity dropped, layer by
    layer."""
    engine = guard_probe(torch, np, serving, analysis, sanitize, cfg, params,
                         slots, max_len, dev)
    route = models.moe._route_group
    seen = []

    def watched(tokens, logits, k, capacity, E):
        out = route(tokens, logits, k, capacity, E)
        seen.append((out[1], capacity, E))
        return out

    models.moe._route_group = watched
    try:
        engine.step()
    finally:
        models.moe._route_group = route
    drops = [int((s == E * C).sum()) for s, C, E in seen]
    total = sum(s.numel() for s, _, _ in seen)
    check(len(seen) == cfg.num_layers - cfg.first_dense_layers,
          f"{cfg.name}: {len(seen)} routed layers in a step")
    say("serving", f"{cfg.name} decode step, {slots} rows leased, capacity "
        f"factor {cfg.moe_capacity_factor}: capacity {seen[0][1]} per expert, "
        f"{sum(drops)} of {total} assignments dropped "
        f"({100 * sum(drops) / total:.1f}%; by layer {drops})")


def moe_share(torch, models, tree, cfg, params, slots, busy_ms, dev="cuda"):
    """The decode step's MoE layers alone: CUDA-event ms of every MoE
    layer's ``moe_forward`` on a (slots, 1, d) bf16 input in turn, beside
    the step's device-busy ms and the bound of reading the MoE layers'
    weights once."""
    stack = params["trunk"]["layers"]["moe"]
    n = cfg.num_layers - cfg.first_dense_layers
    x = torch.randn((slots, 1, cfg.d_model), device=dev).to(torch.bfloat16)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    layer, fwd = models.transformer.layer, models.moe.moe_forward
    ms = time_ms(torch, lambda: [fwd(layer(stack, i), cfg, x)
                                 for i in range(n)], flush, iters=10)
    nbytes = sum(t.numel() * t.element_size() for t in tree.tree_leaves(stack))
    b_ms, _ = bound(nbytes, 0, "bfloat16")
    share = (f"{100 * ms / busy_ms:.1f}% of the step's busy {busy_ms:.2f} ms"
             if busy_ms > 0 else "the step's busy time not measured")
    say("serving", f"{cfg.name} decode step's {n} MoE layers alone ({slots} "
        f"rows): {ms:.3f} ms, {share}; bound {b_ms:.3f} ms (their "
        f"{nbytes / 1e9:.2f} GB of weights at {HBM_BYTES_PER_S / 1e12:.2f} "
        f"TB/s), {100 * b_ms / ms:.0f}% of it")
    del flush


def mamba_share(torch, models, tree, cfg, params, slots, busy_ms, dev="cuda"):
    """A hybrid decode step's Mamba2 layers alone: a (slots, 1, d) bf16
    input through every group's and the tail's ``ssm_stack_decode`` in
    turn, on a scratch cache, in a profiler window of 3 passes (device
    busy ms a pass, as the step's busy ms is taken: the layers' ~3,000
    launches take longer to enqueue than the card to run, so CUDA events
    would time the host), beside the step's busy ms and the bound of
    reading their weights and reading and writing their fp32 states
    once."""
    from torch.profiler import ProfilerActivity, profile

    tfm = models.transformer
    trunk = params["trunk"]
    cache = tfm.init_cache(cfg, slots, 2, device=dev)
    stacks = [(tfm.layer(trunk["groups"], g), tfm.layer(cache["groups"], g))
              for g in range(cfg.num_layers // cfg.shared_attn_every)]
    if "tail" in trunk:
        stacks.append((trunk["tail"], cache["tail"]))
    x = torch.randn((slots, 1, cfg.d_model), device=dev).to(torch.bfloat16)

    def run():
        y = x
        for p, c in stacks:
            y = tfm.ssm_stack_decode(p, cfg, y, c)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run()
        torch.cuda.synchronize()
    ms, _ = device_window(prof, 3)
    weights = sum(t.numel() * t.element_size() for name in ("groups", "tail")
                  if name in trunk for t in tree.tree_leaves(trunk[name]))
    states = sum(c[leaf].numel() * c[leaf].element_size()
                 for _, c in stacks for leaf in c)
    b_ms, _ = bound(weights + 2 * states, 0, "bfloat16")
    share = (f"{100 * ms / busy_ms:.1f}% of the step's busy {busy_ms:.2f} ms"
             if busy_ms > 0 and ms > 0 else "a share not measured")
    say("serving", f"{cfg.name} decode step's {cfg.num_layers} Mamba2 layers "
        f"alone ({slots} rows): device busy {ms:.3f} ms, {share}; bound "
        f"{b_ms:.3f} ms (their {weights / 1e9:.2f} GB of weights read and "
        f"{states / 1e9:.3f} GB of states and conv buffers read and "
        f"written at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)"
        + (f", {100 * b_ms / ms:.0f}% of it" if ms > 0 else ""))


F14_TOL = 1e-3  # fp32 at full width, absolute and relative


def hybrid_f14(torch, np, models, cfg, prompt_len: int = 256,
               steps: int = 8, dev="cuda"):
    """F14 at full width, in fp32 with TF32 off: the port's prefill of a
    ``prompt_len``-token prompt, then ``steps`` decode steps, against a
    decode loop over the same tokens from the zero cache. The logits at
    every prompt position and at every step after it must agree within
    F14_TOL + F14_TOL |ref|."""
    t0 = time.perf_counter()
    c32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    params = models.init_policy(
        c32, generator=torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    S, ML = prompt_len, prompt_len + steps
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (1, ML))).to(dev)
    logits, _, cache = models.policy_prefill(params, c32, toks[:, :S],
                                             max_len=ML)
    got = [logits[0]]
    for t in range(S, ML):
        lg, _, cache = models.policy_decode(params, c32, cache,
                                            toks[:, t:t + 1], t)
        got.append(lg)
    got = torch.cat(got)
    cache = models.init_policy_cache(c32, 1, ML, device=dev)
    want = []
    for t in range(ML):
        lg, _, cache = models.policy_decode(params, c32, cache,
                                            toks[:, t:t + 1], t)
        want.append(lg)
    want = torch.cat(want)
    e_pre = within_rel(torch, got[:S], want[:S], F14_TOL, F14_TOL,
                       "F14: the prefill's logits vs the decode loop's")
    e_dec = within_rel(torch, got[S:], want[S:], F14_TOL, F14_TOL,
                       "F14: decode after the prefill vs the decode loop")
    say("serving", f"{cfg.name} F14 at full width ({c32.num_layers} "
        f"layers, fp32, TF32 off): prefill of {S} tokens then {steps} "
        f"decode steps vs a decode loop over the {ML} tokens from the "
        f"zero cache: max |dlogit| {e_pre:.3g} over the prompt, "
        f"{e_dec:.3g} over the {steps} steps (<= {F14_TOL} + {F14_TOL} "
        f"|logit|; max |logit| {want.abs().max().item():.3g}); "
        f"{time.perf_counter() - t0:.1f} s")
    del params, cache
    torch.cuda.empty_cache()


def profile_decode(torch, np, serving, cfg, params, slots, max_len,
                   steps: int = 8, dev="cuda"):
    """Decode step time with and without torch.profiler, over a steady
    window of ``steps`` steps with every slot leased: (wall ms a step,
    device-busy ms a step, the sum of self device times over
    ``key_averages`` that earlier runs reported as busy, top kernels by
    device time)."""
    from torch.profiler import ProfilerActivity, profile

    engine = serving.DecodeEngine(cfg, params, max_slots=slots,
                                  max_len=max_len, device=dev)
    rng = np.random.default_rng(SEED)
    for slot in range(slots):
        engine.admit(slot, rng.integers(0, cfg.vocab_size, 256), seed=slot)
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    summed_ms = sum(e.self_device_time_total
                    for e in prof.key_averages()) / steps / 1e3
    busy_ms, by_name = device_window(prof, steps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return wall_ms, busy_ms, summed_ms, top, by_name


def profile_prefill(torch, np, serving, cfg, params, slots, max_len,
                    prompt_len: int = 512, reps: int = 3, dev="cuda"):
    """One prompt of ``prompt_len`` tokens prefilled through
    ``DecodeEngine.admit`` (the model's prefill, the first token, the cache
    write), ``reps`` times after a warm-up: (wall ms a prefill without the
    profiler, device-busy ms a prefill, {name: [ms, launches]} a prefill)."""
    from torch.profiler import ProfilerActivity, profile

    engine = serving.DecodeEngine(cfg, params, max_slots=slots,
                                  max_len=max_len, device=dev)
    prompt = np.random.default_rng(SEED).integers(0, cfg.vocab_size, prompt_len)
    engine.admit(0, prompt, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.admit(0, prompt, seed=0)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            engine.admit(0, prompt, seed=0)
        torch.cuda.synchronize()
    busy_ms, by_name = device_window(prof, reps)
    return wall_ms, busy_ms, by_name


class FrameEnv:
    """A stand-in for one ALE emulator behind ``HostEnvPool``: 84x84x4 fp32
    frames made with numpy from the env's own ``RandomState``, reward 1
    when action == state mod 3 and an episode every 10 steps (the rule of
    ``benchmarks/fig2_time_split.py``'s external env), 6 actions; each step
    costs ``delay`` seconds of ``time.sleep``, which releases the GIL as
    an emulator's native step does."""

    SHAPE = (84, 84, 4)

    def __init__(self, seed: int, delay: float):
        import numpy as np

        self.rng = np.random.RandomState(seed)
        self.delay = delay
        self.state = 0

    def _obs(self):
        return self.rng.random_sample(self.SHAPE).astype("float32")

    def reset(self):
        self.state = int(self.rng.randint(0, 100))
        return self._obs()

    def step(self, action):
        if self.delay:
            time.sleep(self.delay)
        reward = 1.0 if int(action) == self.state % 3 else 0.0
        self.state += 1
        return self._obs(), reward, self.state % 10 == 0, {}


# the keys of a heartbeat line of repro/telemetry/hub.py, with the
# pipeline's two gauges
HEARTBEAT_KEYS = {"time_unix", "uptime_s", "steps", "steps_per_s_ema",
                  "span_drops", "actor_last_activity_s", "counters",
                  "queue_depth", "staleness"}


def phase_host(torch, np, configs, core, envs, A, optim, pipeline,
               paper_atari, ops, tree, train, card, dev="cuda", n_envs=32,
               n_workers=8, warmup=10, iters=100, lock_iters=10, window=10,
               cli_iters=50, env_spin=2000):
    """The paper's host env plane: ``ParallelRL`` and ``PipelinedRL`` on a
    ``HostEnvPool`` of ``n_envs`` stand-in emulators over ``n_workers``
    threads, paac_nature at full size in fp32; the bitwise pins; the
    trainer's ``--host-env`` legs; the aliasing checks. Returns the launch
    counts of the timed sync runs, of the timed pipelined runs and of the
    trainer's legs."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.pipeline.actor import to_device

    t_phase = time.perf_counter()
    leaves = tree.tree_leaves
    inf = float("inf")
    t_max = 5
    lr = 0.0007 * n_envs
    frame_bytes = n_envs * int(np.prod(FrameEnv.SHAPE)) * 4
    cfg = configs.get_config("paac_nature").replace(
        obs_shape=FrameEnv.SHAPE, num_actions=6)

    def pool(delay):
        return envs.HostEnvPool([lambda s=i: FrameEnv(s, delay)
                                 for i in range(n_envs)],
                                n_workers=n_workers,
                                obs_shape=FrameEnv.SHAPE, device=dev)

    def agent():
        return A.PAACAgent(cfg, A.PAACConfig(gamma=0.99, entropy_beta=0.01,
                                             t_max=t_max))

    kw = dict(optimizer="rmsprop", lr_schedule=optim.constant(lr), seed=SEED,
              device=dev)

    def sync(p):
        return core.ParallelRL(p, agent(), **kw)

    def piped(p, **cfg_kw):
        return pipeline.PipelinedRL(p, agent(),
                                    pipeline=configs.PipelineConfig(**cfg_kw),
                                    **kw)

    def run_checked(label, rl, n, want):
        """``rl.run(n)`` with the counts set to 0 just before it: the
        launches must be ``want``, the metrics finite, the parameters
        changed."""
        before = [t.clone() for t in leaves(rl.params)]
        ops.reset_launches()
        res = rl.run(n)
        counts = dict(ops.launches)
        expect = {k: want.get(k, 0) for k in counts}
        check(counts == expect, f"{label}: launches {counts}, expected "
              f"{expect}")
        check(all(math.isfinite(v) for v in res.mean_metrics.values()),
              f"{label}: non-finite metrics {res.mean_metrics}")
        changed = max((a - b).abs().max().item() for a, b in
                      zip(before, leaves(rl.params)))
        check(changed > 0, f"{label}: the parameters did not change")
        return res, counts

    def busy_window(rl):
        """(device-busy ms, H2D ms, H2D copies, device activities), each an
        iteration, of a profiler window."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rl.run(window)
            torch.cuda.synchronize()
        busy_ms, by_name = device_window(prof, window)
        h2d = [row for name, row in by_name.items() if "HtoD" in name]
        return (busy_ms, sum(r[0] for r in h2d), sum(r[1] for r in h2d),
                sum(r[1] for r in by_name.values()))

    with pool(0.0) as p:
        n_params = sum(t.numel() for t in leaves(sync(p).params))
    say("host", f"paac_nature ({n_params / 1e6:.2f} M parameters, fp32) on "
        f"a HostEnvPool of {n_envs} stand-in emulators (84x84x4 fp32 "
        f"frames, 6 actions) over {n_workers} worker threads, t_max "
        f"{t_max}, RMSProp lr {lr:g}; page-locked H2D {frame_bytes} B an "
        f"acting step, {t_max * frame_bytes} B of frames (+ {frame_bytes} B "
        "bootstrap) at the update")

    # (a) the synchronous host ParallelRL at delay 0, then calibrated
    sync_counts = {k: 0 for k in ops.launches}

    def timed_sync(delay):
        with pool(delay) as p:
            rl = sync(p)
            collect_s = []
            real_collect = rl._collect_host

            def collect(*a, **k):
                t0 = time.perf_counter()
                try:
                    return real_collect(*a, **k)
                finally:
                    collect_s.append(time.perf_counter() - t0)

            rl._collect_host = collect
            rl.run(warmup)
            collect_s.clear()
            res, counts = run_checked(f"sync host, delay {delay}", rl, iters,
                                      {"nstep_returns": iters})
            for k, v in counts.items():
                sync_counts[k] += v
            iter_ms = 1e3 * n_envs * t_max / res.timesteps_per_sec
            collect_ms = 1e3 * sum(collect_s) / len(collect_s)
            # the update alone, at the state the run reached: the staged
            # trajectory's copy to the card and the learner step
            traj, last = rl._staging.traj, rl._staging.last_obs
            for i in range(21):
                if i == 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                rl._update_step(rl.params, rl.opt_state,
                                *to_device(traj, last, rl.device), 0)
            torch.cuda.synchronize()
            update_ms = (time.perf_counter() - t0) / 20 * 1e3
            busy_ms, h2d_ms, h2d_n, acts = busy_window(rl)
            if delay == 0:
                layers = step_layers(rl)
        m = res.mean_metrics
        say("host", f"(a) sync ParallelRL, delay {1e3 * delay:.1f} ms a "
            f"step: {iters} iterations after {warmup} warm-up, K1 "
            f"{counts['nstep_returns']} K2 {counts['vtrace_returns']}; "
            f"{res.timesteps_per_sec:.1f} timesteps/s, {iter_ms:.2f} ms an "
            f"iteration = collect {collect_ms:.2f} ms "
            f"({100 * collect_ms / iter_ms:.1f}%) + update "
            f"{iter_ms - collect_ms:.2f} ms; the update alone (H2D + "
            f"learner step) {update_ms:.2f} ms; mean loss {m['loss']:.4f}, "
            f"entropy {m['entropy']:.4f}, rho_mean {m['rho_mean']:.6f}; "
            f"profiler window of {window}: device busy {busy_ms:.3f} ms an "
            f"iteration ({100 * busy_ms / iter_ms:.1f}%), {acts:.0f} device "
            f"activities, H2D copies {h2d_ms:.3f} ms x{h2d_n:.0f} "
            f"({card})")
        if delay == 0:
            say("host", "(a) one acting step's layers alone, at the state "
                "the run reached (host ms a call): " + "; ".join(
                    f"{k} {v:.3f}" for k, v in layers.items()))
        return dict(tps=res.timesteps_per_sec, iter_ms=iter_ms,
                    update_ms=update_ms, busy=busy_ms / iter_ms)

    def step_layers(rl, n=20):
        """The layers of one step of ``collect_host``, each alone: the env
        workers' step (on the pool's workers and on one), the copy of the
        frames into the staging set, their H2D, and the act step with its
        packed read-back (the acting sync)."""
        p, s, dev_ = rl.env, rl._staging, rl.device
        actions = np.zeros(n_envs, np.int64)
        gen = torch.Generator(device=dev_).manual_seed(SEED)
        obs = s.traj.obs[0].to(dev_)
        with envs.HostEnvPool([lambda i=i: FrameEnv(i, 0.0)
                               for i in range(n_envs)], n_workers=1,
                              obs_shape=FrameEnv.SHAPE, device=dev) as one:
            one.reset()

            def h2d():
                s.traj.obs[0].to(dev_, non_blocking=True)
                torch.cuda.synchronize()

            def act():
                a, v, lp = rl._act(rl.params, obs, gen)
                torch.stack([a.float(), v.float(), lp.float()]).cpu()

            fns = {f"env step ({n_workers} workers)":
                   lambda: p.step_host(actions),
                   "env step (1 worker)": lambda: one.step_host(actions),
                   "staging copy": lambda: np.copyto(s.np_traj.obs[1],
                                                     p._obs),
                   "H2D of the frames": h2d,
                   "act step + packed read-back": act}
            out = {}
            for k, fn in fns.items():
                fn()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                out[k] = (time.perf_counter() - t0) / n * 1e3
        return out

    rows = {"sync, delay 0": timed_sync(0.0)}
    sync_tps = rows["sync, delay 0"]["tps"]
    envs_a_worker = -(-n_envs // n_workers)
    # the update's wall spread over the rollout's t_max steps and the envs
    # each worker steps in turn, rounded up to 0.1 ms: the envs then take
    # about as long as the update (the paper's ~50% env time)
    delay = math.ceil(rows["sync, delay 0"]["update_ms"]
                      / (t_max * envs_a_worker) * 10) / 1e4
    say("host", f"calibrated delay: update "
        f"{rows['sync, delay 0']['update_ms']:.2f} ms / ({t_max} steps x "
        f"{envs_a_worker} envs a worker), rounded up to 0.1 ms: "
        f"{1e3 * delay:.1f} ms a step")
    rows[f"sync, delay {1e3 * delay:.1f}"] = timed_sync(delay)

    # (b) bitwise pins, cuDNN deterministic
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        runs = []
        for _ in range(2):
            with pool(0.0) as p:
                rl = sync(p)
                runs.append((rl.run(lock_iters), rl))
        check_bitwise(torch, tree, *runs[0], *runs[1],
                      "two same-seed sync host runs")
        with pool(0.0) as p:
            lock = piped(p, queue_depth=1, lockstep=True, rho_bar=inf,
                         c_bar=inf)
            lock_res, counts = run_checked(
                "lockstep host plane", lock, lock_iters,
                {"nstep_returns": lock_iters})
        check(lock.staleness == [0.0] * lock_iters,
              f"lockstep host staleness {lock.staleness}")
        check_bitwise(torch, tree, lock_res, lock, *runs[0],
                      "lockstep host plane vs sync host ParallelRL")
        dev_sync = paper_atari.build("paac_nature", n_envs, SEED, dev)
        forced = paper_atari.build(
            "paac_nature", n_envs, SEED, dev,
            configs.PipelineConfig(queue_depth=1, lockstep=True, rho_bar=inf,
                                   c_bar=inf, rollout_plane="host"))
        check(forced._plane == "host", f"plane {forced._plane}")
        check_bitwise(torch, tree, forced.run(lock_iters), forced,
                      dev_sync.run(lock_iters), dev_sync,
                      "forced host plane on FrameStack(AtariLike) vs "
                      "ParallelRL")
        del runs, rl, lock, dev_sync, forced
    finally:
        torch.backends.cudnn.deterministic = False
    say("host", f"(b) bitwise, cuDNN deterministic, {lock_iters} "
        "iterations each: two same-seed sync host runs; lockstep "
        "PipelinedRL (depth 1, rho_bar = c_bar = inf) on the same pool "
        f"recipe equals them (K1 {counts['nstep_returns']}, K2 "
        f"{counts['vtrace_returns']}); the forced host plane on "
        f"FrameStack(AtariLike({n_envs})) equals ParallelRL on it")

    # (c) the pipelined host plane at clips 1, at both delays
    pipe_counts = {k: 0 for k in ops.launches}
    for d in (0.0, delay):
        for label, n_act, depth in (("one actor", 1, 2),
                                    (f"four actors of {n_envs // 4} envs", 4,
                                     4)):
            with pool(d) as p:
                rl = piped(p, queue_depth=depth, num_actors=n_act)
                rl.run(warmup)
                res, counts = run_checked(f"{label}, delay {d}", rl, iters,
                                          {"vtrace_returns": iters})
                for k, v in counts.items():
                    pipe_counts[k] += v
                want = [(a, s) for a in range(n_act)
                        for s in range(iters // n_act)]
                check(sorted(rl.learned_ids) == want,
                      f"{label}: an (actor_id, seq) was dropped or learned "
                      "twice")
                # one actor runs at most depth rollouts ahead of the
                # learner, plus the one it is collecting; several contend
                # for the queue's free slots in no fixed order, so their
                # staleness has no such bound (the reference's neither)
                stale = max(rl.staleness)
                check(n_act > 1 or stale <= depth + 1,
                      f"{label}: staleness {stale} > {depth + 1}")
                spans = span_means(rl.telemetry)
                update_ms, _ = span_stat(rl.telemetry, "learner",
                                         "learner.update")
                busy_ms, h2d_ms, h2d_n, acts = busy_window(rl)
            per_iter = rl._steps_per_iter
            iter_ms = 1e3 * per_iter / res.timesteps_per_sec
            wall_s = iters * iter_ms / 1e3
            m = res.mean_metrics
            row = rows[f"{'one actor' if n_act == 1 else 'four actors'}, "
                       f"delay {1e3 * d:.1f}"] = dict(
                tps=res.timesteps_per_sec, iter_ms=iter_ms,
                busy=busy_ms / iter_ms, update_ms=update_ms,
                actor_idle=res.actor_idle_s / (n_act * wall_s),
                learner_idle=res.learner_idle_s / wall_s)
            say("host", f"(c) PipelinedRL host plane, {label}, depth "
                f"{depth}, clips 1, delay {1e3 * d:.1f} ms: {iters} updates "
                f"after {warmup} warm-up, K1 {counts['nstep_returns']} K2 "
                f"{counts['vtrace_returns']}; {res.timesteps_per_sec:.1f} "
                f"timesteps/s, {iter_ms:.2f} ms an update of {per_iter} "
                f"timesteps; staleness mean {m['staleness']:.3f} max "
                f"{stale:.0f}, rho_mean {m['rho_mean']:.4f}; "
                f"actor idle {100 * row['actor_idle']:.1f}%, learner idle "
                f"{100 * row['learner_idle']:.1f}%; profiler window of "
                f"{window}: device busy {busy_ms:.3f} ms an update "
                f"({100 * row['busy']:.1f}%), {acts:.0f} device activities, "
                f"H2D {h2d_ms:.3f} ms x{h2d_n:.0f}; mean host ms of each "
                f"span (track, stage, count): {spans} ({card})")
            del rl
    say("host", "timesteps/s: " + ", ".join(
        f"{k} {r['tps']:.1f} (busy {100 * r['busy']:.1f}%)"
        for k, r in rows.items()))

    # (f) the GIL's hand-off: the four-actor cell at delay 0 again with a
    # switch interval of 0.5 ms (a thread woken from a wait gets the GIL
    # within it), then the default 5 ms restored
    default_switch = sys.getswitchinterval()
    sys.setswitchinterval(0.0005)
    try:
        with pool(0.0) as p:
            rl = piped(p, queue_depth=4, num_actors=4)
            rl.run(warmup)
            res, _ = run_checked("four actors, switch interval 0.5 ms", rl,
                                 iters, {"vtrace_returns": iters})
            update_ms, n_upd = span_stat(rl.telemetry, "learner",
                                         "learner.update")
            del rl
    finally:
        sys.setswitchinterval(default_switch)
    base = rows["four actors, delay 0.0"]
    say("host", f"(f) four actors, depth 4, delay 0, "
        f"sys.setswitchinterval(0.0005): {res.timesteps_per_sec:.1f} "
        f"timesteps/s ({res.timesteps_per_sec / base['tps']:.2f}x the "
        f"default {1e3 * default_switch:g} ms interval's "
        f"{base['tps']:.1f}, {res.timesteps_per_sec / sync_tps:.2f}x sync), "
        f"learner update span {update_ms:.2f} ms x{n_upd} against "
        f"{base['update_ms']:.2f} ms at the default; the interval restored "
        f"to {1e3 * sys.getswitchinterval():g} ms ({card})")

    # (d) the reference trainer with --host-env (PyBoundEnv, GIL-held spin)
    spec = envs.py_bound_spec(n_envs, obs_dim=16, spin=env_spin,
                              n_workers=min(8, n_envs), device=dev)
    step_ms = {}
    for n_w in (spec.n_workers, 1):
        with envs.HostEnvPool([lambda a=a: spec.env_fn(*a)
                               for a in spec.env_args], n_workers=n_w,
                              obs_shape=spec.obs_shape, device=dev) as p:
            p.reset()
            acts = np.zeros(n_envs, np.int64)
            p.step_host(acts)
            t0 = time.perf_counter()
            for _ in range(20):
                p.step_host(acts)
            step_ms[n_w] = (time.perf_counter() - t0) / 20 * 1e3
    say("host", f"(d) PyBoundEnv spin {env_spin}: one step_host of {n_envs} "
        f"envs takes {step_ms[spec.n_workers]:.3f} ms on {spec.n_workers} "
        f"workers and {step_ms[1]:.3f} ms on 1 "
        f"({step_ms[1] / step_ms[spec.n_workers]:.2f}x): the workers "
        "serialise on the GIL")
    base = ["--arch", "paac_vector", "--host-env", "--n-envs", str(n_envs),
            "--t-max", str(t_max), "--iterations", str(cli_iters),
            "--env-spin", str(env_spin), "--device", str(dev)]
    cli = {k: 0 for k in ops.launches}
    with tempfile.TemporaryDirectory() as tmp:
        hb = os.path.join(tmp, "hb.jsonl")
        legs = (("sync", [], "nstep_returns"),
                ("--pipeline", ["--pipeline"], "vtrace_returns"),
                ("--pipeline + observers", ["--pipeline", "--metrics-jsonl",
                                            hb, "--stall-timeout", "30"],
                 "vtrace_returns"))
        for label, extra, kernel in legs:
            ops.reset_launches()
            res = train.main(base + extra)
            counts = dict(ops.launches)
            want = {k: cli_iters if k == kernel else 0 for k in counts}
            check(counts == want, f"train --host-env {label}: launches "
                  f"{counts}, expected {want}")
            check(len(res) == 1
                  and res[0].steps == cli_iters * n_envs * t_max
                  and all(math.isfinite(v)
                          for v in res[0].mean_metrics.values()),
                  f"train --host-env {label}: {res}")
            for k, v in counts.items():
                cli[k] += v
            say("host", f"(d) python -m repro_torch.launch.train "
                f"{' '.join(base + extra[:1])}"
                f"{' --metrics-jsonl F --stall-timeout 30' if extra[1:] else ''}"
                f": {res[0].steps} steps, K1 {counts['nstep_returns']} K2 "
                f"{counts['vtrace_returns']}, {res[0].timesteps_per_sec:.1f} "
                f"timesteps/s (first run included), reward/iter "
                f"{res[0].mean_metrics['reward_sum']:+.3f} ({card})")
        with open(hb) as f:
            lines = [json.loads(x) for x in f if x.strip()]
    check(lines and all(set(x) == HEARTBEAT_KEYS for x in lines)
          and lines[-1]["steps"] == cli_iters * n_envs * t_max,
          f"heartbeat: {len(lines)} lines, keys "
          f"{sorted(set(lines[-1])) if lines else None}")
    say("host", f"(d) heartbeat: {len(lines)} lines, each with the "
        f"reference's keys; last steps {lines[-1]['steps']:.0f}, "
        f"steps_per_s_ema {lines[-1]['steps_per_s_ema']:.1f}")

    # (e) no aliasing on the card
    with pool(0.0) as p:
        p.reset()
        out = p.step(np.zeros(n_envs, np.int64))
        check(all(t.device.type == torch.device(dev).type for t in out),
              f"HostEnvPool.step() gave tensors off {dev}")
        snap = [t.clone() for t in out]
        p.step_host(np.ones(n_envs, np.int64))
        check(all(torch.equal(a, b) for a, b in zip(out, snap)),
              "a HostEnvPool.step() tensor changed at the next step_host")
        check(not torch.equal(out[0].cpu(), torch.from_numpy(p._obs)),
              "the next step_host wrote the same frames")
    real_release = pipeline.HostStagingRing.release

    def poisoned(self, s):
        for t in s.traj + (s.last_obs,):
            if t.dtype.is_floating_point:
                t.fill_(float("nan"))
        real_release(self, s)

    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for poison in (False, True):
            pipeline.HostStagingRing.release = (poisoned if poison
                                                else real_release)
            try:
                with pool(0.0) as p:
                    rl = piped(p, queue_depth=1, lockstep=True, rho_bar=inf,
                               c_bar=inf)
                    runs.append((rl.run(lock_iters), rl))
            finally:
                pipeline.HostStagingRing.release = real_release
        check(all(math.isfinite(v) for v in runs[1][0].mean_metrics.values()),
              f"NaN-poisoned release: {runs[1][0].mean_metrics}")
        check_bitwise(torch, tree, *runs[1], *runs[0],
                      "NaN-poisoned release vs a clean rerun")
    finally:
        torch.backends.cudnn.deterministic = False
    say("host", "(e) HostEnvPool.step() gives CUDA tensors that the next "
        "step_host leaves unchanged; staging sets overwritten with NaN the "
        f"moment release() hands them back: {lock_iters} lockstep updates "
        "finite and bitwise equal to a clean rerun; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return ({k: v for k, v in sync_counts.items() if v},
            {k: v for k, v in pipe_counts.items() if v},
            {k: v for k, v in cli.items() if v}, rows, delay)


def frame_spec(envs, np, n_envs: int, delay: float, n_workers: int, dev):
    """A picklable ``HostEnvSpec`` of ``n_envs`` ``FrameEnv``s: spawned
    workers rebuild it (``FrameEnv`` is a module-level class of this
    script, which a spawned child imports again as ``__mp_main__``)."""
    return envs.HostEnvSpec(env_fn=FrameEnv,
                            env_args=tuple((i, delay) for i in range(n_envs)),
                            n_workers=n_workers, obs_shape=FrameEnv.SHAPE,
                            obs_dtype=np.float32, device=str(dev))


def phase_host_process(torch, np, configs, envs, A, optim, pipeline, ops,
                       tree, train, card, sync_rows, delay, dev="cuda",
                       n_envs=32, n_workers=8, warmup=10, iters=100,
                       lock_iters=10, window=10, cli_iters=50, env_spin=2000,
                       sweep=(1, 2, 4, 8), sweep_iters=50):
    """The process actor plane (spawned workers over shared memory) in the
    host phase's setting: one worker at depth 2 and four of 8 envs at
    depth 4, at delay 0 and at the calibrated ``delay``, beside the
    synchronous rows ``sync_rows`` of ``phase_host``; 32 ``PyBoundEnv``s
    on 1, 2, 4 and 8 workers; lockstep ≡ the thread host plane bitwise;
    nothing left in /dev/shm; the trainer's ``--actor-backend process``
    leg. Returns the launch counts of the timed runs and of the trainer's
    leg."""
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    leaves = tree.tree_leaves
    inf = float("inf")
    t_max = 5
    lr = 0.0007 * n_envs
    cfg = configs.get_config("paac_nature").replace(
        obs_shape=FrameEnv.SHAPE, num_actions=6)

    def agent(c=cfg):
        return A.PAACAgent(c, A.PAACConfig(gamma=0.99, entropy_beta=0.01,
                                           t_max=t_max))

    def piped(env, c=cfg, lr=lr, **cfg_kw):
        cfg_kw.setdefault("actor_backend", "process")
        return pipeline.PipelinedRL(env, agent(c),
                                    pipeline=configs.PipelineConfig(**cfg_kw),
                                    optimizer="rmsprop",
                                    lr_schedule=optim.constant(lr), seed=SEED,
                                    device=dev)

    def shm_now():
        return set(os.listdir("/dev/shm"))

    def timed(rl, n_act, label, n_iters, free0, reserved0):
        """Warm-up, then ``n_iters`` updates with the counts set to 0 just
        before them; every (actor_id, seq) learned once; spans; then a
        profiler window of the parent's device work. ``free0`` and
        ``reserved0`` are the card's free and the parent's reserved bytes
        before the workers were spawned: what the card lost beyond the
        parent's own growth is the workers' (contexts and tensors).
        Returns the row."""
        t0 = time.perf_counter()
        rl.run(warmup)
        warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        child_mib = (free0 - torch.cuda.mem_get_info()[0]
                     - (torch.cuda.memory_reserved() - reserved0)) / 2**20
        quota = [n_iters // n_act + (1 if a < n_iters % n_act else 0)
                 for a in range(n_act)]
        before = [t.clone() for t in leaves(rl.params)]
        ops.reset_launches()
        res = rl.run(n_iters)
        counts = dict(ops.launches)
        want = {k: n_iters if k == "vtrace_returns" else 0 for k in counts}
        check(counts == want, f"{label}: launches {counts}, expected {want}")
        check(all(math.isfinite(v) for v in res.mean_metrics.values()),
              f"{label}: non-finite metrics {res.mean_metrics}")
        check(max((a - b).abs().max().item() for a, b in
                  zip(before, leaves(rl.params))) > 0,
              f"{label}: the parameters did not change")
        check(sorted(rl.learned_ids) == [(a, q) for a in range(n_act)
                                         for q in range(quota[a])],
              f"{label}: an (actor_id, seq) was dropped or learned twice")
        hub, stale_max = rl.telemetry, max(rl.staleness)
        update_ms, _ = span_stat(hub, "learner", "learner.update")
        collect_ms, n_col = span_stat(hub, "worker", "collect")
        copy_ms, _ = span_stat(hub, "worker", "shm.copy")
        publish_ms, _ = span_stat(hub, "shm.publish", "shm.copy")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rl.run(window)
            torch.cuda.synchronize()
        busy_ms, by_name = device_window(prof, window)
        h2d = [row for name, row in by_name.items() if "HtoD" in name]
        # one payload's copy to the card, host-timed: from a worker's
        # pageable shm set, as the learner copies it, and from page-locked
        # copies of it (the workers are idle between runs)
        payload = list(rl._process_plane._workers[0].sets[0].traj) + [
            rl._process_plane._workers[0].sets[0].last_obs]
        payload_ms = {}
        for kind, src in (("pageable", payload),
                          ("page-locked", [t.pin_memory() for t in payload])):
            for i in range(21):
                if i == 1:
                    t0 = time.perf_counter()
                for t in src:
                    t.to(dev, non_blocking=True)
                torch.cuda.synchronize()
            payload_ms[kind] = (time.perf_counter() - t0) / 20 * 1e3
        del payload
        per_iter = rl._steps_per_iter
        iter_ms = 1e3 * per_iter / res.timesteps_per_sec
        wall_s = n_iters * iter_ms / 1e3
        m = res.mean_metrics
        return dict(
            tps=res.timesteps_per_sec, iter_ms=iter_ms, counts=counts,
            update_ms=update_ms, collect_ms=collect_ms, n_col=n_col,
            copy_ms=copy_ms, publish_ms=publish_ms,
            learner_idle=res.learner_idle_s / wall_s,
            actor_idle=res.actor_idle_s / (n_act * wall_s),
            stale_mean=m["staleness"], stale_max=stale_max,
            busy_ms=busy_ms, busy=busy_ms / iter_ms,
            h2d_ms=sum(r[0] for r in h2d), h2d_n=sum(r[1] for r in h2d),
            per_iter=per_iter, warm_s=warm_s, child_mib=child_mib / n_act,
            pageable_ms=payload_ms["pageable"],
            pinned_ms=payload_ms["page-locked"])

    say("host", f"process plane: paac_nature on HostEnvSpecs of {n_envs} "
        f"FrameEnvs, spawned workers (each its own interpreter and CUDA "
        f"context, acting on {dev}), shm staging and the shm param slot; "
        "the parent's learner through K2 at clips 1")
    path = {k: 0 for k in ops.launches}
    rows = {}
    for d in (0.0, delay):
        for label, n_act, depth in (("one worker", 1, 2),
                                    (f"four workers of {n_envs // 4} envs",
                                     4, 4)):
            spec = frame_spec(envs, np, n_envs, d, n_workers, dev)
            free0, reserved0 = (torch.cuda.mem_get_info()[0],
                                torch.cuda.memory_reserved())
            rl = piped(spec, queue_depth=depth, num_actors=n_act)
            try:
                r = timed(rl, n_act, f"process {label}, delay {d}", iters,
                          free0, reserved0)
                segs = rl._process_plane.segment_names()
                procs = [w.proc for w in rl._process_plane._workers]
            finally:
                rl.close()
            check(not any(p.is_alive() for p in procs),
                  f"process {label}: a worker outlived close()")
            check(not set(segs) & shm_now(),
                  f"process {label}: segments left in /dev/shm")
            for k, v in r["counts"].items():
                path[k] += v
            key = (f"{'one worker' if n_act == 1 else 'four workers'}, "
                   f"delay {1e3 * d:.1f}")
            rows[key] = r
            sync = sync_rows["sync, delay 0" if d == 0 else
                             f"sync, delay {1e3 * d:.1f}"]
            thread_key = (f"{'one actor' if n_act == 1 else 'four actors'}"
                          f", delay {1e3 * d:.1f}")
            thread = sync_rows.get(thread_key)
            say("host", f"(g) process plane, {label}, depth {depth}, clips "
                f"1, delay {1e3 * d:.1f} ms: the warm-up of {warmup} (the "
                f"workers' start, imports and first forwards included) "
                f"{r['warm_s']:.1f} s, "
                f"{r['child_mib']:.0f} MiB of the card a worker; {iters} "
                "updates, "
                f"K1 {r['counts']['nstep_returns']} K2 "
                f"{r['counts']['vtrace_returns']}; {r['tps']:.1f} "
                f"timesteps/s ({r['tps'] / sync['tps']:.2f}x sync"
                + (f", {r['tps'] / thread['tps']:.2f}x the thread plane's "
                   f"{thread['tps']:.1f}" if thread else "")
                + f"), {r['iter_ms']:.2f} ms an update of {r['per_iter']} "
                f"timesteps; learner update span {r['update_ms']:.2f} ms"
                + (f" (thread plane {thread['update_ms']:.2f})" if thread
                   else "")
                + f", learner idle {100 * r['learner_idle']:.1f}%, actor "
                f"(drainer) idle {100 * r['actor_idle']:.1f}%; staleness "
                f"mean {r['stale_mean']:.3f} max {r['stale_max']:.0f}; "
                f"workers' collect {r['collect_ms']:.2f} ms x{r['n_col']}, "
                f"param copy-in {r['copy_ms']:.3f} ms; the D2H publish into "
                f"shm {r['publish_ms']:.3f} ms an update; profiler window of "
                f"{window} (the parent's device work): busy "
                f"{r['busy_ms']:.3f} ms an update ({100 * r['busy']:.1f}%), "
                f"HtoD DMA {r['h2d_ms'] / window:.3f} ms x"
                f"{r['h2d_n'] / window:.0f} an update; one payload's copy "
                f"to the card alone, host-timed: {r['pageable_ms']:.3f} ms "
                f"from the pageable shm set, {r['pinned_ms']:.3f} ms from "
                f"page-locked memory ({card})")

    # (h) 32 PyBoundEnvs (spin 2000, GIL-held bytecode) on 1-8 workers
    vcfg = configs.get_config("paac_vector").replace(obs_shape=(16,),
                                                     num_actions=3)
    base = None
    for n_w in sweep:
        # the trainer's recipe; a shard's pool gets 8 / n_w threads
        spec = envs.py_bound_spec(n_envs, obs_dim=16, spin=env_spin,
                                  n_workers=min(8, n_envs), device=dev)
        free0, reserved0 = (torch.cuda.mem_get_info()[0],
                            torch.cuda.memory_reserved())
        rl = piped(spec, c=vcfg, lr=3e-3, queue_depth=4, num_actors=n_w)
        try:
            r = timed(rl, n_w, f"PyBoundEnv on {n_w} workers", sweep_iters,
                      free0, reserved0)
        finally:
            rl.close()
        for k, v in r["counts"].items():
            path[k] += v
        base = base or r
        env_tps = r["per_iter"] * n_w / (r["collect_ms"] / 1e3)
        say("host", f"(h) {n_envs} PyBoundEnvs, spin {env_spin}, on {n_w} "
            f"process worker(s) of {n_envs // n_w} envs: {sweep_iters} "
            f"updates, {r['tps']:.1f} timesteps/s "
            f"({r['tps'] / base['tps']:.2f}x one worker), the workers' "
            f"collect {r['collect_ms']:.2f} ms a rollout of "
            f"{r['per_iter']} timesteps (the workers together step "
            f"{env_tps:.0f} timesteps/s while collecting, "
            f"{env_tps / (base['per_iter'] / (base['collect_ms'] / 1e3)):.2f}"
            f"x one), learner update span {r['update_ms']:.2f} ms, learner "
            f"idle {100 * r['learner_idle']:.1f}% ({card})")

    # (i) lockstep process == lockstep thread host plane, bitwise
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        runs = []
        for backend in ("thread", "process"):
            spec = frame_spec(envs, np, n_envs, 0.0, n_workers, dev)
            rl = piped(spec, queue_depth=1, lockstep=True, rho_bar=inf,
                       c_bar=inf, actor_backend=backend)
            try:
                ops.reset_launches()
                res = rl.run(lock_iters)
                check(dict(ops.launches)["nstep_returns"] == lock_iters,
                      f"lockstep {backend}: launches {dict(ops.launches)}")
                segs = (rl._process_plane.segment_names()
                        if backend == "process" else [])
            finally:
                rl.close()
            runs.append((res, rl))
        check(not set(segs) & shm_now(), "lockstep: segments left")
        check_bitwise(torch, tree, *runs[1], *runs[0],
                      "lockstep process plane vs thread host plane")
        check(torch.equal(runs[0][1]._actor_keys[0][0].get_state(),
                          runs[1][1]._actor_keys[0][0].get_state()),
              "lockstep: the worker's acting generator came back different")
        del runs, rl
    finally:
        torch.backends.cudnn.deterministic = False
    say("host", f"(i) bitwise, cuDNN deterministic: {lock_iters} lockstep "
        "updates at rho_bar = c_bar = inf on one spawned worker equal the "
        "thread host plane's (metrics, every parameter, the acting "
        "generator's state brought back); every (actor_id, seq) was "
        "learned once in (g) and (h); after each close() no worker lived "
        "and no segment of the plane was left in /dev/shm")

    # (j) the trainer's process leg
    argv = ["--arch", "paac_vector", "--pipeline", "--actor-backend",
            "process", "--host-env", "--n-envs", str(n_envs), "--t-max",
            str(t_max), "--iterations", str(cli_iters), "--env-spin",
            str(env_spin), "--device", str(dev)]
    ops.reset_launches()
    t0 = time.perf_counter()
    res = train.main(argv)
    wall = time.perf_counter() - t0
    cli = dict(ops.launches)
    want = {k: cli_iters if k == "vtrace_returns" else 0 for k in cli}
    check(cli == want, f"train --actor-backend process: launches {cli}")
    check(len(res) == 1 and res[0].steps == cli_iters * n_envs * t_max
          and all(math.isfinite(v) for v in res[0].mean_metrics.values()),
          f"train --actor-backend process: {res}")
    say("host", f"(j) python -m repro_torch.launch.train {' '.join(argv)}: "
        f"{res[0].steps} steps, K1 {cli['nstep_returns']} K2 "
        f"{cli['vtrace_returns']}, {res[0].timesteps_per_sec:.1f} "
        f"timesteps/s (first run included; {wall:.1f} s with the spawn), "
        f"reward/iter {res[0].mean_metrics['reward_sum']:+.3f} ({card}); "
        f"the process legs took {time.perf_counter() - t_phase:.1f} s")
    return ({k: v for k, v in path.items() if v},
            {k: v for k, v in cli.items() if v})


def phase_replay(torch, configs, core, envs, A, optim, pipeline, ops, tree,
                 train, card, dev="cuda", n_envs=32, warmup=10, iters=100,
                 lock_iters=10, capacity=64, cli_iters=50):
    """The replay plane in the paper's setting (paac_nature,
    FrameStack(AtariLike(n_envs)), fp32, RMSProp lr 0.0007 n_e, t_max 5):
    depth-1 lockstep pipelined DQN ≡ ``SyncReplayDQN`` over two runs and
    PAAC at staleness 0 ≡ on-policy, bitwise; pipelined DQN, prioritized
    DQN and V-trace PAAC timed on a ring of ``capacity`` rollouts; the
    trainer's ``--replay`` legs. Returns the launch counts of the timed
    runs and of the trainer's legs."""
    t_phase = time.perf_counter()
    leaves = tree.tree_leaves
    inf = float("inf")
    t_max = 5
    lr = 0.0007 * n_envs

    def env():
        return envs.FrameStack(envs.AtariLike(n_envs, device=dev), 4)

    cfg = configs.get_config("paac_nature").replace(
        obs_shape=env().obs_shape, num_actions=env().num_actions)

    def dqn():
        return A.DQNAgent(cfg, A.DQNConfig(t_max=t_max))

    def paac():
        return A.PAACAgent(cfg, A.PAACConfig(gamma=0.99, entropy_beta=0.01,
                                             t_max=t_max))

    kw = dict(optimizer="rmsprop", lr_schedule=optim.constant(lr), seed=SEED,
              device=dev)

    def piped(agent, **cfg_kw):
        return pipeline.PipelinedRL(env(), agent, **kw,
                                    pipeline=configs.PipelineConfig(
                                        replay_plane=True, **cfg_kw))

    # (a) bitwise pins, cuDNN deterministic
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        sync = pipeline.SyncReplayDQN(env(), dqn(), replay_capacity=8, **kw)
        pipe = piped(dqn(), queue_depth=1, lockstep=True, replay_capacity=8)
        ops.reset_launches()
        for n in (lock_iters, lock_iters // 2):
            check_bitwise(torch, tree, sync.run(n), sync, pipe.run(n), pipe,
                          f"lockstep replay DQN vs SyncReplayDQN ({n})",
                          DQN_METRICS)
        check(not any(ops.launches.values()),
              f"replay DQN launched {dict(ops.launches)}")
        on = pipeline.PipelinedRL(env(), paac(), **kw,
                                  pipeline=configs.PipelineConfig(
                                      queue_depth=1, lockstep=True))
        rep = piped(paac(), queue_depth=1, lockstep=True, replay_capacity=1)
        ops.reset_launches()
        check_bitwise(torch, tree, on.run(lock_iters), on,
                      rep.run(lock_iters), rep,
                      "replay PAAC at staleness 0, clips 1, vs the FIFO "
                      "device plane")
        k2 = dict(ops.launches)["vtrace_returns"]
        check(k2 == 2 * lock_iters, f"staleness-0 PAAC: K2 {k2}")
        ref = core.ParallelRL(env(), paac(), **kw)
        rep = piped(paac(), queue_depth=1, lockstep=True, replay_capacity=1,
                    rho_bar=inf, c_bar=inf)
        check_bitwise(torch, tree, ref.run(lock_iters), ref,
                      rep.run(lock_iters), rep,
                      "replay PAAC at staleness 0, clips inf, vs ParallelRL")
        del sync, pipe, on, rep, ref
    finally:
        torch.backends.cudnn.deterministic = False
    say("replay", f"(a) bitwise, cuDNN deterministic: depth-1 lockstep "
        f"pipelined DQN equals SyncReplayDQN over two runs ({lock_iters} + "
        f"{lock_iters // 2}, no kernel launched); replay PAAC at capacity 1 "
        f"(staleness 0) equals the FIFO device plane's lockstep run at "
        f"clips 1 (K2 {k2} over both) and ParallelRL at clips inf")

    # (b) timed legs on a ring of `capacity` rollouts
    path = {k: 0 for k in ops.launches}
    roll_bytes = None
    legs = (("DQN", dqn, {}, 0),
            ("DQN prioritized, batch 2", dqn,
             dict(prioritized=True, replay_batch=2), 0),
            ("PAAC V-trace, clips 1", paac, {}, iters))
    for label, make, extra, k2_want in legs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        rl = piped(make(), replay_capacity=capacity, **extra)
        rl.run(warmup)
        before = [t.clone() for t in leaves(rl.params)]
        ops.reset_launches()
        res = rl.run(iters)
        counts = dict(ops.launches)
        want = {k: k2_want if k == "vtrace_returns" else 0 for k in counts}
        check(counts == want, f"replay {label}: launches {counts}, "
              f"expected {want}")
        check(all(math.isfinite(v) for v in res.mean_metrics.values()),
              f"replay {label}: non-finite metrics {res.mean_metrics}")
        check(max((a - b).abs().max().item() for a, b in
                  zip(before, leaves(rl.params))) > 0,
              f"replay {label}: the parameters did not change")
        check(rl.learned_ids == [(-2, q) for q in range(iters)],
              f"replay {label}: learned {rl.learned_ids[:4]}...")
        for k, v in counts.items():
            path[k] += v
        m = res.mean_metrics
        wall_s = iters * n_envs * t_max / res.timesteps_per_sec
        update_ms, _ = span_stat(rl.telemetry, "learner", "learner.update")
        sample_ms, _ = span_stat(rl.telemetry, "replay", "replay.sample")
        peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
        if roll_bytes is None:  # obs and bootstrap, then the (T, E) rest
            roll_bytes = ((t_max + 1) * n_envs * math.prod(cfg.obs_shape) * 4
                          + t_max * n_envs * (8 + 4 + 1 + 4 + 4))
        say("replay", f"(b) pipelined {label} on a ring of {capacity} "
            f"rollouts ({roll_bytes / 1e6:.1f} MB each, "
            f"{capacity * roll_bytes / 1e9:.2f} GB resident when full), one "
            f"actor: {iters} updates after {warmup} warm-up, K1 "
            f"{counts['nstep_returns']} K2 {counts['vtrace_returns']}; "
            f"{res.timesteps_per_sec:.1f} timesteps/s, staleness mean "
            f"{m['staleness']:.2f} max {max(rl.staleness):.0f}, learner "
            f"idle {100 * res.learner_idle_s / wall_s:.1f}%, "
            f"update span {update_ms:.2f} ms, sample+concat {sample_ms:.3f} "
            f"ms, mean loss {m['loss']:.4f}; peak device memory above the "
            f"start {peak:.2f} GiB ({card})")
        del rl, before
        torch.cuda.empty_cache()

    # (c) the trainer's replay legs on TokenEnv
    base = ["--arch", "paac_vector", "--n-envs", str(n_envs), "--t-max",
            str(t_max), "--iterations", str(cli_iters), "--device", str(dev),
            "--pipeline", "--replay"]
    cli = {k: 0 for k in ops.launches}
    for extra, kernel in (([], "vtrace_returns"),
                          (["--algo", "dqn"], None)):
        ops.reset_launches()
        res = train.main(base + extra)
        counts = dict(ops.launches)
        want = {k: cli_iters if k == kernel else 0 for k in counts}
        check(counts == want, f"train {' '.join(base + extra)}: launches "
              f"{counts}, expected {want}")
        check(len(res) == 1 and res[0].steps == cli_iters * n_envs * t_max
              and all(math.isfinite(v) for v in res[0].mean_metrics.values()),
              f"train --replay {extra}: {res}")
        for k, v in counts.items():
            cli[k] += v
        say("replay", f"(c) python -m repro_torch.launch.train "
            f"{' '.join(base + extra)}: {res[0].steps} steps, K1 "
            f"{counts['nstep_returns']} K2 {counts['vtrace_returns']}, "
            f"{res[0].timesteps_per_sec:.1f} timesteps/s (first run "
            f"included), reward/iter {res[0].mean_metrics['reward_sum']:+.3f}"
            f" ({card}); the phase took "
            f"{time.perf_counter() - t_phase:.1f} s")
    return ({k: v for k, v in path.items() if v},
            {k: v for k, v in cli.items() if v})


def fault_spans(hub):
    """``{category: [(t0, t1), ...]}`` of the supervisor's ``fault.*``
    spans in ``hub`` (empty without a supervisor track)."""
    out = {}
    for _, _, em in hub.tracks():
        if em.name == "supervisor":
            for cat, t0, t1 in em.snapshot():
                out.setdefault(em.categories[cat], []).append((t0, t1))
    return out


def first_put(hub, actor_id: int):
    """Start of the first ``queue.put_wait`` span of replica ``actor_id``:
    when its first payload reached the ring (None if it put nothing)."""
    for _, _, em in hub.tracks():
        if em.name == f"actor{actor_id}":
            starts = [t0 for cat, t0, _ in em.snapshot()
                      if em.categories[cat] == "queue.put_wait"]
            return min(starts) if starts else None
    return None


def phase_faults(torch, np, configs, envs, A, optim, pipeline, paper_atari,
                 ops, tree, train, ckpt, card, dev="cuda", n_envs=32,
                 n_workers=8, lock_iters=12, every=4, kill_at=9, warmup=10,
                 iters=100, degrade_iters=40, proc_iters=60, host_iters=30,
                 saves=5, cli_iters=50, stall_s=0.5):
    """Fault tolerance in the paper's setting (paac_nature, 84x84x4 fp32
    frames, n_e = 32, t_max 5, RMSProp lr 0.0007 n_e): (a) kill and resume
    ≡ uninterrupted, bitwise, at clips inf (K1) and 1 (K2); (b) an elastic
    thread respawn among four actors, timed beside the un-faulted run;
    (c) a degrade; (d) a process plane of four workers: an "error" kill
    (the child reused) and an "exit" kill (one fresh spawn), timed beside
    the un-faulted run, and nothing left after close(); (e) a dropped
    release and a stalled learner on the host plane; (f) the checkpoint's
    cost and its round trip on the card; (g) the trainer's legs. Returns
    the launch counts of (a)-(e) and of the trainer's legs."""
    t_phase = time.perf_counter()
    leaves = tree.tree_leaves
    PipelineConfig = configs.PipelineConfig
    FaultPlan = pipeline.FaultPlan
    inf = float("inf")
    t_max = 5
    lr = 0.0007 * n_envs
    cuda = torch.device(dev).type == "cuda"
    path = {k: 0 for k in ops.launches}

    def add(counts):
        for k, v in counts.items():
            path[k] += v

    def expect(label, counts, n, kernel="vtrace_returns"):
        want = {k: n if k == kernel else 0 for k in counts}
        check(counts == want, f"faults {label}: launches {counts}, "
              f"expected {want}")
        add(counts)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # (a) kill and resume ≡ uninterrupted, bitwise (cuDNN deterministic)
    ck_root = tempfile.mkdtemp(prefix="faults_ckpt_")
    lock_rows = []
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for clip, kernel in ((inf, "nstep_returns"), (1.0, "vtrace_returns")):
            d = os.path.join(ck_root, f"clip{clip}")

            def lockstep(**kw):
                return paper_atari.build("paac_nature", n_envs, SEED, dev,
                                         PipelineConfig(queue_depth=1,
                                                        lockstep=True,
                                                        rho_bar=clip,
                                                        c_bar=clip, **kw))

            a = lockstep()
            ops.reset_launches()
            sync()
            t0 = time.perf_counter()
            a.run(lock_iters)
            sync()
            lock_ms = 1e3 * (time.perf_counter() - t0) / lock_iters
            expect(f"uninterrupted, clips {clip}", dict(ops.launches),
                   lock_iters, kernel)
            b = lockstep(checkpoint_dir=d, checkpoint_every=every,
                         fault_plan=FaultPlan(kills=((0, kill_at, "error"),)))
            ops.reset_launches()
            try:
                b.run(lock_iters)
                check(False, "the killed run did not fail")
            except RuntimeError as e:
                check("pipeline actor 0 failed" in str(e)
                      and isinstance(e.__cause__, pipeline.InjectedActorFault),
                      f"the killed run failed otherwise: {e!r}")
            expect(f"killed, clips {clip}", dict(ops.launches),
                   len(b.learned_ids), kernel)
            saved = ckpt.latest_step(d, prefix="pipe")
            want_saved = (min(kill_at, lock_iters) // every) * every
            check(saved == want_saved, f"newest checkpoint {saved}, "
                  f"expected {want_saved}")
            # the resumed run saves too (at its every-th update), so (f)
            # has its live slot state to time
            c = lockstep(checkpoint_dir=d, checkpoint_every=every)
            check(c.restore() == saved, "restore() did not report the update")
            check(all(t.device.type == torch.device(dev).type
                      for t in leaves((c.params, c.opt_state))),
                  "restored tensors off the card")
            ops.reset_launches()
            c.run(lock_iters - saved)
            expect(f"resumed, clips {clip}", dict(ops.launches),
                   lock_iters - saved, kernel)
            for x, y in zip(leaves((a.params, a.opt_state)),
                            leaves((c.params, c.opt_state))):
                check(torch.equal(x, y), f"clips {clip}: the resumed run "
                      "differs from the uninterrupted one")
            check(c.total_steps == a.total_steps,
                  f"total_steps {c.total_steps} vs {a.total_steps}")
            check([s for _, s in c.learned_ids]
                  == list(range(saved, lock_iters)),
                  f"resumed seqs {c.learned_ids}")
            lock_rows.append((clip, len(b.learned_ids), saved, lock_ms))
            if clip == 1.0:
                keep = c  # (f) times its saves
            del a, b
    finally:
        torch.backends.cudnn.deterministic = False
    say("faults", f"(a) depth-1 lockstep, thread device plane, "
        f"{lock_iters} updates, a checkpoint every {every}, killed after "
        f"{kill_at} rollouts: " + "; ".join(
            f"clips {clip}: {n} updates before the kill, resumed from update "
            f"{s}, params, RMSProp state and total_steps bitwise the "
            f"uninterrupted run's, seqs continue at {s} (uninterrupted: "
            f"{ms:.2f} ms a lockstep iteration)"
            for clip, n, s, ms in lock_rows) + " (cuDNN deterministic)")

    # (b) elastic thread respawn among four actors, and (c) a degrade
    def four(**kw):
        return paper_atari.build("paac_nature", n_envs, SEED, dev,
                                 PipelineConfig(num_actors=4, queue_depth=4,
                                                **kw))

    def timed(rl, n, label):
        rl.run(warmup)
        ops.reset_launches()
        t0 = time.perf_counter()
        res = rl.run(n)
        sync()
        wall = time.perf_counter() - t0
        expect(label, dict(ops.launches), n)
        check(len(rl.learned_ids) == n == len(set(rl.learned_ids)),
              f"{label}: {len(rl.learned_ids)} payloads, "
              f"{len(set(rl.learned_ids))} distinct, of {n}")
        check(all(math.isfinite(v) for v in res.mean_metrics.values()),
              f"{label}: non-finite metrics")
        return res, wall

    base = four()
    res0, _ = timed(base, iters, "four actors, no fault")
    del base
    el = four(elastic=True)
    # warm up un-faulted, then arm the kill for the timed run
    el.run(warmup)
    el.pipeline = PipelineConfig(**{**el.pipeline.__dict__, "fault_plan":
                                    FaultPlan(kills=((1, 3, "error"),))})
    ops.reset_launches()
    res1 = el.run(iters)
    sync()
    expect("four actors, one thread kill", dict(ops.launches), iters)
    sup = el.supervisor
    check(sup.episodes == [("respawn", 1, 4)], f"episodes {sup.episodes}")
    check(len(el.learned_ids) == iters == len(set(el.learned_ids)),
          f"thread respawn: {len(el.learned_ids)} payloads of {iters}")
    sp = fault_spans(el.telemetry)
    detect_s = sp["fault.detect"][0][0]
    respawn_s = sp["fault.respawn"][0][1] - detect_s
    first_s = first_put(el.telemetry, 4) - detect_s
    say("faults", f"(b) four actors of {n_envs // 4} envs, depth 4, clips "
        f"1, {iters} updates: no fault {res0.timesteps_per_sec:.1f} "
        f"timesteps/s; elastic with an 'error' kill of slot 1 after 3 "
        f"rollouts {res1.timesteps_per_sec:.1f} timesteps/s "
        f"({res1.timesteps_per_sec / res0.timesteps_per_sec:.3f}x), full "
        f"quota, each (actor_id, seq) once, episodes {sup.episodes}; "
        f"detect -> respawned {1e3 * respawn_s:.1f} ms (backoff "
        f"{1e3 * el.pipeline.restart_backoff_s:.0f} ms), detect -> the new "
        f"replica's first payload {1e3 * first_s:.1f} ms ({card})")
    del el
    dg = four(elastic=True, restart_budget=0,
              fault_plan=FaultPlan(kills=((2, 2, "error"),)))
    ops.reset_launches()
    dg.run(degrade_iters)
    expect("degrade", dict(ops.launches), degrade_iters)
    check(dg.supervisor.episodes == [("giveup", 2, 2)]
          and len(dg.learned_ids) == degrade_iters
          and len(set(dg.learned_ids)) == degrade_iters,
          f"degrade: {dg.supervisor.episodes}, {len(dg.learned_ids)}")
    by_slot = {a: sum(1 for b, _ in dg.learned_ids if b == a)
               for a in range(4)}
    say("faults", f"(c) restart_budget 0, an 'error' kill of slot 2 after 2 "
        f"rollouts, {degrade_iters} updates: episodes "
        f"{dg.supervisor.episodes}, payloads by slot {by_slot} (slot 2's "
        f"quota was {degrade_iters // 4}; the survivors absorbed the rest "
        "through the ledger)")
    del dg

    # (d) the process plane: an "error" kill, then an "exit" kill
    spec = frame_spec(envs, np, n_envs, 0.0, n_workers, dev)
    cfg = configs.get_config("paac_nature").replace(
        obs_shape=FrameEnv.SHAPE, num_actions=6)

    def host_rl(env, **kw):
        return pipeline.PipelinedRL(
            env, A.PAACAgent(cfg, A.PAACConfig(gamma=0.99, entropy_beta=0.01,
                                               t_max=t_max)),
            optimizer="rmsprop", lr_schedule=optim.constant(lr), seed=SEED,
            device=dev, pipeline=PipelineConfig(**kw))

    t0 = time.perf_counter()
    pr = host_rl(spec, num_actors=4, queue_depth=4, actor_backend="process",
                 elastic=True, restart_backoff_s=0.05)
    plane = pr._process_plane
    proc_rows = []
    try:
        pr.run(warmup)
        start_s = time.perf_counter() - t0
        first = [w.proc for w in plane._workers]
        for mode in (None, "error", "exit"):
            pr.pipeline = PipelineConfig(**{
                **pr.pipeline.__dict__, "fault_plan":
                None if mode is None else FaultPlan(kills=((1, 3, mode),))})
            ops.reset_launches()
            t1 = time.perf_counter()
            res = pr.run(proc_iters)
            wall = time.perf_counter() - t1
            label = f"process, {mode or 'no'} kill"
            expect(label, dict(ops.launches), proc_iters)
            check(len(pr.learned_ids) == proc_iters
                  == len(set(pr.learned_ids)),
                  f"{label}: {len(pr.learned_ids)} payloads of {proc_iters}")
            eps = pr.supervisor.episodes
            row = dict(mode=mode, tps=res.timesteps_per_sec, wall=wall,
                       eps=eps)
            if mode is not None:
                check(eps == [("respawn", 1, 4)], f"{label}: {eps}")
                sp = fault_spans(pr.telemetry)
                det = sp["fault.detect"][0][0]
                row["respawn_s"] = sp["fault.respawn"][0][1] - det
                row["first_s"] = first_put(pr.telemetry, 4) - det
            proc_rows.append(row)
        check(plane._workers[1].proc is not first[1]
              and [w.proc for w in plane._graveyard] == [first[1]]
              and first[1].exitcode == 17,
              "process: the 'exit' kill did not retire slot 1's child to "
              "the graveyard and spawn one fresh")
        segs = plane.segment_names()
        handles = plane._handles()
    finally:
        pr.close()
    check(not any(w.proc.is_alive() for w in handles),
          "process: a worker (or a retired one) outlived close()")
    check(not set(segs) & set(os.listdir("/dev/shm")),
          "process: segments left in /dev/shm (graveyard included)")
    ok = proc_rows[0]
    say("faults", f"(d) process plane, four workers of {n_envs // 4} "
        f"FrameEnvs ({n_workers // 4 or 1} env threads each), depth 4, "
        f"clips 1, {proc_iters} updates a run; the plane's start and "
        f"{warmup} warm-up updates {start_s:.1f} s; no fault "
        f"{ok['tps']:.1f} timesteps/s ({ok['wall']:.2f} s); " + "; ".join(
            f"'{r['mode']}' kill of slot 1 after 3 rollouts "
            f"({'child reused' if r['mode'] == 'error' else 'one fresh spawn'}"
            f"): {r['tps']:.1f} timesteps/s "
            f"({r['tps'] / ok['tps']:.3f}x, {r['wall']:.2f} s), detect -> "
            f"respawned {1e3 * r['respawn_s']:.1f} ms, detect -> the new "
            f"epoch's first payload {r['first_s']:.3f} s"
            for r in proc_rows[1:]) + "; after close() no worker alive, "
        f"graveyard included, and none of the plane's {len(segs)} "
        f"segments left in /dev/shm ({card})")

    # (e) learner-side faults on the thread host plane
    host_rows = {}
    for label, plan in (("none", None),
                        ("drop+stall", FaultPlan(
                            drop_release=(2,),
                            stall_learner=((host_iters // 2, stall_s),)))):
        rl = host_rl(frame_spec(envs, np, n_envs, 0.0, n_workers, dev),
                     queue_depth=2, fault_plan=plan)
        try:
            rl.run(3)
            ops.reset_launches()
            res = rl.run(host_iters)
        finally:
            rl.close()
        expect(f"host, {label}", dict(ops.launches), host_iters)
        check(len(rl.learned_ids) == host_iters,
              f"host {label}: {len(rl.learned_ids)} of {host_iters}")
        host_rows[label] = res
    put_gain = (host_rows["drop+stall"].actor_idle_s
                - host_rows["none"].actor_idle_s)
    check(put_gain > 0.3 * stall_s,
          f"host: the {stall_s} s stall left the actor's waits "
          f"{put_gain:.3f} s longer")
    say("faults", f"(e) thread host plane, one actor on {n_envs} FrameEnvs, "
        f"depth 2, {host_iters} updates: a dropped release at update 2 and "
        f"a {stall_s} s learner stall at update {host_iters // 2} — the run "
        f"completes; learner queue.get_wait "
        f"{host_rows['none'].learner_idle_s:.3f} s -> "
        f"{host_rows['drop+stall'].learner_idle_s:.3f} s, the actor's "
        f"put_wait + lease {host_rows['none'].actor_idle_s:.3f} s -> "
        f"{host_rows['drop+stall'].actor_idle_s:.3f} s; timesteps/s "
        f"{host_rows['none'].timesteps_per_sec:.1f} -> "
        f"{host_rows['drop+stall'].timesteps_per_sec:.1f}")

    # (f) the checkpoint's cost and its round trip on the card
    sdir = os.path.join(ck_root, "cost")
    keep.pipeline = PipelineConfig(**{**keep.pipeline.__dict__,
                                      "checkpoint_dir": sdir})
    times = []
    for _ in range(saves):  # each overwrites the file of its update
        sync()
        t0 = time.perf_counter()
        p = keep._save_checkpoint(None, keep._iters_done)
        times.append(time.perf_counter() - t0)
    save_ms = 1e3 * sorted(times)[len(times) // 2]
    nbytes = os.path.getsize(p)
    raw = sum(t.numel() * t.element_size()
              for t in leaves((keep.params, keep.opt_state)))
    full = sum(t.numel() * t.element_size() for t in leaves(
        keep._checkpoint_template()) if isinstance(t, torch.Tensor))
    t0 = time.perf_counter()
    po = ckpt.save_checkpoint(sdir, 0, {"params": keep.params,
                                        "opt_state": keep.opt_state},
                              prefix="params")
    params_ms = 1e3 * (time.perf_counter() - t0)
    iter_ms = lock_rows[-1][3]
    share = save_ms / (100 * iter_ms + save_ms)
    _, env_state, obs = keep._live_slot_state[0]
    want = leaves((keep.params, keep.opt_state, env_state, obs))
    back = ckpt.restore_checkpoint(sdir, keep._iters_done,
                                   keep._checkpoint_template(), prefix="pipe")
    got = leaves((back["params"], back["opt_state"],
                  back["slots"]["0"]["env_state"], back["slots"]["0"]["obs"]))
    check(len(got) == len(want) and all(
        g.device == w.device and g.dtype == w.dtype and torch.equal(g, w)
        for g, w in zip(got, want)), "checkpoint round trip on the card")
    say("faults", f"(f) a pipeline checkpoint of paac_nature (params "
        f"{raw / 2 / 1e6:.2f} MB and RMSProp statistics, plus the slot's "
        f"env state and obs: {full / 1e6:.2f} MB of tensors) takes "
        f"{save_ms:.1f} ms a save (median of {saves}, "
        f"{', '.join(f'{1e3 * t:.1f}' for t in times)}) and "
        f"{nbytes / 1e6:.2f} MB on disk; params and optimizer state alone "
        f"{params_ms:.1f} ms, {os.path.getsize(po) / 1e6:.2f} MB; at "
        f"checkpoint_every = 100 beside (a)'s {iter_ms:.2f} ms a lockstep "
        f"iteration that is {100 * share:.2f}% of the learner's time; "
        f"restored on the card: {len(got)} tensors (params, RMSProp state, "
        f"the slot's env state and obs), each on its device and bitwise "
        f"({card})")
    del keep

    # (g) the trainer's fault-tolerance legs on TokenEnv
    cli = {k: 0 for k in ops.launches}
    cd = os.path.join(ck_root, "cli")
    base = ["--arch", "paac_vector", "--n-envs", str(n_envs), "--t-max",
            str(t_max), "--device", str(dev)]
    legs = (
        (["--pipeline", "--iterations", str(cli_iters), "--elastic",
          "--fault-kill", "0:3", "--checkpoint-dir", cd,
          "--checkpoint-every", str(max(cli_iters // 5, 1))],
         "vtrace_returns", cli_iters),
        (["--pipeline", "--iterations", str(cli_iters + cli_iters // 2),
          "--checkpoint-dir", cd, "--resume"], "vtrace_returns",
         cli_iters // 2),
        (["--iterations", str(cli_iters), "--checkpoint",
          os.path.join(ck_root, "sync")], "nstep_returns", cli_iters),
    )
    for argv, kernel, n in legs:
        ops.reset_launches()
        rl, res = train.run_rl(train.build_parser().parse_args(base + argv))
        counts = dict(ops.launches)
        want = {k: n if k == kernel else 0 for k in counts}
        check(counts == want, f"train {' '.join(argv)}: launches {counts}, "
              f"expected {want}")
        check(len(res) == 1 and all(math.isfinite(v) for v in
                                    res[0].mean_metrics.values()),
              f"train {' '.join(argv)}: {res}")
        for k, v in counts.items():
            cli[k] += v
        extra = ""
        if "--elastic" in argv:
            check(rl.supervisor.episodes == [("respawn", 0, 1)],
                  f"train --elastic: {rl.supervisor.episodes}")
            extra = f", episodes {rl.supervisor.episodes}"
        if "--resume" in argv:
            check(rl.total_steps == (cli_iters + cli_iters // 2) * n_envs
                  * t_max, f"train --resume: {rl.total_steps} steps")
        if "--checkpoint" in argv:
            check(ckpt.latest_step(argv[-1]) == rl.total_steps,
                  "train --checkpoint: no file at the run's steps")
        say("faults", f"(g) python -m repro_torch.launch.train "
            f"{' '.join(base[:-2] + argv)}: {res[0].steps} steps, K1 "
            f"{counts['nstep_returns']} K2 {counts['vtrace_returns']}, "
            f"{res[0].timesteps_per_sec:.1f} timesteps/s{extra}")
    shutil.rmtree(ck_root, ignore_errors=True)
    say("faults", f"the phase took {time.perf_counter() - t_phase:.1f} s")
    return ({k: v for k, v in path.items() if v},
            {k: v for k, v in cli.items() if v})


def sync_forms(torch, dev):
    """Each host-sync form beside whether torch's sync debug mode reports
    it: (label, thunk) pairs, each run once inside a guard."""
    x = torch.arange(8, dtype=torch.float32, device=dev)
    pageable = torch.ones(8)
    pinned = torch.ones(8).pin_memory()
    stream = torch.cuda.Stream(dev)
    event = torch.cuda.current_stream(dev).record_event()
    return (
        (".item()", lambda: x.sum().item()),
        (".cpu()", lambda: x.cpu()),
        (".tolist()", lambda: x.tolist()),
        ("float(t)", lambda: float(x[0])),
        ("torch.tensor(v, device=cuda)", lambda: torch.tensor(1.0,
                                                              device=dev)),
        ("pageable .to(cuda)", lambda: pageable.to(dev)),
        ("pageable .to(cuda, non_blocking)",
         lambda: pageable.to(dev, non_blocking=True)),
        ("pinned .to(cuda, non_blocking)",
         lambda: pinned.to(dev, non_blocking=True)),
        (".nonzero()", lambda: x.nonzero()),
        ("torch.cuda.synchronize()", lambda: torch.cuda.synchronize(dev)),
        ("Stream.synchronize()", stream.synchronize),
        ("Event.synchronize()", event.synchronize),
    )


# the forms the sanitizer's docstring says torch reports; the others of
# sync_forms pass (the linter's hot-path-sync rule flags the waits)
REPORTED = {".item()", ".cpu()", ".tolist()", "float(t)",
            "torch.tensor(v, device=cuda)", "pageable .to(cuda)",
            ".nonzero()", "Stream.synchronize()"}


def sync_probes(torch, san, dev):
    """Torch's sync debug mode is process-wide (set here, read on
    another thread), which of ``sync_forms`` it reports inside a guard,
    and a guarded thread refused while another thread's syncs pass at
    the same time."""
    import threading

    seen = {}

    def read_mode():
        seen["mode"] = torch.cuda.get_sync_debug_mode()

    th = threading.Thread(target=read_mode)
    th.start()
    th.join(timeout=30)
    check(seen.get("mode") == 1, f"another thread reads sync mode {seen}")
    reported = {}
    for label, fn in sync_forms(torch, dev):
        with san.guard():
            try:
                fn()
                reported[label] = False
            except san.HostSyncViolation:
                reported[label] = True
    check({k for k, v in reported.items() if v} == REPORTED,
          f"torch reports {reported}")
    say("analysis", "(e) sync debug mode 'warn' set on the main thread reads "
        f"{seen['mode']} on another thread (process-wide); inside a guard "
        "torch reports: " + ", ".join(k for k, v in reported.items() if v)
        + "; and lets pass: " + ", ".join(k for k, v in reported.items()
                                          if not v))
    san.reset_stats()
    x = torch.arange(8, dtype=torch.float32, device=dev)
    gate = threading.Barrier(2, timeout=30)
    out = {"refused": 0, "passed": 0}

    def guarded():
        with san.guard():
            gate.wait()
            for _ in range(20):
                try:
                    x.sum().item()
                except san.HostSyncViolation:
                    out["refused"] += 1
            gate.wait()

    def reader():
        gate.wait()
        for _ in range(20):
            x.cpu()
            out["passed"] += 1
        gate.wait()

    threads = [threading.Thread(target=f, name=n) for f, n in
               ((guarded, "guarded"), (reader, "reader"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        check(not t.is_alive(), "the two-thread probe hung")
    check(out == {"refused": 20, "passed": 20}
          and san.host_syncs["refused"] == 20
          and san.host_syncs["unguarded"] >= 20, f"two threads: {out} "
          f"{san.host_syncs}")
    say("analysis", f"(e) two threads at once: 20 .item() on the guarded "
        f"one all refused, 20 .cpu() on the other all passed; host syncs "
        f"{dict(san.host_syncs)}")



def phase_analysis(torch, np, configs, envs, A, optim, pipeline, paper_atari,
                   ops, tree, train, serve, analysis, san, lockcheck, card,
                   dev="cuda", n_envs=32, n_workers=8, warmup=10, iters=100,
                   lock_iters=20, proc_iters=60, replay_iters=50,
                   host_iters=20, cli_iters=8, serve_argv=None):
    """The analysis plane (``repro_torch.analysis``) in the paper's setting
    (paac_nature fp32 on FrameStack(AtariLike(32)), t_max 5): (a) both
    linters over the port; (b) four thread actors of 8 envs at depth 4
    (K2) under locks,transfers, timed beside the same run unsanitized in
    turns, and lockstep sanitized ≡ unsanitized bitwise at clips 1 (K2);
    (c) the same at clips inf (K1), and a process plane of four FrameEnv
    workers (K2), sanitized; (d) pipelined replay DQN (no kernel); the
    trainer's two sanitized legs at CI's shape; (e) the sanitizers catch
    what they exist for: which sync forms torch reports, a guarded thread
    refused while another passes, a stray ``.item()`` in the learner step
    raising on the learner while the host plane's actor reads back, and a
    lock inversion between two sites on two threads; (f) ``launch/serve.py
    --continuous --trace --metrics-jsonl`` on qwen2-7b at full width and
    depth (K3, K4), timed beside the same call without the observers in
    turns, tokens bitwise equal. Returns the launch counts of each leg."""
    import threading
    import warnings

    t_phase = time.perf_counter()
    PipelineConfig = configs.PipelineConfig
    inf = float("inf")
    cuda = torch.device(dev).type == "cuda"
    paths = {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def arm(modes):
        analysis.disable_sanitizers()
        if modes:
            analysis.enable_sanitizers(modes)
        lockcheck.monitor().reset()
        san.reset_stats()

    def clean_verdict(rl, label):
        rep = rl.telemetry.reports["lockcheck"]
        check(rep["cycles"] == [] and rep["hazards"] == [],
              f"{label}: lockcheck {rep['cycles']} {rep['hazards']}")
        return len(rep["edges"])

    def edges():
        return ", ".join(f"{k!r} entered {n} absorbing {s} syncs"
                         for k, (n, s) in sorted(san.edge_stats.items()))

    def launches(label, want):
        counts = dict(ops.launches)
        full = {k: want.get(k, 0) for k in counts}
        check(counts == full, f"analysis {label}: launches {counts}, "
              f"expected {full}")
        return {k: v for k, v in counts.items() if v}

    # (a) the two linters over the port, each as a file tool
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    for mod in ("repro_torch.analysis.lint", "repro.analysis.lint"):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", mod, "src/repro_torch"],
                           cwd=root, env=env, capture_output=True, text=True,
                           timeout=300)
        check(r.returncode == 0, f"python -m {mod} src/repro_torch exited "
              f"{r.returncode}: {r.stdout[-2000:]} {r.stderr[-2000:]}")
        say("analysis", f"(a) python -m {mod} src/repro_torch: exit 0, "
            f"{r.stderr.strip().splitlines()[-1]} "
            f"({time.perf_counter() - t0:.1f} s)")

    # (b) four thread actors of 8 envs at depth 4, sanitized and not
    def four():
        return paper_atari.build("paac_nature", n_envs, SEED, dev,
                                 PipelineConfig(num_actors=4, queue_depth=4))

    rows = {"": [], "locks,transfers": []}
    for modes in ("", "locks,transfers", "locks,transfers", ""):
        arm(modes)
        rl = four()
        rl.run(warmup)
        san.reset_stats()
        ops.reset_launches()
        sync()
        t0 = time.perf_counter()
        res = rl.run(iters)
        sync()
        wall = time.perf_counter() - t0
        got = launches("pipeline", {"vtrace_returns": iters})
        check(all(math.isfinite(res.mean_metrics[k]) for k in
                  ("loss", "entropy")), f"four actors: {res.mean_metrics}")
        check(len(rl.learned_ids) == iters == len(set(rl.learned_ids)),
              "four actors: a payload lost or learned twice")
        tps = iters * rl._steps_per_iter / wall
        if modes:
            paths["analysis pipeline"] = got
            g, p = san.stats["guarded"], san.stats["probed"]
            check(g >= (iters - 1) + (iters - 4),
                  f"four actors: {g} guarded scopes")
            check(p == 2 * iters, f"four actors: {p} probes")
            check(san.host_syncs["refused"] == 0, "four actors: refused")
            n_edges = clean_verdict(rl, "four actors")
            rows[modes].append((tps, g, p, n_edges, edges(),
                                dict(san.host_syncs)))
        else:
            rows[modes].append((tps,))
        del rl
    on, off = rows["locks,transfers"], rows[""]
    tps_on = [r[0] for r in on]
    tps_off = [r[0] for r in off]
    _, g, p, n_edges, e, hs = on[-1]
    say("analysis", f"(b) four thread actors of 8 envs, depth 4, clips 1: "
        f"{iters} updates after {warmup} warm-up in turns off, on, on, off: "
        f"timesteps/s off {tps_off[0]:.1f}, {tps_off[1]:.1f}; on "
        f"{tps_on[0]:.1f}, {tps_on[1]:.1f} (on/off "
        f"{sum(tps_on) / sum(tps_off):.3f}); K2 {iters} a run; sanitized: "
        f"{g} guarded scopes ({iters - 1} learner iterations and the "
        f"collects after each actor's first), {p} probes, lockcheck "
        f"{n_edges} lock-order edges, no cycle, no hazard; host syncs {hs}; "
        f"edges: {e} ({card})")

    # (b), (c) lockstep sanitized ≡ unsanitized, bitwise, at clips 1 (K2)
    # and inf (K1), cuDNN deterministic
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    lock_rows = []
    try:
        for clip, kernel in ((1.0, "vtrace_returns"), (inf, "nstep_returns")):
            pair = []
            for modes in ("", "locks,transfers"):
                arm(modes)
                rl = paper_atari.build(
                    "paac_nature", n_envs, SEED, dev,
                    PipelineConfig(queue_depth=1, lockstep=True,
                                   rho_bar=clip, c_bar=clip))
                ops.reset_launches()
                res = rl.run(lock_iters)
                got = launches(f"lockstep clips {clip}",
                               {kernel: lock_iters})
                pair.append((res, rl))
            (ra, a), (rb, b) = pair
            check_bitwise(torch, tree, ra, a, rb, b,
                          f"lockstep clips {clip}, sanitized vs not")
            check(san.stats["guarded"] == 2 * (lock_iters - 1)
                  and san.stats["probed"] == 2 * lock_iters,
                  f"lockstep clips {clip}: {san.stats}")
            clean_verdict(b, f"lockstep clips {clip}")
            if clip == inf:
                paths["analysis lockstep"] = got
            lock_rows.append((clip, kernel, dict(san.stats), edges()))
            del pair, a, b
    finally:
        torch.backends.cudnn.deterministic = False
    for clip, kernel, st, e in lock_rows:
        say("analysis", f"(b)/(c) depth-1 lockstep, one actor, clips {clip}, "
            f"{lock_iters} updates ({kernel} {lock_iters}): sanitized ≡ "
            f"unsanitized bitwise in every metric and parameter (cuDNN "
            f"deterministic); {st}; edges: {e}")

    # (c) a process plane of four FrameEnv workers, sanitized
    arm("locks,transfers")
    t0 = time.perf_counter()
    rl = pipeline.PipelinedRL(
        frame_spec(envs, np, n_envs, 0.0, n_workers, dev),
        _frame_agent(configs, A), optimizer="rmsprop",
        lr_schedule=optim.constant(0.0007 * n_envs), seed=SEED, device=dev,
        pipeline=PipelineConfig(num_actors=4, queue_depth=4,
                                actor_backend="process"))
    try:
        spawn_s = time.perf_counter() - t0
        shm_cond = rl._process_plane._slot._cond
        check(isinstance(shm_cond, lockcheck.SanitizedCondition)
              and shm_cond._name == "shm.param_slot",
              f"the shm slot's condition is {shm_cond!r}")
        rl.run(warmup)  # the workers' first steps
        san.reset_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = rl.run(proc_iters)
        wall = time.perf_counter() - t0
        paths["analysis process"] = launches("process",
                                             {"vtrace_returns": proc_iters})
        st, hs = dict(san.stats), dict(san.host_syncs)
        check(st["guarded"] == proc_iters - 1 and
              st["probed"] == 2 * proc_iters, f"process plane: {st}")
        check(san.edge_stats.get("shm param publish", [0])[0] == proc_iters,
              f"process plane edges {san.edge_stats}")
        n_edges = clean_verdict(rl, "process plane")
        say("analysis", f"(c) process plane, four FrameEnv workers of "
            f"{n_envs // 4} envs, depth 4, sanitized (built in {spawn_s:.1f} "
            f"s): {proc_iters} updates after {warmup} warm-up, K2 "
            f"{proc_iters}, "
            f"{proc_iters * rl._steps_per_iter / wall:.1f} timesteps/s; "
            f"{st}; host syncs {hs}; lockcheck {n_edges} edges (the shm "
            f"slot's mp condition wrapped as 'shm.param_slot'), no cycle, "
            f"no hazard; edges: {edges()} ({card})")
    finally:
        rl.close()
    del rl

    # (d) pipelined replay DQN, capacity 16, batch 2: no kernel
    arm("locks,transfers")
    env_ = envs.FrameStack(envs.AtariLike(n_envs, device=dev), 4)
    cfg = configs.get_config("paac_nature").replace(
        obs_shape=env_.obs_shape, num_actions=env_.num_actions)
    rl = pipeline.PipelinedRL(
        env_, A.DQNAgent(cfg, A.DQNConfig(t_max=5)), optimizer="rmsprop",
        lr_schedule=optim.constant(0.0007 * n_envs), seed=SEED, device=dev,
        pipeline=PipelineConfig(num_actors=2, queue_depth=2,
                                replay_plane=True, replay_capacity=16,
                                replay_batch=2))
    ops.reset_launches()
    t0 = time.perf_counter()
    res = rl.run(replay_iters)
    wall = time.perf_counter() - t0
    launches("replay", {})
    st = dict(san.stats)
    check(st["guarded"] >= (replay_iters - 1) + (replay_iters - 2)
          and st["probed"] == 2 * replay_iters, f"replay DQN: {st}")
    check(san.edge_stats["replay sample draw"][0] == replay_iters
          and san.host_syncs["refused"] == 0, f"replay DQN: {edges()}")
    check(math.isfinite(res.mean_metrics["loss"]), "replay DQN loss")
    n_edges = clean_verdict(rl, "replay DQN")
    say("analysis", f"(d) pipelined replay DQN, two actors, capacity 16, "
        f"batch 2, sanitized: {replay_iters} updates, no kernel launched, "
        f"{replay_iters * rl._steps_per_iter / wall:.1f} timesteps/s; {st}; "
        f"host syncs {dict(san.host_syncs)}; lockcheck {n_edges} edges, no "
        f"cycle, no hazard; edges: {edges()} ({card})")
    del rl, env_

    # the trainer's sanitized legs at CI's shape (TokenEnv, paac_vector)
    cli = {k: 0 for k in ops.launches}
    base = ["--arch", "paac_vector", "--iterations", str(cli_iters),
            "--pipeline", "--num-actors", "2", "--n-envs", "8", "--device",
            str(dev), "--sanitize", "locks,transfers"]
    for leg, kernel in (([], "vtrace_returns"),
                        (["--algo", "dqn", "--replay", "--replay-capacity",
                          "16", "--replay-batch", "2"], None)):
        arm("")
        ops.reset_launches()
        rl, (res,) = train.run_rl(train.build_parser().parse_args(base + leg))
        got = launches(f"train {' '.join(leg)}",
                       {kernel: cli_iters} if kernel else {})
        for k, v in got.items():
            cli[k] += v
        st = dict(san.stats)
        check(st["guarded"] >= 2 * (cli_iters - 2) and
              st["probed"] == 2 * cli_iters, f"train {leg}: {st}")
        check(san.host_syncs["refused"] == 0, f"train {leg}: refused")
        n_edges = clean_verdict(rl, f"train {leg}")
        say("analysis", f"python -m repro_torch.launch.train "
            f"{' '.join(base + leg)}: {res.steps} steps, launches {got}, "
            f"{st}, lockcheck {n_edges} edges and no finding, edges: "
            f"{edges()}")
        del rl
    paths["analysis train cli"] = {k: v for k, v in cli.items() if v}

    # (e) each sanitizer catches what it exists for (the probes of
    # torch's own syncs need the card; a CPU rehearsal skips them)
    arm("transfers")
    with san.guard():  # arms the process-wide mode on this thread
        pass
    if cuda:
        sync_probes(torch, san, dev)

    # the host plane: the learner guarded while its actor reads back; then
    # a stray .item() in the guarded learner step
    def host_rl():
        pool = frame_spec(envs, np, n_envs, 0.0, n_workers, dev)
        return pipeline.PipelinedRL(
            pool, _frame_agent(configs, A), optimizer="rmsprop",
            lr_schedule=optim.constant(0.0007 * n_envs), seed=SEED,
            device=dev, pipeline=PipelineConfig(queue_depth=2))

    arm("transfers")
    with host_rl() as rl:
        with san.guard():  # armed before the actor's first step
            pass
        ops.reset_launches()
        rl.run(host_iters)
        launches("host plane", {"vtrace_returns": host_iters})
        hs = dict(san.host_syncs)
        check(hs["refused"] == 0
              and hs["unguarded"] >= (5 * host_iters if cuda else 0)
              and san.stats["guarded"] == 1 + host_iters - 1,
              f"host plane: {hs} {san.stats}")
        say("analysis", f"(e) thread host plane on {n_envs} FrameEnvs, one "
            f"actor: "
            f"{host_iters} updates, the learner guarded from iteration 1 "
            f"while the actor's collect reads back each step: host syncs "
            f"{hs}")
        step, calls = rl._update_step, []

        def stray(*a):
            out = step(*a)
            calls.append(1)
            if len(calls) == 4:
                out[-1]["loss"].item()  # the deliberate stray sync
                if not cuda:  # a CPU rehearsal: the card's report of it
                    warnings.warn(san.SYNC_MESSAGE, UserWarning)
            return out

        rl._update_step = stray
        san.reset_stats()
        try:
            rl.run(host_iters)
            check(False, "the stray .item() was not caught")
        except san.HostSyncViolation as e:
            where = threading.current_thread().name
            check(repr(where) in str(e), f"violation not on the learner: {e}")
            msg = str(e)
        check(len(calls) == 4 and san.host_syncs["refused"] == 1
              and (san.host_syncs["unguarded"] > 0 or not cuda),
              f"stray sync: {len(calls)} updates, {san.host_syncs}")
        say("analysis", f"(e) a stray .item() in the 4th learner update "
            f"raised on the learner thread while the actor kept reading "
            f"back ({san.host_syncs}): {msg[:160]}")

    arm("locks")
    a = lockcheck.make_lock("supervisor.lock")
    b = lockcheck.make_condition("quota_ledger.cond")

    def nest(first, second):
        with first:
            with second:
                pass

    for order in ((a, b), (b, a)):
        t = threading.Thread(target=nest, args=order)
        t.start()
        t.join(timeout=30)
    rep = lockcheck.monitor().report()
    check([c for c in rep["cycles"]
           if set(c) == {"supervisor.lock", "quota_ledger.cond"}],
          f"the inversion was not flagged: {rep['cycles']}")
    say("analysis", f"(e) supervisor.lock -> quota_ledger.cond on one "
        f"thread and the reverse on another: cycle {rep['cycles'][0]}")
    arm("")

    # (f) the serving CLI with and without its observers, qwen2-7b
    torch.cuda.empty_cache()
    base = serve_argv or ["--arch", "qwen2-7b", "--continuous", "--requests",
                          "8", "--slots", "4", "--prompt-len", "512",
                          "--gen", "32", "--device", str(dev)]
    obs_dir = tempfile.mkdtemp(prefix="serve_obs_")
    serve_cfg = configs.get_config(base[base.index("--arch") + 1])
    if "--reduced" in base:
        serve_cfg = serve_cfg.reduced()
    n_layers = serve_cfg.num_layers
    warm = list(base)
    warm[warm.index("--requests") + 1] = "2"
    serve.main(warm)
    runs = {"off": [], "on": []}
    for k, label in enumerate(("off", "on", "on", "off")):
        argv = list(base)
        if label == "on":
            tr = os.path.join(obs_dir, f"trace{k}.json")
            hb = os.path.join(obs_dir, f"beat{k}.jsonl")
            argv += ["--trace", tr, "--metrics-jsonl", hb]
        ops.reset_launches()
        res = serve.main(argv)
        counts = launches(f"serve {label}", {
            "flash_attention": n_layers * res["admitted"],
            "decode_attention": n_layers * res["steps"]})
        reqs = sorted(res["requests"], key=lambda r: r.rid)
        check(len(reqs) == 8 and all(r.status == "done" for r in reqs),
              f"serve {label}: {[(r.rid, r.status) for r in reqs]}")
        runs[label].append((res, counts, [r.tokens for r in reqs]))
        if label == "on":
            events = json.load(open(tr))["traceEvents"]
            names = {e["name"] for e in events if e.get("ph") == "X"}
            check({"admit", "prefill", "decode"} <= names,
                  f"serve trace spans {names}")
            lines = [json.loads(x) for x in open(hb)]
            served = [x for x in lines if "serve_queue_depth" in x]
            check(len(served) >= 2, f"{len(served)} heartbeat lines carry "
                  "serve_queue_depth")
            paths["analysis serving"] = counts
            spans = sum(1 for e in events if e.get("ph") == "X")
        del res
        torch.cuda.empty_cache()
    ref_tokens = runs["off"][0][2]
    for label in ("off", "on"):
        for _, _, toks in runs[label]:
            check(all(np.array_equal(x, y) for x, y in zip(toks, ref_tokens)),
                  f"serve {label}: tokens differ from the first plain run")
    shutil.rmtree(obs_dir, ignore_errors=True)

    def fmt(r):
        return (f"{r['tok_s']:.1f} tok/s, p50 {r['p50_ms']:.1f} ms, p99 "
                f"{r['p99_ms']:.1f} ms")

    say("analysis", f"(f) python -m repro_torch.launch.serve "
        f"{' '.join(base)} [--trace T --metrics-jsonl M], in turns off, on, "
        f"on, off: off {fmt(runs['off'][0][0])}; on {fmt(runs['on'][0][0])}; "
        f"on {fmt(runs['on'][1][0])}; off {fmt(runs['off'][1][0])}; tokens "
        f"bitwise equal across the four; launches of the first observed "
        f"call {paths['analysis serving']} (K3 a layer a prefill, K4 a "
        f"layer a decode step); "
        f"the trace holds {spans} spans (admit, prefill, decode), the "
        f"heartbeat {len(lines)} lines, {len(served)} with serve_queue_depth "
        f"({card})")
    say("analysis", f"the phase took {time.perf_counter() - t_phase:.1f} s")
    return paths


def _frame_agent(configs, A):
    """paac_nature on 84x84x4 frames, 6 actions: the FrameEnv pools'."""
    cfg = configs.get_config("paac_nature").replace(
        obs_shape=FrameEnv.SHAPE, num_actions=6)
    return A.PAACAgent(cfg, A.PAACConfig(gamma=0.99, entropy_beta=0.01,
                                         t_max=5))


# Each kernel's CUDA kernels as a profile names them. K4 and K5 share the
# combine (split_combine_kernel); no serving cell runs both. decode_kernel,
# decode_combine_kernel, mla_decode_kernel and ssd_scan_kernel (bf16) are
# the earlier designs' kernels, so a profile of those designs reads the
# same way.
PROFILE_NAMES = {
    "flash_attention": ("flash_fwd_kernel", "flash_fwd_bf16_kernel"),
    "decode_attention": ("decode_split_kernel", "split_combine_kernel",
                         "decode_combine_kernel", "decode_kernel"),
    "mla_decode_attention": ("mla_split_bf16_kernel", "mla_split_kernel",
                             "split_combine_kernel", "mla_decode_kernel"),
    "ssd_scan": ("ssd_chunk_kernel", "ssd_state_kernel", "ssd_out_kernel",
                 "ssd_scan_kernel"),
}


def kernel_time(by_name, kernel: str):
    """(ms, launches) of ``kernel``'s CUDA kernels in a ``device_window``
    table (demangled names: ``ns::name<...>(...)`` or ``ns::name(...)``)."""
    import re

    pat = re.compile(r"(?<![\w])(" + "|".join(PROFILE_NAMES[kernel])
                     + r")[<(]")
    hits = [row for name, row in by_name.items() if pat.search(name)]
    return sum(r[0] for r in hits), sum(r[1] for r in hits)


KERNELS = {
    "nstep_returns": ("src/repro_torch/csrc/nstep_returns.cu",
                      "src/repro/kernels/nstep_returns.py:54"),
    "vtrace_returns": ("src/repro_torch/csrc/vtrace.cu",
                       "src/repro/kernels/vtrace.py:92"),
    # the bf16 source: the serving paths run K3 in bf16 (the fp32 path,
    # csrc/flash_attention.cu, serves the card-vs-CPU parity checks)
    "flash_attention": ("src/repro_torch/csrc/flash_attention_bf16.cu",
                        "src/repro/kernels/flash_attention.py:113"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:103"),
    # K5 and K6 too: the bf16 sources, which the serving paths run
    "mla_decode_attention": ("src/repro_torch/csrc/mla_decode_bf16.cu",
                             "src/repro/kernels/mla_decode.py:113"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan_bf16.cu",
                 "src/repro/kernels/ssd_scan.py:86"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="smoke run of the port on one "
                                 "CUDA card")
    ap.add_argument("--trace-dir", default="",
                    help="also write the pipeline runs' Chrome traces here")
    ap.add_argument("--train-cell", default="",
                    help="(internal) run one TRAIN_CELLS entry, given as "
                    "arch,layers,B,T,steps, and print its JSON line")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    if args.train_cell:
        from repro_torch import configs
        from repro_torch.kernels import ops
        from repro_torch.launch import train

        torch.backends.cuda.matmul.allow_tf32 = False
        if sys.stdin.readline().strip() != "go":  # the parent is gone
            return 1
        arch, *dims = args.train_cell.split(",")
        print(json.dumps(train_cell(torch, configs, ops, train,
                                    (arch, *map(int, dims)))))
        return 0
    import numpy as np
    import torch.nn.functional as F

    from repro_torch import (analysis, checkpoint, configs, core, envs,
                             models, optim, pipeline, serving)
    from repro_torch.analysis import lockcheck, sanitize
    from repro_torch.core import agents
    from repro_torch.core.agents import paac, replay
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_decode as mk
    from repro_torch.kernels import nstep_returns as nr
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.kernels import vtrace as vt
    from repro_torch.launch import paper_atari, serve, train
    from repro_torch.utils import tree

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    laps = []  # (phase, seconds since the previous lap)

    def lap(name):
        done = sum(t for _, t in laps)
        laps.append((name, time.perf_counter() - t0 - done))

    first_cell = start_train_cell(TRAIN_CELLS[0])  # it waits to run
    card = phase_card(torch, _build)
    lap("card")
    # first on the card: the full-width training cells need all but a few
    # GB of its memory, which later phases leave fragmented
    by_path = {}
    by_path["token training"] = phase_token_training(
        torch, np, configs, models, ops, paac, optim, train, tree, card,
        first_cell)
    lap("token training")
    rows = {"nstep_returns": phase_returns(torch, ref, nr),
            "vtrace_returns": phase_vtrace(torch, ref, vt)}
    lap("returns, vtrace")
    rows.update(phase_kernels(torch, np, F, ref, fa, da))
    phase_latent_kernels(torch, np, F, ref, fa, mk, sk, rows)
    phase_window_kernels(torch, np, F, ref, da, mk, rows)
    phase_flash_grad(torch, np, F, ref, ops, rows)
    phase_ssd_grad(torch, ref, ops, rows)
    lap("kernels")
    phase_rl_model(torch, configs, models, envs, paac, optim, tree)
    # launches of each kernel on each main path, every path driven with the
    # counts set to 0 just before it and read just after
    by_path["training"], trained = phase_training(torch, paper_atari, ops,
                                                  tree, card)
    lap("rl_model, training")
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    by_path["pipeline"] = {"vtrace_returns": phase_pipeline(
        torch, paper_atari, configs, ops, tree, card,
        trace_dir=args.trace_dir or None)}
    lap("pipeline")
    mesh_k2, mesh_cli_k2 = phase_mesh(torch, paper_atari, configs, ops,
                                      tree, train, card)
    by_path["mesh"] = {"vtrace_returns": mesh_k2}
    by_path["mesh train cli"] = {"vtrace_returns": mesh_cli_k2}
    lap("mesh")
    by_path["agents"], by_path["train cli"] = phase_agents(
        torch, configs, models, envs, agents, replay, core, optim, tree, ops,
        train, card, trained)
    del trained
    lap("agents")
    (by_path["host sync"], by_path["host pipeline"],
     by_path["host train cli"], host_rows, delay) = phase_host(
        torch, np, configs, core, envs, agents, optim, pipeline, paper_atari,
        ops, tree, train, card)
    lap("host")
    by_path["host process"], by_path["host process train cli"] = \
        phase_host_process(torch, np, configs, envs, agents, optim, pipeline,
                           ops, tree, train, card, host_rows, delay)
    lap("host process")
    torch.cuda.empty_cache()
    by_path["replay"], by_path["replay train cli"] = phase_replay(
        torch, configs, core, envs, agents, optim, pipeline, ops, tree, train,
        card)
    lap("replay")
    torch.cuda.empty_cache()
    by_path["faults"], by_path["faults train cli"] = phase_faults(
        torch, np, configs, envs, agents, optim, pipeline, paper_atari, ops,
        tree, train, checkpoint, card)
    lap("faults")
    torch.cuda.empty_cache()
    by_path.update(phase_analysis(
        torch, np, configs, envs, agents, optim, pipeline, paper_atari, ops,
        tree, train, serve, analysis, sanitize, lockcheck, card))
    lap("analysis")
    torch.cuda.empty_cache()
    phase_model(torch, np, configs, models, ops, paac, optim, tree)
    lap("model")
    by_path.update(phase_token_cli(torch, ops, train,
                                   Path(__file__).resolve().parent))
    lap("token cli")
    for cell in SERVING_CELLS:
        by_path.update(phase_serving(
            torch, np, configs, models, ops, serve, serving, tree, card, cell,
            analysis, sanitize))
        lap(f"serving {cell['arch']}")
    for cell in PREFIX_CELLS:
        by_path[f"{cell['arch']} prefixed"] = phase_prefixed(
            torch, np, configs, models, ops, tree, card, cell)
        lap(f"prefixed {cell['arch']}")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        row = rows[name]
        paths = {path: c[name] for path, c in by_path.items() if c.get(name)}
        check(paths, f"{name} was launched on no main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **{k: row[k] for k in ("shape", "host_us", "launch_floor_ms",
                                   "lse_ms", "lse_max_abs_err", "backward",
                                   "other") if k in row}})
        if "backward" in row:  # K3's, K6's plain backward: calls by path
            row["backward"]["calls_by_path"] = {
                path: c[f"{name} backward"] for path, c in by_path.items()
                if c.get(f"{name} backward")}
            row["backward"]["calls"] = sum(
                row["backward"]["calls_by_path"].values())
            check(row["backward"]["calls"] > 0,
                  f"{name}'s backward ran on no training path")
    say("done", "seconds a phase: " + ", ".join(f"{n} {t:.1f}"
                                                  for n, t in laps))
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
