#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

Run from the root of a checkout:  python3 chip_smoke.py

Phases; any failure exits non-zero before the result line is printed:
  1. setup — torch, CUDA and nvcc versions, the card's name and power
     limit, and the build of every kernel from the sources in this
     checkout (one nvcc per source, all started together); per kernel
     of kernels 4 and 6 its registers and spill, and their SASS must
     hold HGMMA (wgmma) and UTMALDG (TMA loads);
  2. kernels — kernel 4 against its plain PyTorch version on the card,
     at the serving and training paths' shapes, over a grid of edge
     cases, at the zoo's head dims with their heads (hubert 80, phi-3-
     vision 96, danube 120, gemma2 256 with softcap 50, MLA 192 against
     a v head dim of 128) at 200 and 4096 tokens, and on rows that keep
     no key (lk_valid), with the tolerance stated per dtype (f32 cases
     against the plain version evaluated in f64); bf16 at head dims that
     are multiples of 8 must take the tensor cores; then timed at the
     serving and training shapes beside its plain version and one
     PyTorch library call (a yardstick the port never calls); then the
     paged decode-attention kernel (kernel 8, csrc/paged_decode.cu)
     against its plain version at the zoo's decode heads (the chat
     cells' internlm2-20b and phi-3-vision, qwen2, gemma2, danube), with
     softcap, window and the replicated-KV map, pages of 8 and 16, f32
     and bf16, on the edge rows (position 0, a page's first and last
     row, max_seq - 1, the null page) and rows of thousands of positions,
     one row alone against the same row in a batch of 64 and two runs,
     bit for bit; timed at the chat cells' decode steps, with one
     step's decode_rows as the engine's layers share them, beside its
     byte bound and its plain version, and again with the host queued
     ahead (device time alone), with the wrapper's host time a call;
  3. serve — qwen2-0.5b at full width (24 layers, vocab 151936) with
     seeded random weights: 8 requests of 100 prompt tokens (bucket 128),
     32 new tokens each, 4 slots, page size 16, max_seq 256 (the run
     `repro_torch/configs/qwen2_0_5b.py` names).  Every
     launch count is set to 0 just before this run and read just after;
     the run must have gone through every kernel of the path: kernel 4
     once a layer a prefill, kernel 8 once a layer a decode step (a
     count every later serving path is held to as well).  Then two
     requests served alone must give the batched run's tokens bit for
     bit, and one request's prefill logits through the kernel must match
     those through the plain version;
  4. runtime kernels — put_copy, dma_copy (kernels 1-2, csrc/put_copy.cu)
     and reduce_combine (kernel 3) against their plain versions, bit for
     bit, over the CPU tests' shapes, ragged edges (1 row, 1 column, odd
     byte widths, unaligned rows), f32/i32/bf16/f64 and 64 MiB buffers;
     the combine over both of its paths (16-byte vectors with a scalar
     tail; scalar for a base or row stride off 16 bytes): contiguous,
     ragged columns, the ring's strided blocks, a base one element off, an
     odd row stride, x f32/bf16/f16/i32/i8/f64/i64 x sum/prod/max/min
     (NaN in the floats) x k 2, 3, 4, 17, 33; then timed at the
     runtime's real size beside the plain version and one PyTorch call
     (the combine in alternating pairs with torch.add);
  5. runtime — the OpenSHMEM SIM runtime on 16 PEs of the paper's 4x4
     mesh (sim_ctx, plain and with NoC waves): the paper's message-size
     sweep (8 B .. 16 KB per PE) of put, get, put_nbi + quiet, fence,
     barrier_all, broadcast, fcollect, collect, to_all (rd, ring; i32 and
     f32), reduce_scatter + allgather_unpad and alltoall, each checked on
     the host against numpy; then the trainer's 64 MiB-per-PE gradient
     bucket (1 GiB PE-stacked) through to_all rd and ring and
     reduce_scatter + allgather_unpad.  Every launch count is set to 0
     just before this phase and read just after; each must equal the
     count the runtime's own schedules imply.  Then the wall time of a
     few single calls at 8 B and 16 KB per PE;
  6. train — (a) the combine + AdamW kernel (kernel 5) bit for bit
     against its plain version over k, lengths, offsets, masks, output
     dtypes and extreme gradients, then timed at the 16-PE bucket and at
     the full-width step; (b) fused_rs_adam on 16 PEs at the 64 MiB-per-PE
     bucket, bit for bit against reduce_scatter + allgather_unpad + the
     plain AdamW; (c) qwen2-0.5b trained at full width, N steps through
     the launcher (default sync) and N through the fused sync, losses
     finite and falling, launch counts equal to their formulas; (d) one
     gradient tree through apply_updates and through fused_adam_sync, bit
     for bit; (e) the loss and gradients through the flash kernel against
     those through the plain attention, in f32 and bf16;
  7. serve mamba2-2.7b — (a) the SSD scan kernel (kernel 7,
     csrc/ssd_scan.cu) through ops.ssd against the plain chunked version
     over tests/test_kernels.py's shapes, h0, ragged L, and the model's
     head shape (H 80, P 64, N 128, chunk 128) contiguous and strided,
     f32 and bf16, each of its three phases (the cumsums, the chunk
     states, the entering and final states, y) against its plain form on
     the kernel's own inputs to it, and the sequential-scan oracle
     against the chunked version; (b) kernel 7 timed at the prefill's
     shape beside its plain version, its three CUDA kernels by the
     profiler; (c) build_prefill on mamba2-2.7b at full width (64 layers,
     d 2560, vocab 50280, seeded random weights, bf16 compute) over one
     32768-token prompt: exactly 64 kernel-7 launches (counts set to 0
     just before, read just after) and finite logits; the same prefill
     through the plain version with kernel 7 held to it in each layer on
     that layer's inputs; the prefill in f32 compute through both, logits
     within 1e-2 of the largest;
     (d) `launch.serve --arch mamba2-2.7b` through main(): the dense-cache
     decode loop at batch 4, prompt 32, 16 tokens, (4, 16) tokens, and
     the loop's logits at the last prompt position against
     build_prefill's on the same prompts;
  8. ring attention — (a) the ring-partials kernel (kernel 6,
     csrc/ring_attention.cu) against its plain version over D 16-256, f32
     and bf16, causal or not, window, softcap, GQA groups 1 and 7, ragged
     Lq/Lk, -1 key slots, wholly and partly masked blocks, rows that keep
     their first key after masked tiles, padded shards, 1, 4 and 16
     PEs (m, l within 1e-5 x sqrt(D/16), acc within 2e-5 x max(1,
     l |v|max), finalize within 2e-5 x sqrt(D/16), wholly masked rows at
     m = -1e30 and the plain l exactly); (b) kernel 6 timed at the ring
     step's shape (16 PEs, Hq 14, Hkv 2, 2048 x 2048, D 64, bf16) on a
     diagonal, a wholly kept and a wholly masked block, each beside its
     plain version, SDPA with the block mask and its own bound; (c) qwen2-0.5b's
     layer-0 q, k, v over a 32768-token prompt, sharded over 16 PEs of
     the 4x4 mesh, through fusion.ring_attention on the plain and the NoC
     SIM: exactly 16 kernel-6 launches and the puts the code implies
     (counts set to 0 just before, read just after), the output within
     max(2e-5, 1 bf16 step) of kernel 4 over the gathered sequence and of
     the ring through the plain partials, then with a window of 4096 and
     a softcap of 50; the ring and mono walls, the peak memory, kernel 4
     at the gathered shape beside scaled_dot_product_attention (a
     yardstick), and choose_attention's pick at the measured per-block
     time;
  9. serve zamba2-1.2b (the hybrid family: 38 Mamba2 layers at d 2048
     and one shared attention + MLP block after every 6 of them, 7
     applications) — (a) kernel 7 at its head shape (H 64, P 64, N 64,
     chunk 128) contiguous and strided, f32 and bf16, each phase against
     its plain form as in 7a, and kernel 4 at B 1, Hq = Hkv = 32, D 64,
     bf16, causal over 4096 tokens against the plain version and against
     the blockwise plain version 9c uses; (b) kernel 7 and kernel 4 timed
     at the 32768-token prefill's shapes, kernel 4 beside the blockwise
     plain version and scaled_dot_product_attention; (c) build_prefill
     over one 32768-token prompt at full width: exactly 38 kernel-7 and 7
     kernel-4 launches (counts set to 0 just before, read just after),
     finite logits, wall, tok/s, peak; the same prefill through the plain
     versions with kernel 7 held to them in every layer and kernel 4 on
     every query row of its 7 calls (the plain attention built 1024 rows
     at a time from ref.ring_partials_ref); the prefill in f32 compute
     through both, logits within 1e-2 of the largest; (d) `launch.serve
     --arch zamba2-1.2b` through main(): (4, 16) tokens, the loop's logits
     at the last prompt position against build_prefill's, and in f32
     compute the same decode within 1e-2 of the prefill's; (e) one
     build_decode_step against caches of 32768 slots at batch 4 filled
     from a seeded generator, at position 32767: finite logits, each
     shared cache changed only at slot 32767, the wall of a step and the
     peak memory;
 10. serve the rest of the dense family at full width (every earlier
     phase's models and engines freed first; the memory still allocated
     is printed) — (a) kernel 4 at each kind of call of the three
     prefills (gemma2-9b's local and global layers: Hq 16 over Hkv 8, D
     256, softcap 50, the local ones windowed at 4096; h2o-danube-3-4b:
     Hq 32 over 8, D 120, window 4096; internlm2-20b: Hq 48 over 8, D
     128), bf16 and f32 over 4096 tokens (windows cut to 1024 so that
     they bite) against the plain version and against the blockwise
     plain version, then timed over 32768 tokens beside that version, its
     bound and scaled_dot_product_attention (causal without the softcap;
     windowed through an additive mask over all L^2 pairs); (b)
     build_prefill of gemma2-9b (42 layers, d 3584, vocab 256000, f32
     weights) over one 32768-token prompt: exactly 42 kernel-4 launches,
     21 with window 4096 (counts set to 0 just before, read just after),
     finite logits, wall, tok/s, peak; the same prefill with kernel 4
     held to the blockwise plain version on every query row of 12 of its
     42 calls (calls i with i % 8 < 2, both its window kinds:
     PREFILL_HELD), each checked as it happens; the f32 prefill over its
     first 8192 tokens through both, logits within 1e-2 of the largest;
     `launch.serve --arch gemma2-9b` through main(): (4, 16) tokens from
     the paged engine sized max(--cache-len, prompt + tokens), and one
     request's prefill logits through the kernel against the plain
     version (phase 3's rule); (c) one gemma2 build_decode_step against
     caches of 32768 slots at batch 2 (21 global caches, 21 local rings
     of 4096) filled from seeded generators at position 32767: finite
     logits, each global cache changed only at slot 32767 and each ring
     only at 4095, checked against each cache regenerated from its seed
     one at a time, the wall of a step and the peak; (d) the same
     prefill and launcher for h2o-danube-3-4b (24 launches, 6 held)
     and internlm2-20b (bf16 weights; 48 launches, 12 held);
 11. serve the moe family at full width (phase 10's models freed first)
     — (a) kernel 4 at granite-moe-3b-a800m's calls (Hq 24 over Hkv 8, D
     64) and deepseek-v3's MLA (Hq = Hkv = 128, D 192 against a v head
     dim of 128, scale 1/sqrt(192)), bf16 and f32 over 4096 tokens
     against the plain and the blockwise plain versions, then timed over
     32768 tokens beside that version, its bound and scaled_dot_product_
     attention (for MLA the first fused backend that takes Dv apart from
     D, named); (b) build_prefill of granite (32 layers of GQA attention
     and 40 routed experts, top-8, f32 weights) over one 32768-token
     prompt: exactly 32 kernel-4 launches (counts set to 0 just before,
     read just after), finite logits, walls, tok/s, peak; the same
     prefill with a quarter of its calls held to the blockwise plain
     version (PREFILL_HELD); the f32 prefill over its first 8192 tokens
     through kernel 4 and through
     that version with each layer's routes (top-k experts, kept flags)
     recorded: where every layer's routes agree, logits within 1e-2 of
     the largest, else each layer's differing picks printed, the layer
     outputs before the first differing layer within 1e-2 of their
     largest and that layer's differing picks under 0.1%; `launch.serve
     --arch granite-moe-3b-a800m` through main(): the dense-cache decode
     loop to (4, 16) tokens; (c) the same for deepseek-v3 cut to
     SERVE_RUN's 4 layers (3 dense MLA layers, 1 MoE layer of 256
     routed experts and a shared one; bf16 weights; exactly 4
     launches), its decode loop through launch.serve's `_decode_loop`,
     and one decode step against 32768-slot MLA caches at batch 4 that
     must change every layer's c_kv and k_rope at slot 32767 in every row
     and nothing else;
 12. serve hubert-xlarge, the encoder, at full width (phase 11's models
     freed first) — (a) kernel 4 at its calls (Hq = Hkv = 16, D 80,
     non-causal: no tile is skipped) bf16 and f32 over 4096 tokens
     against the plain and the blockwise plain versions; (b) timed over
     32768 tokens beside that version, its bound and scaled_dot_product_
     attention without a mask; (c) build_prefill (48 layers, d 1280, f32
     weights) over SERVE_RUN's frames (1, 32768, 1280) from input_specs:
     exactly 48 non-causal kernel-4 launches (counts set to 0 just
     before, read just after), finite logits, walls, frames/s, peak;
     12 of its calls held to the blockwise plain version; forward
     in f32 compute over the first 8192 frames through kernel 4 and that
     version: the hidden state at every position and the logits within
     1e-2 of their largest; (d) `launch.serve --arch hubert-xlarge`
     raises the reference's SystemExit with no launch and no memory;
 13. serve phi-3-vision-4.2b at full width — (a), (b) kernel 4 at its
     calls (Hq = Hkv = 32, D 96, causal) as 12a-b, SDPA causal; (c)
     build_prefill (32 layers, d 3072, f32 weights) over a 32768-token
     prompt with frontend embeds (1, 576, 3072) from input_specs: exactly
     32 launches, 8 held; the f32 gate over 8192 tokens with the
     embeds (logits within 1e-2), whose logits without the embeds must
     differ by more than that; (d) `launch.serve --arch phi-3-vision-
     4.2b` through the paged engine at the reference's defaults, one
     request's prefill logits against the plain version; (e) one decode
     step against 32768-slot dense caches at batch 2 (32 layers of k
     and v, 24 GiB) that must change slot 32767 of every row of every
     cache leaf and nothing else;
 14. the measurement services on the card — (a) a level-2 Profiler on
     sim_ctx(16) over the 4x4 mesh: phase 5's collectives at 8 B per PE
     and the bucket's (to_all rd, ring, reduce_scatter) at 1 GiB, one
     sample per call whose fields equal those of the same call on the
     CPU SIM, kernels 1-3's launches equal with no profiler, pcontrol(0)
     and pcontrol(2), and at 1 GiB each sample's wall_s within 20% of a
     host-clock wall ended by a device wait; (b) Tuner.tune over the
     train launcher's autotune grid (allreduce and fcollect x 4 KiB,
     64 KiB, 1 MiB x chunks 1, 4; iters 3, warmup 1): points and
     variants as `_variants` gives them, launches (warmup + iters) x each
     variant's per-call count plus refit_link's, each best the argmin of
     its means, the tuned allreduce within 1e-4 of the untuned, and the
     fitted alpha_s, bw_Bps and contention printed as the card's; (c)
     choose_attention at phase 8's ring shape: untuned, the cost model's
     pick; with phase 8's measured walls in a TuningDB, the faster one;
     (d) qwen2-0.5b's engine on phase 3's traffic with a LEVEL_FULL
     Tracer and ServeMetrics: phase 3's tokens, valid documents, exactly
     8 submitted, 8 completed, 256 tokens, 0 pages live, TTFT and
     per-token p50 beside an untraced run's and phase 3's; (e)
     `launch.serve --arch
     qwen2-0.5b --trace-out --metrics-out` writes valid documents;
 15. the elastic runtime on the card — (a) the fault injector on
     sim_ctx(16) under SIM and NoC-SIM against one 1 GiB stacked f32
     put: a dead PE raises PEFailure with no launch; a dropped link the
     YX route avoids reroutes, bit for bit with the unfaulted put; a
     severed adjacent link with heal_after 1 and 2 lands on attempt 2
     and 3 bit for bit (retries 1 and 2), and with no heal raises
     LinkFailure after 4 attempts; a 0.05 s straggler's quiet deadline
     raises with the queue kept, and quiet() waits it; (b) the PGAS
     checkpoint stream of the fused sync's state at the bucket (p 1 GiB,
     m and v 64 MiB each): exactly 45 put_copy launches a begin, the
     drained checkpoint restored bit for bit into CUDA templates, begin
     (async issue) under 10% of a synchronous save's wall; (c) 9 fused
     steps (phase 6b's fused_rs_adam + allgather_unpad) with PE 5 killed
     at step 5, inline checkpoints every 2 steps and a LEVEL_FULL
     Tracer: PEFailure, drain, recover to step 4 with a live ring of 15
     and a re-keyed fingerprint, resumed p, m, v after step 8 equal to
     the uninterrupted run's bit for bit, the chaos summary naming
     fault.pe_failure and fault.recovered; (d) qwen2-0.5b's engine on
     phase 3's traffic with PE 1 lost at the third step's decode: the
     drain requeues the live rids in slot order, frees every page, and
     run() regenerates phase 3's tokens exactly with 24 more kernel-4
     launches per re-prefill.
 16. the SPMD backend — 4 and 8 rank processes of core.spmd.run on this
     one card (their kernels time-sliced), every PE's receive slots in
     one symmetric heap mapped by CUDA IPC, gloo for host barriers
     only; each ppermute round a dma_copy store into the peer's slot, a
     stream sync, a barrier and a dma_copy read: (a) test_spmd_equiv's
     collectives through spmd_ctx (broadcast from 3 and 5, fcollect,
     collect, alltoall bit for bit; to_all sum, max and ring at rtol
     1e-5) against sim_ctx(n) on the card, and on a 2x2 mesh Comm's
     allreduce, allgather and reduce_scatter over model and data
     against their plain sums and concatenations; the ranks' launches
     and the wall of one allreduce of a 64 MiB bucket over 4 ranks; (b)
     qwen2-0.5b at full width on a 2x2 (data x model) mesh of 4 ranks:
     the port's 1x1 launcher's first step, then 2 steps at seq 512,
     batch 8 through the launcher's rank loop (default sync) and 2 with
     the fused sync from the same global parameters and batches; every
     loss finite and equal on all ranks, the 2x2 first-step loss within
     the reference's bound (0.05 x max(1, |l1|)) of the 1x1 one,
     kernel-4 launches per rank 2 x 24 layers x 4 microbatches x steps,
     kernel 5 once per bucket per fused step; step walls, peak memory
     per rank and launches per step;
 17. expert parallelism and the Mamba2 and MLA layers at tp > 1 — (a)
     Comm.alltoall over model of 1x4, (data, model) of 2x2 and model of
     1x8, output and gradient bit for bit sim_ctx(n)'s, 4n kernel-2
     launches a rank; kernels 4 and 7 at the per-rank shapes of (b)-(d)
     against their plain versions, and timed; (b) granite-moe-3b-a800m at
     full width on 1x4 (EP 4, 10 of 40 experts a rank): one MoE layer in
     f32 at a no-drop capacity against the 1x1 layer (output and input
     gradient within 1e-5 of the largest, picks exactly), then the
     launcher's loop, 1 step at seq 512, batch 8, its step-0 loss
     within the reference's bound of the 1x1 loss of the same tree, the
     ranks' launches and heap rounds equal to formulas from the code;
     (c) zamba2-1.2b at full width on 2x2 as 16b (1 step), its loss
     within its bound of the 1x1 launcher's, fused step 0 == default,
     exact kernel-7, -4 and -5 launches; (d) deepseek-v3 cut to 4
     layers forward at full width on 2x2 under its own config (EP over
     (data, model), 64 of 256 experts a rank, MLA at 64 heads, fsdp: its
     2-D block weights' rows halved over data, gathered in each block):
     its layer gate as (b), each rank's loss within the reference's
     bound of the 1x1 loss, launches and heap rounds equal to formulas
     (fsdp's gathers included), its peak a rank;
 18. serving at tp > 1 — kernel 4 at the per-rank paged prefill shapes
     (Lq 128, Lk 256, D 64: 7 q heads over 1 kv head at tp 2, 4 over 4
     expanded kv heads at tp 4) against its plain version, timed beside
     it and SDPA; (a) qwen2-0.5b's paged engine on 1x2 and 1x4 rank
     meshes with phase 3's prompts (8 of its 32 new tokens each) on
     phase 3's seed-0 tree, fitted to the mesh and cut by each rank:
     every rank's results equal rank 0's, two requests alone equal the
     batch bit for bit, each request's first-token logits within
     PREFILL_LOGITS_RTOL of the 1x1 engine's, tokens equal phase 3's
     first 8 except after a near tie of phase 3's top two logits, per
     rank kernel 4 24 layers x 8 prefills and (2L + 3) log2(tp) heap
     rounds a prefill or decode step (kernel 2 twice a
     round, kernel 3 once); TTFT p50, per-token p50 and tok/s beside
     phase 3's; (b) one dense-cache decode step after a prompt of 4 x 8
     (teacher-forced) for zamba2-1.2b on 1x2, deepseek-v3's 4-layer cut
     on 1x2 and granite-moe-3b-a800m on 1x4, f32 compute at a no-drop
     capacity: the step's logits within PREFILL_LOGITS_RTOL of the same
     mesh's prefill over the prompt and the pick, the step's and the
     prefill's within it of the 1x1 side's on the same global tree
     (zamba2's 1x1 side norms each shard's channels, as the mesh does),
     picks equal; kernel 4 and 7 launches equal their formulas.
 19. sequence sharding over one spawn of 4 rank processes on a (4, 1)
     mesh (data 4) — kernel 6 at the per-rank shapes (B 1, Hq 14, Hkv 2,
     D 64: 8192 x 8192 bf16, 2048 x 2048 bf16 and f32) against its plain
     version, timed beside it, its bound and SDPA with the block mask;
     (a) fusion.ring_attention on the data axis's spmd_ctx over phase
     8's prompt (qwen2-0.5b's layer-0 q, k, v of 32768 tokens, 8192 a
     rank): each rank's rows within max(2e-5, 1 bf16 step) of kernel 4
     over the gathered sequence, per rank 4 kernel-6 launches, 9 heap
     rounds and 18 dma_copy, the ring's wall beside the mono wall; the
     gradient of the ring layer (attention="ring", 512 of 2048 tokens a
     rank, f32) against the mono layer's at rtol 1e-4 / atol 1e-5 x
     max|g|, every leaf; (b) qwen2-0.5b's 24 layers with
     attention="ring" over 8192 tokens (2048 a rank, global positions)
     in f32 (sampled rows' logits within 1e-3 x max|logit| of the 1x1
     mono forward) and in bf16 (finite, every row's argmax the 1x1's
     but at near ties), per rank 96 kernel-6 launches and 216 heap
     rounds a forward; (c) zamba2-1.2b's decode through
     build.make_serve_steps at long_500k (seq_shards 4, 131072 of the
     524288 slots a rank in each of its 7 shared caches, every cache
     seeded chunk by chunk so the 1x1 cache is the shards' rows), 4
     teacher-forced steps where the last shard writes and 4 in shard 1's
     range, in bf16 (picks equal to the 1x1 decode's but at near ties)
     and in f32 at 65536 slots (logits within 1e-3 x max|logit|), 42
     heap rounds a step a rank (7 layers x 3 allreduces x 2 stages);
     step walls, the rounds' host time and each rank's peak.
 20. fsdp, checkpoints and the engine's drain on a rank mesh — (a)
     qwen2-0.5b with fsdp=True on 2x2 at 16b's shape, 1 default-sync
     step: every rank's losses equal, within 1e-5 of 16b's 1x1 loss at
     step 0, heap rounds and kernel 2-4 launches a step a
     rank equal to `fsdp_step_formula` (each layer's gathers, again
     under remat, and their backward deliveries), its step wall and peak
     a rank beside 16b's; (b) the train launcher with fsdp on 2x2 killed
     at step 2's batch fetch after its step-1 checkpoint landed: the
     resumed losses equal to an uninterrupted run resumed from the same
     checkpoint (rtol 1e-5, atol 1e-6), the checkpoint's bytes, and the
     same checkpoint resumed on 1x2 (the elastic shrink) with a finite
     loss; (c) qwen2's paged engine on 1x2 with phase 3's prompts
     (18a's 8 tokens), PE 1 lost at the third decode on both ranks: both drain alike (the live
     rids requeued in slot order at the queue head, no page live), then
     every request's tokens equal 18a's 1x2 tokens bit for bit, through
     18a's kernel-4 launches plus 24 a re-prefill.
 21. the pod axis and pipeline parallelism, in 16b's ranks after phase
     20's work — (a) the train launcher's loop at --pod 2 --data 1
     --model 2 (a (2, 1, 2) rank mesh) at 16b's shape, 2 steps from 16b's
     shards: every rank's losses equal 16b's default-sync losses bit for
     bit, kernel 2-4 launches and heap rounds a step a rank equal 16b's;
     (b) qwen2-0.5b's 24 layers as a GPipe of 2 stages of 12 over `pod`
     at tp 2 (`parallel/pipeline.py`), batch 4 x 512 in 2 microbatches,
     forward and backward from the same seed-0 tree cut by stage, and
     the unpipelined loss and gradient on 2x2: the pipelined loss within
     1e-4 x max(1, |ref|) of the unpipelined one, every rank's gradient
     finite with sum |g| > 0, each stage's layer leaves within rtol 1e-4
     / atol 1e-5 of the 2x2 gradients of those layers summed over
     `data`, launches and heap rounds a rank equal to
     `pipe_step_formula` and `unpipe_formula`; both walls and peaks.
 22. the library-collective backend, `Comm(backend="xla")` over gloo,
     beside the paper's runtime, in ranks that earlier phases spawned —
     (a) in 16b's ranks: allreduce at 8 B and 64 MiB a PE, allgather,
     alltoall and broadcast on 4 ranks, grad_sync on 2x2, under both
     backends: the xla output equal to the shmem output (movement bit
     for bit, sums within rtol 1e-4 / atol 1e-5) with no heap round and
     no kernel 1-3 launch, and both backends' walls; (b) qwen2-0.5b by
     the train launcher at --data 2 --model 2 --comm xla, 2 steps at
     16b's shape from 16b's tree: every rank's losses equal, step 0
     within 1e-5 of 16b's 1x1 loss, step 1 within 1e-4 of 16b's
     default-sync step 1, no heap round, no kernel 1-3 launch, kernel 4
     16b's launches a step; step wall, host time in the gloo calls and
     peak a rank beside 16b's; (c) in 17b's ranks granite-moe's MoE
     layer gate under xla: picks equal to the shmem gate's, output and
     input gradient within its 1e-5 x the largest; (d) in 18's 2-rank
     spawn the serve launcher's path at --model 2 --comm xla on phase
     3's prompts: the dense-cache loop (not the paged engine), tokens
     equal to the 1x1 loop's but after a near tie of the 1x1 logits.
 23. the dry run against the card (`launch/dryrun.py`; no rank spawned,
     no step added) — before 16b spawns, the parent traces qwen2-0.5b's
     train step on rank 0 of a 2x2 meta rank (`core.spmd.meta_rank`,
     `dryrun.trace_step`: every kernel on its meta path) at 16b's shape
     under shmem and at 22b's under xla; then every rank of 16b's default
     run and of 22b must have taken exactly the trace's heap rounds,
     kernel 2-5 launches and library calls a step, and its parameters
     plus optimizer state, as `torch.cuda.memory_allocated` reads them,
     the trace's argument bytes less the batch within the allocator's
     512-byte rounding a tensor; the trace's peak is printed beside each
     run's `torch.cuda.max_memory_allocated`.

The run fails if a process it started (a rank, nvcc, nvidia-smi, the
resource tracker that spawning the ranks launches) is still alive or
unreaped before the result is printed.

The last lines are one JSON object per kernel run ({"kernels": [...]}:
the eight kernels, then one flash_attention row per prefill shape of
phases 10-13 and per-rank shape of phases 17 and 18, kernel 8 at
phi-3-vision's chat decode step (with the launches of phi-3-vision's
heads in phase 13's launcher), and one ring_attention row per
per-rank shape of phase 19, with a "shape" key),
the card's name and power limit as nvidia-smi gives them, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
KERNELS = ["flash_attention", "put_copy", "reduce_combine",
           "fused_update", "ssd_scan", "ring_attention", "paged_decode"]

# published peaks of one H100 SXM (dense): bytes over 3.35 TB/s, products
# over the tensor-core rate of their type (bf16) or the f32 CUDA-core rate
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.float32": 3e-5, "torch.bfloat16": 3e-2}
# prefill logits through the kernel vs through the plain version, relative
# to the largest logit: 8 bf16 ulps (2^-8 relative spacing each)
PREFILL_LOGITS_RTOL = 8 * 2.0 ** -8
# q and k at 2.5x unit scale (v at unit scale) give logits of std ~6: the
# softmax is peaked, softcap moves the output by several tolerances (each
# softcap case checks that it does), and |out| is far above the tolerance
QK_SCALE = 2.5


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def live_children() -> list[str]:
    """This process's child processes that are still alive or not yet
    reaped (pid, state and command line of each, from /proc)."""
    me, found = os.getpid(), []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
            cmd = (stat.parent / "cmdline").read_bytes()
        except (OSError, IndexError):
            continue                      # it ended while we looked
        if int(fields[1]) == me:
            found.append(f"{stat.parent.name} {fields[0]} "
                         f"{cmd.replace(bytes(1), b' ').decode()[:120]}")
    return found


def kernel_label(mangled: str) -> str:
    """A short name for a kernel's mangled symbol in nvcc's report: the
    function's name and its template arguments (dtype, int parameters)."""
    m = re.search(r"(flash_fwd_tc|flash_fwd_cc|ring_partials_tc|"
                  r"ring_partials_cc|ring_prep|[a-z_]*(?:kernel|partials|fwd))"
                  r"(?=[IE])(I(?:13__nv_bfloat16|f|Li\d+E)+E)?", mangled)
    if not m:
        return mangled[-48:]
    args = [{"f": "f32"}.get(a.group(0), a.group(1) or "bf16")
            for a in re.finditer(r"13__nv_bfloat16|Li(\d+)E|f",
                                 m.group(2) or "")]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


# the opcodes that show kernels 4 and 6 on Hopper's tensor cores (HGMMA:
# wgmma) fed by TMA (UTMALDG), and HMMA (mma.sync) for contrast
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")


def sass_counts(path: Path) -> dict | None:
    """{opcode: count} in a library's SASS by cuobjdump, or None when the
    toolkit has no cuobjdump or it shows no SASS for the library."""
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc_path()).with_name("cuobjdump"))
    if not Path(tool).is_file():
        return None
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300).stdout
    if "Function :" not in sass:
        return None
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}


def report_builds(libs: dict) -> None:
    """Per library, nvcc's resource report (`-Xptxas -v`, kept beside it):
    kernels, registers, spill, and which kernels spill; per kernel of the
    SSD scan, its registers; per kernel of kernels 4 and 6, registers and
    spill, and their SASS's tensor-core and TMA opcodes (a kernel 4 or 6
    without HGMMA fails the run)."""
    for name, path in libs.items():
        report = path.with_suffix(".log").read_text()
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", report)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", report))
        log(f"    {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
            f"registers, {spills} bytes of spill (nvcc -Xptxas -v)")
        entries = re.findall(r"Compiling entry function '([^']+)'.*?(\d+)"
                             r" bytes spill stores", report, re.S)
        spilling = [e for e, sp in entries if int(sp)]
        if spilling:
            log(f"      {len(spilling)} of them spill: "
                + ", ".join(kernel_label(e) for e in spilling[:6]))
        if name in ("flash_attention", "ring_attention"):
            log("      " + ", ".join(
                f"{kernel_label(e)} {r} regs" + (f" {sp} B spill"
                                                 if int(sp) else "")
                for e, sp, r in re.findall(
                    r"Compiling entry function '([^']+)'.*?(\d+) bytes "
                    r"spill stores.*?Used (\d+) registers", report, re.S)))
            ops = sass_counts(path)
            log(f"      SASS: {ops if ops else 'not readable (no cuobjdump)'}")
            if ops is not None and not (ops["HGMMA"] and ops["UTMALDG"]):
                raise AssertionError(f"{name}: no HGMMA or UTMALDG in its "
                                     f"SASS ({ops})")
        if name == "ssd_scan":
            dtypes = {"If": " f32", "I13__nv_bfloat16": " bf16"}
            log("      registers: " + ", ".join(
                f"{k}{dtypes.get(t, '')} {r}" for k, t, r in re.findall(
                    r"Compiling entry function '[^']*?(chunk_state|"
                    r"state_pass|chunk_output)_kernel(If|I13__nv_bfloat16)?"
                    r"[^']*'.*?Used (\d+) registers", report, re.S)))


def time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean device time of `fn` over back-to-back calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: flash attention against its plain version
# ---------------------------------------------------------------------------

ATTN_CASES = [dict(causal=True), dict(causal=False),
              dict(causal=True, window=17), dict(causal=True, softcap=30.0),
              dict(causal=True, window=33, softcap=50.0)]


def attention_inputs(torch, gen, b, hq, hkv, lq, lk, d, dt, dv=None):
    def rnd(scale, *shape):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dt)
    return (rnd(QK_SCALE, b, hq, lq, d), rnd(QK_SCALE, b, hkv, lk, d),
            rnd(1.0, b, hkv, lk, dv or d))


# fault C1: the zoo's full-width head dims with their heads
# (src/repro/configs/): (label, Hkv, group, D, Dv, kwargs).  Their windows
# are 4096 wide; a window is cut to 33 at the short length and to 1024 at
# 4096 tokens, so that it bites at both.
C1_MODELS = [
    ("hubert", 16, 1, 80, 80, dict(causal=False)),
    ("phi3v", 32, 1, 96, 96, dict(causal=True)),
    ("danube", 8, 4, 120, 120, dict(causal=True, window=4096)),
    ("gemma2", 8, 2, 256, 256, dict(causal=True, window=4096, softcap=50.0)),
    ("mla", 128, 1, 192, 128, dict(causal=True)),
]


def attention_cases():
    """(label, B, Hkv, group, Lq, Lk, D, dtype name, kwargs, Dv)."""
    cases = [("slice", 1, 2, 7, 128, 256, 64, "bfloat16", dict(causal=True)),
             ("slice_ragged", 1, 2, 7, 100, 100, 64, "bfloat16",
              dict(causal=True)),
             ("slice_noncausal", 1, 2, 7, 128, 256, 64, "bfloat16",
              dict(causal=False)),
             ("slice_f32", 1, 2, 7, 128, 256, 64, "float32",
              dict(causal=True)),
             # the training step's shape (one microbatch of TRAIN_RUN)
             ("train", 2, 2, 7, 128, 128, 64, "bfloat16", dict(causal=True)),
             ("train_f32", 2, 2, 7, 128, 128, 64, "float32",
              dict(causal=True))]
    for kw in ATTN_CASES:
        for lq, lk, group in [(64, 64, 2), (100, 100, 1), (32, 96, 4)]:
            if kw.get("causal") and lq != lk:
                continue          # causal assumes aligned positions
            for dtype in ("float32", "bfloat16"):
                cases.append((f"grid{lq}x{lk}g{group}", 2, 2, group, lq, lk,
                              32, dtype, kw))
    for d in (16, 128):
        for dtype in ("float32", "bfloat16"):
            cases.append((f"hd{d}", 1, 2, 2, 96, 160, d, dtype,
                          dict(causal=True, window=40)))
    cases = [c + (c[6],) for c in cases]
    for label, hkv, group, d, dv, kw in C1_MODELS:
        for length, window in ((200, 33), (4096, 1024)):
            opts = dict(kw, window=window) if "window" in kw else kw
            for dtype in ("float32", "bfloat16"):
                cases.append((f"{label}{length}", 1, hkv, group, length,
                              length, d, dtype, opts, dv))
    return cases


def mask_counts(lq: int, lk: int, causal: bool, window) -> tuple[int, int]:
    """(query-key pairs, keys) the mask keeps: the products the function
    needs, and the K/V rows some query reads (those past every row's
    causal edge or before every row's window are never needed)."""
    pairs, lo_min, hi_max = 0, lk, -1
    for i in range(lq):
        lo = max(0, i - window + 1) if window is not None else 0
        hi = min(i, lk - 1) if causal else lk - 1
        if hi >= lo:
            pairs += hi - lo + 1
            lo_min, hi_max = min(lo_min, lo), max(hi_max, hi)
    return pairs, max(0, hi_max - lo_min + 1)


def ulp(torch, x):
    """The spacing of x's dtype at each element's magnitude, in f32."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.full_like(x, torch.finfo(x.dtype).eps,
                                       dtype=torch.float32), e - 1)


def plain_attention(torch, ref, q, k, v, exact=True, **kw):
    """The plain version on these inputs, a few KV heads at a time (its
    logits at 128 heads x 4096^2 would not fit at once).  For f32 inputs
    (unless exact=False) it runs in f64 and is rounded to f32 at the end:
    its own f32 evaluation errs by 3.0e-5 to 3.4e-5 at D 192 and 256 over
    4096 tokens (cuBLAS's f32 GEMM over D terms: check_attention prints
    it), at and above the 3e-5 tolerance, while kernel 4 stays within
    ~1e-5 of the f64 value.  So an f32 case holds the kernel to the
    function's exact value; the limit is unchanged."""
    hkv = k.shape[1]
    group = q.shape[1] // hkv
    step = max(1, 16 // group)
    up = (lambda x: x.double()) if exact and q.dtype == torch.float32 \
        else (lambda x: x)
    parts = [ref.attention_ref(up(q[:, h * group:(h + step) * group]),
                               up(k[:, h:h + step]), up(v[:, h:h + step]),
                               **kw)
             for h in range(0, hkv, step)]
    return torch.cat(parts, dim=1).to(q.dtype)


def attention_over(torch, out, want, dt) -> tuple[float, float]:
    """(max|err|, worst err/limit) of an output against its plain version:
    an output rounded to its dtype cannot be held closer than one step of
    that dtype at its own magnitude, so the limit of an element is the
    larger of the dtype's tolerance and that step (for bf16 they differ
    only where |want| >= 4, where the step is 2^-5 = 0.03125)."""
    diff = (out.float() - want.float()).abs()
    limit = torch.maximum(torch.full_like(diff, TOL[str(dt)]),
                          ulp(torch, want))
    return diff.max().item(), (diff / limit).max().item()


def check_attention(torch, ops, ref, fa, gen) -> dict:
    worst = {}
    for label, b, hkv, group, lq, lk, d, dtype, kw, dv in attention_cases():
        dt = getattr(torch, dtype)
        q, k, v = attention_inputs(torch, gen, b, hkv * group, hkv, lq, lk,
                                   d, dt, dv)
        out = ops.attention(q, k, v, **kw)
        want = plain_attention(torch, ref, q, k, v, **kw)
        torch.cuda.synchronize()
        if out.shape != want.shape or out.dtype != want.dtype:
            raise AssertionError(f"{label}: {out.shape}/{out.dtype} vs "
                                 f"{want.shape}/{want.dtype}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{label} {kw}: non-finite output")
        err, over = attention_over(torch, out, want, dt)
        tol = TOL[str(dt)]
        typical = want.float().abs().mean().item()
        route = "tensor cores" if fa.tensor_core_route(q, k, v) \
            else "CUDA cores"
        oracle = ""
        if dtype == "float32":
            plain32 = plain_attention(torch, ref, q, k, v, exact=False, **kw)
            oracle = (f"; the plain version's own f32 max|err| "
                      f"{(plain32 - want).abs().max().item():.3e}")
            del plain32
        log(f"  attention {label:16s} {dtype:8s} B{b} Hq{hkv * group} "
            f"Hkv{hkv} Lq{lq} Lk{lk} D{d} Dv{dv} {kw} ({route}): max|err| "
            f"{err:.3e} (tol {tol:g} or 1 ulp, worst err/limit {over:.3f}, "
            f"mean|out| {typical:.3f}{oracle})")
        if dtype == "bfloat16" and d % 8 == 0 and dv % 8 == 0 \
                and route != "tensor cores":
            raise AssertionError(f"{label}: bf16 at D{d}/Dv{dv} did not "
                                 f"take the tensor cores")
        if not over <= 1.0:
            raise AssertionError(f"{label} {dtype} {kw}: max|err| {err}, "
                                 f"err/limit {over} > 1")
        if not typical > 10 * tol:
            raise AssertionError(f"{label} {dtype}: mean|out| {typical} is "
                                 f"not far above the tolerance {tol}")
        if "softcap" in kw:
            blind = plain_attention(torch, ref, q, k, v,
                                    **{**kw, "softcap": None})
            gap = (blind.float() - want.float()).abs().max().item()
            if not gap > 2 * tol:
                raise AssertionError(f"{label} {dtype} {kw}: dropping the "
                                     f"softcap moves the output by {gap}, "
                                     f"not more than twice the tolerance")
        worst[label + dtype] = err
    return worst


def check_attention_edges(torch, fa, ref, gen) -> None:
    """Kernel 4's wrapper with lk_valid against the plain version: rows
    that keep no key (non-causal with lk_valid 0; a window above a short
    lk_valid), lk_valid below one key tile, and a window that skips the
    leading key tiles of later query tiles, at the C1 head dims, f32 and
    bf16.  The limits are check_attention's; a row that keeps nothing is
    the mean of v over the Lk slots, so these outputs are small and no
    mean|out| floor applies."""
    cases = [("none_noncausal", 80, 80, 128, 128, 0, dict(causal=False)),
             ("none_window", 120, 120, 128, 256, 3,
              dict(causal=True, window=8)),
             ("below_tile", 256, 256, 128, 256, 40, dict(causal=False)),
             ("window_skips", 96, 96, 512, 512, 512,
              dict(causal=True, window=100)),
             ("mla_window", 192, 128, 256, 256, 200,
              dict(causal=True, window=70, softcap=50.0))]
    dead_rows = 0
    for label, d, dv, lq, lk, lk_valid, kw in cases:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q, k, v = attention_inputs(torch, gen, 1, 4, 2, lq, lk, d, dt,
                                       dv)
            out = fa.flash_attention(q, k, v, lk_valid=lk_valid, **kw)
            want = plain_attention(torch, ref, q, k, v, lk_valid=lk_valid,
                                   **kw)
            torch.cuda.synchronize()
            err, over = attention_over(torch, out, want, dt)
            qp = torch.arange(lq, device="cuda")[:, None]
            kp = torch.arange(lk, device="cuda")[None, :]
            keep = (kp < lk_valid).expand(lq, lk)
            if kw.get("causal"):
                keep = keep & (kp <= qp)
            if kw.get("window"):
                keep = keep & (kp > qp - kw["window"])
            dead = int((~keep.any(1)).sum())
            dead_rows += dead
            log(f"  attention edge {label:14s} {dtype:8s} Lq{lq} Lk{lk} "
                f"lk_valid {lk_valid} D{d} Dv{dv} {kw}: rows keeping no key "
                f"{dead} of {lq}; max|err| {err:.3e}, worst err/limit "
                f"{over:.3f}")
            if not (over <= 1.0 and torch.isfinite(out).all()):
                raise AssertionError(f"attention edge {label} {dtype}: "
                                     f"err/limit {over}")
    if not dead_rows:
        raise AssertionError("attention edges: no row kept nothing")


ATTN_TIMED = {"serving": (1, 14, 2, 128, 256, 64),   # the qwen2 prefill
              "training": (2, 14, 2, 128, 128, 64)}  # a TRAIN_RUN microbatch


def time_attention(torch, fa, ref, gen, card) -> dict:
    """Times at the serving prefill's and the training step's shapes
    (ATTN_TIMED): the kernel alone (its C entry called back to back), the
    wrapper, the plain version, and scaled_dot_product_attention as the
    library yardstick.  Returns the serving shape's, with the training
    shape's under "training"."""
    import torch.nn.functional as F
    got = {}
    for shape, (b, hq, hkv, lq, lk, d) in ATTN_TIMED.items():
        got[shape] = time_attention_at(torch, F, fa, ref, gen, card, b, hq,
                                       hkv, lq, lk, d)
    return dict(got["serving"], training=got["training"])


def time_attention_at(torch, F, fa, ref, gen, card, b, hq, hkv, lq, lk,
                      d) -> dict:
    dt = torch.bfloat16
    q, k, v = attention_inputs(torch, gen, b, hq, hkv, lq, lk, d, dt)
    scale = 1.0 / math.sqrt(d)
    out = fa.flash_attention(q, k, v, causal=True, sm_scale=scale)
    want = ref.attention_ref(q, k, v, causal=True, sm_scale=scale)
    err = (out.float() - want.float()).abs().max().item()

    lib = fa._library()
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b,
            hq, hkv, lq, lk, d, d, lk, 1, 0, 0.0, scale, stream)
    kernel_ms = time_ms(lambda: lib.repro_flash_attention_fwd(*args))
    wrapper_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True,
                                                    sm_scale=scale))
    plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, causal=True,
                                                 sm_scale=scale))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, scale=scale, enable_gqa=True)
    sdpa_err = (sdpa().float() - want.float()).abs().max().item()
    library_ms = time_ms(sdpa)

    # q read and out written once; of k and v only the rows the causal
    # mask keeps (keys 0..Lq-1 of Lk): the rest is never needed
    pairs, keys = mask_counts(lq, lk, True, None)
    nbytes = (q.numel() + out.numel() + 2 * b * hkv * keys * d) \
        * q.element_size()
    ops_count = 4 * d * pairs * b * hq
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / PEAK_OPS_PER_S[str(dt)] * 1e3
    log(f"  times at B{b} Hq{hq} Hkv{hkv} Lq{lq} Lk{lk} D{d} bf16 causal "
        f"({card}): kernel {kernel_ms:.5f} ms, wrapper {wrapper_ms:.5f} ms, "
        f"plain {plain_ms:.5f} ms, sdpa {library_ms:.5f} ms (sdpa max|err| "
        f"vs plain {sdpa_err:.3e}); bound {max(t_bytes, t_ops):.6f} ms "
        f"({nbytes} B, {ops_count} products-ops, {keys} of {lk} keys); "
        f"kernel / sdpa {kernel_ms / library_ms:.3f}")
    return dict(max_abs_err=err, ms=kernel_ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2b: the paged decode-attention kernel against its plain version
# ---------------------------------------------------------------------------

# The kernel sums in another order than the plain version (each split of a
# row's pages, then the splits combined; the plain version's einsums over
# all max_seq positions): within PAGED_RTOL of the largest |value| plus
# PAGED_ATOL, in f32 and over bf16 K/V alike (both widen the same bf16
# values exactly)
PAGED_RTOL, PAGED_ATOL = 1e-4, 1e-5
# (label, group, hd, page_size): the chat cells' decode heads (internlm2-20b,
# phi-3-vision-4.2b), qwen2-0.5b's, gemma2's and danube's
PAGED_HEADS = [("internlm2", 6, 128, 8), ("phi3v", 1, 96, 8),
               ("qwen2", 7, 64, 16), ("gemma2", 2, 256, 16),
               ("danube", 4, 120, 8)]
PAGED_VARIANTS = [dict(), dict(softcap=50.0), dict(window=13),
                  dict(q2slot=True),
                  dict(softcap=50.0, window=13, q2slot=True)]
# the chat cells' decode step (ptbench/traffic/chat.json): 64 slots, pages
# of 8, max_seq 1792; (B, Hq, Hkv, hd), contexts spread evenly over
# 64..906 positions, the mean of ~485 that the cells' traced steps read
PAGED_TIMED = {"internlm2-20b.chat": (64, 48, 8, 128),
               "phi-3-vision-4.2b.chat": (64, 32, 32, 96)}
PAGED_MAX_PAGES = 224


def paged_inputs(torch, gen, hq, hkv, hd, ps, max_pages, positions, dt,
                 q2slot=False):
    """q, pools, page table and positions of a decode step: each row owns
    the pages up to its position, drawn from a shuffled pool; one more
    row on the null page only (table all 0, position 0).  Under q2slot
    the q heads read the stored heads in a random map."""
    b = len(positions) + 1
    num_pages = 1 + len(positions) * max_pages

    def rnd(scale, *shape):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dt)
    pool_k, pool_v = (rnd(1.0, num_pages, ps, hkv, hd) for _ in range(2))
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    table = torch.zeros((b, max_pages), dtype=torch.long, device="cuda")
    for r, pos in enumerate(positions):
        n = pos // ps + 1
        table[r, :n] = perm[r * max_pages:r * max_pages + n]
    slots = torch.randint(0, hkv, (hq,), generator=gen, device="cuda") \
        if q2slot else None
    pos_t = torch.tensor(list(positions) + [0], device="cuda")
    return dict(q=rnd(2.0, b, hq, hd), pool_k=pool_k, pool_v=pool_v,
                page_table=table, positions=pos_t, q2slot=slots)


def paged_over(torch, got, want) -> tuple[float, float]:
    """(max|err|, err over its limit) of the kernel against the plain
    version."""
    err = (got - want).abs().max().item()
    return err, err / (PAGED_RTOL * want.abs().max().item() + PAGED_ATOL)


def check_paged_decode(torch, kpd, ref, gen) -> None:
    """The kernel against its plain version at the zoo's decode heads, with
    and without softcap, window and the replicated-KV map, pages of 8 and
    16, f32 and bf16, on rows at position 0, a page's first and last row,
    max_seq - 1 and the null page; rows of thousands of positions (many
    splits); one row alone and in a batch of 64 bit for bit, and two runs
    bit for bit."""
    for label, group, hd, ps in PAGED_HEADS:
        for dtype in ("float32", "bfloat16"):
            worst = 0.0
            for variant in PAGED_VARIANTS:
                q2slot = variant.get("q2slot", False)
                hkv = 3 if q2slot else 2
                hq = group + 1 if q2slot else group * hkv
                last = 8 * ps - 1
                c = paged_inputs(torch, gen, hq, hkv, hd, ps, 8,
                                 [0, 2 * ps, 3 * ps - 1, last, 5, last - 9],
                                 getattr(torch, dtype), q2slot)
                kw = dict(page_size=ps, window=variant.get("window"),
                          softcap=variant.get("softcap"))
                got = kpd.paged_decode_attention(**c, **kw)
                want = ref.paged_decode_ref(**c, **kw)
                torch.cuda.synchronize()
                err, over = paged_over(torch, got, want)
                if not over <= 1.0:
                    raise AssertionError(f"paged decode {label} {dtype} "
                                         f"{variant}: max|err| {err}, "
                                         f"err/limit {over}")
                worst = max(worst, over)
            log(f"  paged decode {label:9s} {dtype:8s} group {group} hd {hd} "
                f"pages of {ps}, {len(PAGED_VARIANTS)} variants: worst "
                f"err/limit {worst:.3f}")
    c = paged_inputs(torch, gen, 48, 8, 128, 8, 512,
                     [4095, 2048, 1000, 257, 255, 256], torch.bfloat16)
    got = kpd.paged_decode_attention(**c, page_size=8)
    err, over = paged_over(torch, got,
                           ref.paged_decode_ref(**c, page_size=8))
    if not over <= 1.0:
        raise AssertionError(f"paged decode long rows: err/limit {over}")
    g = torch.Generator().manual_seed(5)
    rows = torch.randint(0, 8 * PAGED_MAX_PAGES, (63,), generator=g)
    c = paged_inputs(torch, gen, 48, 8, 128, 8, PAGED_MAX_PAGES,
                     rows.tolist(), torch.bfloat16)
    batched = kpd.paged_decode_attention(**c, page_size=8)
    if not torch.equal(batched, kpd.paged_decode_attention(**c,
                                                           page_size=8)):
        raise AssertionError("paged decode: two runs differ")
    for r in (0, 17, 62, 63):
        one = {k: v[r:r + 1] for k, v in c.items() if k not in
               ("pool_k", "pool_v", "q2slot")}
        alone = kpd.paged_decode_attention(
            pool_k=c["pool_k"], pool_v=c["pool_v"], **one, page_size=8)
        if not torch.equal(alone[0], batched[r]):
            raise AssertionError(f"paged decode: row {r} alone differs "
                                 f"from the same row in a batch of 64")
    log(f"  paged decode: rows of up to 4096 positions err/limit "
        f"{over:.3f}; rows alone == in a batch of 64 and run == run, bit "
        f"for bit")


def device_ms(torch, fn, iters: int = 200, warmup: int = 10,
              sleep_cycles: int = 2 * 10**8) -> float:
    """Mean device time of `fn` over back-to-back calls queued while the
    card sleeps (~0.1 s of cycles): the host's time a call is hidden
    where it is longer than the call's device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_paged_decode(torch, kpd, ref, gen, card) -> dict:
    """The kernel (its wrapper, back to back, with one step's
    `decode_rows` as the engine's layers share them) and the plain
    version at the chat cells' decode steps (PAGED_TIMED), bf16, beside
    the bound: the K and V rows of the live positions read once, q read
    and the f32 output written once; 4 hd operations a position and q
    head at the f32 rate.  Beside it the kernel's device time with the
    host queued ahead (`device_ms`) and the wrapper's host time a call.
    Returns the internlm2 shape's numbers, the phi-3-vision shape's
    under "phi3v"."""
    got = {}
    for cell, (b, hq, hkv, hd) in PAGED_TIMED.items():
        positions = [round(64 + i * (906 - 64) / (b - 2))
                     for i in range(b - 1)]
        c = paged_inputs(torch, gen, hq, hkv, hd, 8, PAGED_MAX_PAGES,
                         positions, torch.bfloat16)
        rows = kpd.decode_rows(c["page_table"], c["positions"], page_size=8)
        run = lambda: kpd.paged_decode_attention(  # noqa: E731
            **c, page_size=8, rows=rows)
        plain = lambda: ref.paged_decode_ref(**c, page_size=8)  # noqa: E731
        err, over = paged_over(torch, run(), plain())
        kernel_ms = time_ms(run)
        dev_ms = device_ms(torch, run)
        torch.cuda.synchronize()
        torch.cuda._sleep(2 * 10**8)          # the host alone is timed
        t0 = time.perf_counter()
        for _ in range(200):
            run()
        host_ms = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        plain_ms = time_ms(plain, iters=20, warmup=2)
        live = sum(p + 1 for p in positions) + 1         # + the null row
        nbytes = 2 * live * hkv * hd * 2 + b * hq * hd * (2 + 4)
        ops_count = 4 * hd * hq * live
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops_count / PEAK_OPS_PER_S["torch.float32"] * 1e3
        bound = max(t_bytes, t_ops)
        log(f"  paged decode at {cell}'s step (B{b} Hq{hq} Hkv{hkv} hd{hd} "
            f"bf16, {live} live positions, {card}): kernel {kernel_ms:.5f} "
            f"ms back to back ({100 * bound / kernel_ms:.1f}% of the "
            f"bound), {dev_ms:.5f} ms with the host queued ahead "
            f"({100 * bound / dev_ms:.1f}%), the wrapper's host time "
            f"{host_ms:.5f} ms a call; plain {plain_ms:.5f} ms; bound "
            f"{bound:.6f} ms ({nbytes} B, {ops_count} f32 ops); max|err| "
            f"{err:.3e} (err/limit {over:.3f})")
        if not over <= 1.0:
            raise AssertionError(f"paged decode at {cell}: err/limit {over}")
        got[cell] = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                         bound_ms=bound, library_ms=None,
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", shape=cell)
    return dict(got["internlm2-20b.chat"],
                phi3v=got["phi-3-vision-4.2b.chat"])


# ---------------------------------------------------------------------------
# phase 3: serve
# ---------------------------------------------------------------------------

def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))]


def counting_decodes():
    """A patch of `transformer.decode_step_paged` that counts the decode
    steps it runs to their end under ["steps"]; kernel 8 launches once a
    layer in each.  Returns (the patch, the count)."""
    from repro_torch.models import transformer
    real, seen = transformer.decode_step_paged, {"steps": 0}

    def counted(*a, **k):
        out = real(*a, **k)
        seen["steps"] += 1
        return out

    return mock.patch.object(transformer, "decode_step_paged", counted), seen


def drive_engine(torch, eng, prompts, new_tokens, on_step=None):
    """Submit every prompt, step the engine until idle noting the host
    time each request's tokens arrive, then the final evict pass;
    `on_step` sees each step's result as it returns.  Returns (rids, TTFT
    list (submit to the end of the admitting step), gaps between a
    request's tokens, wall); waits for the card at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, new_tokens) for p in prompts]
    got_at = {rid: [] for rid in rids}               # host times of tokens
    while not eng.scheduler.idle():
        before = {st.rid: len(st.out) for st in eng.scheduler.slots
                  if st is not None}
        res = eng.step()
        now = time.perf_counter()
        if on_step is not None:
            on_step(res)
        for st in eng.scheduler.slots:
            if st is not None and len(st.out) > before.get(st.rid, 0):
                got_at[st.rid].append(now)
    eng.run()                                        # final evict pass
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ttft = [got_at[r][0] - t0 for r in rids]
    gaps = [b - a for r in rids for a, b in zip(got_at[r], got_at[r][1:])
            if b > a]
    return rids, ttft, gaps, wall


def serve(torch, np, fa, serving, ServeEngine):
    from repro_torch.kernels import paged_decode as kpd
    cfg, engine_kw = serving.CONFIG, serving.SERVE_ENGINE
    n_requests, prompt_len, new_tokens = (
        serving.SERVE_TRAFFIC[k] for k in ("requests", "prompt_len",
                                           "new_tokens"))
    eng = ServeEngine(cfg, device="cuda", init_seed=0, **engine_kw)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, size=(n_requests, prompt_len),
                           dtype=np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    decode_steps = []
    fa.launches = kpd.launches = 0                   # main path starts
    rids, ttft, gaps, wall = drive_engine(
        torch, eng, prompts, new_tokens,
        lambda res: decode_steps.append(res["decoded"] > 0))
    launches = {"flash_attention": fa.launches,      # main path ends
                "paged_decode": kpd.launches}
    peak = torch.cuda.max_memory_allocated()

    n_prefill = eng.scheduler.n_admitted
    if launches["flash_attention"] != cfg.n_layers * n_prefill:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times, want "
                             f"{cfg.n_layers} x {n_prefill} prefills")
    if launches["paged_decode"] != cfg.n_layers * sum(decode_steps):
        raise AssertionError(f"paged_decode launched "
                             f"{launches['paged_decode']} times, want "
                             f"{cfg.n_layers} x {sum(decode_steps)} decode "
                             f"steps")
    for rid in rids:
        if len(eng.results[rid]) != new_tokens:
            raise AssertionError(f"request {rid}: {len(eng.results[rid])} "
                                 f"tokens, want {new_tokens}")
    n_tok = sum(len(eng.results[r]) for r in rids)
    log(f"  served {n_requests} requests x {new_tokens} tokens in "
        f"{wall:.3f} s: {n_tok / wall:.1f} tok/s, TTFT p50 "
        f"{pct(ttft, 50) * 1e3:.2f} ms (submit to the end of the admitting "
        f"step), per-token p50 {pct(gaps, 50) * 1e3:.3f} ms, peak memory "
        f"{peak / 2**30:.3f} GiB, {eng.steps} engine steps, "
        f"{n_prefill} prefills, {sum(decode_steps)} decode steps; launches "
        f"{launches}")

    # two requests alone: tokens bit-identical to the batched run
    solo = ServeEngine(cfg, params=eng.params, device="cuda", **engine_kw)
    for rid in rids[:2]:
        s = solo.submit(prompts[rid], new_tokens)
        solo.run()
        if not np.array_equal(solo.results[s], eng.results[rid]):
            raise AssertionError(f"request {rid}: alone "
                                 f"{solo.results[s].tolist()} != batched "
                                 f"{eng.results[rid].tolist()}")
    log("  batched == alone, bit for bit, for requests "
        f"{rids[:2]}")
    stats = {"tokens": [eng.results[r].copy() for r in rids],
             "ttft_p50": pct(ttft, 50), "per_token_p50": pct(gaps, 50),
             "tok_s": n_tok / wall}
    return eng, prompts, launches, stats


def prefill_logits_check(torch, np, ref, layers, eng, prompts, serving,
                         ServeEngine):
    """One request's prefill logits through the kernel and through the
    plain version (ops.attention swapped for ref.attention_ref)."""
    cfg = serving.CONFIG

    def first_logits():
        e = ServeEngine(cfg, params=eng.params, device="cuda",
                        capture_logits=True, **serving.SERVE_ENGINE)
        r = e.submit(prompts[0], 1)
        e.run()
        return e.logits_trace[r][0]

    kernel = first_logits()
    with mock.patch.object(layers.kops, "attention", ref.attention_ref):
        plain = first_logits()
    if kernel.shape != (cfg.vocab,) or not np.isfinite(kernel).all():
        raise AssertionError(f"prefill logits {kernel.shape}, finite "
                             f"{np.isfinite(kernel).all()}")
    err = float(np.abs(kernel - plain).max())
    scale = float(np.abs(plain).max())
    log(f"  prefill logits kernel vs plain: max|err| {err:.4e}, "
        f"max|logit| {scale:.4f}, tol {PREFILL_LOGITS_RTOL * scale:.4e}; "
        f"argmax {int(kernel.argmax())} vs {int(plain.argmax())}")
    if not err <= PREFILL_LOGITS_RTOL * scale:
        raise AssertionError(f"prefill logits differ by {err}")


# ---------------------------------------------------------------------------
# phase 4: the runtime's kernels against their plain versions
# ---------------------------------------------------------------------------

RUNTIME_KERNELS = [
    ("put_copy", "src/repro_torch/kernels/csrc/put_copy.cu",
     "src/repro/kernels/put_copy.py:37"),
    ("dma_copy", "src/repro_torch/kernels/csrc/put_copy.cu",
     "src/repro/kernels/put_copy.py:59"),
    ("reduce_combine", "src/repro_torch/kernels/csrc/reduce_combine.cu",
     "src/repro/kernels/reduce_combine.py:39"),
]
# the runtime's real size: the trainer's gradient-sync bucket, 64 MiB of
# f32 per PE (BUCKET_BYTES, src/repro/train/step.py:36), on the paper's 16
# PEs: 1 GiB of PE-stacked payload
BUCKET_ELEMS = (64 << 20) // 4


def rand(torch, gen, shape, dtype):
    """Seeded values of `dtype` on the card (floats at 100x unit scale)."""
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=gen, device="cuda") * 100
                ).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -(1 << 30)), min(info.max, 1 << 30),
                         shape, generator=gen, device="cuda",
                         dtype=torch.int64).to(dtype)


def bitwise(torch, got, want, what: str) -> None:
    """Kernel output == plain output value for value (NaN where NaN)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    if want.dtype.is_floating_point:
        nan = torch.isnan(want)
        if not torch.equal(torch.isnan(got), nan) or \
                not torch.equal(got[~nan], want[~nan]):
            raise AssertionError(f"{what}: kernel != plain version")
    elif not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel != plain version")


def check_runtime_kernels(torch, gen) -> None:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import put_copy as pc
    from repro_torch.kernels import reduce_combine as rc
    cases = {"put_copy": 0, "dma_copy": 0, "reduce_combine": 0}
    f32, i32, bf16, f64 = (torch.float32, torch.int32, torch.bfloat16,
                           torch.float64)
    # put_copy: identity, source-row tables with zero rows and more rows
    # out than in, rows at a stride (unaligned row starts)
    for shape in [(37, 300), (100, 1), (1, 513), (1, 1), (7, 37),
                  (16, 4096)]:
        for dt in (f32, i32, bf16, f64, torch.uint8):
            x = rand(torch, gen, shape, dt)
            tables = [None, torch.randint(-1, shape[0], (shape[0] + 3,),
                                          generator=gen, device="cuda",
                                          dtype=torch.int32)]
            for rows in tables:
                bitwise(torch, pc.put_copy(x, rows),
                        ref.put_copy_ref(x, rows), f"put_copy {shape} {dt}")
                cases["put_copy"] += 1
            if shape[1] > 1:
                bitwise(torch, pc.put_copy(x[:, 1:], tables[1]),
                        ref.put_copy_ref(x[:, 1:], tables[1]),
                        f"put_copy strided {shape} {dt}")
                cases["put_copy"] += 1
            bitwise(torch, ops.put_copy(x), x, f"ops.put_copy {shape} {dt}")
    # dma_copy: the CPU tests' descriptor, ragged regions, 1 row, 1
    # column, and a batch of 96 descriptors in one launch
    batch = [[r, c, 95 - r, 383 - c - 1, 1, 2] for r in range(0, 64, 2)
             for c in (0, 77, 201)]
    for descs in ([[32, 128, 0, 256, 32, 128]], [[3, 5, 7, 11, 13, 17]],
                  [[63, 0, 0, 0, 1, 256]], [[0, 255, 1, 1, 64, 1]], batch):
        for dt in (f32, f64, i32, bf16, torch.uint8):
            src = rand(torch, gen, (64, 256), dt)
            dst = rand(torch, gen, (96, 384), dt)
            plan = pc.DmaPlan(descs, src.shape, dst.shape)
            bitwise(torch, pc.dma_copy(src, dst.clone(), plan),
                    ref.dma_copy_ref(src, dst.clone(), plan.descs),
                    f"dma_copy {descs[0]} x{len(descs)} {dt}")
            cases["dma_copy"] += 1
    # reduce_combine over both of its paths: the 16-byte vector path
    # (aligned bases and row strides) with its scalar tail, and the scalar
    # path (a base or a row stride off 16 bytes); k = 2, 3 and 4 (template
    # k), 17 and 33 (run-time k; 33 folds in two launches); NaN in the
    # float buffers for max/min
    def layouts(make):
        """(label, k views of one shape): contiguous; a ragged column count
        on aligned rows; the ring reduce-scatter's blocks of PE-stacked
        rows; a base one element off; a row stride off 16 bytes."""
        yield "contiguous", lambda: make((40, 256))
        yield "ragged cols", lambda: make((40, 256))[:, :203]
        yield "ring blocks", lambda: make((16, 1024))[:, 192:448]
        yield "base +1", lambda: make((40 * 256 + 1,))[1:].view(40, 256)
        yield "odd stride", lambda: make((40, 257))[:, :250]

    def buf(dt, op):
        def make(shape):
            b = rand(torch, gen, shape, dt)
            if dt.is_floating_point:
                b = b / 100
                if op in ("max", "min"):
                    b.view(-1)[::7] = float("nan")
            elif op == "prod":
                b = b % 5 - 2
            return b
        return make

    for dt in (f32, bf16, torch.float16, i32, torch.int8, f64,
               torch.int64):
        for op in ("sum", "prod", "max", "min"):
            for k in (2, 3, 4, 17, 33):
                for label, view in layouts(buf(dt, op)):
                    bufs = [view() for _ in range(k)]
                    bitwise(torch, rc.reduce_combine(bufs, op),
                            ref.reduce_combine_ref(bufs, op),
                            f"reduce_combine {dt} {op} k{k} {label}")
                    cases["reduce_combine"] += 1
    wide = rand(torch, gen, (16, 1000), f32)
    blocks = [wide[:, 25 * t:25 * (t + 1)] for t in range(40)]
    bitwise(torch, rc.reduce_combine(blocks, "sum"),
            ref.reduce_combine_ref(blocks, "sum"), "reduce_combine k40")
    nan = torch.tensor([[1.0, float("nan"), 3.0, -1.0, float("nan")]],
                       device="cuda")
    other = torch.tensor([[float("nan"), 2.0, 1.0, float("nan"), 0.5]],
                         device="cuda")
    for dt in (f32, bf16):
        for op in ("max", "min"):
            got = rc.reduce_combine([nan.to(dt), other.to(dt)], op)
            bitwise(torch, got, ref.reduce_combine_ref(
                [nan.to(dt), other.to(dt)], op), f"NaN {op} {dt}")
            if int(torch.isnan(got).sum()) != 4:
                raise AssertionError(f"NaN {op} {dt}: {got.tolist()}")
    cases["reduce_combine"] += 6
    # 64 MiB per buffer
    big = rand(torch, gen, (16, 1 << 20), f32)
    ring = torch.tensor([(i - 1) % 16 for i in range(16)], dtype=torch.int32,
                        device="cuda")
    bitwise(torch, pc.put_copy(big, ring), ref.put_copy_ref(big, ring),
            "put_copy 64 MiB")
    B = (1 << 20) // 16
    plan = pc.DmaPlan([[p, ((p + t) % 16) * B, p, t * B, 1, B]
                       for p in range(16) for t in range(16)],
                      big.shape, big.shape)
    bitwise(torch, pc.dma_copy(big, torch.empty_like(big), plan),
            ref.dma_copy_ref(big, torch.empty_like(big), plan.descs),
            "dma_copy 64 MiB")
    big2 = rand(torch, gen, (16, 1 << 20), f32)
    bitwise(torch, rc.reduce_combine([big, big2], "sum"),
            ref.reduce_combine_ref([big, big2], "sum"),
            "reduce_combine 64 MiB")
    torch.cuda.synchronize()
    log(f"  bit for bit with the plain versions: {cases} cases, plus "
        f"strided/k40/NaN combines and 64 MiB buffers of each kernel")


def time_runtime_kernels(torch, gen) -> dict:
    """Each kernel at the shapes the 1 GiB bucket gives it on the main
    path: put_copy = one delivery of the rd allreduce's first stage
    (16 rows of 64 MiB), dma_copy = the ring reduce-scatter's
    pre-rotation (256 descriptors of 4 MiB), reduce_combine = one rd
    stage combine (two 1 GiB buffers).  The kernel alone is its C entry
    called back to back; the plain version is `kernels/ref.py`; the
    library call is one PyTorch op computing the same function."""
    import ctypes
    import numpy as np
    from repro_torch.core import collectives as coll
    from repro_torch.core.pattern import xor_pattern
    from repro_torch.kernels import ref
    from repro_torch.kernels import put_copy as pc
    from repro_torch.kernels import reduce_combine as rc
    n, L = 16, BUCKET_ELEMS
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.randn((n, L), generator=gen, device="cuda")
    nbytes = x.numel() * x.element_size()
    out = {}

    def row(name, err, ms, plain_ms, library_ms, moved, what):
        bound = moved / HBM_BYTES_PER_S * 1e3
        log(f"  {name} at {what}: kernel {ms:.5f} ms, plain {plain_ms:.5f} "
            f"ms, library {library_ms:.5f} ms; bound {bound:.5f} ms "
            f"({moved} B at 3.35 TB/s), max|err| {err}")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound,
                         bound_by="bytes")

    lib = pc._library()
    table = xor_pattern(n, 1).gather_table_device(x.device)
    y = torch.empty_like(x)
    got = pc.put_copy(x, table)
    err = float((got - ref.put_copy_ref(x, table)).abs().max())
    idx = table.long()
    if not torch.equal(torch.index_select(x, 0, idx), got):
        raise AssertionError("index_select != put_copy")
    del got
    row("put_copy",
        err, time_ms(lambda: lib.repro_put_copy(
            x.data_ptr(), y.data_ptr(), table.data_ptr(), n, L * 4, L * 4,
            stream), iters=20, warmup=3),
        time_ms(lambda: ref.put_copy_ref(x, table), iters=10, warmup=2),
        time_ms(lambda: torch.index_select(x, 0, idx), iters=20, warmup=3),
        2 * nbytes, "16 x 64 MiB f32, one delivery")

    rank = np.arange(n)
    plan = coll._plan("take", (rank[:, None] + rank) % n, 1, L // n, n, n)
    got = pc.dma_copy(x, torch.empty_like(x), plan)
    err = float((got - ref.dma_copy_ref(x, torch.empty_like(x),
                                         plan.descs)).abs().max())
    blk = torch.as_tensor((rank[:, None] + rank) % n, device="cuda")
    pe = torch.arange(n, device="cuda")[:, None]
    xv = x.view(n, n, L // n)
    if not torch.equal(xv[pe, blk].reshape(n, L), got):
        raise AssertionError("advanced indexing != dma_copy")
    del got
    segs = -(-(L // n * 4) // pc.SEG_BYTES)
    descs = plan.on(x.device)
    row("dma_copy",
        err, time_ms(lambda: lib.repro_dma_copy(
            x.data_ptr(), y.data_ptr(), descs.data_ptr(), len(plan), segs, 4,
            L, L, stream), iters=20, warmup=3),
        time_ms(lambda: ref.dma_copy_ref(x, y, plan.descs), iters=10,
                warmup=2),
        time_ms(lambda: xv[pe, blk], iters=20, warmup=3),
        2 * nbytes, "16 x 64 MiB f32, 256 descriptors of 4 MiB")

    clib = rc._library()
    b = torch.randn((n, L), generator=gen, device="cuda")
    got = rc.reduce_combine([x, b], "sum")
    err = float((got - ref.reduce_combine_ref([x, b], "sum")).abs().max())
    if not torch.equal(torch.add(x, b), got):
        raise AssertionError("torch.add != reduce_combine")
    del got
    ptrs = (ctypes.c_void_p * 2)(x.data_ptr(), b.data_ptr())
    lds = (ctypes.c_int64 * 2)(L, L)
    # kernel and torch.add in alternating pairs (either first in turn),
    # after a warm-up of both; the medians of six readings each
    def kern():
        clib.repro_reduce_combine(ptrs, lds, 2, y.data_ptr(), n, L, 0, 0,
                                  stream)

    def add():
        torch.add(x, b, out=y)

    for _ in range(20):
        kern()
        add()
    pairs = []
    for i in range(6):
        t = {fn: time_ms(fn, iters=30, warmup=5)
             for fn in ((kern, add) if i % 2 else (add, kern))}
        pairs.append((t[kern], t[add]))
    k_ms = statistics.median(k for k, _ in pairs)
    add_ms = statistics.median(a for _, a in pairs)
    row("reduce_combine", err, k_ms,
        time_ms(lambda: ref.reduce_combine_ref([x, b], "sum"), iters=10,
                warmup=2),
        add_ms, 3 * nbytes, "two 16 x 64 MiB f32 buffers, sum")
    ratios = [k / a for k, a in pairs]
    log(f"  reduce_combine in 6 alternating pairs with torch.add: kernel / "
        f"torch.add median {statistics.median(ratios):.4f} (min "
        f"{min(ratios):.4f}, max {max(ratios):.4f}), the kernel faster in "
        f"{sum(r < 1 for r in ratios)} of 6; "
        f"{out['reduce_combine']['bound_ms'] / k_ms:.1%} of the byte bound")
    del x, y, b
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 5: the OpenSHMEM runtime on the card
# ---------------------------------------------------------------------------

def f32_sum_ok(np, got, x64) -> float:
    """Largest |got - exact| over its bound (n-1) * 2^-24 * sum|x|, the
    worst case of n f32 additions in any order; <= 1 passes."""
    exact = x64.sum(0)
    bound = (x64.shape[0] - 1) * 2.0 ** -24 * np.abs(x64).sum(0) + 1e-30
    return float((np.abs(got.astype(np.float64) - exact) / bound).max())


def runtime(torch, np) -> dict:
    from repro_torch.configs import epiphany16 as paper
    from repro_torch.core import collectives as coll
    from repro_torch.core import sim_ctx
    from repro_torch.kernels import put_copy as pc
    from repro_torch.kernels import reduce_combine as rc
    n, topo = paper.N_PES, paper.TOPOLOGY
    rng = np.random.default_rng(0)
    ring = [(i, (i + 1) % n) for i in range(n)]
    mirror = [(i, n - 1 - i) for i in range(n)]
    want = {"put_copy": 0, "dma_copy": 0, "reduce_combine": 0}

    def expect(ctx, stages_or_patterns, dma=0, combines=0):
        """Launches one op must make: a put per ppermute (plus, under
        NoC waves, a wave fold per multi-wave pattern), a DMA per block
        gather, a combine per reduction stage."""
        pats = [getattr(p, "pattern", p) for p in stages_or_patterns]
        want["put_copy"] += len(pats)
        want["dma_copy"] += dma
        want["reduce_combine"] += combines
        if getattr(ctx.net, "topo", None) is not None:
            want["reduce_combine"] += sum(len(p.link_waves(topo)) > 1
                                          for p in pats)

    def exact(got, oracle, what):
        g = got.cpu().numpy()
        if g.shape != oracle.shape or not np.array_equal(g, oracle):
            raise AssertionError(f"{what}: differs from numpy")

    def close(got, x64, what):
        ratio = f32_sum_ok(np, got.cpu().numpy(), x64)
        if not ratio <= 1.0:
            raise AssertionError(f"{what}: f32 sum off by {ratio:.3g}x its "
                                 f"bound")
        return ratio

    def with_rows(x, pairs):
        out = x.copy()
        for s, d in pairs:
            out[d] = x[s]
        return out

    pc.launches = pc.dma_launches = rc.launches = 0     # phase 5 starts
    t0 = time.perf_counter()
    worst = 0.0
    for noc in (False, True):
        ctx = sim_ctx(n, topo, noc=noc, device="cuda")
        for size in paper.MSG_SIZES:
            e = size // 4
            xi_h = rng.integers(-1000, 1000, (n, e), dtype=np.int32)
            xf_h = rng.standard_normal((n, e), dtype=np.float32)
            xi, xf = torch.from_numpy(xi_h).cuda(), \
                torch.from_numpy(xf_h).cuda()
            tag = f"noc={noc} {size} B"
            exact(ctx.put(xi, ring), with_rows(xi_h, ring), f"put {tag}")
            expect(ctx, [ctx.compile(ring)])
            exact(ctx.get(xf, ring), np.roll(xf_h, -1, 0), f"get {tag}")
            expect(ctx, [ctx._owner_push(ring)])
            pats = [[(0, 5)], ring, mirror]
            for p in pats:
                ctx.put_nbi(xi, p)
            for p, v in zip(pats, ctx.quiet()):
                exact(v, with_rows(xi_h, p), f"put_nbi+quiet {tag}")
            expect(ctx, [ctx.compile(p) for p in pats])
            f1 = ctx.put_nbi(xi, [(0, 3)])
            f2 = ctx.put_nbi(2 * xi, [(1, 3)])
            if len(ctx.fence()) != 2 or f1.done or ctx.pending_count != 2:
                raise AssertionError(f"fence completed ops {tag}")
            ctx.quiet()
            exact(f2.value, with_rows(2 * xi_h, [(1, 3)]), f"fence {tag}")
            expect(ctx, [ctx.compile([(0, 3)]), ctx.compile([(1, 3)])])
            tok = ctx.barrier_all(torch.ones(n, dtype=torch.int32,
                                             device="cuda"))
            exact(tok, np.full(n, n, np.int32), f"barrier_all {tag}")
            expect(ctx, coll.barrier_schedule(n).stages)
            exact(ctx.broadcast(xf, 5), np.tile(xf_h[5], (n, 1)),
                  f"broadcast {tag}")
            expect(ctx, coll.broadcast_schedule(n, 0.0, 5).stages)
            allv = np.tile(xi_h.reshape(-1), (n, 1))
            exact(ctx.fcollect(xi), allv, f"fcollect {tag}")
            expect(ctx, coll.fcollect_schedule(n, 0.0, "rd").stages, dma=1)
            exact(ctx.collect(xi), allv, f"collect {tag}")
            expect(ctx, coll.fcollect_schedule(n, 0.0, "ring").stages, dma=1)
            isum = np.tile(xi_h.sum(0, dtype=np.int64).astype(np.int32),
                           (n, 1))
            for algo, dma, comb in (("rd", 0, 4), ("ring", 2, n - 1)):
                sched = coll.allreduce_schedule(n, 0.0, algo).stages
                exact(ctx.to_all(xi, "sum", algorithm=algo), isum,
                      f"to_all {algo} i32 {tag}")
                expect(ctx, sched, dma=dma, combines=comb)
                got = ctx.to_all(xf, "sum", algorithm=algo)
                worst = max(worst, close(got, xf_h.astype(np.float64),
                                         f"to_all {algo} f32 {tag}"))
                expect(ctx, sched, dma=dma, combines=comb)
            own, info = ctx.reduce_scatter(xi)
            exact(coll.allgather_unpad(ctx.net, own, info), isum,
                  f"reduce_scatter+allgather {tag}")
            expect(ctx, coll.reduce_scatter_schedule(n).stages, dma=1,
                   combines=n - 1)
            expect(ctx, coll.allgather_schedule(n).stages, dma=1)
            blk = max(1, e // n)
            a_h = rng.integers(-99, 99, (n, n * blk), dtype=np.int32)
            exact(ctx.alltoall(torch.from_numpy(a_h).cuda()),
                  a_h.reshape(n, n, blk).transpose(1, 0, 2)
                  .reshape(n, n * blk), f"alltoall {tag}")
            expect(ctx, coll.alltoall_schedule(n).stages, dma=2)
    torch.cuda.synchronize()
    log(f"  paper sweep: {len(paper.MSG_SIZES)} sizes "
        f"({paper.MSG_SIZES[0]} B .. {paper.MSG_SIZES[-1]} B per PE) x 2 "
        f"nets x 14 ops checked against numpy in "
        f"{time.perf_counter() - t0:.1f} s; worst f32 sum error "
        f"{worst:.3f} of its bound")

    # the trainer's 64 MiB-per-PE gradient bucket on 16 PEs
    ctx = sim_ctx(n, topo, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    xf = torch.randn((n, BUCKET_ELEMS), generator=gen, device="cuda")
    xi = torch.randint(-1000, 1000, (n, BUCKET_ELEMS), generator=gen,
                       device="cuda", dtype=torch.int32)
    xf64 = xf.cpu().numpy().astype(np.float64)
    isum = xi.cpu().numpy().sum(0, dtype=np.int64).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.setdefault(label, []).append(time.perf_counter() - t)
        if not torch.equal(out, out[:1].expand_as(out)):
            raise AssertionError(f"{label}: PEs disagree")
        return out[0].cpu().numpy()

    rs_ag = lambda v: coll.allgather_unpad(  # noqa: E731
        ctx.net, *ctx.reduce_scatter(v))
    runs = [(algo, (lambda v, a=algo: ctx.to_all(v, "sum", algorithm=a)),
             coll.allreduce_schedule(n, 0.0, algo).stages, dma, comb)
            for algo, dma, comb in (("rd", 0, 4), ("ring", 2, n - 1))]
    runs.append(("rs+ag", rs_ag, coll.reduce_scatter_schedule(n).stages
                 + coll.allgather_schedule(n).stages, 2, n - 1))
    for label, fn, stages, dma, comb in runs:
        for _ in range(2):
            got = timed(f"{label} i32", lambda: fn(xi))
            if not np.array_equal(got, isum):
                raise AssertionError(f"bucket {label} i32 differs")
            expect(ctx, stages, dma=dma, combines=comb)
            got = timed(f"{label} f32", lambda: fn(xf))
            ratio = f32_sum_ok(np, got, xf64)
            if not ratio <= 1.0:
                raise AssertionError(f"bucket {label} f32 off by {ratio}x")
            expect(ctx, stages, dma=dma, combines=comb)
    peak = torch.cuda.max_memory_allocated()
    got = {"put_copy": pc.launches, "dma_copy": pc.dma_launches,
           "reduce_combine": rc.launches}                # phase 5 ends
    for label, ws in walls.items():
        log(f"  bucket 16 x 64 MiB {label}: wall "
            + ", ".join(f"{w * 1e3:.3f}" for w in ws) + " ms")
    log(f"  bucket peak device memory {peak / 2**30:.3f} GiB (inputs "
        f"2 x 1 GiB); launches {got}, implied by the schedules {want}")
    for name in want:
        if got[name] != want[name] or got[name] < 1:
            raise AssertionError(f"{name}: {got[name]} launches, the "
                                 f"schedules imply {want[name]}")
    small_op_walls(torch, ctx, n, ring)
    return got


def small_op_walls(torch, ctx, n, ring) -> None:
    """Wall time of single calls at the paper's smallest and largest
    message sizes (synchronised host clock, median of 21): what one
    launch-bound collective costs on the card's host."""
    import statistics
    for size in (8, 16384):
        x = torch.ones((n, size // 4), dtype=torch.int32, device="cuda")
        ops = {"put": lambda: ctx.put(x, ring),
               "barrier_all": lambda: ctx.barrier_all(),
               "to_all rd": lambda: ctx.to_all(x, "sum", algorithm="rd"),
               "to_all ring": lambda: ctx.to_all(x, "sum",
                                                 algorithm="ring"),
               "fcollect": lambda: ctx.fcollect(x)}
        walls = {}
        for name, fn in ops.items():
            ts = []
            for _ in range(21):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t)
            walls[name] = statistics.median(ts) * 1e3
        log(f"  {size} B per PE, median wall ms: "
            + ", ".join(f"{k} {v:.4f}" for k, v in walls.items()))


# ---------------------------------------------------------------------------
# phase 6: training — kernel 5, the fused bucket, full-width steps
# ---------------------------------------------------------------------------

ADAM_HP = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd_coef=0.1)
# offsets (elements) of g_0.., p, m, v, mask into larger buffers: all
# aligned (the vector path), all odd or mixed (the outputs are aligned,
# so the scalar path); the strided (16, cols) cases below reach the
# vector path after a head
OFFSETS = {"aligned": lambda i: 0, "odd": lambda i: 1,
           "mixed": lambda i: 1 + i % 3}
# tolerances of phase 6e: the loss through the kernel relative to the
# loss through the plain attention, and every gradient leaf relative to
# its own max |value|.  f32: 1e-5 and 1e-3.  bf16: set from the readings
# of the H100 runs (loss rel 1.068e-4, worst leaf 3.585e-2, identical in
# each run), at about 9x and 3x above them
GRAD_RTOL = {"torch.float32": (1e-5, 1e-3), "torch.bfloat16": (1e-3, 0.1)}


def adam_inputs(torch, gen, k, n, mode, g_scale=1.0, zero=False):
    """k gradient chunks, p, m and v of length n, each a view at its
    OFFSETS[mode] element offset into a larger buffer (zero gradients and
    moments with `zero`), and a function placing a mask the same way."""
    off = OFFSETS[mode]

    def at(i, x):
        buf = torch.empty(n + 8, dtype=x.dtype, device="cuda")
        buf[off(i):off(i) + n] = x
        return buf[off(i):off(i) + n]

    def rnd(scale):
        return torch.randn(n, generator=gen, device="cuda") * scale

    gs = [at(i, torch.zeros(n, device="cuda") if zero else rnd(g_scale))
          for i in range(k)]
    p = at(k, rnd(1.0))
    m = at(k + 1, torch.zeros(n, device="cuda") if zero else rnd(0.1))
    v = at(k + 2, torch.zeros(n, device="cuda") if zero
           else rnd(0.01).abs())
    return gs, p, m, v, lambda mask: at(k + 3, mask)


def check_fused_update(torch) -> None:
    """Kernel 5 against its plain version, bit for bit: k 1-4; n 1, 7,
    1000, 1003, 2^20+3; aligned, odd and mixed offsets; f32 and bf16 out;
    t 1 and 1000 with scales 4 and 3; masks all zero, all one and
    alternating; (16, cols) chunks with strided gradient rows; then zero
    gradients and moments, and |g| up to 1e18."""
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = 0

    def one(gs, p, m, v, w, t, scale, out, what):
        nonlocal cases
        c1 = torch.tensor(1 - 0.9 ** t, device="cuda")
        c2 = torch.tensor(1 - 0.95 ** t, device="cuda")
        kw = dict(scale=scale, out_dtype=out, **ADAM_HP)
        got = fu.fused_adam(gs, p, m, v, w, c1, c2, **kw)
        want = ref.fused_adam_ref(gs, p, m, v, w, c1, c2, **kw)
        for name, a, b in zip("pmv", got, want):
            bitwise(torch, a, b, f"fused_update {what} {name}")
        cases += 1

    for k in (1, 2, 3, 4):
        for n in (1, 7, 1000, 1003, (1 << 20) + 3):
            for mode in OFFSETS:
                gs, p, m, v, at = adam_inputs(torch, gen, k, n, mode)
                masks = {"zero": torch.zeros(n, dtype=torch.int8,
                                             device="cuda"),
                         "one": torch.ones(n, dtype=torch.int8,
                                           device="cuda"),
                         "alt": (torch.arange(n, device="cuda") % 2).to(
                             torch.int8)}
                for mname, mask in masks.items():
                    w = at(mask)
                    for t, scale in ((1, 4.0), (1000, 3.0)):
                        for out in (torch.float32, torch.bfloat16):
                            one(gs, p, m, v, w, t, scale, out,
                                f"k{k} n{n} {mode} {mname} t{t} {out}")
    # PE-stacked (rows, cols) chunks, the gradients column blocks of a
    # wider buffer (as the ring's last local partial): ragged rows start
    # at every alignment, so rows take the vector path after a head, or
    # the scalar path
    for k in (1, 2, 4):
        for cols in (1000, 1003, (1 << 16) + 3):
            wide = torch.randn((16, k * cols + 1), generator=gen,
                               device="cuda")
            gs = [wide[:, 1 + j * cols:1 + (j + 1) * cols] for j in range(k)]
            p, m, v = (torch.randn((16, cols), generator=gen, device="cuda")
                       for _ in range(3))
            v = v.abs()
            w = (torch.arange(16 * cols, device="cuda") % 3 == 0).to(
                torch.int8).reshape(16, cols)
            for out in (torch.float32, torch.bfloat16):
                one(gs, p, m, v, w, 1000, 16.0, out,
                    f"k{k} 16 x {cols} strided {out}")
    for k in (1, 4):
        for g_scale, zero in ((1e18, False), (1e9, False), (1.0, True)):
            gs, p, m, v, at = adam_inputs(torch, gen, k, 1003, "odd",
                                          g_scale, zero)
            w = at((torch.arange(1003, device="cuda") % 2).to(torch.int8))
            for out in (torch.float32, torch.bfloat16):
                one(gs, p, m, v, w, 1, 1.0, out,
                    f"k{k} |g|~{g_scale:g} zero={zero} {out}")
    torch.cuda.synchronize()
    log(f"  fused_update: {cases} cases bit for bit with the plain version "
        f"(p, m, v)")


def time_fused_update(torch, n_params: int) -> dict:
    """Kernel 5 at the two shapes the training paths give it: the 16-PE
    bucket (k 2, 16 rows of 1,048,576) and the full-width step (k 1,
    every parameter once).  The kernel alone is its C entry called back
    to back; the plain version is `ref.fused_adam_ref`; no single PyTorch
    call computes the function (library: none)."""
    import ctypes
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(7)
    lib = fu._library()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for label, k, rows, cols in (("bucket16", 2, 16, 1 << 20),
                                 ("full", 1, 1, n_params)):
        gs = [torch.randn((rows, cols), generator=gen, device="cuda")
              for _ in range(k)]
        p = torch.randn((rows, cols), generator=gen, device="cuda")
        m = torch.randn((rows, cols), generator=gen, device="cuda") * 0.1
        v = torch.rand((rows, cols), generator=gen, device="cuda") * 0.01
        w = (torch.arange(cols, device="cuda") % 2).to(torch.int8) \
            .expand(rows, cols).contiguous()
        hyper = torch.tensor([1 - 0.9 ** 10, 1 - 0.95 ** 10], device="cuda")
        kw = dict(scale=float(k), out_dtype=torch.float32, **ADAM_HP)
        got = fu.fused_adam(gs, p, m, v, w, hyper[0], hyper[1], **kw)
        want = ref.fused_adam_ref(gs, p, m, v, w, hyper[0], hyper[1], **kw)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        del want
        po, mo, vo = got
        args = ((ctypes.c_void_p * k)(*[g.data_ptr() for g in gs]),
                (ctypes.c_int64 * k)(*[cols] * k), k, p.data_ptr(),
                m.data_ptr(), v.data_ptr(), w.data_ptr(), hyper.data_ptr(),
                po.data_ptr(), mo.data_ptr(), vo.data_ptr(), rows, cols, 0,
                ADAM_HP["lr"], ADAM_HP["b1"], ADAM_HP["b2"],
                1.0 - ADAM_HP["b1"], 1.0 - ADAM_HP["b2"], ADAM_HP["eps"],
                ADAM_HP["wd_coef"], float(k), stream)
        iters = 50 if label == "bucket16" else 10
        ms = time_ms(lambda: lib.repro_fused_adam(*args), iters=iters,
                     warmup=3)
        plain_ms = time_ms(lambda: ref.fused_adam_ref(
            gs, p, m, v, w, hyper[0], hyper[1], **kw), iters=5, warmup=1)
        nbytes = rows * cols * (4 * k + 13 + 12)
        flops = rows * cols * (k + 14)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_OPS_PER_S["torch.float32"] * 1e3
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=None, bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations")
        log(f"  fused_update {label} (k {k}, {rows} x {cols} f32): kernel "
            f"{ms:.5f} ms, plain {plain_ms:.5f} ms, library none; bound "
            f"{max(t_bytes, t_ops):.5f} ms ({nbytes} B at 3.35 TB/s), "
            f"max|err| {err}")
        del gs, p, m, v, w, got, po, mo, vo
        torch.cuda.empty_cache()
    return out


def fused_bucket(torch, np) -> dict:
    """fused_rs_adam + allgather_unpad on the paper's 16 PEs at the
    trainer's 64 MiB-per-PE f32 bucket, bit for bit against
    reduce_scatter + allgather_unpad + the plain AdamW on full moments
    (`tests/test_fused.py`'s identity contract, with nonzero moments and
    t 1000); each PE's owned moment chunks against the matching slices.
    Returns the launch counts of the fused call."""
    from repro_torch.configs import epiphany16 as paper
    from repro_torch.core import collectives as coll
    from repro_torch.core import fusion, sim_ctx
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import put_copy as pc
    from repro_torch.kernels import reduce_combine as rc
    from repro_torch.kernels import ref
    n, L = paper.N_PES, BUCKET_ELEMS
    chunk = -(-L // n)
    net = sim_ctx(n, paper.TOPOLOGY, device="cuda").net
    gen = torch.Generator(device="cuda").manual_seed(8)
    g = torch.randn((n, L), generator=gen, device="cuda")
    p = torch.randn(L, generator=gen, device="cuda").expand(n, L) \
        .contiguous()
    wd = (torch.arange(L, device="cuda") % 3 == 0).to(torch.int8)
    m = torch.randn((n, chunk), generator=gen, device="cuda") * 0.1
    v = torch.rand((n, chunk), generator=gen, device="cuda") * 0.01
    c1 = torch.tensor(1 - 0.9 ** 1000, device="cuda")
    c2 = torch.tensor(1 - 0.95 ** 1000, device="cuda")
    kw = dict(scale=float(n), out_dtype=torch.float32, **ADAM_HP)

    def fused():
        new_p, new_m, new_v, info = fusion.fused_rs_adam(
            net, g, p, m, v, wd, c1, c2, **kw)
        return coll.allgather_unpad(net, new_p, info), new_m, new_v

    torch.cuda.synchronize()
    pc.launches = pc.dma_launches = rc.launches = fu.launches = 0
    full, new_m, new_v = fused()                  # the path's one call
    torch.cuda.synchronize()
    got = {"put_copy": pc.launches, "dma_copy": pc.dma_launches,
           "reduce_combine": rc.launches, "fused_update": fu.launches}
    stages = len(coll.reduce_scatter_schedule(n).stages)
    want = {"put_copy": stages + len(coll.allgather_schedule(n).stages),
            "dma_copy": 2, "reduce_combine": stages - 1, "fused_update": 1}
    if got != want:
        raise AssertionError(f"fused bucket launches {got}, the schedules "
                             f"imply {want}")

    own = (torch.arange(n, device="cuda") + 1) % n
    m_full = torch.zeros(chunk * n, device="cuda")
    v_full = torch.zeros(chunk * n, device="cuda")
    m_full.view(n, chunk)[own] = m
    v_full.view(n, chunk)[own] = v
    g_sum = coll.allgather_unpad(net, *coll.reduce_scatter(net, g))
    want_p, want_m, want_v = ref.fused_adam_ref(
        [g_sum], p, m_full[:L].expand(n, L), v_full[:L].expand(n, L),
        wd.expand(n, L), c1, c2, **kw)
    del g_sum
    bitwise(torch, full, want_p, "fused bucket p")
    if not torch.equal(full, full[:1].expand_as(full)):
        raise AssertionError("fused bucket: PEs disagree")
    idx = own[:, None] * chunk + torch.arange(chunk, device="cuda")
    bitwise(torch, new_m, torch.gather(want_m, 1, idx), "fused bucket m")
    bitwise(torch, new_v, torch.gather(want_v, 1, idx), "fused bucket v")
    del want_p, want_m, want_v, full
    walls = {}
    for label, fn in (("fused", fused), ("unfused", lambda: ref.fused_adam_ref(
            [coll.allgather_unpad(net, *coll.reduce_scatter(net, g))], p,
            m_full[:L].expand(n, L), v_full[:L].expand(n, L),
            wd.expand(n, L), c1, c2, **kw))):
        ts = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        walls[label] = ts
    log(f"  fused_rs_adam on 16 PEs x 64 MiB f32: bit for bit with "
        f"reduce_scatter + allgather_unpad + plain AdamW (p, owned m, v); "
        f"launches {got}; wall ms fused "
        + ", ".join(f"{w:.3f}" for w in walls["fused"]) + ", unfused "
        + ", ".join(f"{w:.3f}" for w in walls["unfused"]))
    del g, p, m, v, m_full, v_full
    torch.cuda.empty_cache()
    return got


def _counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import paged_decode as kpd
    from repro_torch.kernels import put_copy as pc
    from repro_torch.kernels import reduce_combine as rc
    from repro_torch.kernels import ring_attention as ra
    from repro_torch.kernels import ssd_scan as ks
    return {"flash_attention": fa.launches, "put_copy": pc.launches,
            "dma_copy": pc.dma_launches, "reduce_combine": rc.launches,
            "fused_update": fu.launches, "ssd_scan": ks.launches,
            "ring_attention": ra.launches, "paged_decode": kpd.launches}


def _reset_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import paged_decode as kpd
    from repro_torch.kernels import put_copy as pc
    from repro_torch.kernels import reduce_combine as rc
    from repro_torch.kernels import ring_attention as ra
    from repro_torch.kernels import ssd_scan as ks
    fa.launches = pc.launches = pc.dma_launches = rc.launches = 0
    fu.launches = ks.launches = ra.launches = kpd.launches = 0


# 6c trains this many steps a sync at TRAIN_RUN's shape, not the config's
# 12, for the time limit (the loss falls by a quarter in 6)
TRAIN_STEPS = 6


def train(torch, np, serving) -> dict:
    """6c: qwen2-0.5b at full width, TRAIN_STEPS steps at TRAIN_RUN's shape
    through the launcher (default sync: apply_updates) and as many through
    build_train_step(grad_rs="fused") from the same seed-0 weights.
    Returns the launch counts of both runs and what 6d needs."""
    from repro_torch.core.heap import tree_flatten
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as tstep
    cfg, run = serving.CONFIG, serving.TRAIN_RUN
    steps, tokens = TRAIN_STEPS, run["seq_len"] * run["batch"]
    per_step_fa = 2 * cfg.n_layers * cfg.microbatches

    def report(label, losses, walls, peak, counts):
        tok_s = tokens * (len(walls) - 1) / sum(walls[1:])
        log(f"  train {label}: {steps} steps, losses "
            + ", ".join(f"{x:.4f}" for x in losses)
            + f"; step wall ms " + ", ".join(f"{w * 1e3:.1f}" for w in walls)
            + f"; {tok_s:.1f} train tok/s (steps 2..{steps}); peak device "
            f"memory {peak / 2**30:.3f} GiB; launches {counts}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"train {label}: non-finite loss")
        if not np.mean(losses[-3:]) < np.mean(losses[:3]):
            raise AssertionError(f"train {label}: loss did not fall")
        if counts["flash_attention"] != per_step_fa * steps:
            raise AssertionError(
                f"train {label}: flash_attention launched "
                f"{counts['flash_attention']} times, want 2 x "
                f"{cfg.n_layers} x {cfg.microbatches} x {steps}")

    argv = ["--arch", "qwen2-0.5b", "--steps", str(steps), "--seq-len",
            str(run["seq_len"]), "--batch", str(run["batch"]), "--lr",
            str(run["lr"]), "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                                 # path (i) starts
    res = train_mod.run(argv)
    torch.cuda.synchronize()
    counts_i = _counts()                            # path (i) ends
    report("(i) launcher, default sync", res.losses, res.step_s,
                   torch.cuda.max_memory_allocated(), counts_i)
    if counts_i["fused_update"] != 0:
        raise AssertionError("the default sync launched kernel 5")

    adamw = opt.AdamWConfig(lr=run["lr"], moment_dtype=cfg.moment_dtype)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    n_buckets = len(tstep.plan_fused_buckets(tree_flatten(params)[0]))
    state = tstep.init_fused_opt_state(params)
    step = tstep.build_train_step(cfg, adamw=adamw, grad_rs="fused")
    pipe = SyntheticLM(cfg.vocab, run["seq_len"], run["batch"])
    losses, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                                 # path (ii) starts
    for s in range(steps):
        t0 = time.perf_counter()
        loss, params, state = step(params, state, pipe.batch(s))
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    counts_ii = _counts()                           # path (ii) ends
    report("(ii) fused sync", losses, walls,
                    torch.cuda.max_memory_allocated(), counts_ii)
    if counts_ii["fused_update"] != n_buckets * steps:
        raise AssertionError(f"kernel 5 launched {counts_ii['fused_update']} "
                             f"times, want {n_buckets} buckets x {steps}")
    log(f"  step-0 loss: launcher {res.losses[0]!r}, fused {losses[0]!r}; "
        f"{n_buckets} fused buckets of at most 64 MiB")
    del params, state
    torch.cuda.empty_cache()
    return dict(counts=[counts_i, counts_ii], params=res.params, opt_state=res.opt_state, adamw=adamw,
                batch=pipe.batch(steps), n_params=sum(
                    l.numel() for l in tree_flatten(res.params)[0]))


def same_grads_both_optimizers(torch, serving, trained) -> None:
    """6d: one gradient tree, computed once, through apply_updates and
    through fused_adam_sync (moments packed from the same state): the new
    parameters and moments bit for bit."""
    from repro_torch.core import heap
    from repro_torch.core.heap import tree_flatten
    from repro_torch.parallel import sharding
    from repro_torch.parallel.comm import Comm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as tstep
    cfg = serving.CONFIG
    params, state, adamw = (trained["params"], trained["opt_state"],
                            trained["adamw"])
    comm = Comm()
    batch = tstep.batch_to_device(trained["batch"], "cuda")
    _, grads = tstep.loss_and_grads(comm, cfg, params, batch,
                                    cfg.microbatches)
    leaves = tree_flatten(params)[0]
    buckets = tstep.plan_fused_buckets(leaves)
    specs = [heap.plan_pack([leaves[i] for i in idxs], dtype=torch.float32)
             for idxs in buckets]
    fstate = {"step": state["step"], "fused": [
        {key: heap.pack([state["mv"][i][key] for i in idxs], spec)
         for key in ("m", "v")} for idxs, spec in zip(buckets, specs)]}
    new_a, st_a = opt.apply_updates(params, grads, state, adamw)
    new_f, st_f = tstep.fused_adam_sync(
        comm, params, grads, fstate, adamw,
        sharding.needs_data_sync(cfg, params))
    torch.cuda.synchronize()
    for i, (a, f) in enumerate(zip(tree_flatten(new_a)[0],
                                   tree_flatten(new_f)[0])):
        bitwise(torch, f, a, f"6d param leaf {i}")
    for idxs, spec, mv in zip(buckets, specs, st_f["fused"]):
        for key in ("m", "v"):
            for i, val in zip(idxs, heap.unpack(mv[key], spec)):
                bitwise(torch, val, st_a["mv"][i][key], f"6d {key} {i}")
    log(f"  one gradient tree through apply_updates and fused_adam_sync: "
        f"{len(leaves)} params and their m, v bit for bit ({len(buckets)} "
        f"buckets, step {int(st_a['step'])})")


def grads_through_the_kernel(torch, np, serving, ref, layers) -> None:
    """6e: one microbatch at full width: the loss and every gradient leaf
    through the flash kernel (its Function's reference-recompute
    backward) against those through the plain attention, in f32 and
    bf16, each within GRAD_RTOL."""
    from repro_torch.core.heap import tree_flatten
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.parallel.comm import Comm
    from repro_torch.train import step as tstep
    cfg, run = serving.CONFIG, serving.TRAIN_RUN
    rows = run["batch"] // cfg.microbatches
    batch = {k: v[:rows] for k, v in
             SyntheticLM(cfg.vocab, run["seq_len"], run["batch"]).batch(0)
             .items()}
    batch = tstep.batch_to_device(batch, "cuda")
    params = transformer.init_params(cfg, seed=0, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, dtype=dtype)
        before = fa.launches
        loss_k, g_k = tstep.loss_and_grads(Comm(), c, params, batch)
        if fa.launches - before != 2 * cfg.n_layers:
            raise AssertionError("6e: the kernel path did not launch the "
                                 "kernel in every layer")
        with mock.patch.object(layers.kops, "attention", ref.attention_ref):
            loss_p, g_p = tstep.loss_and_grads(Comm(), c, params, batch)
        rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) for a, b in zip(tree_flatten(g_k)[0],
                                    tree_flatten(g_p)[0]))
        log(f"  grads through the kernel vs plain attention, {dtype}: loss "
            f"{float(loss_k):.6f} vs {float(loss_p):.6f} (rel {rel_loss:.3e})"
            f", worst leaf max|diff|/max|grad| {worst:.3e}")
        loss_tol, leaf_tol = GRAD_RTOL[str(dtype)]
        if not (rel_loss <= loss_tol and worst <= leaf_tol):
            raise AssertionError(f"6e {dtype}: loss rel {rel_loss} (tol "
                                 f"{loss_tol}), worst leaf {worst} (tol "
                                 f"{leaf_tol})")
        del g_k, g_p
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: serve mamba2-2.7b at full width — kernel 7, prefill, decode
# ---------------------------------------------------------------------------

# kernel 7 against ref.ssd_chunked_ref: y in f32 and the f32 state within
# tests/test_kernels.py's atol 2e-4, scaled by |want| where that is above
# 1 (model-scale values); y in bf16 within the larger of 3e-2 and one bf16
# step of |want| (phase 2's rule for a rounded output)
SSD_ATOL = 2e-4
# the prefill's last-position logits through kernel 7 against those
# through the plain version, relative to the largest logit, with f32
# compute: 1e-2.  In bf16 no such gate can tell a right kernel from a
# wrong one: the random-weight 64-layer stack amplifies each flipped bf16
# rounding of y.  A CPU probe at reduced width (d 256, L 1024; the plain
# version at chunk 128 against chunk 64, two f32 orders of the same sums)
# moved the bf16 logits by 1.1% of the largest at 4 layers, 3.2% at 16
# and 27% at 64, the f32 logits by 1.4e-5, 3.3e-5 and 4.8e-4.  So the
# bf16 prefill holds kernel 7 to the plain version layer by layer, on each
# layer's own inputs (the rule of 7a), and prints the end-to-end
# difference; the f32 prefill gates it at 20x the probe's reading
MAMBA_F32_LOGITS_RTOL = 1e-2


def ssd_inputs(torch, gen, b, seq, h, p, n, g, dtype, *, scale=0.3,
               model=False, h0=False):
    """x, dt, A, B, C, h0 on the card.  tests/test_kernels.py's draws (x,
    B, C at `scale`, dt in [0, 0.5), A in (-1.1, -0.1], h0 at 0.2), or
    with `model` the mamba2 layer's: A = -linspace(1, 16, H) (`a_log`'s
    init) and dt = softplus(N(0, 1)) (dt_bias 0)."""
    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s
    x = rnd(b, seq, h, p, s=scale).to(dtype)
    if model:
        dt = torch.nn.functional.softplus(rnd(b, seq, h))
        a = -torch.linspace(1.0, 16.0, h, device="cuda")
    else:
        dt = torch.rand(b, seq, h, generator=gen, device="cuda") * 0.5
        a = -torch.rand(h, generator=gen, device="cuda") - 0.1
    bm = rnd(b, seq, g, n, s=scale).to(dtype)
    cm = rnd(b, seq, g, n, s=scale).to(dtype)
    return x, dt, a, bm, cm, (rnd(b, h, p, n, s=0.2) if h0 else None)


def ssd_cases():
    """(label, B, L, H, P, N, G, chunk, dtype name, options)."""
    cases = []
    for dtype, scale in (("float32", 0.3), ("bfloat16", 1.0)):
        for seq, q in ((64, 16), (64, 64), (48, 16)):   # test_kernels
            for g in (1, 2):
                cases.append((f"tests_L{seq}q{q}", 2, seq, 4, 16, 8, g, q,
                              dtype, dict(scale=scale)))
        cases.append(("tests_h0", 1, 32, 2, 8, 4, 1, 8, dtype,
                      dict(scale=scale, h0=True)))
        cases.append(("ragged_L50q16", 2, 50, 4, 16, 8, 2, 16, dtype,
                      dict(scale=scale, h0=True)))
        cases.append(("ragged_L200q128", 1, 200, 8, 64, 128, 1, 128, dtype,
                      dict(scale=scale)))
        # the model's head shape and A, dt draws; "strided" slices x, B, C
        # out of one (B, L, H*P + 2*N) tensor, as mamba2 hands them over
        cases.append(("model_L4096", 1, 4096, 80, 64, 128, 1, 128, dtype,
                      dict(scale=scale, model=True)))
        cases.append(("model_strided", 1, 1024, 80, 64, 128, 1, 128, dtype,
                      dict(scale=scale, model=True, strided=True)))
    return cases


def ssd_over(torch, y, h, want_y, want_h):
    """(worst err/limit, max|err| of y, of the state, smallest y limit):
    y in bf16 within the larger of 3e-2 and one bf16 step of |want|, y in
    f32 and the f32 state within SSD_ATOL x max(1, |want|)."""
    dy = (y.float() - want_y.float()).abs()
    dh = (h - want_h).abs()
    if y.dtype == torch.bfloat16:
        lim_y = torch.maximum(torch.full_like(dy, TOL[str(y.dtype)]),
                              ulp(torch, want_y))
    else:
        lim_y = SSD_ATOL * want_y.float().abs().clamp_min(1.0)
    lim_h = SSD_ATOL * want_h.abs().clamp_min(1.0)
    over = max((dy / lim_y).max().item(), (dh / lim_h).max().item())
    return over, dy.max().item(), dh.max().item(), lim_y.min().item()


def check_ssd(torch, ops, ref, gen) -> float:
    """Kernel 7 through ops.ssd against the plain chunked version on the
    same inputs, each case within its limit, and each of its phases held
    to its plain form (`ssd_phases_over`); returns the worst err/limit.
    Then the sequential-scan oracle against the plain chunked version."""
    worst, worst_phase = check_ssd_cases(torch, ops, ref, gen, ssd_cases())
    x, dt, a, bm, cm, h0 = ssd_inputs(torch, gen, 2, 64, 4, 16, 8, 2,
                                      torch.float32, h0=True)
    ys, hs = ref.ssd_ref(x, dt, a, bm, cm, h0)
    yc, hc = ref.ssd_chunked_ref(x, dt, a, bm, cm, h0, chunk=16)
    err = max((ys - yc).abs().max().item(), (hs - hc).abs().max().item())
    log(f"  ssd_ref (sequential scan) vs ssd_chunked_ref, L64 Q16 G2 with "
        f"h0: max|err| {err:.3e} (atol {SSD_ATOL}); worst err/limit of the "
        f"kernel's y and state {worst:.3f}, of its phases {worst_phase:.3f}")
    if not err <= SSD_ATOL:
        raise AssertionError(f"ssd_ref vs ssd_chunked_ref: {err}")
    return worst


def check_ssd_cases(torch, ops, ref, gen, cases) -> tuple[float, float]:
    """Each case of `cases` (ssd_cases' tuples) through ops.ssd against
    the plain chunked version on its own inputs, and each of the kernel's
    phases against its plain form; returns the worst err/limit of y and
    the state, and of the phases."""
    worst = worst_phase = 0.0
    for label, b, seq, h, p, n, g, q, dtype, opt in cases:
        dt_ = getattr(torch, dtype)
        opt = dict(opt)
        strided = opt.pop("strided", False)
        x, dt, a, bm, cm, h0 = ssd_inputs(torch, gen, b, seq, h, p, n, g,
                                          dt_, **opt)
        if strided:
            fused = torch.cat([x.reshape(b, seq, h * p),
                               bm.reshape(b, seq, g * n),
                               cm.reshape(b, seq, g * n)], -1)
            x = fused[..., :h * p].reshape(b, seq, h, p)
            bm = fused[..., h * p:h * p + g * n].reshape(b, seq, g, n)
            cm = fused[..., h * p + g * n:].reshape(b, seq, g, n)
            assert not x.is_contiguous()
        y, hf = ops.ssd(x, dt, a, bm, cm, h0, chunk=q)
        want_y, want_h = ops._ssd_padded(x, dt, a, bm, cm, h0, q,
                                         ref.ssd_chunked_ref)
        torch.cuda.synchronize()
        if y.shape != want_y.shape or y.dtype != dt_ \
                or hf.dtype != torch.float32:
            raise AssertionError(f"ssd {label}: {y.shape}/{y.dtype}, state "
                                 f"{hf.dtype}")
        if not (torch.isfinite(y).all() and torch.isfinite(hf).all()):
            raise AssertionError(f"ssd {label} {dtype}: non-finite output")
        over, err_y, err_h, min_lim = ssd_over(torch, y, hf, want_y, want_h)
        typical = want_y.float().abs().mean().item()
        phases = ssd_phases_over(torch, ops, ref, x, dt, a, bm, cm, h0, q)
        log(f"  ssd {label:16s} {dtype:8s} B{b} L{seq} H{h} P{p} N{n} G{g} "
            f"Q{q}: max|err| y {err_y:.3e}, state {err_h:.3e} (worst "
            f"err/limit {over:.3f}, mean|y| {typical:.4f}); phases "
            + " ".join(f"{k} {v:.3f}" for k, v in phases.items()))
        if not over <= 1.0:
            raise AssertionError(f"ssd {label} {dtype}: err/limit {over}")
        for phase, v in phases.items():
            if not v <= 1.0:
                raise AssertionError(f"ssd {label} {dtype}: phase {phase} "
                                     f"err/limit {v}")
        worst_phase = max(worst_phase, max(phases.values()))
        if not typical > 10 * min_lim:
            raise AssertionError(f"ssd {label} {dtype}: mean|y| {typical} "
                                 f"is not far above the tolerance")
        worst = max(worst, over)
    return worst, worst_phase


def ssd_phases_over(torch, ops, ref, x, dt, a, bm, cm, h0, q) -> dict:
    """Kernel 7's phases, each held to its plain form on the kernel's own
    inputs to that phase, so that a fault names its phase: the cumsums s
    to `ref.ssd_chunk_states_ref`'s; the chunk states to the same
    function given the kernel's s; the entering and final states to
    `ref.ssd_state_passing_ref` on the kernel's chunk states and s; y to
    `ref.ssd_chunk_outputs_ref` on the kernel's s and entering states.  f32
    intermediates within SSD_ATOL x max(1, |want|), y within ssd_over's
    limit.  Returns {phase: worst err/limit}."""
    x, dt, bm, cm = ops._ssd_pad(x, dt, bm, cm, q)
    got = ops._ssd.ssd_scan_phases(x, dt, a, bm, cm, h0, chunk=q)
    s_want, _ = ref.ssd_chunk_states_ref(x, dt, a, bm, q)
    _, local = ref.ssd_chunk_states_ref(x, dt, a, bm, q, s=got["s"])
    entering, final = ref.ssd_state_passing_ref(got["chunk_states"],
                                                got["s"], h0)
    y = ref.ssd_chunk_outputs_ref(x, dt, bm, cm, got["s"], got["entering"],
                                  q)

    def f32_over(g_, w_):
        return ((g_ - w_).abs() / (SSD_ATOL * w_.abs().clamp_min(1.0))
                ).max().item()

    return {"s": f32_over(got["s"], s_want),
            "chunk states": f32_over(got["chunk_states"], local),
            "entering": f32_over(got["entering"], entering),
            "final": f32_over(got["final"], final),
            "y": ssd_over(torch, got["y"], final, y, final)[0]}


def ssd_counts(b, seq, h, p, n, g, q, itemsize) -> tuple[int, int]:
    """(bytes, products-ops) the SSD scan needs: x, dt, A, B, C read once,
    y and the f32 state written once; the products of the pairs u <= t the
    mask keeps, C B^T once per group (its heads share it), and per head
    the intra term, C @ state^T and the state update."""
    nbytes = (2 * b * seq * h * p * itemsize + b * seq * h * 4 + h * 4
              + 2 * b * seq * g * n * itemsize + b * h * p * n * 4)
    pairs = q * (q + 1) // 2
    per_chunk = 2 * n * pairs * g + h * (2 * p * pairs + 4 * q * n * p)
    return nbytes, b * (seq // q) * per_chunk


# one layer's scan in a 32768-token prefill: (Bt, L, H, P, N, G, chunk)
MAMBA_SSD_SHAPE = (1, 32768, 80, 64, 128, 1, 128)
ZAMBA_SSD_SHAPE = (1, 32768, 64, 64, 64, 1, 128)


def time_ssd(torch, kssd, ref, gen, shape=MAMBA_SSD_SHAPE) -> dict:
    """Kernel 7 at a prefill's shapes (one layer's scan; default the
    mamba2-2.7b prefill's): its C entry back to back (three CUDA kernels,
    timed alone by the profiler too), the wrapper (which allocates the
    scratch), and the plain version.  The bound is that of the arithmetic
    the kernel uses: the bf16 path's products on the tensor cores (the
    f32 CUDA-core figure beside it)."""
    b, seq, h, p, n, g, q = shape
    x, dt, a, bm, cm, _ = ssd_inputs(torch, gen, b, seq, h, p, n, g,
                                     torch.bfloat16, scale=1.0, model=True)
    y, hf = kssd.ssd_scan(x, dt, a, bm, cm, chunk=q)
    want_y, want_h = ref.ssd_chunked_ref(x, dt, a, bm, cm, chunk=q)
    err = (y.float() - want_y.float()).abs().max().item()
    lib = kssd._library()
    stream = torch.cuda.current_stream().cuda_stream
    states = torch.empty((b, seq // q, h, p, n), device="cuda")
    s_buf = torch.empty((b, seq // q, h, q), device="cuda")
    args = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), None, y.data_ptr(), hf.data_ptr(),
            states.data_ptr(), s_buf.data_ptr(), 1, b, seq, h, g, p, n, q, 3,
            x.stride(0), x.stride(1), bm.stride(0), bm.stride(1),
            cm.stride(0), cm.stride(1), stream)
    kernel_ms = time_ms(lambda: lib.repro_ssd_scan(*args), iters=20,
                        warmup=2)
    wrapper_ms = time_ms(lambda: kssd.ssd_scan(x, dt, a, bm, cm, chunk=q),
                         iters=20, warmup=2)
    plain_ms = time_ms(lambda: ref.ssd_chunked_ref(x, dt, a, bm, cm,
                                                   chunk=q),
                       iters=3, warmup=1)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(5):
            lib.repro_ssd_scan(*args)
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.key_averages():
        name = re.search(r"(chunk_state|state_pass|chunk_output)_kernel",
                         e.key)
        if name and e.device_time_total > 0:
            per_kernel[name.group(0)] = e.device_time_total / 1e3 / 5
    nbytes, ops_count = ssd_counts(b, seq, h, p, n, g, q, 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / PEAK_OPS_PER_S["torch.bfloat16"] * 1e3
    t_f32 = ops_count / PEAK_OPS_PER_S["torch.float32"] * 1e3
    full_q = b * (seq // q) * h * (2 * q * q * (n + p) + 4 * q * n * p)
    smem = {ph: lib.repro_ssd_scan_smem_bytes(p, n, q, 1, ph)
            for ph in (1, 3)}
    log(f"  times at B{b} L{seq} H{h} P{p} N{n} G{g} Q{q} bf16: kernel "
        f"{kernel_ms:.5f} ms (three CUDA kernels, by the profiler: "
        + ", ".join(f"{k} {v:.5f} ms" for k, v in per_kernel.items())
        + f"), wrapper {wrapper_ms:.5f} ms, plain {plain_ms:.5f} ms; "
        f"max|err| vs plain {err:.3e}; dynamic shared memory a block: "
        f"phase 1 {smem[1]} B, phase 3 {smem[3]} B")
    log(f"  bound {max(t_bytes, t_ops):.6f} ms ({nbytes} B = {t_bytes:.6f} "
        f"ms; {ops_count} products-ops = {t_ops:.6f} ms at the bf16 "
        f"tensor-core rate, {t_f32:.6f} ms at the f32 CUDA-core rate; the "
        f"full Q x Q per head is {full_q} = "
        f"{full_q / PEAK_OPS_PER_S['torch.float32'] * 1e3:.6f} ms at f32); "
        f"kernel at {max(t_bytes, t_ops) / kernel_ms:.2%} of it; scratch "
        f"{(states.numel() + s_buf.numel()) * 4} B of states and cumsums")
    log("  ssd_scan library_ms: none; no PyTorch call computes the SSD "
        "chunked scan (the plain version is a dozen einsum/cumsum/exp "
        "calls and a loop over the chunks)")
    del x, dt, bm, cm, y, hf, want_y, want_h, states, s_buf
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=kernel_ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, library_ms=None,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def serve_mamba(torch, np, mamba, ops, ref) -> dict:
    """7c: build_prefill on mamba2-2.7b at full width (seeded random
    weights, bf16 compute on f32 weights) over SERVE_RUN's prompt: 64
    ssd_scan launches and finite logits.  Then the same prefill through
    the plain version, kernel 7 held to it in every layer on the layer's
    own inputs, and the prefill in f32 compute through both, its logits
    within MAMBA_F32_LOGITS_RTOL of the largest.  Returns the launch counts
    of the path."""
    from repro_torch.core.heap import tree_flatten
    from repro_torch.models import transformer
    from repro_torch.serve import step as sstep
    cfg, run = mamba.CONFIG, mamba.SERVE_RUN
    params = transformer.init_params(cfg, seed=0, device="cuda")
    n_params = sum(w.numel() for w in tree_flatten(params)[0])
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(
        1, cfg.vocab, size=(run["prefill_batch"], run["prefill_len"])),
        device="cuda")
    prefill = sstep.build_prefill(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                                  # path starts
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()                               # path ends
    peak = torch.cuda.max_memory_allocated()
    log(f"  prefill {cfg.name} ({n_params} parameters, {cfg.n_layers} "
        f"layers, d {cfg.d_model}, vocab {cfg.vocab}), batch "
        f"{run['prefill_batch']} x L {run['prefill_len']}: wall {wall:.3f} s "
        f"({run['prefill_batch'] * run['prefill_len'] / wall:.1f} prompt "
        f"tok/s), peak memory {peak / 2**30:.3f} GiB, launches {counts}")
    if counts["ssd_scan"] != cfg.n_layers:
        raise AssertionError(f"ssd_scan launched {counts['ssd_scan']} times "
                             f"in the prefill, want {cfg.n_layers}")
    if logits.shape != (run["prefill_batch"], 1, cfg.vocab) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    # the same prefill through the plain version; each layer's kernel 7
    # output on that layer's inputs held to the plain output
    kernel_scan, layer_over = ops._ssd.ssd_scan, []

    def plain_and_kernel(x, dt, a, bm, cm, h0=None, *, chunk):
        want = ref.ssd_chunked_ref(x, dt, a, bm, cm, h0, chunk=chunk)
        got = kernel_scan(x, dt, a, bm, cm, h0, chunk=chunk)
        layer_over.append(ssd_over(torch, *got, *want)[0])
        return want

    t0 = time.perf_counter()
    with mock.patch.object(ops._ssd, "ssd_scan", plain_and_kernel):
        plain = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    both_wall = time.perf_counter() - t0
    err = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    log(f"  kernel 7 vs plain on each layer's inputs in the bf16 prefill: "
        f"{len(layer_over)} layers, worst err/limit {max(layer_over):.3f} "
        f"(first, middle, last layer: {layer_over[0]:.3f}, "
        f"{layer_over[len(layer_over) // 2]:.3f}, {layer_over[-1]:.3f}); "
        f"plain + kernel prefill wall "
        f"{both_wall:.3f} s")
    log(f"  bf16 prefill logits, kernel path vs plain path (not gated, see "
        f"MAMBA_F32_LOGITS_RTOL): max|err| {err:.4e}, max|logit| "
        f"{scale:.4f}, {err / scale / 2.0 ** -8:.2f} bf16 ulps of the "
        f"largest; argmax {int(logits.argmax())} vs {int(plain.argmax())}")
    if len(layer_over) != cfg.n_layers or not max(layer_over) <= 1.0:
        raise AssertionError(f"kernel 7 in the prefill's layers: "
                             f"{layer_over}")
    del logits, plain
    torch.cuda.empty_cache()
    prefill32 = sstep.build_prefill(dataclasses.replace(cfg,
                                                        dtype=torch.float32))
    t0 = time.perf_counter()
    logits = prefill32(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall32 = time.perf_counter() - t0
    with mock.patch.object(ops._ssd, "ssd_scan", ref.ssd_chunked_ref):
        plain = prefill32(params, {"tokens": tokens})
    err = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    log(f"  f32 prefill logits, kernel path vs plain path: max|err| "
        f"{err:.4e}, max|logit| {scale:.4f}, rel {err / scale:.3e} (tol "
        f"{MAMBA_F32_LOGITS_RTOL}); argmax {int(logits.argmax())} vs "
        f"{int(plain.argmax())}; kernel-path wall {wall32:.3f} s")
    if not (torch.isfinite(logits).all()
            and err <= MAMBA_F32_LOGITS_RTOL * scale):
        raise AssertionError(f"f32 prefill logits differ by {err} "
                             f"(max|logit| {scale})")
    del logits, plain, tokens, params
    torch.cuda.empty_cache()
    return counts


def decode_loop(torch, np, arch, cfg=None) -> None:
    """7d, 9d, 11b, 11c: `python -m repro_torch.launch.serve --arch
    <arch>` through its main() (the dense-cache decode loop at the
    reference's defaults; `arch` is the config module), or with `cfg` (a
    cut of arch's CONFIG, which no launcher flag names) the launcher's
    `_decode_loop` on it at those defaults; then the loop's logits at
    the last prompt position against build_prefill's on the same prompts
    and weights."""
    import argparse
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer
    from repro_torch.serve import step as sstep
    run = arch.SERVE_RUN
    seen = {}
    real = transformer.decode_step

    def spy(comm, cfg_, params_, cache, tokens, positions, **kw):
        logits, cache = real(comm, cfg_, params_, cache, tokens, positions,
                             **kw)
        step = seen.setdefault("steps", 0)
        if step == run["prompt_len"] - 1:
            seen.update(logits=logits.clone(), params=params_)
        seen["steps"] = step + 1
        return logits, cache

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(transformer, "decode_step", spy):
        if cfg is None:
            cfg = arch.CONFIG
            gen = launch_serve.main(["--arch", cfg.name])
        else:
            gen = launch_serve._decode_loop(cfg, torch.device("cuda"),
                                            argparse.Namespace(
                batch=run["batch"], prompt_len=run["prompt_len"],
                tokens=run["new_tokens"], cache_len=run["cache_len"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    want = (run["batch"], run["new_tokens"])
    entry = ("main" if cfg is arch.CONFIG
             else f"_decode_loop, {cfg.n_layers} layers")
    log(f"  decode loop (launch.serve {entry}, batch {run['batch']}, prompt "
        f"{run['prompt_len']}, {run['new_tokens']} tokens): tokens "
        f"{gen.shape}, wall {wall:.3f} s with the weights' init, "
        f"{gen.size / wall:.1f} tok/s, peak memory {peak / 2**30:.3f} GiB, "
        f"{seen['steps']} decode steps; first row {gen[0].tolist()}")
    if gen.shape != want or seen["steps"] != run["prompt_len"] \
            + run["new_tokens"] - 1:
        raise AssertionError(f"decode loop gave {gen.shape} in "
                             f"{seen['steps']} steps, want {want}")
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(run["batch"], run["prompt_len"]), dtype=np.int32)
    pre = sstep.build_prefill(cfg)(seen["params"], {"tokens": torch.as_tensor(
        prompts, device="cuda").long()})
    diff = (seen["logits"] - pre).abs().max().item()
    scale = pre.abs().max().item()
    log(f"  decode-loop logits at the last prompt position vs build_prefill"
        f"'s on the same prompts: max|diff| {diff:.4e}, max|logit| "
        f"{scale:.4f} (the one-step decode vs the full-sequence path in "
        f"bf16; the CPU test of the smoke config gates 0.12; in the moe "
        f"family a step routes at its own capacity, so they differ more)")
    if not np.isfinite(diff):
        raise AssertionError("decode-loop or prefill logits are not finite")
    seen.clear()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: sequence-sharded ring attention — kernel 6, the ring on 16 PEs
# ---------------------------------------------------------------------------

NEG_INF = -1e30
# 8a's limits, kernel 6 against its plain version on the same inputs: for
# a row that keeps a key, m within RING_M_RTOL x max(1, |m|) (a max logit
# near 0 has no relative precision left), l within RING_M_RTOL relative,
# acc within RING_ACC_TOL x max(1, l |v|max) (|acc| <= l |v|max); a row
# that keeps none: m exactly -1e30, l exactly the plain l (the count of
# the block's slots), acc within the same acc limit.  Then finalize of
# both within RING_OUT_ATOL (tests/test_fused.py's 2e-5, at D 16).  The m,
# l and finalize limits are for D 16 and grow as sqrt(D / 16): the logits
# are f32 dot products of D terms summed in two orders (the kernel's FMA
# chain, cuBLAS's GEMM), whose difference grows as sqrt(D), and l and the
# output inherit it.  The H100 run read, under the D-16 limits, worst l at
# 0.31, 0.50, 0.61 and 1.05 of the limit at D 16, 32, 64 and 128 (finalize
# 1.25 at D 128), masked rows exact everywhere.
RING_M_RTOL = 1e-5
RING_ACC_TOL = 2e-5
RING_OUT_ATOL = 2e-5
# the limits above hold blocks of up to this many keys (8b's ring step);
# at phase 19's 8192-key block the H100 read 1.45 of them (the sums of l
# and acc over 4x the keys, two f32 orders): the limits of the sums grow
# as sqrt(Lk / RING_LIMIT_LK) above it, the rounding of a sum of Lk terms
RING_LIMIT_LK = 2048


def ring_positions(torch, gen, layout, p, lq, lk, step=0):
    """(q_pos (P, Lq), k_pos (P, Lk)) int32 on the card.  "ring": PE p's
    queries at p*Lq.., its block from PE (p - step) % P at src*Lk.. (a
    ring step: past, diagonal and future blocks side by side); "future":
    every key after every query (wholly masked under causal); "kept":
    every key before every query (wholly kept under causal); "partly":
    keys from the middle of the query rows on (the early rows keep
    nothing); "late": a ring step with each block's keys in falling
    order, so a row keeps its first key after masked tiles; "pad": a ring
    step with ~15% of the key slots at -1; "shard": a ring step whose
    last PE holds a short shard, its last third of query and key slots at
    -1."""
    pe = torch.arange(p, device="cuda")[:, None]
    q_pos = pe * lq + torch.arange(lq, device="cuda")
    src = (pe - step) % p
    k_pos = src * lk + torch.arange(lk, device="cuda")
    if layout == "future":
        k_pos = k_pos + p * lq + 7
    elif layout == "kept":
        q_pos = q_pos + p * lk
    elif layout == "partly":
        k_pos = q_pos[:, :1] + lq // 2 + torch.arange(lk, device="cuda")
    elif layout == "late":
        k_pos = k_pos.flip(1)
    elif layout == "pad":
        drop = torch.rand((p, lk), generator=gen, device="cuda") < 0.15
        k_pos = torch.where(drop, torch.full_like(k_pos, -1), k_pos)
    elif layout == "shard":
        q_pos[-1, -(lq // 3):] = -1
        k_pos[src[:, 0] == p - 1, -(lk // 3):] = -1
    return q_pos.to(torch.int32), k_pos.to(torch.int32)


RING_DIMS = (16, 32, 64, 80, 120, 128, 256)


def ring_cases():
    """(label, P, B, Hkv, group, Lq, Lk, layout, step, kwargs); each runs
    at RING_DIMS in f32 and bf16."""
    causal = dict(causal=True)
    return [
        ("ring16", 16, 1, 2, 7, 64, 64, "ring", 5, causal),
        ("diag1", 1, 2, 2, 1, 100, 100, "ring", 0, causal),
        ("noncausal4", 4, 2, 2, 7, 37, 70, "ring", 1,
         dict(causal=False)),
        ("window4", 4, 2, 2, 1, 96, 96, "ring", 1,
         dict(causal=True, window=40)),
        ("softcap4", 4, 1, 2, 7, 50, 50, "ring", 3,
         dict(causal=True, softcap=30.0)),
        ("future4", 4, 2, 2, 1, 33, 65, "future", 0, causal),
        ("partly1", 1, 2, 2, 7, 64, 64, "partly", 0, causal),
        ("pad4", 4, 2, 2, 7, 40, 45, "pad", 1,
         dict(causal=True, window=30, softcap=50.0)),
        ("late4", 4, 1, 2, 7, 130, 200, "late", 0, causal),
        ("shard4", 4, 1, 2, 1, 150, 150, "shard", 1,
         dict(causal=True, window=100)),
    ]


def ring_over(torch, got, want, vmax, lk: int = RING_LIMIT_LK
              ) -> tuple[dict, int, int]:
    """({component: worst err/limit} of acc, m, l and their finalize, rows
    that keep a key, rows that keep none) under 8a's limits; a row that
    keeps none counts as inf under "masked" unless its m and l equal the
    plain version's exactly.  Blocks of `lk` > RING_LIMIT_LK keys: the
    limits of the sums over the keys (acc, l, finalize) grow as sqrt(lk /
    RING_LIMIT_LK)."""
    acc, m, l = got
    racc, rm, rl = want
    grow = math.sqrt(acc.shape[-1] / 16)
    sums = math.sqrt(max(1.0, lk / RING_LIMIT_LK))
    kept = rm > NEG_INF
    none = ~kept
    exact = torch.equal(m[none], rm[none]) and torch.equal(l[none], rl[none])
    lim_acc = sums * RING_ACC_TOL * (rl * vmax).clamp_min(1.0)[..., None]
    over = {"masked": 0.0 if exact else math.inf,
            "acc": ((acc - racc).abs() / lim_acc).max().item()}
    if kept.any():
        over["m"] = ((m - rm).abs()[kept]
                     / (grow * RING_M_RTOL * rm.abs()[kept].clamp_min(1.0))
                     ).max().item()
        over["l"] = ((l - rl).abs()[kept]
                     / (sums * grow * RING_M_RTOL * rl[kept])).max().item()
    over["finalize"] = (acc / l.clamp_min(1e-30)[..., None]
                        - racc / rl.clamp_min(1e-30)[..., None]
                        ).abs().max().item() / (sums * grow * RING_OUT_ATOL)
    return over, int(kept.sum()), int(none.sum())


def check_ring_partials(torch, ra, ref, gen) -> float:
    """8a: kernel 6 against `ref.ring_partials_ref` on the same inputs over
    ring_cases() x D x dtype; every case is checked and printed before a
    failure is raised.  Returns the worst err/limit."""
    worst, bad, rows = 0.0, [], [0, 0]
    for label, p, b, hkv, group, lq, lk, layout, step, kw in ring_cases():
        for d in RING_DIMS:
            for dtype in ("float32", "bfloat16"):
                dt = getattr(torch, dtype)
                q, k, v = attention_inputs(torch, gen, p * b, hkv * group,
                                           hkv, lq, lk, d, dt)
                q, k, v = (x.reshape((p, b) + tuple(x.shape[1:]))
                           for x in (q, k, v))
                q_pos, k_pos = ring_positions(torch, gen, layout, p, lq, lk,
                                              step)
                got = ra.attn_block_partials(q, k, v, q_pos, k_pos, **kw)
                want = ref.ring_partials_ref(q, k, v, q_pos, k_pos, **kw)
                torch.cuda.synchronize()
                if any(g.shape != w.shape or g.dtype != torch.float32
                       or not torch.isfinite(g).all()
                       for g, w in zip(got, want)):
                    bad.append(f"{label} D{d} {dtype}: shape/dtype/finite")
                    continue
                parts, kept, none = ring_over(torch, got, want,
                                              v.float().abs().max().item())
                over = max(parts.values())
                rows[0] += kept
                rows[1] += none
                worst = max(worst, over)
                log(f"  ring partials {label:10s} D{d:<3d} {dtype:8s} P{p} "
                    f"B{b} Hq{hkv * group} Hkv{hkv} Lq{lq} Lk{lk} {layout} "
                    f"{kw}: err/limit "
                    + " ".join(f"{c} {x:.3f}" for c, x in parts.items())
                    + f"; rows keeping a key {kept}, keeping none {none}")
                if not over <= 1.0:
                    bad.append(f"{label} D{d} {dtype}: err/limit {over}")
    log(f"  kernel 6 vs plain: {len(ring_cases()) * len(RING_DIMS) * 2} "
        f"cases, worst "
        f"err/limit {worst:.3f}; rows keeping a key {rows[0]}, wholly "
        f"masked {rows[1]}")
    if bad or not (rows[0] and rows[1]):
        raise AssertionError(f"ring partials: {bad or rows}")
    return worst


def ring_block_counts(p, b, hq, hkv, lq, lk, d, itemsize, pairs):
    """(bytes, products-ops) of one partials call: q, k, v and both
    position tables read once, acc, m and l written once; 4 D operations
    for each kept query-key pair."""
    nbytes = (p * b * (hq * lq + 2 * hkv * lk) * d * itemsize
              + 4 * p * (lq + lk) + 4 * p * b * hq * lq * (d + 2))
    return nbytes, 4 * d * pairs * b * hq


# 8b's shape: the ring step of phase 8 (P, B, Hq, Hkv, Lq, Lk, D)
RING_STEP_SHAPE = (16, 1, 14, 2, 2048, 2048, 64)


def time_ring_partials(torch, ra, ref, gen, card, shape=RING_STEP_SHAPE,
                       dtype="bfloat16") -> dict:
    """8b: kernel 6 at the ring step's shape (16 PEs, B 1, Hq 14, Hkv 2,
    Lq = Lk = 2048, D 64, bf16, causal; or `shape` and `dtype`) on three
    blocks: the diagonal one (each PE its own block, the ring's first
    step), one wholly kept (every key before every query) and one wholly
    masked (every key after every query).  Each: its C entry back to
    back, the wrapper, the plain version, and
    scaled_dot_product_attention over the same PEs with the block's
    boolean mask (a yardstick of the work: it computes the normalised
    output, not (acc, m, l)), beside its own bound.  Returns the diagonal
    block's, with the others under their names."""
    import torch.nn.functional as F
    p, b, hq, hkv, lq, lk, d = shape
    dt = getattr(torch, dtype)
    itemsize = torch.finfo(dt).bits // 8
    q, k, v = attention_inputs(torch, gen, p * b, hq, hkv, lq, lk, d, dt)
    q, k, v = (x.reshape((p, b) + tuple(x.shape[1:])) for x in (q, k, v))
    if ra.tensor_core_route(q, k, v) != (dt == torch.bfloat16):
        raise AssertionError(f"kernel 6 at {shape} {dtype} is not on the "
                             f"tensor cores in bf16 (CUDA cores in f32)")
    scale = 1.0 / math.sqrt(d)
    lib = ra._library()
    stream = torch.cuda.current_stream().cuda_stream
    vsum = torch.empty((p * b * hkv, d), dtype=torch.float32, device="cuda")
    bounds = torch.empty((p, -(-lk // ra.BK), 4), dtype=torch.int32,
                         device="cuda")
    f32 = PEAK_OPS_PER_S["torch.float32"]
    got = {}
    for block, layout in (("diagonal", "ring"), ("kept", "kept"),
                          ("masked", "future")):
        q_pos, k_pos = ring_positions(torch, gen, layout, p, lq, lk, 0)
        res = ra.attn_block_partials(q, k, v, q_pos, k_pos, causal=True)
        want = ref.ring_partials_ref(q, k, v, q_pos, k_pos, causal=True)
        parts = ring_over(torch, res, want, v.float().abs().max().item(),
                          lk)[0]
        over = max(parts.values())
        err = max((g - w).abs().max().item() for g, w in zip(res, want))
        if not over <= 1.0:
            raise AssertionError(f"ring partials at {shape} {dtype}, {block} "
                                 f"block: err/limit {parts}")
        acc, m, l = res
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                k_pos.data_ptr(), acc.data_ptr(), m.data_ptr(),
                l.data_ptr(), vsum.data_ptr(), bounds.data_ptr(),
                ra._DTYPES[dt], p, b, hq, hkv, lq, lk, d, 1, 0, 0.0, scale,
                stream)
        kernel_ms = time_ms(lambda: lib.repro_ring_partials(*args),
                            iters=20, warmup=3)
        wrapper_ms = time_ms(lambda: ra.attn_block_partials(
            q, k, v, q_pos, k_pos, causal=True), iters=20, warmup=3)
        plain_ms = time_ms(lambda: ref.ring_partials_ref(
            q, k, v, q_pos, k_pos, causal=True), iters=3, warmup=1)
        mask = (k_pos[:, None, :] <= q_pos[:, :, None])[:, None]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q[:, 0], k[:, 0], v[:, 0], attn_mask=mask, scale=scale,
            enable_gqa=True)
        library_ms = time_ms(sdpa, iters=10, warmup=2)
        pairs = int(mask.sum().item())
        if pairs:
            nbytes, ops_count = ring_block_counts(p, b, hq, hkv, lq, lk, d,
                                                  itemsize, pairs)
            sdpa_err = (sdpa().float() - (acc / l[..., None])[:, 0]
                        ).abs().max().item()
        else:
            # no kept pair: the function needs v (its sum), the positions,
            # and writes acc, m and l; q and k are never read
            nbytes = (p * b * hkv * lk * d * itemsize + 4 * p * (lq + lk)
                      + 4 * p * b * hq * lq * (d + 2))
            ops_count, sdpa_err = 0, float("nan")
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops_count / PEAK_OPS_PER_S[str(dt)] * 1e3
        bound = max(t_bytes, t_ops)
        log(f"  times at P{p} B{b} Hq{hq} Hkv{hkv} Lq{lq} Lk{lk} D{d} "
            f"{dtype} causal, {block} block ({card}): err/limit vs plain "
            + " ".join(f"{c_} {x_:.3f}" for c_, x_ in parts.items())
            + f"; kernel {kernel_ms:.5f} ms, "
            f"wrapper {wrapper_ms:.5f} ms, plain {plain_ms:.5f} ms, sdpa "
            f"with the block mask {library_ms:.5f} ms (sdpa max|err| vs the "
            f"kernel's acc/l {sdpa_err:.3e}); max|err| vs plain {err:.3e}; "
            f"bound {bound:.6f} ms by {'bytes' if t_bytes >= t_ops else 'operations'} "
            f"({nbytes} B = {t_bytes:.6f} ms; {ops_count} products-ops of "
            f"the {pairs} kept pairs = {t_ops:.6f} ms at the {dtype} "
            f"rate, {ops_count / f32 * 1e3:.6f} ms at the f32 rate); "
            f"kernel at {bound / kernel_ms:.1%} of its bound")
        got[block] = dict(max_abs_err=err, ms=kernel_ms,
                          wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound,
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations")
        del acc, m, l, res, want, mask
    every = 4 * d * p * b * hq * lq * lk
    log(f"  the causal ring of {p} steps holds {p} diagonal, "
        f"{p * (p - 1) // 2} kept and {p * (p - 1) // 2} masked PE-blocks; "
        f"computing every tile of every block, as the TPU kernel does, "
        f"would be {p * every} ops")
    del q, k, v
    torch.cuda.empty_cache()
    return dict(got["diagonal"], kept=got["kept"], masked=got["masked"])


def _shard_seq(x, n):
    """(B, H, L, D) -> (n, B, H, L/n, D), contiguous: PE p holds rows
    [p L/n, (p+1) L/n)."""
    b, h, length, d = x.shape
    return x.reshape(b, h, n, length // n, d).permute(2, 0, 1, 3, 4) \
        .contiguous()


def _unshard_seq(x):
    n, b, h, ls, d = x.shape
    return x.permute(1, 2, 0, 3, 4).reshape(b, h, n * ls, d)


def bf16_over(torch, got, want) -> float:
    """Worst |got - want| over the larger of 2e-5 and one step of want's
    dtype at |want| (phase 2's rule)."""
    diff = (got.float() - want.float()).abs()
    limit = torch.maximum(torch.full_like(diff, RING_OUT_ATOL),
                          ulp(torch, want))
    return (diff / limit).max().item()


def ring_path(torch, np, serving, ra, ref, ops, fa, card) -> list:
    """8c: qwen2-0.5b's layer-0 q, k, v (seeded weights, bf16, after the
    projections and RoPE) over RING_RUN's 32768-token prompt, sharded over
    16 PEs, through fusion.ring_attention on the plain and the NoC SIM:
    16 kernel-6 launches and 3 x 15 puts each; the output against kernel
    4 over the gathered sequence and against the same ring through the
    plain partials; the mono alternative (fcollect of k and v, then
    kernel 4) timed; the merged f32 (acc, m, l) of the kernel ring and the
    plain-partials ring held to each other under 8a's limits; then a
    window of 4096 and a softcap of 50.  Returns the launch counts of
    each run."""
    from repro_torch.core import abmodel, fusion, sim_ctx
    from repro_torch.core import collectives as coll
    from repro_torch.core.pattern import ring_pattern
    from repro_torch.models import layers as L
    from repro_torch.models import transformer
    from repro_torch.parallel.comm import Comm
    cfg, run = serving.CONFIG, serving.RING_RUN
    n, topo, seq = run["n_pes"], run["topology"], run["seq_len"]
    params = transformer.init_params(cfg, seed=0, device="cuda")
    bp = params["layers"][run["layer"]]
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab, size=(run["batch"], seq)), device="cuda")
    positions = torch.arange(seq, device="cuda").expand(run["batch"], seq)
    with torch.no_grad():
        h = L.rms_norm(L.embed(Comm(), cfg, params["embed"], tokens),
                       bp["ln1"])
        q, k, v = L.attention_qkv(cfg, bp["attn"], h, positions)
    del params, h
    qs, ks, vs = (_shard_seq(x, n) for x in (q, k, v))
    pos = torch.arange(seq, dtype=torch.int32, device="cuda").reshape(n, -1)
    waves = len(ring_pattern(n).link_waves(topo))
    counts, outs, walls = [], {}, {}

    def ring(noc, **kw):
        ctx = sim_ctx(n, topo, noc=noc, device="cuda")
        torch.cuda.synchronize()
        _reset_counts()                                 # path starts
        t0 = time.perf_counter()
        out = fusion.ring_attention(ctx, qs, ks, vs, pos, pos, causal=True,
                                    **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _counts()                                 # path ends
        want = {"flash_attention": 0, "put_copy": 3 * (n - 1),
                "dma_copy": 0, "fused_update": 0, "ssd_scan": 0,
                "reduce_combine": 3 * (n - 1) if noc and waves > 1 else 0,
                "ring_attention": n, "paged_decode": 0}
        if got != want:
            raise AssertionError(f"ring noc={noc} {kw}: launches {got}, the "
                                 f"code implies {want}")
        counts.append(got)
        return out, wall

    def plain_partials(q_, k_, v_, qp_, kp_, **kw):
        return ref.ring_partials_ref(q_, k_, v_, qp_, kp_, **kw)

    kernel_partials, real_finalize = ra.attn_block_partials, ra.finalize

    def ring_through(partials, **kw):
        """The ring on the plain SIM with `partials` in kernel 6's place:
        (its output, the merged (acc, m, l) it hands to finalize)."""
        seen = []

        def capture(state, dtype=None):
            seen.append(state)
            return real_finalize(state, dtype)

        with mock.patch.object(ra, "attn_block_partials", partials), \
                mock.patch.object(ra, "finalize", capture):
            out = fusion.ring_attention(ctx, qs, ks, vs, pos, pos,
                                        causal=True, **kw)
        return _unshard_seq(out), seen[0]

    def states_over(**kw):
        """8a's limits (ring_over) on the merged states of the ring
        through kernel 6 and through the plain partials: the f32 check of
        the full-size ring that one bf16 step of the output cannot make.
        Returns (the plain ring's output, {component: err/limit})."""
        _, got = ring_through(kernel_partials, **kw)
        plain, want = ring_through(plain_partials, **kw)
        parts, _, none = ring_over(torch, got, want,
                                   vs.float().abs().max().item())
        if none or not all(torch.isfinite(x).all() for x in got):
            raise AssertionError(f"ring {kw}: {none} rows keep no key, or "
                                 f"the merged state is not finite")
        return plain, parts

    torch.cuda.reset_peak_memory_stats()
    for noc in (False, True):
        outs[noc], walls[f"ring noc={noc}"] = ring(noc)
    peak = torch.cuda.max_memory_allocated()
    if not torch.equal(outs[False], outs[True]):
        raise AssertionError("ring on the NoC SIM != ring on the plain SIM")
    # mono: fcollect of k and v (each PE then holds the whole sequence),
    # then kernel 4 over the gathered sequence: every PE's query rows in
    # one launch against PE 0's copy (all copies are equal)
    ctx = sim_ctx(n, topo, device="cuda")
    torch.cuda.synchronize()
    _reset_counts()                                     # mono starts
    t0 = time.perf_counter()
    kf = ctx.fcollect(ks, axis=2)
    vf = ctx.fcollect(vs, axis=2)
    mono = ops.attention(q, kf[0], vf[0], causal=True)
    torch.cuda.synchronize()
    walls["mono"] = time.perf_counter() - t0
    mono_counts = _counts()                             # mono ends
    stages = len(coll.fcollect_schedule(n, 0.0, "rd").stages)
    want = dict({name: 0 for name in mono_counts}, put_copy=2 * stages,
                dma_copy=2, flash_attention=1)
    if mono_counts != want or not (torch.equal(kf[0], k)
                                   and torch.equal(vf[0], v)):
        raise AssertionError(f"mono: launches {mono_counts} (want {want}) "
                             f"or fcollect is not the sequence")
    counts.append(mono_counts)
    got = _unshard_seq(outs[False])
    over_mono = bf16_over(torch, got, mono)
    plain, states = states_over()
    over_plain = bf16_over(torch, got, plain)
    log(f"  ring over {n} PEs ({topo.shape} mesh, {waves} NoC waves per "
        f"rotation) of {cfg.name} layer {run['layer']}'s q {tuple(q.shape)}"
        f" k {tuple(k.shape)} bf16, causal: err/limit vs kernel 4 on the "
        f"gathered sequence {over_mono:.3f}, vs the ring through the plain "
        f"partials {over_plain:.3f} (limit max(2e-5, 1 bf16 step)); merged "
        f"f32 states vs the plain-partials ring under 8a's limits: "
        + " ".join(f"{c} {x:.3f}" for c, x in states.items())
        + f"; NoC ring == plain-SIM ring bit for bit; launches {counts[0]} "
        f"(plain SIM), {counts[1]} (NoC), mono {mono_counts}")
    if not (over_mono <= 1.0 and over_plain <= 1.0
            and max(states.values()) <= 1.0):
        raise AssertionError(f"ring output: err/limit {over_mono} vs mono, "
                             f"{over_plain} vs plain partials, merged "
                             f"states {states}")
    # gemma2-9b's local window and attention softcap on qwen2's geometry
    kw = dict(window=4096, softcap=50.0)
    out, walls["ring window+softcap"] = ring(False, **kw)
    got = _unshard_seq(out)
    mono_ws = ops.attention(q, k, v, causal=True, **kw)
    plain, states = states_over(**kw)
    over_ws = (bf16_over(torch, got, mono_ws), bf16_over(torch, got, plain))
    log(f"  ring with window 4096 and softcap 50: err/limit vs kernel 4 "
        f"{over_ws[0]:.3f}, vs the plain partials {over_ws[1]:.3f}; merged "
        f"f32 states under 8a's limits: "
        + " ".join(f"{c} {x:.3f}" for c, x in states.items())
        + f"; launches {counts[-1]}")
    if not (max(over_ws) <= 1.0 and max(states.values()) <= 1.0):
        raise AssertionError(f"ring window+softcap: err/limit {over_ws}, "
                             f"merged states {states}")
    # kernel 4 alone at the gathered shape (row 4's long reading)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    lib = fa._library()
    b, hq, _, d = q.shape
    args = (qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), mono.data_ptr(), 1,
            b, hq, k.shape[1], seq, seq, d, d, seq, 1, 0, 0.0,
            1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    k4_ms = time_ms(lambda: lib.repro_flash_attention_fwd(*args), iters=3,
                    warmup=1)
    # SDPA at the same shape: a yardstick the port never calls, on a fused
    # backend only (the math backend would form 60 GB of logits)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qc, kc, vc, is_causal=True, enable_gqa=True)

    with sdpa_kernel(fused):
        sdpa_diff = (sdpa().float() - mono.float()).abs().max().item()
        sdpa_ms = time_ms(sdpa, iters=3, warmup=1)
    pairs = seq * (seq + 1) // 2
    k4_bytes = (2 * qc.numel() + kc.numel() + vc.numel()) * 2
    k4_ops = 4 * d * pairs * b * hq
    k4_bound = max(k4_bytes / HBM_BYTES_PER_S, k4_ops /
                   PEAK_OPS_PER_S["torch.bfloat16"]) * 1e3
    # choose_attention at the measured per-block time, t_mono / n, as
    # benchmarks/bench_fused.py reckons it
    kv_bytes = (ks[0].numel() + vs[0].numel()) * ks.element_size() \
        + pos[0].numel() * pos.element_size()
    picks = {"default link": fusion.choose_attention(
        n, kv_bytes, walls["mono"] / n),
        "epiphany16 board": fusion.choose_attention(
            n, kv_bytes, walls["mono"] / n, topo=topo,
            link=abmodel.EPIPHANY_NOC)}
    log(f"  walls ({card}; host clock, ending in synchronize): "
        + ", ".join(f"{name} {w * 1e3:.3f} ms" for name, w in walls.items())
        + f"; peak device memory of the two rings {peak / 2**30:.3f} GiB")
    log(f"  kernel 4 at B{b} Hq{hq} Hkv{k.shape[1]} L{seq} D{d} bf16 causal "
        f"(the gathered sequence; {card}): {k4_ms:.5f} ms; bound "
        f"{k4_bound:.6f} ms "
        f"({k4_bytes} B, {k4_ops} ops of the {pairs} kept pairs at the "
        f"bf16 rate; {k4_ops / PEAK_OPS_PER_S['torch.float32'] * 1e3:.6f} "
        f"ms at the f32 rate); scaled_dot_product_attention (causal, "
        f"enable_gqa, fused backends) {sdpa_ms:.5f} ms, max|diff| vs "
        f"kernel 4 {sdpa_diff:.3e}")
    log(f"  choose_attention(n={n}, kv_block_bytes={kv_bytes}, "
        f"block_compute_s=t_mono/{n}={walls['mono'] / n:.6f}): "
        + "; ".join(f"{where}: pick {pick}, modeled ring "
                    f"{times['ring'] * 1e3:.6f} ms, mono "
                    f"{times['mono'] * 1e3:.6f} ms"
                    for where, (pick, times) in picks.items()))
    del q, k, v, qs, ks, vs, kf, vf, mono, mono_ws, plain, outs, qc, kc, vc
    torch.cuda.empty_cache()
    return counts, {"n": n, "topo": topo, "kv_bytes": kv_bytes,
                    "block_s": walls["mono"] / n,
                    "ring_s": walls["ring noc=False"],
                    "mono_s": walls["mono"]}


# ---------------------------------------------------------------------------
# phase 9: serve zamba2-1.2b at full width — kernels 4 and 7, prefill, decode
# ---------------------------------------------------------------------------

# the f32 prefill's last-position logits through kernels 4 and 7 against
# those through their plain versions, relative to the largest logit: the
# limit of MAMBA_F32_LOGITS_RTOL, for the same reason.  zamba2 stacks 38
# Mamba2 layers, fewer than the 64 of the probe behind that limit (f32
# logits moved by 4.8e-4 of the largest at 64 layers), and its 7 shared
# attention blocks add kernel 4's f32 difference from the plain version,
# within 3e-5 of the output (phase 2's f32 limit), at each application
ZAMBA_F32_LOGITS_RTOL = MAMBA_F32_LOGITS_RTOL
# the plain attention over a 32768-token prompt is built this many query
# rows at a time, for up to 32 heads (proportionally fewer for more): the
# f32 logits of all rows at once would be 137 GB at zamba2's 32 heads,
# those of one block of rows at most 4.3 GB
PLAIN_ROWS = 1024
# the full-width prefills of phases 10-13 hold kernel 4 to the blockwise
# plain version on the calls i with i % 8 in (0, 1): a layer's attention
# shape repeats through the stack, and gemma2's local and global layers
# alternate, so both of its shapes are held; a quarter of the plain
# version's cost (0.12-2.3 s a call), to leave room for phase 23's traces
# under the time limit
PREFILL_HELD = (8, 2)
# kernel 4 at zamba2's attention shape (B, heads, L, D): 32 q heads over
# 32 KV heads (a group of 1), bf16, causal; held at 4096 tokens, timed at
# the prefill's 32768
ZAMBA_ATTN = (1, 32, 4096, 64)


def zamba_ssd_cases():
    """Kernel 7 at zamba2's head shape (H 64, P 64, N 64, chunk 128; the
    model's A and dt draws), contiguous and as the strided views `mamba2`
    hands over, in f32 and bf16 (ssd_cases' tuples)."""
    cases = []
    for dtype, scale in (("float32", 0.3), ("bfloat16", 1.0)):
        cases.append(("zamba_L4096", 1, 4096, 64, 64, 64, 1, 128, dtype,
                      dict(scale=scale, model=True)))
        cases.append(("zamba_strided", 1, 1024, 64, 64, 64, 1, 128, dtype,
                      dict(scale=scale, model=True, strided=True)))
    return cases


def blockwise_attention(torch, ref, ra, q, k, v, *, causal=True,
                        window=None, softcap=None, sm_scale=None,
                        lk_valid=None):
    """The plain attention of q (B, Hq, Lq, D) over k, v (kernel 4's
    function, query row i at position i and key j at j), built PLAIN_ROWS
    query rows at a time (fewer above 32 heads): `ref.ring_partials_ref`
    of the block against the keys up to its last row (a causal row keeps
    none past itself) and, under a window, from its first row's first
    kept key on, by global positions, keys at or past `lk_valid` marked
    -1, then `finalize` in q's dtype.  Its probabilities stay in f32."""
    lq, lk = q.shape[2], k.shape[2]
    lk_valid = lk if lk_valid is None else lk_valid
    rows = PLAIN_ROWS * 32 // max(32, q.shape[1])
    pos = torch.arange(max(lq, lk), dtype=torch.int32, device=q.device)
    k_pos = torch.where(pos[:lk] < lk_valid, pos[:lk], -1)
    out = torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype,
                      device=q.device)
    for r0 in range(0, lq, rows):
        r1 = min(lq, r0 + rows)
        hi = min(lk, r1) if causal else lk
        lo = max(0, r0 - window + 1) if window is not None else 0
        state = ref.ring_partials_ref(
            q[:, :, r0:r1], k[:, :, lo:hi], v[:, :, lo:hi], pos[r0:r1],
            k_pos[lo:hi], causal=causal, window=window, softcap=softcap,
            sm_scale=sm_scale)
        out[:, :, r0:r1] = ra.finalize(state, q.dtype)
        del state
    return out


def check_zamba_kernels(torch, ops, ref, fa, ra, gen) -> None:
    """9a: kernel 7 at zamba2's head shape (zamba_ssd_cases, each phase
    on its own inputs, as 7a), and kernel 4 at ZAMBA_ATTN against
    `ref.attention_ref` (phase 2's limits) and against
    `blockwise_attention`, the plain version 9c holds it to at 32768
    tokens."""
    worst, worst_phase = check_ssd_cases(torch, ops, ref, gen,
                                         zamba_ssd_cases())
    log(f"  ssd at zamba2's H 64, P 64, N 64: worst err/limit of y and the "
        f"state {worst:.3f}, of the phases {worst_phase:.3f}")
    b, h, seq, d = ZAMBA_ATTN
    dt = torch.bfloat16
    q, k, v = attention_inputs(torch, gen, b, h, h, seq, seq, d, dt)
    out = ops.attention(q, k, v, causal=True)
    want = plain_attention(torch, ref, q, k, v, causal=True)
    blocks = blockwise_attention(torch, ref, ra, q, k, v, causal=True)
    torch.cuda.synchronize()
    err, over = attention_over(torch, out, want, dt)
    err_b, over_b = attention_over(torch, out, blocks, dt)
    gap = (blocks.float() - want.float()).abs().max().item()
    route = "tensor cores" if fa.tensor_core_route(q, k, v) \
        else "CUDA cores"
    typical = want.float().abs().mean().item()
    log(f"  attention zamba2 B{b} Hq{h} Hkv{h} L{seq} D{d} bf16 causal "
        f"({route}): vs attention_ref max|err| {err:.3e} (worst err/limit "
        f"{over:.3f}), vs the blockwise plain version {err_b:.3e} "
        f"({over_b:.3f}); blockwise vs attention_ref {gap:.3e} (f32 against "
        f"bf16 probabilities); mean|out| {typical:.3f}")
    if route != "tensor cores":
        raise AssertionError("kernel 4 at zamba2's shape did not take the "
                             "tensor cores")
    if not (over <= 1.0 and over_b <= 1.0 and torch.isfinite(out).all()):
        raise AssertionError(f"kernel 4 at zamba2's shape: err/limit {over}"
                             f" vs attention_ref, {over_b} vs blockwise")
    if not typical > 10 * TOL[str(dt)]:
        raise AssertionError(f"kernel 4 at zamba2's shape: mean|out| "
                             f"{typical} is not far above the tolerance")
    del q, k, v, out, want, blocks
    torch.cuda.empty_cache()


def time_zamba_attention(torch, fa, ref, ra, gen, card, seq) -> dict:
    """9b: kernel 4 at the zamba2 prefill's attention shape (B 1, Hq =
    Hkv = 32, L `seq`, D 64, bf16, causal): its C entry back to back,
    the blockwise plain version once, and scaled_dot_product_attention on
    a fused backend (a yardstick the port never calls)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    b, h, _, d = ZAMBA_ATTN
    dt = torch.bfloat16
    q, k, v = attention_inputs(torch, gen, b, h, h, seq, seq, d, dt)
    scale = 1.0 / math.sqrt(d)
    out = fa.flash_attention(q, k, v, causal=True, sm_scale=scale)
    lib = fa._library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b,
            h, h, seq, seq, d, d, seq, 1, 0, 0.0, scale,
            torch.cuda.current_stream().cuda_stream)
    kernel_ms = time_ms(lambda: lib.repro_flash_attention_fwd(*args),
                        iters=5, warmup=1)
    plain = blockwise_attention(torch, ref, ra, q, k, v, causal=True,
                                sm_scale=scale)
    err, over = attention_over(torch, out, plain, dt)
    plain_ms = time_ms(lambda: blockwise_attention(
        torch, ref, ra, q, k, v, causal=True, sm_scale=scale), iters=1,
        warmup=0)
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale)

    with sdpa_kernel(fused):
        sdpa_diff = (sdpa().float() - out.float()).abs().max().item()
        library_ms = time_ms(sdpa, iters=5, warmup=1)
    pairs = seq * (seq + 1) // 2
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) \
        * q.element_size()
    ops_count = 4 * d * pairs * b * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / PEAK_OPS_PER_S[str(dt)] * 1e3
    log(f"  kernel 4 at B{b} Hq{h} Hkv{h} L{seq} D{d} bf16 causal ({card}): "
        f"{kernel_ms:.5f} ms; blockwise plain {plain_ms:.5f} ms (max|err| vs "
        f"it {err:.3e}, err/limit {over:.3f}); scaled_dot_product_attention "
        f"(causal, fused backends) {library_ms:.5f} ms, max|diff| vs kernel 4"
        f" {sdpa_diff:.3e}; bound {max(t_bytes, t_ops):.6f} ms ({nbytes} B, "
        f"{ops_count} ops of the {pairs} kept pairs at the bf16 rate); "
        f"kernel / sdpa {kernel_ms / library_ms:.3f}")
    if not over <= 1.0:
        raise AssertionError(f"kernel 4 at L{seq}: err/limit {over}")
    del q, k, v, out, plain
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def serve_zamba(torch, np, zamba, ops, ref, ra) -> dict:
    """9c: build_prefill on zamba2-1.2b at full width (seeded random
    weights, bf16 compute on f32 weights) over SERVE_RUN's prompt: 38
    ssd_scan and 7 flash_attention launches and finite logits.  Then the
    same prefill through the plain versions, kernel 7 held to
    `ref.ssd_chunked_ref` in every layer and kernel 4 to
    `blockwise_attention` on every query row of each of its 7 calls, each
    on that call's inputs; then the prefill in f32 compute through the
    kernels and through the plain versions, its logits within
    ZAMBA_F32_LOGITS_RTOL of the largest.  Returns the launch counts of
    the path."""
    from repro_torch.core.heap import tree_flatten
    from repro_torch.models import transformer
    from repro_torch.serve import step as sstep
    cfg, run = zamba.CONFIG, zamba.SERVE_RUN
    params = transformer.init_params(cfg, seed=0, device="cuda")
    n_params = sum(w.numel() for w in tree_flatten(params)[0])
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(
        1, cfg.vocab, size=(run["prefill_batch"], run["prefill_len"])),
        device="cuda")
    prefill = sstep.build_prefill(cfg)
    n_shared = transformer.n_shared_blocks(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                                  # path starts
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()                               # path ends
    peak = torch.cuda.max_memory_allocated()
    log(f"  prefill {cfg.name} ({n_params} parameters, {cfg.n_layers} "
        f"Mamba2 layers and {n_shared} applications of the shared attention"
        f" block, d {cfg.d_model}, vocab {cfg.vocab}), batch "
        f"{run['prefill_batch']} x L {run['prefill_len']}: wall {wall:.3f} s "
        f"({run['prefill_batch'] * run['prefill_len'] / wall:.1f} prompt "
        f"tok/s), peak memory {peak / 2**30:.3f} GiB, launches {counts}")
    want = dict({name: 0 for name in counts}, ssd_scan=cfg.n_layers,
                flash_attention=n_shared)
    if counts != want:
        raise AssertionError(f"prefill launches {counts}, want {want}")
    if logits.shape != (run["prefill_batch"], 1, cfg.vocab) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    # the same prefill through the plain versions; each kernel call's
    # output on that call's inputs held to the plain output
    kernel_scan, kernel_attn = ops._ssd.ssd_scan, ops._fa.flash_attention
    ssd_over_, attn_over, attn_rows = [], [], []

    def ssd_both(x, dt, a, bm, cm, h0=None, *, chunk):
        want = ref.ssd_chunked_ref(x, dt, a, bm, cm, h0, chunk=chunk)
        got = kernel_scan(x, dt, a, bm, cm, h0, chunk=chunk)
        ssd_over_.append(ssd_over(torch, *got, *want)[0])
        return want

    def attn_both(q, k, v, **kw):
        got = kernel_attn(q, k, v, **kw)
        want = blockwise_attention(torch, ref, ra, q, k, v, **kw)
        attn_over.append(attention_over(torch, got, want, q.dtype)[1])
        attn_rows.append(q.shape[2])
        return want

    t0 = time.perf_counter()
    with mock.patch.object(ops._ssd, "ssd_scan", ssd_both), \
            mock.patch.object(ops._fa, "flash_attention", attn_both):
        plain = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    both_wall = time.perf_counter() - t0
    err = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    log(f"  in the bf16 prefill, on each call's inputs: kernel 7 vs plain "
        f"in {len(ssd_over_)} layers, worst err/limit {max(ssd_over_):.3f}; "
        f"kernel 4 vs the blockwise plain version in {len(attn_over)} calls"
        f" of {attn_rows} query rows, worst err/limit {max(attn_over):.3f} "
        f"(per call: " + " ".join(f"{x:.3f}" for x in attn_over)
        + f"); plain + kernel prefill wall {both_wall:.3f} s")
    log(f"  bf16 prefill logits, kernel path vs plain path (not gated, see "
        f"ZAMBA_F32_LOGITS_RTOL): max|err| {err:.4e}, max|logit| "
        f"{scale:.4f}, {err / scale / 2.0 ** -8:.2f} bf16 ulps of the "
        f"largest; argmax {int(logits.argmax())} vs {int(plain.argmax())}")
    if len(ssd_over_) != cfg.n_layers or not max(ssd_over_) <= 1.0:
        raise AssertionError(f"kernel 7 in the prefill's layers: {ssd_over_}")
    rows = -(-run["prefill_len"] // ops._fa.BQ) * ops._fa.BQ   # padded
    if attn_rows != [rows] * n_shared \
            or not max(attn_over) <= 1.0:
        raise AssertionError(f"kernel 4 in the prefill's shared blocks: "
                             f"rows {attn_rows}, err/limit {attn_over}")
    del logits, plain
    torch.cuda.empty_cache()
    prefill32 = sstep.build_prefill(dataclasses.replace(cfg,
                                                        dtype=torch.float32))
    t0 = time.perf_counter()
    logits = prefill32(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall32 = time.perf_counter() - t0

    def attn_plain(q, k, v, **kw):
        return blockwise_attention(torch, ref, ra, q, k, v, **kw)

    with mock.patch.object(ops._ssd, "ssd_scan", ref.ssd_chunked_ref), \
            mock.patch.object(ops._fa, "flash_attention", attn_plain):
        plain = prefill32(params, {"tokens": tokens})
    err = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    log(f"  f32 prefill logits, kernel path vs plain path: max|err| "
        f"{err:.4e}, max|logit| {scale:.4f}, rel {err / scale:.3e} (tol "
        f"{ZAMBA_F32_LOGITS_RTOL}); argmax {int(logits.argmax())} vs "
        f"{int(plain.argmax())}; kernel-path wall {wall32:.3f} s")
    if not (torch.isfinite(logits).all()
            and err <= ZAMBA_F32_LOGITS_RTOL * scale):
        raise AssertionError(f"f32 prefill logits differ by {err} "
                             f"(max|logit| {scale})")
    del logits, plain, tokens, params
    torch.cuda.empty_cache()
    return counts


def decode_f32_vs_prefill(torch, np, zamba) -> None:
    """9d, gated: in bf16 the loop's logits cannot be held to the
    prefill's (a random-weight stack amplifies each flipped bf16 rounding,
    see MAMBA_F32_LOGITS_RTOL; 7d and 9d print that difference).  So the
    decode path is held in f32 compute: SERVE_RUN's prompts fed through
    build_decode_step against caches of --cache-len slots, the logits at
    the last prompt position against build_prefill's (kernels 4 and 7)
    within ZAMBA_F32_LOGITS_RTOL of the largest."""
    from repro_torch.models import transformer
    from repro_torch.serve import step as sstep
    run = zamba.SERVE_RUN
    cfg = dataclasses.replace(zamba.CONFIG, dtype=torch.float32)
    B, prompt_len = run["batch"], run["prompt_len"]
    params = transformer.init_params(cfg, seed=0, device="cuda")
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab, size=(B, prompt_len)), device="cuda")
    cache = transformer.init_cache(cfg, 1, B, run["cache_len"],
                                   device="cuda")
    decode = sstep.build_decode_step(cfg)
    for t in range(prompt_len):
        logits, cache = decode(params, cache, {
            "tokens": prompts[:, t:t + 1],
            "positions": torch.full((B,), t, device="cuda")})
    pre = sstep.build_prefill(cfg)(params, {"tokens": prompts})
    err = (logits - pre).abs().max().item()
    scale = pre.abs().max().item()
    log(f"  f32 decode ({prompt_len} steps, batch {B}, caches of "
        f"{run['cache_len']} slots) vs the f32 prefill at the last prompt "
        f"position: max|err| {err:.4e}, max|logit| {scale:.4f}, rel "
        f"{err / scale:.3e} (tol {ZAMBA_F32_LOGITS_RTOL})")
    if not (torch.isfinite(logits).all()
            and err <= ZAMBA_F32_LOGITS_RTOL * scale):
        raise AssertionError(f"f32 decode logits differ from the prefill's "
                             f"by {err} (max|logit| {scale})")
    del params, cache
    torch.cuda.empty_cache()


def long_decode(torch, np, zamba) -> None:
    """9e: one build_decode_step of zamba2-1.2b at SERVE_RUN's long
    decode (batch 4 against caches of 32768 slots, every cache filled
    from a seeded generator) at position 32767: finite logits, each
    shared attention cache changed at slot 32767 of every row and nowhere
    else; then the wall of a few more steps and the peak memory."""
    from repro_torch.core.heap import tree_flatten
    from repro_torch.models import transformer
    from repro_torch.serve import step as sstep
    cfg, run = zamba.CONFIG, zamba.SERVE_RUN
    B, S = run["long_batch"], run["long_cache_len"]
    params = transformer.init_params(cfg, seed=0, device="cuda")
    cache = transformer.init_cache(cfg, 1, B, S, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for leaf in tree_flatten(cache)[0]:
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
    before = [{k: c[k].clone() for k in ("k", "v")} for c in cache["shared"]]
    decode = sstep.build_decode_step(cfg)
    batch = {"tokens": torch.randint(1, cfg.vocab, (B, 1), generator=gen,
                                     device="cuda"),
             "positions": torch.full((B,), S - 1, device="cuda")}
    nbytes = sum(c[k].numel() * c[k].element_size()
                 for c in cache["shared"] for k in ("k", "v"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    logits, cache = decode(params, cache, batch)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    changed = []
    for c, old in zip(cache["shared"], before):
        moved = torch.zeros((B, S), dtype=torch.bool, device="cuda")
        for k in ("k", "v"):
            moved |= (c[k] != old[k]).flatten(2).any(-1)
        changed.append(moved.nonzero()[:, 1].unique().tolist()
                       + [int(moved[:, S - 1].sum())])
    del before
    steps = 5
    t0 = time.perf_counter()
    for _ in range(steps):
        logits_n, cache = decode(params, cache, batch)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / steps
    log(f"  long decode {cfg.name}: batch {B}, {len(cache['shared'])} shared"
        f" caches of {S} slots ({nbytes / 1e9:.3f} GB), position {S - 1}: "
        f"first step {first * 1e3:.3f} ms, then {per_step * 1e3:.3f} ms a "
        f"step over {steps}; peak memory {peak / 2**30:.3f} GiB; launches "
        f"{counts}; slots changed per shared cache [slots..., rows at "
        f"{S - 1}] {changed[0]} (each of {len(changed)})")
    if any(c != [S - 1, B] for c in changed):
        raise AssertionError(f"the decode step changed slots {changed}, "
                             f"want only {S - 1} in every row")
    if logits.shape != (B, 1, cfg.vocab) or not (
            torch.isfinite(logits).all() and torch.isfinite(logits_n).all()):
        raise AssertionError(f"long-decode logits {tuple(logits.shape)} are "
                             f"not finite")
    del params, cache, logits, logits_n
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 10: the rest of the dense family at full width — kernel 4 at head
# dims 256, 120 and 128; gemma2-9b, h2o-danube-3-4b, internlm2-20b
# ---------------------------------------------------------------------------

# kernel 4 held at its new shapes over this many tokens (10a), where a
# window of 4096 would keep every causal key: it is cut to 1024 there
# (phase 2's rule), and held at its real width over 32768 tokens, call by
# call, in 10b and 10d
DENSE_CHECK_LEN, DENSE_CHECK_WINDOW = 4096, 1024
# gemma2's prefill in f32 compute through the kernels and through the
# plain versions, logits within this share of the largest (the limit of
# MAMBA_F32_LOGITS_RTOL), over the first GEMMA_F32_LEN tokens of the
# prompt: at 32768 tokens the f32 projections alone (~600 TFLOP of
# products at the 67 TFLOP/s f32 rate, no TF32) would take ~10 s a pass,
# two passes plus f32 attention over a minute of the phase's ~400 s.
# 8192 tokens still hold two windows of 4096 on every local layer
DENSE_F32_LOGITS_RTOL = MAMBA_F32_LOGITS_RTOL
GEMMA_F32_LEN = 8192


def reference_windows(cfg) -> list:
    """Each layer's window by the reference's rule (`repro/models/
    layers.py:220-222`: the local window on the even layers of a
    local/global config, else cfg.window), written out apart from the
    port's own rule so that the launches are held to it."""
    return [cfg.local_window if cfg.local_global_period and i % 2 == 0
            else cfg.window for i in range(cfg.n_layers)]


def dense_attention_shapes(archs) -> list:
    """(label, Hq, Hkv, D, Dv, window, softcap, launches in one prefill,
    causal) of each kind of kernel-4 call the three models' prefills
    make: gemma2's local and global layers, danube's windowed and
    internlm2's causal ones."""
    shapes = []
    for mod in archs:
        cfg = mod.CONFIG
        windows = reference_windows(cfg)
        for window in dict.fromkeys(windows):
            kind = ("" if not cfg.local_global_period
                    else " local" if window else " global")
            shapes.append((cfg.name + kind, cfg.n_heads, cfg.n_kv_heads,
                           cfg.hd, cfg.hd, window, cfg.softcap,
                           windows.count(window), cfg.causal))
    return shapes


def check_dense_kernels(torch, ops, ref, fa, ra, gen, shapes) -> None:
    """10a, 11a, 12a, 13a: kernel 4 at each shape of
    `dense_attention_shapes`, `moe_attention_shapes` or
    `frontend_attention_shapes` (B 1, its heads and head dims, causal or
    not, its softcap, its window cut to DENSE_CHECK_WINDOW) over
    DENSE_CHECK_LEN tokens, bf16 and f32, against `plain_attention`
    (phase 2's limits; f32 against the f64 evaluation) and against
    `blockwise_attention`, the plain version 10b and 10d hold it to (in
    bf16; in f32 that version's own f32 products err by ~3e-5 at D 256,
    see `plain_attention`, so its gap is printed)."""
    seq = DENSE_CHECK_LEN
    for label, hq, hkv, d, dv, window, softcap, _, causal in shapes:
        kw = dict(causal=causal, softcap=softcap,
                  window=DENSE_CHECK_WINDOW if window else None)
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = attention_inputs(torch, gen, 1, hq, hkv, seq, seq, d,
                                       dt, dv)
            out = ops.attention(q, k, v, **kw)
            want = plain_attention(torch, ref, q, k, v, **kw)
            blocks = blockwise_attention(torch, ref, ra, q, k, v, **kw)
            torch.cuda.synchronize()
            err, over = attention_over(torch, out, want, dt)
            err_b, over_b = attention_over(torch, out, blocks, dt)
            route = "tensor cores" if fa.tensor_core_route(q, k, v) \
                else "CUDA cores"
            typical = want.float().abs().mean().item()
            log(f"  attention {label} B1 Hq{hq} Hkv{hkv} L{seq} D{d} Dv{dv} "
                f"{dt} {kw} ({route}): vs attention_ref max|err| {err:.3e} "
                f"(worst err/limit {over:.3f}), vs the blockwise plain "
                f"version {err_b:.3e} ({over_b:.3f}); mean|out| "
                f"{typical:.3f}")
            if dt == torch.bfloat16 and route != "tensor cores":
                raise AssertionError(f"kernel 4 at {label}'s shape did not "
                                     f"take the tensor cores")
            if not (over <= 1.0 and torch.isfinite(out).all()) \
                    or (dt == torch.bfloat16 and not over_b <= 1.0):
                raise AssertionError(f"kernel 4 at {label} {dt}: err/limit "
                                     f"{over} vs attention_ref, {over_b} "
                                     f"vs blockwise")
            if not typical > 10 * TOL[str(dt)]:
                raise AssertionError(f"kernel 4 at {label}: mean|out| "
                                     f"{typical} is not far above the "
                                     f"tolerance")
            del q, k, v, out, want, blocks
            torch.cuda.empty_cache()


def window_mask(torch, seq, window):
    """The additive (L, L) bf16 mask of a causal window: 0 where key j
    is kept by row i (i - window < j <= i), -inf elsewhere."""
    i = torch.arange(seq, device="cuda")
    keep = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    mask = torch.zeros((seq, seq), dtype=torch.bfloat16, device="cuda")
    return mask.masked_fill_(~keep, float("-inf"))


def first_sdpa_backend(torch, candidates, sdpa):
    """The first of `candidates` (SDPBackend members) that runs `sdpa`
    on its own: the yardstick's backend where the dispatcher's choice
    would not say which."""
    from torch.nn.attention import sdpa_kernel
    for backend in candidates:
        try:
            with sdpa_kernel([backend]):
                sdpa()
            return backend
        except RuntimeError:
            continue
    raise AssertionError(f"none of {candidates} runs this shape")


def time_dense_attention(torch, fa, ref, ra, gen, card, shape, seq) -> dict:
    """10a, 11a, 12b, 13b: kernel 4 at one shape of
    `dense_attention_shapes`, `moe_attention_shapes` or
    `frontend_attention_shapes` over `seq` tokens (bf16, B 1, causal or
    not, the real window and softcap): its C entry back to back, the
    blockwise plain version once, and scaled_dot_product_attention on a
    fused backend as a yardstick the port never calls, on k and v
    repeated to Hq heads: causal (or, for an encoder, without a mask)
    and without a softcap; for a window, with the window as an additive
    mask, which makes it compute all L^2 pairs; for a head dim of v
    apart from q's (MLA), on the first fused backend that takes it,
    named."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    label, hq, hkv, d, dv, window, softcap, calls, causal = shape
    dt = torch.bfloat16
    q, k, v = attention_inputs(torch, gen, 1, hq, hkv, seq, seq, d, dt, dv)
    scale = 1.0 / math.sqrt(d)
    kw = dict(causal=causal, window=window, softcap=softcap, sm_scale=scale)
    out = fa.flash_attention(q, k, v, **kw)
    lib = fa._library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, 1,
            hq, hkv, seq, seq, d, dv, seq, int(causal), window or 0,
            float(softcap or 0.0), scale,
            torch.cuda.current_stream().cuda_stream)
    kernel_ms = time_ms(lambda: lib.repro_flash_attention_fwd(*args),
                        iters=5, warmup=1)
    plain = blockwise_attention(torch, ref, ra, q, k, v, **kw)
    err, over = attention_over(torch, out, plain, dt)
    plain_ms = time_ms(lambda: blockwise_attention(
        torch, ref, ra, q, k, v, **kw), iters=1, warmup=0)
    del plain
    kr = k.repeat_interleave(hq // hkv, 1)
    vr = v.repeat_interleave(hq // hkv, 1)
    if window is None:
        backends = [SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION]
        yard = "causal" if causal else "no mask"
        sdpa_kw = dict(is_causal=causal)
    else:
        backends = [SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION]
        yard = f"the window as an additive mask, all {seq}^2 pairs"
        sdpa_kw = dict(attn_mask=window_mask(torch, seq, window))
    yard += ", no softcap" if softcap else ""

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, kr, vr, scale=scale, **sdpa_kw)

    if dv != d:
        backends = [first_sdpa_backend(torch, backends, sdpa)]
        yard += f", Dv {dv} against D {d} on {backends[0].name}"
    with sdpa_kernel(backends):
        sdpa_diff = (sdpa().float() - out.float()).abs().max().item()
        library_ms = time_ms(sdpa, iters=3, warmup=1)
    pairs, _ = mask_counts(seq, seq, causal, window)
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) \
        * q.element_size()
    ops_count = 2 * (d + dv) * pairs * hq
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / PEAK_OPS_PER_S[str(dt)] * 1e3
    mask = "causal" if causal else "non-causal"
    log(f"  kernel 4 at {label} B1 Hq{hq} Hkv{hkv} L{seq} D{d} Dv{dv} bf16 "
        f"{mask} window {window} softcap {softcap} ({card}): {kernel_ms:.5f}"
        f" ms ({ops_count / kernel_ms / 1e9:.1f} TFLOP/s of kept products);"
        f" blockwise plain {plain_ms:.5f} ms (max|err| vs it {err:.3e}, "
        f"err/limit {over:.3f}); scaled_dot_product_attention ({yard}): "
        f"{library_ms:.5f} ms, max|diff| vs kernel 4 {sdpa_diff:.3e}, "
        f"kernel / sdpa {kernel_ms / library_ms:.3f}; bound "
        f"{max(t_bytes, t_ops):.6f} ms ({nbytes} B, "
        f"{ops_count} ops of the {pairs} kept pairs a head at the bf16 "
        f"rate)")
    if not over <= 1.0:
        raise AssertionError(f"kernel 4 at {label} L{seq}: err/limit {over}")
    del q, k, v, kr, vr, out, sdpa_kw
    torch.cuda.empty_cache()
    dims = f"D {d}" if dv == d else f"D {d}, Dv {dv}"
    return dict(shape=f"{label} (B 1, Hq {hq}, Hkv {hkv}, L {seq}, {dims}, "
                f"bf16, {mask}, window {window}, softcap {softcap})",
                calls=calls, max_abs_err=err, ms=kernel_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def prefill_dense(torch, np, mod, ops, ref, ra, cfg=None):
    """10b, 10d, 11b, 11c, 12c, 13c: build_prefill on `mod`'s model at
    full width (`cfg`, default its CONFIG; seeded random weights in its
    param_dtype, bf16 compute) over SERVE_RUN's prompt (`prefill_inputs`:
    hubert's frames, phi-3-vision's tokens and frontend embeds): exactly
    one kernel-4 launch a layer, each with the reference's window for
    that layer and the config's causal flag, and finite logits; the wall
    of a second prefill too (the first call in a
    process carries one-time start-up: `tools/profile_prefill` read 8.8
    s for danube's, then 0.75); then the same prefill with kernel 4 held
    to `blockwise_attention` on every query row of the calls
    `PREFILL_HELD` picks, each checked as it happens, the plain output
    carried on (the kernel's on the other calls).
    Returns (params, the launch counts of the path)."""
    from repro_torch.core.heap import tree_flatten
    from repro_torch.models import transformer
    from repro_torch.serve import step as sstep
    from repro_torch.tools.profile_prefill import prefill_inputs
    cfg, run = cfg or mod.CONFIG, mod.SERVE_RUN
    params = transformer.init_params(cfg, seed=0, device="cuda")
    n_params = sum(w.numel() for w in tree_flatten(params)[0])
    n_bytes = sum(w.numel() * w.element_size()
                  for w in tree_flatten(params)[0])
    batch = prefill_inputs(cfg, run, "cuda")
    prefill = sstep.build_prefill(cfg)
    kernel = ops._fa.flash_attention
    windows, causal = [], []

    def spy(q, k, v, **kw):
        windows.append(kw.get("window"))
        causal.append(kw.get("causal"))
        return kernel(q, k, v, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(ops._fa, "flash_attention", spy):
        _reset_counts()                              # path starts
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()                           # path ends
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    prefill(params, batch)
    torch.cuda.synchronize()
    again = time.perf_counter() - t0
    want_windows = reference_windows(cfg)
    log(f"  prefill {cfg.name} ({n_params} parameters, {n_bytes / 2**30:.3f}"
        f" GiB of {cfg.param_dtype} weights; {cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads} q heads over {cfg.n_kv_heads} KV "
        f"heads of {cfg.hd}, vocab {cfg.vocab}), batch "
        f"{run['prefill_batch']} x L {run['prefill_len']} ("
        + ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
        + f"): wall {wall:.3f} s first, {again:.3f} s again ("
        f"{run['prefill_batch'] * run['prefill_len'] / again:.1f} "
        f"{'frames' if cfg.frontend == 'audio' else 'prompt tok'}/s), peak "
        f"memory {peak / 2**30:.3f} GiB, launches {counts}, "
        f"windows {dict((w, windows.count(w)) for w in set(windows))}, "
        f"causal {dict((c, causal.count(c)) for c in set(causal))}")
    want = dict({name: 0 for name in counts}, flash_attention=cfg.n_layers)
    if counts != want or windows != want_windows \
            or causal != [cfg.causal] * cfg.n_layers:
        raise AssertionError(f"prefill launches {counts} with windows "
                             f"{windows}, causal {causal}, want {want} with "
                             f"{want_windows}, causal {cfg.causal}")
    if logits.shape != (run["prefill_batch"], 1, cfg.vocab) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    over, calls = [], [0]
    every, held = PREFILL_HELD

    def attn_both(q, k, v, **kw):
        got = kernel(q, k, v, **kw)
        calls[0] += 1
        if (calls[0] - 1) % every >= held:
            return got
        want = blockwise_attention(torch, ref, ra, q, k, v, **kw)
        over.append(attention_over(torch, got, want, q.dtype)[1])
        return want

    t0 = time.perf_counter()
    with mock.patch.object(ops._fa, "flash_attention", attn_both):
        plain = prefill(params, batch)
    torch.cuda.synchronize()
    both_wall = time.perf_counter() - t0
    err = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    log(f"  in the bf16 prefill, on each call's inputs: kernel 4 vs the "
        f"blockwise plain version on every query row of {len(over)} of "
        f"the {calls[0]} calls (i % {every} < {held}), worst err/limit "
        f"{max(over):.3f} (per call: "
        + " ".join(f"{x:.3f}" for x in over)
        + f"); plain + kernel prefill wall {both_wall:.3f} s; bf16 logits "
        f"kernel path vs that path (not gated, see MAMBA_F32_LOGITS_RTOL): "
        f"max|err| {err:.4e}, max|logit| {scale:.4f}; argmax "
        f"{int(logits.argmax())} vs {int(plain.argmax())}")
    n_held = sum(i % every < held for i in range(cfg.n_layers))
    if calls[0] != cfg.n_layers or len(over) != n_held \
            or not max(over) <= 1.0:
        raise AssertionError(f"kernel 4 in the prefill's {calls[0]} calls: "
                             f"err/limit {over}")
    del logits, plain, batch
    torch.cuda.empty_cache()
    return params, counts


def f32_gate(torch, mod, ops, ref, ra, params, length) -> None:
    """10b, 12c, 13c: `mod`'s model in f32 compute over the first `length`
    positions of SERVE_RUN's prompt (`prefill_inputs`; frontend embeds
    whole), `forward` through kernel 4 and through the blockwise plain
    version: the last position's logits (the prefill's) within
    DENSE_F32_LOGITS_RTOL of the largest.  An encoder's hidden state is
    held at every position too, each within that share of the
    position's largest |h|: a bidirectional layer mixes every position
    into every other, so a fault at any row shows anywhere.  With
    frontend embeds, the kernel path's logits without them must differ
    from those with them by more than the tolerance: the embeds reach
    the output."""
    from repro_torch.models import layers, transformer
    from repro_torch.parallel.comm import Comm
    from repro_torch.tools.profile_prefill import prefill_inputs
    cfg = dataclasses.replace(mod.CONFIG, dtype=torch.float32)
    batch = {k: v if k == "frontend_embeds" else v[:, :length]
             for k, v in prefill_inputs(mod.CONFIG, mod.SERVE_RUN,
                                        "cuda").items()}
    comm = Comm()

    @torch.no_grad()
    def run(attn, inputs):
        t0 = time.perf_counter()
        with mock.patch.object(ops._fa, "flash_attention", attn):
            h, _ = transformer.forward(
                comm, cfg, params, inputs.get("tokens"),
                frames=inputs.get("frames"),
                frontend_embeds=inputs.get("frontend_embeds"))
            logits = layers.lm_logits(comm, cfg, params["embed"], h[:, -1:])
        torch.cuda.synchronize()
        return h, logits, time.perf_counter() - t0

    def attn_plain(q, k, v, **kw):
        return blockwise_attention(torch, ref, ra, q, k, v, **kw)

    h, logits, wall32 = run(ops._fa.flash_attention, batch)
    h_plain, plain, _ = run(attn_plain, batch)
    err = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    tol = DENSE_F32_LOGITS_RTOL
    over = [not torch.isfinite(logits).all(), err > tol * scale]
    msg = (f"  f32 {cfg.name} over {length} positions ("
           + ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
           + f"), logits kernel path vs plain path: max|err| {err:.4e}, "
           f"max|logit| {scale:.4f}, rel {err / scale:.3e} (tol {tol}); "
           f"argmax {int(logits.argmax())} vs {int(plain.argmax())}; "
           f"kernel-path wall {wall32:.3f} s")
    if cfg.is_encoder:
        rel = ((h - h_plain).abs().amax(-1)
               / h_plain.abs().amax(-1)).max().item()
        msg += (f"; hidden state at all {h.shape[1]} positions, worst "
                f"max|err| / max|h| of a position {rel:.3e} (tol {tol})")
        over.append(not rel <= tol)
    if "frontend_embeds" in batch:
        _, bare, _ = run(ops._fa.flash_attention,
                         {k: v for k, v in batch.items()
                          if k != "frontend_embeds"})
        moved = (logits - bare).abs().max().item()
        msg += (f"; without the frontend embeds the logits move by "
                f"{moved:.4e} ({moved / scale:.3e} of the largest, must "
                f"exceed {tol})")
        over.append(not moved > tol * scale)
    log(msg)
    if any(over):
        raise AssertionError(f"f32 gate of {cfg.name}: failed checks "
                             f"{over} (non-finite, logits, then hidden "
                             f"state or embeds)")
    del h, h_plain, logits, plain, batch
    torch.cuda.empty_cache()


def long_decode_dense(torch, np, mod, params, cfg=None) -> None:
    """10c, 11c, 13e: one build_decode_step of `mod`'s model (`cfg`,
    default its CONFIG: gemma2, phi-3-vision; deepseek-v3 cut to 4
    layers) at SERVE_RUN's long
    decode, batch `long_batch` against caches of `long_cache_len` slots
    (gemma2's local layers: rings of local_window slots; MLA: the latent
    c_kv and k_rope), every cache leaf filled from a generator seeded by
    its index, at the last position: finite logits; each full-length
    cache changed only at that slot and each ring only at that slot
    modulo its length, in every row, checked against each leaf's
    contents regenerated from its seed, one leaf at a time (no copy of
    the caches); then the wall of a few more steps and the peak
    memory."""
    from repro_torch.core.heap import tree_flatten
    from repro_torch.models import transformer
    from repro_torch.serve import step as sstep
    cfg, run = cfg or mod.CONFIG, mod.SERVE_RUN
    B, S = run["long_batch"], run["long_cache_len"]
    cache = transformer.init_cache(cfg, 1, B, S, device="cuda")
    leaves = tree_flatten(cache)[0]

    def fill(j):
        gen = torch.Generator(device="cuda").manual_seed(1000 + j)
        return torch.randn(leaves[j].shape, generator=gen,
                           device="cuda").to(leaves[j].dtype)

    for j, leaf in enumerate(leaves):
        leaf.copy_(fill(j))
    gen = torch.Generator(device="cuda").manual_seed(1)
    decode = sstep.build_decode_step(cfg)
    batch = {"tokens": torch.randint(1, cfg.vocab, (B, 1), generator=gen,
                                     device="cuda"),
             "positions": torch.full((B,), S - 1, device="cuda")}
    nbytes = sum(leaf.numel() * leaf.element_size() for leaf in leaves)
    slots = sorted({leaf.shape[1] for leaf in leaves})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    logits, cache = decode(params, cache, batch)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    changed = set()
    for j, leaf in enumerate(tree_flatten(cache)[0]):
        moved = (leaf != fill(j)).flatten(2).any(-1)       # (B, slots)
        n = leaf.shape[1]
        changed.add((n, tuple(moved.nonzero()[:, 1].unique().tolist()),
                     int(moved[:, (S - 1) % n].sum())))
    steps = 5
    t0 = time.perf_counter()
    for _ in range(steps):
        logits_n, cache = decode(params, cache, batch)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / steps
    log(f"  long decode {cfg.name}: batch {B}, {len(leaves)} cache leaves"
        f" of {slots} slots ({nbytes / 1e9:.3f} GB), position "
        f"{S - 1}: first step {first * 1e3:.3f} ms, then {per_step * 1e3:.3f}"
        f" ms a step over {steps}; peak memory {peak / 2**30:.3f} GiB; "
        f"launches {counts}; (slots, slots changed, rows changed there) "
        f"{sorted(changed)}")
    want = {(n, ((S - 1) % n,), B) for n in slots}
    if changed != want:
        raise AssertionError(f"the decode step changed {sorted(changed)}, "
                             f"want {sorted(want)}")
    if logits.shape != (B, 1, cfg.vocab) or not (
            torch.isfinite(logits).all() and torch.isfinite(logits_n).all()):
        raise AssertionError(f"long-decode logits {tuple(logits.shape)} are "
                             f"not finite")
    del cache, leaves, logits, logits_n
    torch.cuda.empty_cache()


def launch_dense(torch, np, mod, ref, layers, logits_check=False) -> dict:
    """10b, 10d, 13d: `python -m repro_torch.launch.serve --arch <arch>`
    through its main() at the reference's defaults (the paged engine, batch 4,
    prompt 32, 16 tokens, max_seq max(--cache-len 128, 48)): (4, 16)
    tokens, one paged prefill of kernel-4 launches per layer per
    request and one kernel-8 launch per layer per decode step (counts
    set to 0 just before, read just after).  With
    `logits_check`, one request's prefill logits through the kernel
    against those through the plain version (phase 3's rule,
    PREFILL_LOGITS_RTOL of the largest) on the engine's weights.  Returns
    the launch counts."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import engine as serve_engine
    cfg, run = mod.CONFIG, mod.SERVE_RUN
    built = []

    class Recording(serve_engine.ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    decoding, decodes = counting_decodes()
    with mock.patch.object(serve_engine, "ServeEngine", Recording), \
            decoding:
        _reset_counts()                              # path starts
        t0 = time.perf_counter()
        gen = launch_serve.main(["--arch", cfg.name])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()                           # path ends
    peak = torch.cuda.max_memory_allocated()
    (eng,) = built
    want = (run["batch"], run["new_tokens"])
    log(f"  launch.serve main ({cfg.name}, paged engine: batch "
        f"{run['batch']}, prompt {run['prompt_len']}, {run['new_tokens']} "
        f"tokens, max_seq {eng.max_seq}, {eng.kv.pool.num_pages} pages of "
        f"{eng.page_size}): tokens {gen.shape}, wall {wall:.3f} s with the "
        f"weights' init, {gen.size / wall:.1f} tok/s, peak memory "
        f"{peak / 2**30:.3f} GiB, {eng.steps} engine steps, "
        f"{decodes['steps']} decode steps, launches {counts}; first row "
        f"{gen[0].tolist()}")
    want_counts = dict({name: 0 for name in counts},
                       flash_attention=cfg.n_layers * run["batch"],
                       paged_decode=cfg.n_layers * decodes["steps"])
    if gen.shape != want or counts != want_counts \
            or decodes["steps"] < run["new_tokens"] - 1 \
            or eng.max_seq != max(run["cache_len"],
                                  run["prompt_len"] + run["new_tokens"]):
        raise AssertionError(f"launcher gave {gen.shape}, launches {counts}"
                             f", max_seq {eng.max_seq}; want {want}, "
                             f"{want_counts}")
    if logits_check:
        prompts = np.random.default_rng(0).integers(
            1, cfg.vocab, size=(run["batch"], run["prompt_len"]),
            dtype=np.int32)

        def first_logits():
            e = serve_engine.ServeEngine(
                cfg, params=eng.params, device="cuda", capture_logits=True,
                max_slots=eng.max_slots, page_size=eng.page_size,
                max_seq=eng.max_seq, prompt_bucket=eng.prompt_bucket)
            r = e.submit(prompts[0], 1)
            e.run()
            return e.logits_trace[r][0]

        kernel = first_logits()
        with mock.patch.object(layers.kops, "attention", ref.attention_ref):
            plain = first_logits()
        err = float(np.abs(kernel - plain).max())
        scale = float(np.abs(plain).max())
        log(f"  prefill logits of request 0 through the engine, kernel vs "
            f"plain: max|err| {err:.4e}, max|logit| {scale:.4f}, tol "
            f"{PREFILL_LOGITS_RTOL * scale:.4e}; argmax "
            f"{int(kernel.argmax())} vs {int(plain.argmax())}")
        if kernel.shape != (cfg.vocab,) or not np.isfinite(kernel).all() \
                or not err <= PREFILL_LOGITS_RTOL * scale:
            raise AssertionError(f"prefill logits {kernel.shape} differ by "
                                 f"{err}")
    built.clear()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 11: the moe family at full width — kernel 4 at granite's and MLA's
# shapes; granite-moe-3b-a800m, deepseek-v3 over 4 of its 61 layers
# ---------------------------------------------------------------------------

# each model's prefill in f32 compute through kernel 4 and through the
# blockwise plain version over the first MOE_F32_LEN tokens of the prompt
# (gemma2's GEMMA_F32_LEN, for the same reason).  The router turns any
# change of summation order into a different expert where two gates are
# near-tied or a token sits at an expert's capacity, and a changed pick
# moves the drops of later tokens in that expert: so each layer's routes
# (top-k experts, kept flags) are recorded on both paths.  Where all
# agree, the logits are held within MOE_F32_RTOL of the largest; where
# some differ, the layer outputs before the first layer that differs are
# held within MOE_F32_RTOL of their largest and that layer's differing
# picks must be fewer than MOE_ROUTE_SHARE of its T x K
MOE_F32_LEN = 8192
MOE_F32_RTOL = DENSE_F32_LOGITS_RTOL
MOE_ROUTE_SHARE = 1e-3


def moe_attention_shapes(granite_cfg, deepseek_cfg) -> list:
    """`dense_attention_shapes`' tuples of the two kinds of kernel-4
    call of the moe prefills: granite's GQA layers, and deepseek-v3's
    MLA (q and k at nope + rope, v at v_dim, one KV head a q head)."""
    g, ds = granite_cfg, deepseek_cfg
    m = ds.mla
    return [(g.name, g.n_heads, g.n_kv_heads, g.hd, g.hd, None, None,
             g.n_layers, True),
            (ds.name + " MLA", ds.n_heads, ds.n_heads,
             m.qk_nope_dim + m.qk_rope_dim, m.v_dim, None, None,
             ds.n_layers, True)]


def moe_f32_gate(torch, np, cfg, run, ops, ref, ra, params) -> None:
    """11b, 11c: `cfg`'s prefill in f32 compute over the first
    MOE_F32_LEN tokens of SERVE_RUN's prompt through kernel 4 and through
    the blockwise plain version, each layer's routes and block outputs
    recorded, gated by the rule at MOE_F32_LEN."""
    from repro_torch.models import layers, transformer
    from repro_torch.serve import step as sstep
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab, size=(run["prefill_batch"], run["prefill_len"])),
        device="cuda")[:, :MOE_F32_LEN]
    prefill32 = sstep.build_prefill(dataclasses.replace(
        cfg, dtype=torch.float32))
    real_route, real_block = layers.moe_route, transformer._attn_block
    kernel = ops._fa.flash_attention

    def run_path(attn):
        routes, outs = [], []

        def route(*a):
            r = real_route(*a)
            routes.append((r[2], r[4]))               # tope, keep
            return r

        def block(*a, **kw):
            x, aux = real_block(*a, **kw)
            outs.append(x)
            return x, aux

        t0 = time.perf_counter()
        with mock.patch.object(layers, "moe_route", route), \
                mock.patch.object(transformer, "_attn_block", block), \
                mock.patch.object(ops._fa, "flash_attention", attn):
            logits = prefill32(params, {"tokens": tokens})
        torch.cuda.synchronize()
        return logits, routes, outs, time.perf_counter() - t0

    def attn_plain(q, k, v, **kw):
        return blockwise_attention(torch, ref, ra, q, k, v, **kw)

    logits, routes, outs, wall = run_path(kernel)
    plain, p_routes, p_outs, plain_wall = run_path(attn_plain)
    nd = cfg.moe.first_dense_layers
    picks = tokens.numel() * cfg.moe.top_k
    differ = [int(((te != pe).reshape(-1) | (kp != pk)).sum())
              for (te, kp), (pe, pk) in zip(routes, p_routes)]
    out_rel = [(a - b).abs().max().item() / b.abs().max().item()
               for a, b in zip(outs, p_outs)]
    err = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    log(f"  f32 prefill {cfg.name} over {tokens.shape[1]} tokens, kernel 4 "
        f"vs the blockwise plain version: {len(routes)} MoE layers of "
        f"{picks} (token, k) picks, picks that differ per layer {differ}; "
        f"block outputs max|err| / max|out| per block "
        + " ".join(f"{x:.2e}" for x in out_rel)
        + f"; logits max|err| {err:.4e}, max|logit| {scale:.4f}, rel "
        f"{err / scale:.3e} (tol {MOE_F32_RTOL}); argmax "
        f"{int(logits.argmax())} vs {int(plain.argmax())}; walls "
        f"{wall:.3f} s (kernel) and {plain_wall:.3f} s (plain)")
    if len(routes) != cfg.n_layers - nd or len(outs) != cfg.n_layers \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"f32 prefill: {len(routes)} routes, "
                             f"{len(outs)} blocks, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    if not any(differ):
        if not err <= MOE_F32_RTOL * scale:
            raise AssertionError(f"f32 prefill logits differ by {err} "
                                 f"(max|logit| {scale}) with every route "
                                 f"equal")
    else:
        first = next(i for i, n in enumerate(differ) if n)
        log(f"  routes differ first in MoE layer {first} (block "
            f"{nd + first}): {differ[first]} of {picks} picks "
            f"({differ[first] / picks:.2e}, limit {MOE_ROUTE_SHARE}); the "
            f"{nd + first} blocks before it within "
            f"{max(out_rel[:nd + first], default=0.0):.3e} (tol "
            f"{MOE_F32_RTOL})")
        if not (differ[first] < MOE_ROUTE_SHARE * picks
                and all(x <= MOE_F32_RTOL for x in out_rel[:nd + first])):
            raise AssertionError(f"f32 prefill: routes differ in layer "
                                 f"{first} at {differ[first]} of {picks} "
                                 f"picks; block outputs {out_rel}")
    del logits, plain, routes, p_routes, outs, p_outs, tokens
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 12-13: the audio and vlm families at full width — kernel 4 at
# hubert-xlarge's non-causal D 80 and phi-3-vision-4.2b's D 96
# ---------------------------------------------------------------------------

# hubert's f32 gate over this many frames (gemma2's GEMMA_F32_LEN, for
# the same reason); phi-3-vision's takes GEMMA_F32_LEN tokens
AUDIO_F32_LEN = GEMMA_F32_LEN


def frontend_attention_shapes(hubert_cfg, phi_cfg) -> list:
    """`dense_attention_shapes`' tuples of the two frontends' kernel-4
    calls: hubert's non-causal 16 heads of 80 (a KV head a q head) and
    phi-3-vision's causal 32 heads of 96."""
    return [(c.name, c.n_heads, c.n_kv_heads, c.hd, c.hd, c.window,
             c.softcap, c.n_layers, c.causal) for c in (hubert_cfg, phi_cfg)]


def encoder_launcher(torch, mod) -> None:
    """12d: `python -m repro_torch.launch.serve --arch <encoder>` through
    its main() raises the reference's SystemExit("encoder-only arch has no
    decode loop") before any work on the card: no launch, no memory."""
    from repro_torch.launch import serve as launch_serve
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    _reset_counts()                                  # path starts
    try:
        launch_serve.main(["--arch", mod.CONFIG.name])
        said = None
    except SystemExit as e:
        said = str(e)
    torch.cuda.synchronize()
    counts = _counts()                               # path ends
    grew = torch.cuda.memory_allocated() - before
    log(f"  launch.serve main ({mod.CONFIG.name}): SystemExit {said!r}, "
        f"launches {counts}, memory allocated meanwhile {grew} B")
    if said != "encoder-only arch has no decode loop" or any(
            counts.values()) or grew:
        raise AssertionError(f"the encoder's launcher said {said!r}, "
                             f"launched {counts}, allocated {grew} B")


# ---------------------------------------------------------------------------
# phase 14: the measurement services on the card
# ---------------------------------------------------------------------------

# the train launcher's autotune grid (`repro/launch/train.py`), over both
# collectives Tuner.tune sweeps
TUNE_GRID = {"collectives": ("allreduce", "fcollect"),
             "sizes": (4096, 65536, 1 << 20), "chunks": (1, 4),
             "iters": 3, "warmup": 1}
# the same call's wall through the profiler and on the host clock ended by
# a device wait, at 1 GiB: within this fraction of each other
PROFILE_WALL_RTOL = 0.2
# the fields of a sample fixed by the call alone (not by its timing)
SAMPLE_TIMES = ("wall_s", "t_start", "issue_s", "stall_s")


def _service_calls(ctx, x, xa, full: bool):
    """Phase 5's collectives through the context's methods, each one op
    sample under a profiler: to_all rd and ring and reduce_scatter (the
    bucket's), then (`full`) broadcast, fcollect, collect, alltoall and
    barrier (the message-size sweep's)."""
    calls = [("to_all rd", lambda: ctx.to_all(x, "sum", algorithm="rd")),
             ("to_all ring", lambda: ctx.to_all(x, "sum", algorithm="ring")),
             ("reduce_scatter", lambda: ctx.reduce_scatter(x))]
    if full:
        calls += [("broadcast", lambda: ctx.broadcast(x, 5)),
                  ("fcollect", lambda: ctx.fcollect(x)),
                  ("collect", lambda: ctx.collect(x)),
                  ("alltoall", lambda: ctx.alltoall(xa)),
                  ("barrier", lambda: ctx.barrier())]
    return calls


def _sample_fields(prof) -> list:
    return [{k: v for k, v in smp.to_dict().items() if k not in SAMPLE_TIMES}
            for smp in prof.samples]


def services_profiler(torch, np, card) -> dict:
    """14a: a level-2 Profiler on sim_ctx(16) over the paper's 4x4 mesh on
    the card; phase 5's collectives at 8 B per PE (the sweep's set) and
    at 1 GiB PE-stacked (the bucket's set: to_all rd, ring,
    reduce_scatter).  Each call gives exactly one sample whose fields
    (algorithm, chunks, embedding, schedule, bytes moved, hottest-link
    load, predicted_s under the board's link model...) equal those of
    the same call on sim_ctx(16, device="cpu"); kernels 1-3 launch the
    same counts with no profiler, with pcontrol(0) and with pcontrol(2);
    at 1 GiB each sample's wall_s agrees with a host-clock wall of the
    same call ended by a device wait within PROFILE_WALL_RTOL.  Returns
    the launches of the profiled 8 B run (counts set to 0 just before,
    read just after)."""
    from repro_torch.configs import epiphany16 as paper
    from repro_torch.core import Profiler, abmodel, sim_ctx
    n, topo, link = paper.N_PES, paper.TOPOLOGY, abmodel.EPIPHANY_NOC
    rng = np.random.default_rng(14)
    small = rng.standard_normal((n, 2), dtype=np.float32)       # 8 B / PE
    small_a = rng.standard_normal((n, n), dtype=np.float32)
    prof = Profiler(level=2)
    ctx = sim_ctx(n, topo, link=link, device="cuda", profile=prof)
    bare = sim_ctx(n, topo, link=link, device="cuda")
    cpu_prof = Profiler(level=2)
    cpu = sim_ctx(n, topo, link=link, device="cpu", profile=cpu_prof)

    def run(c, x, xa, full):
        for _, fn in _service_calls(c, x, xa, full):
            fn()

    xs = torch.from_numpy(small).to("cuda")
    xas = torch.from_numpy(small_a).to("cuda")
    counts = {}
    for label, c, level in (("no profiler", bare, None),
                            ("pcontrol(0)", ctx, 0),
                            ("pcontrol(2)", ctx, 2)):
        if level is not None:
            ctx.pcontrol(level)
        prof.reset()
        torch.cuda.synchronize()
        _reset_counts()                                 # path starts
        run(c, xs, xas, True)
        torch.cuda.synchronize()
        counts[label] = _counts()                       # path ends
    n_ops = len(_service_calls(ctx, xs, xas, True))
    if len(prof.samples) != n_ops or prof.counters() == {}:
        raise AssertionError(f"8 B: {len(prof.samples)} samples for "
                             f"{n_ops} collectives")
    if not (counts["no profiler"] == counts["pcontrol(0)"]
            == counts["pcontrol(2)"]):
        raise AssertionError(f"the profiler changed the launches: {counts}")
    run(cpu, torch.from_numpy(small), torch.from_numpy(small_a), True)
    got, want = _sample_fields(prof), _sample_fields(cpu_prof)
    if got != want:
        raise AssertionError(f"8 B samples on the card != the CPU SIM's:\n"
                             f"{got}\n{want}")
    log(f"  8 B per PE: {n_ops} collectives, one sample each, fields equal "
        f"to the CPU SIM's; launches with no profiler, pcontrol(0) and "
        f"pcontrol(2) all {counts['pcontrol(2)']}")

    # 1 GiB PE-stacked (64 MiB per PE), the bucket's collectives
    big = torch.zeros((n, BUCKET_ELEMS), device="cuda")
    big.uniform_(-1.0, 1.0, generator=torch.Generator(
        device="cuda").manual_seed(14))
    rows = []
    for name, fn in _service_calls(bare, big, None, False):
        fn()                                            # warm the allocator
        torch.cuda.synchronize()
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append(time.perf_counter() - t)
        rows.append([name, min(host)])
    prof.reset()
    for _ in range(3):
        for _, fn in _service_calls(ctx, big, None, False):
            fn()
    walls = [smp.wall_s for smp in prof.samples]
    k = len(rows)
    if len(walls) != 3 * k:
        raise AssertionError(f"1 GiB: {len(walls)} samples for {3 * k} "
                             f"calls")
    for i, row in enumerate(rows):
        row.append(min(walls[i::k]))
    big_fields = _sample_fields(prof)[:k]
    del big
    torch.cuda.empty_cache()
    cpu_prof.reset()
    big_cpu = torch.zeros((n, BUCKET_ELEMS))
    run(cpu, big_cpu, None, False)
    del big_cpu
    if big_fields != _sample_fields(cpu_prof):
        raise AssertionError(f"1 GiB samples on the card != the CPU SIM's:"
                             f"\n{big_fields}\n{_sample_fields(cpu_prof)}")
    log(f"  1 GiB PE-stacked ({card}; min of 3 each): "
        + "; ".join(f"{name} sample wall_s {p * 1e3:.3f} ms, host clock "
                    f"{h * 1e3:.3f} ms (x{p / h:.3f})"
                    for name, h, p in rows)
        + "; sample fields equal to the CPU SIM's")
    for name, h, p in rows:
        if abs(p / h - 1.0) > PROFILE_WALL_RTOL:
            raise AssertionError(f"{name} at 1 GiB: the profiler's wall "
                                 f"{p} s vs the host clock's {h} s")
    return counts["pcontrol(2)"]


def services_tuner(torch, np, card) -> dict:
    """14b: Tuner.tune on the profiled 16-PE context on the card over
    TUNE_GRID: `points` and `variants` as `_variants` gives them, kernel
    launches (warmup + iters) x each variant's per-call count, summed,
    plus refit_link's (its measure calls at their defaults: 2 warmup + 5
    timed, one put_copy per ppermute), each best the argmin of its
    recorded means, the tuned allreduce within the CPU test's tolerance
    of the untuned one, and the fitted link constants printed as the
    card's.  Returns the launches of the sweep."""
    from repro_torch.configs import epiphany16 as paper
    from repro_torch.core import Profiler, sim_ctx
    from repro_torch.core import collectives as coll
    from repro_torch.core import tuner as tuner_mod
    n, topo = paper.N_PES, paper.TOPOLOGY
    ctx = sim_ctx(n, topo, device="cuda", profile=Profiler(level=2))
    tuner = tuner_mod.Tuner()
    g = TUNE_GRID
    link = tuner.link_model(topo, n)
    per_call = {"put_copy": 0, "dma_copy": 0, "reduce_combine": 0}
    n_var = 0
    for collective in g["collectives"]:
        for nbytes in g["sizes"]:
            x = torch.zeros((n, nbytes // 4), device="cuda")
            for algo, c, emb in tuner._variants(collective, n, nbytes, topo,
                                                link, g["chunks"]):
                fn = coll.allreduce if collective == "allreduce" \
                    else coll.fcollect
                _reset_counts()
                fn(ctx.net, x, algorithm=algo, pipeline_chunks=c,
                   topo=topo, link=link, embedding=emb)
                one = _counts()
                for name in per_call:
                    per_call[name] += (g["warmup"] + g["iters"]) * one[name]
                n_var += 1
    sizes = sorted({max(4, int(sz)) for sz in g["sizes"]})
    pats = 3 if topo.snake_order() != tuple(range(n)) else 2
    per_call["put_copy"] += (len(sizes) + pats) * (2 + 5)
    torch.cuda.synchronize()
    _reset_counts()                                     # sweep starts
    t0 = time.perf_counter()
    summary = tuner.tune(ctx, g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _counts()                                     # sweep ends
    n_points = len(g["collectives"]) * len(g["sizes"])
    if (summary["points"], summary["variants"]) != (n_points, n_var):
        raise AssertionError(f"sweep {summary['points']} points, "
                             f"{summary['variants']} variants; want "
                             f"{n_points}, {n_var}")
    launched = {name: got[name] for name in per_call}
    if launched != per_call:
        raise AssertionError(f"sweep launches {launched}, the variants "
                             f"imply {per_call}")
    fp = summary["fingerprint"]
    for collective in g["collectives"]:
        for nbytes in g["sizes"]:
            var = tuner.db.variants(fp, collective, f"n{n}", nbytes)
            best = min(var, key=lambda v: var[v]["mean_s"])
            key = f"{collective}@{tuner_mod.nbytes_bucket(nbytes)}B"
            if summary["best"][key] != best:
                raise AssertionError(f"{key}: best {summary['best'][key]}, "
                                     f"argmin of the means {best}")
    gen = torch.Generator(device="cuda").manual_seed(15)
    x = torch.randn((n, 65536 // 4), generator=gen, device="cuda")
    tuned = sim_ctx(n, topo, device="cuda", tuner=tuner)
    plain = sim_ctx(n, topo, device="cuda")
    a = tuned.to_all(x, "sum", algorithm="auto", pipeline_chunks="auto")
    b = plain.to_all(x, "sum", algorithm="auto")
    if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
        raise AssertionError("the tuned allreduce differs from the untuned "
                             "one beyond rtol 1e-4, atol 1e-4")
    lk = tuner.link_model(topo, n)
    picks = {f"{c}@{nb}": tuner.selector().schedule(c, n, nb, topo)
             for c in g["collectives"] for nb in g["sizes"]}
    log(f"  tune {fp}: {summary['points']} points, {summary['variants']} "
        f"variants in {wall:.2f} s, launches {launched} (= the variants' "
        f"(warmup + iters) x per-call + refit_link's); best {summary['best']}"
        f"; tuned picks {picks}; tuned to_all(auto, auto) == untuned within "
        f"rtol/atol 1e-4")
    log(f"  fitted link of the 16-PE SIM on {card}: alpha_s "
        f"{lk.alpha_s:.6e} s, bw_Bps {lk.bw_Bps:.6e} B/s, contention "
        f"{lk.contention:.4f}, hop_s {lk.hop_s:.3e} s (the prior's: the "
        f"cost model's default ICI_V5E)")
    return got


def services_attention(ring_walls) -> None:
    """14c: choose_attention at phase 8's ring shape: without a tuner the
    cost model's pick (the argmin of its modeled times, the reference's
    rule); with phase 8's measured ring and mono walls recorded under
    collective "attention", the variant with the smaller measured
    wall."""
    from repro_torch.core import fusion
    from repro_torch.core import tuner as tuner_mod
    n, kv, block = ring_walls["n"], ring_walls["kv_bytes"], \
        ring_walls["block_s"]
    pick, times = fusion.choose_attention(n, kv, block)
    model = "ring" if times["ring"] <= times["mono"] else "mono"
    db = tuner_mod.TuningDB()
    fp = tuner_mod.fingerprint(None, n)
    for algo in ("ring", "mono"):
        db.record(fp, "attention", f"n{n}", kv * n, algo, 1, None,
                  ring_walls[f"{algo}_s"])
    tuned, _ = fusion.choose_attention(n, kv, block,
                                       tuner=tuner_mod.TunedSelector(db))
    faster = min(("ring", "mono"), key=lambda a: ring_walls[f"{a}_s"])
    log(f"  choose_attention(n={n}, kv_block_bytes={kv}): untuned pick "
        f"{pick} (modeled ring {times['ring'] * 1e3:.6f} ms, mono "
        f"{times['mono'] * 1e3:.6f} ms); measured ring "
        f"{ring_walls['ring_s'] * 1e3:.3f} ms, mono "
        f"{ring_walls['mono_s'] * 1e3:.3f} ms; tuned pick {tuned}")
    if pick != model or tuned != faster:
        raise AssertionError(f"choose_attention: untuned {pick} (model "
                             f"{model}), tuned {tuned} (faster {faster})")


def services_engine(torch, np, serving, ServeEngine, served) -> dict:
    """14d: qwen2-0.5b's engine on phase 3's traffic with a LEVEL_FULL
    Tracer and ServeMetrics: tokens identical to phase 3's, both
    documents valid, exact request/token/page counts, and the registry's
    TTFT and per-token p50 beside phase 3's measures of this run, of an
    untraced run right after and of phase 3's run; kernel 4 once a layer
    a request, kernel 8 once a layer a decode step.  Returns the traced
    run's launches (counts set to 0 just before, read just after)."""
    from repro_torch.core.trace import LEVEL_FULL, Tracer
    from repro_torch.serve.metrics import ServeMetrics
    from repro_torch.tools.tracereport import (validate_metrics,
                                               validate_trace)
    cfg, engine_kw = serving.CONFIG, serving.SERVE_ENGINE
    n_req, prompt_len, new_tokens = (
        serving.SERVE_TRAFFIC[k] for k in ("requests", "prompt_len",
                                           "new_tokens"))
    tracer, metrics = Tracer(level=LEVEL_FULL), ServeMetrics()
    metrics.attach(tracer)
    eng = ServeEngine(cfg, device="cuda", init_seed=0, profile=tracer,
                      metrics=metrics, **engine_kw)
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(n_req, prompt_len), dtype=np.int32)
    decodes = []
    _reset_counts()                                     # path starts
    rids, ttft, gaps, _ = drive_engine(
        torch, eng, prompts, new_tokens,
        lambda res: decodes.append(res["decoded"] > 0))
    got = _counts()                                     # path ends
    for rid, want in zip(rids, served["tokens"]):
        if not np.array_equal(eng.results[rid], want):
            raise AssertionError(f"traced request {rid}: "
                                 f"{eng.results[rid].tolist()} != phase "
                                 f"3's {want.tolist()}")
    errs = validate_trace(tracer.to_chrome()) \
        + validate_metrics(metrics.to_json())
    m = metrics.registry
    counts = {k: m[f"serve.{k}"].value for k in (
        "requests_submitted", "requests_completed", "tokens_generated",
        "kv_pages_live")}
    want = {"requests_submitted": n_req, "requests_completed": n_req,
            "tokens_generated": n_req * new_tokens, "kv_pages_live": 0}
    if errs or counts != want:
        raise AssertionError(f"traced engine: schema errors {errs}, counts "
                             f"{counts} (want {want})")
    if got["flash_attention"] != cfg.n_layers * n_req \
            or got["paged_decode"] != cfg.n_layers * sum(decodes):
        raise AssertionError(f"traced engine: {got} launches, "
                             f"{sum(decodes)} decode steps")
    n_events = len(tracer._events)
    # the same traffic untraced, right after: the host-bound engine's
    # per-token time moves by more between runs than the tracer costs
    bare = ServeEngine(cfg, params=eng.params, device="cuda", **engine_kw)
    _, ttft0, gaps0, _ = drive_engine(torch, bare, prompts, new_tokens)
    del bare
    log(f"  traced engine: tokens == phase 3's for all {n_req} requests; "
        f"{n_events} trace events and the metrics document valid; {counts}"
        f"; the registry's TTFT p50 {metrics.ttft_s.percentile(50) * 1e3:.2f}"
        f" ms (submit to first token) and per-token p50 "
        f"{metrics.per_token_s.percentile(50) * 1e3:.3f} ms (a decode "
        f"step's wall); phase 3's measures on this run: TTFT p50 "
        f"{pct(ttft, 50) * 1e3:.2f} ms, per-token p50 "
        f"{pct(gaps, 50) * 1e3:.3f} ms; untraced right after "
        f"{pct(ttft0, 50) * 1e3:.2f} and {pct(gaps0, 50) * 1e3:.3f} ms "
        f"(phase 3's untraced run {served['ttft_p50'] * 1e3:.2f} and "
        f"{served['per_token_p50'] * 1e3:.3f} ms); launches {got}")
    return got


def services_launcher(torch) -> dict:
    """14e: `launch.serve --arch qwen2-0.5b --trace-out --metrics-out` on
    the card writes documents that validate; kernel 8 once a layer a
    decode step.  Returns its launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_launch
    from repro_torch.tools.tracereport import (validate_metrics,
                                               validate_trace)
    out = ROOT / "build" / "phase14"
    out.mkdir(parents=True, exist_ok=True)
    tpath, mpath = out / "trace.json", out / "metrics.json"
    torch.cuda.synchronize()
    decoding, decodes = counting_decodes()
    with decoding:
        _reset_counts()                                 # path starts
        gen = serve_launch.main(["--arch", "qwen2-0.5b", "--trace-out",
                                 str(tpath), "--metrics-out", str(mpath)])
        torch.cuda.synchronize()
        got = _counts()                                 # path ends
    tdoc, mdoc = json.loads(tpath.read_text()), json.loads(mpath.read_text())
    errs = validate_trace(tdoc) + validate_metrics(mdoc)
    done = mdoc["metrics"]["serve.requests_completed"]["value"]
    n_layers = get_config("qwen2-0.5b").n_layers
    if errs or done != gen.shape[0] or got["flash_attention"] < 1 \
            or not decodes["steps"] \
            or got["paged_decode"] != n_layers * decodes["steps"]:
        raise AssertionError(f"launcher documents: {errs}, completed "
                             f"{done} of {gen.shape[0]}, launches {got}, "
                             f"{decodes['steps']} decode steps")
    log(f"  launch.serve --trace-out --metrics-out: {gen.shape} tokens, "
        f"{len(tdoc['traceEvents'])} trace events, both documents valid; "
        f"launches {got}")
    return got


# ---------------------------------------------------------------------------
# phase 15: the elastic runtime on the card — fault injection, the PGAS
# checkpoint stream, kill-and-resume, the serving drain
# ---------------------------------------------------------------------------

# 15c's run: fused steps, the PE that dies and the step it dies at, the
# checkpoint period (the reference's tests/test_fault.py toy run)
FAULT_STEPS, KILL_PE, KILL_STEP, CKPT_EVERY = 9, 5, 5, 2
# 15d: the decode call (1-based) at which a PE is lost: the third step's
DRAIN_AT_DECODE = 3


def same_bits(torch, got, want, what: str) -> None:
    """`got` holds `want`'s bits exactly (shape, dtype and every bit)."""
    if got.shape != want.shape or got.dtype != want.dtype or \
            got.device != want.device:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} "
                             f"{got.device} vs {tuple(want.shape)} "
                             f"{want.dtype} {want.device}")
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[got.element_size()]
    if not torch.equal(got.view(view), want.view(view)):
        raise AssertionError(f"{what}: bits differ")


def _expect_raise(exc_type, fn, what: str):
    """The error `fn()` raises, which must be an `exc_type`."""
    try:
        fn()
    except exc_type as e:
        return e
    raise AssertionError(f"{what}: no {exc_type.__name__} raised")


def elastic_injector(torch, np) -> list:
    """15a: the fault injector against one 1 GiB stacked f32 ppermute (64
    MiB per PE) on 16 PEs, under SIM and NoC-SIM: a dead PE raises
    PEFailure with no launch; a link the YX route avoids reroutes with
    output bit-identical to the unfaulted put; a severed adjacent link
    with heal_after=k fails k attempts, heals, and lands on attempt k + 1
    bit for bit; a straggler's delay is felt at quiet() and its deadline
    raises with the queue untouched.  Returns each sub-phase's launches
    (counts set to 0 just before the faulted call, read just after)."""
    from repro_torch.configs import epiphany16 as paper
    from repro_torch.core import FaultPlan, Profiler, RetryPolicy, sim_ctx
    from repro_torch.core.fault import (DeadlineExceeded, LinkFailure,
                                        PEFailure)
    n, topo = paper.N_PES, paper.TOPOLOGY
    gen = torch.Generator(device="cuda").manual_seed(15)
    x = torch.randn((n, BUCKET_ELEMS), generator=gen, device="cuda")
    retry = RetryPolicy(backoff_s=1e-4)
    one_put = {"put_copy": 1, "dma_copy": 0, "reduce_combine": 0}
    paths = []
    for noc in (False, True):
        kind = "NoC-SIM" if noc else "SIM"
        clean = sim_ctx(n, topo, noc=noc, device="cuda")
        want = {pair: clean.put(x, [pair]) for pair in ((0, 6), (0, 1),
                                                        (3, 2))}

        def ctx_for(plan, **kw):
            return sim_ctx(n, topo, noc=noc, device="cuda", fault=plan,
                           retry=retry, **kw)

        def counts():
            got = _counts()
            return {k: got[k] for k in one_put}

        # a dead PE: typed error at issue, before any launch
        ctx = ctx_for(FaultPlan().kill_pe(3, pe=5))
        ctx.fault_injector.set_step(3)
        torch.cuda.synchronize()
        _reset_counts()                                 # path starts
        e = _expect_raise(PEFailure, lambda: ctx.put_nbi(x, [(5, 6)]),
                          f"{kind} dead PE")
        torch.cuda.synchronize()
        dead = counts()                                 # path ends
        if (e.pe, e.step) != (5, 3) or any(dead.values()) or \
                ctx.pending_count:
            raise AssertionError(f"{kind} dead PE: pe {e.pe}, step "
                                 f"{e.step}, launches {dead}, pending "
                                 f"{ctx.pending_count}")
        _expect_raise(PEFailure, lambda: ctx.to_all(x, "sum"),
                      f"{kind} to_all over a dead PE")

        # a dropped link the YX route avoids: rerouted, bit for bit
        ctx = ctx_for(FaultPlan().drop_link(0, 1, 2))
        _reset_counts()                                 # path starts
        (out,) = ctx.quiet(ctx.put_nbi(x, [(0, 6)]))
        torch.cuda.synchronize()
        reroute = counts()                              # path ends
        same_bits(torch, out, want[(0, 6)], f"{kind} rerouted put")
        if ctx.fault_injector.stats != {"fault.reroutes": 1} or \
                reroute != one_put:
            raise AssertionError(f"{kind} reroute: stats "
                                 f"{ctx.fault_injector.stats}, launches "
                                 f"{reroute}")

        # both routes severed, transient: the k-th failed attempt heals
        heal = {}
        for k in (1, 2):
            prof = Profiler(level=1)
            ctx = ctx_for(FaultPlan().drop_link(0, 0, 1, heal_after=k),
                          profile=prof)
            _reset_counts()                             # path starts
            (out,) = ctx.quiet(ctx.put_nbi(x, [(0, 1)]))
            torch.cuda.synchronize()
            heal[k] = counts()                          # path ends
            same_bits(torch, out, want[(0, 1)], f"{kind} healed put")
            retries = prof.counters().get("fault.retries", {}).get("count")
            if ctx.fault_injector.stats != {"fault.link_hits": k} or \
                    retries != k or heal[k] != one_put:
                raise AssertionError(f"{kind} heal_after={k}: stats "
                                     f"{ctx.fault_injector.stats}, retries "
                                     f"{retries}, launches {heal[k]}")
        # with no heal the retries run out: LinkFailure after 1 + 3 tries
        ctx = ctx_for(FaultPlan().drop_link(0, 0, 1))
        e = _expect_raise(LinkFailure, lambda: ctx.put_nbi(x, [(0, 1)]),
                          f"{kind} severed link")
        if (e.link, e.attempts, e.op) != ((0, 1), 4, "put"):
            raise AssertionError(f"{kind} severed link: {e.link}, "
                                 f"{e.attempts} attempts, op {e.op}")

        # a straggler: the deadline raises at quiet(), queue untouched;
        # within it quiet() waits the delay
        ctx = ctx_for(FaultPlan().slow_pe(0, pe=3, delay_s=0.05))
        _reset_counts()                                 # path starts
        f = ctx.put_nbi(x, [(3, 2)])
        _expect_raise(DeadlineExceeded, lambda: ctx.quiet(deadline_s=0.01),
                      f"{kind} straggler deadline")
        if ctx.pending_count != 1 or f.done:
            raise AssertionError(f"{kind}: the deadline touched the queue")
        torch.cuda.synchronize()
        t = time.perf_counter()
        (out,) = ctx.quiet()
        torch.cuda.synchronize()
        wait = time.perf_counter() - t
        slow = counts()                                 # path ends
        same_bits(torch, out, want[(3, 2)], f"{kind} straggler put")
        if wait < 0.05 or slow != one_put:
            raise AssertionError(f"{kind} straggler: quiet took {wait:.4f}"
                                 f" s, launches {slow}")
        log(f"  15a {kind}, 1 GiB f32 over 16 PEs: dead PE 5 -> PEFailure"
            f"(pe 5, step 3) with launches {dead}; link (1,2) dropped -> "
            f"YX reroute of (0,6), bit for bit, launches {reroute}; link "
            f"(0,1) severed, heal_after 1 / 2 -> lands on attempt 2 / 3 "
            f"bit for bit (retries 1 / 2), launches {heal[1]} / {heal[2]};"
            f" never healed -> LinkFailure after 4 attempts; straggler "
            f"0.05 s -> quiet(deadline 0.01) raised, queue kept, quiet() "
            f"{wait:.4f} s")
        paths += [dead, reroute, heal[1], heal[2], slow]
        del clean, want, out, ctx
    del x
    torch.cuda.empty_cache()
    return paths


def bucket_state(torch, seed: int) -> dict:
    """The fused sync's state at the 64 MiB-per-PE f32 bucket on 16 PEs:
    params p (16, 16777216), the same on every PE, and each PE's owned
    moment chunks m, v (16, 1048576)."""
    n, L = 16, BUCKET_ELEMS
    chunk = -(-L // n)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn(L, generator=gen, device="cuda").expand(n, L) \
        .contiguous()
    m = torch.randn((n, chunk), generator=gen, device="cuda") * 0.1
    v = torch.rand((n, chunk), generator=gen, device="cuda") * 0.01
    return {"p": p, "m": m, "v": v}


def _gib(nbytes) -> str:
    return f"{nbytes / 2**30:.3f} GiB"


def elastic_pgas(torch, np, card) -> dict:
    """15b: the PGAS checkpoint stream of the bucket's state (1.125 GiB)
    on 16 PEs: one begin launches exactly 3 x 15 put_copy rotations;
    drain writes a checkpoint that restore returns bit for bit into
    CUDA templates; begin (async issue) against a synchronous save of
    the same state must stay under 10% of it (the reference's bar,
    benchmarks/bench_fault.py).  Returns the stream's launches (counts
    set to 0 just before begin, read after drain)."""
    import shutil

    from repro_torch.ckpt import manager
    from repro_torch.ckpt.pgas import PgasCheckpointer
    from repro_torch.configs import epiphany16 as paper
    from repro_torch.core import sim_ctx
    n = paper.N_PES
    out = ROOT / "build" / "phase15"
    shutil.rmtree(out, ignore_errors=True)
    state = bucket_state(torch, 16)
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    torch.cuda.synchronize()
    t = time.perf_counter()
    manager.save(out / "sync", 0, state)
    sync_s = time.perf_counter() - t
    shutil.rmtree(out / "sync")
    ctx = sim_ctx(n, paper.TOPOLOGY, device="cuda")
    ck = PgasCheckpointer(ctx, out / "pgas", async_issue=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _reset_counts()                                     # path starts
    t = time.perf_counter()
    n_rot = ck.begin(1, state)
    begin_s = time.perf_counter() - t
    t = time.perf_counter()
    ck.drain()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t
    got = _counts()                                     # path ends
    peak = torch.cuda.max_memory_allocated()
    want = {"put_copy": 3 * (n - 1), "dma_copy": 0, "reduce_combine": 0,
            "fused_update": 0, "flash_attention": 0, "ssd_scan": 0,
            "ring_attention": 0, "paged_decode": 0}
    if n_rot != 3 * (n - 1) or got != want:
        raise AssertionError(f"pgas begin: {n_rot} rotations, launches "
                             f"{got} (want {want})")
    template = {k: torch.empty_like(v) for k, v in state.items()}
    step, back = manager.restore(out / "pgas", template)
    if step != 1:
        raise AssertionError(f"pgas checkpoint restored step {step}")
    for k in state:
        same_bits(torch, back[k], state[k], f"pgas checkpoint {k}")
    del back, template
    shutil.rmtree(out / "pgas")
    log(f"  15b PGAS stream of p, m, v ({_gib(nbytes)}) on 16 PEs: begin "
        f"(async issue) {begin_s * 1e3:.3f} ms, drain {drain_s * 1e3:.1f} "
        f"ms, a synchronous manager.save {sync_s * 1e3:.1f} ms (begin "
        f"{begin_s / sync_s:.2%} of it); peak memory {_gib(peak)} "
        f"({_gib(peak - base)} over the state); restore == state bit for "
        f"bit on the card; launches {got} ({card})")
    if begin_s >= 0.1 * sync_s:
        raise AssertionError(f"pgas begin {begin_s:.4f} s is not under 10% "
                             f"of the synchronous save's {sync_s:.4f} s")
    del state
    torch.cuda.empty_cache()
    return got


def fused_bucket_step(torch, net, state, step: int, wd) -> dict:
    """One step of phase 6b's fused sync on the bucket: step `step`'s
    gradients from Generator(1000 + step), fused_rs_adam at t = step + 1,
    then allgather_unpad of the new params."""
    from repro_torch.core import collectives as coll
    from repro_torch.core import fusion
    n, L = state["p"].shape
    gen = torch.Generator(device="cuda").manual_seed(1000 + step)
    g = torch.randn((n, L), generator=gen, device="cuda")
    t = step + 1
    c1 = torch.tensor(1 - ADAM_HP["b1"] ** t, device="cuda")
    c2 = torch.tensor(1 - ADAM_HP["b2"] ** t, device="cuda")
    new_p, new_m, new_v, info = fusion.fused_rs_adam(
        net, g, state["p"], state["m"], state["v"], wd, c1, c2,
        scale=float(n), out_dtype=torch.float32, **ADAM_HP)
    return {"p": coll.allgather_unpad(net, new_p, info), "m": new_m,
            "v": new_v}


def elastic_resume(torch, np, card) -> list:
    """15c: kill and resume at the bucket's size.  FAULT_STEPS fused steps
    on a victim context whose PE KILL_PE dies at step KILL_STEP, with
    inline PGAS checkpoints every CKPT_EVERY steps and a LEVEL_FULL
    Tracer: PEFailure at the kill; drain; recover returns the last
    checkpoint's step, the dead set and a live ring of 15, and re-keys
    the fingerprint; resumed on a healthy context, p, m, v after the last
    step equal the uninterrupted run's bit for bit; the tracer's chaos
    summary names fault.pe_failure and fault.recovered.  Returns the
    launches of the uninterrupted run, the victim's and the resumed one
    (each: counts set to 0 just before, read just after)."""
    import shutil

    from repro_torch.ckpt.pgas import PgasCheckpointer
    from repro_torch.configs import epiphany16 as paper
    from repro_torch.core import FaultPlan, RetryPolicy, elastic, sim_ctx
    from repro_torch.core import collectives as coll
    from repro_torch.core.fault import PEFailure
    from repro_torch.core.trace import LEVEL_FULL, Tracer
    from repro_torch.tools import tracereport
    n, topo = paper.N_PES, paper.TOPOLOGY
    wd = (torch.arange(BUCKET_ELEMS, device="cuda") % 3 == 0) \
        .to(torch.int8)
    out = ROOT / "build" / "phase15" / "kill"
    shutil.rmtree(out, ignore_errors=True)
    init = bucket_state(torch, 17)

    # the uninterrupted run, each step's wall on the host clock
    healthy = sim_ctx(n, topo, device="cuda")
    st, walls = init, []
    torch.cuda.synchronize()
    _reset_counts()                                     # path starts
    for s in range(FAULT_STEPS):
        t = time.perf_counter()
        st = fused_bucket_step(torch, healthy.net, st, s, wd)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    straight = _counts()                                # path ends
    stages = len(coll.reduce_scatter_schedule(n).stages)
    per_step = {"put_copy": stages + len(coll.allgather_schedule(n).stages),
                "dma_copy": 2, "reduce_combine": stages - 1,
                "fused_update": 1}
    if any(straight[k] != FAULT_STEPS * v for k, v in per_step.items()):
        raise AssertionError(f"uninterrupted run: launches {straight}, "
                             f"{FAULT_STEPS} x {per_step} expected")

    # the victim: PE KILL_PE dies at step KILL_STEP
    tracer = Tracer(level=LEVEL_FULL)
    ctx = sim_ctx(n, topo, device="cuda",
                  fault=FaultPlan().kill_pe(KILL_STEP, pe=KILL_PE),
                  retry=RetryPolicy(backoff_s=1e-4), profile=tracer)
    fp_before = ctx._fp
    inj = ctx.fault_injector
    ck = PgasCheckpointer(ctx, out, async_issue=False)
    vst = init
    torch.cuda.synchronize()
    _reset_counts()                                     # path starts
    try:
        for s in range(FAULT_STEPS):
            inj.set_step(s)
            if s % CKPT_EVERY == 0:
                ck.begin(s, vst)
            vst = fused_bucket_step(torch, ctx.net, vst, s, wd)
        raise AssertionError("the victim ran every step: no PEFailure")
    except PEFailure as e:
        if (e.pe, e.step) != (KILL_PE, KILL_STEP):
            raise AssertionError(f"PEFailure at pe {e.pe}, step {e.step}")
    ck.drain()
    torch.cuda.synchronize()
    victim = _counts()                                  # path ends
    del vst
    ckpts = KILL_STEP // CKPT_EVERY + 1     # begins at steps 0, 2, 4
    floor = {k: KILL_STEP * v for k, v in per_step.items()}
    floor["put_copy"] += ckpts * 3 * (n - 1)
    if any(not 0 <= victim[k] - floor[k] < max(per_step[k], 1)
           for k in per_step):
        raise AssertionError(f"victim: launches {victim}; {KILL_STEP} "
                             f"steps and {ckpts} checkpoints give {floor} "
                             f"and the faulted step less than a step")
    template = {k: torch.empty_like(v) for k, v in init.items()}
    torch.cuda.synchronize()
    t = time.perf_counter()
    step, restored, dm = elastic.recover(ctx, inj.dead_pes, out, template)
    torch.cuda.synchronize()
    recovery_s = time.perf_counter() - t
    last = (KILL_STEP - 1) // CKPT_EVERY * CKPT_EVERY
    if step != last or dm.dead != (KILL_PE,) or len(dm.live) != n - 1 \
            or KILL_PE in dm.live or ctx._fp != dm.fingerprint \
            or ctx._fp == fp_before:
        raise AssertionError(f"recover: step {step}, dead {dm.dead}, live "
                             f"{dm.live}, fingerprint {ctx._fp} (was "
                             f"{fp_before})")
    doc = tracer.to_chrome()
    chaos = tracereport._chaos_report(doc["traceEvents"], doc["repro"])
    text = "\n".join(chaos)
    if "fault.pe_failure" not in text or "fault.recovered" not in text:
        raise AssertionError(f"chaos summary: {chaos}")

    # resume on a healthy context from the restored step
    spare = sim_ctx(n, topo, device="cuda")      # replacement hardware
    torch.cuda.synchronize()
    _reset_counts()                                     # path starts
    rst = restored
    for s in range(step, FAULT_STEPS):
        rst = fused_bucket_step(torch, spare.net, rst, s, wd)
    torch.cuda.synchronize()
    resumed = _counts()                                 # path ends
    for k in ("p", "m", "v"):
        same_bits(torch, rst[k], st[k], f"resumed {k} after step "
                  f"{FAULT_STEPS - 1}")
    if any(resumed[k] != (FAULT_STEPS - step) * v
           for k, v in per_step.items()):
        raise AssertionError(f"resumed run: launches {resumed}")
    shutil.rmtree(out)
    log(f"  15c kill and resume, fused_rs_adam on the 1 GiB bucket over 16 "
        f"PEs: PEFailure(pe {KILL_PE}) at step {KILL_STEP}; recover -> "
        f"step {step}, dead {dm.dead}, live ring of {len(dm.live)} "
        f"{dm.live}, fingerprint {dm.fingerprint!r}; recovery wall "
        f"{recovery_s * 1e3:.1f} ms; resumed p, m, v after step "
        f"{FAULT_STEPS - 1} == uninterrupted, bit for bit; step wall "
        f"(uninterrupted, ms) " + ", ".join(f"{w * 1e3:.3f}" for w in walls)
        + f"; chaos summary: {' | '.join(l.strip() for l in chaos)}; "
        f"launches uninterrupted {straight}, victim {victim}, resumed "
        f"{resumed} ({card})")
    del st, rst, restored, init, template
    torch.cuda.empty_cache()
    return [straight, victim, resumed]


def elastic_serve(torch, np, serving, ServeEngine, served, phase3) -> dict:
    """15d: qwen2-0.5b's engine on phase 3's traffic with PE 1 lost at the
    third step's decode: the step drains (faulted, the live rids in slot
    order requeued at the queue head, no page live, pe_failures 1 and
    requests_requeued n in the metrics), then run() regenerates phase 3's
    tokens exactly, through phase 3's kernel-4 launches plus one layer
    stack per re-prefill, and kernel 8 once a layer a decode step that
    ran (every call but the faulted one).  Returns its launches (counts
    set to 0 just before, read just after)."""
    from repro_torch.core.fault import PEFailure
    from repro_torch.models import transformer
    from repro_torch.serve.metrics import ServeMetrics
    cfg, engine_kw = serving.CONFIG, serving.SERVE_ENGINE
    n_req, prompt_len, new_tokens = (
        serving.SERVE_TRAFFIC[k] for k in ("requests", "prompt_len",
                                           "new_tokens"))
    metrics = ServeMetrics()
    eng = ServeEngine(cfg, device="cuda", init_seed=0, metrics=metrics,
                      **engine_kw)
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(n_req, prompt_len), dtype=np.int32)
    real, seen = transformer.decode_step_paged, {"calls": 0, "live": None}

    def dying(*a, **k):
        seen["calls"] += 1
        if seen["calls"] == DRAIN_AT_DECODE:
            seen["live"] = [st.rid for st in eng.scheduler.slots
                            if st is not None]
            raise PEFailure("PE 1 lost in the decode", pe=1,
                            step=eng.steps)
        return real(*a, **k)

    faulted = []

    def check_drain(res):
        if not res.get("faulted"):
            return
        queue = [r.rid for r in eng.scheduler.queue]
        faulted.append(dict(res, queue=queue,
                            pages=eng.kv.pool.live_pages(),
                            failures=metrics.pe_failures.value,
                            requeued_n=metrics.requests_requeued.value))

    with mock.patch.object(transformer, "decode_step_paged", dying):
        _reset_counts()                                 # path starts
        rids, ttft, gaps, wall = drive_engine(torch, eng, prompts,
                                              new_tokens, check_drain)
        got = _counts()                                 # path ends
    if len(faulted) != 1:
        raise AssertionError(f"{len(faulted)} faulted steps, want 1")
    (f,) = faulted
    live = seen["live"]
    if f["pe"] != 1 or f["requeued"] != live or not live \
            or f["queue"][:len(live)] != live or f["pages"] != 0 \
            or f["failures"] != 1 or f["requeued_n"] != len(live):
        raise AssertionError(f"drain: {f}, live before it {live}")
    for rid, want in zip(rids, served["tokens"]):
        if not np.array_equal(eng.results[rid], want):
            diff = int(np.argmax(eng.results[rid] != want))
            raise AssertionError(f"request {rid} after the drain: first "
                                 f"divergence at token {diff}: "
                                 f"{eng.results[rid].tolist()} != phase "
                                 f"3's {want.tolist()}")
    want_fa = phase3["flash_attention"] + cfg.n_layers * len(live)
    want_pd = cfg.n_layers * (seen["calls"] - 1)
    if got["flash_attention"] != want_fa or got["paged_decode"] != want_pd:
        raise AssertionError(f"drained engine: {got['flash_attention']} "
                             f"kernel-4 launches, want {want_fa}; "
                             f"{got['paged_decode']} kernel-8, want "
                             f"{want_pd}")
    log(f"  15d {cfg.name} engine, PE 1 lost at the third step's decode: "
        f"the step drained on PE {f['pe']}, requeued {f['requeued']} (the "
        f"live rids in slot order) at the queue head {f['queue']}, 0 pages "
        f"live, "
        f"pe_failures 1, requests_requeued {len(live)}; tokens == phase "
        f"3's for all {n_req} requests; TTFT p50 {pct(ttft, 50) * 1e3:.2f} "
        f"ms, per-token p50 {pct(gaps, 50) * 1e3:.3f} ms (phase 3 "
        f"{served['ttft_p50'] * 1e3:.2f}, {served['per_token_p50'] * 1e3:.3f}"
        f" ms); {wall:.3f} s, {eng.steps} engine steps; launches {got} "
        f"(phase 3's {phase3['flash_attention']} + {cfg.n_layers} x "
        f"{len(live)} re-prefills)")
    return got


# ---------------------------------------------------------------------------
# phase 16: the SPMD backend — rank processes sharing the card
# ---------------------------------------------------------------------------
# Each rank is a process of core.spmd.run on this one card (time-sliced:
# kernels of different ranks do not overlap); every PE's receive slots
# live in one symmetric heap the ranks map by CUDA IPC, and a put is a
# dma_copy launch of the sending rank into its peer's slot.  The rank
# bodies below are module-level so the spawned ranks can import them.

SPMD_COLLECTIVES = ("broadcast3", "broadcast5", "fcollect", "collect",
                    "alltoall", "sum", "max", "ring")
SPMD_MOVES = ("broadcast3", "broadcast5", "fcollect", "collect", "alltoall")
SPMD_BUCKET_ELEMS = 16 * 1024 * 1024        # 64 MiB of f32: one bucket
# 16b's steps: 2 since phase 22 joined the run (3 at PR 29, 4 before),
# enough for a step after the first update; every gate is kept
SPMD_TRAIN = dict(steps=2, seq_len=512, batch=8, data=2, model=2)
# 16b: the largest |2x2 loss - 1x1 loss| allowed at each step.  On the
# H100 the readings are 9.54e-07, 1.16e-3, 1.37e-3, 1.48e-3 for both
# syncs, the same in every run (PERF.md § 6): the bounds leave 2-10x
# room above them, and far below what a dropped tensor-parallel
# allreduce does to the loss (a deliberately broken copy, smoke size).
SPMD_LOSS_TOL = (1e-5, 3e-3, 3e-3, 3e-3)


def _spmd_bucket(torch, q):
    """Rank q's 64 MiB f32 bucket for 16a's timed allreduce."""
    gen = torch.Generator(device="cuda").manual_seed(1600 + q)
    return torch.randn(1, SPMD_BUCKET_ELEMS, device="cuda", generator=gen)


def _spmd_inputs(torch, n):
    """The collectives' inputs, the same in every rank and in the
    parent: (n, 4096) f32 and (n, n * 1024) f32 for alltoall."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    return (torch.randn(n, 4096, device="cuda", generator=gen),
            torch.randn(n, n * 1024, device="cuda", generator=gen))


def spmd_collectives_rank(n, comm_2x2):
    """16a, one rank: test_spmd_equiv's collectives through spmd_ctx over
    all n ranks; on 4 ranks also Comm over a 2x2 mesh, and the wall and
    the result of the 64 MiB allreduce: its largest error against the
    plain sum of every rank's bucket (in f64), and its largest excess
    over the f32 rounding bound of an n-term sum in any order,
    gamma_(n-1) * sum_q |x_q| (u = 2^-24), which must be <= 0."""
    import torch
    from repro_torch.core import spmd, spmd_ctx
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.parallel.comm import AxisSpec, Comm
    rt = spmd.current()
    r = rt.rank
    x, x2 = _spmd_inputs(torch, n)
    make_rank_mesh((n,), ("pe",))
    ctx = spmd_ctx("pe")
    xl, x2l = x[r:r + 1], x2[r:r + 1]
    _reset_counts()
    out = {"broadcast3": ctx.broadcast(xl, 3),
           "broadcast5": ctx.broadcast(xl, 5), "fcollect": ctx.fcollect(xl),
           "collect": ctx.collect(xl), "alltoall": ctx.alltoall(x2l),
           "sum": ctx.to_all(xl, "sum"), "max": ctx.to_all(xl, "max"),
           "ring": ctx.to_all(xl, "sum", algorithm="ring")}
    torch.cuda.synchronize()
    out["counts"] = _counts()
    if comm_2x2:
        make_rank_mesh((2, 2), ("data", "model"))
        comm = Comm(AxisSpec())
        y = x[r:r + 1, :1024].clone()
        _reset_counts()
        for ax in ("model", "data"):
            b = comm.allgather(y, ax, concat_axis=0)
            out[f"comm/{ax}/allreduce"] = comm.allreduce(y, ax)
            out[f"comm/{ax}/allgather"] = b
            out[f"comm/{ax}/reduce_scatter"] = comm.reduce_scatter(
                b, ax, scatter_axis=0)
        torch.cuda.synchronize()
        out["comm_counts"] = _counts()
        make_rank_mesh((n,), ("pe",))
        big = _spmd_bucket(torch, r)
        ctx = spmd_ctx("pe")
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            rt.barrier()
            t0 = time.perf_counter()
            got = ctx.to_all(big, "sum")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out["bucket_walls"] = walls
        xs = torch.cat([_spmd_bucket(torch, q) for q in range(n)]).double()
        u = 2.0 ** -24
        gamma = (n - 1) * u / (1 - (n - 1) * u)
        err = (got.double() - xs.sum(0, keepdim=True)).abs()
        out["bucket_err"] = (float(err.max()), float(
            (err - gamma * xs.abs().sum(0, keepdim=True)).max()))
        del xs, err, got
    return out


def spmd_collectives(torch, np, card) -> list:
    """16a: the collectives on 4 and 8 rank processes against sim_ctx(n)
    on the card (bit for bit for data movement, rtol 1e-5 for the
    reductions); Comm's allreduce, allgather and reduce_scatter over
    `model` and `data` of a 2x2 mesh against their plain sums and
    concatenations; the ranks' kernel launches; the wall of one
    allreduce of a 64 MiB bucket over 4 ranks.  Returns the launch
    counts of the runs, summed over their ranks."""
    from repro_torch.core import sim_ctx, spmd
    paths = []
    for n in (4, 8):
        t0 = time.perf_counter()
        res = spmd.run(spmd_collectives_rank, n, n, n == 4, device="cuda")
        wall = time.perf_counter() - t0
        x, x2 = _spmd_inputs(torch, n)
        sim = sim_ctx(n)
        want = {"broadcast3": sim.broadcast(x, 3),
                "broadcast5": sim.broadcast(x, 5),
                "fcollect": sim.fcollect(x), "collect": sim.collect(x),
                "alltoall": sim.alltoall(x2), "sum": sim.to_all(x, "sum"),
                "max": sim.to_all(x, "max"),
                "ring": sim.to_all(x, "sum", algorithm="ring")}
        for name in SPMD_COLLECTIVES:
            got = torch.cat([r_[name] for r_ in res]).cuda()
            if name in SPMD_MOVES:
                if not torch.equal(got, want[name]):
                    raise AssertionError(f"16a: {name} on {n} ranks differs "
                                         f"from sim_ctx({n})")
            else:
                err = float(((got - want[name]).abs()
                             / want[name].abs().clamp_min(1e-30)).max())
                if not torch.allclose(got, want[name], rtol=1e-5, atol=0):
                    raise AssertionError(f"16a: {name} on {n} ranks off by "
                                         f"{err:.3g} relative")
        counts = [r_["counts"] for r_ in res]
        log(f"  16a {n} ranks: {len(SPMD_COLLECTIVES)} collectives == "
            f"sim_ctx({n}) (moves bit for bit, reductions at rtol 1e-5); "
            f"run wall {wall:.1f} s (spawn included); launches per rank "
            f"(put_copy, dma_copy, reduce_combine): "
            + ", ".join(f"({c['put_copy']}, {c['dma_copy']}, "
                        f"{c['reduce_combine']})" for c in counts))
        paths.append({k: sum(c[k] for c in counts) for k in counts[0]})
        if n != 4:
            continue
        y = x[:, :1024]
        for ax in ("model", "data"):
            # rank r = (d, m) = divmod(r, 2); the group over `ax`
            groups = [[g * 2 + i for i in range(2)] if ax == "model"
                      else [i * 2 + g for i in range(2)] for g in range(2)]
            for g in groups:
                for pos, r_ in enumerate(g):
                    ar = y[g[0]:g[0] + 1] + y[g[1]:g[1] + 1]
                    ag = torch.cat([y[q:q + 1] for q in g])
                    rs = (ag + ag)[pos:pos + 1]
                    got = res[r_]
                    if not torch.allclose(got[f"comm/{ax}/allreduce"].cuda(),
                                          ar, rtol=1e-5, atol=0) or \
                            not torch.equal(got[f"comm/{ax}/allgather"].cuda(),
                                            ag) or \
                            not torch.allclose(
                                got[f"comm/{ax}/reduce_scatter"].cuda(), rs,
                                rtol=1e-5, atol=0):
                        raise AssertionError(f"16a: Comm over {ax} on rank "
                                             f"{r_} differs from the plain "
                                             f"version")
        cc = [r_["comm_counts"] for r_ in res]
        paths.append({k: sum(c[k] for c in cc) for k in cc[0]})
        walls = [min(r_["bucket_walls"][1:]) for r_ in res]
        errs = [r_["bucket_err"] for r_ in res]
        if any(ex > 0 for _, ex in errs):
            raise AssertionError(f"16a: the 64 MiB allreduce exceeds the "
                                 f"f32 rounding bound of the plain sum: "
                                 f"{errs}")
        log(f"  16a Comm on 2x2: allreduce, allgather, reduce_scatter over "
            f"model and data == plain (rtol 1e-5; gathers bit for bit); "
            f"launches per rank " + ", ".join(
                f"({c['put_copy']}, {c['dma_copy']}, {c['reduce_combine']})"
                for c in cc))
        log(f"  16a one allreduce (rd) of a 64 MiB f32 bucket over 4 ranks: "
            f"{max(walls) * 1e3:.1f} ms wall (best of 3 after one warm-up, "
            f"slowest rank; {card}); == the plain sum of the 4 buckets "
            f"within the f32 bound gamma_3 sum|x| (max abs err "
            f"{max(e for e, _ in errs):.3g})")
    return paths


def tok_s_text(tok: int, walls) -> str:
    """Train tok/s over the steps after the first (whose wall holds the
    ranks' warm-up), or over the one step when a run takes one."""
    if len(walls) > 1:
        return (f"{tok * (len(walls) - 1) / sum(walls[1:]):.1f} train tok/s "
                f"(steps 2..{len(walls)})")
    return f"{tok / walls[0]:.1f} train tok/s (its one step, warm-up in it)"


def seed0_shards(torch, cfg, mesh):
    """This rank's shards of the 1x1 launcher's seed-0 tree fitted to
    `mesh` (drawn here, as 16b's ranks draw it; no 1x1 leaf is kept)."""
    from repro_torch.models import convert, transformer
    shards = transformer.map_params(torch.clone, convert.local_shards(
        convert.fit_global(transformer.init_params(cfg, seed=0,
                                                   device="cuda"),
                           cfg, tp=mesh.sizes["model"],
                           dp=mesh.sizes["data"]), cfg, mesh))
    gc.collect()
    torch.cuda.empty_cache()
    return shards


def mesh_train_rank(argv, fused_steps, extra=None):
    """16b, 17c, one rank: the 1x1 launcher's seed-0 tree fitted to the
    mesh (`convert.fit_global`; every rank draws the same 1x1 tree, so
    none is handed it) and cut to this rank's shards; the launcher's
    loop (`launch.train.train_loop`) on `argv` from its own copy of
    them (updated in place), then `fused_steps` steps of
    build.make_train_step with grad_rs="fused" from the same shards; the
    launch counts, walls, peak memory, heap rounds and host time in the
    syncs of each.  With `extra`, (key, function name, arguments) of
    later phases' work, each follows in the same (warm) ranks, its
    result under "extra" by key (phase 20's `fsdp_rank4`, 21's
    `pod_rank4`)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import spmd
    from repro_torch.core.heap import tree_flatten
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import build
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as tstep
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rt = spmd.current()
    args = train_mod.parse_args(argv)
    cfg, mesh = get_config(args.arch), rt.mesh
    shards = seed0_shards(torch, cfg, mesh)
    out = {}
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated()
    own = transformer.map_params(torch.clone, shards)   # the default run's
    # phase 23: the bytes of a rank's parameters and optimizer state (the
    # launcher's: f32 moments and the step), as the allocator reads them
    ostate = opt.init_state(own, opt.AdamWConfig(
        moment_dtype=cfg.moment_dtype), cfg.local_global_period)
    torch.cuda.synchronize()
    state_alloc = (torch.cuda.memory_allocated() - a0,
                   len(tree_flatten((own, ostate))[0]))
    del ostate
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                                   # path (i) starts
    r0, s0, c0 = rt.rounds, rt.sync_s, rt.lib_calls
    res = train_mod.train_loop(args, shards=own)
    torch.cuda.synchronize()
    out["default"] = dict(losses=res.losses, walls=res.step_s,
                          counts=_counts(),
                          peak=torch.cuda.max_memory_allocated(),
                          rounds=rt.rounds - r0, sync_s=rt.sync_s - s0,
                          lib_calls=rt.lib_calls - c0,
                          state_alloc=state_alloc)
    del res, own
    torch.cuda.empty_cache()
    adamw = opt.AdamWConfig(lr=args.lr, moment_dtype=cfg.moment_dtype)
    step, _, _ = build.make_train_step(cfg, mesh, grad_rs="fused",
                                       adamw=adamw)
    params = shards        # no second reference: each step frees the last
    del shards
    state = tstep.init_fused_opt_state(params, mesh.sizes["data"])
    n_buckets = len(tstep.plan_fused_buckets(tree_flatten(params)[0]))
    pipe = SyntheticLM(cfg.vocab, args.seq_len, args.batch)
    losses, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                                   # path (ii) starts
    r0, s0 = rt.rounds, rt.sync_s
    for s in range(fused_steps):
        t0 = time.perf_counter()
        loss, params, state = step(params, state, pipe.batch(s))
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    out["fused"] = dict(losses=losses, walls=walls, counts=_counts(),
                        peak=torch.cuda.max_memory_allocated(),
                        n_buckets=n_buckets, rounds=rt.rounds - r0,
                        sync_s=rt.sync_s - s0,
                        digest=[float(t.double().sum())
                                for t in tree_flatten(params)[0]])
    if extra:
        del params, state, step
        gc.collect()
        torch.cuda.empty_cache()
        out["extra"] = {key: globals()[fn](*args) for key, fn, args in extra}
    return out


def mesh_train(torch, np, cfg, run, tol, card, label, extra=None) -> tuple:
    """16b and 17c: `cfg` at full width on a data x model mesh of rank
    processes on the card (`run`: steps, seq_len, batch, lr, data,
    model): the port's 1x1 launcher first, run's steps on run's batches
    from its seed-0 init; then the ranks from that init fitted to the
    mesh (`mesh_train_rank`: each rank draws and fits it itself, so no
    global tree is held here while the ranks run), through the
    launcher's loop (default sync) and as many steps with the fused
    sync.  Gates: every loss of both runs within `tol` of the 1x1 loss
    of its step (the first also within the reference's
    test_tp2_matches_single_device bound), equal on all ranks, finite;
    the fused step-0 loss equal to the default one (the same forward);
    after the fused steps the data replicas of each model shard holding
    the same parameters (per-leaf f64 sums equal); per rank and
    microbatch (remat recomputing each layer's forward) kernel 4 twice
    an attention layer (the hybrid family's: an application of its
    shared block), kernel 7 twice a Mamba2 layer, and kernel 5 once a
    bucket a fused step.  Returns the launch counts of both runs, summed
    over the ranks, kernel 4's per rank, the 1x1 losses, and each rank's
    results of `extra` (later phases' work, run in the same ranks after
    both runs, by key) beside its default run's under "default"."""
    from repro_torch.launch import build
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer
    dims = (run["data"], run["model"])
    argv = ["--arch", cfg.name, "--seq-len", str(run["seq_len"]),
            "--batch", str(run["batch"]), "--lr", str(run["lr"]),
            "--device", "cuda", "--steps", str(run["steps"])]
    t0 = time.perf_counter()
    l1 = train_mod.run(argv).losses          # from its seed-0 init
    log(f"  {label} 1x1 launcher, {run['steps']} steps at seq "
        f"{run['seq_len']} batch {run['batch']}: losses {l1!r} "
        f"({time.perf_counter() - t0:.1f} s)")
    gc.collect()
    torch.cuda.empty_cache()
    mesh_argv = argv + ["--data", str(dims[0]), "--model", str(dims[1])]
    t0 = time.perf_counter()
    # the fused steps peak near 17 GiB a rank at zamba2's width (every
    # bucket's packed gradient, parameters and new moments alive at
    # once): the ranks' allocators grow their segments in place instead
    # of stranding ~0.5-1 GiB a rank
    with mock.patch.dict("os.environ",
                         PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"):
        res = build.shard_mapped(
            mesh_train_rank, dims,
            [(mesh_argv, run["steps"], extra)] * math.prod(dims),
            device="cuda")
    wall = time.perf_counter() - t0
    b_local = run["batch"] // dims[0]
    mb = max(1, min(cfg.microbatches, b_local))
    n = mb * run["steps"]
    n_ssd = cfg.n_layers if cfg.ssm is not None else 0
    n_attn = (transformer.n_shared_blocks(cfg) if cfg.family == "hybrid"
              else cfg.n_layers - n_ssd)
    paths = []
    for kind in ("default", "fused"):
        per = [r_[kind] for r_ in res]
        losses = per[0]["losses"]
        if any(p["losses"] != losses for p in per):
            raise AssertionError(f"{label} {kind}: ranks disagree on the "
                                 f"loss")
        if not np.isfinite(losses).all():
            raise AssertionError(f"{label} {kind}: non-finite loss "
                                 f"{losses}")
        diffs = [abs(a - b) for a, b in zip(losses, l1)]
        log(f"  {label} {kind} {dims[0]}x{dims[1]} vs 1x1, |loss diff| per "
            f"step: " + ", ".join(f"{d:.4g}" for d in diffs)
            + " (bound " + ", ".join(f"{t:g}" for t in tol) + f"; {card})")
        if len(losses) != len(l1) or any(
                not d <= t for d, t in zip(diffs, tol)):
            raise AssertionError(f"{label} {kind}: the mesh's losses "
                                 f"{losses} are not the 1x1 losses {l1} "
                                 f"within {tol}")
        for r_, p in enumerate(per):
            want = dict(flash_attention=2 * n_attn * n,
                        ssd_scan=2 * n_ssd * n,
                        fused_update=p["n_buckets"] * run["steps"]
                        if kind == "fused" else 0)
            got = {k: p["counts"][k] for k in want}
            if got != want:
                raise AssertionError(f"{label} {kind}: rank {r_} launched "
                                     f"{got}, the formulas give {want}")
        walls = per[0]["walls"]
        tok = run["seq_len"] * run["batch"]
        log(f"  {label} {kind} sync on {dims[0]}x{dims[1]}: losses "
            + ", ".join(f"{x:.5f}" for x in losses)
            + "; step wall ms (rank 0) "
            + ", ".join(f"{w * 1e3:.1f}" for w in walls)
            + f"; {tok_s_text(tok, walls)}; peak per rank GiB "
            + ", ".join(f"{p['peak'] / 2**30:.3f}" for p in per)
            + "; launches per step per rank (flash, ssd, put, dma, combine, "
            "fused): " + ", ".join(
                f"{per[0]['counts'][k] / run['steps']:g}"
                for k in ("flash_attention", "ssd_scan", "put_copy",
                          "dma_copy", "reduce_combine", "fused_update"))
            + (f"; {per[0]['n_buckets']} fused buckets a rank"
               if kind == "fused" else "")
            + f"; heap rounds (a slot-sized chunk of a ppermute round "
            f"each) a step {per[0]['rounds'] / run['steps']:g}, host time "
            f"in their syncs a step (stream wait + barrier; ranks) ms "
            + ", ".join(f"{p['sync_s'] / run['steps'] * 1e3:.1f}"
                        for p in per))
        paths.append({k: sum(p["counts"][k] for p in per)
                      for k in per[0]["counts"]})
    l2 = res[0]["default"]["losses"][0]
    log(f"  {label} step-0 loss: 1x1 {l1[0]!r}, mesh {l2!r}, |diff| "
        f"{abs(l1[0] - l2):.3g} (the reference's bound 0.05 x max(1, |l1|) "
        f"= {0.05 * max(1.0, abs(l1[0])):.3g}); both mesh runs in one "
        f"spawn: {wall:.1f} s"
        + "".join(f", phase {k}'s work {v['wall']:.1f} s of it"
                  for k, v in res[0].get("extra", {}).items())
        + f" ({card})")
    if not abs(l1[0] - l2) < 0.05 * max(1.0, abs(l1[0])):
        raise AssertionError(f"{label}: the mesh's loss {l2} is not the 1x1 "
                             f"loss {l1[0]}")
    for m in range(dims[1]):              # rank r = (d, m) = divmod(r, tp)
        digests = [res[d * dims[1] + m]["fused"]["digest"]
                   for d in range(dims[0])]
        if any(g != digests[0] for g in digests):
            raise AssertionError(f"{label} fused: the data replicas of "
                                 f"model shard {m} hold different "
                                 f"parameters")
    if res[0]["fused"]["losses"][0] != l2:
        raise AssertionError(f"{label}: the fused step-0 loss "
                             f"{res[0]['fused']['losses'][0]!r} is not the "
                             f"default one {l2!r} (the same forward)")
    return paths, sum(r_[k]["counts"]["flash_attention"]
                      for r_ in res[:1] for k in ("default", "fused")), l1, \
        [dict(r_.get("extra", {}), default=r_["default"]) for r_ in res]


# ---------------------------------------------------------------------------
# phase 17: expert parallelism, and the Mamba2 and MLA layers at tp > 1
# ---------------------------------------------------------------------------
# 17a holds Comm.alltoall over rank processes (the paper's pairwise
# exchange through the heap) and its gradient to sim_ctx(n) bit for bit,
# and kernels 4 and 7 at the per-rank shapes of 17b-17d to their plain
# versions; 17b trains granite-moe-3b-a800m on a 1x4 mesh (its 40
# experts 10 a rank); 17c zamba2-1.2b on 2x2 (Mamba2 and the shared
# attention at tp 2); 17d runs deepseek-v3 cut to the 4 layers of its
# SERVE_RUN forward on 2x2 (MLA at tp 2, its 256 experts over (data,
# model), 64 a rank).  No rank is handed a whole tree: in 17b and 17d
# each rank draws its own seed-0 parameters, as a launcher does (every
# rank's init is the same local tree, and the 1x1 run it is held to runs
# on that tree tiled along each sharded dim, `tiled_global`); in 17c, as
# in 16b, each rank fits the 1x1 seed-0 tree itself (`mesh_train_rank`).

# (mesh, axis) of each exchange 17a holds; EP_A2A_ROWS f32 rows of 256 a
# block per destination PE (512 KiB)
EP_EXCHANGES = (((1, 4), "model"), ((2, 2), ("data", "model")),
                ((1, 8), "model"))
EP_A2A_ROWS = 512
# 17b and 17c: the launcher's loop at this sequence length, global batch
# and step count (the configs' own microbatches: granite 2, zamba2 8,
# clamped to the local batch of 4 on 2x2).  One step since phase 22
# joined the run (2 at PR 29, 3 before); every gate is kept
EP_TRAIN = dict(seq_len=512, batch=8, steps=1)
# 17d: deepseek-v3's forward at this global batch and length on 2x2
EP_DS = dict(seq_len=512, batch=4)
# the layer gates: one MoE layer in f32 compute at a no-drop capacity,
# the mesh's output and input gradient within EP_GATE_RTOL x max|1x1| of
# the 1x1 layer's, its picks exactly the 1x1 picks.  Tokens: granite
# (8, 512) on 1x4 (the rank's dispatch buffer (40, 1024, 1536) f32, 252
# MB); deepseek one (1, 64) batch a data row on 2x2 (t_local 32: (256,
# 32, 7168) f32, 235 MB, under 256 MiB)
EP_GATE_RTOL = 1e-5
EP_GATE_TOKENS = {"granite-moe-3b-a800m": (8, 512),
                  "deepseek-v3-671b": (1, 64)}
# 17b: the largest spread of each step's loss over the 4 ranks.  Each
# rank adds its own MoE aux loss (0.01 x aux / n_layers, aux from the
# gates of the rank's own token slice: the reference's semantics), so
# the ranks' losses differ by the aux term's spread and by nothing
# else (the cross-entropy is computed from the gathered and allreduced
# activations, the same on every rank).  The term lies in [0, 0.01 x
# n_experts]; its spread grows once the first update concentrates the
# routes.  On the H100 the readings are 3.29e-3, 1.50e-2, 4.20e-3
# (PERF.md § 6): the bounds leave ~3x room.
EP_RANK_SPREAD = (1e-2, 5e-2, 1.5e-2)
# 17c: the largest |2x2 loss - 1x1 loss| at each step (SPMD_LOSS_TOL's
# rule).  At tp 2 Mamba2's gated norm runs over each shard's own 2048
# channels (the reference's layout), so the 2x2 model is not the 1x1
# model: its step-0 loss is ~1.5e-2 away, within the reference's 0.05 x
# max(1, |l1|), and Adam's first steps from other gradients carry it
# ~0.1 further.  On the H100 the readings are 1.536e-2, 0.101, 0.118 for
# both syncs (PERF.md § 6): the bounds leave ~3x room.
EP_ZAMBA_LOSS_TOL = (5e-2, 0.3, 0.35)


def _ep_exchange_inputs(torch, n):
    """17a's global input and upstream gradient: (n, n * EP_A2A_ROWS,
    256) f32 each, the same in every rank and in the parent."""
    gen = torch.Generator(device="cuda").manual_seed(1700 + n)
    return (torch.randn(n, n * EP_A2A_ROWS, 256, device="cuda",
                        generator=gen),
            torch.randn(n, n * EP_A2A_ROWS, 256, device="cuda",
                        generator=gen))


def ep_exchange_rank(cases):
    """17a, one rank: Comm.alltoall over each (mesh, axis) of `cases`
    that has this run's rank count, on its row of the seeded input, then
    the backward of sum(g * out) under the seeded upstream gradient g;
    the launches and heap rounds of each exchange (forward and
    backward), counted from 0."""
    import torch
    from repro_torch.core import spmd
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.parallel.comm import AxisSpec, Comm
    rt = spmd.current()
    out = []
    for dims, axis in cases:
        mesh = make_rank_mesh(dims, ("data", "model"))
        n = mesh.axis_size(axis)
        x, g = _ep_exchange_inputs(torch, n)
        u = x[mesh.axis_index(axis)].clone().requires_grad_()
        comm = Comm(AxisSpec())
        torch.cuda.synchronize()
        _reset_counts()
        r0 = rt.rounds
        y = comm.alltoall(u, axis, split_axis=0, concat_axis=0)
        (y * g[mesh.axis_index(axis)]).sum().backward()
        torch.cuda.synchronize()
        out.append(dict(y=y.detach(), grad=u.grad, counts=_counts(),
                        rounds=rt.rounds - r0))
    return out


def ep_exchange(torch) -> list:
    """17a: each exchange of EP_EXCHANGES on its rank processes, its
    output and its gradient bit for bit sim_ctx(n)'s alltoall of the
    same global input and upstream gradient (the pairwise exchange is
    its own inverse), and its launches per rank: per exchange and per
    direction n - 1 heap rounds, each a kernel-2 store into the peer's
    slot and a read of its own, and two kernel-2 block moves (the
    pre-rotation and the post-gather), so 4n kernel-2 launches, no
    kernel-1 or kernel-3 launch.  Returns the launch counts summed over
    ranks."""
    from repro_torch.core import sim_ctx, spmd
    paths = []
    for world in (4, 8):
        cases = [(d, a) for d, a in EP_EXCHANGES if math.prod(d) == world]
        t0 = time.perf_counter()
        res = spmd.run(ep_exchange_rank, world, cases, device="cuda")
        wall = time.perf_counter() - t0
        for i, (dims, axis) in enumerate(cases):
            n = world
            x, g = _ep_exchange_inputs(torch, n)
            sim = sim_ctx(n)
            want_y, want_g = sim.alltoall(x), sim.alltoall(g)
            got_y = torch.cat([r[i]["y"][None] for r in res]).cuda()
            got_g = torch.cat([r[i]["grad"][None] for r in res]).cuda()
            same_bits(torch, got_y, want_y, f"17a alltoall over {axis} "
                      f"of {dims[0]}x{dims[1]}")
            same_bits(torch, got_g, want_g, f"17a alltoall's gradient over "
                      f"{axis} of {dims[0]}x{dims[1]}")
            for r_, rr in enumerate(res):
                c = rr[i]["counts"]
                want = dict(c, dma_copy=4 * n, put_copy=0, reduce_combine=0)
                if c != want or rr[i]["rounds"] != 2 * (n - 1):
                    raise AssertionError(
                        f"17a {axis} of {dims}: rank {r_} launched {c} in "
                        f"{rr[i]['rounds']} heap rounds, want dma_copy "
                        f"{4 * n}, no put_copy or reduce_combine, "
                        f"{2 * (n - 1)} rounds")
            counts = [r[i]["counts"] for r in res]
            paths.append({k: sum(c[k] for c in counts) for k in counts[0]})
            log(f"  17a Comm.alltoall over {axis} of {dims[0]}x{dims[1]} "
                f"({n} PEs, {x[0].numel() * 4 // n} B a block): output and "
                f"gradient == sim_ctx({n}).alltoall bit for bit; per rank "
                f"{2 * (n - 1)} heap rounds and {4 * n} dma_copy launches "
                f"(forward + backward)")
        log(f"  17a {world}-rank run wall {wall:.1f} s (spawn included)")
    return paths


def ep_rank_shapes(granite_cfg, zamba_cfg, ds_cfg, mb) -> list:
    """(label, Hq, Hkv, D, Dv, window, softcap, launches a rank, causal,
    B) of kernel 4's calls in 17b-17d, per rank: granite at tp 4 (6 of
    24 q heads, 2 of 8 KV heads), zamba2's shared block at tp 2 (16 of
    32), deepseek's MLA at tp 2 (64 of 128 heads at D 192, Dv 128); B
    the local microbatch."""
    g, z, ds = granite_cfg, zamba_cfg, ds_cfg
    m = ds.mla
    steps = EP_TRAIN["steps"]
    nz = -(-z.n_layers // z.hybrid_attn_period)
    return [(g.name + " tp4", g.n_heads // 4, g.n_kv_heads // 4, g.hd, g.hd,
             None, None, 2 * g.n_layers * mb["granite"] * steps, True,
             EP_TRAIN["batch"] // mb["granite"]),
            (z.name + " tp2", z.n_heads // 2, z.n_kv_heads // 2, z.hd, z.hd,
             None, None, 2 * 2 * nz * mb["zamba"] * steps, True,
             EP_TRAIN["batch"] // 2 // mb["zamba"]),
            (ds.name + " MLA tp2", ds.n_heads // 2, ds.n_heads // 2,
             m.qk_nope_dim + m.qk_rope_dim, m.v_dim, None, None,
             ds.n_layers + 1, True, EP_DS["batch"] // 2)]


def ep_check_kernels(torch, ops, ref, fa, gen, shapes, zamba_cfg) -> None:
    """17a: kernel 4 at each per-rank shape over EP_TRAIN's 512 tokens,
    bf16 (on the tensor cores) and f32, against `plain_attention` within
    phase 2's limits; kernel 7 at zamba2's tp-2 shape (H 32, P 64, N 64,
    chunk 128, L 512; the model's draws), contiguous and strided, f32
    and bf16, against the plain chunked version and each of its phases
    (phase 9's limits)."""
    seq = EP_TRAIN["seq_len"]
    for label, hq, hkv, d, dv, _, _, _, causal, b in shapes:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = attention_inputs(torch, gen, b, hq, hkv, seq, seq, d,
                                       dt, dv)
            out = ops.attention(q, k, v, causal=causal)
            want = plain_attention(torch, ref, q, k, v, causal=causal)
            torch.cuda.synchronize()
            err, over = attention_over(torch, out, want, dt)
            route = "tensor cores" if fa.tensor_core_route(q, k, v) \
                else "CUDA cores"
            log(f"  17a kernel 4 at {label} B{b} Hq{hq} Hkv{hkv} L{seq} D{d} "
                f"Dv{dv} {dt} ({route}): max|err| {err:.3e} (worst "
                f"err/limit {over:.3f})")
            if dt == torch.bfloat16 and route != "tensor cores":
                raise AssertionError(f"17a: kernel 4 at {label} did not take "
                                     f"the tensor cores")
            if not (over <= 1.0 and torch.isfinite(out).all()):
                raise AssertionError(f"17a: kernel 4 at {label} {dt}: "
                                     f"err/limit {over}")
            del q, k, v, out, want
    s = zamba_cfg.ssm
    h = s.expand * zamba_cfg.d_model // s.head_dim // 2
    cases = []
    for dtype, scale in (("float32", 0.3), ("bfloat16", 1.0)):
        cases.append(("zamba_tp2_L512", 1, seq, h, s.head_dim, s.state, 1,
                      s.chunk, dtype, dict(scale=scale, model=True)))
        cases.append(("zamba_tp2_strided", 1, seq, h, s.head_dim, s.state, 1,
                      s.chunk, dtype, dict(scale=scale, model=True,
                                           strided=True)))
    worst, worst_phase = check_ssd_cases(torch, ops, ref, gen, cases)
    log(f"  17a kernel 7 at zamba2's tp-2 shape (H {h}): worst err/limit "
        f"{worst:.3f}, of its phases {worst_phase:.3f}")
    torch.cuda.empty_cache()


def tiled_global(cfg, local, dims):
    """The GLOBAL tree of a data x model mesh of `dims` whose every rank
    holds `local`: each leaf repeated along the dim its spec
    (`sharding.param_specs`) splits, as many times as that dim's PEs.
    Every rank's own init draws the same local tree from the same seed,
    so this is the tree a launcher on that mesh trains from its seed;
    its padded vocabulary rows (granite: 49155 over 4) stay, so the 1x1
    run on it sees the columns the mesh's loss does."""
    from repro_torch.parallel import sharding
    sizes = {"data": dims[0], "model": dims[1]}
    # `local` is data-full (fsdp cuts its rows per rank, and the
    # gathers give them back whole): fsdp adds no tiling
    specs = sharding.param_specs(dataclasses.replace(cfg, fsdp=False),
                                 local, sharding.MeshAxes(), dims[1])

    def reps(spec):
        return [math.prod(sizes[a] for a in (ax if isinstance(ax, tuple)
                                             else (ax,)))
                if ax is not None else 1 for ax in spec]

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, sv) for v, sv in zip(t, s)]
        r = reps(s)
        return t.repeat(*r) if any(x > 1 for x in r) else t

    return walk(local, specs)


def ep_gate_params(torch, cfg, experts, model_rank=0, tp=1):
    """One MoE layer of `cfg` for the layer gates, each weight drawn
    from a generator of its own on the card, rounded to the config's
    param dtype and held in f32 (the gate computes in f32, and bf16
    weights cast per call would keep three f32 copies of deepseek's
    experts, 45 GB, for the backward beside them): the router (seed
    1750), routed expert e's w_gate, w_up, w_down (seed 1751 + e), the
    shared experts' MLP (seed 1749), cut to `model_rank` of `tp` as
    `init_mlp` lays it out.  `experts` are the ids this holder keeps (a
    rank its own slice, the 1x1 run all of them): the same weights bit
    for bit either way, and expert e's differ from every other's, so a
    block delivered to the wrong rank changes the output."""
    mo, d, dt = cfg.moe, cfg.d_model, cfg.param_dtype

    def draw(gen, shape, fan):
        return torch.randn(shape, generator=gen, device="cuda").mul_(
            1.0 / math.sqrt(fan)).to(dt).float()

    p = {"router": draw(torch.Generator(device="cuda").manual_seed(1750),
                        (d, mo.n_experts), d)}
    shapes = (("w_gate", (d, mo.d_ff), d), ("w_up", (d, mo.d_ff), d),
              ("w_down", (mo.d_ff, d), mo.d_ff))
    for name, shape, _ in shapes:
        p[name] = torch.empty((len(experts),) + shape, device="cuda")
    for i, e in enumerate(experts):
        gen = torch.Generator(device="cuda").manual_seed(1751 + e)
        for name, shape, fan in shapes:
            p[name][i] = draw(gen, shape, fan)
    if mo.n_shared:
        ff = mo.n_shared * mo.d_ff
        lo, hi = model_rank * ff // tp, (model_rank + 1) * ff // tp
        gen = torch.Generator(device="cuda").manual_seed(1749)
        full = {k: draw(gen, s, f)
                for k, s, f in (("w_gate", (d, ff), d), ("w_up", (d, ff), d),
                                ("w_down", (ff, d), ff))}
        p["shared"] = {"w_gate": full["w_gate"][:, lo:hi].contiguous(),
                       "w_up": full["w_up"][:, lo:hi].contiguous(),
                       "w_down": full["w_down"][lo:hi].contiguous()}
    return p


def ep_gate_inputs(torch, cfg, dp):
    """The gate's input and upstream gradient, (dp, B, L, d) f32: one
    batch a data row (seed 1748)."""
    b, seq = EP_GATE_TOKENS[cfg.name]
    gen = torch.Generator(device="cuda").manual_seed(1748)
    return (torch.randn(dp, b, seq, cfg.d_model, device="cuda",
                        generator=gen),
            torch.randn(dp, b, seq, cfg.d_model, device="cuda",
                        generator=gen))


def ep_gate_cfg(cfg):
    """`cfg` at a capacity that drops no pick: capacity_factor =
    n_experts / top_k makes cap = the tokens a device routes."""
    mo = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=mo.n_experts / mo.top_k))


def ep_gate_layer(torch, cfg, comm, p, x, w):
    """One MoE layer forward in x's dtype (f32) and the backward of
    sum(w * out) (the aux loss left out: it is each device's own) ->
    (out, the picks of this device's token slice, x's gradient, whether
    every pick was kept)."""
    from repro_torch.models import layers as L
    u = x.clone().requires_grad_()
    out, _ = L.moe(comm, cfg, p, u)
    (out * w).sum().backward()
    with torch.no_grad():
        _, _, tope, _, keep, _ = L.moe_route(cfg, p, L.moe_tokens(comm, x))
    return out.detach(), tope, u.grad, bool(keep.all())


def ep_gate_rank(arch, backend="shmem"):
    """A rank's half of a layer gate: its experts' weights and its data
    row's input, the layer on the rank mesh, its collectives on
    `backend`; the layer's launches, heap rounds and library calls."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import spmd
    from repro_torch.parallel.comm import AxisSpec, Comm
    torch.backends.cuda.matmul.allow_tf32 = False
    rt = spmd.current()
    cfg = ep_gate_cfg(get_config(arch))
    mesh = spmd.current().mesh
    dp, tp = mesh.sizes["data"], mesh.sizes["model"]
    ep = dp * tp if cfg.moe.ep_over_data else tp
    e_local = -(-cfg.moe.n_experts // ep)
    me = mesh.axis_index(("data", "model")) if cfg.moe.ep_over_data \
        else mesh.axis_index("model")
    experts = [e for e in range(me * e_local, (me + 1) * e_local)
               if e < cfg.moe.n_experts]
    if len(experts) != e_local:
        raise AssertionError(f"17: {cfg.name} pads its experts on {dp}x{tp}")
    p = ep_gate_params(torch, cfg, experts, mesh.axis_index("model"), tp)
    x, w = ep_gate_inputs(torch, cfg, dp)
    d = mesh.axis_index("data")
    torch.cuda.synchronize()
    _reset_counts()
    r0, c0 = rt.rounds, rt.lib_calls
    out, tope, grad, kept = ep_gate_layer(torch, cfg,
                                          Comm(AxisSpec(), backend), p,
                                          x[d], w[d])
    torch.cuda.synchronize()
    counts = _counts()
    del p
    torch.cuda.empty_cache()
    return dict(out=out, tope=tope, grad=grad, kept=kept, counts=counts,
                rounds=rt.rounds - r0, lib_calls=rt.lib_calls - c0)


def ep_gate_reference(torch, cfg):
    """The 1x1 side of a layer gate: every expert, every data row's
    tokens in one call (with no drop each token's output is its own)."""
    from repro_torch.parallel.comm import Comm
    gcfg = ep_gate_cfg(cfg)
    p = ep_gate_params(torch, gcfg, range(gcfg.moe.n_experts))
    x, w = ep_gate_inputs(torch, gcfg, 1 if not cfg.moe.ep_over_data else 2)
    out, tope, grad, kept = ep_gate_layer(
        torch, gcfg, Comm(), p, x.flatten(0, 1), w.flatten(0, 1))
    del p
    torch.cuda.empty_cache()
    if not kept:
        raise AssertionError(f"17: {cfg.name}'s 1x1 gate dropped a pick")
    return out.reshape(x.shape), tope, grad.reshape(x.shape)


def ep_gate_check(torch, cfg, want, got, dims) -> None:
    """The mesh's layer against the 1x1 layer: each rank's output (the
    full token set of its data row, after the allgather) and the sum of
    its data row's input gradients over `model` divided by tp (each
    rank's gradient is its own slice's, scaled by tp by the transposed
    allgather) within EP_GATE_RTOL x max|1x1|, and its picks exactly the
    1x1 picks of its token slice."""
    out1, tope1, grad1 = want
    dp, tp = dims
    t_row = out1[0].numel() // cfg.d_model
    lim_o = EP_GATE_RTOL * out1.abs().max().item()
    lim_g = EP_GATE_RTOL * grad1.abs().max().item()
    worst_o = worst_g = 0.0
    for d in range(dp):
        row = [got[d * tp + m] for m in range(tp)]
        for m, r in enumerate(row):
            if not r["kept"]:
                raise AssertionError(f"17: {cfg.name} gate rank ({d}, {m}) "
                                     f"dropped a pick")
            worst_o = max(worst_o, (r["out"].cuda() - out1[d]).abs().max()
                          .item())
            lo = d * t_row + m * (t_row // tp)
            if not torch.equal(r["tope"].cuda(),
                               tope1[lo:lo + t_row // tp]):
                raise AssertionError(f"17: {cfg.name} gate rank ({d}, {m}) "
                                     f"picks differ from the 1x1 picks")
        g = sum(r["grad"].cuda() for r in row) / tp
        worst_g = max(worst_g, (g - grad1[d]).abs().max().item())
    log(f"  {cfg.name} MoE layer gate on {dp}x{tp} (f32, no-drop capacity, "
        f"{out1.shape[0] * t_row} tokens, full width): picks == 1x1 "
        f"exactly; max|out - 1x1| {worst_o:.3e} (limit {lim_o:.3e}), "
        f"max|grad - 1x1| {worst_g:.3e} (limit {lim_g:.3e})")
    if not (worst_o <= lim_o and worst_g <= lim_g):
        raise AssertionError(f"17: {cfg.name}'s layer on {dp}x{tp} is not "
                             f"the 1x1 layer: {worst_o}, {worst_g}")


def ep_loss_1x1(torch, cfg, dims, batch):
    """The 1x1 loss, no gradient, of the tree a launcher on a `dims`
    mesh starts from (each rank's seed-0 init, tiled); the card's memory
    is freed before it returns."""
    from repro_torch.models import transformer
    from repro_torch.parallel.comm import Comm
    from repro_torch.train import step as tstep
    local = transformer.init_params(cfg, seed=0, device="cuda", tp=dims[1],
                                    dp=dims[0])
    glob = tiled_global(cfg, local, dims)
    del local
    with torch.no_grad():
        loss = float(transformer.train_loss(
            Comm(), cfg, glob, tstep.batch_to_device(batch, "cuda")))
    del glob
    gc.collect()
    torch.cuda.empty_cache()
    return loss


def ep_granite_rank(argv):
    """17b, one rank: the MoE layer gate, then the launcher's loop on
    `argv` (its own seed-0 init, updated in place) with the launches,
    heap rounds, host time in the syncs, walls and peak memory."""
    import torch
    from repro_torch.core import spmd
    from repro_torch.launch import train as train_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    rt = spmd.current()
    args = train_mod.parse_args(argv)
    out = {"gate": ep_gate_rank(args.arch),
           "gate_xla": ep_gate_rank(args.arch, "xla")}    # phase 22c
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                                    # the path starts
    r0, s0 = rt.rounds, rt.sync_s
    res = train_mod.train_loop(args)
    torch.cuda.synchronize()
    out.update(losses=res.losses, walls=res.step_s, counts=_counts(),
               peak=torch.cuda.max_memory_allocated(),
               rounds=rt.rounds - r0, sync_s=rt.sync_s - s0)
    return out


def ep_granite(torch, np, granite, card, phase22=None) -> list:
    """17b: granite-moe-3b-a800m at full width on a 1x4 mesh (EP 4 over
    `model`: 10 of 40 experts, 6 of 24 q heads and 2 of 8 KV heads a
    rank).  Why not 2x2: its 3.37 B parameters take 16 B each as f32
    weights, gradients, m and v (~13.5 GB a rank on 1x4; on 2x2 every
    expert is held twice, ~104 GB).  First the 1x1 side in this process:
    the layer gate's 1x1 layer and the 1x1 loss of the launcher's tree
    on EP_TRAIN's first batch (memory freed after each); then 4 ranks:
    the layer gate (`ep_gate_check`), and the launcher's loop, EP_TRAIN's
    steps at the config's 2 microbatches.  Gates: the step-0 loss within
    the reference's 0.05 x max(1, |l1|) of the 1x1 loss (capacity is
    counted per rank slice, so the drops differ: a bound, not equality);
    every rank's losses finite, their spread within EP_RANK_SPREAD; per
    rank and microbatch (L layers, remat recomputing each layer's
    forward): kernel 4 2L, heap rounds 30L + 14 (forward: the embedding
    allreduce 2, a layer's attention allreduce 2, two alltoalls 3 + 3
    and the token allgather 2, the loss's three allreduces 6; the
    recompute 10L; the backward the same rounds reversed but the
    stabiliser's max, 10L + 6), kernel 2 twice a round plus 15L block
    moves (5 a layer's exchange per pass), kernel 3 4L + 8 (one a stage
    of each sum and max allreduce in the forward and the recompute),
    no kernel-1 launch.  Each rank also runs the gate under the xla
    backend (phase 22c: its results, and the shmem gate's, under
    `phase22`).  Returns the path's launch counts, summed over ranks, and
    kernel 4's per rank."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import build
    cfg, run = granite.CONFIG, EP_TRAIN
    dims = (1, 4)
    t0 = time.perf_counter()
    want = ep_gate_reference(torch, cfg)
    batch = SyntheticLM(cfg.vocab, run["seq_len"], run["batch"]).batch(0)
    l1 = ep_loss_1x1(torch, cfg, dims, batch)
    log(f"  17b 1x1 side: layer gate and the 1x1 loss {l1!r} on the "
        f"launcher's tree, {time.perf_counter() - t0:.1f} s; memory "
        f"allocated as the ranks start "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    argv = ["--arch", cfg.name, "--seq-len", str(run["seq_len"]), "--batch",
            str(run["batch"]), "--steps", str(run["steps"]), "--device",
            "cuda", "--data", str(dims[0]), "--model", str(dims[1])]
    t0 = time.perf_counter()
    res = build.shard_mapped(ep_granite_rank, dims, [(argv,)] * 4,
                             device="cuda")
    wall = time.perf_counter() - t0
    ep_gate_check(torch, cfg, want, [r["gate"] for r in res], dims)
    del want
    if phase22 is not None:
        phase22["22c"] = [dict(shmem=r.pop("gate"), xla=r.pop("gate_xla"))
                          for r in res]
    torch.cuda.empty_cache()
    L, mb = cfg.n_layers, min(cfg.microbatches, run["batch"])
    n = mb * run["steps"]
    formula = dict(flash_attention=2 * L * n, put_copy=0,
                   dma_copy=(2 * (30 * L + 14) + 15 * L) * n,
                   reduce_combine=(4 * L + 8) * n, fused_update=0,
                   ssd_scan=0, ring_attention=0, paged_decode=0)
    for r_, p in enumerate(res):
        if not np.isfinite(p["losses"]).all():
            raise AssertionError(f"17b: rank {r_} non-finite loss "
                                 f"{p['losses']}")
        if p["counts"] != formula or p["rounds"] != (30 * L + 14) * n:
            raise AssertionError(f"17b: rank {r_} launched {p['counts']} in "
                                 f"{p['rounds']} heap rounds; the formulas "
                                 f"give {formula} in {(30 * L + 14) * n}")
    spread = [max(p["losses"][s] for p in res)
              - min(p["losses"][s] for p in res)
              for s in range(run["steps"])]
    losses = res[0]["losses"]
    walls = res[0]["walls"]
    tok = run["seq_len"] * run["batch"]
    log(f"  17b granite on 1x4: losses (rank 0) "
        + ", ".join(f"{x:.5f}" for x in losses)
        + "; spread over the ranks per step "
        + ", ".join(f"{s:.3g}" for s in spread)
        + f" (bound {EP_RANK_SPREAD}); step-0 |1x4 - 1x1| "
        f"{abs(losses[0] - l1):.4g} (the reference's bound "
        f"{0.05 * max(1.0, abs(l1)):.3g}); step wall ms (rank 0) "
        + ", ".join(f"{w * 1e3:.1f}" for w in walls)
        + f"; {tok_s_text(tok, walls)}; peak per rank GiB "
        + ", ".join(f"{p['peak'] / 2**30:.3f}" for p in res)
        + f"; per step per rank: {res[0]['rounds'] / run['steps']:g} heap "
        f"rounds,"
        f" launches (flash, dma, combine) " + ", ".join(
            f"{res[0]['counts'][k] / run['steps']:g}"
            for k in ("flash_attention", "dma_copy", "reduce_combine"))
        + "; host time in the syncs a step (ranks 0-3) ms "
        + ", ".join(f"{p['sync_s'] / run['steps'] * 1e3:.1f}" for p in res)
        + f" == the formulas; run wall {wall:.1f} s, spawn included ({card})")
    if not abs(losses[0] - l1) < 0.05 * max(1.0, abs(l1)):
        raise AssertionError(f"17b: the 1x4 loss {losses[0]} is not the 1x1 "
                             f"loss {l1}")
    if any(not x <= t for x, t in zip(spread, EP_RANK_SPREAD)):
        raise AssertionError(f"17b: the ranks' losses spread by {spread}")
    return [{k: sum(p["counts"][k] for p in res) for k in formula}], \
        res[0]["counts"]["flash_attention"]


def ep_deepseek_rank(ds_cfg, batch):
    """17d, one rank: the MoE layer gate, then the train loss, forward
    only, of the rank's own seed-0 init on its slice of `batch`, the
    data-axis mean, with the launches and heap rounds of the forward."""
    import torch
    from repro_torch.core import spmd
    from repro_torch.launch import build
    from repro_torch.models import transformer
    from repro_torch.parallel.comm import AxisSpec, Comm
    from repro_torch.train import step as tstep
    rt = spmd.current()
    out = {"gate": ep_gate_rank(ds_cfg.name)}
    mesh = rt.mesh
    params = build.make_init_fn(ds_cfg, mesh)[0](0, "cuda")
    local = tstep.batch_to_device(build.local_batch(ds_cfg, batch, mesh),
                                  "cuda")
    comm = Comm(AxisSpec())
    def forward():
        with torch.no_grad():
            loss = transformer.train_loss(comm, ds_cfg, params, local)
            return float(comm.allreduce(loss, "data")
                         / comm.axis_size("data"))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                                    # the path starts
    r0 = rt.rounds
    t0 = time.perf_counter()
    loss = forward()
    dp, slot = mesh.sizes["data"], rt.heap.slot_bytes
    out.update(loss=loss, wall=time.perf_counter() - t0, counts=_counts(),
               rounds=rt.rounds - r0, peak=torch.cuda.max_memory_allocated(),
               gathers={k: fsdp_gathers(t, dp, slot) for k, t in (
                   ("dense", params["dense_layers"][0]),
                   ("moe", params["layers"][0]),
                   ("mtp", params["mtp"]["block"]),
                   ("proj", {"w": params["mtp"]["proj"]}))})
    t0 = time.perf_counter()            # once more, warm (not counted)
    out.update(loss2=forward(), wall2=time.perf_counter() - t0)
    return out


def fsdp_gathers(tree, dp: int, slot_bytes: int) -> tuple[int, int]:
    """(the leaves `transformer._fsdp_gather` gathers over `data` in a
    block `tree` of a rank's fsdp shards: its 2-D leaves (an MoE block's
    experts are 3-D), the heap rounds their gathers take): each leaf's
    dp row blocks cross as one buffer of dp x its bytes, in ceil(dp x
    bytes / slot) slot-sized chunks (recursive doubling over dp = 2: one
    stage), and so does its backward's delivery."""
    from repro_torch.core.heap import tree_flatten
    two = [t for t in tree_flatten(tree)[0] if t.dim() == 2]
    return len(two), sum(-(-dp * t.numel() * t.element_size() // slot_bytes)
                         for t in two)


def ep_deepseek(torch, np, ds_cfg, card) -> list:
    """17d: deepseek-v3 cut to the 4 layers of its SERVE_RUN (its 3
    dense MLA layers and its first MoE layer: every kind of layer at its
    published width, and the MTP head) forward at full width on a 2x2
    mesh under its own config: EP over (data, model) = 4, 64 of 256
    experts a rank, MLA at 64 of 128 heads, and fsdp (ZeRO-3 over data:
    every 2-D block weight's rows halved over the 2 data PEs, gathered
    inside its block).  Forward only: its bf16 parameters, gradients and
    int8 moments come to ~6 bytes a parameter, ~95 GB for the 15.8 B of
    the cut and its MTP block over the four ranks, more than the card.
    First the 1x1 side (the layer gate's 1x1 layer; the 1x1 loss of the
    ranks' tree at EP_DS's batch), its memory freed before the ranks
    start; then 4 ranks: the layer gate, and the train loss.  Gates:
    each rank's loss (the data-axis mean; each
    model rank adds its own aux) within the reference's 0.05 x max(1,
    |l1|) of the 1x1 loss, finite; per rank (nd dense layers of L, the
    MTP block after): kernel 4 L + 1, heap rounds 2nd + 9(L - nd) + 11
    (each dense layer's two allreduces over tp 2, 1 round each; an MoE
    layer's attention and shared-expert allreduces 1 + 1, two alltoalls
    over 4 PEs 3 + 3, the token allgather 1; the embedding 1, the loss's
    3, the MTP head's embedding 1, block 2 and loss 3, the data mean 1)
    plus the rounds of fsdp's gathers over the 2 data PEs (`fsdp_gathers`
    on the rank's shards: a leaf's two row blocks cross as one buffer in
    ceil(2 x bytes / slot) rounds; a dense block's 8 leaves: MLA's wq_a,
    wq_b, wkv_a, wkv_b, wo and the MLP's three; an MoE block's 9: MLA's
    five, the router, the shared expert's three; the MTP block's 8 and
    the MTP projection); kernel 2 twice a round plus 5(L - nd) block
    moves and one block move a gather, kernel 3 2L + 11, no kernel-1
    launch.  Returns
    the path's launch counts, summed over ranks, and kernel 4's per
    rank."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import build
    dims = (2, 2)
    t0 = time.perf_counter()
    want = ep_gate_reference(torch, ds_cfg)
    batch = SyntheticLM(ds_cfg.vocab, EP_DS["seq_len"],
                        EP_DS["batch"]).batch(0)
    l1 = ep_loss_1x1(torch, ds_cfg, dims, batch)
    log(f"  17d 1x1 side: layer gate and the 1x1 loss {l1!r} on the ranks' "
        f"tree, {time.perf_counter() - t0:.1f} s; memory allocated as the "
        f"ranks start {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    t0 = time.perf_counter()
    res = build.shard_mapped(ep_deepseek_rank, dims, [(ds_cfg, batch)] * 4,
                             device="cuda")
    wall = time.perf_counter() - t0
    ep_gate_check(torch, ds_cfg, want, [r["gate"] for r in res], dims)
    del want
    torch.cuda.empty_cache()
    L, nd = ds_cfg.n_layers, ds_cfg.moe.first_dense_layers
    g = res[0]["gathers"]
    per = lambda i: (nd * g["dense"][i] + (L - nd) * g["moe"][i]
                     + g["mtp"][i] + g["proj"][i])
    gathers, g_rounds = per(0), per(1)
    rounds = 2 * nd + 9 * (L - nd) + 11 + g_rounds
    formula = dict(flash_attention=L + 1, put_copy=0,
                   dma_copy=2 * rounds + 5 * (L - nd) + gathers,
                   reduce_combine=2 * L + 11, fused_update=0, ssd_scan=0,
                   ring_attention=0, paged_decode=0)
    for r_, p in enumerate(res):
        if p["counts"] != formula or p["rounds"] != rounds:
            raise AssertionError(f"17d: rank {r_} launched {p['counts']} in "
                                 f"{p['rounds']} heap rounds; the formulas "
                                 f"give {formula} in {rounds}")
        if p["loss2"] != p["loss"]:
            raise AssertionError(f"17d: rank {r_}'s second forward gave "
                                 f"{p['loss2']}, the first {p['loss']}")
        if not (np.isfinite(p["loss"])
                and abs(p["loss"] - l1) < 0.05 * max(1.0, abs(l1))):
            raise AssertionError(f"17d: rank {r_}'s loss {p['loss']} is not "
                                 f"the 1x1 loss {l1}")
    log(f"  17d deepseek-v3 ({L} layers) forward on 2x2: losses (ranks 0-3) "
        + ", ".join(f"{p['loss']:.5f}" for p in res)
        + f", 1x1 {l1:.5f} (the reference's bound "
        f"{0.05 * max(1.0, abs(l1)):.3g}); forward wall ms (ranks 0-3) "
        + ", ".join(f"{p['wall'] * 1e3:.1f}" for p in res)
        + ", warm " + ", ".join(f"{p['wall2'] * 1e3:.1f}" for p in res)
        + "; peak per rank GiB "
        + ", ".join(f"{p['peak'] / 2**30:.3f}" for p in res)
        + f" (12.574 without fsdp, PERF.md §6); fsdp gathers a rank "
        f"{gathers} in {g_rounds} rounds ((leaves, rounds) a dense block "
        f"{g['dense']}, an MoE block {g['moe']}, the MTP block "
        f"{g['mtp']}, its projection {g['proj']})"
        + f"; per rank {rounds} heap rounds, launches (flash, dma, combine) "
        + ", ".join(str(formula[k]) for k in ("flash_attention", "dma_copy",
                                                "reduce_combine"))
        + f" == the formulas; run wall {wall:.1f} s, spawn included ({card})")
    return [{k: sum(p["counts"][k] for p in res) for k in formula}], \
        res[0]["counts"]["flash_attention"]


# ---------------------------------------------------------------------------
# phase 18: serving at tp > 1
# ---------------------------------------------------------------------------
# 18a serves qwen2-0.5b's paged engine on 1x2 and 1x4 meshes of rank
# processes (each rank its own replica of the scheduler, in lockstep on
# the allreduced tokens) with phase 3's traffic and engine; each rank
# fits phase 3's seed-0 tree to the mesh itself (`convert.fit_global`:
# at tp 4 the 14 q heads pad to 16, two ghost heads on rank 3, and the 2
# kv heads are replicated under the cache plan, ndk 2) and cuts its
# shards, as 16b does.  18b runs one dense-cache decode step, after a
# short prompt, of zamba2-1.2b at 1x2 (Mamba2 and the shared attention
# at tp 2), deepseek-v3's 4-layer cut at 1x2 (MLA at tp 2, its experts
# over `model`) and granite-moe-3b-a800m at 1x4, against the same
# model's 1x1 step on the same global weights, in f32 and then in the
# config's own bf16 (its picks only).  One spawn of 2 ranks
# runs qwen2's engine, zamba2 and deepseek in turn, one of 4 qwen2's
# engine and granite, each model freed before the next.

SERVE_TP = (2, 4)
# 18a and 20c: new tokens a request on the mesh engines, of phase 3's
# traffic (phase 3's prompts; greedy tokens are a prefix of phase 3's 32,
# batched == alone bit for bit).  Cut from phase 3's 32 to keep the whole
# run inside its limit once phase 22 joined: the engine passes of 18a
# took ~90 s of phase 18 at 32 (run T4, PERF.md § 6)
SERVE_TP_TOKENS = 8
# 18b: (arch, tp) of each decode step, and its prompt: B sequences of P
# tokens fed, teacher-forced, through P dense-cache decode steps; then
# the step itself at position P on their greedy pick, and the prefill
# (kernels 4 and 7) over the prompt and that pick, whose last position
# is the step's
DECODE_TP = (("zamba2-1.2b", 2), ("deepseek-v3-671b", 2),
             ("granite-moe-3b-a800m", 4))
DECODE_TP_RUN = dict(batch=4, prompt_len=4)
# 18b's f32 limit on logits, x the largest: the same function on the
# mesh and on 1x1 (only the allreduce's summation order differs) agreed
# to within 1.1e-4 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6)
DECODE_TP_F32_RTOL = 1e-3


def top2_gap(np, lg) -> float:
    """The gap between the two largest entries of a 1-D array."""
    a, b = np.partition(np.asarray(lg, np.float64), -2)[-2:]
    return float(b - a)


def serve_tp_engine(cfg, engine_kw, prompts, new_tokens):
    """18a, one rank: phase 3's seed-0 tree fitted to the mesh and cut
    to this rank's shards; the engine on phase 3's traffic (the path:
    launches, heap rounds and host time in their syncs counted from 0
    just before, read just after); two requests alone on a second
    engine; phase 3's traffic again on a third that keeps every token's
    logits over the whole vocabulary (gathered over `model`), its tokens
    and logits rank 0's returned."""
    import numpy as np
    import torch
    from repro_torch.core import spmd
    from repro_torch.models import convert, transformer
    from repro_torch.serve.engine import ServeEngine
    rt = spmd.current()
    mesh = rt.mesh
    params = transformer.map_params(torch.clone, convert.local_shards(
        convert.fit_global(transformer.init_params(cfg, seed=0,
                                                   device="cuda"),
                           cfg, tp=mesh.sizes["model"]), cfg, mesh))
    gc.collect()
    torch.cuda.empty_cache()
    eng = ServeEngine(cfg, mesh, params=params, **engine_kw)
    decodes = []
    torch.cuda.synchronize()
    _reset_counts()                                    # the path starts
    r0, s0 = rt.rounds, rt.sync_s
    rids, ttft, gaps, wall = drive_engine(
        torch, eng, prompts, new_tokens,
        on_step=lambda res: decodes.append(res["decoded"] > 0))
    out = dict(counts=_counts(), rounds=rt.rounds - r0,
               sync_s=rt.sync_s - s0, wall=wall, ttft=ttft, gaps=gaps,
               n_prefill=eng.scheduler.n_admitted, n_decode=sum(decodes),
               steps=eng.steps, tokens=[eng.results[r] for r in rids],
               results=dict(eng.results))
    solo = ServeEngine(cfg, mesh, params=params, **engine_kw)
    out["alone"] = []
    for rid in rids[:2]:
        s = solo.submit(prompts[rid], new_tokens)
        solo.run()
        out["alone"].append(solo.results[s])
    del solo, eng
    cap = ServeEngine(cfg, mesh, params=params, capture_logits=True,
                      **engine_kw)
    cr = [cap.submit(p, new_tokens) for p in prompts]
    cap.run()
    if rt.rank == 0:
        out["cap_tokens"] = [cap.results[r] for r in cr]
        out["logits"] = [np.stack(cap.logits_trace[r])[:, :cfg.vocab]
                         for r in cr]
    del cap, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def engine_1x1_logits(torch, cfg, engine_kw, params, prompts, new_tokens):
    """The 1x1 engine's tokens and logits of each token of each of
    `prompts` (on the card batched equals alone bit for bit: phase
    3)."""
    from repro_torch.serve.engine import ServeEngine
    e = ServeEngine(cfg, params=params, device="cuda", capture_logits=True,
                    **engine_kw)
    rids = [e.submit(p, new_tokens) for p in prompts]
    e.run()
    return [e.results[r] for r in rids], [e.logits_trace[r] for r in rids]


def serve_tp_check(np, serving, tp, res, phase3, logits1, card):
    """18a's gates on one mesh's ranks: every rank's results equal rank
    0's; the two requests alone equal the batch bit for bit; the
    capturing engine's tokens equal the batch's, and its logits of every
    step of each request, up to and including the first whose token
    differs from phase 3's, within PREFILL_LOGITS_RTOL x the largest
    logit of phase 3's (`logits1`: each request's logits of each token on
    the 1x1 engine); the first differing token allowed only where phase
    3's gap between its top two logits there is within that bound (a
    near tie), and the request not compared after it; per rank 8
    prefills (phase 3's requests, each admitted once), kernel 4 L x
    prefills launches, kernel 8 L x decode steps, and (2L + 3) log2(tp)
    heap rounds a prefill and a
    decode step (the embedding's, two a layer, sample_greedy's max and
    min; one round a stage of the recursive doubling), two kernel-2
    launches and one kernel-3 launch a round.  Returns the path's launch
    counts, summed over the ranks."""
    cfg = serving.CONFIG
    lead = res[0]
    for r_, got in enumerate(res):
        if sorted(got["results"]) != sorted(lead["results"]) or any(
                not np.array_equal(got["results"][k], lead["results"][k])
                for k in lead["results"]):
            raise AssertionError(f"18a 1x{tp}: rank {r_}'s results differ "
                                 f"from rank 0's")
    for i, a in enumerate(lead["alone"]):
        if not np.array_equal(a, lead["tokens"][i]):
            raise AssertionError(f"18a 1x{tp}: request {i} alone "
                                 f"{a.tolist()} != batched "
                                 f"{lead['tokens'][i].tolist()}")
    first, worst, ties, upto, n_cmp = 0.0, 0.0, [], [], 0
    for i, (got, want) in enumerate(zip(lead["tokens"], phase3["tokens"])):
        want = want[:len(got)]                    # SERVE_TP_TOKENS of 32
        if not np.array_equal(lead["cap_tokens"][i], got):
            raise AssertionError(f"18a 1x{tp}: request {i} on the "
                                 f"capturing engine "
                                 f"{lead['cap_tokens'][i].tolist()} != "
                                 f"{got.tolist()}")
        diff = np.flatnonzero(got != want)
        d = int(diff[0]) if diff.size else len(want)
        upto.append(d if diff.size else None)
        n_cmp += min(d + 1, len(want))
        for j in range(min(d + 1, len(want))):
            lg, lg1 = lead["logits"][i][j], logits1[i][j]
            err = float(np.abs(lg - lg1).max())
            lim = PREFILL_LOGITS_RTOL * float(np.abs(lg1).max())
            worst = max(worst, err / lim)
            if j == 0:
                first = max(first, err / lim)
            if not (np.isfinite(lg).all() and err <= lim):
                raise AssertionError(f"18a 1x{tp}: request {i}'s logits of "
                                     f"token {j} off phase 3's by {err} "
                                     f"(limit {lim})")
        if not diff.size:
            continue
        gap = top2_gap(np, logits1[i][d])
        lim = PREFILL_LOGITS_RTOL * float(np.abs(logits1[i][d]).max())
        ties.append((i, d, gap, lim))
        if not gap <= lim:
            raise AssertionError(f"18a 1x{tp}: request {i}'s token {d} is "
                                 f"{int(got[d])}, phase 3's {int(want[d])} "
                                 f"at a top-2 gap of {gap} (near-tie bound "
                                 f"{lim})")
    L = cfg.n_layers
    stages = int(math.log2(tp))
    n_req = serving.SERVE_TRAFFIC["requests"]
    for r_, got in enumerate(res):
        if got["n_prefill"] != n_req:
            raise AssertionError(f"18a 1x{tp}: rank {r_} admitted "
                                 f"{got['n_prefill']} prefills, want one a "
                                 f"request, {n_req}")
        passes = got["n_prefill"] + got["n_decode"]
        rounds = passes * (2 * L + 3) * stages
        want = dict(flash_attention=L * n_req, put_copy=0,
                    dma_copy=2 * rounds, reduce_combine=rounds,
                    fused_update=0, ssd_scan=0, ring_attention=0,
                    paged_decode=L * got["n_decode"])
        if got["counts"] != want or got["rounds"] != rounds:
            raise AssertionError(f"18a 1x{tp}: rank {r_} launched "
                                 f"{got['counts']} in {got['rounds']} heap "
                                 f"rounds; the formulas give {want} in "
                                 f"{rounds}")
    n_tok = sum(len(t) for t in lead["tokens"])
    per_tok = pct(lead["gaps"], 50)
    log(f"  18a qwen2-0.5b engine on 1x{tp}: every rank's results == rank "
        f"0's; requests 0, 1 alone == batched bit for bit; the capturing "
        f"engine's tokens == the batch's; logits vs phase 3's (limit "
        f"{PREFILL_LOGITS_RTOL:.4f} x max|logit|) worst err/limit {worst:.3f}"
        f" over {n_cmp} steps (first tokens {first:.3f}); first differing "
        f"token of each "
        f"request {upto} (None: none); tokens == phase 3's"
        + (f" but near ties (request, token, top-2 gap, bound) {ties}"
           if ties else "")
        + f"; {n_tok} tokens in {lead['wall']:.3f} s: {n_tok / lead['wall']:.1f}"
        f" tok/s (phase 3 {phase3['tok_s']:.1f}), TTFT p50 "
        f"{pct(lead['ttft'], 50) * 1e3:.2f} ms (phase 3 "
        f"{phase3['ttft_p50'] * 1e3:.2f}), per-token p50 {per_tok * 1e3:.3f}"
        f" ms (phase 3 {phase3['per_token_p50'] * 1e3:.3f}); per rank "
        f"{lead['n_prefill']} prefills and {lead['n_decode']} decode steps "
        f"in {lead['steps']} engine steps, {lead['rounds']} heap rounds "
        f"({(2 * L + 3) * stages} a pass), host time in their syncs "
        + ", ".join(f"{g['sync_s']:.3f}" for g in res)
        + f" s of the {lead['wall']:.3f} s wall (ranks; share "
        f"{lead['sync_s'] / lead['wall']:.3f} on rank 0), launches "
        f"(flash, dma, combine) " + ", ".join(
            str(lead["counts"][k]) for k in ("flash_attention", "dma_copy",
                                             "reduce_combine"))
        + f" == the formulas ({card})")
    return {k: sum(g["counts"][k] for g in res) for k in lead["counts"]}


def decode_tp_run(torch, cfg, comm, params, prompt, tp, prefill=True):
    """18b's path on `params` (a rank's shards, or the 1x1 tree): P
    teacher-forced dense-cache decode steps over `prompt` (B, P), the
    step at position P on their greedy pick, and (with `prefill`) the
    prefill (kernels 4 and 7) over the prompt and the pick.  -> (the
    step's logits, the prefill's last-position logits or None, the
    picks, the logits they were picked from), (B, V_local) or (B,), no
    gradient."""
    from repro_torch.models import transformer
    from repro_torch.serve import step as sstep
    tokens = torch.as_tensor(prompt, device="cuda").long()
    B, P = tokens.shape
    with torch.no_grad():
        cache = transformer.init_cache(cfg, tp, B, P + 1, device="cuda")
        for t in range(P):
            lg, cache = transformer.decode_step(
                comm, cfg, params, cache, tokens[:, t:t + 1],
                torch.full((B,), t, device="cuda"))
        pick = sstep.sample_greedy(comm, lg[:, 0])
        step, cache = transformer.decode_step(
            comm, cfg, params, cache, pick[:, None],
            torch.full((B,), P, device="cuda"))
        del cache
        pre = transformer.prefill(comm, cfg, params, torch.cat(
            [tokens, pick[:, None]], 1))[:, 0] if prefill else None
    torch.cuda.synchronize()
    return step[:, 0], pre, pick, lg[:, 0]


def decode_tp_cfg(arch, dtype=None):
    """18b's config of `arch`, fsdp off as serving has it (the reference's
    `make_serve_steps`): deepseek cut to its SERVE_RUN layers; its
    compute dtype `dtype`, f32 unless given: the logits are gated in f32,
    as phases 9 and 11 gate their models (in bf16 a random-weight stack
    amplifies each flipped rounding to tens of percent of the largest
    logit, and one flipped route of an MoE layer moves a token's output
    whole; deepseek's bf16 experts are cast per call, ~15 GB of f32
    copies at once on the 1x1 side), and the config's own bf16 step only
    for finite logits and its picks; the moe family at a capacity that
    drops no pick (`ep_gate_cfg`), since capacity is counted per rank
    slice and the 1x1 step would drop other picks."""
    import torch
    from repro_torch.configs import deepseek_v3_671b, get_config
    cfg = dataclasses.replace(get_config(arch), fsdp=False,  # serving
                              dtype=dtype or torch.float32)
    if arch == "deepseek-v3-671b":
        cfg = dataclasses.replace(
            cfg, n_layers=deepseek_v3_671b.SERVE_RUN["n_layers"])
    return ep_gate_cfg(cfg) if cfg.moe is not None else cfg


def decode_tp_prompt(np, cfg):
    return np.random.default_rng(1800).integers(
        1, cfg.vocab, size=(DECODE_TP_RUN["batch"],
                            DECODE_TP_RUN["prompt_len"]), dtype=np.int32)


def decode_tp_params(torch, cfg, mesh=None, tp=1):
    """The tree 18b runs: the hybrid family's 1x1 seed-0 tree, on a mesh
    fitted to it and cut to the rank's shards (Mamba2's columns are laid
    out per shard: 17c's rule); the moe family's seed-0 init of a rank of
    1 x tp, on the 1x1 side tiled to the global tree (17b's rule)."""
    from repro_torch.launch import build
    from repro_torch.models import convert, transformer
    if cfg.family == "hybrid":
        p = transformer.init_params(cfg, seed=0, device="cuda")
        if mesh is None:
            return p
        return transformer.map_params(torch.clone, convert.local_shards(
            convert.fit_global(p, cfg, tp=tp), cfg, mesh))
    if mesh is not None:
        return build.make_init_fn(cfg, mesh)[0](0, "cuda")
    local = transformer.init_params(cfg, seed=0, device="cuda", tp=tp)
    glob = tiled_global(cfg, local, (1, tp))
    del local
    return glob


def decode_tp_rank(arch):
    """18b, one rank: its tree; `decode_tp_run` in f32, then the
    config's own bf16 step (no prefill) on the same tree, each with the
    launches and heap rounds counted from 0 just before it and read just
    after; the logits gathered over `model` (after the count), rank 0's
    returned."""
    import numpy as np
    import torch
    from repro_torch.core import spmd
    from repro_torch.parallel.comm import AxisSpec, Comm
    rt = spmd.current()
    cfg = decode_tp_cfg(arch)
    tp = rt.mesh.sizes["model"]
    params = decode_tp_params(torch, cfg, rt.mesh, tp)
    gc.collect()
    torch.cuda.empty_cache()
    comm = Comm(AxisSpec())
    out = {}
    for key, c, prefill in (("f32", cfg, True),
                            ("bf16", decode_tp_cfg(arch, torch.bfloat16),
                             False)):
        torch.cuda.synchronize()
        _reset_counts()                                # the path starts
        r0 = rt.rounds
        t0 = time.perf_counter()
        got = decode_tp_run(torch, c, comm, params,
                            decode_tp_prompt(np, cfg), tp, prefill)
        out[key] = dict(wall=time.perf_counter() - t0, counts=_counts(),
                        rounds=rt.rounds - r0)
        full = [comm.allgather(t, "model", concat_axis=1)
                for t in (got[0], got[1], got[3]) if t is not None]
        if rt.rank == 0:
            out[key]["logits"] = [t.float().cpu().numpy() for t in full]
            out[key]["pick"] = got[2].cpu().numpy()
        del got, full
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def shard_norm(torch, cfg, tp):
    """The 1x1 side of a Mamba2 model at `tp`: its gated norm (the
    `layers.rms_norm` of the d_in channels) over each shard's d_in / tp
    channels, as the mesh runs it (the reference's layout: at tp > 1
    each rank norms its own heads' channels), so that the 1x1 step is the
    mesh model's function; on a smoke zamba2 the two then agree to
    3e-6 of logits near 3.5, 2.7 apart without it."""
    from repro_torch.models import layers
    d_in = cfg.ssm.expand * cfg.d_model
    orig = layers.rms_norm

    def norm(x, w, eps=1e-6):
        if x.shape[-1] != d_in:
            return orig(x, w, eps)
        return torch.cat([orig(a, b, eps) for a, b in
                          zip(x.chunk(tp, -1), w.chunk(tp, -1))], -1)

    return mock.patch.object(layers, "rms_norm", norm)


def decode_tp_reference(torch, np, arch, tp):
    """18b's 1x1 side: the same paths, f32 and bf16, on the global tree
    (a Mamba2 model's gated norm per shard, `shard_norm`), its memory
    freed before it returns."""
    import contextlib
    from repro_torch.parallel.comm import Comm
    cfg = decode_tp_cfg(arch)
    params = decode_tp_params(torch, cfg, tp=tp)
    out = {}
    with (shard_norm(torch, cfg, tp) if cfg.ssm is not None
          else contextlib.nullcontext()):
        for key, c, prefill in (("f32", cfg, True),
                                ("bf16", decode_tp_cfg(arch, torch.bfloat16),
                                 False)):
            got = decode_tp_run(torch, c, Comm(), params,
                                decode_tp_prompt(np, cfg), 1, prefill)
            out[key] = dict(logits=[t.float().cpu().numpy() for t in
                                    (got[0], got[1], got[3])
                                    if t is not None],
                            pick=got[2].cpu().numpy())
            del got
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def decode_tp_check(np, arch, tp, res, want, card) -> dict:
    """18b's gates on one model's ranks.  f32, each within
    DECODE_TP_F32_RTOL x the largest logit, row by row: the step's
    logits against the same mesh's prefill over the prompt and the pick
    (the decode path against the full-sequence path of the same model),
    the step's and the prefill's logits against the 1x1 side's; the
    picks equal the 1x1 side's (no near tie is expected in f32).  The
    config's bf16 step: finite logits; the picks after the prompt, and
    the step's argmax where those agree, equal the 1x1 bf16 side's
    except at a near tie (the 1x1 top-2 gap within PREFILL_LOGITS_RTOL x
    the largest logit).  Per rank kernel 4 once an attention layer
    (zamba2: an application of its shared block) and kernel 7 once a
    Mamba2 layer, both in the f32 prefill, neither in the bf16 step.
    Returns the launch counts summed over the ranks and both dtypes."""
    from repro_torch.models import transformer
    cfg = decode_tp_cfg(arch)
    lead, lead1 = res[0]["f32"], want["f32"]
    V = cfg.vocab
    step, pre, _ = (t[:, :V] for t in lead["logits"])
    step1, pre1, _ = (t[:, :V] for t in lead1["logits"])
    if not np.array_equal(lead["pick"], lead1["pick"]):
        raise AssertionError(f"18b {arch} 1x{tp}: picks "
                             f"{lead['pick'].tolist()}, the 1x1 side's "
                             f"{lead1['pick'].tolist()}")
    worst = {}
    for name, got, w in (("step vs the mesh's prefill", step, pre),
                         ("step vs 1x1", step, step1),
                         ("prefill vs 1x1", pre, pre1)):
        for b in range(got.shape[0]):
            err = float(np.abs(got[b] - w[b]).max())
            lim = DECODE_TP_F32_RTOL * float(np.abs(w[b]).max())
            worst[name] = max(worst.get(name, 0.0), err / lim)
            if not (np.isfinite(got[b]).all() and err <= lim):
                raise AssertionError(f"18b {arch} 1x{tp}: {name}, row {b}: "
                                     f"max|diff| {err} (limit {lim})")
    hb, hb1 = res[0]["bf16"], want["bf16"]
    (bstep, blg), (bstep1, blg1) = ([t[:, :V] for t in h["logits"]]
                                     for h in (hb, hb1))
    if not (np.isfinite(bstep).all() and np.isfinite(blg).all()):
        raise AssertionError(f"18b {arch} 1x{tp}: bf16 logits not finite")
    bties, bdev = [], 0.0
    for b in range(bstep.shape[0]):
        for name, got, w, lg1 in (
                ("pick", hb["pick"][b], hb1["pick"][b], blg1[b]),
                ("step", int(bstep[b].argmax()), int(bstep1[b].argmax()),
                 bstep1[b])):
            if name == "step" and hb["pick"][b] != hb1["pick"][b]:
                break                       # the step reads another token
            bdev = max(bdev, float(np.abs(
                (blg if name == "pick" else bstep)[b] - lg1).max()
                / np.abs(lg1).max()))
            if got == w:
                continue
            gap = top2_gap(np, lg1)
            lim = PREFILL_LOGITS_RTOL * float(np.abs(lg1).max())
            bties.append((name, b, gap, lim))
            if not gap <= lim:
                raise AssertionError(f"18b {arch} 1x{tp}: bf16 {name} of row "
                                     f"{b} is {int(got)}, 1x1's {int(w)} at "
                                     f"a top-2 gap of {gap} (near-tie bound "
                                     f"{lim})")
    n_ssd = cfg.n_layers if cfg.ssm is not None else 0
    n_attn = (transformer.n_shared_blocks(cfg) if cfg.family == "hybrid"
              else cfg.n_layers)
    for r_, got in enumerate(res):
        for key, fa_, ssd_ in (("f32", n_attn, n_ssd), ("bf16", 0, 0)):
            c = got[key]["counts"]
            if c["flash_attention"] != fa_ or c["ssd_scan"] != ssd_:
                raise AssertionError(f"18b {arch} 1x{tp}: rank {r_} "
                                     f"launched {c} in {key}; want kernel 4 "
                                     f"{fa_}, kernel 7 {ssd_}")
    log(f"  18b {arch} ({cfg.n_layers} layers) decode step on 1x{tp} after "
        f"a prompt of {DECODE_TP_RUN['batch']} x "
        f"{DECODE_TP_RUN['prompt_len']}: f32, worst max|diff| / limit "
        + ", ".join(f"{k} {v:.4f}" for k, v in worst.items())
        + f" (limit {DECODE_TP_F32_RTOL:g} x max|logit|"
        + ("; the 1x1 side's gated norm per shard" if cfg.ssm is not None
           else "")
        + f"), picks {lead['pick'].tolist()} == 1x1; bf16 ({cfg.name}'s "
        f"own dtype), logits finite, max|diff| / max|logit| vs 1x1 "
        f"{bdev:.4f}, picks {hb['pick'].tolist()} and the step's argmax == "
        f"1x1's" + (f" but near ties (which, row, top-2 gap, bound) {bties}"
                    if bties else "")
        + f"; per rank {lead['rounds']} + {hb['rounds']} heap rounds, "
        f"kernel 4 {n_attn} and kernel 7 {n_ssd} launches == the formulas; "
        f"path walls (rank 0) {lead['wall'] * 1e3:.1f} + "
        f"{hb['wall'] * 1e3:.1f} ms ({card})")
    return {k: sum(g[d]["counts"][k] for g in res for d in ("f32", "bf16"))
            for k in lead["counts"]}


def serve_tp_rank(tasks):
    """18, one rank: each task of `tasks` in turn, each model freed
    before the next (and phase 20's 1x2 work, `fsdp_rank2`, in the same
    warm ranks)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    run = {"engine": serve_tp_engine, "decode": decode_tp_rank,
           "fsdp": fsdp_rank2, "xla": xla_serve_rank}
    return [run[name](*args) for name, args in tasks]


def serve_tp(torch, np, serving, phase3, card, fsdp_args=None,
             phase22=None) -> tuple:
    """Phase 18: the 1x1 sides in this process first (phase 3's traffic
    on a 1x1 engine that keeps every token's logits, on phase 3's tree:
    its tokens must be phase 3's; each 18b model's 1x1 path), each freed
    before the next; then one spawn of 2 ranks (qwen2's engine, zamba2,
    deepseek) and one of 4 (qwen2's engine, granite).  Returns the
    launch counts of each path, summed over the ranks, and kernel 4's
    launches on 18a's engine path of each mesh, summed over its ranks,
    each mesh's engine run (rank 0's tokens and kernel-4 launches), and
    each rank's result of phase 20's 1x2 work (`fsdp_args`, run last in
    the 2-rank spawn; None without).  With `phase22`, the serve launcher
    at --model 2 --comm xla follows in the 2-rank spawn (22d), and its
    1x1 side runs here first: both go under `phase22`."""
    from repro_torch.launch import build
    from repro_torch.models import transformer
    cfg, engine_kw = serving.CONFIG, serving.SERVE_ENGINE
    traffic = serving.SERVE_TRAFFIC
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, size=(traffic["requests"],
                                               traffic["prompt_len"]),
                           dtype=np.int32)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device="cuda")
    tokens1, logits1 = engine_1x1_logits(torch, cfg, engine_kw, params,
                                         prompts, SERVE_TP_TOKENS)
    del params
    if any(not np.array_equal(a, b[:SERVE_TP_TOKENS])
           for a, b in zip(tokens1, phase3["tokens"])):
        raise AssertionError("18: the 1x1 engine that keeps its logits "
                             "did not give phase 3's tokens")
    want = {a: decode_tp_reference(torch, np, a, tp) for a, tp in DECODE_TP}
    if phase22 is not None:
        phase22["22d_1x1"] = xla_serve_1x1(torch, cfg)
    log(f"  18 1x1 sides: phase 3's tokens and logits and "
        f"{[a for a, _ in DECODE_TP]}'s paths in "
        f"{time.perf_counter() - t0:.1f} s; memory allocated as the ranks "
        f"start {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    paths, engine_fa, engines, fsdp2 = [], {}, {}, None
    for tp in SERVE_TP:
        tasks = [("engine", (cfg, engine_kw, prompts, SERVE_TP_TOKENS))]
        tasks += [("decode", (a,)) for a, t in DECODE_TP if t == tp]
        if tp == 2 and fsdp_args is not None:
            tasks.append(("fsdp", fsdp_args))
        if tp == 2 and phase22 is not None:
            tasks.append(("xla", (xla_serve_argv(cfg) + ["--model", "2"],)))
        t0 = time.perf_counter()
        res = build.shard_mapped(serve_tp_rank, (1, tp), [(tasks,)] * tp,
                                 device="cuda")
        wall = time.perf_counter() - t0
        paths.append(serve_tp_check(np, serving, tp, [r[0] for r in res],
                                    phase3, logits1, card))
        engine_fa[tp] = paths[-1]["flash_attention"]
        engines[tp] = dict(tokens=res[0][0]["tokens"],
                           flash_attention=res[0][0]["counts"][
                               "flash_attention"])
        for i, (name, args) in enumerate(tasks):
            if name == "decode":
                paths.append(decode_tp_check(np, args[0], tp,
                                             [r[i] for r in res],
                                             want[args[0]], card))
            elif name == "fsdp":
                fsdp2 = [r[i] for r in res]
            elif name == "xla":
                phase22["22d"] = [r[i] for r in res]
        log(f"  18 the {tp}-rank spawn: {wall:.1f} s, spawn included "
            f"({card})")
    return paths, engine_fa, engines, fsdp2


def serve_tp_attention(torch, fa, ref, gen, card, serving) -> list:
    """18: kernel 4 at 18a's per-rank paged prefill shapes (B 1, the
    prompt bucket of queries against the engine's max_seq of keys, D
    64, bf16, causal): tp 2 holds 7 q heads over 1 kv head, tp 4 4 q
    heads over 4 (the kv heads expanded through the cache plan's q2slot,
    group 1), against the plain version within phase 2's limit, then
    timed beside it and scaled_dot_product_attention; each row's
    `calls`, L x 8 prefills x tp, is what 18a must launch, summed over
    the ranks (its measured count is held to it in `main`)."""
    import torch.nn.functional as F
    cfg, kw = serving.CONFIG, serving.SERVE_ENGINE
    n_prefill = serving.SERVE_TRAFFIC["requests"]
    rows = []
    for tp in SERVE_TP:
        hq = -(-cfg.n_heads // tp)
        hkv = cfg.n_kv_heads // tp if cfg.n_kv_heads >= tp \
            and cfg.n_heads % tp == 0 else hq
        q, k, v = attention_inputs(torch, gen, 1, hq, hkv,
                                   kw["prompt_bucket"], kw["max_seq"],
                                   cfg.hd, torch.bfloat16)
        out = fa.flash_attention(q, k, v, causal=True)
        want = plain_attention(torch, ref, q, k, v, causal=True)
        err, over = attention_over(torch, out, want, torch.bfloat16)
        if not (over <= 1.0 and fa.tensor_core_route(q, k, v)):
            raise AssertionError(f"18: kernel 4 at the 1x{tp} paged prefill "
                                 f"shape: err/limit {over}")
        del q, k, v, out, want
        t = time_attention_at(torch, F, fa, ref, gen, card, 1, hq, hkv,
                              kw["prompt_bucket"], kw["max_seq"], cfg.hd)
        t.update(shape=f"{cfg.name} paged prefill 1x{tp} per rank (B 1, Hq "
                 f"{hq}, Hkv {hkv}, Lq {kw['prompt_bucket']}, Lk "
                 f"{kw['max_seq']}, D {cfg.hd}, bf16, causal)",
                 calls=cfg.n_layers * n_prefill * tp)
        log(f"  18 kernel 4 at the 1x{tp} paged prefill shape: err/limit "
            f"{over:.3f} against the plain version (tensor cores)")
        rows.append(t)
    return rows


# ---------------------------------------------------------------------------
# phase 19: sequence sharding — the ring's model path over rank processes,
# and the sequence-sharded long-context decode
# ---------------------------------------------------------------------------
# One spawn of SEQ_RANKS rank processes on a (4, 1) mesh (data 4) runs
# 19a-19c in turn, each model freed before the next; the parent runs every
# 1x1 side after the ranks exit.  19a: `fusion.ring_attention` on the
# data axis's `spmd_ctx` over phase 8's prompt (qwen2-0.5b's layer-0 q,
# k, v of RING_RUN's 32768 tokens, 8192 a rank), against kernel 4 over
# the gathered sequence; one backward through the ring layer in f32.
# 19b: qwen2-0.5b's 24 layers with attention="ring" over SEQ_MODEL_LEN
# tokens sharded by sequence, at their global positions.  19c:
# zamba2-1.2b's decode at the reference's long_500k cell through
# `build.make_serve_steps` (seq_shards 4: each rank holds 131072 of the
# 524288 slots of each of the 7 shared attention caches).

SEQ_RANKS = 4
# 19a: the ring layer's gradient over this many tokens (512 a rank), f32
SEQ_GRAD_LEN = 2048
# 19a: the ring layer's gradient against the mono layer's, every leaf:
# |ring - mono| <= SEQ_GRAD_RTOL |mono| + SEQ_GRAD_ATOL x max|mono| (the
# CPU parity tests' rtol 1e-4 / atol 1e-5, the atol relative to the
# leaf's scale)
SEQ_GRAD_RTOL, SEQ_GRAD_ATOL = 1e-4, 1e-5
# 19b: qwen2-0.5b's forward over this many tokens (2048 a rank); the f32
# logits of every SEQ_ROW_STRIDE-th row of a shard (and its last) go back
# to the parent, the argmax of every row
SEQ_MODEL_LEN = 8192
SEQ_ROW_STRIDE = 64
# 19c: the long_500k decode: 4 teacher-forced steps from position
# SEQ_T0 - 4 after the end (the last shard owns the writes), then 4 in
# shard 1's range; the f32 gate's cache length
SEQ_DECODE_STEPS = 4
SEQ_F32_CELL = dict(seq_len=65536, global_batch=1, kind="decode")
# 19c's caches are drawn this many rows at a time (zamba2: 1 GiB of f32)
SEQ_FILL_ROWS = 1 << 17


def seq_ring_qkv(torch, np, cfg, params, run, lo, hi):
    """Phase 8's ring inputs, rows [lo, hi): qwen2's layer-`run["layer"]`
    q, k, v (B, H, rows, D) of RING_RUN's seeded prompt at its global
    positions, and those positions (int32)."""
    from repro_torch.models import layers as L
    from repro_torch.parallel.comm import Comm
    seq = run["seq_len"]
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab, size=(run["batch"], seq))[:, lo:hi], device="cuda")
    pos = torch.arange(lo, hi, device="cuda").expand(run["batch"], hi - lo)
    bp = params["layers"][run["layer"]]
    with torch.no_grad():
        h = L.rms_norm(L.embed(Comm(), cfg, params["embed"], tokens),
                       bp["ln1"])
        q, k, v = L.attention_qkv(cfg, bp["attn"], h, pos)
    return q, k, v, pos[0].to(torch.int32)


def seq_grad_inputs(torch, cfg):
    """19a's gradient check: x (1, SEQ_GRAD_LEN, d) and the cotangent
    weights w, drawn from seeded generators on the card (every rank and
    the parent draw the same)."""
    gen = torch.Generator(device="cuda").manual_seed(1900)
    shape = (1, SEQ_GRAD_LEN, cfg.d_model)
    return (torch.randn(shape, generator=gen, device="cuda"),
            torch.randn(shape, generator=gen, device="cuda"))


def seq_layer_grads(torch, cfg, comm, p, x, w, positions):
    """(output, dx, {leaf: gradient}) of sum(w * attention(x)) for the
    attention layer `p` in f32."""
    from repro_torch.models import layers as L
    p = {k: t.detach().clone().requires_grad_() for k, t in p.items()}
    x = x.detach().clone().requires_grad_()
    out = L.attention(comm, cfg, p, x, positions)
    (w * out).sum().backward()
    return out.detach(), x.grad, {k: t.grad for k, t in p.items()}


def seq_forward(comm, cfg, params, tokens, positions):
    """qwen2's layer stack at the given (global) positions -> logits:
    `transformer.forward` builds arange(L) of the tokens it is handed
    (the reference's, too), so a sequence shard is driven block by block
    here; at 1x1 with positions arange(L) it is `forward` +
    `lm_logits`."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer
    x = transformer._embed_scaled(comm, cfg, params, tokens)
    for i, bp in enumerate(params["layers"]):
        x, _ = transformer._attn_block(comm, cfg, bp, x, positions,
                                       transformer._is_local(cfg, i))
    x = L.rms_norm(x, params["final_norm"])
    return L.lm_logits(comm, cfg, params["embed"], x)


def seq_model_tokens(np, cfg):
    return np.random.default_rng(1901).integers(
        1, cfg.vocab, size=(1, SEQ_MODEL_LEN))


def seq_rows(ls):
    """The rows of a shard of `ls` whose f32 logits 19b returns."""
    return sorted(set(range(0, ls, SEQ_ROW_STRIDE)) | {ls - 1})


def seq_decode_positions(S):
    """19c's positions for a cache of S global slots: the last 4 (the
    last shard writes), then 4 early in shard 1's range."""
    s1 = S // SEQ_RANKS + S // (4 * SEQ_RANKS)
    return (list(range(S - SEQ_DECODE_STEPS, S))
            + list(range(s1, s1 + SEQ_DECODE_STEPS)))


def seq_decode_tokens(np, cfg, n):
    return np.random.default_rng(1902).integers(1, cfg.vocab, size=(1, n))


def seq_fill_cache(torch, cache, shard, n_shards):
    """Fill a zamba2 decode cache in place from seeded generators: each
    shared attention cache (k, v) chunk by chunk, chunk (layer, shard s)
    from its own seed, so that the rank of shard `shard` (of `n_shards`
    ranks; n_shards 1: the 1x1 cache, every chunk at its rows) holds
    exactly its rows of the 1x1 cache; the Mamba2 caches (replicated over
    the data axis) from a seed a layer."""
    for i, c in enumerate(cache["layers"]):
        gen = torch.Generator(device="cuda").manual_seed(19000 + i)
        for k in ("conv", "ssm"):
            c[k].copy_(0.5 * torch.randn(c[k].shape, generator=gen,
                                         device="cuda"))
    chunks = [shard] if n_shards > 1 else range(SEQ_RANKS)
    for i, c in enumerate(cache["shared"]):
        for j, k in enumerate(("k", "v")):
            t = c[k]
            rows = t.shape[1] // len(chunks)
            for n, s in enumerate(chunks):
                gen = torch.Generator(device="cuda").manual_seed(
                    19100 + 100 * i + 10 * s + j)
                part = t[:, n * rows:(n + 1) * rows]
                for lo in range(0, rows, SEQ_FILL_ROWS):
                    hi = min(lo + SEQ_FILL_ROWS, rows)
                    part[:, lo:hi].copy_(torch.randn(
                        part[:, lo:hi].shape, generator=gen, device="cuda"))


def seq_decode_run(torch, decode, params, cache, tokens, positions, rt=None):
    """19c's steps: decode(params, cache, {"tokens", "positions"}) at each
    position in turn on the global batch (1 sequence), teacher-forced.
    -> (logits (steps, V_local) f32 on the host, wall a step, heap rounds
    a step, launch counts summed over the steps)."""
    tokens = torch.as_tensor(tokens, device="cuda")
    out, rounds = [], []
    torch.cuda.synchronize()
    _reset_counts()                                  # the path starts
    t0 = time.perf_counter()
    for n, pos in enumerate(positions):
        r0 = rt.rounds if rt is not None else 0
        lg, cache = decode(params, cache, {
            "tokens": tokens[:, n:n + 1],
            "positions": torch.full((1,), pos, device="cuda")})
        out.append(lg[0, 0].float())
        rounds.append(rt.rounds - r0 if rt is not None else 0)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / len(positions)
    counts = _counts()                               # the path ends
    return (torch.stack(out).cpu().numpy(), wall, rounds, counts)


def seq_shard_rank(serving_cfg, run, zamba_cfg):
    """19, one rank of the (4, 1) mesh: 19a, 19b, 19c in turn, each
    path's launches, heap rounds and host time in their syncs counted
    from 0 just before it and read just after."""
    import numpy as np
    import torch
    from repro_torch.core import fusion, spmd
    from repro_torch.core.shmem import spmd_ctx
    from repro_torch.launch import build
    from repro_torch.models import config as mconfig
    from repro_torch.models import transformer
    from repro_torch.parallel.comm import AxisSpec, Comm
    torch.backends.cuda.matmul.allow_tf32 = False
    rt = spmd.current()
    n, d = rt.mesh.axis_size("data"), rt.mesh.axis_index("data")
    out = {}
    cfg = serving_cfg
    params = transformer.init_params(cfg, seed=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    # 19a: the ring over the ranks, phase 8's prompt
    ls = run["seq_len"] // n
    q, k, v, pos = seq_ring_qkv(torch, np, cfg, params, run, d * ls,
                                (d + 1) * ls)
    ctx = spmd_ctx("data")
    for _ in range(2):                    # the first call warms the rank
        torch.cuda.synchronize()
        _reset_counts()                              # the path starts
        r0, s0 = rt.rounds, rt.sync_s
        t0 = time.perf_counter()
        o = fusion.ring_attention(ctx, q[None], k[None], v[None], pos[None],
                                  pos[None], causal=True)
        torch.cuda.synchronize()
        out["19a"] = dict(wall=time.perf_counter() - t0, counts=_counts(),
                          rounds=rt.rounds - r0, sync_s=rt.sync_s - s0)
    out["19a"]["out"] = o[0].cpu()
    del q, k, v, o
    # 19a: one backward through the ring layer, f32
    ring32 = dataclasses.replace(cfg, dtype=torch.float32, attention="ring")
    x, w = seq_grad_inputs(torch, cfg)
    gl = SEQ_GRAD_LEN // n
    rows = slice(d * gl, (d + 1) * gl)
    _reset_counts()
    _, gx, gp = seq_layer_grads(
        torch, ring32, Comm(AxisSpec()), params["layers"][0]["attn"],
        x[:, rows], w[:, rows],
        torch.arange(SEQ_GRAD_LEN, device="cuda")[rows][None])
    out["19a"]["grad"] = dict(gx=gx.cpu(), gp={k_: g.cpu()
                                               for k_, g in gp.items()},
                              counts=_counts())
    del x, w, gx, gp
    # 19b: the 24 layers through the ring, f32 compute then bf16
    toks = torch.as_tensor(seq_model_tokens(np, cfg), device="cuda")
    ls = SEQ_MODEL_LEN // n
    rows = slice(d * ls, (d + 1) * ls)
    positions = torch.arange(SEQ_MODEL_LEN, device="cuda")[rows][None]
    keep = seq_rows(ls)
    for key, dt in (("f32", torch.float32), ("bf16", cfg.dtype)):
        c = dataclasses.replace(cfg, dtype=dt, attention="ring")
        torch.cuda.synchronize()
        _reset_counts()                              # the path starts
        r0, s0 = rt.rounds, rt.sync_s
        t0 = time.perf_counter()
        with torch.no_grad():
            lg = seq_forward(Comm(AxisSpec()), c, params, toks[:, rows],
                             positions)[0]
        torch.cuda.synchronize()
        res = dict(wall=time.perf_counter() - t0, counts=_counts(),
                   rounds=rt.rounds - r0, sync_s=rt.sync_s - s0,
                   finite=bool(torch.isfinite(lg).all()),
                   argmax=lg.argmax(-1).cpu().numpy(),
                   rows=lg[keep].float().cpu().numpy())
        out["19b_" + key] = res
        del lg
    del params, toks
    out["peak_qwen"] = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    # 19c: zamba2's long_500k decode through make_serve_steps, bf16 (the
    # config's own dtype), then f32 compute at SEQ_F32_CELL's length
    torch.cuda.reset_peak_memory_stats()
    zparams = transformer.init_params(zamba_cfg, seed=0, device="cuda")
    mconfig.SHAPES["seq_f32"] = SEQ_F32_CELL
    for key, c, cell in (("bf16", zamba_cfg, "long_500k"),
                         ("f32", dataclasses.replace(
                             zamba_cfg, dtype=torch.float32), "seq_f32")):
        _, decode, (cshapes, _), _, ss = build.make_serve_steps(c, rt.mesh,
                                                                cell)
        cache = transformer.map_params(lambda t: torch.zeros(
            t.shape, dtype=t.dtype, device="cuda"), cshapes)
        seq_fill_cache(torch, cache, d, n)
        S = mconfig.SHAPES[cell]["seq_len"]
        positions = seq_decode_positions(S)
        tokens = seq_decode_tokens(np, c, len(positions))
        s0 = rt.sync_s
        lg, wall, rounds, counts = seq_decode_run(torch, decode, zparams,
                                                  cache, tokens, positions,
                                                  rt)
        out["19c_" + key] = dict(seq_shards=ss, wall=wall, rounds=rounds,
                                 counts=counts, logits=lg,
                                 sync_s=(rt.sync_s - s0) / len(positions),
                                 slots=cache["shared"][0]["k"].shape[1])
        del cache
        gc.collect()
        torch.cuda.empty_cache()
    out["peak_zamba"] = torch.cuda.max_memory_allocated()
    del zparams
    gc.collect()
    torch.cuda.empty_cache()
    return out


def seq_shard(torch, np, serving, zamba, ra, ref, ops, gen, card) -> tuple:
    """Phase 19: kernel 6 at the per-rank shapes of 19a and 19b against
    its plain version, timed beside it and SDPA; one spawn of SEQ_RANKS
    ranks (`seq_shard_rank`); then the 1x1 sides in this process, each
    freed before the next, and the gates.  Returns each path's launch
    counts summed over the ranks, and kernel 6's timed rows, each with
    the launches of its shape on the path."""
    from repro_torch.core import collectives as coll
    from repro_torch.launch import build
    from repro_torch.models import transformer
    from repro_torch.parallel.comm import Comm
    from repro_torch.serve import step as sstep
    cfg, run, zcfg = serving.CONFIG, serving.RING_RUN, zamba.CONFIG
    n = SEQ_RANKS
    total_mem = torch.cuda.get_device_properties(0).total_memory
    ls_a, ls_b = run["seq_len"] // n, SEQ_MODEL_LEN // n
    timing = []
    for key, ls, dtype in (("19a", ls_a, "bfloat16"), ("19b_bf16", ls_b,
                                                      "bfloat16"),
                           ("19b_f32", ls_b, "float32")):
        t = time_ring_partials(torch, ra, ref, gen, card, (
            1, 1, cfg.n_heads, cfg.n_kv_heads, ls, ls, cfg.hd), dtype)
        t.update(key=key, shape=f"{cfg.name} ring block per rank of "
                 f"{n} (B 1, Hq {cfg.n_heads}, Hkv {cfg.n_kv_heads}, Lq = "
                 f"Lk {ls}, D {cfg.hd}, {dtype}, causal, the diagonal "
                 f"block; phase {key[:3]})")
        timing.append(t)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = build.shard_mapped(seq_shard_rank, (n, 1),
                             [(cfg, run, zcfg)] * n, device="cuda")
    log(f"  19 the {n}-rank spawn: {time.perf_counter() - t0:.1f} s, spawn "
        f"included; peak a rank (share of the card's {total_mem / 2**30:.1f}"
        f" GiB): 19a-b "
        + ", ".join(f"{r['peak_qwen'] / total_mem:.3f}" for r in res)
        + "; 19c " + ", ".join(f"{r['peak_zamba'] / total_mem:.3f}"
                               for r in res) + f" ({card})")

    # 19a: the ring against kernel 4 over the gathered sequence
    params = transformer.init_params(cfg, seed=0, device="cuda")
    q, k, v, _ = seq_ring_qkv(torch, np, cfg, params, run, 0,
                              run["seq_len"])
    ops.attention(q, k, v, causal=True)              # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mono = ops.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    mono_wall = time.perf_counter() - t0
    del q, k, v
    want = {name: 0 for name in res[0]["19a"]["counts"]}
    want.update(ring_attention=n, dma_copy=2 * 3 * (n - 1))
    overs = []
    for d, r in enumerate(res):
        a = r["19a"]
        overs.append(bf16_over(torch, a["out"].cuda(),
                               mono[:, :, d * ls_a:(d + 1) * ls_a]))
        if a["counts"] != want or a["rounds"] != 3 * (n - 1):
            raise AssertionError(f"19a rank {d}: launches {a['counts']}, "
                                 f"{a['rounds']} heap rounds; want {want}, "
                                 f"{3 * (n - 1)}")
    log(f"  19a ring over {n} ranks of {cfg.name} layer {run['layer']}'s q "
        f"k v over {run['seq_len']} tokens ({ls_a} a rank, bf16, causal): "
        f"err/limit vs kernel 4 on the gathered sequence "
        + ", ".join(f"{o:.3f}" for o in overs)
        + f" (limit max(2e-5, 1 bf16 step)); per rank {n} kernel-6 "
        f"launches, {3 * (n - 1)} heap rounds (3 puts x {n - 1} rotations), "
        f"{2 * 3 * (n - 1)} dma_copy; ring wall (host clock, rank 0) "
        f"{res[0]['19a']['wall'] * 1e3:.3f} ms, its heap rounds' syncs "
        f"{res[0]['19a']['sync_s'] * 1e3:.3f} ms; mono (kernel 4 over the "
        f"gathered sequence, one process) {mono_wall * 1e3:.3f} ms ({card})")
    if not max(overs) <= 1.0:
        raise AssertionError(f"19a ring vs kernel 4: err/limit {overs}")
    del mono
    # 19a: the ring layer's gradient against the mono layer's, f32
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    x, w = seq_grad_inputs(torch, cfg)
    _, gx, gp = seq_layer_grads(torch, cfg32, Comm(),
                                params["layers"][0]["attn"], x, w,
                                torch.arange(SEQ_GRAD_LEN,
                                             device="cuda")[None])
    gl = SEQ_GRAD_LEN // n
    leaves = {"x": (torch.cat([r["19a"]["grad"]["gx"] for r in res], 1),
                    gx.cpu())}
    leaves.update({k_: (sum(r["19a"]["grad"]["gp"][k_] for r in res),
                        g.cpu()) for k_, g in gp.items()})
    worst = {}
    for name, (got, want_) in leaves.items():
        lim = SEQ_GRAD_RTOL * want_.abs() + SEQ_GRAD_ATOL \
            * want_.abs().max()
        worst[name] = float(((got - want_).abs() / lim).max())
    log(f"  19a gradient of sum(w * ring layer) over {SEQ_GRAD_LEN} tokens "
        f"({gl} a rank, f32; kernel 6's backward recomputes through the "
        f"plain partials) vs the mono layer's, worst |diff| / (rtol "
        f"{SEQ_GRAD_RTOL:g} |g| + atol {SEQ_GRAD_ATOL:g} max|g|): "
        + ", ".join(f"{k_} {v_:.3f}" for k_, v_ in worst.items()))
    if not max(worst.values()) <= 1.0:
        raise AssertionError(f"19a ring layer gradient: {worst}")
    del x, w, gx, gp, leaves

    # 19b: the 24 layers through the ring against the 1x1 mono forward
    toks = torch.as_tensor(seq_model_tokens(np, cfg), device="cuda")
    pos = torch.arange(SEQ_MODEL_LEN, device="cuda")[None]
    keep = seq_rows(ls_b)
    with torch.no_grad():
        lg1 = seq_forward(Comm(), cfg32, params, toks, pos)[0]
    f32_worst = 0.0
    for d, r in enumerate(res):
        b = r["19b_f32"]
        for i, row in enumerate(keep):
            w1 = lg1[d * ls_b + row].cpu().numpy()
            err = float(np.abs(b["rows"][i] - w1).max())
            lim = DECODE_TP_F32_RTOL * float(np.abs(w1).max())
            f32_worst = max(f32_worst, err / lim)
            if not (b["finite"] and err <= lim):
                raise AssertionError(f"19b f32 rank {d} row {row}: "
                                     f"max|diff| {err} (limit {lim})")
    del lg1
    with torch.no_grad():
        lgb = seq_forward(Comm(), cfg, params, toks, pos)[0]
    pick1 = lgb.argmax(-1).cpu().numpy()
    ties, bdev = [], 0.0
    for d, r in enumerate(res):
        b = r["19b_bf16"]
        if not b["finite"]:
            raise AssertionError(f"19b bf16 rank {d}: logits not finite")
        for i, row in enumerate(keep):
            w1 = lgb[d * ls_b + row].float().cpu().numpy()
            bdev = max(bdev, float(np.abs(b["rows"][i] - w1).max()
                                   / np.abs(w1).max()))
        for row in np.flatnonzero(b["argmax"] != pick1[d * ls_b:
                                                      (d + 1) * ls_b]):
            lg = lgb[d * ls_b + row].float().cpu().numpy()
            gap = top2_gap(np, lg)
            lim = PREFILL_LOGITS_RTOL * float(np.abs(lg).max())
            ties.append((d, int(row), gap))
            if not gap <= lim:
                raise AssertionError(f"19b bf16 rank {d} row {row}: argmax "
                                     f"{int(b['argmax'][row])}, 1x1's "
                                     f"{int(pick1[d * ls_b + row])} at a "
                                     f"top-2 gap of {gap} (bound {lim})")
    del lgb, params, toks, pos
    L_ = cfg.n_layers
    for key in ("19b_f32", "19b_bf16"):
        want = {name: 0 for name in res[0][key]["counts"]}
        want.update(ring_attention=L_ * n, dma_copy=2 * 3 * (n - 1) * L_)
        for d, r in enumerate(res):
            b = r[key]
            if b["counts"] != want or b["rounds"] != 3 * (n - 1) * L_:
                raise AssertionError(f"19b {key} rank {d}: launches "
                                     f"{b['counts']}, {b['rounds']} heap "
                                     f"rounds; want {want}, "
                                     f"{3 * (n - 1) * L_}")
    log(f"  19b {cfg.name}'s {L_} layers with attention='ring' over "
        f"{SEQ_MODEL_LEN} tokens ({ls_b} a rank, global positions): f32 "
        f"logits of {len(keep)} rows a rank vs the 1x1 mono forward, worst "
        f"max|diff| / limit {f32_worst:.4f} (limit {DECODE_TP_F32_RTOL:g} "
        f"x max|logit|); bf16 (the config's own): finite, max|diff| / "
        f"max|logit| vs 1x1 over those rows {bdev:.4f}, every row's argmax "
        f"== 1x1's" + (f" but at {len(ties)} near ties of {SEQ_MODEL_LEN} "
                       f"rows (1x1 top-2 gaps {min(t_[2] for t_ in ties)}"
                       f"-{max(t_[2] for t_ in ties)}, the first (rank, row,"
                       f" gap) {ties[:4]})" if ties else "")
        + f"; per rank {L_ * n} kernel-6 launches, {3 * (n - 1) * L_} heap "
        f"rounds a forward; walls (rank 0, host clock) f32 "
        f"{res[0]['19b_f32']['wall'] * 1e3:.1f} ms, bf16 "
        f"{res[0]['19b_bf16']['wall'] * 1e3:.1f} ms, the rounds' syncs "
        f"{res[0]['19b_bf16']['sync_s'] * 1e3:.1f} ms ({card})")
    gc.collect()
    torch.cuda.empty_cache()

    # 19c: the sequence-sharded decode against the 1x1 decode
    n_shared = transformer.n_shared_blocks(zcfg)
    stages = len(coll.allreduce_schedule(n).stages)
    per_step = n_shared * 3 * stages
    zparams = transformer.init_params(zcfg, seed=0, device="cuda")
    for key, c, S in (("bf16", zcfg, 524288),
                      ("f32", dataclasses.replace(zcfg, dtype=torch.float32),
                       SEQ_F32_CELL["seq_len"])):
        cache = transformer.init_cache(c, 1, 1, S, device="cuda")
        seq_fill_cache(torch, cache, 0, 1)
        positions = seq_decode_positions(S)
        tokens = seq_decode_tokens(np, c, len(positions))
        torch.cuda.reset_peak_memory_stats()
        lg1, wall1, _, _ = seq_decode_run(torch, sstep.build_decode_step(c),
                                          zparams, cache, tokens, positions)
        peak1 = torch.cuda.max_memory_allocated()
        del cache
        gc.collect()
        torch.cuda.empty_cache()
        worst, ties = 0.0, []
        for d, r in enumerate(res):
            z = r["19c_" + key]
            if z["seq_shards"] != n or z["slots"] != S // n:
                raise AssertionError(f"19c {key} rank {d}: seq_shards "
                                     f"{z['seq_shards']}, {z['slots']} slots")
            want = {name: 0 for name in z["counts"]}
            want.update(dma_copy=2 * per_step * len(positions),
                        reduce_combine=per_step * len(positions))
            if z["counts"] != want or z["rounds"] != [per_step] * len(
                    positions):
                raise AssertionError(f"19c {key} rank {d}: launches "
                                     f"{z['counts']}, heap rounds "
                                     f"{z['rounds']}; want {want}, "
                                     f"{per_step} a step")
            lg = z["logits"]
            if not np.isfinite(lg).all():
                raise AssertionError(f"19c {key} rank {d}: logits not finite")
            for t in range(len(positions)):
                top = float(np.abs(lg1[t]).max())
                err = float(np.abs(lg[t] - lg1[t]).max())
                if key == "f32":
                    lim = DECODE_TP_F32_RTOL * top
                    worst = max(worst, err / lim)
                    if not err <= lim:
                        raise AssertionError(f"19c f32 rank {d} step {t}: "
                                             f"max|diff| {err} (limit {lim})")
                    continue
                worst = max(worst, err / top)
                got_, want_ = int(lg[t].argmax()), int(lg1[t].argmax())
                if got_ != want_:
                    gap = top2_gap(np, lg1[t])
                    ties.append((d, t, gap))
                    if not gap <= PREFILL_LOGITS_RTOL * top:
                        raise AssertionError(
                            f"19c bf16 rank {d} step {t}: pick {got_}, "
                            f"1x1's {want_} at a top-2 gap of {gap} (bound "
                            f"{PREFILL_LOGITS_RTOL * top})")
        z0 = res[0]["19c_" + key]
        log(f"  19c {zcfg.name} decode, {key} compute, {S} slots "
            f"(make_serve_steps at "
            f"{'long_500k' if key == 'bf16' else 'a ' + str(S) + '-slot cell'}"
            f": seq_shards {n}, {S // n} slots a rank in each of "
            f"{n_shared} shared caches), positions {positions[0]}.."
            f"{positions[SEQ_DECODE_STEPS - 1]} (shard {n - 1} writes) and "
            f"{positions[SEQ_DECODE_STEPS]}..{positions[-1]} (shard 1): "
            + (f"logits vs 1x1 worst max|diff| / limit {worst:.4f} (limit "
               f"{DECODE_TP_F32_RTOL:g} x max|logit|)" if key == "f32" else
               f"finite, picks == 1x1's"
               + (f" but near ties (rank, step, gap) {ties}" if ties else "")
               + f", max|diff| / max|logit| vs 1x1 {worst:.4f}")
            + f"; {per_step} heap rounds a step a rank ({n_shared} layers x 3 "
            f"allreduces x {stages} stages; 2 dma_copy a round, a combine a "
            f"stage); step wall (rank 0) "
            f"{z0['wall'] * 1e3:.1f} ms, its rounds' syncs "
            f"{z0['sync_s'] * 1e3:.1f} ms, against 1x1 {wall1 * 1e3:.1f} ms "
            f"(1x1 peak {peak1 / 2**30:.2f} GiB) ({card})")
    del zparams
    gc.collect()
    torch.cuda.empty_cache()
    paths = [{k_: sum(r[key]["counts"][k_] for r in res)
              for k_ in res[0][key]["counts"]}
             for key in ("19a", "19b_f32", "19b_bf16", "19c_bf16", "19c_f32")]
    paths.append({k_: sum(r["19a"]["grad"]["counts"][k_] for r in res)
                  for k_ in res[0]["19a"]["grad"]["counts"]})
    for t in timing:
        t["calls"] = sum(r[t["key"]]["counts"]["ring_attention"] for r in res)
    return paths, timing


# ---------------------------------------------------------------------------
# phase 20: fsdp, checkpoints and the engine's drain on a rank mesh
# ---------------------------------------------------------------------------
# 20a trains qwen2-0.5b with fsdp=True (ZeRO-3 over `data`: every 2-D
# block weight's rows halved over the 2 data PEs, gathered inside its
# block) on 2x2 at 16b's shape, through build.make_train_step's default
# sync from the 1x1 seed-0 tree fitted to the mesh and cut to each
# rank's rows (each rank draws it itself, as 16b).  20b runs the train
# launcher on 2x2 with fsdp, killed at a step's batch fetch after a
# checkpoint landed (`test_fault.py`'s FAULT_RESUME_SCRIPT), resumed
# from a copy of that checkpoint, and an uninterrupted run resumed from
# another copy; then the same checkpoint resumed on 1x2 (the elastic
# shrink).  20c serves phase 3's traffic with qwen2's paged engine on
# 1x2 with a PEFailure at the third step's decode on every rank.  No
# spawn of its own: 20a and 20b's 2x2 runs follow 16b in its 4 ranks
# (`mesh_train`'s `extra`), the shrink and 20c follow 18's work in its 2
# ranks (`serve_tp`'s `fsdp_args`), both warm by then; phase 20 checks
# their results after phase 19.  The launcher has no fsdp flag (nor has
# the reference's): its rank bodies patch `configs.get_config` to the
# config with fsdp=True.

# 20a's steps: one since phase 22 joined the run (2 at PR 29); every
# gate is kept
FSDP_TRAIN = dict(SPMD_TRAIN, steps=1)
# 20b: the launcher's --steps, --ckpt-every and shape (a batch of one
# row a data PE: one microbatch, so a step is a quarter of 20a's heap
# rounds); the kill at step FSDP_KILL_AT's batch fetch, after step
# FSDP_KILL_AT - 1's checkpoint
FSDP_KILL = dict(steps=3, ckpt_every=1, seq_len=128, batch=2)
FSDP_KILL_AT = 2
FSDP_DIR = ROOT / "build" / "phase20"


def fsdp_config(cfg):
    return dataclasses.replace(cfg, fsdp=True)


def fsdp_step_formula(torch, cfg, params, mb, dp, slot_bytes) -> dict:
    """20a's launches and heap rounds a default-sync step a rank, of the
    dense family on 2x2 with fsdp and remat, `params` the rank's shards.
    Per microbatch: 7 rounds outside the layers (4 in the forward: the
    embedding's allreduce over `model` and sharded_xent's three; 3 in
    the backward), and a layer's 5 (its two allreduces over `model` in
    the forward and again under remat, 1 in its backward) plus 3R (its
    G 2-D leaves each gathered over `data` in the forward, again under
    remat, and its backward's delivery, R rounds each time:
    `fsdp_gathers`, 1 a leaf at qwen2's sizes); per step the loss's mean
    over `data` (1) and the default sync's S rounds: each bucket of
    fused_grad_sync's plan (the synced leaves: fsdp leaves are not) one
    recursive-doubling stage, in ceil(bytes / slot) slot-sized chunks.
    Kernel 2 twice a round, plus one block move each gather and each
    gather's backward; kernel 3 a combine each round of an allreduce: 4
    + 3L a microbatch and one a bucket and the loss's; kernel 4 twice a
    layer a microbatch (remat).  Measured on the CPU against the port's
    code at 2-3 layers, 1, 2 and 4 microbatches, with and without fsdp
    (G = R = 0 without)."""
    from repro_torch.core import heap
    from repro_torch.core.heap import tree_flatten
    from repro_torch.parallel import sharding
    from repro_torch.train import step as tstep
    L = cfg.n_layers
    G, R = fsdp_gathers(params["layers"][0], dp, slot_bytes)
    mask = tree_flatten(sharding.needs_data_sync(cfg, params))[0]
    synced = [t for t, m in zip(tree_flatten(params)[0], mask) if m]
    budget = tstep.BUCKET_BYTES // 4
    buckets, cur, n = [], [], 0
    for t in synced:
        if cur and n + t.numel() > budget:
            buckets.append(cur)
            cur, n = [], 0
        cur.append(t)
        n += t.numel()
    if cur:
        buckets.append(cur)
    nbytes = [heap.plan_pack(b, dtype=torch.float32).total * 4
              for b in buckets]
    S = sum(-(-b // slot_bytes) for b in nbytes)
    rounds = 1 + S + mb * (7 + (5 + 3 * R) * L)
    return dict(rounds=rounds, G=G, R=R, S=S, buckets=len(buckets),
                counts=dict(flash_attention=2 * L * mb, put_copy=0,
                            dma_copy=2 * rounds + 3 * G * L * mb,
                            reduce_combine=1 + len(buckets)
                            + mb * (4 + 3 * L),
                            fused_update=0, ssd_scan=0, ring_attention=0,
                            paged_decode=0))


def fsdp_train_rank(argv):
    """20a, one rank: the 1x1 seed-0 tree fitted to the mesh and cut to
    this rank's fsdp rows; FSDP_TRAIN's steps of make_train_step's
    default sync (in place); losses, walls, the path's launches and heap
    rounds, peak, and the formulas'."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import spmd
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import build
    from repro_torch.launch import train as train_mod
    from repro_torch.train import optimizer as opt
    rt = spmd.current()
    args = train_mod.parse_args(argv)
    cfg, mesh = fsdp_config(get_config(args.arch)), rt.mesh
    params = seed0_shards(torch, cfg, mesh)
    adamw = opt.AdamWConfig(lr=args.lr, moment_dtype=cfg.moment_dtype)
    step, _, _ = build.make_train_step(cfg, mesh, adamw=adamw, donate=True)
    state = opt.init_state(params, adamw)
    b_local = args.batch // mesh.sizes["data"]
    mb = max(1, min(cfg.microbatches, b_local))
    while b_local % mb:
        mb -= 1
    formula = fsdp_step_formula(torch, cfg, params, mb, mesh.sizes["data"],
                                rt.heap.slot_bytes)
    pipe = SyntheticLM(cfg.vocab, args.seq_len, args.batch)
    losses, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                                    # the path starts
    r0, s0 = rt.rounds, rt.sync_s
    for s in range(args.steps):
        t0 = time.perf_counter()
        loss, params, state = step(params, state, pipe.batch(s))
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
    out = dict(losses=losses, walls=walls, counts=_counts(),
               rounds=rt.rounds - r0, sync_s=rt.sync_s - s0,
               peak=torch.cuda.max_memory_allocated(), formula=formula,
               mb=mb)
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fsdp_launcher(argv, params=None):
    """The train launcher's loop in this rank on `argv`, its config with
    fsdp=True."""
    from repro_torch import configs
    from repro_torch.launch import train as train_mod
    real = configs.get_config
    with mock.patch.object(configs, "get_config",
                           lambda arch, **kw: fsdp_config(real(arch, **kw))):
        return train_mod.train_loop(train_mod.parse_args(argv), params)


def fsdp_kill_rank(argv, ckpt_dir):
    """20b on 2x2, one rank: the launcher killed at step FSDP_KILL_AT's
    batch fetch (every rank's fetch raises, so no rank waits at a heap
    round), rank 0 waiting for the checkpoint before it to land and
    copying it twice; the resumed run and the uninterrupted one resumed
    from the other copy.  The path's launches and heap rounds, counted
    from 0 before the kill and read after the second resume."""
    import shutil

    import torch
    from repro_torch.ckpt import manager as ckpt
    from repro_torch.core import spmd
    from repro_torch.data import pipeline as data_mod
    rt = spmd.current()
    real = data_mod.SyntheticLM.batch

    def dying_batch(self, step):
        if step == FSDP_KILL_AT:
            raise RuntimeError("injected PE failure: node lost")
        return real(self, step)

    run = argv + ["--steps", str(FSDP_KILL["steps"])]
    torch.cuda.synchronize()
    _reset_counts()                                    # the path starts
    r0 = rt.rounds
    t0 = time.perf_counter()
    killed = ""
    data_mod.SyntheticLM.batch = dying_batch
    try:
        fsdp_launcher(run + ["--ckpt-dir", ckpt_dir, "--ckpt-every",
                             str(FSDP_KILL["ckpt_every"])])
    except RuntimeError as e:
        killed = str(e)
    finally:
        data_mod.SyntheticLM.batch = real
    gc.collect()
    torch.cuda.empty_cache()
    t_kill = time.perf_counter() - t0
    if rt.rank == 0:
        for _ in range(600):        # the async save may still be writing
            if ckpt.latest_step(ckpt_dir) == FSDP_KILL_AT - 1:
                break
            time.sleep(0.1)
        for tag in ("-resume", "-ref", "-shrink"):      # hard links
            shutil.copytree(ckpt_dir, ckpt_dir + tag,
                            copy_function=os.link)
    rt.barrier()
    latest = ckpt.latest_step(ckpt_dir)
    out = dict(killed=killed, latest=latest, t_kill=t_kill)
    for tag in ("-resume", "-ref"):
        t0 = time.perf_counter()
        res = fsdp_launcher(run + ["--ckpt-dir", ckpt_dir + tag,
                                   "--resume", "auto", "--ckpt-every",
                                   "100"])
        out[tag] = dict(losses=res.losses, walls=res.step_s,
                        wall=time.perf_counter() - t0)
        gc.collect()
        torch.cuda.empty_cache()
    out.update(counts=_counts(), rounds=rt.rounds - r0)
    return out


def fsdp_rank4(train_argv, kill_argv, ckpt_dir):
    """Phase 20's 2x2 work in a rank of 16b's spawn: 20a, then 20b's 2x2
    runs; with its wall."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = {"20a": fsdp_train_rank(train_argv),
           "20b": fsdp_kill_rank(kill_argv, ckpt_dir)}
    return dict(out, wall=time.perf_counter() - t0)


def fsdp_drain_rank(cfg, engine_kw, prompts, new_tokens):
    """20c, one rank: phase 3's seed-0 tree fitted to 1x2 and cut to this
    rank's shards (18a's); the engine on phase 3's traffic with a
    PEFailure at the DRAIN_AT_DECODE-th decode, raised on every rank
    (each counts its own calls: the ranks step in lockstep); the drained
    step's result, the queue and live pages after it, the tokens, the
    path's launches and heap rounds."""
    import torch
    from repro_torch.core import spmd
    from repro_torch.core.fault import PEFailure
    from repro_torch.models import convert, transformer
    from repro_torch.serve.engine import ServeEngine
    rt = spmd.current()
    mesh = rt.mesh
    params = transformer.map_params(torch.clone, convert.local_shards(
        convert.fit_global(transformer.init_params(cfg, seed=0,
                                                   device="cuda"),
                           cfg, tp=mesh.sizes["model"]), cfg, mesh))
    gc.collect()
    torch.cuda.empty_cache()
    eng = ServeEngine(cfg, mesh, params=params, **engine_kw)
    real, seen = transformer.decode_step_paged, {"calls": 0, "live": None}

    def dying(*a, **k):
        seen["calls"] += 1
        if seen["calls"] == DRAIN_AT_DECODE:
            seen["live"] = [st.rid for st in eng.scheduler.slots
                            if st is not None]
            raise PEFailure("PE 1 lost in the decode", pe=1, step=eng.steps)
        return real(*a, **k)

    faulted = []

    def check_drain(res):
        if res.get("faulted"):
            faulted.append(dict(res, queue=[r.rid for r in
                                            eng.scheduler.queue],
                                pages=eng.kv.pool.live_pages()))

    torch.cuda.synchronize()
    with mock.patch.object(transformer, "decode_step_paged", dying):
        _reset_counts()                                # the path starts
        r0 = rt.rounds
        rids, ttft, gaps, wall = drive_engine(torch, eng, prompts,
                                              new_tokens, check_drain)
        counts = _counts()                             # the path ends
    out = dict(faulted=faulted, live=seen["live"], counts=counts,
               decodes=seen["calls"] - 1,
               rounds=rt.rounds - r0, wall=wall, steps=eng.steps,
               tokens=[eng.results[r] for r in rids], ttft=ttft, gaps=gaps)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fsdp_rank2(shrink_argv, drain_args):
    """Phase 20's 1x2 work in a rank of 18's 2-rank spawn: 20b's shrink
    (the 2x2 checkpoint resumed on 1x2), then 20c; with its wall."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import spmd
    rt = spmd.current()
    t_all = time.perf_counter()
    torch.cuda.synchronize()
    _reset_counts()                                    # the path starts
    r0 = rt.rounds
    t0 = time.perf_counter()
    res = fsdp_launcher(shrink_argv)
    shrink = dict(losses=res.losses, wall=time.perf_counter() - t0,
                  counts=_counts(), rounds=rt.rounds - r0)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    out = {"shrink": shrink, "20c": fsdp_drain_rank(*drain_args)}
    return dict(out, wall=time.perf_counter() - t_all)


def fsdp_plan(serving) -> dict:
    """Phase 20's runs: the arguments of 20a and 20b's 2x2 runs (to ride
    in 16b's spawn: `mesh_train`'s `extra`) and of the shrink and 20c (in
    18's 2-rank spawn: `serve_tp`'s `fsdp_args`); a fresh checkpoint
    directory."""
    import shutil
    cfg = fsdp_config(serving.CONFIG)
    run = dict(FSDP_TRAIN, lr=serving.TRAIN_RUN["lr"])
    mesh = ["--data", str(run["data"]), "--model", str(run["model"])]
    argv = ["--arch", cfg.name, "--seq-len", str(run["seq_len"]),
            "--batch", str(run["batch"]), "--lr", str(run["lr"]),
            "--device", "cuda"] + mesh
    kill_argv = ["--arch", cfg.name, "--seq-len",
                 str(FSDP_KILL["seq_len"]), "--batch",
                 str(FSDP_KILL["batch"]), "--lr", str(run["lr"]),
                 "--device", "cuda"]
    shutil.rmtree(FSDP_DIR, ignore_errors=True)
    FSDP_DIR.mkdir(parents=True)
    ckpt_dir = str(FSDP_DIR / "ckpt")
    import numpy as np
    traffic = serving.SERVE_TRAFFIC
    prompts = np.random.default_rng(0).integers(       # phase 3's
        1, serving.CONFIG.vocab, size=(traffic["requests"],
                                       traffic["prompt_len"]),
        dtype=np.int32)
    # one step on 1x2 from the step-1 checkpoint: its losses need only be
    # finite (a per-layer leaf's rows are data rank 0's, tiled)
    shrink_argv = kill_argv + ["--data", "1", "--model", "2", "--steps",
                               str(FSDP_KILL_AT), "--ckpt-dir",
                               ckpt_dir + "-shrink", "--resume", "auto",
                               "--ckpt-every", "100"]
    return dict(run=run, cfg=cfg, ckpt_dir=ckpt_dir,
                rank4=(argv + ["--steps", str(run["steps"])],
                       kill_argv + mesh, ckpt_dir),
                rank2=(shrink_argv, (serving.CONFIG, serving.SERVE_ENGINE,
                                     prompts, SERVE_TP_TOKENS)))


def fsdp_phase(torch, np, plan, res, res2, l1, engine_1x2, card) -> list:
    """Phase 20's gates on the results of its work in 16b's spawn (`res`:
    each rank's `fsdp_rank4`) and in 18's 2-rank spawn (`res2`: each
    rank's `fsdp_rank2`).  `l1`: 16b's 1x1 launcher losses (the same
    seed-0 tree, batches and lr); `engine_1x2`: 18a's 1x2 engine run
    (rank 0's tokens and kernel-4 launches), the undisturbed run 20c is
    held to.  Gates: 20a every rank's losses equal, the first within
    SPMD_LOSS_TOL[0] of 16b's 1x1 first loss and the later ones within
    theirs, launches of kernels 2-4 and heap rounds a rank equal to
    `fsdp_step_formula`; 20b the kill fired and the checkpoint before it
    landed, the resumed losses equal to the uninterrupted resumed run's
    at rtol 1e-5 / atol 1e-6 (the reference test's allclose), the
    shrink's finite; 20c one drained step on every rank alike (the live
    rids in slot order requeued at the queue head, no page live), then
    every request's tokens 18a's 1x2 tokens bit for bit, through 18a's
    kernel-4 launches plus L a re-prefill.  Removes the checkpoints.
    Returns the four paths' launch counts, summed over ranks."""
    import shutil
    cfg, run, ckpt_dir = plan["cfg"], plan["run"], plan["ckpt_dir"]
    dims = (run["data"], run["model"])
    paths = []

    # 20a
    per = [r_["20a"] for r_ in res]
    losses = per[0]["losses"]
    f = per[0]["formula"]
    if any(p["losses"] != losses for p in per):
        raise AssertionError("20a: ranks disagree on the loss")
    diffs = [abs(a - b) for a, b in zip(losses, l1)]
    if not np.isfinite(losses).all() or any(
            not d <= t for d, t in zip(diffs, SPMD_LOSS_TOL)):
        raise AssertionError(f"20a: the fsdp mesh's losses {losses} are not "
                             f"16b's 1x1 losses {l1[:len(losses)]} within "
                             f"{SPMD_LOSS_TOL}")
    steps = run["steps"]
    want = {k: v * steps for k, v in f["counts"].items()}
    for r_, p in enumerate(per):
        got = {k: p["counts"][k] for k in want}
        if got != want or p["rounds"] != f["rounds"] * steps:
            raise AssertionError(f"20a: rank {r_} launched {got} in "
                                 f"{p['rounds']} heap rounds over {steps} "
                                 f"steps; the formulas give {want} in "
                                 f"{f['rounds'] * steps}")
    walls = per[0]["walls"]
    tok = run["seq_len"] * run["batch"]
    log(f"  20a {cfg.name} fsdp=True on {dims[0]}x{dims[1]}, {steps} "
        f"default-sync steps at seq {run['seq_len']} batch {run['batch']} "
        f"({per[0]['mb']} microbatches a rank): losses "
        + ", ".join(f"{x:.6f}" for x in losses) + "; |diff| vs 16b's 1x1 "
        + ", ".join(f"{d:.4g}" for d in diffs) + " (bound "
        + ", ".join(f"{t:g}" for t in SPMD_LOSS_TOL[:steps])
        + "); step wall ms (rank 0) "
        + ", ".join(f"{w * 1e3:.1f}" for w in walls)
        + f"; {tok_s_text(tok, walls)}; peak per rank GiB "
        + ", ".join(f"{p['peak'] / 2**30:.3f}" for p in per)
        + " (16b without fsdp: 6.557, PERF.md §6); per step per rank "
        f"{f['rounds']} heap rounds == 1 + S {f['S']} ({f['buckets']} sync "
        f"buckets) + mb x (7 + (5 + 3 x R {f['R']}) x L) (G {f['G']} "
        f"gathered leaves a layer), launches (flash, "
        f"dma, combine) " + ", ".join(str(f["counts"][k]) for k in (
            "flash_attention", "dma_copy", "reduce_combine"))
        + " == the formulas; host time in the rounds' syncs a step (ranks) "
        "ms " + ", ".join(f"{p['sync_s'] / steps * 1e3:.1f}" for p in per)
        + f" ({card})")
    paths.append({k: sum(p["counts"][k] for p in per)
                  for k in per[0]["counts"]})

    # 20b on 2x2
    per = [r_["20b"] for r_ in res]
    for r_, p in enumerate(per):
        if "node lost" not in p["killed"] or \
                p["latest"] != FSDP_KILL_AT - 1:
            raise AssertionError(f"20b: rank {r_}: kill {p['killed']!r}, "
                                 f"latest checkpoint {p['latest']}")
    got, ref = per[0]["-resume"]["losses"], per[0]["-ref"]["losses"]
    n_left = FSDP_KILL["steps"] - (FSDP_KILL_AT - 1)
    if len(got) != n_left or not np.isfinite(got).all() or \
            not np.allclose(got, ref, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"20b: resumed losses {got} vs the "
                             f"uninterrupted resumed run's {ref}")
    paths.append({k: sum(p["counts"][k] for p in per)
                  for k in per[0]["counts"]})
    ck = Path(ckpt_dir)
    step_dir = sorted(ck.glob("step-*"))[-1]
    ck_bytes = sum(x.stat().st_size for x in step_dir.iterdir())

    shrink = res2[0]["shrink"]["losses"]
    if len(shrink) != 1 or not np.isfinite(shrink).all():
        raise AssertionError(f"20b: the 1x2 resume's losses {shrink}")
    paths.append({k: sum(r_["shrink"]["counts"][k] for r_ in res2)
                  for k in res2[0]["shrink"]["counts"]})
    log(f"  20b the launcher on 2x2 with fsdp (seq "
        f"{FSDP_KILL['seq_len']}, batch {FSDP_KILL['batch']}), killed at "
        f"step {FSDP_KILL_AT}'s batch fetch ({per[0]['killed']!r}) after its "
        f"step-{FSDP_KILL_AT - 1} checkpoint ({ck_bytes / 2**30:.3f} GiB "
        f"on disk: the gathered tree, data rank 0's rows of each per-layer "
        f"fsdp leaf, and its f32 moments) landed: resumed losses "
        + ", ".join(f"{x:.6f}" for x in got) + " == the uninterrupted "
        "resumed run's " + ", ".join(f"{x:.6f}" for x in ref)
        + f" (rtol 1e-5, atol 1e-6); on 1x2 (the shrink) "
        + ", ".join(f"{x:.6f}" for x in shrink)
        + f", finite; walls s: kill run {per[0]['t_kill']:.1f}, resumes "
        f"{per[0]['-resume']['wall']:.1f} and {per[0]['-ref']['wall']:.1f},"
        f" shrink {res2[0]['shrink']['wall']:.1f}; 20a and 20b in 16b's "
        f"ranks {res[0]['wall']:.1f} s ({card})")
    shutil.rmtree(FSDP_DIR, ignore_errors=True)

    # 20c
    per = [r_["20c"] for r_ in res2]
    lead = per[0]
    live = lead["live"]
    for r_, p in enumerate(per):
        if len(p["faulted"]) != 1 or p["faulted"] != lead["faulted"] \
                or p["live"] != live:
            raise AssertionError(f"20c: rank {r_} drained {p['faulted']} "
                                 f"(live {p['live']}), rank 0 "
                                 f"{lead['faulted']} (live {live})")
    (fl,) = lead["faulted"]
    if fl["pe"] != 1 or not live or fl["requeued"] != live \
            or fl["queue"][:len(live)] != live or fl["pages"] != 0:
        raise AssertionError(f"20c: drain {fl}, live before it {live}")
    for p in per:
        for i, (a, b) in enumerate(zip(p["tokens"], engine_1x2["tokens"])):
            if not np.array_equal(a, b):
                raise AssertionError(f"20c: request {i} after the drain "
                                     f"{a.tolist()} != 18a's 1x2 "
                                     f"{b.tolist()}")
    want_fa = engine_1x2["flash_attention"] + cfg.n_layers * len(live)
    if any(p["counts"]["flash_attention"] != want_fa for p in per):
        raise AssertionError(f"20c: kernel-4 launches "
                             f"{[p['counts']['flash_attention'] for p in per]}"
                             f" a rank, want {want_fa}")
    if any(p["counts"]["paged_decode"] != cfg.n_layers * p["decodes"]
           for p in per):
        raise AssertionError(f"20c: kernel-8 launches "
                             f"{[p['counts']['paged_decode'] for p in per]}"
                             f" a rank, want {cfg.n_layers} x "
                             f"{[p['decodes'] for p in per]} decode steps")
    paths.append({k: sum(p["counts"][k] for p in per)
                  for k in lead["counts"]})
    log(f"  20c {cfg.name}'s engine on 1x2, PE 1 lost at the "
        f"third step's decode on both ranks: both drained alike, requeued "
        f"{fl['requeued']} (the live rids in slot order) at the queue head "
        f"{fl['queue']}, 0 pages live; every request's tokens == 18a's 1x2 "
        f"tokens bit for bit; kernel 4 {want_fa} a rank (18a's "
        f"{engine_1x2['flash_attention']} + {cfg.n_layers} x {len(live)} "
        f"re-prefills); {lead['steps']} engine steps, {lead['rounds']} heap "
        f"rounds a rank, {lead['wall']:.3f} s, TTFT p50 "
        f"{pct(lead['ttft'], 50) * 1e3:.2f} ms, per-token p50 "
        f"{pct(lead['gaps'], 50) * 1e3:.3f} ms; the shrink and 20c in 18's "
        f"2-rank spawn {res2[0]['wall']:.1f} s ({card})")
    return paths


# ---------------------------------------------------------------------------
# phase 21: the pod axis and pipeline parallelism
# ---------------------------------------------------------------------------
# 21a runs the train launcher's loop with --pod 2 --data 1 --model 2 at
# 16b's seq_len, batch and lr from 16b's shards (each rank fits the 1x1
# seed-0 tree itself): the batch splits over (pod, data) as over `data`
# at 2x2, the data allreduce has one PE and the pod allreduce runs 16b's
# data allreduce's algorithm over 2 PEs, so its losses are 16b's default
# losses bit for bit and its launches and heap rounds a step a rank
# 16b's.  21b runs qwen2-0.5b's 24 layers as a GPipe of two 12-layer
# stages over `pod` at tp 2 (`parallel/pipeline.py`) on a batch of 4 x
# 512 in 2 microbatches (3 ticks), forward and backward, from the same
# tree cut by stage, and the unpipelined loss and gradient of the same
# tree and batch on 2x2 (`tests/test_pipeline.py`'s `fn`).  No spawn of
# its own: it follows phase 20's work in 16b's 4 warm ranks, each run
# on the mesh it makes (`launch.mesh.make_mesh`).

POD_TRAIN_STEPS = 2
PIPE_RUN = dict(batch=4, seq_len=512, n_micro=2, pod=2, model=2)
# 21b's gradient gate, the CPU test's (`tests/test_torch_pipeline.py`):
# a stage's layer leaf against the sum over the data ranks of the 2x2
# gradient of the same layer
PIPE_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def pipe_step_formula(n_layers, n_micro, stages) -> dict:
    """21b's launches and heap rounds a rank for one pipelined forward +
    backward under remat="full" at tp 2, T = n_micro + P - 1 ticks of Ls
    = L/P layers.  A tick's forward: the embedding's allreduce over
    `model`, 2 a layer, sharded_xent's 3, the put over `pod` (5 + 2Ls
    rounds); its backward: each layer's 2 again in the recompute and 1,
    the xent's and the embedding's 3, the put's (4 + 3Ls; the last
    tick's put has none: its output is unread); the loss's and the
    count's allreduces over `pod`, 1 of them again in the backward: T(9
    + 5Ls) + 2.  Kernel 2 twice a round but once in a put's (a stage
    only sends or only receives): 2 rounds - (2T - 1).  Kernel 3 one a
    forward allreduce round and one a recompute's: T(4 + 3Ls) + 2.
    Kernel 4 twice a layer a tick.  Measured on the CPU against the
    port's code with counting wrappers at Ls 1 and 2, n_micro 1, 2, 4."""
    T, Ls = n_micro + stages - 1, n_layers // stages
    rounds = T * (9 + 5 * Ls) + 2
    return dict(rounds=rounds, tick=9 + 5 * Ls, ticks=T,
                counts=dict(flash_attention=2 * Ls * T, put_copy=0,
                            dma_copy=2 * rounds - (2 * T - 1),
                            reduce_combine=T * (4 + 3 * Ls) + 2,
                            fused_update=0, ssd_scan=0, ring_attention=0,
                            paged_decode=0))


def unpipe_formula(n_layers) -> dict:
    """The unpipelined loss's forward + backward on 2x2 a rank (remat
    full): the embedding's 1, 2 a layer, the xent's 3 and the mean over
    `data` in the forward; 3 a layer, the xent's 2, the embedding's and
    the mean's in the backward: 9 + 5L rounds, kernel 2 twice each,
    kernel 3 5 + 3L, kernel 4 2L.  Measured as `pipe_step_formula`."""
    rounds = 9 + 5 * n_layers
    return dict(rounds=rounds, counts=dict(
        flash_attention=2 * n_layers, put_copy=0, dma_copy=2 * rounds,
        reduce_combine=5 + 3 * n_layers, fused_update=0, ssd_scan=0,
        ring_attention=0, paged_decode=0))


def pod_train_rank(argv):
    """21a, one rank: the launcher's loop on `argv` (--pod 2 --data 1
    --model 2) from 16b's shards, in place; its losses, walls, launches,
    heap rounds and their host time, peak."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import spmd
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    rt = spmd.current()
    args = train_mod.parse_args(argv)
    mesh = make_mesh(args.data, args.model, args.pod)
    own = seed0_shards(torch, get_config(args.arch), mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                                    # the path starts
    r0, s0 = rt.rounds, rt.sync_s
    res = train_mod.train_loop(args, shards=own)
    torch.cuda.synchronize()
    out = dict(losses=res.losses, walls=res.step_s, counts=_counts(),
               rounds=rt.rounds - r0, sync_s=rt.sync_s - s0,
               peak=torch.cuda.max_memory_allocated(),
               mesh=tuple(mesh.shape))
    del res, own
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _value_and_grad(torch, fn, params):
    from repro_torch.core.heap import tree_flatten, tree_unflatten
    leaves, treedef = tree_flatten(params)
    req = [t.detach().requires_grad_() for t in leaves]
    with torch.enable_grad():
        loss = fn(tree_unflatten(treedef, req))
        grads = torch.autograd.grad(loss, req, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def pipe_rank(arch, run):
    """21b, one rank: the pipelined loss and gradient of its stage on
    (pod 2, data 1, model 2), then the unpipelined loss and gradient of
    the same tree and batch on 2x2, each with its wall, launches, heap
    rounds and peak; then (not counted: a comparison) the 2x2 layer
    gradients summed over `data`, this stage's layers held to the
    pipelined ones at PIPE_GRAD_TOL."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import spmd
    from repro_torch.core.heap import tree_flatten
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.parallel import pipeline, sharding
    from repro_torch.parallel.comm import AxisSpec, Comm
    rt = spmd.current()
    cfg = get_config(arch)
    mesh = make_mesh(1, run["model"], run["pod"])
    shards = seed0_shards(torch, cfg, mesh)
    batch = SyntheticLM(cfg.vocab, run["seq_len"], run["batch"]).batch(0)
    stage = mesh.coords["pod"]
    out = {"stage": stage}

    def timed(key, fn, params, m):
        torch.cuda.synchronize()
        rt.barrier()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()                                # the path starts
        r0, s0 = rt.rounds, rt.sync_s
        t0 = time.perf_counter()
        loss, grads = _value_and_grad(torch, fn, params)
        torch.cuda.synchronize()
        out[key] = dict(loss=float(loss), wall=time.perf_counter() - t0,
                        counts=_counts(), rounds=rt.rounds - r0,
                        sync_s=rt.sync_s - s0,
                        peak=torch.cuda.max_memory_allocated(),
                        abs_sum=float(sum(g.double().abs().sum()
                                          for g in tree_flatten(grads)[0])),
                        mesh=tuple(m.shape))
        return grads

    tb = {k: torch.as_tensor(v, device="cuda").long()
          for k, v in batch.items()}
    comm = Comm(AxisSpec(pod="pod"))
    pp = timed("pp", lambda p: pipeline.pipeline_train_loss(
        comm, cfg, p, tb, n_micro=run["n_micro"]),
        sharding.pipeline_stage(shards, stage, run["pod"]), mesh)
    mesh2 = make_mesh(2, run["model"])
    comm2 = Comm(AxisSpec())
    lb = {k: torch.as_tensor(v, device="cuda").long()
          for k, v in build.local_batch(cfg, batch, mesh2).items()}

    def unpipelined(p):
        loss = transformer.train_loss(comm2, cfg, p, lb)
        return comm2.allreduce(loss, "data") / comm2.axis_size("data")

    unpp = timed("unpp", unpipelined, shards, mesh2)
    del shards
    gc.collect()
    torch.cuda.empty_cache()
    # the comparison: every rank allreduces every layer (the collectives
    # must match on all ranks), then holds its own stage's layers
    per = cfg.n_layers // run["pod"]
    worst, n_leaves, ok = 0.0, 0, True
    for li in range(cfg.n_layers):
        leaves = tree_flatten(unpp["layers"][li])[0]
        flat = comm2.allreduce(torch.cat([g.reshape(-1) for g in leaves]),
                               "data")
        if li // per != stage:
            continue
        got = torch.cat([g.reshape(-1) for g in
                         tree_flatten(pp["layers"][li - stage * per])[0]])
        d = (got - flat).abs()
        worst = max(worst, float(d.max()))
        ok &= bool((d <= PIPE_GRAD_TOL["atol"]
                    + PIPE_GRAD_TOL["rtol"] * flat.abs()).all())
        ok &= bool(torch.isfinite(got).all())
        n_leaves += len(leaves)
    out["grad_check"] = dict(max_abs_diff=worst, leaves=n_leaves, ok=ok)
    del pp, unpp
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pod_rank4(train_argv, arch, pipe_run):
    """Phase 21's work in a rank of 16b's spawn, after phase 20's: 21a,
    then 21b; with its wall."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = {"21a": pod_train_rank(train_argv),
           "21b": pipe_rank(arch, pipe_run)}
    return dict(out, wall=time.perf_counter() - t0)


def pod_plan(serving) -> dict:
    """Phase 21's arguments for 16b's ranks (`mesh_train`'s `extra`)."""
    run = dict(SPMD_TRAIN, lr=serving.TRAIN_RUN["lr"])
    argv = ["--arch", serving.CONFIG.name, "--seq-len", str(run["seq_len"]),
            "--batch", str(run["batch"]), "--lr", str(run["lr"]),
            "--device", "cuda", "--pod", "2", "--data", "1", "--model",
            str(run["model"]), "--steps", str(POD_TRAIN_STEPS)]
    return dict(run=run, pipe=PIPE_RUN,
                rank4=(argv, serving.CONFIG.name, PIPE_RUN))


def pod_phase(torch, np, cfg, plan, res, default16b, card) -> list:
    """Phase 21's gates on each rank's `pod_rank4` result (`res`) and
    16b's default-sync results a rank (`default16b`: losses, launches,
    heap rounds over SPMD_TRAIN's steps).  21a: every rank's losses
    equal, and 16b's first POD_TRAIN_STEPS losses bit for bit; launches
    of kernels 2-4 and heap rounds a step a rank equal to 16b's.  21b:
    every rank's pipelined loss equal, within 1e-4 x max(1, |ref|) of the
    unpipelined 2x2 loss (the reference test's bound); every rank's
    gradient finite with sum |g| > 0; each stage's layer leaves within
    PIPE_GRAD_TOL of the 2x2 gradients summed over `data`; launches and
    heap rounds a rank equal to `pipe_step_formula` and
    `unpipe_formula`.  Returns the three runs' launch counts, summed
    over the ranks."""
    paths = []
    run = plan["run"]
    # 21a
    per = [r_["21a"] for r_ in res]
    losses = per[0]["losses"]
    want = default16b[0]["losses"][:POD_TRAIN_STEPS]
    if any(p["losses"] != losses for p in per) or losses != want:
        raise AssertionError(f"21a: the losses on {per[0]['mesh']} "
                             f"{[p['losses'] for p in per]} are not 16b's "
                             f"default-sync losses {want} bit for bit")
    keys = ("flash_attention", "dma_copy", "reduce_combine")
    s16 = run["steps"]
    for r_, (p, d) in enumerate(zip(per, default16b)):
        a = {k: p["counts"][k] / POD_TRAIN_STEPS for k in keys}
        b = {k: d["counts"][k] / s16 for k in keys}
        if a != b or p["rounds"] / POD_TRAIN_STEPS != d["rounds"] / s16:
            raise AssertionError(
                f"21a: rank {r_} a step: launches {a}, heap rounds "
                f"{p['rounds'] / POD_TRAIN_STEPS}; 16b's {b}, "
                f"{d['rounds'] / s16}")
    walls = per[0]["walls"]
    log(f"  21a the launcher at --pod 2 --data 1 --model 2 "
        f"({'x'.join(map(str, per[0]['mesh']))} ranks), "
        f"{POD_TRAIN_STEPS} steps at seq {run['seq_len']} batch "
        f"{run['batch']}: losses " + ", ".join(repr(x) for x in losses)
        + " == 16b's default-sync losses bit for bit; a step a rank "
        + ", ".join(f"{k} {per[0]['counts'][k] / POD_TRAIN_STEPS:g}"
                    for k in keys)
        + f", heap rounds {per[0]['rounds'] / POD_TRAIN_STEPS:g} (16b: "
        + ", ".join(f"{default16b[0]['counts'][k] / s16:g}" for k in keys)
        + f", {default16b[0]['rounds'] / s16:g}); step wall ms (rank 0) "
        + ", ".join(f"{w * 1e3:.1f}" for w in walls)
        + "; host time in the rounds' syncs a step (ranks) ms "
        + ", ".join(f"{p['sync_s'] / POD_TRAIN_STEPS * 1e3:.1f}"
                    for p in per)
        + "; peak per rank GiB "
        + ", ".join(f"{p['peak'] / 2**30:.3f}" for p in per) + f" ({card})")
    paths.append({k: sum(p["counts"][k] for p in per)
                  for k in per[0]["counts"]})

    # 21b
    per = [r_["21b"] for r_ in res]
    pp = [p["pp"] for p in per]
    unpp = [p["unpp"] for p in per]
    loss = pp[0]["loss"]
    ref = sum(u["loss"] for u in unpp) / len(unpp)
    if any(p["loss"] != loss for p in pp) or \
            any(u["loss"] != unpp[0]["loss"] for u in unpp):
        raise AssertionError(f"21b: ranks disagree on the loss: pipelined "
                             f"{[p['loss'] for p in pp]}, unpipelined "
                             f"{[u['loss'] for u in unpp]}")
    if not abs(loss - ref) < 1e-4 * max(1.0, abs(ref)):
        raise AssertionError(f"21b: the pipelined loss {loss!r} is not the "
                             f"unpipelined 2x2 loss {ref!r} within 1e-4 x "
                             f"max(1, |ref|)")
    for r_, p in enumerate(pp):
        if not (np.isfinite(p["abs_sum"]) and p["abs_sum"] > 0):
            raise AssertionError(f"21b: rank {r_}'s gradient sum |g| "
                                 f"{p['abs_sum']}")
    gc_ = [p["grad_check"] for p in per]
    if not all(g["ok"] for g in gc_):
        raise AssertionError(f"21b: a stage's layer gradient is not the 2x2 "
                             f"gradient summed over data within "
                             f"{PIPE_GRAD_TOL}: {gc_}")
    pr = plan["pipe"]
    f = pipe_step_formula(cfg.n_layers, pr["n_micro"], pr["pod"])
    u = unpipe_formula(cfg.n_layers)
    for name, runs, form in (("pipelined", pp, f), ("unpipelined", unpp, u)):
        for r_, p in enumerate(runs):
            got = {k: p["counts"][k] for k in form["counts"]}
            if got != form["counts"] or p["rounds"] != form["rounds"]:
                raise AssertionError(f"21b: {name} rank {r_} launched {got} "
                                     f"in {p['rounds']} heap rounds; the "
                                     f"formulas give {form['counts']} in "
                                     f"{form['rounds']}")
        paths.append({k: sum(p["counts"][k] for p in runs)
                      for k in runs[0]["counts"]})
    log(f"  21b {cfg.name}'s {cfg.n_layers} layers as a GPipe of "
        f"{pr['pod']} stages of {cfg.n_layers // pr['pod']} over pod at tp "
        f"{pr['model']}, batch {pr['batch']} x {pr['seq_len']} in "
        f"{pr['n_micro']} microbatches ({f['ticks']} ticks): loss {loss!r} "
        f"against the unpipelined 2x2 loss {ref!r}, |diff| "
        f"{abs(loss - ref):.3g} (bound {1e-4 * max(1.0, abs(ref)):.3g}); "
        f"sum |g| a rank " + ", ".join(f"{p['abs_sum']:.6g}" for p in pp)
        + f"; each stage's {gc_[0]['leaves']} layer leaves == the 2x2 "
        f"gradients summed over data within {PIPE_GRAD_TOL} (largest "
        f"|diff| " + ", ".join(f"{g['max_abs_diff']:.3g}" for g in gc_)
        + "); forward + backward wall ms (rank 0) pipelined "
        f"{pp[0]['wall'] * 1e3:.1f}, unpipelined on 2x2 "
        f"{unpp[0]['wall'] * 1e3:.1f}; heap rounds a rank {f['rounds']} == "
        f"T x (9 + 5Ls) + 2 ({f['tick']} a tick) against {u['rounds']} == "
        f"9 + 5L, their host time (ranks) ms "
        + ", ".join(f"{p['sync_s'] * 1e3:.1f}" for p in pp) + " against "
        + ", ".join(f"{p['sync_s'] * 1e3:.1f}" for p in unpp)
        + "; launches a rank (flash, dma, combine) "
        + ", ".join(str(f["counts"][k]) for k in keys) + " against "
        + ", ".join(str(u["counts"][k]) for k in keys)
        + " == the formulas; peak per rank GiB "
        + ", ".join(f"{p['peak'] / 2**30:.3f}" for p in pp) + " against "
        + ", ".join(f"{p['peak'] / 2**30:.3f}" for p in unpp) + f" ({card})")
    return paths


# ---------------------------------------------------------------------------
# phase 22: the library-collective backend, Comm(backend="xla")
# ---------------------------------------------------------------------------
# The reference's substrate switch: every collective of the model and the
# trainer runs on the paper's runtime (shmem: heap rounds through kernels
# 2 and 3) or on the vendor library (xla: here torch.distributed over
# gloo, `parallel/libcoll.py`; NCCL refuses two ranks of one card).  The
# phase spawns nothing of its own: 22a (the collectives under both
# backends) and 22b (qwen2-0.5b's steps under --comm xla) ride in 16b's
# warm ranks after phase 21's work, 22c (granite's MoE layer gate) in
# 17b's, 22d (the serve launcher at --model 2 --comm xla) in 18's 2-rank
# spawn; `xla_phase` checks them all after phase 21.

XLA_COLL_ITERS = 3          # 22a: timed calls a collective, after a warm-up
XLA_TRAIN_STEPS = 2         # 22b: launcher steps under --comm xla
# 22b: the largest |step-1 loss - 16b's default-sync step-1 loss|.  The
# two backends sum the same values over 2 PEs (a + b either way), so the
# prediction is equality; the bound stays 10x below 16b's own 2x2 gap to
# 1x1 after a step (1.16e-3), which a dropped or doubled sync exceeds
XLA_STEP1_TOL = 1e-4
# 22d: phase 3's prompts (np.random.default_rng(0), 8 x 100 tokens, as the
# launcher draws them), 8 greedy tokens each
XLA_SERVE = dict(batch=8, prompt_len=100, tokens=8)
XLA_SUM_TOL = dict(rtol=1e-4, atol=1e-5)
XLA_MOVES = ("allgather", "alltoall", "broadcast")
XLA_RUNTIME = ("put_copy", "dma_copy", "reduce_combine")


def xla_collectives_rank():
    """22a, one rank of 16b's spawn: each collective under both backends,
    on a (4,) mesh (grad_sync on 2x2, over `data`): a warm-up call, then
    XLA_COLL_ITERS timed ones (the stream synchronised and the ranks met
    at a barrier before each, the stream synchronised after); the xla
    output against the shmem one (movement bit for bit, sums within
    XLA_SUM_TOL); under xla the heap rounds, kernel 1-3 launches and
    library calls of the timed calls."""
    import torch
    from repro_torch.core import spmd
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.parallel.comm import AxisSpec, Comm
    rt = spmd.current()
    r = rt.rank
    x, x2 = _spmd_inputs(torch, 4)
    big = _spmd_bucket(torch, r)[0]
    small = x[r, :2].clone()                              # 8 B a PE
    cases = (("allreduce 8 B", lambda c: c.allreduce(small, "pe")),
             ("allreduce 64 MiB", lambda c: c.allreduce(big, "pe")),
             ("allgather", lambda c: c.allgather(x[r], "pe")),
             ("alltoall", lambda c: c.alltoall(x2[r], "pe")),
             ("broadcast", lambda c: c.broadcast(x[r], "pe", root=3)),
             ("grad_sync 2x2", lambda c: c.grad_sync(big)))
    out = {}
    for name, fn in cases:
        if name.endswith("2x2"):
            make_rank_mesh((2, 2), ("data", "model"))
            axes = AxisSpec()
        else:
            make_rank_mesh((4,), ("pe",))
            axes = AxisSpec(data="pe", model=None)
        got, res = {}, {}
        for backend in ("shmem", "xla"):
            comm = Comm(axes, backend)
            walls = []
            for i in range(1 + XLA_COLL_ITERS):
                torch.cuda.synchronize()
                rt.barrier()
                if i == 1:                          # the timed calls start
                    _reset_counts()
                    r0, c0 = rt.rounds, rt.lib_calls
                t0 = time.perf_counter()
                y = fn(comm)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            got[backend] = y
            res[backend] = dict(walls=walls[1:], counts=_counts(),
                                rounds=rt.rounds - r0,
                                lib_calls=rt.lib_calls - c0)
        a, b = got["xla"], got["shmem"]
        res["err"] = float((a.float() - b.float()).abs().max())
        res["ok"] = (torch.equal(a, b) if name in XLA_MOVES else
                     bool(torch.allclose(a, b, **XLA_SUM_TOL)))
        res["bytes"] = a.numel() * a.element_size()
        out[name] = res
        del got, a, b, y
    del big
    torch.cuda.empty_cache()
    return out


def xla_train_rank(argv):
    """22b, one rank of 16b's spawn: the launcher's loop on `argv`
    (--data 2 --model 2 --comm xla) from 16b's shards, in place; its
    losses, walls, launches, heap rounds, library calls and their host
    time, peak."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import spmd
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    rt = spmd.current()
    args = train_mod.parse_args(argv)
    mesh = make_mesh(args.data, args.model)
    own = seed0_shards(torch, get_config(args.arch), mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                                    # the path starts
    r0, c0, l0 = rt.rounds, rt.lib_calls, rt.lib_s
    res = train_mod.train_loop(args, shards=own)
    torch.cuda.synchronize()
    out = dict(losses=res.losses, walls=res.step_s, counts=_counts(),
               rounds=rt.rounds - r0, lib_calls=rt.lib_calls - c0,
               lib_s=rt.lib_s - l0, peak=torch.cuda.max_memory_allocated())
    del res, own
    gc.collect()
    torch.cuda.empty_cache()
    return out


def xla_rank4(train_argv):
    """Phase 22's work in a rank of 16b's spawn, after phase 21's: 22a,
    then 22b; with its wall."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = {"22a": xla_collectives_rank(), "22b": xla_train_rank(train_argv)}
    return dict(out, wall=time.perf_counter() - t0)


def xla_plan(serving) -> dict:
    """Phase 22's arguments for 16b's ranks (`mesh_train`'s `extra`)."""
    run = dict(SPMD_TRAIN, lr=serving.TRAIN_RUN["lr"])
    argv = ["--arch", serving.CONFIG.name, "--seq-len", str(run["seq_len"]),
            "--batch", str(run["batch"]), "--lr", str(run["lr"]),
            "--device", "cuda", "--data", str(run["data"]), "--model",
            str(run["model"]), "--steps", str(XLA_TRAIN_STEPS), "--comm",
            "xla"]
    return dict(run=run, rank4=(argv,))


def xla_serve_argv(cfg) -> list:
    """22d's serve launcher flags (the 1x1 side's; the mesh adds
    --model 2)."""
    return ["--arch", cfg.name, "--device", "cuda", "--comm", "xla",
            "--batch", str(XLA_SERVE["batch"]), "--prompt-len",
            str(XLA_SERVE["prompt_len"]), "--tokens",
            str(XLA_SERVE["tokens"])]


def xla_serve_1x1(torch, cfg) -> dict:
    """22d's 1x1 side: the serve launcher's dense-cache loop on one device
    (its seed-0 tree) at `xla_serve_argv`, with the top-2 gap and the
    largest |logit| of every row `sample_greedy` picks from."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import step as sstep
    real, seen = sstep.sample_greedy, []

    def noting(comm, logits):
        lg = logits.float()
        top = lg.topk(2, -1).values
        seen.append(((top[..., 0] - top[..., 1]).cpu().numpy(),
                     lg.abs().amax(-1).cpu().numpy()))
        return real(comm, logits)

    t0 = time.perf_counter()
    with mock.patch.object(sstep, "sample_greedy", noting):
        tokens = serve_mod.run(xla_serve_argv(cfg))
    gc.collect()
    torch.cuda.empty_cache()
    return dict(tokens=tokens, seen=seen, wall=time.perf_counter() - t0)


def xla_serve_rank(argv):
    """22d, one rank of 18's 2-rank spawn: the serve launcher's path on
    `argv` (--model 2 --comm xla) as its spawned ranks run it
    (`launch.serve._serve`), on this rank's shards of the seed-0 tree
    fitted to the mesh: whether it took the paged engine, the tokens,
    the wall, launches, heap rounds, library calls and their host
    time."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import spmd
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import convert, transformer
    rt = spmd.current()
    mesh = rt.mesh
    args = serve_mod._parser().parse_args(argv)
    cfg = dataclasses.replace(get_config(args.arch), fsdp=False)
    paged = serve_mod._paged(cfg, args)
    params = transformer.map_params(torch.clone, convert.local_shards(
        convert.fit_global(transformer.init_params(cfg, seed=0,
                                                   device="cuda"),
                           cfg, tp=mesh.sizes["model"]), cfg, mesh))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    _reset_counts()                                    # the path starts
    r0, c0, l0 = rt.rounds, rt.lib_calls, rt.lib_s
    t0 = time.perf_counter()
    tokens = serve_mod._serve(args, cfg, rt.device, paged, params, mesh)
    torch.cuda.synchronize()
    out = dict(paged=paged, tokens=tokens, wall=time.perf_counter() - t0,
               counts=_counts(), rounds=rt.rounds - r0,
               lib_calls=rt.lib_calls - c0, lib_s=rt.lib_s - l0)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _no_runtime(counts) -> bool:
    return all(counts[k] == 0 for k in XLA_RUNTIME)


def xla_phase(torch, np, cfg, plan, res, default16b, l1_16b, got,
              card) -> list:
    """Phase 22's gates.  22a (`res`: each rank's `xla_rank4`): every
    collective's xla output equal to its shmem output (movement bit for
    bit, sums within XLA_SUM_TOL) on every rank, with no heap round and
    no kernel 1-3 launch under xla; the walls of both backends.  22b:
    every rank's losses equal; step 0 within 16b's bound
    (SPMD_LOSS_TOL[0]) of the 1x1 loss, step 1 within XLA_STEP1_TOL of
    16b's default-sync step 1; no heap round and no kernel 1-3 launch;
    kernel 4 16b's launches a step a rank.  22c (`got["22c"]`): the xla
    gate's picks equal to the shmem gate's, its output and input
    gradient within EP_GATE_RTOL x the largest of the shmem gate's, no
    drop, no heap round, no kernel 1-3 launch.  22d (`got["22d"]`,
    `got["22d_1x1"]`): the launcher on the dense-cache loop (not the
    paged engine), every rank's tokens rank 0's, each request's tokens
    the 1x1 loop's up to a near tie of the 1x1 logits (phase 18's rule:
    the top-2 gap within PREFILL_LOGITS_RTOL x the largest |logit|, the
    request not compared after it), no heap round, no kernel 1-3
    launch.  Returns the xla paths' launch counts, summed over ranks."""
    paths = []
    # 22a
    per = [r_["22a"] for r_ in res]
    rows = []
    for name in per[0]:
        cs = [p[name] for p in per]
        bad = [r_ for r_, c in enumerate(cs) if not c["ok"]]
        if bad:
            raise AssertionError(f"22a {name}: the xla output differs from "
                                 f"the shmem one on ranks {bad} (max|diff| "
                                 f"{[c['err'] for c in cs]})")
        for r_, c in enumerate(cs):
            x = c["xla"]
            if x["rounds"] or not _no_runtime(x["counts"]) \
                    or not x["lib_calls"]:
                raise AssertionError(f"22a {name}: rank {r_} under xla took "
                                     f"{x['rounds']} heap rounds, "
                                     f"{x['lib_calls']} library calls, "
                                     f"launched {x['counts']}")
        walls = {b: max(min(c[b]["walls"]) for c in cs)
                 for b in ("shmem", "xla")}
        rows.append(f"{name} ({cs[0]['bytes']} B a PE) shmem "
                    f"{walls['shmem'] * 1e3:.3f} / xla "
                    f"{walls['xla'] * 1e3:.3f} ms (x"
                    f"{walls['xla'] / walls['shmem']:.2f}; max|diff| "
                    f"{max(c['err'] for c in cs):.3g}; heap rounds a shmem "
                    f"call {cs[0]['shmem']['rounds'] // XLA_COLL_ITERS}, "
                    f"library calls an xla call "
                    f"{cs[0]['xla']['lib_calls'] // XLA_COLL_ITERS})")
    paths.append({k: sum(c["xla"]["counts"][k] for p in per
                         for c in p.values())
                  for k in XLA_RUNTIME + ("flash_attention",)})
    log(f"  22a the collectives on 4 ranks (grad_sync on 2x2), each "
        f"backend's wall (best of {XLA_COLL_ITERS} after a warm-up, slowest "
        f"rank): " + "; ".join(rows) + "; xla output == shmem output on "
        f"every rank (moves bit for bit, sums within {XLA_SUM_TOL}), no "
        f"heap round and no kernel 1-3 launch under xla ({card})")

    # 22b
    per = [r_["22b"] for r_ in res]
    losses = per[0]["losses"]
    want16 = default16b[0]["losses"]
    s16 = plan["run"]["steps"]
    if any(p["losses"] != losses for p in per) or \
            not np.isfinite(losses).all():
        raise AssertionError(f"22b: the ranks' losses "
                             f"{[p['losses'] for p in per]}")
    d0, d1 = abs(losses[0] - l1_16b[0]), abs(losses[1] - want16[1])
    if not (d0 <= SPMD_LOSS_TOL[0] and d1 <= XLA_STEP1_TOL):
        raise AssertionError(f"22b: losses {losses}: step 0 {d0} from the "
                             f"1x1 loss (bound {SPMD_LOSS_TOL[0]}), step 1 "
                             f"{d1} from 16b's default sync (bound "
                             f"{XLA_STEP1_TOL})")
    for r_, (p, d) in enumerate(zip(per, default16b)):
        fa_step = d["counts"]["flash_attention"] / s16
        if p["rounds"] or not _no_runtime(p["counts"]) or \
                p["counts"]["flash_attention"] / XLA_TRAIN_STEPS != fa_step:
            raise AssertionError(f"22b: rank {r_} took {p['rounds']} heap "
                                 f"rounds, launched {p['counts']} (kernel 4 "
                                 f"a step: 16b's {fa_step:g})")
    walls = per[0]["walls"]
    log(f"  22b {cfg.name} by the launcher at --data 2 --model 2 --comm xla,"
        f" {XLA_TRAIN_STEPS} steps at seq {plan['run']['seq_len']} batch "
        f"{plan['run']['batch']} from 16b's tree: losses "
        + ", ".join(repr(x) for x in losses) + f" (1x1 step 0 "
        f"{l1_16b[0]!r}: |diff| {d0:.3g}, bound {SPMD_LOSS_TOL[0]:g}; 16b "
        f"default step 1 {want16[1]!r}: |diff| {d1:.3g}, bound "
        f"{XLA_STEP1_TOL:g}); step wall ms (rank 0) "
        + ", ".join(f"{w * 1e3:.1f}" for w in walls) + " against 16b's "
        + ", ".join(f"{w * 1e3:.1f}" for w in default16b[0]["walls"])
        + "; a step a rank: heap rounds 0 (16b "
        f"{default16b[0]['rounds'] / s16:g}), library calls "
        f"{per[0]['lib_calls'] / XLA_TRAIN_STEPS:g}, host time in them ms "
        + ", ".join(f"{p['lib_s'] / XLA_TRAIN_STEPS * 1e3:.1f}" for p in per)
        + " (16b's in its rounds' syncs "
        + ", ".join(f"{d['sync_s'] / s16 * 1e3:.1f}" for d in default16b)
        + "), kernel 4 "
        + f"{per[0]['counts']['flash_attention'] / XLA_TRAIN_STEPS:g}"
        + ", kernels 1-3 0; peak per rank GiB "
        + ", ".join(f"{p['peak'] / 2**30:.3f}" for p in per) + " (16b "
        + ", ".join(f"{d['peak'] / 2**30:.3f}" for d in default16b)
        + f") ({card})")
    paths.append({k: sum(p["counts"][k] for p in per)
                  for k in per[0]["counts"]})

    # 22c
    per = got["22c"]
    lim_o = EP_GATE_RTOL * max(p["shmem"]["out"].abs().max().item()
                               for p in per)
    lim_g = EP_GATE_RTOL * max(p["shmem"]["grad"].abs().max().item()
                               for p in per)
    worst_o = worst_g = 0.0
    exact = True
    for r_, p in enumerate(per):
        s_, x = p["shmem"], p["xla"]
        if not torch.equal(x["tope"], s_["tope"]) or not x["kept"]:
            raise AssertionError(f"22c: rank {r_}'s xla picks differ from "
                                 f"the shmem gate's (or dropped)")
        if x["rounds"] or not _no_runtime(x["counts"]) or not x["lib_calls"]:
            raise AssertionError(f"22c: rank {r_} under xla took "
                                 f"{x['rounds']} heap rounds, "
                                 f"{x['lib_calls']} library calls, launched "
                                 f"{x['counts']}")
        worst_o = max(worst_o, (x["out"] - s_["out"]).abs().max().item())
        worst_g = max(worst_g, (x["grad"] - s_["grad"]).abs().max().item())
        exact = exact and torch.equal(x["out"], s_["out"])
    if not (worst_o <= lim_o and worst_g <= lim_g):
        raise AssertionError(f"22c: the xla gate is off the shmem gate by "
                             f"{worst_o} (out, limit {lim_o}), {worst_g} "
                             f"(grad, limit {lim_g})")
    log(f"  22c granite-moe-3b-a800m's MoE layer gate on 1x4 under xla (its "
        f"alltoalls and allgather through gloo): picks == the shmem gate's "
        f"on every rank, none dropped; max|out - shmem| {worst_o:.3e} "
        f"(limit {lim_o:.3e}; output bit for bit: {exact}), max|grad - "
        f"shmem| {worst_g:.3e} (limit {lim_g:.3e}); library calls a rank "
        f"{per[0]['xla']['lib_calls']} against {per[0]['shmem']['rounds']} "
        f"heap rounds under shmem; no heap round and no kernel 1-3 launch "
        f"under xla ({card})")
    paths.append({k: sum(p["xla"]["counts"][k] for p in per)
                  for k in per[0]["xla"]["counts"]})

    # 22d
    per, one = got["22d"], got["22d_1x1"]
    P, B = XLA_SERVE["prompt_len"], XLA_SERVE["batch"]
    if any(p["paged"] for p in per):
        raise AssertionError("22d: the serve launcher at --comm xla chose "
                             "the paged engine")
    for r_, p in enumerate(per):
        if not np.array_equal(p["tokens"], per[0]["tokens"]):
            raise AssertionError(f"22d: rank {r_}'s tokens differ from rank "
                                 f"0's")
        if p["rounds"] or not _no_runtime(p["counts"]) \
                or p["counts"]["paged_decode"] or not p["lib_calls"]:
            raise AssertionError(f"22d: rank {r_} took {p['rounds']} heap "
                                 f"rounds, {p['lib_calls']} library calls, "
                                 f"launched {p['counts']}")
    toks, want = per[0]["tokens"], one["tokens"]
    if toks.shape != (B, XLA_SERVE["tokens"]) or want.shape != toks.shape:
        raise AssertionError(f"22d: tokens {toks.shape}, 1x1 {want.shape}")
    ties, upto = [], []
    for i in range(B):
        diff = np.flatnonzero(toks[i] != want[i])
        upto.append(int(diff[0]) if diff.size else None)
        if not diff.size:
            continue
        gap, big = (a[i] for a in one["seen"][P - 1 + int(diff[0])])
        lim = PREFILL_LOGITS_RTOL * float(big)
        ties.append((i, int(diff[0]), float(gap), lim))
        if not gap <= lim:
            raise AssertionError(f"22d: request {i}'s token {int(diff[0])} "
                                 f"differs from the 1x1 loop's at a top-2 "
                                 f"gap of {gap} (near-tie bound {lim})")
    n_tok, wall = toks.size, per[0]["wall"]
    log(f"  22d the serve launcher at --model 2 --comm xla on phase 3's "
        f"prompts ({B} x {P} tokens, {XLA_SERVE['tokens']} new): the "
        f"dense-cache loop, every rank's tokens == rank 0's; first token "
        f"differing from the 1x1 loop's, each request: {upto} (None: none)"
        + (f", at near ties (request, token, top-2 gap, bound) {ties}"
           if ties else "") + f"; {n_tok} tokens in {wall:.3f} s "
        f"({n_tok / wall:.1f} tok/s; the 1x1 loop {one['wall']:.3f} s, "
        f"build included), {per[0]['lib_calls']} library calls a rank "
        f"({per[0]['lib_calls'] / (P + XLA_SERVE['tokens'] - 1):g} a step), "
        f"host time in them " + ", ".join(f"{p['lib_s']:.3f}" for p in per)
        + f" s (ranks); no heap round and no kernel 1-3 launch ({card})")
    paths.append({k: sum(p["counts"][k] for p in per)
                  for k in per[0]["counts"]})
    return paths


# ---------------------------------------------------------------------------
# phase 23: the dry run against the card
# ---------------------------------------------------------------------------
# `launch/dryrun.py` traces one rank's step on the meta device; here its
# counts are held to those of the ranks 16b and 22b run on the card.

# the kernels whose launches a step of 16b and 22b the trace must equal
DRYRUN_KERNELS = ("dma_copy", "reduce_combine", "flash_attention",
                  "fused_update")
ALLOC_ROUND = 512           # the caching allocator's rounding a tensor


def dryrun_plan(torch, serving, card) -> dict:
    """23, before 16b spawns: qwen2-0.5b's train step (the launcher's:
    default sync, its parameters updated in place) traced on rank 0 of a
    2x2 meta rank (`launch.dryrun.trace_step`) at 16b's shape under
    shmem and at 22b's under xla, with the card's heap slots.  Nothing
    is spawned and the card is not touched."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import RankMesh
    run = SPMD_TRAIN
    mesh = RankMesh(("data", "model"), (run["data"], run["model"]), 0)
    batch = {k: torch.empty((run["batch"], run["seq_len"]),
                            dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    out = {}
    for comm in ("shmem", "xla"):
        t0 = time.perf_counter()
        got = dryrun.trace_step(serving.CONFIG, "train_4k", mesh, comm,
                                batch=batch)
        out[comm] = dict(got, wall=time.perf_counter() - t0)
        log(f"  23 trace of {serving.CONFIG.name}'s step on rank 0 of a "
            f"{run['data']}x{run['model']} meta rank under {comm} (batch "
            f"{run['batch']} x {run['seq_len']}): {got['heap_rounds']} heap "
            f"rounds, {got['lib_calls']} library calls, launches "
            f"{got['kernel_launches']}, memory {got['memory']}, "
            f"collectives {got['collectives']['counts']}, "
            f"{out[comm]['wall']:.1f} s of host (no card: {card})")
    return out


def dryrun_phase(plan, default16b, xla22b) -> None:
    """23: every rank of 16b's default run and of 22b took the trace's
    heap rounds, kernel 2-5 launches and library calls a step exactly;
    its parameters and optimizer state hold the trace's argument bytes
    less the batch, within the allocator's rounding a tensor; the peaks
    side by side."""
    run = SPMD_TRAIN
    batch_bytes = 2 * (run["batch"] // run["data"]) * run["seq_len"] * 4
    for comm, per, steps in (("shmem", default16b, run["steps"]),
                             ("xla", xla22b, XLA_TRAIN_STEPS)):
        want = plan[comm]
        exp = dict({k: want["kernel_launches"].get(k, 0)
                    for k in DRYRUN_KERNELS},
                   heap_rounds=want["heap_rounds"],
                   lib_calls=want["lib_calls"])
        for r, p in enumerate(per):
            got = dict({k: p["counts"][k] / steps for k in DRYRUN_KERNELS},
                       heap_rounds=p["rounds"] / steps,
                       lib_calls=p["lib_calls"] / steps)
            if got != exp:
                raise AssertionError(f"23 {comm}: rank {r} took {got} a "
                                     f"step, the dry run {exp}")
        peaks = ", ".join(f"{p['peak'] / 2**30:.3f}" for p in per)
        log(f"  23 {comm}: every rank's step took the dry run's counts "
            f"exactly: {exp}; peak a rank: dry run "
            f"{want['memory']['peak_bytes'] / 2**30:.3f} GiB (no bound), "
            f"torch.cuda.max_memory_allocated {peaks} GiB"
            + (" (16b's ranks also hold the shards they copied)"
               if comm == "shmem" else ""))
    mem = plan["shmem"]["memory"]
    want = mem["argument_bytes"] - batch_bytes
    if want != mem["alias_bytes"]:
        raise AssertionError(f"23: argument bytes less the batch {want} "
                             f"are not the donated {mem['alias_bytes']}")
    for r, p in enumerate(default16b):
        alloc, n = p["state_alloc"]
        if not 0 <= alloc - want <= ALLOC_ROUND * n:
            raise AssertionError(f"23: rank {r}'s parameters and optimizer "
                                 f"state take {alloc} B allocated, the dry "
                                 f"run {want} B ({n} tensors)")
    log(f"  23 parameters + optimizer state a rank: dry run {want} B; "
        f"memory_allocated " + ", ".join(str(p["state_alloc"][0])
                                         for p in default16b)
        + f" B ({default16b[0]['state_alloc'][1]} tensors, at most "
        f"{ALLOC_ROUND} B of rounding each)")


def main() -> int:
    try:
        import torch
    except ImportError as e:
        return fail(f"torch missing: {e}")
    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail(f"{ROOT} is not a checkout of the repository "
                    f"(no src/repro_torch)")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import deepseek_v3_671b as deepseek
    from repro_torch.configs import gemma2_9b as gemma
    from repro_torch.configs import granite_moe_3b_a800m as granite
    from repro_torch.configs import h2o_danube_3_4b as danube
    from repro_torch.configs import hubert_xlarge as hubert
    from repro_torch.configs import internlm2_20b as internlm
    from repro_torch.configs import mamba2_2_7b as mamba
    from repro_torch.configs import phi_3_vision_4_2b as phi3v
    from repro_torch.configs import qwen2_0_5b as serving
    from repro_torch.configs import zamba2_1_2b as zamba
    from repro_torch.kernels import _build, ref, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as kpd
    from repro_torch.kernels import ring_attention as ra
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.models import layers
    from repro_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 1: setup")
    card = card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc: {nvcc}")
    log(f"  card: {torch.cuda.get_device_name(0)} ({card}), "
        f"{torch.cuda.device_count()} visible")
    t = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per source
        libs = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    log(f"  built {KERNELS} in {time.perf_counter() - t:.1f} s")
    report_builds(libs)

    log("== phase 2: kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_attention(torch, ops, ref, fa, gen)
    check_attention_edges(torch, fa, ref, gen)
    torch.cuda.empty_cache()
    timing = time_attention(torch, fa, ref, gen, card)
    check_paged_decode(torch, kpd, ref, gen)
    torch.cuda.empty_cache()
    paged_timing = time_paged_decode(torch, kpd, ref, gen, card)
    torch.cuda.empty_cache()

    log(f"== phase 3: serve {serving.CONFIG.name} at full width")
    eng, prompts, launches, served = serve(torch, np, fa, serving,
                                           ServeEngine)
    prefill_logits_check(torch, np, ref, layers, eng, prompts, serving,
                         ServeEngine)
    del eng, prompts

    log("== phase 4: runtime kernels against their plain versions")
    check_runtime_kernels(torch, gen)
    rt_timing = time_runtime_kernels(torch, gen)

    log("== phase 5: the OpenSHMEM runtime on 16 PEs")
    rt_launches = runtime(torch, np)

    log(f"== phase 6: train {serving.CONFIG.name} at full width")
    check_fused_update(torch)
    bucket_launches = fused_bucket(torch, np)
    trained = train(torch, np, serving)
    same_grads_both_optimizers(torch, serving, trained)
    trained_counts, n_params = trained["counts"], trained["n_params"]
    del trained
    torch.cuda.empty_cache()
    grads_through_the_kernel(torch, np, serving, ref, layers)
    fu_timing = time_fused_update(torch, n_params)

    log(f"== phase 7: serve {mamba.CONFIG.name} at full width")
    check_ssd(torch, ops, ref, gen)
    ssd_timing = time_ssd(torch, kssd, ref, gen)
    mamba_launches = serve_mamba(torch, np, mamba, ops, ref)
    decode_loop(torch, np, mamba)

    log(f"== phase 8: ring attention over {serving.RING_RUN['n_pes']} PEs "
        f"at {serving.CONFIG.name}'s width")
    check_ring_partials(torch, ra, ref, gen)
    ring_timing = time_ring_partials(torch, ra, ref, gen, card)
    ring_launches, ring_walls = ring_path(torch, np, serving, ra, ref, ops,
                                          fa, card)

    log(f"== phase 9: serve {zamba.CONFIG.name} at full width")
    check_zamba_kernels(torch, ops, ref, fa, ra, gen)
    time_ssd(torch, kssd, ref, gen, ZAMBA_SSD_SHAPE)
    time_zamba_attention(torch, fa, ref, ra, gen, card,
                         zamba.SERVE_RUN["prefill_len"])
    zamba_launches = serve_zamba(torch, np, zamba, ops, ref, ra)
    decode_loop(torch, np, zamba)
    decode_f32_vs_prefill(torch, np, zamba)
    long_decode(torch, np, zamba)

    log(f"== phase 10: serve {gemma.CONFIG.name}, {danube.CONFIG.name} and "
        f"{internlm.CONFIG.name} at full width")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  memory allocated as phase 10 starts: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    shapes = dense_attention_shapes((gemma, danube, internlm))
    check_dense_kernels(torch, ops, ref, fa, ra, gen, shapes)
    dense_timing = [time_dense_attention(torch, fa, ref, ra, gen, card, s,
                                         gemma.SERVE_RUN["prefill_len"])
                    for s in shapes]
    params, gemma_launches = prefill_dense(torch, np, gemma, ops, ref, ra)
    f32_gate(torch, gemma, ops, ref, ra, params, GEMMA_F32_LEN)
    long_decode_dense(torch, np, gemma, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    dense_paths = [gemma_launches, launch_dense(torch, np, gemma, ref, layers,
                                                logits_check=True)]
    params, danube_launches = prefill_dense(torch, np, danube, ops, ref, ra)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    dense_paths += [danube_launches, launch_dense(torch, np, danube, ref,
                                                  layers)]
    params, internlm_launches = prefill_dense(torch, np, internlm, ops, ref,
                                              ra)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    dense_paths += [internlm_launches, launch_dense(torch, np, internlm, ref,
                                                    layers)]

    ds_cfg = dataclasses.replace(deepseek.CONFIG,
                                 n_layers=deepseek.SERVE_RUN["n_layers"])
    log(f"== phase 11: serve {granite.CONFIG.name} and {ds_cfg.name} "
        f"(cut to {ds_cfg.n_layers} of its {deepseek.CONFIG.n_layers} "
        f"layers) at full width")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  memory allocated as phase 11 starts: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    shapes = moe_attention_shapes(granite.CONFIG, ds_cfg)
    check_dense_kernels(torch, ops, ref, fa, ra, gen, shapes)
    moe_timing = [time_dense_attention(torch, fa, ref, ra, gen, card, s,
                                       granite.SERVE_RUN["prefill_len"])
                  for s in shapes]
    params, granite_launches = prefill_dense(torch, np, granite, ops, ref,
                                             ra)
    moe_f32_gate(torch, np, granite.CONFIG, granite.SERVE_RUN, ops, ref, ra,
                 params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    decode_loop(torch, np, granite)
    params, ds_launches = prefill_dense(torch, np, deepseek, ops, ref, ra,
                                        ds_cfg)
    moe_f32_gate(torch, np, ds_cfg, deepseek.SERVE_RUN, ops, ref, ra, params)
    long_decode_dense(torch, np, deepseek, params, ds_cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    decode_loop(torch, np, deepseek, ds_cfg)
    moe_paths = [granite_launches, ds_launches]

    log(f"== phase 12: serve {hubert.CONFIG.name} (an encoder) at full "
        f"width")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  memory allocated as phase 12 starts: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    hubert_shape, phi_shape = frontend_attention_shapes(hubert.CONFIG,
                                                        phi3v.CONFIG)
    check_dense_kernels(torch, ops, ref, fa, ra, gen, [hubert_shape])
    frontend_timing = [time_dense_attention(
        torch, fa, ref, ra, gen, card, hubert_shape,
        hubert.SERVE_RUN["prefill_len"])]
    params, hubert_launches = prefill_dense(torch, np, hubert, ops, ref, ra)
    f32_gate(torch, hubert, ops, ref, ra, params, AUDIO_F32_LEN)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    encoder_launcher(torch, hubert)

    log(f"== phase 13: serve {phi3v.CONFIG.name} with its frontend embeds "
        f"at full width")
    check_dense_kernels(torch, ops, ref, fa, ra, gen, [phi_shape])
    frontend_timing.append(time_dense_attention(
        torch, fa, ref, ra, gen, card, phi_shape,
        phi3v.SERVE_RUN["prefill_len"]))
    params, phi_launches = prefill_dense(torch, np, phi3v, ops, ref, ra)
    f32_gate(torch, phi3v, ops, ref, ra, params, GEMMA_F32_LEN)
    long_decode_dense(torch, np, phi3v, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phi3v_launcher = launch_dense(torch, np, phi3v, ref, layers,
                                  logits_check=True)
    frontend_paths = [hubert_launches, phi_launches, phi3v_launcher]

    log("== phase 14: the measurement services on the card (profiler, "
        "tuner, choose_attention, traced engine, launcher)")
    gc.collect()
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    service_paths = [services_profiler(torch, np, card),
                     services_tuner(torch, np, card)]
    services_attention(ring_walls)
    service_paths += [services_engine(torch, np, serving, ServeEngine,
                                      served),
                      services_launcher(torch)]
    log(f"  phase 14 wall {time.perf_counter() - t14:.1f} s ({card})")

    log("== phase 15: the elastic runtime on 16 PEs (fault injection, the "
        "PGAS checkpoint stream, kill and resume, the serving drain)")
    gc.collect()
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    elastic_paths = elastic_injector(torch, np)
    elastic_paths.append(elastic_pgas(torch, np, card))
    elastic_paths += elastic_resume(torch, np, card)
    elastic_paths.append(elastic_serve(torch, np, serving, ServeEngine,
                                       served, launches))
    log(f"  phase 15 wall {time.perf_counter() - t15:.1f} s ({card})")

    log("== phase 16: the SPMD backend (rank processes sharing the card, "
        "one symmetric heap mapped by CUDA IPC)")
    gc.collect()
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    spmd_paths = spmd_collectives(torch, np, card)
    # phase 20's work rides in the warm ranks of 16b's and 18's spawns,
    # phase 21's in 16b's after it, phase 22's in 16b's, 17b's and 18's
    plan20, plan21 = fsdp_plan(serving), pod_plan(serving)
    plan22, phase22 = xla_plan(serving), {}
    plan23 = dryrun_plan(torch, serving, card)   # phase 23's traces
    got, _, l1_16b, extra16b = mesh_train(
        torch, np, serving.CONFIG,
        dict(SPMD_TRAIN, lr=serving.TRAIN_RUN["lr"]), SPMD_LOSS_TOL, card,
        "16b", extra=(("20", "fsdp_rank4", plan20["rank4"]),
                      ("21", "pod_rank4", plan21["rank4"]),
                      ("22", "xla_rank4", plan22["rank4"])))
    fsdp4 = [r_["20"] for r_ in extra16b]
    spmd_paths += got
    log(f"  phase 16 wall {time.perf_counter() - t16:.1f} s ({card})")

    log("== phase 17: expert parallelism, and the Mamba2 and MLA layers at "
        "tp > 1 (Comm.alltoall over the ranks; granite-moe on 1x4, zamba2 "
        "on 2x2, deepseek-v3's 4-layer cut forward on 2x2)")
    gc.collect()
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    ep_paths = ep_exchange(torch)
    mb = {"granite": min(granite.CONFIG.microbatches, EP_TRAIN["batch"]),
          "zamba": max(1, min(zamba.CONFIG.microbatches,
                              EP_TRAIN["batch"] // 2))}
    ep_shapes = ep_rank_shapes(granite.CONFIG, zamba.CONFIG, ds_cfg, mb)
    ep_check_kernels(torch, ops, ref, fa, gen, ep_shapes, zamba.CONFIG)
    ep_timing = [time_dense_attention(torch, fa, ref, ra, gen, card, s[:9],
                                      EP_TRAIN["seq_len"])
                 for s in ep_shapes]
    zs = zamba.CONFIG.ssm
    time_ssd(torch, kssd, ref, gen,
             (1, EP_TRAIN["seq_len"],
              zs.expand * zamba.CONFIG.d_model // zs.head_dim // 2,
              zs.head_dim, zs.state, zs.n_groups, zs.chunk))
    fa_ranks = []
    for run_ in (lambda: ep_granite(torch, np, granite, card, phase22),
                 lambda: mesh_train(torch, np, zamba.CONFIG,
                                    dict(EP_TRAIN, lr=3e-4, data=2, model=2),
                                    EP_ZAMBA_LOSS_TOL, card, "17c")[:2],
                 lambda: ep_deepseek(torch, np, ds_cfg, card)):
        gc.collect()
        torch.cuda.empty_cache()
        got, n_fa = run_()
        ep_paths += got
        fa_ranks.append(n_fa)
    for t, n_fa in zip(ep_timing, fa_ranks):
        if t["calls"] != n_fa:
            raise AssertionError(f"17: kernel 4 at {t['shape']} launched "
                                 f"{n_fa} times a rank, want {t['calls']}")
    log(f"  phase 17 wall {time.perf_counter() - t17:.1f} s ({card})")

    log("== phase 18: serving at tp > 1 (qwen2-0.5b's paged engine on 1x2 "
        "and 1x4 ranks; one decode step of zamba2 and deepseek-v3's cut on "
        "1x2, granite-moe on 1x4)")
    gc.collect()
    torch.cuda.empty_cache()
    t18 = time.perf_counter()
    tp_timing = serve_tp_attention(torch, fa, ref, gen, card, serving)
    tp_paths, tp_fa, tp_engines, fsdp2 = serve_tp(
        torch, np, serving, served, card, fsdp_args=plan20["rank2"],
        phase22=phase22)
    for t, tp in zip(tp_timing, SERVE_TP):
        if t["calls"] != tp_fa[tp]:
            raise AssertionError(f"18: kernel 4 at {t['shape']} launched "
                                 f"{tp_fa[tp]} times over the ranks of 18a, "
                                 f"want {t['calls']}")
        t["calls"] = tp_fa[tp]                  # the measured count
    log(f"  phase 18 wall {time.perf_counter() - t18:.1f} s ({card})")

    log(f"== phase 19: sequence sharding over {SEQ_RANKS} ranks (the ring's "
        f"model path: {serving.CONFIG.name}'s layer and 24 layers; "
        f"{zamba.CONFIG.name}'s long_500k decode, seq_shards {SEQ_RANKS})")
    gc.collect()
    torch.cuda.empty_cache()
    t19 = time.perf_counter()
    seq_paths, seq_timing = seq_shard(torch, np, serving, zamba, ra, ref,
                                      ops, gen, card)
    log(f"  phase 19 wall {time.perf_counter() - t19:.1f} s ({card})")

    log(f"== phase 20: fsdp, checkpoints and the engine's drain on a rank "
        f"mesh ({serving.CONFIG.name} trained with fsdp=True on 2x2, the "
        f"launcher killed and resumed on 2x2 and on 1x2, the engine "
        f"drained on 1x2; run in 16b's and 18's ranks)")
    fsdp_paths = fsdp_phase(torch, np, plan20, fsdp4, fsdp2, l1_16b,
                            tp_engines[2], card)
    log(f"  phase 20 wall in those ranks {fsdp4[0]['wall']:.1f} + "
        f"{fsdp2[0]['wall']:.1f} s ({card})")

    log(f"== phase 21: the pod axis and pipeline parallelism "
        f"({serving.CONFIG.name} trained by the launcher at --pod 2 --data 1 "
        f"--model 2; its {serving.CONFIG.n_layers} layers as a GPipe of "
        f"{PIPE_RUN['pod']} stages over pod at tp {PIPE_RUN['model']}; run "
        f"in 16b's ranks)")
    pod_paths = pod_phase(torch, np, serving.CONFIG, plan21,
                          [r_["21"] for r_ in extra16b],
                          [r_["default"] for r_ in extra16b], card)
    log(f"  phase 21 wall in those ranks "
        f"{extra16b[0]['21']['wall']:.1f} s ({card})")

    log(f"== phase 22: the library-collective backend, Comm(backend="
        f"\"xla\") over gloo (the collectives under both backends and "
        f"{serving.CONFIG.name} trained under --comm xla, in 16b's ranks; "
        f"granite's MoE layer in 17b's; the serve launcher at --model 2 "
        f"--comm xla in 18's)")
    xla_paths = xla_phase(torch, np, serving.CONFIG, plan22,
                          [r_["22"] for r_ in extra16b],
                          [r_["default"] for r_ in extra16b], l1_16b,
                          phase22, card)
    log(f"  phase 22 wall in 16b's ranks {extra16b[0]['22']['wall']:.1f} s, "
        f"22d in 18's {phase22['22d'][0]['wall']:.1f} s ({card})")

    log(f"== phase 23: the dry run against the card ({serving.CONFIG.name}'s "
        f"step traced on a 2x2 meta rank, held to 16b's and 22b's ranks)")
    dryrun_phase(plan23, [r_["default"] for r_ in extra16b],
                 [r_["22"]["22b"] for r_ in extra16b])
    log(f"  phase 23 wall: the traces "
        f"{sum(p['wall'] for p in plan23.values()):.1f} s of host ({card})")

    # each path's counts, set to 0 just before it and read just after
    paths = [launches, rt_launches, bucket_launches] + trained_counts \
        + [mamba_launches] + ring_launches + [zamba_launches] + dense_paths \
        + moe_paths + frontend_paths + service_paths + elastic_paths \
        + spmd_paths + ep_paths + tp_paths + seq_paths + fsdp_paths \
        + pod_paths + xla_paths
    total = {name: sum(c.get(name, 0) for c in paths)
             for name in ("flash_attention", "put_copy", "dma_copy",
                          "reduce_combine", "fused_update", "ssd_scan",
                          "ring_attention", "paged_decode")}
    log(f"  launches on the main paths: serve {launches}, runtime "
        f"{rt_launches}, fused bucket {bucket_launches}, train "
        f"{trained_counts}, mamba2 prefill {mamba_launches}, ring "
        f"attention (plain SIM, NoC SIM, mono, window+softcap) "
        f"{ring_launches}, zamba2 prefill {zamba_launches}, dense family "
        f"(gemma2 prefill, launcher; danube; internlm2) {dense_paths}, moe "
        f"family (granite prefill, deepseek prefill) {moe_paths}, audio "
        f"and vlm (hubert prefill, phi-3-vision prefill, launcher) "
        f"{frontend_paths}, services (profiled 8 B collectives, tune sweep, "
        f"traced engine, launcher) {service_paths}, elastic (15a's faulted "
        f"puts, the PGAS stream, uninterrupted / victim / resumed fused "
        f"steps, the drained engine) {elastic_paths}, spmd (16a 4 and 8 "
        f"ranks, 2x2 Comm; 16b default, fused; summed over ranks) "
        f"{spmd_paths}, ep (17a the exchanges over model of 1x4, (data, "
        f"model) of 2x2, model of 1x8; 17b granite 1x4; 17c zamba2 2x2 "
        f"default, fused; 17d deepseek 2x2; summed over ranks) {ep_paths}, "
        f"tp (18a qwen2 engine 1x2, 18b zamba2 1x2, deepseek 1x2, 18a qwen2 "
        f"engine 1x4, 18b granite 1x4; summed over ranks) {tp_paths}, "
        f"seq (19a ring, 19b f32, 19b bf16, 19c bf16, 19c f32, 19a "
        f"gradient; summed over ranks) {seq_paths}, fsdp (20a qwen2 2x2, "
        f"20b 2x2 kill and resumes, 20b 1x2 shrink, 20c drained engine "
        f"1x2; summed over ranks) {fsdp_paths}, pod (21a the launcher on "
        f"2 x (1x2), 21b pipelined, 21b unpipelined 2x2; summed over "
        f"ranks) {pod_paths}, xla (22a the collectives under xla, 22b "
        f"qwen2 2x2, 22c granite's gate 1x4, 22d the serve launcher 1x2; "
        f"summed over ranks) {xla_paths}")
    rows = [("flash_attention", "src/repro_torch/kernels/csrc/"
             "flash_attention.cu", "src/repro/kernels/flash_attention.py:79",
             timing)]
    rows += [(name, source, replaces, rt_timing[name])
             for name, source, replaces in RUNTIME_KERNELS]
    rows.append(("fused_update", "src/repro_torch/kernels/csrc/"
                 "fused_update.cu", "src/repro/kernels/fused_update.py:73",
                 dict(fu_timing["full"], max_abs_err=max(
                     fu_timing["full"]["max_abs_err"],
                     fu_timing["bucket16"]["max_abs_err"]))))
    rows.append(("ring_attention", "src/repro_torch/kernels/csrc/"
                 "ring_attention.cu", "src/repro/kernels/ring_attention.py:84",
                 ring_timing))
    rows.append(("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:86", ssd_timing))
    # kernel 8 replaces no TPU kernel: the reference's paged decode is jnp
    rows.append(("paged_decode", "src/repro_torch/kernels/csrc/"
                 "paged_decode.cu", "none (repro/models/layers.py "
                 "attention_paged's decode, plain jnp)", paged_timing))
    kernels = [dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=total[name],
                    max_abs_err=t["max_abs_err"], ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"], library_ms=t["library_ms"])
               for name, source, replaces, t in rows]
    # kernel 4 at the dense, moe, audio and vlm families' prefill shapes,
    # each with the launches of that shape in its model's prefill
    kernels += [dict(name="flash_attention", route="cuda",
                     source="src/repro_torch/kernels/csrc/flash_attention.cu",
                     replaces="src/repro/kernels/flash_attention.py:79",
                     shape=t["shape"], launches=t["calls"],
                     max_abs_err=t["max_abs_err"], ms=t["ms"],
                     plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                     bound_by=t["bound_by"], library_ms=t["library_ms"])
                for t in dense_timing + moe_timing + frontend_timing
                + ep_timing + tp_timing]
    # kernel 8 at phi-3-vision-4.2b's chat decode step, with the launches
    # of phi-3-vision's heads (Hq = Hkv 32, hd 96) in phase 13's launcher
    # (its batch of 4; the timed step is the benchmark cell's batch of 64)
    kernels.append(dict(name="paged_decode", route="cuda",
                        source="src/repro_torch/kernels/csrc/paged_decode.cu",
                        replaces="none (repro/models/layers.py "
                        "attention_paged's decode, plain jnp)",
                        launches=phi3v_launcher["paged_decode"],
                        **{k: paged_timing["phi3v"][k] for k in (
                            "shape", "max_abs_err", "ms", "plain_ms",
                            "bound_ms", "bound_by", "library_ms")}))
    # kernel 6 at phase 19's per-rank shapes, each with its launches there
    kernels += [dict(name="ring_attention", route="cuda",
                     source="src/repro_torch/kernels/csrc/ring_attention.cu",
                     replaces="src/repro/kernels/ring_attention.py:84",
                     shape=t["shape"], launches=t["calls"],
                     max_abs_err=t["max_abs_err"], ms=t["ms"],
                     plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                     bound_by=t["bound_by"], library_ms=t["library_ms"])
                for t in seq_timing]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on the path")
    left = live_children()
    if left:                      # every process this run started has ended
        return fail(f"child processes still running: {left}")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
