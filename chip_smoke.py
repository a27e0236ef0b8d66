#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deepcoro_clip_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --host-only   # phase 21 alone (copy the script
                                        # into an older tree to time its host path)
    python3 chip_smoke.py --compare     # one run of an A B B A call (run_compare;
                                        # copy the script into the older tree too)
    python3 chip_smoke.py --ddp-rank <spec.json>   # one rank of phases 32 to 38, as
                                        # torch.distributed.run starts it there
    python3 chip_smoke.py --drift       # phase 32's world-1 control against world N,
                                        # reversed rows and gradient accumulation 2
    python3 chip_smoke.py --wide-rows   # the wide bf16 forward's rows and phase 42
                                        # (copy the script into an older tree too)
    python3 chip_smoke.py --wide-bwd-rows   # the wide bf16 backward's rows and
                                        # phase 43's steps (likewise)

Phases, each printing one line (or a few) before the last:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc builds csrc/flash_fwd.cu, csrc/flash_fwd_proj.cu,
   csrc/flash_bwd.cu, csrc/flash_short.cu and csrc/ring_attention.cu for
   sm_90a, side by side
   (timed, with the ptxas register and spill lines), and the registers and
   dynamic shared memory a block of the Hopper kernels: K1's, K5's, K2's
   two, K6's, and the long K3's and K4's two at Dh 64 and 128;
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   in bf16, at the serving path's shapes and in one small case of every
   other mode it takes (K1 also at ragged lengths 130 and 10 and the text
   tower's shape, each K1 case with its time and TFLOP/s);
4. serving: the retrieval server at flagship width (num_videos 10,
   max_batch 4, seeded random weights, seeded 1000 x 512 demo bank) answers
   concurrent /retrieve requests, one /embed and /stats over HTTP; the
   kernels' launch counters, zeroed just before, must show both kernels on
   that path;
5. end to end: the same studies through the kernels and through the plain
   attention, same weights; embeddings must agree to cosine >= 0.999;
6. times (CUDA events, after warm-up): dispatch latency, a profiler
   breakdown of one tower pass by kernel, each kernel at its serving
   shapes beside its plain version, its bound and
   scaled_dot_product_attention (a yardstick only; the port never calls
   it), K1 with its TFLOP/s; beside each time between CUDA events the
   time the card was busy (device events of a profiler trace), which for a
   call of microseconds is the smaller by the host's share. Every busy time
   of the script is read by device_ms: each kernel at its mean event time
   times its launches a call, so that an event the profiler drops does not
   read as a faster call; it fails when a port kernel the caller names has
   no event, or one it does not name ran;
7. backward kernels: dq, dk, dv of the CUDA backward against
   flash_bwd_plain on the card in bf16, at the train step's shapes (the
   video tower at 4 clips) and in one small case of every other mode; two
   backward launches on the same inputs must agree bit for bit. In every
   case the forward that the backward follows (the one that also writes
   the row statistics, as every forward of a train step does) is held
   against the plain forward as in phase 3; phase 10 does the same for
   the video tower's shapes at 32 clips. A profiler trace of one backward
   of K2 (the packed layouts) shows the Hopper flash_bwd_dkv_sm90_kernel
   and flash_bwd_dq_sm90_kernel ran (K4's kernels: phases 20 and 26);
8. training: the contrastive train step at
   flagship_config(multi_video=True, num_videos=4, batch_size=8,
   max_text_length=512): 8 studies x 4 clips of 16x224x224 (uint8,
   patch-major) and 8 reports of 512 tokens, seeded weights and batch,
   dropout on with a seeded generator; 3 warm-up steps, then 7 counted
   ones. The schedule is built with steps_per_epoch=1 (30 updates in all,
   3 of warm-up), so the rate is 0 only at the first step. Every loss
   finite, per step 24 K1 / 24 K2 / 2 K3 / 2 K4 launches, every trainable
   parameter moved, none NaN, the loss on the repeated batch (read with
   dropout off before and after, through make_eval_step) falls;
9. gradients end to end: one step's gradients with dropout off, same
   weights, 2 studies x 4 clips, three ways: through the kernels (bf16),
   through the plain attention (bf16) and through the plain attention in
   fp32 as the reference; per tower the kernel path's cosine to the fp32
   gradient must be within 0.005 of the plain bf16 path's and at least
   0.95, and its cosine to the plain bf16 gradient at least 0.97 (video)
   and 0.985 (text);
10. train times: step time (CUDA events and host clock), clips/s, peak
   memory, a profiler breakdown of one step, each backward kernel beside
   its plain version, its bound and the backward of
   scaled_dot_product_attention (a yardstick only);
11. fused projection and fp32 kernels: the forward with the output
   projection fused in (K5) against its plain version on the card at the
   probing step's own shapes (fused qkv [80,1569,1536] and [80,393,1536]
   with RoPE: all 80 clips of a step; the text shape [8,512,2304] with a key
   mask) and in one small case of every other mode, its gradients (dq, dk,
   dv, dwo) against the plain backward, two launches bit-equal, the
   forward's time and TFLOP/s; K3 and K4 on fp32 operands at the probing head's
   [8,8,11,64] with a mask and at a Dh-128 case, held to 1e-5 + 1e-5|plain|;
   K3 in bf16 at the AttentionPool shape (one query over 393 keys);
12. linear probing: build_probe_bundle at the full width of
   config/linear_probing/stenosis_config.yaml (probe_config() below spells
   its fields out) with fused_outproj=True: 8 studies x 10 clips (uint8,
   patch-major, some slots padded), seeded weights, batch and targets; 2
   warm-up and 5 counted train steps on the frozen backbone, one eval step.
   Per step 12 K5, 0 K1, 1 K3 and 1 K4 launches (the head's one CLS
   transformer block, fp32); every loss finite, every head parameter moved,
   no encoder parameter moved, the loss on the repeated batch (dropout off)
   falls;
13. probing end to end: the eval step's per-video embeddings and head
   outputs through K5 against the same weights with fused_outproj=False (K1
   then F.linear: 12 K1, 0 K5 launches) and against the plain attention;
14. a partially frozen step (video_freeze_ratio 0.8, 2 studies x 4 clips):
   the backward through K5 (K2 launches counted), the trainable encoder
   leaves' gradients against the plain attention by phase 9's cosine bars,
   and one train step that moves those leaves and no other encoder leaf;
15. probing times: step time, studies/s, peak memory, a profiler breakdown
   of one step; K5 at each shape (and TFLOP/s) beside K1 + F.linear, its plain version,
   its bound and scaled_dot_product_attention + F.linear (a yardstick
   only), and what the cast of wo costs; the timed K5 and plain outputs are
   held against each other once more, on these other seeded inputs;
16. ring path: joint attention over a study's 10 clips at flagship head
   width, q/k/v [2,4,15680,128] bf16 (seeded), through
   ring_attention(backend="rdma") over a mesh of 4 shards on the card
   (chunks of 3920 tokens): 16 K6 launches (one per shard per ring step),
   counted from 0 just before; K6 against its plain version
   (backend="rdma_interpret") and the "xla" ring by check_forward's bars
   and a relative L2 of 1e-2; two calls bit-equal; a profiler trace shows
   the Hopper ring_step_sm90_kernel ran. Where several cards are visible
   (and divide 15680), the ring over them is held bit-equal to the same
   number of shards on one card;
17. ring gradients at [2,4,6272,128] (4 clips): through backend="rdma"
   (K6 forward, the "xla" ring's backward) against the plain ring's, by
   phase 7's bars;
18. ring times: K6 at 1, 2 and 4 shards on the card (and over the cards,
   where there are several) beside its bound, its plain version and
   scaled_dot_product_attention over the whole unsharded q/k/v (a
   yardstick only), the same pass through ops/_ring_cuda.ring_fwd itself
   (bit-equal), the host's time to enqueue a pass per step launch (tensor
   maps included),
   and the share of the slot copies' device time that lies under a step
   kernel in a profiler trace;
19. ring train step: flagship_config(multi_video=True, num_videos=4,
   batch_size=8, max_text_length=512, use_ring_attention=True) over a mesh
   of 3 shards on the card (all 12 backbone blocks take the "xla" ring); 1
   warm-up and 3 timed steps (step time, peak memory), per step 12 K1 / 12
   K2 (text tower) / 2 K3 / 2 K4 and no K5 or K6 launch, the loss on the
   repeated batch falls, a profiler breakdown of one step, and the video
   embeddings of the same weights in eval mode against the dense kernel
   path at cosine >= 0.999;
20. short kernels (csrc/flash_short.cu, every [B, H, L, Dh] call with
   Lq, Lk <= 64): forward and backward against multi_head_attention and
   flash_bwd_plain at L in {1, 4, 10, 11, 16, 17, 64}, causal, causal with
   a mask, cross 1|64 and 37|50, RoPE at L 10, each with a fully masked
   batch row where masked, in bf16 (phase 3's and 7's bars) and fp32
   (relative L2 1e-5), at Dh 64 and 128; two backward launches and one
   batch row alone against the batch, bit for bit; the bf16 forward
   against the tile kernel flash_long_fwd_kernel by phase 3's bars (it sums
   in wgmma's order; the bit-equal cases are counted). Profiler traces: at
   the main paths' shapes a K3 forward and a K4 backward are one short
   kernel each, no mask conversion; at L = 65 the long Hopper kernels run
   (flash_long_fwd_kernel, and bwd_rows_kernel, flash_long_bwd_dkv_kernel,
   flash_long_bwd_dq_kernel). Phases 6, 10 and 15's profiles show the
   short kernels on the serving, contrastive and probing paths and no long
   kernel of K3/K4;
21. host time of a K3/K4 call, in a process of its own (--host-only): at
   [4,8,10,64] bf16 + mask (forward), [8,8,4,64] bf16 + mask and
   [8,8,11,64] fp32 + mask (forward and backward), the host's enqueue per
   call, the time between CUDA events, the card's busy time, the device
   kernels a call runs (by name), a breakdown of the host's time (checks,
   mask conversion, allocations, stream lookup, argument packing, the
   ctypes call without and with its launch, the autograd Function's
   share), and the launch floor (a one-element in-place add);
22. the contrastive training run through the port's main, at
   config/quality/flagship_quality_train.yaml (quality_train_config() below
   spells its fields out; data_filename, output_dir, epochs 2 and
   num_workers are overridden, and printed): a corpus of 48 train and 16
   val clips of 16x224x224 rendered by data/synthetic_angio.generate_corpus
   (seed 0), 2 epochs of 3 steps at batch 16 with validation (retrieval
   metrics over the deduplicated reports) after each. Every loss finite;
   the launches of the whole run, counted from 0 just before it, equal 12
   K1 / 12 K2 / 14 K3 / 14 K4 a train step (the text tower's 12 layers at
   L 128 on the long kernels, counted apart as "K3 long" and "K4 long",
   and the aggregator's 2 blocks) plus the validation's; the latest,
   best-loss and highest-alignment checkpoints with their meta keys, one of
   each; the history's keys, grad_norm_video_<block> included. Epoch 0's
   checkpoint, copied out of the run as it is written (what a run killed
   after epoch 0 leaves), resumed
   through main (resume_training, checkpoint = the copy's directory) must
   end bit-equal to the uninterrupted run (epoch-1 loss, every parameter,
   the generator state); phases 23 to 31 resume the same way. A profiler
   trace of one step shows the text tower's long kernels
   (flash_long_fwd_kernel, bwd_rows_kernel, flash_long_bwd_dkv_kernel,
   flash_long_bwd_dq_kernel) and the aggregator's short ones; K3 and K4 at
   [16,12,128,64] bf16 with that
   batch's padding mask against their plain versions (phase 3's and 7's
   bars), with times, busy times, bound and SDPA's; the step time, clips/s, the
   loader's wait a step, the validation pass and peak memory, each line
   with the card's name and power limit;
23. the multitask run through the port's main, at
   config/multitask/multitask_config.yaml (multitask_config() below spells
   its fields out; data_filename, output_dir, epochs 2 and num_workers are
   overridden, and printed): phase 22's clips grouped into studies of 2 to
   4 clips by data/synthetic_angio.write_study_manifest, 2 epochs at batch 8
   studies x 4 clips with validation (the weighted losses, greedy captions
   of every validation study with the K/V cache, BLEU, ROUGE-L, METEOR)
   after each. Every loss finite; the launches of the whole run, counted
   from 0 just before it, equal 12 K1 / 12 K2 / 22 K3 / 22 K4 a train step
   (20 of each long: the text tower's 12 layers at L 512, the decoder's 4 causal
   self-attentions at L 128 under the caption mask and 4 cross-attentions
   over 4 x 393 video tokens, the aggregator's 2 blocks) and 12 K1 / 22 K3
   a validation batch, no K5 or K6; the latest and best-loss checkpoints,
   the captions CSV of each epoch with one row a validation study, the
   caption metrics in the history. Epoch 0's checkpoint resumed through
   main ends bit-equal to the uninterrupted one. A profiler trace
   of one step shows the long kernels of K3/K4 and the aggregator's short
   ones; K3 and K4 at the text tower's [8,12,512,64] with the batch's
   padding mask, at the decoder's [8,8,128,64] causal with the batch's
   caption mask and at the cross shape [8,8,128|1572,64] against their
   plain versions (phase 3's and 7's bars), with times, busy times, bounds
   and SDPA's; the step time (the run has one step an epoch; 5 more on one
   batch are timed too), the validation pass, peak memory and the profiled
   step's busy time, each with the card's name and power limit;
24. SigLIP multi-positive pretraining through the port's main, at
   config/clip/siglip_multi_positive_config.yaml (siglip_config() below
   spells its fields out): texts/edges/videos manifests written by
   data/dataset_creation.build_siglip_manifests from the findings of phase
   22's clips (siglip_rows), then a memory reckoning (one train step at
   batch 2 and 4, the line through their peaks at the YAML's 20 and at
   SIGLIP_BATCH, which must stay within 85% of the card), and 2 epochs at
   batch_size SIGLIP_BATCH (the one cut besides data and epochs), the
   class-aware sampler, a bank of batch_size x 40 texts of 512 tokens a
   step, validation against every video's positives with the semantic
   panel. Every loss finite; the launches of the whole run, predicted per
   train step (12 K1 / 12 K2 / 13 K3 / 13 K4), per validation batch and per
   bank chunk of 64 texts, counted from 0 just before it; logit_bias moved
   from -10; checkpoints and artifacts; epoch 0's checkpoint resumed
   through main ends bit-equal; step time, peak memory, a profiled
   step's busy time and its tile K3/K4 share; K3/K4 at the bank's
   [B*40,12,512,64] with the batch's mask and the aggregator's [B,16,1,32]
   (run at Dh 64 on zero-padded operands) against their plain versions
   (phase 3's and 7's bars), with times, busy times, bounds and SDPA's;
25. multi-video SigLIP through main at config/clip/multivideo_config.yaml
   (multivideo_config()): phase 23's studies, 2 epochs at 8 studies x 5
   clip slots, the pairwise siglip loss; the same checks (12 K1 / 12 K2 /
   14 K3 / 14 K4 a train step), K3/K4 at the text tower's [8,12,512,64] and
   the aggregator's [8,8,5,64] with the batch's masks;
26. the long K3/K4 kernels at phase 24's bank (B x 40 texts of 512 tokens,
   the step's own mask): the key tiles the skip rule's mirror
   (_flash_cuda.visited_key_tiles) predicts the forward, dQ and dK/dV
   kernels visit; K3/K4 against their plain versions with times, busy
   times, bound and SDPA's at a bank whose every row is a real prompt of 2
   to 21 tokens and at one whose every key is real (nothing skipped); at
   the bank's mask the forward and dQ bit-equal to a call whose K, V and
   mask are cut to _flash_cuda.key_cut keys, dK and dV exactly 0 past the
   cut, two calls bit-equal, batch rows alone (B = 1) and in fours (B = 4)
   bit-equal to the batch; the kernels a call runs, by profiler name;
27. the linear-probing run through the port's main, at
   config/linear_probing/stenosis_config.yaml (probe_config()): phase 22's
   clips grouped into 24 train and 16 val studies of 6 to 10 clips (a clip
   serves several studies), labelled by synthetic_angio.probe_labels_for of
   each study's first clip (calcif_binary a seeded draw), the encoder from
   phase 22's last checkpoint through video_encoder_checkpoint_path (every
   backbone leaf must load), epochs 2, DEEPCORO_FUSED_OUTPROJ=1 (K5). Every
   loss finite, launches over the run 12 K5 / 1 K3 / 1 K4 a train step and
   12 K5 / 1 K3 a validation batch, no K1, K2 or K6; the backbone bit-equal
   to phase 22's after the run, every head tensor moved; epoch 0's
   checkpoint resumed through main bit-equal; run_mode val with the
   bootstrap intervals of every head; run_mode inference with the study
   embeddings through K5 and with the switch off (K1 + F.linear, cosine >=
   0.999), and at batch 2 against 8 (the largest differences printed,
   cosine >= 0.999); the step, studies/s and the loader's wait over epoch 1,
   the validation pass with its metrics (the bootstrap) apart, peak memory,
   a profiled step's busy time and share;
28. contrastive inference through the port's main, at
   config/inference/clip_retrieval_inference.yaml (clip_inference_config()):
   a text bank of the corpus' reports written from phase 22's checkpoint by
   python -m deepcoro_clip_tpu_torch.generate_embeddings (its main, in
   process; 12 long K3 a chunk of 64) and read back by serve's
   load_text_bank, a metadata CSV a bank text (a number with gaps, a string
   drawn from four), the corpus in studies of 1 to 4 clips, weights through
   init_from_checkpoint (every tensor must load). One row a study, launches
   12 K1 and 2 K3 (the aggregator) a batch; the top-k ranks equal to those
   from the plain attention's embeddings with the same weights wherever the
   neighbouring scores are more than 1e-3 apart, scores within 1e-2, each
   row's string the smallest of its tied modes; bank texts/s, studies/s,
   peak memory;
29. deployment (phase_deployment): (a) serve --checkpoint from phase 22's
   checkpoint at its config, multi-video, num_videos 10, max_batch 4, a
   1000 x 512 bank that generate_embeddings writes from the same checkpoint
   over synthetic reports: concurrent /retrieve requests, one /embed, /stats,
   12 K1 + 2 K3 a dispatch, every answer bit-equal to an InferenceEngine
   given the same tree; (b) the retrieval artifact of the same checkpoint and
   bank (serving.export_retrieval_artifact): its graph names K1's and K3's
   operators and no attention taken apart, loaded in a fresh
   RetrievalArtifact and served through serve --artifact, 12 K1 + 2 K3 a
   dispatch, top-k, scores and embeddings against the engine, swap_params
   with phase 22's epoch-0 checkpoint against that checkpoint's engine, the
   CPU refused; (c) the probing artifact of phase 27's checkpoint at
   stenosis_config.yaml with the fused projection (12 K5 + 1 fp32 K3 a
   batch) and without (12 K1 + 1 K3), its logits against the restored
   runner's inference on the same studies, predict's activations; (d)
   python -m deepcoro_clip_tpu_torch.external_validation on a CSV of phase
   27's validation clips in the documented template columns (with view,
   contrast and stent columns that drop known rows), from phase 27's
   checkpoint: one prediction a surviving study, equal to a restored runner
   on the runtime manifest; once more with the same checkpoint as the
   filter model; (e) dispatch p50/p95 of the artifact and the engine,
   export and load seconds, artifact bytes, with the card's name and power
   limit;
30. single-head SigLIP pretraining through the port's main, at
   config/clip/siglip_single_head_config.yaml (siglip_single_head_config()):
   phase 24's manifests written anew, 2 epochs at batch_size SIGLIP_BATCH
   (the cut phase 24's memory reckoning explains: the bank has its shape),
   the sharded batch order, each batch's bank from one
   SingleHeadRetrievalSampler a run (collate_single_head). Every loss
   finite; launches as phase 24's (12 K1 / 12 K2 / 13 K3 / 13 K4 a train
   step), counted over the run; logit_bias moved from -10; the semantic
   panel finite; each batch's bank (real texts, dropped, positive pairs,
   the share of W not 0, no row without a positive); step time, clips/s,
   peak memory, a profiled step's busy time and share;
31. phase 30's run with locca_enabled: true (ClipConfig's LocCa defaults:
   4 layers, d 512, 8 heads, 256 tokens, weight 0.5): launches predicted
   and counted, 12 K1 / 12 K2 / 21 K3 / 21 K4 a train step (20 of each
   long) and 12 K1 / 21 K3 a validation batch; the LocCa loss finite at
   every step, every decoder tensor moved; epoch 0's checkpoint resumed
   through main bit-equal (the sampler's state and the decoder's
   moments in the checkpoint); the decoder's K3/K4 at the step's own
   caption mask, [B,8,256,64] causal, and at [B,8,256|393,64] against
   their plain versions (phase 3's and 7's bars) with times, busy times,
   bounds and SDPA's; step time, peak memory against phase 30's, the
   profiled step's busy time and the head's share of it (the same batch
   without its caption ids);
32. data-parallel training: phase 22's config at dropout 0 on phase 22's
   corpus through `python -m torch.distributed.run --nproc_per_node N
   chip_smoke.py --ddp-rank <spec>` (each rank calls the port's main): N
   cards over NCCL where the machine shows two or more, else 2 ranks
   sharing card 0 over gloo; the same config at world 1 in this process.
   Per-step losses against world 1 (relative 1e-2) and grad_norm where the
   weights are still the same (1e-3), validation loss, alignment and
   Recall@k against world 1, parameters bit-equal across the ranks after
   each epoch (checksums), launches per rank as phase 22's per step, one
   run directory written by rank 0 alone (an audit hook on every rank),
   the checkpoint's per-rank generator states, epoch 0's checkpoint resumed
   at world N bit-equal to the uninterrupted run; step time and global
   clips/s beside world 1's, peak memory per rank, and a profiled step's
   gradient all-reduce (host time) and collectives on the card;
33. one optimizer step each of SigLIP multi-positive (global batch 4, the
   bank replicated), multitask (8 studies x 4 clips, the MVM mask handed
   over) and probing (8 x 10 clips) at full width and depth 4 (MP_DEPTH),
   dropout 0, on phase 32's ranks, over the
   same group against the world-1 step on the same global batch and
   weights: the loss (relative 1e-2), each tower's averaged gradient by
   its cosine to world 1's (phase 9's bars), launches per rank equal to
   world 1's, parameters bit-equal across the ranks after the step;
37. tensor parallelism: phase 32's config with mesh_model 2 and no ring
   through main on 2 ranks (gloo on one card; phase 32's ranks where they
   are the same, as phase 33 runs on them), each rank holding half of
   every attention's heads and MLP's hidden width, against phase 32's
   world-1 run: per-step loss and grad_norm (the bars printed before the
   run), launches of K1 to K4 per rank equal to world 1's, the replicated
   parameters bit-equal across the model group, resume bit-equal, rank 0
   alone writing, the checkpoint (the whole tree) restored at mesh_model 1
   against the mesh_model-2 model's embeddings (cosine >= 0.9999), K1/K2
   at 2 heads, K3/K4 at the text tower's 6 and the aggregator's 4 against
   their plain versions with times and bounds, step time, the model
   group's all-reduces and peak memory a rank against world 1;
38. the probing step at full width and depth 4 with DEEPCORO_FUSED_OUTPROJ
   and mesh_model 2 on phase 37's ranks against world 1: K5 at a rank's 2
   heads with its [256, 512] rows of wo against its plain version, the
   ranks' partials summed against K5 over the whole layer, K5 launches per
   rank, the head outputs against world 1's, step time, all-reduces and
   memory;
39. the attention at every precision and head width the JAX wrappers take
   (after phase 38, outside the corpus): K1/K2 in fp32 (K1 on the
   register-tiled flash_fwd_f32_regtile_kernel<128>, K2 on the register-
   tiled flash_bwd_dkv_f32_regtile_kernel<128> and
   flash_bwd_dq_f32_regtile_kernel<128>)
   at [16,1569,1536] H 4 (fused and split) and [16,393,1536], in bf16 and
   fp32 at Dh 256 (H 2) and 512 (H 1), and in bf16 at [16,1569,1536] Dh
   256 and 512 (bf16 K1, K3 and K5 at Dh 256 to 512 on the wide Hopper
   kernels flash_fwd_wide_sm90_kernel<Dh> and
   flash_fwd_proj_wide_sm90_kernel<Dh>, K2 and K4 on
   flash_bwd_dkv_wide_sm90_kernel<Dh> and flash_bwd_dq_wide_sm90_kernel<Dh>,
   the bf16 rows with busy times); K3/K4 at phase 40's fp32 calls (the
   text tower's [16,12,128,64] with a real-prefix key mask, the
   aggregator's [16,8,1,64]) and at head dims padded as the JAX wrapper
   pads (Dh 32 with RoPE, 96, 192 in bf16; 192 in fp32); K5 in fp32 at
   phase 41's [80,1569,1536] and [80,393,1536] with wo [512,512] and at Dh
   256 (H 2, 393 tokens), and in bf16 at Dh 256 at both lengths; K6 in fp32
   at [2,4,15680,128] and in bf16 at [2,4,15680,64] (the mma.sync step) and
   [2,2,15680,256] (the wide SIMT step) over 4 shards (phase 34
   also runs it across its 4 ranks through ring_fwd_rank, bit-equal to the
   one-process pass): each against its plain version (fp32: F32_ATOL /
   F32_BWD_REL bars, a short call's gradients by F32_ATOL; bf16: phases 3's
   and 7's), with times (CUDA events), bounds (fp32 at 67 TFLOP/s) and the
   library call's; fp32 K1 to K4 at Dh 64 / 128 and K5 at 128 traced by
   name on the register-tiled kernels, whose registers and shared memory
   (against the Python mirrors, _flash_cuda.regtile_smem_bytes and
   regtile_bwd_smem_bytes) it prints; the bf16 K1 at Dh 256 and 512, K3
   padded to 256 and K5 at Dh 256 and 512, and the backward of the K1 and
   K3 calls (K2, K4), traced by name on the wide Hopper kernels (one launch
   each, counted; the SIMT kernels they replaced not run), their registers
   and local (spilled) bytes as the runtime reads them, the backward's
   shared memory against _flash_cuda.wide_bwd_smem_bytes; the wide rows' q
   and k drawn WIDE_QK_SCALE times wider (a peaked
   softmax), held by a relative l2 (WIDE_L2_REL) too, and the plain
   version under a mis-paired RoPE shown to fail the bars; the K3 row's
   time split into the host's issue time, pad_head_dim's and the card's
   busy time by kernel;
40. (inside the corpus, after phase 38) config/quality/flagship_quality_train.yaml
   through main at precision fp32, one epoch of 3 steps and its validation,
   against the same run with the plain attention from the same seed, both
   at dropout 0: per-step and validation losses (FP32_RUN_LOSS_REL),
   launches per step K1 12, K2 12, K3 14, K4 14 on the fp32 kernels, the
   run's checkpoint written and read back in fp32, a traced step (busy
   share, the fp32 kernels by name, the forward's and the backward's
   shares, K2's and K4's busy time a call), step time, peak memory;
41. phase 12's probing step at precision fp32 with DEEPCORO_FUSED_OUTPROJ=1:
   12 fp32 K5 launches a step, the heads against the plain attention's
   (FP32_HEAD_ATOL + FP32_HEAD_RTOL|plain|), step time, a traced step (busy
   time, K5 by name and its share), peak memory;
42. the wide-head forward path: phase 12's probing step (probe_config(), 80
   clips, bf16) at vit_heads 2 (Dh 256) and 1 (Dh 512), each with the
   projection fused (12 wide K5 launches a step) and without (12 wide K1,
   then F.linear), counted from 0 against the prediction; the heads against
   the same bundle with the plain attention (HEAD_ATOL + HEAD_RTOL|plain|),
   step time (synchronised), a traced step's busy time and the wide
   kernel's share of it by name (the SIMT kernels it replaced not run),
   peak memory;
43. (inside the corpus, after phase 40) the wide-head training path:
   config/quality/flagship_quality_train.yaml through main at vit_heads 2
   (Dh 256) and 1 (Dh 512), one epoch of 3 steps and its validation, each
   against the same run with the plain attention from the same seed, both
   at dropout 0 and writing no checkpoint: the first step's loss within
   WIDE_RUN_FIRST_REL, the later steps' and the validation loss within
   WIDE_RUN_LOSS_REL, launches per step K1 12, K2 12 (the wide kernels), K3
   14, K4 14; at the initial weights each video-tower attention parameter's
   gradient through the kernels, and the tower's, no further from the fp32
   gradient than the plain bf16 attention's, by cosine (WIDE_GRAD_SLACK;
   the cosine to the plain bf16 gradient printed; the same check at the
   recipe's 4 heads, K2's Hopper kernels at Dh 128, as its control); a
   traced step (the wide kernels by name, no SIMT
   one; busy time and share, K1's and K2's shares, K2's busy time a call),
   step time, peak memory;
then one JSON "kernels" line (K1, K3 forward, K2, K4 backward, K5, K6, and
the long K3 and K4 kernels an entry each; K3 and K4 list their short and
long kernels and carry phase 21's rows; every kernel carries the launches
of phases 22 to 25's, 27, 28, 30 and 31's runs, of phase 29's paths, a
rank's of phases 32, 33, 35, 37 and 38 and phase 36's, K1 to K5 their
rows at a rank's shapes under tensor parallelism; K6 a rank's of phase 34
with that pass's times (K5's "launches" are phase 27's train run's), K3 and K4 their shapes; the
long entries their launches over phases 22 to 25's, 30's and 31's runs and
the bank's, their row at the SigLIP bank's mask and every long row of
phases 22 to 26 and 31; then an entry each for the SIMT routes of K1 to K6
with phase 39's rows, their launches on phase 40's fp32 run (K1 to K4),
phase 41's step (K5) and phase 39's pass (K6), K1 and K5 with phase 42's,
K1 to K4 with phase 43's, K1 to K5 with the wide kernels phase 39 traced;
then the wide bf16 backward's own entry: launches over phase 43's runs,
its [16,1569,1536] Dh 256 row, every wide backward row; phase 42's steps).

--compare runs the build, checksums of the outputs of the kernels meant to
stay bit-equal (K1, K2, K5, K6, the short K3/K4), K1's and K2's times at
the video and text towers' shapes, phase 24's train step on
one batch (step time, busy time and share, tile K3/K4 share) and K3/K4 rows
at the main paths' long shapes, against the package of the tree it lies in.

--fp32-rows runs the build, phase 39's fp32 rows of K1 (with K2), K3 at the
text tower's shape (with K4) and K5, phase 41's step and phase 40's traced
step (on a rendered corpus), against the package of the tree it lies in:
the fp32 forward's and backward's A B B A call (an older tree's SIMT kernels
by name).

--wide-rows runs the build, phase 39's bf16 rows of K1 at Dh 256 and 512
([16,393|1569,1536], the forward alone), K3 at [8,2,512,192] padded to 256
(with K4) and K5 at [80,393|1569,1536] Dh 256, and phase 42's four steps,
against the package of the tree it lies in: the wide bf16 forward's A B B A
call (an older tree's SIMT kernels by name).

--wide-bwd-rows runs the build, phase 39's bf16 rows of K1 and K2 at Dh
256 and 512 ([16,393|1569,1536], busy times) and K3 / K4 at [8,2,512,192]
padded to 256, the split of K2's [16,393,1536] Dh 256 call into the host's
issue time (flash_bwd's alone beside it) and the card's busy time, and
phase 43's step at vit_heads 2 and 1 (the gradient
cosines at the initial weights, step, busy and K2's share, on a rendered
corpus), against the package of the tree it lies in: the wide bf16
backward's A B B A call (an older tree's SIMT kernels by name).

--drift renders phase 22's corpus and runs phase 32's config at dropout 0
through main four times: world 1 (the control), world N (ddp_topology),
world 1 with each batch's rows reversed (the same loss and gradient,
summed in another order) and world 1 with gradient_accumulation_steps 2;
it prints each step's loss and grad_norm beside the control's. The
"timeline" lines of a full run give the seconds after each group of phases.

The last line is {"ok": true, "device": {...}}. Any failing phase exits
non-zero before it, as does a machine without CUDA.
"""

from __future__ import annotations

import concurrent.futures
import http.client
import inspect
import json
import math
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

# H100 SXM published dense peaks (NVIDIA data sheet) for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores, where the fp32 kernels run
PEAK_BYTES = 3.35e12

# kernel vs plain, both bf16 on the card: the outputs are rounded to bf16
# (2^-8 relative) and P is rounded to bf16 against the running max in the
# kernel but against the final max in the plain version; the sums run in
# another order. |kernel - plain| <= ATOL + RTOL * |plain| elementwise.
KERNEL_ATOL = 1e-2
KERNEL_RTOL = 1e-2
# the bf16 forwards at Dh 256 to 512 (phase 39's wide rows): q and k drawn
# WIDE_QK_SCALE times wider than the other inputs (std 1.5: q k^T / sqrt(Dh)
# has a std of 2.25, the softmax over 393 or 1569 keys is peaked and the
# output is O(0.1), not the near-uniform mean of v that 0.5-scaled q and k
# give, which the elementwise bar above is as large as); the output also by
# a relative l2 of WIDE_L2_REL, and the plain version under a mis-paired
# RoPE (each column's rotate-half partner one 64-column box off) must fail
# the two bars together
WIDE_QK_SCALE = 3.0
WIDE_L2_REL = 1e-2
# end to end, bf16 tower through the kernels vs through the plain attention
E2E_MIN_COSINE = 0.999
# timed launches per kernel (the plain version: a fifth of them)
REPS = 20

# backward kernel vs flash_bwd_plain, both bf16 on the card, per gradient
# tensor: max|kernel - plain| <= BWD_MAX_REL * max|plain| and
# ||kernel - plain|| <= BWD_L2_REL * ||plain||. Each gradient is rounded to
# bf16 on the way out (2^-9 relative per element), P and dS are rounded to
# bf16 before their products on both sides but from scores summed in
# another order, and the plain version starts from its own forward output.
BWD_MAX_REL = 2e-2
BWD_L2_REL = 1e-2
# end-to-end gradients, per tower, as cosines of the flattened gradient
# against the fp32 plain-attention gradient of the same weights and batch.
# A bf16 tower's gradient carries bf16 rounding noise through 12 layers
# whichever attention it uses (measured on seeded weights: kernels 0.9976,
# plain attention 0.9971, the two bf16 paths against each other 0.9954), so
# the kernel path is held to the plain bf16 path's own distance from fp32:
# it may fall short of it by at most GRAD_COSINE_SLACK, with a floor that a
# wrong gradient (a sign, a missing term) cannot reach.
GRAD_COSINE_SLACK = 0.005
GRAD_MIN_COSINE = 0.95
# and the two bf16 paths against each other. On the seeded weights after the
# ten training steps this reads 0.974994 (video) and 0.990895 (text) on an
# H100 with the Hopper K1 (0.977796 and 0.988398 with the mma.sync K1 before
# it: the weights after ten steps differ), the same to the last digit in
# every run (no atomics, seeded batch); the floors leave a margin of 0.005
# and 0.006 below the readings for another card or library version, and
# stand above what one wrong layer would leave.
GRAD_MIN_KERNEL_VS_PLAIN = {"video_encoder": 0.97, "text_encoder": 0.985}
TRAIN_WARMUP, TRAIN_STEPS = 3, 7

# fp32 kernels vs the plain versions in fp32: exp2 with log2(e) folded into
# the scale for exp, FMA contraction, sums in another order; nothing is
# rounded below fp32. |kernel - plain| <= F32_ATOL + F32_RTOL * |plain|.
F32_ATOL = 1e-5
F32_RTOL = 1e-5
# head outputs through K5 vs through K1 + F.linear or the plain attention,
# same weights: the heads read a 1024-wide pooled embedding whose bf16
# inputs agree to cosine >= 0.999; |d| <= HEAD_ATOL + HEAD_RTOL * |ref|
HEAD_ATOL = 5e-2
HEAD_RTOL = 5e-2
PROBE_WARMUP, PROBE_STEPS = 2, 5
# clips of one probing step (stenosis_config.yaml: batch_size 8 x num_videos
# 10), the batch the path launches K5 at and K5 is held to its plain version at
PROBE_CLIPS = 80

KERNEL_SOURCE = "deepcoro_clip_tpu_torch/csrc/flash_fwd.cu"
PROJ_SOURCE = "deepcoro_clip_tpu_torch/csrc/flash_fwd_proj.cu"
K5_REPLACES = "deepcoro_clip_tpu/ops/flash_attention_packed.py:119"
BWD_SOURCE = "deepcoro_clip_tpu_torch/csrc/flash_bwd.cu"
K1_REPLACES = "deepcoro_clip_tpu/ops/flash_attention_packed.py:63"
K2_REPLACES = "deepcoro_clip_tpu/ops/flash_attention_packed.py:210"
K3_REPLACES = "deepcoro_clip_tpu/ops/flash_attention.py:84"
K4_REPLACES = "deepcoro_clip_tpu/ops/flash_attention.py:179"
RING_SOURCE = "deepcoro_clip_tpu_torch/csrc/ring_attention.cu"
K6_REPLACES = "deepcoro_clip_tpu/parallel/ring_attention.py:88"

# the ring path (A): joint attention over a study's 10 clips of 1568 tokens
# at flagship head width, sharded 4 ways on one card (chunks of 3920 tokens);
# its gradients at 4 clips. K6 against its plain version: check_forward's
# bars, and ||kernel - plain|| <= RING_L2_REL ||plain||, since the outputs,
# means over 15680 keys, are far smaller than KERNEL_ATOL.
RING_B, RING_H, RING_DH = 2, 4, 128
RING_L, RING_GRAD_L = 10 * 1568, 4 * 1568
RING_SHARDS = 4
RING_L2_REL = 1e-2
# the ring train step (B): 3 shards divide 1569 and 393 tokens
RING_TRAIN_SHARDS = 3
RING_TRAIN_WARMUP, RING_TRAIN_STEPS = 1, 3


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# profiler windows a busy time may take (see device_ms): a run once traced
# ten empty windows in a row at phase 24's bank row; windows a trace that
# shows fewer events than launched may take (device_events)
TRACE_TRIES = 20
SHORT_TRIES = 5
# readings for which the profiler traced no device event in any window (its
# tracing dead for a stretch of a run: a run of this script once traced none
# in 20 windows of a busy time): each is "not traced", and its caller goes on
# with what the wrappers' counters and CUDA events show. Until a window traces
# again, a reading takes DEAD_TRIES windows at most.
UNTRACED: list = []
DEAD_TRIES = 2
_PROFILER_DEAD = [False]


def _windows() -> int:
    return DEAD_TRIES if _PROFILER_DEAD[0] else TRACE_TRIES


def _traced(ok: bool, fn, windows: int) -> bool:
    """Note whether the profiler traced a device event for ``fn``."""
    _PROFILER_DEAD[0] = not ok
    if not ok:
        what = getattr(fn, "__qualname__", repr(fn))
        UNTRACED.append(what)
        print(f"trace: {what}: the profiler traced no device event in {windows} windows; "
              f"not traced", flush=True)
    return ok


def share(part: float, whole: float):
    """``part / whole``, or None where the trace held no device event."""
    return part / whole if whole else None


def fmt(x, spec: str) -> str:
    return "not traced" if x is None else format(x, spec)


def device_events(torch, fn, expect=None):
    """Run ``fn`` once under torch.profiler: (device time by kernel name in
    ms, host wall time in ms including the final synchronise). A trace with
    no device event (the profiler on the H100 machine now and then records
    none) is taken again, up to TRACE_TRIES times; so is one in which the
    kernels ``expect`` names (``{name part: launches}``) show fewer events
    than they launched, up to SHORT_TRIES times (it also drops events: late
    in whole runs of this script, phase 40's fp32 forward traced 2.2 to 2.4
    ms a step in every window where a fresh process traced 10.5). A trace
    still short is returned, and said so; one with no event at all is
    returned empty, as "not traced" (``_traced``)."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    tries = 0  # windows with events
    windows = _windows()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        per_name, events = defaultdict(float), defaultdict(int)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                per_name[e.name] += e.time_range.elapsed_us() / 1e3
                events[e.name] += 1
        short = [k for k, n in (expect or {}).items()
                 if sum(c for name, c in events.items() if k in name) < n]
        tries += bool(per_name)
        if per_name and (not short or tries == SHORT_TRIES):
            break
    if not _traced(bool(per_name), fn, windows):
        return per_name, wall_ms
    if short:
        print(f"trace: {short} traced fewer events than launched in {tries} windows with events "
              f"({TRACE_TRIES} at most); the times read from it undercount", flush=True)
    return per_name, wall_ms


def device_ms(torch, fn, reps: int, kernels=()) -> float:
    """Mean time the card is busy per call of ``fn``, from a profiler trace
    of ``reps`` calls. Unlike ``cuda_ms`` it leaves out the gaps in which
    the card waits for the host, which is most of the time between CUDA
    events for a call of a few microseconds.

    ``kernels`` names (by substring) the port's kernels the call runs. On
    the H100 machine the profiler now and then traces no device event in a
    window, or drops one, which would read as a faster call. So each kernel
    counts at its mean event time times its launches a call (its events
    over the window's calls, rounded up), and the window is traced again, up
    to TRACE_TRIES times, when it is empty (then after a 0.2 s pause and with
    twice the calls, up to 16 times ``reps``: runs of this script traced ten
    empty windows in a row, of a 10 us call and of a 0.3 ms one), when one of ``kernels`` is missing, or when a
    kernel's events are not a whole number a call. The check fails when
    the last trace misses one of ``kernels`` or holds a port kernel that
    none of them names. When no window traced a device event at all, the
    time is read between CUDA events instead (``cuda_ms``: it includes the
    gaps) and said so."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    calls = reps
    windows = _windows()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = defaultdict(list)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                times[e.name].append(e.time_range.elapsed_us())
        missing = [k for k in kernels if not any(k in n for n in times)]
        if times and not missing and all(len(t) % calls == 0 for t in times.values()):
            break
        if not times:  # an empty window: the next one longer, up to 16 times,
            calls = min(2 * calls, 16 * reps)  # after a pause for the tracer
            time.sleep(0.2)
    if not _traced(bool(times), fn, windows):
        ms = cuda_ms(torch, fn, reps)
        print(f"busy time: not traced; {ms:.4f} ms a call between CUDA events instead",
              flush=True)
        return ms
    check(not missing, f"busy time: no event of {missing} in {windows} traces: "
                       f"{sorted(map(_short_name, times))}")
    stray = sorted({_short_name(n) for n in times if _short_name(n).startswith(PORT_KERNELS)
                    and not any(k in n for k in kernels)})
    check(not stray, f"busy time: port kernel(s) {stray} ran, expected {list(kernels)}")
    return sum(sum(t) / len(t) * math.ceil(len(t) / calls) for t in times.values()) / 1e3


def print_profile(label: str, what: str, per_name, wall_ms: float, top: int) -> None:
    busy = sum(per_name.values())
    if not busy:
        print(f"{label}: no device events in the trace (not measured)", flush=True)
        return
    print(f"{label}: {what}, kernels busy {busy:.2f} ms of {wall_ms:.2f} ms host wall "
          f"(busy share {busy / wall_ms:.2f}, profiler on)", flush=True)
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{label}:   {ms:8.3f} ms  {ms / busy:5.1%}  {name[:90]}", flush=True)


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS
          ) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def hopper_attrs() -> dict:
    """Registers and shared memory a block of every Hopper kernel (K1, K5,
    K2's two, K6), by key."""
    from deepcoro_clip_tpu_torch.ops._flash_cuda import hopper_kernel_attrs
    from deepcoro_clip_tpu_torch.ops._ring_cuda import step_kernel_attrs

    return {**hopper_kernel_attrs(), "K6": step_kernel_attrs()}


def kernels_run(torch, fn, expect=None) -> list:
    """The names (without namespace and arguments) of the kernels the card
    ran during one call of ``fn``, from a profiler trace (``expect``: as
    device_events')."""
    per_name, _ = device_events(torch, fn, expect)
    return sorted({_short_name(n) for n in per_name})


def check_route(torch, label: str, fn, want, not_want, untraced_ok: bool = False) -> list:
    """Hold the kernels one call of ``fn`` runs: every name in ``want`` is
    among them and none of ``not_want``; prints them with their registers
    and shared memory a block where they are Hopper kernels. A trace that
    misses a name of ``want`` is taken again; with ``untraced_ok`` (the
    caller counted the launch) one that still misses it is said so, not
    failed: the profiler drops events late in a whole run."""
    names = kernels_run(torch, fn, expect={w: 1 for w in want})
    if not names:
        print(f"{label}: not traced (the profiler traced no device event); the wrappers' "
              f"counters hold the launches", flush=True)
        return []
    attrs = {a["kernel"]: a for a in hopper_attrs().values()}
    for w in want:
        if untraced_ok and not any(w in n for n in names):
            print(f"{label}: the profiler traced no event of {w} ({names}); its launch was "
                  f"counted", flush=True)
            continue
        check(any(w in n for n in names), f"{label}: {w} did not run ({names})")
    for w in not_want:
        check(not any(w in n for n in names), f"{label}: {w} ran ({names})")
    ran = [n for n in names if any(w in n for w in want)]
    print(f"{label}: ran " + ", ".join(
        f"{n} ({attrs[n]['registers']} registers, {attrs[n]['smem_bytes']} B shared a block)"
        if n in attrs else n for n in ran), flush=True)
    return ran


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions


def kernel_cases(torch):
    """(name, kernel_fn, plain_fn, at_serving_shape, flops or None) at the
    serving shapes and small modes; K1's cases carry their FLOP count."""
    from deepcoro_clip_tpu_torch.ops.attention import multi_head_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import (
        flash_attention_packed,
    )
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    def rope(dh, T, H, W):
        t = build_rope3d_tables(dh, T, H, W, n_special=1)
        return (torch.from_numpy(t.sin).to(dev), torch.from_numpy(t.cos).to(dev))

    def packed_plain(q, k, v, H, sin=None, cos=None, kv_mask=None, causal=False):
        B, Lq, D = q.shape
        heads = [t.unflatten(2, (H, D // H)).transpose(1, 2) for t in (q, k, v)]
        out = multi_head_attention(*heads, sin=sin, cos=cos, kv_mask=kv_mask,
                                   causal=causal)
        return out.transpose(1, 2).reshape(B, Lq, D)

    cases = []
    # K1 at the serving shapes: fused qkv [B*N, L, 3D] with RoPE
    for T, HW in ((8, 14), (8, 7)):
        sin, cos = rope(128, T, HW, HW)
        L = sin.shape[0]
        qkv = randn(40, L, 3 * 512)
        q, k, v = qkv.split(512, dim=-1)
        cases.append((
            f"K1 fused qkv + RoPE [40,{L},1536]",
            lambda qkv=qkv, s=sin, c=cos: flash_attention_packed(
                qkv=qkv, num_heads=4, sin=s, cos=c),
            lambda q=q, k=k, v=v, s=sin, c=cos: packed_plain(q, k, v, 4, s, c),
            True, 4 * 40 * 4 * L * L * 128))
    # K1 at ragged lengths below a q tile and a key tile, and the text
    # tower's shape (H 6, D 768) with padded reports, one fully masked
    for T, H_, W_ in ((1, 3, 43), (1, 3, 3)):
        t = build_rope3d_tables(128, T, H_, W_, n_special=1)
        sin, cos = torch.from_numpy(t.sin).to(dev), torch.from_numpy(t.cos).to(dev)
        L = sin.shape[0]
        qkv = randn(6, L, 3 * 512)
        q, k, v = qkv.split(512, dim=-1)
        cases.append((
            f"K1 fused qkv + RoPE [6,{L},1536]",
            lambda qkv=qkv, s=sin, c=cos: flash_attention_packed(
                qkv=qkv, num_heads=4, sin=s, cos=c),
            lambda q=q, k=k, v=v, s=sin, c=cos: packed_plain(q, k, v, 4, s, c),
            False, 4 * 6 * 4 * L * L * 128))
    qkv_t = randn(8, 512, 3 * 768)
    qt, kt, vt = qkv_t.split(768, dim=-1)
    mt = torch.arange(512, device=dev)[None, :] < torch.tensor(
        [512, 300, 77, 1, 450, 512, 200, 130], device=dev)[:, None]
    mt[3] = False
    cases.append(("K1 fused qkv + kv_mask [8,512,2304] H 6 (one row fully masked)",
                  lambda: flash_attention_packed(qkv=qkv_t, num_heads=6, kv_mask=mt),
                  lambda: packed_plain(qt, kt, vt, 6, kv_mask=mt), False,
                  4 * 8 * 6 * 512 * 512 * 128))
    # K1 small modes: separate q/k/v with a key mask (one row fully masked,
    # Lq != Lk), causal
    q, k, v = randn(3, 70, 256), randn(3, 200, 256), randn(3, 200, 256)
    mask = torch.rand(3, 200, generator=g, device=dev) > 0.3
    mask[2] = False
    cases.append(("K1 q/k/v + kv_mask [3,70|200,256]",
                  lambda: flash_attention_packed(q, k, v, num_heads=2, kv_mask=mask),
                  lambda: packed_plain(q, k, v, 2, kv_mask=mask), False,
                  4 * 3 * 2 * 70 * 200 * 128))
    qc, kc, vc = randn(2, 150, 256), randn(2, 150, 256), randn(2, 150, 256)
    cases.append(("K1 causal [2,150,256]",
                  lambda: flash_attention_packed(qc, kc, vc, num_heads=2, causal=True),
                  lambda: packed_plain(qc, kc, vc, 2, causal=True), False,
                  4 * 2 * 2 * 150 * 150 * 128))
    # K3 at the serving shape: the aggregator, one study fully masked
    q3, k3, v3 = randn(4, 8, 10, 64), randn(4, 8, 10, 64), randn(4, 8, 10, 64)
    m3 = torch.zeros(4, 10, dtype=torch.bool, device=dev)
    m3[0, :7], m3[1, :10], m3[2, :1] = True, True, True  # study 3: no video
    cases.append(("K3 kv_mask [4,8,10,64] (one row fully masked)",
                  lambda: flash_attention(q3, k3, v3, kv_mask=m3),
                  lambda: multi_head_attention(q3, k3, v3, kv_mask=m3), True, None))
    # K3 small modes: cross-attention Lq != Lk with a mask, causal at Dh 128,
    # RoPE at Dh 64
    qx, kx, vx = randn(2, 3, 37, 64), randn(2, 3, 300, 64), randn(2, 3, 300, 64)
    mx = torch.rand(2, 300, generator=g, device=dev) > 0.5
    cases.append(("K3 cross + kv_mask [2,3,37|300,64]",
                  lambda: flash_attention(qx, kx, vx, kv_mask=mx),
                  lambda: multi_head_attention(qx, kx, vx, kv_mask=mx), False, None))
    qc3, kc3, vc3 = randn(2, 2, 130, 128), randn(2, 2, 130, 128), randn(2, 2, 130, 128)
    cases.append(("K3 causal [2,2,130,128]",
                  lambda: flash_attention(qc3, kc3, vc3, causal=True),
                  lambda: multi_head_attention(qc3, kc3, vc3, causal=True), False, None))
    s64, c64 = rope(64, 2, 7, 7)
    qr, kr, vr = (randn(2, 3, s64.shape[0], 64) for _ in range(3))
    cases.append(("K3 RoPE [2,3,99,64]",
                  lambda: flash_attention(qr, kr, vr, sin=s64, cos=c64),
                  lambda: multi_head_attention(qr, kr, vr, sin=s64, cos=c64), False, None))
    return cases


def check_forward(torch, label: str, name: str, out, ref) -> float:
    """Hold a forward kernel's output against the plain version's; returns
    max|kernel - plain|."""
    d = (out.float() - ref.float()).abs()
    tol = KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()
    err = float(d.max())
    ok = bool(torch.isfinite(out).all()) and bool((d <= tol).all())
    print(f"{label} {name}: max|kernel-plain| {err:.3e} "
          f"(tol {KERNEL_ATOL}+{KERNEL_RTOL}|plain|) {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, f"kernel {name} disagrees with its plain version")
    return err


def misrotated(x, sin, cos):
    """``x`` ([..., L, Dh]) under RoPE with each column's rotate-half
    partner one 64-column box off: what a wide kernel that paired the
    wrong boxes would compute (the sensitivity check of ``check_wide``)."""
    import torch

    h = x.shape[-1] // 2
    r = torch.cat([-x[..., h:].roll(64, -1), x[..., :h].roll(-64, -1)], dim=-1)
    return x * cos.to(x.dtype) + r * sin.to(x.dtype)


def check_wide(torch, label: str, name: str, out, ref, wrong=None) -> float:
    """A wide bf16 forward against its plain version: ``check_forward``'s
    elementwise bar and a relative l2 of WIDE_L2_REL; ``wrong``, the plain
    version under a mis-paired RoPE (``misrotated``), must fail them
    together. Returns max|kernel - plain|."""
    err = check_forward(torch, label, name, out, ref)
    l2 = _rel_l2(out, ref)
    check(l2 <= WIDE_L2_REL and math.isfinite(l2),
          f"kernel {name}: rel l2 {l2:.3e} against its plain version, bar {WIDE_L2_REL}")
    seen = ""
    if wrong is not None:
        d = (wrong.float() - ref.float()).abs()
        w_elem = bool((d <= KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()).all())
        w_l2 = _rel_l2(wrong, ref)
        check(not (w_elem and w_l2 <= WIDE_L2_REL),
              f"{name}: the plain version under a mis-paired RoPE passes the bars")
        seen = (f"; a mis-paired RoPE: max|d| {float(d.max()):.3e} "
                f"({'passes' if w_elem else 'fails'} the elementwise bar), rel l2 {w_l2:.3e} "
                f"({'passes' if w_l2 <= WIDE_L2_REL else 'fails'})")
    print(f"{label} {name}: rel l2 {l2:.3e} (bar {WIDE_L2_REL}; q, k at {WIDE_QK_SCALE}x)"
          f"{seen} ok", flush=True)
    return err


def phase_kernels(torch) -> dict:
    errs = {"K1": 0.0, "K3": 0.0}
    for name, kern, plain, at_serving_shape, flops in kernel_cases(torch):
        out = kern()
        torch.cuda.synchronize()
        err = check_forward(torch, "kernel check", name, out, plain())
        if flops:  # K1 on the Hopper kernel: a time beside the check
            ms = cuda_ms(torch, kern, 5)
            print(f"kernel check {name}: {ms:.4f} ms between CUDA events, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
        if at_serving_shape:
            key = name[:2]
            errs[key] = max(errs[key], err)
    return errs


# --------------------------------------------------------------------------- #
# phase 4: the retrieval server over HTTP


def _post(port, path, payload):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    c.request("POST", path, json.dumps(payload), {"Content-Type": "application/json"})
    r = c.getresponse()
    return r.status, json.loads(r.read())


def _get(port, path):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    c.request("GET", path)
    r = c.getresponse()
    return r.status, json.loads(r.read())


def phase_serving(torch, tmp: Path):
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import (
        flash_attention_packed,
    )
    from deepcoro_clip_tpu_torch.serve import build_server, parse_args

    args = parse_args(["--port", "0", "--max_batch", "4", "--num_videos", "10",
                       "--top_k", "5", "--demo_bank", "1000", "--device", "cuda"])
    t0 = time.perf_counter()
    httpd, engine = build_server(args)
    study, mask = engine.load_study([])
    engine.infer_batch(study[None], mask[None])  # warm the kernels
    print(f"serving: engine built and warmed in {time.perf_counter() - t0:.1f} s "
          f"(flagship, num_videos {engine.num_videos}, max_batch {engine.max_batch})",
          flush=True)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        r = np.random.default_rng(0)
        paths = []
        for i in range(6):
            p = tmp / f"clip{i}.npy"
            np.save(p, r.integers(0, 256, size=(32, 256, 256, 3), dtype=np.uint8))
            paths.append(str(p))
        port = httpd.server_address[1]
        requests = [("/retrieve", paths[: 1 + i % 6]) for i in range(8)]
        requests.append(("/embed", paths[:3]))

        flash_attention_packed.launches = 0
        flash_attention.launches = 0
        b0 = httpd.batcher.stats["batches"]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(requests)) as ex:
            futs = [ex.submit(_post, port, path, {"videos": v}) for path, v in requests]
            results = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        k1, k3 = flash_attention_packed.launches, flash_attention.launches
        code, stats = _get(port, "/stats")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    for (path, v), (code_i, out) in zip(requests, results):
        check(code_i == 200, f"{path} answered {code_i}: {out}")
        if path == "/retrieve":
            check(len(out["topk"]) == 5, f"top-k of length {len(out['topk'])}")
            scores = [t["score"] for t in out["topk"]]
            check(all(math.isfinite(s) for s in scores), f"scores {scores}")
            check(scores == sorted(scores, reverse=True), "top-k not sorted")
            check(out["n_clips"] == len(v), f"n_clips {out['n_clips']} != {len(v)}")
        else:
            emb = np.asarray(out["embedding"])
            check(emb.shape == (512,) and np.isfinite(emb).all(), "bad embedding")
            check(abs(np.linalg.norm(emb) - 1.0) < 1e-3, "embedding not unit norm")
    check(code == 200, f"/stats answered {code}")
    batches = stats["batches"] - b0
    print(f"serving: {len(requests)} concurrent requests (8 /retrieve, 1 /embed) "
          f"all 200 in {wall:.2f} s, {batches} dispatches, "
          f"avg occupancy {stats['avg_occupancy']}, dispatch p50 "
          f"{stats['dispatch_p50_ms']} ms (host clock)", flush=True)
    print(f"serving: launches K1 {k1} (12 per dispatch), K3 {k3} (2 per dispatch)",
          flush=True)
    check(batches >= 1, "no dispatch ran")
    check(k1 == 12 * batches, f"K1 launched {k1} times in {batches} dispatches")
    check(k3 == 2 * batches, f"K3 launched {k3} times in {batches} dispatches")
    return engine, paths, {"K1": k1, "K3": k3}


# --------------------------------------------------------------------------- #
# phase 5: end to end against the plain attention


def phase_e2e(torch, engine, paths):
    import dataclasses

    from deepcoro_clip_tpu_torch.models.video_encoder import video_encoder_from_config

    cfg_plain = dataclasses.replace(engine.cfg, use_pallas_attention=False)
    plain = video_encoder_from_config(cfg_plain)
    plain.load_state_dict(engine.model.state_dict())
    plain = plain.eval().to(engine.device)

    studies, masks = zip(*(engine.load_study(paths[:n]) for n in (6, 1, 3, 2)))
    x = torch.from_numpy(np.stack(studies)).to(engine.device)
    m = torch.from_numpy(np.stack(masks)).to(engine.device)
    with torch.inference_mode():
        a = engine.model(x, video_mask=m).float()
        b = plain(x, video_mask=m).float()
    check(bool(torch.isfinite(a).all()), "non-finite kernel-path embeddings")
    cos = torch.nn.functional.cosine_similarity(a, b, dim=1)
    dmax = float((a - b).abs().max())
    print(f"end to end: 4 studies through the kernels vs the plain attention: "
          f"max|d| {dmax:.3e}, min cosine {float(cos.min()):.6f} "
          f"(bar >= {E2E_MIN_COSINE})", flush=True)
    check(float(cos.min()) >= E2E_MIN_COSINE, "end-to-end cosine below the bar")
    del plain
    torch.cuda.empty_cache()
    return x, m


# --------------------------------------------------------------------------- #
# phase 6: times


def phase_profile(torch, engine, x, m) -> None:
    """Device time of one tower pass by kernel name (torch.profiler)."""
    with torch.inference_mode():
        per_name, wall_ms = device_events(torch, lambda: engine.model(x, video_mask=m))
    print_profile("profile", "one tower pass", per_name, wall_ms, top=8)
    check_main_path_kernels("profile, the aggregator's K3", per_name,
                            ("flash_short_fwd_bf16_kernel",), ("flash_long_fwd_kernel",))


def phase_times(torch, engine, x, m, errs, launches):
    import torch.nn.functional as F

    from deepcoro_clip_tpu_torch.ops.attention import apply_rope, multi_head_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import (
        flash_attention_packed,
    )
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    # dispatch latency: a full batch of 4 studies, host clock, ends in a copy
    studies, masks = x.cpu().numpy(), m.cpu().numpy()
    for _ in range(2):
        engine.infer_batch(studies, masks)
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        engine.infer_batch(studies, masks)
        lat.append((time.perf_counter() - t0) * 1e3)
    with torch.inference_mode():
        dev_ms = cuda_ms(torch, lambda: engine.model(x, video_mask=m), 5)
    print(f"times: dispatch at max_batch 4 (40 clips): host p50 "
          f"{float(np.median(lat)):.2f} ms, min {min(lat):.2f} ms; tower device "
          f"time {dev_ms:.2f} ms", flush=True)

    phase_profile(torch, engine, x, m)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def timed(kern, plain, library, flops, nbytes, kernels):
        b_ms, b_by = bound(flops, nbytes)
        return {"ms": cuda_ms(torch, kern, REPS),
                "plain_ms": cuda_ms(torch, plain, REPS // 5),
                "library_ms": cuda_ms(torch, library, REPS),
                "bound_ms": b_ms, "bound_by": b_by,
                "device_ms": device_ms(torch, kern, REPS, kernels),
                "library_device_ms": device_ms(torch, library, REPS)}

    k1_shapes = []
    for T, HW in ((8, 14), (8, 7)):
        t = build_rope3d_tables(128, T, HW, HW, n_special=1)
        sin, cos = torch.from_numpy(t.sin).to(dev), torch.from_numpy(t.cos).to(dev)
        L = sin.shape[0]
        B, H, Dh, D = 40, 4, 128, 512
        qkv = torch.randn(B, L, 3 * D, generator=g, device=dev).to(torch.bfloat16)
        heads = [u.unflatten(2, (H, Dh)).transpose(1, 2) for u in qkv.split(D, -1)]
        qr, kr = apply_rope(heads[0], sin, cos), apply_rope(heads[1], sin, cos)
        flops = 4 * B * H * L * L * Dh
        nbytes = B * L * 3 * D * 2 + B * L * D * 2 + 2 * L * Dh * 4
        row = timed(
            lambda: flash_attention_packed(qkv=qkv, num_heads=H, sin=sin, cos=cos),
            lambda: multi_head_attention(*heads, sin=sin, cos=cos),
            # yardstick: SDPA on pre-rotated q/k (RoPE not included)
            lambda: F.scaled_dot_product_attention(qr, kr, heads[2]),
            flops, nbytes, ("flash_fwd_sm90_kernel",))
        row["shape"] = f"qkv [{B},{L},{3 * D}] bf16, H {H}, Dh {Dh}, RoPE"
        row["tflops"] = flops / row["ms"] / 1e9
        k1_shapes.append(row)
        del qkv, heads, qr, kr

    B, H, L, Dh = 4, 8, 10, 64
    q3, k3, v3 = (torch.randn(B, H, L, Dh, generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(3))
    m3 = torch.ones(B, L, dtype=torch.bool, device=dev)
    m3[1, 4:], m3[3] = False, False
    k3_row = timed(lambda: flash_attention(q3, k3, v3, kv_mask=m3),
               lambda: multi_head_attention(q3, k3, v3, kv_mask=m3),
               lambda: F.scaled_dot_product_attention(
                   q3, k3, v3, attn_mask=m3[:, None, None, :]),
               4 * B * H * L * L * Dh, 4 * B * H * L * Dh * 2 + B * L,
               ("flash_short_fwd_bf16_kernel",))
    k3_row["shape"] = "q/k/v [4,8,10,64] bf16, kv_mask [4,10]"

    for name, rows in (("K1", k1_shapes), ("K3", [k3_row])):
        for r in rows:
            rate = f" ({r['tflops']:.1f} TFLOP/s)" if "tflops" in r else ""
            print(f"times: {name} {r['shape']}: kernel {r['ms']:.4f} ms{rate}, plain "
                  f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}); card busy: kernel "
                  f"{r['device_ms']:.4f} ms, sdpa {r['library_device_ms']:.4f} ms",
                  flush=True)

    def entry(name, replaces, key, rows):
        head = rows[0]
        e = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
             "replaces": replaces, "launches": launches[key],
             "max_abs_err": errs[key]}
        e.update({k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "device_ms")})
        e["shapes"] = rows
        return e

    entries = [
        entry("flash_attention_packed (K1 forward)", K1_REPLACES, "K1", k1_shapes),
        entry("flash_attention (K3 forward)", K3_REPLACES, "K3", [k3_row]),
    ]
    return {"kernels": entries}


# --------------------------------------------------------------------------- #
# phase 7: backward kernels against flash_bwd_plain


def _to_heads(t, H):
    return t.unflatten(2, (H, t.shape[2] // H)).transpose(1, 2)


def bwd_cases(torch):
    """(name, key or None, run) with run() -> (kernel grads, plain grads,
    kernel forward output, plain forward output): the gradients as lists of
    [B, H, L, Dh] tensors, the outputs as [B, H, L, Dh]. The kernel output
    is the one the backward follows: it carries a grad_fn, so its forward
    also wrote the row statistics."""
    from deepcoro_clip_tpu_torch.ops.attention import (
        flash_bwd_plain,
        multi_head_attention,
    )
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import (
        flash_attention_packed,
    )
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    def rope(dh, T, H, W):
        t = build_rope3d_tables(dh, T, H, W, n_special=1)
        return dict(sin=torch.from_numpy(t.sin).to(dev),
                    cos=torch.from_numpy(t.cos).to(dev))

    def plain(qh, kh, vh, doh, **kw):
        out = multi_head_attention(qh, kh, vh, **kw)
        return list(flash_bwd_plain(qh, kh, vh, doh, out, **kw)), out

    def twice(out, leaves, do):
        check(out.grad_fn is not None, "the wrapper's output carries no grad_fn")
        a = torch.autograd.grad(out, leaves, do, retain_graph=True)
        b = torch.autograd.grad(out, leaves, do)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              "two backward launches on the same inputs differ")
        return a

    def fused(B, L, H, Dh, kw):
        D = H * Dh
        qkv, do = randn(B, L, 3 * D), randn(B, L, D)

        def run():
            leaf = qkv.clone().requires_grad_()
            out = flash_attention_packed(qkv=leaf, num_heads=H, **kw)
            (dqkv,) = twice(out, [leaf], do)
            heads = [_to_heads(t, H) for t in qkv.split(D, -1)]
            ref, ref_out = plain(*heads, _to_heads(do, H), **kw)
            return ([_to_heads(t, H) for t in dqkv.split(D, -1)], ref,
                    _to_heads(out.detach(), H), ref_out)
        return run

    def packed(B, Lq, Lk, H, Dh, kw):
        D = H * Dh
        q, k, v, do = randn(B, Lq, D), randn(B, Lk, D), randn(B, Lk, D), randn(B, Lq, D)

        def run():
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = flash_attention_packed(*leaves, num_heads=H, **kw)
            got = twice(out, leaves, do)
            ref, ref_out = plain(*[_to_heads(t, H) for t in (q, k, v)],
                                 _to_heads(do, H), **kw)
            return ([_to_heads(t, H) for t in got], ref,
                    _to_heads(out.detach(), H), ref_out)
        return run

    def heads(B, H, Lq, Lk, Dh, kw):
        q, k, v = randn(B, H, Lq, Dh), randn(B, H, Lk, Dh), randn(B, H, Lk, Dh)
        # the output gradient arrives through a transpose, as the aggregator's does
        do = randn(B, Lq, H, Dh).transpose(1, 2)

        def run():
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = flash_attention(*leaves, **kw)
            ref, ref_out = plain(q, k, v, do, **kw)
            return list(twice(out, leaves, do)), ref, out.detach(), ref_out
        return run

    cases = []
    # K2 at the train step's shapes: the video tower (4 clips here, 32 in the
    # step) with fused qkv and RoPE, the text tower with its key mask
    for T, HW in ((8, 14), (8, 7)):
        kw = rope(128, T, HW, HW)
        L = kw["sin"].shape[0]
        cases.append((f"K2 fused qkv + RoPE [4,{L},1536]", "K2", fused(4, L, 4, 128, kw)))
    tmask = torch.ones(8, 512, dtype=torch.bool, device=dev)
    tmask[1, 300:], tmask[5, 77:] = False, False
    cases.append(("K2 q/k/v + kv_mask [8,512,768] H 6", "K2",
                  packed(8, 512, 512, 6, 128, dict(kv_mask=tmask))))
    # K4 at the train step's shape: the aggregator over 4 videos
    amask = torch.ones(8, 4, dtype=torch.bool, device=dev)
    amask[2, 3:], amask[6, 1:] = False, False
    cases.append(("K4 kv_mask [8,8,4,64]", "K4", heads(8, 8, 4, 4, 64, dict(kv_mask=amask))))
    # every other mode, small: mask with one fully masked row and Lq != Lk,
    # causal, K4 with RoPE at Dh 64, K4 causal at Dh 128
    m = torch.rand(3, 200, generator=g, device=dev) > 0.3
    m[2] = False
    cases.append(("K2 q/k/v + kv_mask [3,70|200,256] (one row fully masked)", None,
                  packed(3, 70, 200, 2, 128, dict(kv_mask=m))))
    cases.append(("K2 causal [2,150,256]", None,
                  packed(2, 150, 150, 2, 128, dict(causal=True))))
    kw64 = rope(64, 2, 7, 7)
    cases.append(("K4 RoPE [2,3,99,64]", None,
                  heads(2, 3, kw64["sin"].shape[0], kw64["sin"].shape[0], 64, kw64)))
    cases.append(("K4 causal [2,2,130,128]", None,
                  heads(2, 2, 130, 130, 128, dict(causal=True))))
    return cases


def _rel_check(name: str, which: str, a, r) -> float:
    """The backward bars for one gradient tensor (BWD_MAX_REL, BWD_L2_REL);
    returns max|kernel - plain|. An all-zero plain gradient (no valid key)
    must be met exactly."""
    import torch

    a, r = a.float(), r.float()
    err, top = float((a - r).abs().max()), float(r.abs().max())
    l2 = float(torch.linalg.vector_norm(a - r) / torch.linalg.vector_norm(r).clamp_min(1e-30))
    ok = (bool(torch.isfinite(a).all()) and err <= BWD_MAX_REL * top
          and (l2 <= BWD_L2_REL or top == 0.0))
    check(ok, f"{name}: {which} disagrees with the plain version (max|d| {err:.3e} vs "
              f"max|plain| {top:.3e}, rel l2 {l2:.3e})")
    return err


def phase_bwd_kernels(torch) -> dict:
    """Returns max|kernel - plain| at the train step's shapes: of the
    gradients under K2 and K4, of the forward outputs under K1 and K3."""
    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0}
    forward_of = {"K2": "K1", "K4": "K3"}
    for name, key, run in bwd_cases(torch):
        got, ref, out, ref_out = run()
        torch.cuda.synchronize()
        fwd_err = check_forward(torch, "backward check, its forward (row statistics "
                                "written):", name.replace("K2", "K1").replace("K4", "K3"),
                                out, ref_out)
        worst = max(_rel_check(f"backward kernel {name}", which, a, r)
                    for which, a, r in zip(("dq", "dk", "dv"), got, ref))
        print(f"backward check {name}: max|kernel-plain| {worst:.3e} over dq, dk, dv "
              f"(bars: {BWD_MAX_REL} of max|plain|, rel l2 {BWD_L2_REL}); two launches "
              f"bit-equal ok", flush=True)
        if key:
            errs[key] = max(errs[key], worst)
            errs[forward_of[key]] = max(errs[forward_of[key]], fwd_err)
    return errs


def bwd_routes(torch) -> list:
    """K2 (the packed layouts) runs the Hopper backward kernels: the kernels
    of one backward, from a profiler trace (K4's are phase 20's)."""
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import (
        flash_attention_packed,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    qkv = torch.randn(4, 393, 3 * 512, generator=g, device=dev).to(torch.bfloat16)
    leaf = qkv.clone().requires_grad_()
    out = flash_attention_packed(qkv=leaf, num_heads=4)
    return check_route(torch, "backward kernels, K2 [4,393,1536]",
                       lambda: torch.autograd.grad(out, leaf, out.detach(), retain_graph=True),
                       ("flash_bwd_dkv_sm90_kernel", "flash_bwd_dq_sm90_kernel"),
                       ("flash_long_bwd",))


# --------------------------------------------------------------------------- #
# phase 8: the contrastive train step at flagship width


def train_config(**over):
    from deepcoro_clip_tpu_torch.flagship import flagship_config

    return flagship_config(multi_video=True, num_videos=4, batch_size=8,
                           max_text_length=512, **over)


def train_batch(cfg, studies: int):
    from deepcoro_clip_tpu_torch.data.patch_wire import patchify_videos

    r = np.random.default_rng(0)
    videos = r.integers(0, 255, size=(studies, cfg.num_videos, cfg.frames, cfg.resize,
                                      cfg.resize, 3), dtype=np.uint8)
    return {
        "videos": patchify_videos(videos, tuple(cfg.vit_patch)),
        "video_mask": np.ones((studies, cfg.num_videos), bool),
        "input_ids": r.integers(0, cfg.text_vocab_size,
                                size=(studies, cfg.max_text_length)).astype(np.int32),
        "attention_mask": np.ones((studies, cfg.max_text_length), np.int32),
    }


def _kernel_counts():
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention as k3
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import (
        flash_attention_packed as k1,
    )

    from deepcoro_clip_tpu_torch.parallel import ring_attention as k6

    return {"K1": k1.launches, "K2": k1.bwd_launches,
            "K3": k3.launches, "K4": k3.bwd_launches, "K5": k1.proj_launches,
            "K6": k6.launches}


def _zero_kernel_counts():
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention as k3
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import (
        flash_attention_packed as k1,
    )

    from deepcoro_clip_tpu_torch.parallel import ring_attention as k6

    k1.launches = k1.bwd_launches = k3.launches = k3.bwd_launches = 0
    k1.proj_launches = k6.launches = 0
    k3.long_launches = k3.long_bwd_launches = 0


def _long_counts():
    """The K3 and K4 launches that ran the long Hopper kernels (bf16, Lq or
    Lk above 64), counted on the wrapper apart from the short ones."""
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention as k3

    return {"K3 long": getattr(k3, "long_launches", 0),
            "K4 long": getattr(k3, "long_bwd_launches", 0)}


def phase_training(torch):
    from deepcoro_clip_tpu_torch.train.clip import (
        build_clip_bundle,
        make_eval_step,
        make_train_step,
        to_device_batch,
    )

    cfg = train_config()
    t0 = time.perf_counter()
    bundle, state = build_clip_bundle(cfg, seed=0, steps_per_epoch=1)
    step_fn = make_train_step(bundle)
    batch = to_device_batch(bundle, train_batch(cfg, cfg.batch_size))
    gen = torch.Generator(device=bundle.device).manual_seed(0)
    n_params = sum(p.numel() for p in state.params.values())
    print(f"training: bundle built in {time.perf_counter() - t0:.1f} s: "
          f"{n_params / 1e6:.1f} M parameters, {cfg.batch_size} studies x "
          f"{cfg.num_videos} clips of {cfg.frames}x{cfg.resize}x{cfg.resize}, "
          f"{cfg.max_text_length} tokens, dropout {cfg.dropout}, {cfg.optimizer}, "
          f"{cfg.scheduler_name} (steps_per_epoch 1: 30 updates, 3 of warm-up)",
          flush=True)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    eval_fn = make_eval_step(bundle)  # dropout off: the loss without mask noise
    eval_before = float(eval_fn(state.params, batch)["loss"])
    torch.cuda.reset_peak_memory_stats()

    losses, lrs = [], []
    for _ in range(TRAIN_WARMUP):
        state, m = step_fn(state, batch, gen, 0.0, 0.0, -1.0)
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    _zero_kernel_counts()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    metrics = []
    for _ in range(TRAIN_STEPS):
        state, m = step_fn(state, batch, gen, 0.0, 0.0, -1.0)
        metrics.append(m)  # read after the loop: no host wait inside it
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    dev_ms = start.elapsed_time(end) / TRAIN_STEPS
    counts = _kernel_counts()
    losses += [float(m["loss"]) for m in metrics]
    lrs += [float(m["lr"]) for m in metrics]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    eval_after = float(eval_fn(state.params, batch)["loss"])
    last = metrics[-1]

    print("training: losses " + " ".join(f"{x:.4f}" for x in losses), flush=True)
    print("training: lr " + " ".join(f"{x:.2e}" for x in lrs), flush=True)
    print(f"training: last step grad_norm {float(last['grad_norm']):.3f} (video "
          f"{float(last['grad_norm_video_encoder']):.3f}, text "
          f"{float(last['grad_norm_text_encoder']):.3f}), temperature "
          f"{float(last['temperature']):.5f}, alignment {float(last['alignment']):.4f}",
          flush=True)
    print(f"training: launches over {TRAIN_STEPS} steps: K1 {counts['K1']}, K2 "
          f"{counts['K2']}, K3 {counts['K3']}, K4 {counts['K4']} (per step 24/24/2/2)",
          flush=True)
    clips = cfg.batch_size * cfg.num_videos
    print(f"training: step {dev_ms:.1f} ms (CUDA events), {host_ms:.1f} ms (host clock), "
          f"{clips / dev_ms * 1e3:.1f} clips/s, peak memory {peak_gb:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)", flush=True)

    check(all(math.isfinite(x) for x in losses), f"non-finite loss in {losses}")
    for key, per_step in (("K1", 24), ("K2", 24), ("K3", 2), ("K4", 2)):
        check(counts[key] == per_step * TRAIN_STEPS,
              f"{key} launched {counts[key]} times in {TRAIN_STEPS} steps, "
              f"expected {per_step} per step")
    check(state.step == TRAIN_WARMUP + TRAIN_STEPS, f"step count {state.step}")
    stuck = [k for k, v in state.params.items()
             if k != "logit_bias" and torch.equal(v, before[k])]
    bad = [k for k, v in state.params.items() if not bool(torch.isfinite(v).all())]
    check(not bad, f"non-finite parameters after training: {bad[:5]}")
    # logit_bias is in the tree for the SigLIP losses; clip_loss does not read it
    check(not stuck, f"parameters that did not move: {stuck[:5]}")
    check(math.isfinite(eval_after) and eval_after < eval_before,
          f"the loss on the repeated batch did not fall: {eval_before} -> {eval_after}")
    print(f"training: all {len(state.params) - 1} trainable tensors moved, none NaN; loss "
          f"on the repeated batch with dropout off {eval_before:.4f} -> {eval_after:.4f} "
          f"(train-mode mean of the first 3 steps {sum(losses[:3]) / 3:.4f}, of the "
          f"last 3 {sum(losses[-3:]) / 3:.4f})", flush=True)
    del before
    times = {"step_ms": dev_ms, "step_host_ms": host_ms, "peak_gib": peak_gb}
    return bundle, state, step_fn, batch, gen, counts, times


# --------------------------------------------------------------------------- #
# phase 9: gradients end to end against the plain attention


def phase_grad_e2e(torch, bundle):
    import dataclasses

    from deepcoro_clip_tpu_torch.train.clip import (
        build_clip_bundle,
        compute_loss,
        to_device_batch,
    )

    def with_weights(**over):
        b, _ = build_clip_bundle(dataclasses.replace(bundle.config, **over), seed=0,
                                 steps_per_epoch=1)
        b.video_model.load_state_dict(bundle.video_model.state_dict())
        b.text_model.load_state_dict(bundle.text_model.state_dict())
        return b

    batch = to_device_batch(bundle, train_batch(bundle.config, 2))

    def grads(b):
        models = {"video_encoder": b.video_model, "text_encoder": b.text_model}
        log_temp = torch.tensor(math.log(b.config.temperature), device=b.device)
        out = compute_loss(b, log_temp, batch, deterministic=True)
        leaves = [p for m in models.values() for p in m.parameters()]
        got = torch.autograd.grad(out["loss"], leaves)
        flat, i = {}, 0
        for name, m in models.items():
            n = len(list(m.parameters()))
            flat[name] = torch.cat([g.flatten().double() for g in got[i:i + n]])
            i += n
        return float(out["loss"].detach()), flat

    def cosine(a, b):
        return float(torch.dot(a, b) / (torch.linalg.vector_norm(a)
                                        * torch.linalg.vector_norm(b)))

    _zero_kernel_counts()
    loss_k, gk = grads(bundle)
    counts = _kernel_counts()
    check(counts["K2"] == 24 and counts["K4"] == 2, f"kernel path launched {counts}")
    loss_p, gp = grads(with_weights(use_pallas_attention=False))
    loss_f, gf = grads(with_weights(use_pallas_attention=False, precision="fp32"))
    check(_kernel_counts() == counts, "a plain-attention bundle launched a kernel")
    check(counts["K5"] == 0 and counts["K6"] == 0,
          "the contrastive step launched the fused projection or the ring")
    print(f"gradients end to end: loss through the kernels {loss_k:.5f}, plain bf16 "
          f"{loss_p:.5f}, plain fp32 {loss_f:.5f}", flush=True)
    for tower in gk:
        kf, pf, kp = (cosine(gk[tower], gf[tower]), cosine(gp[tower], gf[tower]),
                      cosine(gk[tower], gp[tower]))
        print(f"gradients end to end: {tower}: cosine to the fp32 gradient: kernels "
              f"{kf:.6f}, plain bf16 {pf:.6f} (bar: kernels >= plain - "
              f"{GRAD_COSINE_SLACK} and >= {GRAD_MIN_COSINE}); kernels vs plain bf16 "
              f"{kp:.6f} (bar >= {GRAD_MIN_KERNEL_VS_PLAIN[tower]})", flush=True)
        check(bool(torch.isfinite(gk[tower]).all()), f"non-finite {tower} gradients")
        check(kf >= pf - GRAD_COSINE_SLACK and kf >= GRAD_MIN_COSINE,
              f"{tower}: the kernel path's gradient is further from fp32 ({kf}) than "
              f"the plain bf16 path's ({pf})")
        check(kp >= GRAD_MIN_KERNEL_VS_PLAIN[tower],
              f"{tower}: cosine of the kernel path's gradient to the plain bf16 "
              f"path's {kp} below {GRAD_MIN_KERNEL_VS_PLAIN[tower]}")
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# phase 10: train times


def phase_train_profile(torch, state, step_fn, batch, gen) -> None:
    per_name, wall_ms = device_events(
        torch, lambda: step_fn(state, batch, gen, 0.0, 0.0, -1.0))
    print_profile("train profile", "one step", per_name, wall_ms, top=14)
    check_main_path_kernels("train profile, the aggregator's K3 and K4", per_name,
                            ("flash_short_fwd_bf16_kernel", "flash_short_bwd_bf16_kernel"),
                            ("flash_long_",))


def phase_train_times(torch, errs, counts, routes):
    import torch.nn.functional as F

    from deepcoro_clip_tpu_torch.ops.attention import (
        apply_rope,
        flash_bwd_plain,
        multi_head_attention,
    )
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import (
        flash_attention_packed,
    )
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    def timed(out, leaves, do, plain, sdpa_out, sdpa_leaves, sdpa_do, flops, nbytes,
              kernels):
        b_ms, b_by = bound(flops, nbytes)
        return {
            "ms": cuda_ms(torch, lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True), REPS),
            "plain_ms": cuda_ms(torch, plain, max(1, REPS // 5)),
            "library_ms": cuda_ms(torch, lambda: torch.autograd.grad(
                sdpa_out, sdpa_leaves, sdpa_do, retain_graph=True), REPS),
            "bound_ms": b_ms, "bound_by": b_by,
            "device_ms": device_ms(torch, lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True), REPS, kernels),
            "library_device_ms": device_ms(torch, lambda: torch.autograd.grad(
                sdpa_out, sdpa_leaves, sdpa_do, retain_graph=True), REPS)}

    rows_k2 = []
    # K2, video tower: fused qkv with RoPE at 32 clips
    for T, HW in ((8, 14), (8, 7)):
        t = build_rope3d_tables(128, T, HW, HW, n_special=1)
        sin, cos = torch.from_numpy(t.sin).to(dev), torch.from_numpy(t.cos).to(dev)
        B, H, Dh, D, L = 32, 4, 128, 512, sin.shape[0]
        qkv, do = randn(B, L, 3 * D), randn(B, L, D)
        leaf = qkv.clone().requires_grad_()
        out = flash_attention_packed(qkv=leaf, num_heads=H, sin=sin, cos=cos)
        heads = [_to_heads(u, H) for u in qkv.split(D, -1)]
        doh = _to_heads(do, H)
        outh = _to_heads(out.detach(), H)
        # the forward at the step's 32 clips, row statistics written
        errs["K1"] = max(errs["K1"], check_forward(
            torch, "train forward check", f"K1 fused qkv + RoPE [{B},{L},{3 * D}]",
            outh, multi_head_attention(*heads, sin=sin, cos=cos)))
        sq = [apply_rope(heads[0], sin, cos).requires_grad_(),
              apply_rope(heads[1], sin, cos).requires_grad_(),
              heads[2].clone().requires_grad_()]
        sout = F.scaled_dot_product_attention(*sq)
        row = timed(out, [leaf], do,
                    lambda: flash_bwd_plain(*heads, doh, outh, sin=sin, cos=cos),
                    sout, sq, doh, 10 * B * H * L * L * Dh,
                    8 * B * L * D * 2 + 2 * L * Dh * 4, K2_KERNELS)
        row["shape"] = f"qkv [{B},{L},{3 * D}] bf16, H {H}, Dh {Dh}, RoPE"
        rows_k2.append(row)
        del qkv, do, leaf, out, heads, doh, outh, sq, sout
        torch.cuda.empty_cache()
    # K1 forward and K2 backward, text tower: q/k/v with the key mask
    B, H, Dh, D, L = 8, 6, 128, 768, 512
    q, k, v, do = randn(B, L, D), randn(B, L, D), randn(B, L, D), randn(B, L, D)
    mask = torch.ones(B, L, dtype=torch.bool, device=dev)
    leaves = [u.clone().requires_grad_() for u in (q, k, v)]
    out = flash_attention_packed(*leaves, num_heads=H, kv_mask=mask)
    heads = [_to_heads(u, H) for u in (q, k, v)]
    doh, outh = _to_heads(do, H), _to_heads(out.detach(), H)
    sq = [u.clone().requires_grad_() for u in heads]
    sout = F.scaled_dot_product_attention(*sq, attn_mask=mask[:, None, None, :])
    row = timed(out, leaves, do,
                lambda: flash_bwd_plain(*heads, doh, outh, kv_mask=mask),
                sout, sq, doh, 10 * B * H * L * L * Dh, 8 * B * L * D * 2 + B * L,
                K2_KERNELS)
    row["shape"] = f"q/k/v [{B},{L},{D}] bf16, H {H}, Dh {Dh}, kv_mask"
    rows_k2.append(row)
    with torch.no_grad():
        b_ms, b_by = bound(4 * B * H * L * L * Dh, 4 * B * L * D * 2 + B * L)
        k1_text = {
            "shape": row["shape"],
            "ms": cuda_ms(torch, lambda: flash_attention_packed(
                q, k, v, num_heads=H, kv_mask=mask), REPS),
            "plain_ms": cuda_ms(torch, lambda: multi_head_attention(
                *heads, kv_mask=mask), max(1, REPS // 5)),
            "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                *heads, attn_mask=mask[:, None, None, :]), REPS),
            "bound_ms": b_ms, "bound_by": b_by,
            "device_ms": device_ms(torch, lambda: flash_attention_packed(
                q, k, v, num_heads=H, kv_mask=mask), REPS, ("flash_fwd_sm90_kernel",)),
            "library_device_ms": device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    *heads, attn_mask=mask[:, None, None, :]), REPS)}
        k1_text["tflops"] = 4 * B * H * L * L * Dh / k1_text["ms"] / 1e9
    del q, k, v, do, leaves, out, heads, doh, outh, sq, sout

    # K4: the aggregator over 4 videos
    B, H, L, Dh = 8, 8, 4, 64
    q4, k4, v4 = randn(B, H, L, Dh), randn(B, H, L, Dh), randn(B, H, L, Dh)
    do4 = randn(B, L, H, Dh).transpose(1, 2)
    m4 = torch.ones(B, L, dtype=torch.bool, device=dev)
    leaves = [u.clone().requires_grad_() for u in (q4, k4, v4)]
    out = flash_attention(*leaves, kv_mask=m4)
    sq = [u.clone().requires_grad_() for u in (q4, k4, v4)]
    sout = F.scaled_dot_product_attention(*sq, attn_mask=m4[:, None, None, :])
    row_k4 = timed(out, leaves, do4,
                   lambda: flash_bwd_plain(q4, k4, v4, do4, out.detach(), kv_mask=m4),
                   sout, sq, do4, 10 * B * H * L * L * Dh, 8 * B * H * L * Dh * 2 + B * L,
                   ("flash_short_bwd_bf16_kernel",))
    row_k4["shape"] = "q/k/v [8,8,4,64] bf16, kv_mask [8,4]"

    for name, rows in (("K2 backward", rows_k2), ("K1 forward (text)", [k1_text]),
                       ("K4 backward", [row_k4])):
        for r in rows:
            rate = f" ({r['tflops']:.1f} TFLOP/s)" if "tflops" in r else ""
            print(f"train times: {name} {r['shape']}: kernel {r['ms']:.4f} ms{rate}, plain "
                  f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}); card busy: kernel "
                  f"{r['device_ms']:.4f} ms, sdpa {r['library_device_ms']:.4f} ms",
                  flush=True)

    def entry(name, replaces, key, rows):
        e = {"name": name, "route": "cuda", "source": BWD_SOURCE, "replaces": replaces,
             "launches": counts[key], "max_abs_err": errs[key],
             "kernels": routes[key]}
        e.update({k: rows[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "device_ms")})
        e["shapes"] = rows
        return e

    return [entry("flash_attention_packed backward (K2: flash_bwd_dkv_sm90_kernel, "
                  "flash_bwd_dq_sm90_kernel)", K2_REPLACES, "K2", rows_k2),
            entry("flash_attention (K4 backward)", K4_REPLACES, "K4", [row_k4])], k1_text


# --------------------------------------------------------------------------- #
# phase 11: the fused projection (K5) and the fp32 kernels against plain


def proj_cases(torch):
    """(name, at a probing shape, run) with run() -> (y, plain y, gradients,
    plain gradients): K5 through the entry point, forward and backward, each
    launched twice and held bit-equal."""
    from deepcoro_clip_tpu_torch.ops.attention import (
        flash_bwd_plain,
        multi_head_attention,
        project_plain,
    )
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import (
        flash_attention_packed,
    )
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    def case(B, Lq, Lk, H, dout, fused, kw):
        D = H * 128
        if fused:
            operands = [randn(B, Lq, 3 * D)]
        else:
            operands = [randn(B, Lq, D), randn(B, Lk, D), randn(B, Lk, D)]
        wo = torch.randn(D, dout, generator=g, device=dev) * D ** -0.5  # fp32, as proj.weight
        gy = randn(B, Lq, dout)

        def call(leaves):
            if fused:
                return flash_attention_packed(qkv=leaves[0], num_heads=H, wo=leaves[-1], **kw)
            return flash_attention_packed(*leaves[:3], num_heads=H, wo=leaves[-1], **kw)

        def run():
            leaves = [t.clone().requires_grad_() for t in operands + [wo]]
            y = call(leaves)
            check(y.grad_fn is not None, "the wrapper's output carries no grad_fn")
            with torch.no_grad():
                bare = call([t.detach() for t in leaves])
            check(torch.equal(y.detach(), bare),
                  "two forward launches (with and without residuals) differ")
            got = torch.autograd.grad(y, leaves, gy, retain_graph=True)
            again = torch.autograd.grad(y, leaves, gy)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  "two backward launches on the same inputs differ")
            q, k, v = operands[0].split(D, -1) if fused else operands
            wo16 = wo.to(torch.bfloat16)
            heads = [_to_heads(t, H) for t in (q, k, v)]
            out = multi_head_attention(*heads, **kw)
            flat = out.transpose(1, 2).flatten(2)
            ref_y = project_plain(flat, wo16)
            do = torch.matmul(gy, wo16.t())
            ref = [t.transpose(1, 2).flatten(2)
                   for t in flash_bwd_plain(*heads, _to_heads(do, H), out, **kw)]
            if fused:
                ref = [torch.cat(ref, dim=-1)]
            ref.append(torch.matmul(flat.flatten(0, 1).t().float(), gy.flatten(0, 1).float()))
            return y.detach(), ref_y, got, ref

        def forward():  # no gradient wanted: y alone, no residuals
            with torch.no_grad():
                return call(operands + [wo])
        run.forward = forward
        run.flops = 4 * B * H * Lq * Lk * 128 + 2 * B * Lq * D * dout
        return run

    def rope(T, HW):
        t = build_rope3d_tables(128, T, HW, HW, n_special=1)
        return dict(sin=torch.from_numpy(t.sin).to(dev), cos=torch.from_numpy(t.cos).to(dev))

    cases = []
    B = PROBE_CLIPS  # every clip of a probing step: the batch the path launches K5 at
    for T, HW in ((8, 14), (8, 7)):  # the backbone before and after the pool
        kw = rope(T, HW)
        L = kw["sin"].shape[0]
        cases.append((f"K5 fused qkv + RoPE [{B},{L},1536] wo [512,512]", True,
                      case(B, L, L, 4, 512, True, kw)))
    tmask = torch.ones(8, 512, dtype=torch.bool, device=dev)
    tmask[1, 300:], tmask[5, 77:] = False, False
    cases.append(("K5 fused qkv + kv_mask [8,512,2304] wo [768,768]", True,
                  case(8, 512, 512, 6, 768, True, dict(kv_mask=tmask))))
    m = torch.rand(3, 200, generator=g, device=dev) > 0.3
    m[2] = False
    cases.append(("K5 q/k/v + kv_mask [3,70|200,256] wo [256,384] (one row fully masked)",
                  False, case(3, 70, 200, 2, 384, False, dict(kv_mask=m))))
    cases.append(("K5 q/k/v causal [2,150,256] wo [256,256]", False,
                  case(2, 150, 150, 2, 256, False, dict(causal=True))))
    return cases


def f32_cases(torch):
    """(name, at the probing head's shape, run) with run() -> (out, plain out,
    gradients, plain gradients) of flash_attention on fp32 operands."""
    from deepcoro_clip_tpu_torch.ops.attention import (
        flash_bwd_plain,
        multi_head_attention,
    )
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)

    def case(B, H, Lq, Lk, Dh, kw):
        # operands as the layer hands them over: strided views of [B, L, 3D]
        q, k, v = (torch.randn(B, n, H * Dh, generator=g, device=dev) for n in (Lq, Lk, Lk))
        do = torch.randn(B, Lq, H, Dh, generator=g, device=dev).transpose(1, 2)

        def run():
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = flash_attention(*[_to_heads(t, H) for t in leaves], **kw)
            check(out.dtype == torch.float32, f"fp32 operands gave {out.dtype}")
            got = torch.autograd.grad(out, leaves, do, retain_graph=True)
            again = torch.autograd.grad(out, leaves, do)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  "two fp32 backward launches on the same inputs differ")
            heads = [_to_heads(t, H) for t in (q, k, v)]
            ref_out = multi_head_attention(*heads, **kw)
            ref = [t.transpose(1, 2).flatten(2)
                   for t in flash_bwd_plain(*heads, do, ref_out, **kw)]
            return out.detach(), ref_out, got, ref
        return run

    mask = torch.ones(8, 11, dtype=torch.bool, device=dev)
    mask[1, 4:], mask[3, 1:], mask[6, 8:] = False, False, False
    t = build_rope3d_tables(64, 2, 7, 7, n_special=1)
    rope = dict(sin=torch.from_numpy(t.sin).to(dev), cos=torch.from_numpy(t.cos).to(dev))
    return [
        ("fp32 K3/K4 kv_mask [8,8,11,64]", True, case(8, 8, 11, 11, 64, dict(kv_mask=mask))),
        ("fp32 K3/K4 causal [2,2,130,128]", False, case(2, 2, 130, 130, 128, dict(causal=True))),
        ("fp32 K3/K4 RoPE [2,3,99,64]", False, case(2, 3, 99, 99, 64, rope)),
        ("fp32 K3/K4 cross [2,4,37|300,128]", False, case(2, 4, 37, 300, 128, {})),
    ]


def phase_proj_kernels(torch) -> dict:
    """Returns max|kernel - plain| at the probing shapes: K5 forward and
    backward, K3 and K4 on fp32 operands, K3 in bf16 at the AttentionPool
    shape."""
    from deepcoro_clip_tpu_torch.ops.attention import multi_head_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention

    errs = {"K5": 0.0, "K5_bwd": 0.0, "K3_f32": 0.0, "K4_f32": 0.0, "K3_pool": 0.0}
    for name, at_shape, run in proj_cases(torch):
        y, ref_y, got, ref = run()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the plain backward at 80 clips holds fp32 scores
        err = check_forward(torch, "fused projection check", name, y, ref_y)
        names = ("dqkv", "dwo") if len(got) == 2 else ("dq", "dk", "dv", "dwo")
        worst = max(_rel_check(name, which, a, r) for which, a, r in zip(names, got, ref))
        print(f"fused projection check {name}: gradients max|kernel-plain| {worst:.3e} "
              f"over {', '.join(names)} (bars: {BWD_MAX_REL} of max|plain|, rel l2 "
              f"{BWD_L2_REL}); forward and backward launched twice, bit-equal ok",
              flush=True)
        ms = cuda_ms(torch, run.forward, 5)
        print(f"fused projection check {name}: forward {ms:.4f} ms between CUDA events, "
              f"{run.flops / ms / 1e9:.1f} TFLOP/s", flush=True)
        if at_shape:
            errs["K5"], errs["K5_bwd"] = max(errs["K5"], err), max(errs["K5_bwd"], worst)
    for name, at_shape, run in f32_cases(torch):
        out, ref_out, got, ref = run()
        torch.cuda.synchronize()
        reached = []
        for which, a, r in zip(("out", "dq", "dk", "dv"), [out] + list(got), [ref_out] + ref):
            d = (a - r).abs()
            ok = bool(torch.isfinite(a).all()) and bool(
                (d <= F32_ATOL + F32_RTOL * r.abs()).all())
            check(ok, f"{name}: {which} disagrees with the plain version in fp32 "
                      f"(max|d| {float(d.max()):.3e})")
            reached.append(float(d.max()))
        print(f"fp32 check {name}: max|kernel-plain| forward {reached[0]:.3e}, "
              f"gradients {max(reached[1:]):.3e} (tol {F32_ATOL}+{F32_RTOL}|plain|); "
              f"two backward launches bit-equal ok", flush=True)
        if at_shape:
            errs["K3_f32"], errs["K4_f32"] = reached[0], max(reached[1:])
    # K3 in bf16 as AttentionPool calls it: one query over a clip's 393 tokens
    g = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn(80, 8, 1, 64, generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(80, 8, 393, 64, generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    errs["K3_pool"] = check_forward(
        torch, "kernel check", "K3 cross [80,8,1|393,64] (AttentionPool)",
        flash_attention(q, k, v), multi_head_attention(q, k, v))
    return errs


# --------------------------------------------------------------------------- #
# phase 12: the linear-probing step on the frozen flagship backbone


def probe_config(**over):
    """config/linear_probing/stenosis_config.yaml, field by field (a CPU test
    holds this dict equal to the YAML as the port's parser reads it; the
    machine with the card need not have a YAML reader)."""
    from deepcoro_clip_tpu_torch.configs import LinearProbingConfig

    heads = ("stenosis", "stenosis_binary", "calcif_binary", "CTO")
    d = dict(
        pipeline_project="DeepCORO_video_linear_probing", run_mode="train", epochs=25,
        num_workers=8, seed=42,
        data_filename="data/labels.csv", datapoint_loc_label="FileName", frames=16,
        stride=2, resize=224, batch_size=8, multi_video=True, num_videos=10,
        groupby_column="StudyInstanceUID",
        head_structure={h: 1 for h in heads},
        loss_structure={"stenosis": "huber", "stenosis_binary": "bce_logit",
                        "calcif_binary": "bce_logit", "CTO": "bce_logit"},
        head_task={"stenosis": "regression", "stenosis_binary": "binary",
                   "calcif_binary": "binary", "CTO": "binary"},
        head_lr={h: 0.0003 for h in heads},
        head_weight_decay={h: 0.00001 for h in heads},
        pooling_mode="attention+cls_token", use_cls_token=True,
        normalization_strategy="pre_norm", attention_hidden=256,
        dropout_attention=0.24, attention_lr=0.0015, attention_weight_decay=0.00005,
        model_name="mvit", vit_dim=512, vit_depth=12, vit_heads=4, vit_patch=[2, 16, 16],
        vit_pool_stages=[3], embedding_dim=512, aggregate_videos_tokens=False,
        video_encoder_checkpoint_path=None, video_freeze_ratio=1.0,
        optimizer="AdamW", scheduler_name="cosine_with_warmup", lr=0.001,
        weight_decay=0.00001, max_grad_norm=1.0,
        ci_n_bootstrap=1000, ci_confidence_level=0.95, save_embeddings=True,
        precision="bf16", use_pallas_attention=True, use_wandb=False,
    )
    d.update(over)
    return LinearProbingConfig.from_dict(d)


def probe_batch(cfg, studies: int):
    from deepcoro_clip_tpu_torch.data.patch_wire import patchify_videos

    r = np.random.default_rng(1)
    videos = r.integers(0, 255, size=(studies, cfg.num_videos, cfg.frames, cfg.resize,
                                      cfg.resize, 3), dtype=np.uint8)
    mask = np.ones((studies, cfg.num_videos), bool)
    mask[1, cfg.num_videos // 2:] = False  # studies with fewer clips: padded slots
    mask[studies - 1, 1:] = False
    targets = {h: ((r.random(studies) > 0.5).astype(np.float32)
                   if cfg.loss_structure[h] == "bce_logit"
                   else r.random(studies).astype(np.float32))
               for h in cfg.head_structure}
    return {"videos": patchify_videos(videos, tuple(cfg.vit_patch)),
            "video_mask": mask, "targets": targets}


def phase_probing(torch):
    from deepcoro_clip_tpu_torch.train.linear_probe import (
        build_probe_bundle,
        make_probe_eval_step,
        make_probe_train_step,
        to_device_batch,
    )

    cfg = probe_config()
    check(cfg.batch_size * cfg.num_videos == PROBE_CLIPS,
          f"phases 11 and 15 hold K5 at {PROBE_CLIPS} clips, the step has "
          f"{cfg.batch_size * cfg.num_videos}")
    t0 = time.perf_counter()
    bundle, state = build_probe_bundle(cfg, seed=0, steps_per_epoch=1, fused_outproj=True)
    step_fn = make_probe_train_step(bundle)
    eval_fn = make_probe_eval_step(bundle)
    batch = to_device_batch(bundle, probe_batch(cfg, cfg.batch_size))
    gen = torch.Generator(device=bundle.device).manual_seed(0)
    n_enc = sum(p.numel() for k, p in state.params.items() if k.startswith("video_encoder."))
    n_mil = sum(p.numel() for k, p in state.params.items() if k.startswith("mil."))
    print(f"probing: bundle built in {time.perf_counter() - t0:.1f} s: encoder "
          f"{n_enc / 1e6:.1f} M parameters (frozen, bf16 compute, output projection fused "
          f"into the attention kernel), head {n_mil / 1e6:.2f} M (fp32), {cfg.batch_size} "
          f"studies x {cfg.num_videos} clips of {cfg.frames}x{cfg.resize}x{cfg.resize}, "
          f"pooling {cfg.pooling_mode}, dropout {cfg.dropout}/{cfg.dropout_attention}, "
          f"{cfg.scheduler_name} (steps_per_epoch 1: 25 updates)", flush=True)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    ratio = cfg.video_freeze_ratio
    eval_before = float(eval_fn(state.params, batch)["loss"])
    torch.cuda.reset_peak_memory_stats()

    losses, lrs = [], []
    for _ in range(PROBE_WARMUP):
        state, m = step_fn(state, batch, gen, ratio)
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    _zero_kernel_counts()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    metrics = []
    for _ in range(PROBE_STEPS):
        state, m = step_fn(state, batch, gen, ratio)
        metrics.append(m)  # read after the loop: no host wait inside it
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / PROBE_STEPS
    dev_ms = start.elapsed_time(end) / PROBE_STEPS
    counts = _kernel_counts()
    losses += [float(m["loss"]) for m in metrics]
    lrs += [float(m["lr"]) for m in metrics]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    _zero_kernel_counts()
    out = eval_fn(state.params, batch)
    eval_counts = _kernel_counts()
    eval_after = float(out["loss"])
    last = metrics[-1]

    print("probing: losses " + " ".join(f"{x:.4f}" for x in losses), flush=True)
    print("probing: lr " + " ".join(f"{x:.2e}" for x in lrs), flush=True)
    print("probing: last step grad_norm {:.3f}, per head {}".format(
        float(last["grad_norm"]),
        ", ".join(f"{h} {float(last['loss_' + h]):.4f}" for h in bundle.head_names)),
        flush=True)
    print(f"probing: launches over {PROBE_STEPS} steps: K5 {counts['K5']}, K1 "
          f"{counts['K1']}, K2 {counts['K2']}, K3 {counts['K3']}, K4 {counts['K4']} (per "
          f"step 12/0/0/1/1); eval step: K5 {eval_counts['K5']}, K1 {eval_counts['K1']}, "
          f"K3 {eval_counts['K3']}", flush=True)
    print(f"probing: step {dev_ms:.1f} ms (CUDA events), {host_ms:.1f} ms (host clock), "
          f"{cfg.batch_size / dev_ms * 1e3:.1f} studies/s, "
          f"{cfg.batch_size * cfg.num_videos / dev_ms * 1e3:.1f} clips/s, peak memory "
          f"{peak_gb:.2f} GiB (torch.cuda.max_memory_allocated)", flush=True)

    check(all(math.isfinite(x) for x in losses), f"non-finite loss in {losses}")
    for key, per_step in (("K5", 12), ("K1", 0), ("K2", 0), ("K3", 1), ("K4", 1)):
        check(counts[key] == per_step * PROBE_STEPS,
              f"{key} launched {counts[key]} times in {PROBE_STEPS} probing steps, "
              f"expected {per_step} per step")
    check(eval_counts == {"K1": 0, "K2": 0, "K3": 1, "K4": 0, "K5": 12, "K6": 0},
          f"the eval step launched {eval_counts}")
    check(state.step == PROBE_WARMUP + PROBE_STEPS, f"step count {state.step}")
    moved_enc = [k for k, v in state.params.items()
                 if k.startswith("video_encoder.") and not torch.equal(v, before[k])]
    stuck = [k for k, v in state.params.items()
             if k.startswith("mil.") and torch.equal(v, before[k])]
    bad = [k for k, v in state.params.items() if not bool(torch.isfinite(v).all())]
    check(not bad, f"non-finite parameters after probing: {bad[:5]}")
    check(not moved_enc, f"frozen encoder parameters moved: {moved_enc[:5]}")
    check(not stuck, f"head parameters that did not move: {stuck[:5]}")
    emb = out["embeddings"]
    check(tuple(emb.shape) == (cfg.batch_size, cfg.num_videos, cfg.embedding_dim)
          and bool(torch.isfinite(emb).all()), f"bad embeddings {tuple(emb.shape)}")
    for h, n in cfg.head_structure.items():
        o = out["outputs"][h]
        check(tuple(o.shape) == (cfg.batch_size, n) and o.dtype == torch.float32
              and bool(torch.isfinite(o).all()), f"bad output of head {h}")
    check(math.isfinite(eval_after) and eval_after < eval_before,
          f"the loss on the repeated batch did not fall: {eval_before} -> {eval_after}")
    n_mil_t = sum(k.startswith("mil.") for k in state.params)
    print(f"probing: all {n_mil_t} head tensors moved, none of the "
          f"{len(state.params) - n_mil_t} encoder tensors did, none NaN; loss on the "
          f"repeated batch with dropout off {eval_before:.4f} -> {eval_after:.4f}",
          flush=True)
    del before
    times = {"step_ms": dev_ms, "step_host_ms": host_ms, "peak_gib": peak_gb,
             "studies_per_s": cfg.batch_size / dev_ms * 1e3}
    return bundle, state, step_fn, batch, gen, counts, times


# --------------------------------------------------------------------------- #
# phase 13: probing end to end against the unfused and the plain attention


def phase_probe_e2e(torch, bundle, state, batch):
    import dataclasses

    import torch.nn.functional as F

    from deepcoro_clip_tpu_torch.train.linear_probe import (
        build_probe_bundle,
        make_probe_eval_step,
    )

    def with_weights(fused, **over):
        b, s = build_probe_bundle(dataclasses.replace(bundle.config, **over), seed=0,
                                  steps_per_epoch=1, fused_outproj=fused)
        b.video_model.load_state_dict(bundle.video_model.state_dict())
        b.mil_model.load_state_dict(bundle.mil_model.state_dict())
        return b, s

    eval_fn = make_probe_eval_step(bundle)
    ref = eval_fn(state.params, batch)
    eval_ms = {"K5": cuda_ms(torch, lambda: eval_fn(state.params, batch), 5)}
    others = {}
    for label, fused, over, want in (
            ("K1 + F.linear", False, {}, {"K1": 12, "K5": 0, "K3": 1}),
            ("plain attention", False, dict(use_pallas_attention=False),
             {"K1": 0, "K5": 0, "K3": 0})):
        b, s = with_weights(fused, **over)
        _zero_kernel_counts()
        other_fn = make_probe_eval_step(b)
        others[label] = other_fn(s.params, batch)
        counts = _kernel_counts()
        check(all(counts[k] == n for k, n in want.items()),
              f"the {label} path launched {counts}, expected {want}")
        if fused is False and not over:  # the same step with the projection unfused
            eval_ms[label] = cuda_ms(torch, lambda: other_fn(s.params, batch), 5)
        del b, s, other_fn
    for label, out in others.items():
        a, o = ref["embeddings"].float(), out["embeddings"].float()
        cos = float(F.cosine_similarity(a.flatten(0, 1), o.flatten(0, 1), dim=1).min())
        worst = 0.0
        for h in bundle.head_names:
            x, y = ref["outputs"][h], out["outputs"][h]
            d = (x - y).abs()
            check(bool((d <= HEAD_ATOL + HEAD_RTOL * y.abs()).all()),
                  f"head {h} through K5 is off the {label} path by {float(d.max()):.3e}")
            worst = max(worst, float(d.max()))
        print(f"probing end to end: K5 vs {label}: per-video embeddings min cosine "
              f"{cos:.6f} (bar >= {E2E_MIN_COSINE}), head outputs max|d| {worst:.3e} "
              f"(bar {HEAD_ATOL}+{HEAD_RTOL}|ref|), loss {float(ref['loss']):.5f} vs "
              f"{float(out['loss']):.5f}", flush=True)
        check(cos >= E2E_MIN_COSINE, f"K5 vs {label}: embedding cosine {cos} below the bar")
    print("probing end to end: eval step (80 clips forward, head, losses; CUDA events, "
          "mean of 5): " + ", ".join(f"{k} path {v:.2f} ms" for k, v in eval_ms.items()),
          flush=True)
    torch.cuda.empty_cache()
    return eval_ms


# --------------------------------------------------------------------------- #
# phase 14: a partially frozen step: the backward through K5


def phase_probe_partial(torch, bundle):
    import dataclasses

    from deepcoro_clip_tpu_torch.train import optim as optim_lib
    from deepcoro_clip_tpu_torch.train.linear_probe import (
        build_probe_bundle,
        forward_heads,
        make_probe_train_step,
        to_device_batch,
    )
    from deepcoro_clip_tpu_torch.losses.heads import multi_head_loss

    ratio = 0.8  # config/linear_probing/cathef_regression_config.yaml
    base = dataclasses.replace(bundle.config, video_freeze_ratio=ratio, batch_size=2,
                               num_videos=4)

    def with_weights(fused, **over):
        b, s = build_probe_bundle(dataclasses.replace(base, **over), seed=0,
                                  steps_per_epoch=1, fused_outproj=fused)
        b.video_model.load_state_dict(bundle.video_model.state_dict())
        b.mil_model.load_state_dict(bundle.mil_model.state_dict())
        return b, s

    kernel_b, kernel_s = with_weights(True)
    batch = to_device_batch(kernel_b, probe_batch(base, 2))
    keep = optim_lib.freeze_keep(kernel_b.video_fracs, ratio)
    kept = [k for k, v in keep.items() if v]
    check(0 < len(kept) < len(keep), f"ratio {ratio} keeps {len(kept)} of {len(keep)} leaves")

    def grads(b):
        """The loss and the flattened gradient of the trainable encoder
        leaves, dropout off."""
        outputs, _ = forward_heads(b, batch, deterministic=True)
        loss = multi_head_loss(outputs, batch["targets"], dict(b.config.loss_structure),
                               head_weights=dict(b.config.head_weights))["main"]
        named = dict(b.video_model.named_parameters())
        got = torch.autograd.grad(loss, [named[k] for k in kept])
        return float(loss.detach()), torch.cat([x.flatten().double() for x in got])

    def cosine(a, b):
        return float(torch.dot(a, b) / (torch.linalg.vector_norm(a)
                                        * torch.linalg.vector_norm(b)))

    _zero_kernel_counts()
    loss_k, gk = grads(kernel_b)
    counts = _kernel_counts()
    # the gradient stops below the lowest trainable leaf: only the blocks
    # above it run a backward
    check(counts["K5"] == 12 and counts["K1"] == 0 and 1 <= counts["K2"] <= 12
          and counts["K4"] == 1, f"the partially frozen backward launched {counts}")
    plain_b, _ = with_weights(False, use_pallas_attention=False)
    loss_p, gp = grads(plain_b)
    del plain_b
    fp32_b, _ = with_weights(False, use_pallas_attention=False, precision="fp32")
    loss_f, gf = grads(fp32_b)
    del fp32_b
    kf, pf, kp = cosine(gk, gf), cosine(gp, gf), cosine(gk, gp)
    bar = GRAD_MIN_KERNEL_VS_PLAIN["video_encoder"]
    print(f"partial freeze: ratio {ratio}, {len(kept)} of {len(keep)} encoder leaves "
          f"trainable ({gk.numel() / 1e6:.1f} M values), launches K5 {counts['K5']}, K2 "
          f"{counts['K2']}, K3 {counts['K3']}, K4 {counts['K4']}; loss through K5 "
          f"{loss_k:.5f}, plain bf16 {loss_p:.5f}, plain fp32 {loss_f:.5f}", flush=True)
    print(f"partial freeze: cosine to the fp32 gradient: K5 path {kf:.6f}, plain bf16 "
          f"{pf:.6f} (bar: K5 >= plain - {GRAD_COSINE_SLACK} and >= {GRAD_MIN_COSINE}); "
          f"K5 path vs plain bf16 {kp:.6f} (bar >= {bar})", flush=True)
    check(bool(torch.isfinite(gk).all()), "non-finite encoder gradients through K5")
    check(kf >= pf - GRAD_COSINE_SLACK and kf >= GRAD_MIN_COSINE,
          f"the K5 path's gradient is further from fp32 ({kf}) than the plain bf16 "
          f"path's ({pf})")
    check(kp >= bar, f"cosine of the K5 path's gradient to the plain bf16 path's {kp} "
                     f"below {bar}")

    # and the step itself: the trainable leaves move, the frozen ones do not
    before = {k: v.detach().clone() for k, v in kernel_s.params.items()}
    step_fn = make_probe_train_step(kernel_b)
    gen = torch.Generator(device=kernel_b.device).manual_seed(0)
    for _ in range(2):  # the first update has rate 0
        kernel_s, m = step_fn(kernel_s, batch, gen, ratio)
    check(math.isfinite(float(m["loss"])), "non-finite loss in the partially frozen step")
    pre = "video_encoder."
    wrong = [k for k, v in kernel_s.params.items() if k.startswith(pre)
             and torch.equal(v, before[k]) == keep[k[len(pre):]]]
    check(not wrong, f"leaves on the wrong side of the freeze mask: {wrong[:5]}")
    print(f"partial freeze: after 2 train steps the {len(kept)} trainable encoder leaves "
          f"moved and the other {len(keep) - len(kept)} did not", flush=True)
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------- #
# phase 15: probing times


def phase_probe_profile(torch, state, step_fn, batch, gen, ratio) -> None:
    per_name, wall_ms = device_events(torch, lambda: step_fn(state, batch, gen, ratio))
    print_profile("probing profile", "one step", per_name, wall_ms, top=12)
    check_main_path_kernels("probing profile, the CLS block's K3 and K4", per_name,
                            ("flash_short_fwd_f32_kernel", "flash_short_bwd_f32_kernel"),
                            ("flash_fwd_f32_kernel", "flash_fwd_f32_regtile_kernel",
                             "bwd_rows_f32_kernel", "flash_bwd_dkv_f32_kernel",
                             "flash_bwd_dq_f32_kernel") + REGTILE_BWD)


def phase_probe_times(torch, errs, counts, partial_counts):
    import torch.nn.functional as F

    from deepcoro_clip_tpu_torch.ops.attention import (
        apply_rope,
        flash_bwd_plain,
        multi_head_attention,
        project_plain,
    )
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import (
        flash_attention_packed,
    )
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    rows = []
    with torch.no_grad():
        for B, L, H, rope_grid in ((PROBE_CLIPS, 1569, 4, (8, 14)),
                                   (PROBE_CLIPS, 393, 4, (8, 7)), (8, 512, 6, None)):
            D = H * 128
            kw = {}
            if rope_grid:
                t = build_rope3d_tables(128, rope_grid[0], rope_grid[1], rope_grid[1],
                                        n_special=1)
                kw = dict(sin=torch.from_numpy(t.sin).to(dev),
                          cos=torch.from_numpy(t.cos).to(dev))
            else:
                kw = dict(kv_mask=torch.ones(B, L, dtype=torch.bool, device=dev))
            qkv = randn(B, L, 3 * D)
            weight = torch.randn(D, D, generator=g, device=dev) * D ** -0.5  # proj.weight
            w16 = weight.to(torch.bfloat16)          # [Dout, D], what F.linear takes
            wo16 = w16.t().contiguous()              # [D, Dout], what the kernel takes
            heads = [_to_heads(u, H) for u in qkv.split(D, -1)]
            if rope_grid:
                sq = [apply_rope(heads[0], **kw), apply_rope(heads[1], **kw), heads[2]]
                sdpa_kw = {}
            else:
                sq, sdpa_kw = heads, dict(attn_mask=kw["kv_mask"][:, None, None, :])

            def fused():
                return flash_attention_packed(qkv=qkv, num_heads=H, wo=wo16, **kw)

            def fused_with_cast():  # as the layer calls it: fp32 [Dout, D] weights
                return flash_attention_packed(qkv=qkv, num_heads=H, wo=weight.t(), **kw)

            def unfused():
                return F.linear(flash_attention_packed(qkv=qkv, num_heads=H, **kw), w16)

            def unfused_with_cast():
                return F.linear(flash_attention_packed(qkv=qkv, num_heads=H, **kw),
                                weight.to(torch.bfloat16))

            def plain():
                out = multi_head_attention(*heads, **kw)
                return project_plain(out.transpose(1, 2).flatten(2), wo16)

            def library():
                out = F.scaled_dot_product_attention(*sq, **sdpa_kw)
                return F.linear(out.transpose(1, 2).flatten(2), w16)

            flops = 4 * B * H * L * L * 128 + 2 * B * L * D * D
            nbytes = ((B * L * 3 * D + D * D + B * L * D) * 2
                      + (2 * L * 128 * 4 if rope_grid else B * L))
            b_ms, b_by = bound(flops, nbytes)
            row = {"shape": f"qkv [{B},{L},{3 * D}] bf16, H {H}, Dh 128, wo [{D},{D}], "
                            + ("RoPE" if rope_grid else "kv_mask"),
                   "ms": cuda_ms(torch, fused, REPS),
                   "ms_with_cast": cuda_ms(torch, fused_with_cast, REPS),
                   "unfused_ms": cuda_ms(torch, unfused, REPS),
                   "unfused_ms_with_cast": cuda_ms(torch, unfused_with_cast, REPS),
                   "plain_ms": cuda_ms(torch, plain, max(1, REPS // 5)),
                   "library_ms": cuda_ms(torch, library, REPS),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "device_ms": device_ms(torch, fused, REPS, ("flash_fwd_proj_kernel",)),
                   "unfused_device_ms": device_ms(torch, unfused, REPS,
                                                  ("flash_fwd_sm90_kernel",)),
                   "library_device_ms": device_ms(torch, library, REPS)}
            # the outputs that were timed, against each other
            row["max_abs_err"] = check_forward(
                torch, "probing times", f"K5 {row['shape']}", fused(), plain())
            errs["K5"] = max(errs["K5"], row["max_abs_err"])
            row["tflops"] = flops / row["ms"] / 1e9
            row["unfused_tflops"] = flops / row["unfused_ms"] / 1e9
            rows.append(row)
            print(f"probing times: K5 {row['shape']}: kernel {row['ms']:.4f} ms "
                  f"({row['tflops']:.1f} TFLOP/s; K1 + F.linear "
                  f"{row['unfused_tflops']:.1f}) "
                  f"({row['ms_with_cast']:.4f} with the cast of wo), K1 + F.linear "
                  f"{row['unfused_ms']:.4f} ms ({row['unfused_ms_with_cast']:.4f} with the "
                  f"cast), plain {row['plain_ms']:.4f} ms, sdpa + F.linear "
                  f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}); card busy: kernel {row['device_ms']:.4f} ms, K1 + "
                  f"F.linear {row['unfused_device_ms']:.4f} ms, sdpa + F.linear "
                  f"{row['library_device_ms']:.4f} ms", flush=True)
            del qkv, heads, sq
            torch.cuda.empty_cache()

    # K3 and K4 on fp32 operands at the probing head's shape
    B, H, L, Dh = 8, 8, 11, 64
    q, k, v = (torch.randn(B, H, L, Dh, generator=g, device=dev) for _ in range(3))
    do = torch.randn(B, L, H, Dh, generator=g, device=dev).transpose(1, 2)
    mask = torch.ones(B, L, dtype=torch.bool, device=dev)
    mask[1, 4:] = False
    leaves = [u.clone().requires_grad_() for u in (q, k, v)]
    out = flash_attention(*leaves, kv_mask=mask)
    sq = [u.clone().requires_grad_() for u in (q, k, v)]
    sout = F.scaled_dot_product_attention(*sq, attn_mask=mask[:, None, None, :])

    def fwd():
        with torch.no_grad():
            return flash_attention(q, k, v, kv_mask=mask)

    def fwd_lib():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask[:, None, None, :])

    def bwd():
        return torch.autograd.grad(out, leaves, do, retain_graph=True)

    def bwd_lib():
        return torch.autograd.grad(sout, sq, do, retain_graph=True)

    shape = "q/k/v [8,8,11,64] fp32, kv_mask [8,11]"
    f_ms, f_by = bound(4 * B * H * L * L * Dh, 4 * B * H * L * Dh * 4 + B * L,
                       PEAK_FP32_FLOPS)
    g_ms, g_by = bound(10 * B * H * L * L * Dh, 8 * B * H * L * Dh * 4 + B * L,
                       PEAK_FP32_FLOPS)
    row_k3 = {"shape": shape, "ms": cuda_ms(torch, fwd, REPS),
              "plain_ms": cuda_ms(torch, lambda: multi_head_attention(q, k, v, kv_mask=mask),
                                  max(1, REPS // 5)),
              "library_ms": cuda_ms(torch, fwd_lib, REPS),
              "bound_ms": f_ms, "bound_by": f_by,
              "device_ms": device_ms(torch, fwd, REPS, ("flash_short_fwd_f32_kernel",)),
              "library_device_ms": device_ms(torch, fwd_lib, REPS)}
    row_k4 = {"shape": shape, "ms": cuda_ms(torch, bwd, REPS),
              "plain_ms": cuda_ms(torch, lambda: flash_bwd_plain(
                  q, k, v, do, out.detach(), kv_mask=mask), max(1, REPS // 5)),
              "library_ms": cuda_ms(torch, bwd_lib, REPS),
              "bound_ms": g_ms, "bound_by": g_by,
              "device_ms": device_ms(torch, bwd, REPS, ("flash_short_bwd_f32_kernel",)),
              "library_device_ms": device_ms(torch, bwd_lib, REPS)}
    for name, r in (("K3 forward", row_k3), ("K4 backward", row_k4)):
        print(f"probing times: {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']}); card busy: kernel "
              f"{r['device_ms']:.4f} ms, sdpa {r['library_device_ms']:.4f} ms", flush=True)

    k5 = {"name": "flash_attention_packed wo= (K5 fused projection forward)",
          "route": "cuda", "source": PROJ_SOURCE, "replaces": K5_REPLACES,
          "launches": counts["K5"], "max_abs_err": errs["K5"],
          "bwd_max_abs_err": errs["K5_bwd"],
          "partial_freeze_launches": partial_counts["K5"]}
    k5.update({key: rows[0][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "device_ms")})
    k5["shapes"] = rows
    return k5, row_k3, row_k4


# --------------------------------------------------------------------------- #
# phases 16 to 19: sequence-parallel ring attention (K6) and the ring train step


def ring_mesh(torch, n, devices=None):
    from deepcoro_clip_tpu_torch.parallel import MeshSpec, make_mesh

    return make_mesh(MeshSpec(data=1, model=n),
                     devices=devices or [torch.device("cuda", 0)] * n)


def ring_inputs(torch, L, seed):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(RING_B, RING_H, L, RING_DH, generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(3)]


def _rel_l2(a, r) -> float:
    import torch

    return float(torch.linalg.vector_norm(a.float() - r.float())
                 / torch.linalg.vector_norm(r.float()))


def phase_ring_kernel(torch) -> dict:
    """Path A: joint attention over a study's 10 clips at flagship head
    width, q/k/v [2, 4, 15680, 128] bf16 over 4 shards on the card (Lc 3920),
    through ring_attention(backend="rdma"); K6 against its plain version and
    the "xla" ring, bit-equal run to run; over the real cards as well where
    there are several."""
    from deepcoro_clip_tpu_torch.ops import _ring_cuda
    from deepcoro_clip_tpu_torch.parallel import ring_attention

    q, k, v = ring_inputs(torch, RING_L, seed=11)
    mesh = ring_mesh(torch, RING_SHARDS)
    with torch.no_grad():
        ring_attention.launches = 0
        out = ring_attention(q, k, v, mesh, backend="rdma")  # the main path
        torch.cuda.synchronize()
        launches = ring_attention.launches
        again = ring_attention(q, k, v, mesh, backend="rdma")
        plain = ring_attention(q, k, v, mesh, backend="rdma_interpret")
        xla = ring_attention(q, k, v, mesh, backend="xla")
        torch.cuda.synchronize()
    shape = f"[{RING_B},{RING_H},{RING_L},{RING_DH}] bf16 over {RING_SHARDS} shards"
    print(f"ring path: launches {launches} in one call (n x n = "
          f"{RING_SHARDS * RING_SHARDS}: one per shard per ring step)", flush=True)
    check(launches == RING_SHARDS * RING_SHARDS,
          f"K6 launched {launches} times in one call, expected {RING_SHARDS ** 2}")
    check(torch.equal(out, again), "two K6 calls on the same inputs differ")
    err = check_forward(torch, "ring check", f"K6 {shape} vs its plain version", out, plain)
    err_xla = check_forward(torch, "ring check", f"K6 {shape} vs the xla ring", out, xla)
    l2 = (_rel_l2(out, plain), _rel_l2(out, xla))
    print(f"ring check: rel l2 {l2[0]:.3e} (plain), {l2[1]:.3e} (xla), bar "
          f"{RING_L2_REL}; max|plain| {float(plain.float().abs().max()):.3e}; two calls "
          f"bit-equal ok", flush=True)
    check(max(l2) <= RING_L2_REL, f"K6 rel l2 {l2} above {RING_L2_REL}")
    kernels = check_route(torch, f"ring path {shape}",
                          lambda: ring_attention(q, k, v, mesh, backend="rdma"),
                          ("ring_step_sm90_kernel",), ("ring_step_kernel",))
    cards = torch.cuda.device_count()
    result = {"launches": launches, "max_abs_err": max(err, err_xla), "rel_l2": max(l2),
              "cards": cards, "kernels": kernels}
    if cards > 1 and RING_L % cards == 0:
        devs = [torch.device("cuda", i) for i in range(cards)]
        with torch.no_grad():
            many = ring_attention(q, k, v, ring_mesh(torch, cards, devs), backend="rdma")
            one = (out if cards == RING_SHARDS else
                   ring_attention(q, k, v, ring_mesh(torch, cards), backend="rdma"))
            torch.cuda.synchronize()
        same = torch.equal(many, one)
        result["peer_access"] = {f"{a}->{b}": ok for (a, b), ok in
                                 sorted(_ring_cuda.peer_access.items())}
        print(f"ring check: over {cards} cards (peer copies: {result['peer_access']}) "
              f"bit-equal to {cards} shards on one card: {same}", flush=True)
        check(same, "the ring over the cards differs from the same shards on one card")
    return result


def phase_ring_grads(torch) -> float:
    """Gradients through backend="rdma" (K6 forward, the xla ring's
    backward) against the plain ring's at [2, 4, 6272, 128] (4 clips)."""
    from deepcoro_clip_tpu_torch.parallel import ring_attention

    q, k, v = ring_inputs(torch, RING_GRAD_L, seed=12)
    do = ring_inputs(torch, RING_GRAD_L, seed=13)[0]
    mesh = ring_mesh(torch, RING_SHARDS)
    grads = {}
    for backend in ("rdma", "xla"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ring_attention(*leaves, mesh, backend=backend)
        grads[backend] = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    worst = max(_rel_check("ring gradients", f"d{w} through rdma", a, r)
                for w, a, r in zip("qkv", grads["rdma"], grads["xla"]))
    same = all(torch.equal(a, r) for a, r in zip(grads["rdma"], grads["xla"]))
    print(f"ring gradients [{RING_B},{RING_H},{RING_GRAD_L},{RING_DH}] over {RING_SHARDS} "
          f"shards: rdma vs the plain ring max|d| {worst:.3e} (bars: {BWD_MAX_REL} of "
          f"max|plain|, rel l2 {BWD_L2_REL}); bit-equal: {same}", flush=True)
    return worst


def _copy_overlap(torch, fn) -> tuple:
    """One call of ``fn`` under torch.profiler: (share of the device time of
    the device-to-device copies that lies under a K6 step kernel, copy ms)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    copies, steps = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if "Memcpy" in e.name:
            copies.append(span)
        elif "ring_step" in e.name:
            steps.append(span)
    total = sum(b - a for a, b in copies)
    if not total:
        return None, 0.0
    covered = 0.0
    for a, b in copies:
        spans = sorted((max(a, s), min(b, t)) for s, t in steps if s < b and t > a)
        end = a
        for s, t in spans:  # the union of the kernels' spans inside the copy
            if t > end:
                covered += t - max(s, end)
                end = t
    return covered / total, total / 1e3


def phase_ring_times(torch, ring) -> dict:
    """K6 at n = 1, 2, 4 shards on the card against its bound, its plain
    version and SDPA over the whole unsharded q/k/v (a yardstick only)."""
    import torch.nn.functional as F

    from deepcoro_clip_tpu_torch.parallel import ring_attention

    from types import SimpleNamespace

    from deepcoro_clip_tpu_torch.ops import _ring_cuda

    q, k, v = ring_inputs(torch, RING_L, seed=14)
    rows = []
    B, H, L, Dh = RING_B, RING_H, RING_L, RING_DH
    meshes = [(n, ring_mesh(torch, n), f"{n} shard(s) on one card")
              for n in (1, 2, RING_SHARDS)]
    cards = torch.cuda.device_count()
    if cards > 1 and L % cards == 0:  # q/k/v start and end on card 0
        devs = [torch.device("cuda", i) for i in range(cards)]
        meshes.append((cards, ring_mesh(torch, cards, devs), f"{cards} cards"))
    with torch.no_grad():
        for n, mesh, where in meshes:

            def kern(mesh=mesh):
                return ring_attention(q, k, v, mesh, backend="rdma")

            # the pass through ring_fwd itself, on the same shards, without
            # ring_attention's sharding and gather
            devs = mesh.devices_along("model")
            shards = [[t.chunk(n, dim=2)[i].to(devs[i]) for i in range(n)] for t in (q, k, v)]
            outs = [torch.empty_like(t) for t in shards[0]]

            def direct(shards=shards, outs=outs):
                _ring_cuda.ring_fwd(*shards, outs, RING_DH ** -0.5,
                                    SimpleNamespace(launches=0))

            def enqueue_us():  # host time to enqueue a pass, per step launch
                best = math.inf
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    direct()
                    best = min(best, time.perf_counter() - t0)
                torch.cuda.synchronize()
                return best / (n * n) * 1e6

            # each shard's q, k, v and output once, plus the chunks the ring moves
            nbytes = 4 * B * H * L * Dh * 2 + (n - 1) * 2 * B * H * L * Dh * 2
            b_ms, b_by = bound(4 * B * H * L * L * Dh, nbytes)
            overlap, copy_ms = _copy_overlap(torch, kern) if n > 1 else (None, 0.0)
            row = {"shape": f"[{B},{H},{L},{Dh}] bf16, {where}",
                   "shards": n, "launches_per_call": n * n,
                   "ms": cuda_ms(torch, kern, REPS),
                   "ring_fwd_ms": cuda_ms(torch, direct, REPS),
                   "enqueue_us_per_launch": enqueue_us(),
                   "plain_ms": cuda_ms(torch, lambda mesh=mesh: ring_attention(
                       q, k, v, mesh, backend="rdma_interpret"), max(1, REPS // 5)),
                   "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                       q, k, v), REPS),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "device_ms": device_ms(torch, kern, REPS, ("ring_step_sm90_kernel",)),
                   "library_device_ms": device_ms(
                       torch, lambda: F.scaled_dot_product_attention(q, k, v), REPS),
                   "copy_ms": copy_ms, "copy_overlap": overlap}
            direct()
            torch.cuda.synchronize()
            check(torch.equal(torch.cat([o.to(q.device) for o in outs], dim=2), kern()),
                  "K6 through ring_fwd differs from ring_attention's pass")
            rows.append(row)
            del shards, outs
            torch.cuda.empty_cache()
            print(f"ring times: K6 {row['shape']}: kernel {row['ms']:.3f} ms "
                  f"({row['launches_per_call']} launches; through ring_fwd "
                  f"{row['ring_fwd_ms']:.3f} ms, bit-equal; host enqueue "
                  f"{row['enqueue_us_per_launch']:.1f} us a step launch), plain "
                  f"{row['plain_ms']:.3f} ms, "
                  f"sdpa (whole q/k/v) {row['library_ms']:.3f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}); card busy: kernel "
                  f"{row['device_ms']:.3f} ms, sdpa {row['library_device_ms']:.3f} ms; "
                  f"slot copies {copy_ms:.3f} ms, share under a step kernel "
                  + ("n/a" if overlap is None else f"{overlap:.2f}"), flush=True)
    head = rows[2]  # the main path's shards
    e = {"name": "ring_attention backend=rdma (K6 ring forward: ring_step_sm90_kernel)",
         "route": "cuda", "source": RING_SOURCE, "replaces": K6_REPLACES,
         "launches": ring["launches"], "max_abs_err": ring["max_abs_err"],
         "rel_l2": ring["rel_l2"], "bwd_max_abs_err": ring["bwd_max_abs_err"],
         "kernels": ring["kernels"]}
    e.update({key: head[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "device_ms", "copy_overlap")})
    if "peer_access" in ring:
        e["peer_access"] = ring["peer_access"]
    e["shapes"] = rows
    return e


def phase_ring_training(torch) -> dict:
    """Path B: the contrastive train step with use_ring_attention over a
    mesh of 3 shards on the card (3 divides 1569 and 393: all 12 backbone
    blocks take the ring, its "xla" backend); 1 warm-up and 3 timed steps;
    the loss on the repeated batch falls; same weights in eval mode, the
    video embeddings through the ring against the dense kernel path."""
    from deepcoro_clip_tpu_torch.models.video_encoder import (
        init_params,
        video_encoder_from_config,
    )
    from deepcoro_clip_tpu_torch.train.clip import (
        build_clip_bundle,
        make_eval_step,
        make_train_step,
        to_device_batch,
    )

    cfg = train_config(use_ring_attention=True)
    mesh = ring_mesh(torch, RING_TRAIN_SHARDS)
    t0 = time.perf_counter()
    bundle, state = build_clip_bundle(cfg, seed=0, steps_per_epoch=1, mesh=mesh)
    step_fn = make_train_step(bundle)
    batch = to_device_batch(bundle, train_batch(cfg, cfg.batch_size))
    gen = torch.Generator(device=bundle.device).manual_seed(0)
    eval_fn = make_eval_step(bundle)
    eval_before = float(eval_fn(state.params, batch)["loss"])
    print(f"ring training: bundle built in {time.perf_counter() - t0:.1f} s, mesh "
          f"{mesh.shape} on one card; {cfg.batch_size} studies x {cfg.num_videos} clips, "
          f"{cfg.max_text_length} tokens", flush=True)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(RING_TRAIN_WARMUP):
        state, m = step_fn(state, batch, gen, 0.0, 0.0, -1.0)
        losses.append(float(m["loss"]))
    _zero_kernel_counts()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    metrics = []
    for _ in range(RING_TRAIN_STEPS):
        state, m = step_fn(state, batch, gen, 0.0, 0.0, -1.0)
        metrics.append(m)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / RING_TRAIN_STEPS
    dev_ms = start.elapsed_time(end) / RING_TRAIN_STEPS
    counts = _kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses += [float(m["loss"]) for m in metrics]
    eval_after = float(eval_fn(state.params, batch)["loss"])
    print("ring training: losses " + " ".join(f"{x:.4f}" for x in losses), flush=True)
    print(f"ring training: launches over {RING_TRAIN_STEPS} steps: {counts} (per step "
          f"K1 12, K2 12 in the text tower, K3 2, K4 2 in the aggregator; the backbone "
          f"takes the xla ring)", flush=True)
    clips = cfg.batch_size * cfg.num_videos
    print(f"ring training: step {dev_ms:.1f} ms (CUDA events), {host_ms:.1f} ms (host "
          f"clock), {clips / dev_ms * 1e3:.1f} clips/s, peak memory {peak_gb:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)", flush=True)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss in {losses}")
    for key, per_step in (("K1", 12), ("K2", 12), ("K3", 2), ("K4", 2), ("K5", 0),
                          ("K6", 0)):
        check(counts[key] == per_step * RING_TRAIN_STEPS,
              f"{key} launched {counts[key]} times in {RING_TRAIN_STEPS} ring steps, "
              f"expected {per_step} per step")
    check(math.isfinite(eval_after) and eval_after < eval_before,
          f"the loss on the repeated batch did not fall: {eval_before} -> {eval_after}")
    print(f"ring training: loss on the repeated batch with dropout off {eval_before:.4f} "
          f"-> {eval_after:.4f}", flush=True)
    per_name, wall_ms = device_events(
        torch, lambda: step_fn(state, batch, gen, 0.0, 0.0, -1.0))
    print_profile("ring train profile", "one step", per_name, wall_ms, top=12)

    # same weights, eval mode: the ring against the dense kernel path
    dense = init_params(video_encoder_from_config(train_config()), 0).to(bundle.device)
    dense.load_state_dict(bundle.video_model.state_dict())
    with torch.no_grad():
        v_ring = bundle.video_model(batch["videos"], video_mask=batch["video_mask"])
        _zero_kernel_counts()
        v_dense = dense(batch["videos"], video_mask=batch["video_mask"])
        dense_counts = _kernel_counts()
    cos = torch.nn.functional.cosine_similarity(v_ring.float(), v_dense.float(), dim=-1)
    print(f"ring training: video embeddings (eval mode) through the ring vs the dense "
          f"kernel path ({dense_counts['K1']} K1 launches): min cosine "
          f"{float(cos.min()):.6f} (bar {E2E_MIN_COSINE})", flush=True)
    check(dense_counts["K1"] == 12, f"the dense path launched {dense_counts}")
    check(float(cos.min()) >= E2E_MIN_COSINE, f"ring vs dense cosine {float(cos.min())}")
    return {"step_ms": dev_ms, "step_host_ms": host_ms, "peak_gib": peak_gb,
            "shards": RING_TRAIN_SHARDS, "min_cosine_vs_dense": float(cos.min())}


# --------------------------------------------------------------------------- #
# phase 20: the short kernels of K3 and K4 (Lq, Lk <= 64) against their plain
# versions across the modes, and which kernels a call runs

SHORT_SOURCE = "deepcoro_clip_tpu_torch/csrc/flash_short.cu"
# the short fp32 kernels against the plain versions in fp32: exp2 with
# log2(e) folded into the scale, FMA contraction, sums in another order
SHORT_F32_L2_REL = 1e-5
SHORT_LENGTHS = (1, 4, 10, 11, 16, 17, 64)


def short_cases(dh: int):
    """(name, Lq, Lk, kwargs maker) of the grid: a key mask with one fully
    masked batch row at every length, causal, causal with a mask, cross
    attention and RoPE."""
    cases = [(f"mask L {n}", n, n, "mask") for n in SHORT_LENGTHS]
    cases += [("causal L 17", 17, 17, "causal"), ("causal + mask L 64", 64, 64, "causal_mask"),
              ("cross 1|64 + mask", 1, 64, "mask"), ("cross 37|50 + mask", 37, 50, "mask"),
              ("RoPE L 10", 10, 10, "rope")]
    return cases


def _short_grad_check(label: str, got, ref, fp32: bool) -> float:
    """dq, dk, dv against the plain gradients, each held to the largest
    plain gradient of the call (at Lk = 1 the exact dq and dk are 0 and the
    two sides' are rounding noise): bf16 by phase 7's bars, fp32 by a
    relative L2 of SHORT_F32_L2_REL. Returns max|kernel - plain|."""
    import torch

    top = max(float(r.float().abs().max()) for r in ref)
    norm = max(float(torch.linalg.vector_norm(r.float())) for r in ref)
    worst = 0.0
    for which, a, r in zip(("dq", "dk", "dv"), got, ref):
        d = a.float() - r.float()
        err, l2 = float(d.abs().max()), float(torch.linalg.vector_norm(d)) / max(norm, 1e-30)
        ok = bool(torch.isfinite(a).all()) and (
            l2 <= SHORT_F32_L2_REL if fp32 else (err <= BWD_MAX_REL * top and l2 <= BWD_L2_REL))
        check(ok, f"{label}: {which} disagrees with the plain version (max|d| {err:.3e}, "
                  f"rel l2 {l2:.3e} of the call's largest gradient)")
        worst = max(worst, err)
    return worst


def phase_short_kernels(torch) -> dict:
    """The short forward and backward against multi_head_attention and
    flash_bwd_plain over the grid, in bf16 and fp32 at Dh 64 and 128; two
    backward launches and a batch row alone (B = 1) against the batch of 3,
    bit for bit; the bf16 forward against the tile kernel
    flash_long_fwd_kernel on the same inputs by phase 3's bars (it sums in
    wgmma's order; the cases that come out bit-equal anyway are counted)."""
    from deepcoro_clip_tpu_torch.ops import _flash_cuda
    from deepcoro_clip_tpu_torch.ops.attention import flash_bwd_plain, multi_head_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    errs = {"fwd": {}, "bwd": {}}
    n_cases = n_tile_equal = n_bf16 = 0
    for dtype in (torch.bfloat16, torch.float32):
        fp32 = dtype == torch.float32
        for dh in (64, 128):
            t = build_rope3d_tables(dh, 1, 3, 3, n_special=1)  # L = 10
            rope = dict(sin=torch.from_numpy(t.sin).to(dev), cos=torch.from_numpy(t.cos).to(dev))
            for name, Lq, Lk, mode in short_cases(dh):
                B, H = 3, 4
                # as the layers hand them over: strided views of [B, L, 3D] / [B, L, 2D]
                q = torch.randn(B, Lq, H, dh, generator=g, device=dev).to(dtype).transpose(1, 2)
                kv = torch.randn(B, Lk, 2, H, dh, generator=g, device=dev).to(dtype)
                k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
                do = torch.randn(B, Lq, H, dh, generator=g, device=dev).to(dtype).transpose(1, 2)
                kw = {}
                if "mask" in mode:
                    m = torch.rand(B, Lk, generator=g, device=dev) > 0.3
                    m[:, 0] = True
                    m[1] = False  # no valid key: the uniform mean of v, dS = 0
                    kw["kv_mask"] = m
                if "causal" in mode:
                    kw["causal"] = True
                if mode == "rope":
                    kw.update(rope)
                label = f"short {str(dtype)[6:]} Dh {dh} {name}"

                def grads(sl):
                    leaves = [x[sl].clone().requires_grad_() for x in (q, k, v)]
                    kws = dict(kw)
                    if "kv_mask" in kws:
                        kws["kv_mask"] = kws["kv_mask"][sl]
                    out = flash_attention(*leaves, **kws)
                    a = torch.autograd.grad(out, leaves, do[sl], retain_graph=True)
                    b = torch.autograd.grad(out, leaves, do[sl])
                    check(all(torch.equal(x, y) for x, y in zip(a, b)),
                          f"{label}: two backward launches differ")
                    return out.detach(), a

                out, got = grads(slice(None))
                one_out, one = grads(slice(2, 3))
                check(torch.equal(out[2:3], one_out) and all(
                    torch.equal(x[2:3], y) for x, y in zip(got, one)),
                      f"{label}: batch row 2 alone differs from the batch of {B}")
                ref_out = multi_head_attention(q, k, v, **kw)
                ref = flash_bwd_plain(q, k, v, do, ref_out, **kw)
                torch.cuda.synchronize()
                if fp32:
                    d = out - ref_out
                    l2 = float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(ref_out))
                    check(bool(torch.isfinite(out).all()) and l2 <= SHORT_F32_L2_REL,
                          f"{label}: forward rel l2 {l2:.3e} > {SHORT_F32_L2_REL}")
                    ferr = float(d.abs().max())
                else:
                    ferr = check_forward(torch, "short check", label, out, ref_out)
                    tile = torch.empty_like(out)
                    _flash_cuda.flash_fwd(q, k, v, tile, scale=dh ** -0.5, causal=bool(
                        kw.get("causal")), kv_mask=kw.get("kv_mask"), sin=kw.get("sin"),
                        cos=kw.get("cos"))
                    torch.cuda.synchronize()
                    d = (tile.float() - out.float()).abs()
                    check(bool((d <= KERNEL_ATOL + KERNEL_RTOL * out.float().abs()).all()),
                          f"{label}: the short forward and the tile kernel differ by "
                          f"{float(d.max()):.3e}")
                    n_tile_equal += bool(torch.equal(tile, out))
                    n_bf16 += 1
                gerr = _short_grad_check(label, got, ref, fp32)
                if "kv_mask" in kw:  # the fully masked batch row: no gradient through scores
                    check(float(got[0][1].abs().max()) == 0.0
                          and float(got[1][1].abs().max()) == 0.0,
                          f"{label}: a fully masked row passed a gradient through its scores")
                key = f"{str(dtype)[6:]} Dh {dh}"
                errs["fwd"][key] = max(errs["fwd"].get(key, 0.0), ferr)
                errs["bwd"][key] = max(errs["bwd"].get(key, 0.0), gerr)
                n_cases += 1
    print(f"short check: {n_cases} cases (bf16 and fp32, Dh 64 and 128, L in "
          f"{SHORT_LENGTHS}, causal, cross 1|64 and 37|50, RoPE, a fully masked row) "
          f"within the bars (bf16: phase 3's and phase 7's; fp32: rel l2 "
          f"{SHORT_F32_L2_REL}); two backward launches and B = 1 against B = 3 bit-equal; "
          f"bf16 forward within phase 3's bars of the tile kernel flash_long_fwd_kernel in "
          f"all {n_bf16} cases, bit-equal in {n_tile_equal}", flush=True)
    for key in errs["fwd"]:
        print(f"short check {key}: max|kernel-plain| forward {errs['fwd'][key]:.3e}, "
              f"gradients {errs['bwd'][key]:.3e}", flush=True)
    errs["tile_equal"] = f"{n_tile_equal} of {n_bf16}"
    return errs


def short_routes(torch) -> dict:
    """Which kernels a call runs, from profiler traces: at the main paths'
    shapes (operands as the layers hand them over, a bool key mask) the K3
    forward and the K4 backward are one short kernel each, with no mask
    conversion; at L = 65 the long Hopper kernels run."""
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    routes = {"K3": [], "K4": []}
    for B, L, dtype, sfx in ((4, 10, torch.bfloat16, "bf16"), (8, 4, torch.bfloat16, "bf16"),
                             (8, 11, torch.float32, "f32"), (2, 65, torch.bfloat16, None)):
        qkv = torch.randn(B, L, 3 * 512, generator=g, device=dev).to(dtype)
        q, k, v = (t.unflatten(2, (8, 64)).transpose(1, 2) for t in qkv.split(512, -1))
        m = torch.ones(B, L, dtype=torch.bool, device=dev)
        m[0, L // 2:] = False
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, kv_mask=m)
        do = torch.randn(B, L, 8, 64, generator=g, device=dev).to(dtype).transpose(1, 2)
        label = f"[{B},8,{L},64] {str(dtype)[6:]} + mask"
        fwd = _launches(torch, lambda: flash_attention(q, k, v, kv_mask=m))
        bwd = _launches(torch, lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
        if fwd is None or bwd is None:
            print(f"short routes {label}: not traced (the profiler traced no device event)",
                  flush=True)
            continue
        if sfx:
            want_f, want_b = f"flash_short_fwd_{sfx}_kernel", f"flash_short_bwd_{sfx}_kernel"
            check(len(fwd) == 1 and want_f in fwd[0],
                  f"K3 {label}: expected the one kernel {want_f}, ran {fwd}")
            check(len(bwd) == 1 and want_b in bwd[0],
                  f"K4 {label}: expected the one kernel {want_b}, ran {bwd}")
        else:  # past SHORT_MAX: the long Hopper kernels, no short kernel
            ours = [[n for n in run if n.startswith(PORT_KERNELS)] for run in (fwd, bwd)]
            check(ours == [list(TILE_FWD), list(TILE_BWD)],
                  f"{label}: expected the long Hopper kernels, ran {fwd} / {bwd}")
        print(f"short routes {label}: forward ran {fwd} ({len(fwd)} kernel(s)); backward "
              f"ran {bwd} ({len(bwd)} kernel(s))", flush=True)
        routes["K3"] += [n for n in fwd if n not in routes["K3"]]
        routes["K4"] += [n for n in bwd if n not in routes["K4"]]
    return routes


def check_main_path_kernels(label: str, per_name, want, not_want) -> None:
    """The kernels of a profiled main-path pass: each of ``want`` ran, none
    of ``not_want``; a trace with no device event is "not traced"."""
    if not per_name:
        print(f"{label}: not traced (the profiler traced no device event); the wrappers' "
              f"counters hold the launches", flush=True)
        return
    names = list(per_name)
    for w in want:
        check(any(w in n for n in names), f"{label}: {w} did not run")
    for w in not_want:
        check(not any(w in n for n in names), f"{label}: {w} ran")
    print(f"{label}: ran {', '.join(want)}; not {', '.join(not_want)}", flush=True)


# --------------------------------------------------------------------------- #
# phase 21: where the time of one K3 or K4 call goes, at the main paths' shapes

HOST_REPS = 100  # calls per host-clock reading
SHORT_CASES = (  # (K3 forward and, with grad, K4 backward) as the paths call them
    ("serving aggregator", 4, 10, "bfloat16", False),
    ("training aggregator", 8, 4, "bfloat16", True),
    ("probing CLS block", 8, 11, "float32", True),
)


def host_us(torch, fn, reps: int = HOST_REPS) -> float:
    """Host time per call of ``fn`` (perf_counter around ``reps`` calls, no
    synchronisation inside), in microseconds; the card drains after."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _breakdown(torch, fc, q, k, v, m, do, leaves, out, bwd: bool) -> dict:
    """Host microseconds per call of the steps of one forward (or, with
    ``bwd``, backward) of the [B, H, L, Dh] entry, each timed alone as the
    wrapper of this tree runs it: checks, mask conversion, allocations,
    stream lookup, argument packing, the ctypes call without a launch (the C
    entry refused at once for a head dim it does not take) and with it, and
    the autograd Function's share."""
    import ctypes

    B, H, Lq, Dh = q.shape
    dev, dt = q.device, q.dtype
    scale = Dh ** -0.5
    new = hasattr(fc, "short_args")  # this tree's lean host path
    # (an older tree's bwd_symbol takes no head dim)
    dh = (Dh,) if "Dh" in inspect.signature(fc.bwd_symbol).parameters else ()
    r = {}
    stream = torch.cuda.current_stream(dev).cuda_stream
    lookup = getattr(fc, "_raw_stream", lambda d: torch.cuda.current_stream(d).cuda_stream)
    r["stream lookup"] = host_us(torch, lambda: lookup(dev))
    ops = (q, k, v, do) if bwd else (q, k, v)
    if new:
        if bwd:
            r["checks"] = host_us(torch, lambda: (
                fc._aligned(do), fc._check_operand("do", do, dev, dt),
                fc.bwd_symbol(dt, False, Lq, k.shape[2], *dh)))
        else:
            r["checks"] = host_us(torch, lambda: (
                fc._check_problem(q, k, v, None, None, m),
                [fc._short_operand("x", t, dev, dt) for t in (q, k, v)],
                fc.fwd_symbol(dt, False, Lq, k.shape[2], Dh)))
        r["mask"] = host_us(torch, lambda: fc.mask_arg(m, strided=True))
        if bwd:
            r["allocations"] = host_us(torch, lambda: [torch.empty_like(
                t, memory_format=torch.contiguous_format) for t in (q, k, v)])
            g3 = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in (q, k, v)]
            kw = dict(do=do, dq=g3[0], dk=g3[1], dv=g3[2])
        else:
            r["allocations"] = host_us(torch, lambda: torch.empty(
                (B, H, Lq, Dh), dtype=dt, device=dev))
            kw = {}
        o = out.detach() if bwd else torch.empty_like(q, memory_format=torch.contiguous_format)
        r["argument packing"] = host_us(torch, lambda: fc.short_args(
            q, k, v, o, sin=None, cos=None, mask=m, causal=False, stream=stream, **kw))
        symbol = (fc.bwd_symbol(dt, False, Lq, k.shape[2], *dh) if bwd
                  else fc.fwd_symbol(dt, False, Lq, k.shape[2], Dh))
        fn = fc._short_fn(symbol)
        good = fc.short_args(q, k, v, o, sin=None, cos=None, mask=m, causal=False,
                             stream=stream, **kw)
        bad = bytearray(good)
        struct.pack_into("q", bad, 8 * fc.A_DH, 96)
        bad = bytes(bad)
        r["ctypes call, refused"] = host_us(torch, lambda: fn(bad, scale))
        r["ctypes call + launch"] = host_us(torch, lambda: fn(good, scale))
    else:
        mask8 = (m != 0).to(torch.uint8).contiguous()
        nop = len(ops) + (4 if bwd else 1)  # the outputs are checked too
        r["checks"] = host_us(torch, lambda: (fc._check_problem(q, k, v, None, None, None), [
            fc._check_operand("x", t, dev, dt) for t in (ops + (q,) * (nop - len(ops)))]))
        r["mask"] = host_us(torch, lambda: (m != 0).to(torch.uint8).contiguous())
        lq_pad = -(-Lq // fc.TILE) * fc.TILE
        if bwd:
            r["allocations"] = host_us(torch, lambda: (
                torch.empty((3, B, H, lq_pad), dtype=torch.float32, device=dev),
                [torch.empty_like(t, memory_format=torch.contiguous_format) for t in (q, k, v)]))
            stats = torch.empty((2, B, H, Lq), dtype=torch.float32, device=dev)
            fc.flash_fwd(q, k, v, torch.empty_like(q), sin=None, cos=None, kv_mask=m,
                         causal=False, scale=scale, stats=stats)
            rows = torch.empty((3, B, H, lq_pad), dtype=torch.float32, device=dev)
            g3 = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in (q, k, v)]
            fn = fc._bwd_fn(dt, False)

            def args(dh):
                return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        do.data_ptr(), stats.data_ptr(), None, None, mask8.data_ptr(),
                        *(t.data_ptr() for t in g3), rows.data_ptr(), None, None,
                        B, H, Lq, k.shape[2], dh, *q.stride()[:3], *k.stride()[:3],
                        *v.stride()[:3], *out.stride()[:3], *do.stride()[:3],
                        *g3[0].stride()[:3], *g3[1].stride()[:3], *g3[2].stride()[:3],
                        scale, 0, stream)
        else:
            r["allocations"] = host_us(torch, lambda: torch.empty(
                (B, H, Lq, Dh), dtype=dt, device=dev))
            o = torch.empty_like(q)
            fn = fc._fwd_fn(dt, False)

            def args(dh):
                return (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, None,
                        mask8.data_ptr(), None, None, B, H, Lq, k.shape[2], dh,
                        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                        scale, 0, stream)
        r["argument packing"] = host_us(torch, lambda: args(Dh))
        good, bad = args(Dh), args(96)
        r["ctypes call, refused"] = host_us(torch, lambda: fn(*bad))
        r["ctypes call + launch"] = host_us(torch, lambda: fn(*good))
    # the autograd Function's share: the public call minus the same work called directly
    if bwd:
        public = host_us(torch, lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
        if new:
            direct = host_us(torch, lambda: fc.short_backward(
                q, k, v, out.detach(), do, None, None, m, False, scale))
        else:
            st = out.grad_fn.saved_tensors[4]  # the row statistics
            direct = host_us(torch, lambda: fc.attention_backward(
                *(t.detach() for t in leaves), out.detach(), st, do, None, None, m, False,
                scale, "heads", H, fc_counter()))
    elif new:
        public = host_us(torch, lambda: fc.ShortAttention.apply(
            *leaves, None, None, m, False, scale, fc_counter()))
        direct = host_us(torch, lambda: fc.short_forward(q, k, v, None, None, m, False, scale))
    else:
        public = host_us(torch, lambda: fc.FlashAttention.apply(
            *leaves, None, None, m, False, scale, "heads", H, fc_counter()))
        direct = host_us(torch, lambda: fc.attention_forward(
            q, k, v, None, None, m, False, scale, "heads", H, fc_counter(), stats=True))
    r["autograd Function"] = public - direct
    return r


class _Counter:
    launches = bwd_launches = long_launches = long_bwd_launches = 0


def fc_counter():
    return _Counter


def phase_host(torch) -> list:
    """For each main-path case of K3 and K4: (a) the host's enqueue per call,
    (b) the time between CUDA events per call, (c) the card's busy time per
    call (profiler), (d) the device kernels a call runs, by name, (e) the
    host-time breakdown of one call; and (f) the launch floor: the same for
    a one-element in-place add. It runs in a process of its own
    (``--host-only``), as it does in an older tree it is copied into, so
    that both are read the same way; the host clock readings (a, b, e) come
    before any profiler session, and (a) again after them."""
    from deepcoro_clip_tpu_torch.ops import _flash_cuda as fc
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(22)
    rows, calls = [], []
    x = torch.zeros(1, device=dev)
    rows.append({"case": "launch floor: x.add_(1), x one fp32 element", "kind": "floor",
                 "host_us": host_us(torch, lambda: x.add_(1)),
                 "events_ms": cuda_ms(torch, lambda: x.add_(1), REPS)})
    calls.append(lambda: x.add_(1))
    for name, B, L, dtype_name, with_bwd in SHORT_CASES:
        dt = getattr(torch, dtype_name)
        qkv = torch.randn(B, L, 3 * 512, generator=g, device=dev).to(dt)
        q, k, v = (t.unflatten(2, (8, 64)).transpose(1, 2) for t in qkv.split(512, -1))
        m = torch.ones(B, L, dtype=torch.bool, device=dev)
        m[1, L // 2:] = False
        do = torch.randn(B, L, 8, 64, generator=g, device=dev).to(dt).transpose(1, 2)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, kv_mask=m)
        shape = f"[{B},8,{L},64] {dtype_name} + mask"

        def fwd(q=q, k=k, v=v, m=m):
            with torch.no_grad():
                return flash_attention(q, k, v, kv_mask=m)

        def bwd(out=out, leaves=leaves, do=do):
            return torch.autograd.grad(out, leaves, do, retain_graph=True)

        for kind, fn in (("K3 forward", fwd), ("K4 backward", bwd))[:2 if with_bwd else 1]:
            for _ in range(HOST_REPS):  # the interpreter and the clocks settle
                fn()
            torch.cuda.synchronize()
            rows.append({"case": f"{kind} {shape} ({name})", "kind": kind[:2],
                         "host_us": host_us(torch, fn), "events_ms": cuda_ms(torch, fn, REPS),
                         "breakdown_us": _breakdown(torch, fc, q, k, v, m, do, leaves, out,
                                                    kind.startswith("K4"))})
            calls.append(fn)
    for r, fn in zip(rows, calls):  # the profiler, last
        r["kernels"] = _launches(torch, fn) or []
        r["kernels_per_call"] = len(r["kernels"])
        r["busy_ms"] = device_ms(torch, fn, REPS, tuple(
            n for n in r["kernels"] if n.startswith(PORT_KERNELS)))
    # the host's enqueue again, now that the profiler has run in this process
    for r, fn in zip(rows, calls):
        r["host_us_after_profiler"] = host_us(torch, fn)
    for r in rows:
        extra = ""
        if "breakdown_us" in r:
            extra = "; host breakdown (us): " + ", ".join(
                f"{k} {v:.2f}" for k, v in r["breakdown_us"].items())
            extra = f"; {r['kernels_per_call']} device kernel(s) a call" + extra
        print(f"host time {r['case']}: enqueue {r['host_us']:.2f} us a call "
              f"({r['host_us_after_profiler']:.2f} after the profiler ran), between CUDA "
              f"events {r['events_ms']:.4f} ms, card busy {r['busy_ms']:.4f} ms; kernels "
              f"{r['kernels']}{extra}", flush=True)
    return rows


def phase_host_process() -> list:
    """Phase 21 in a fresh process (``--host-only``), whose lines it prints;
    returns its rows."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--host-only"],
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-2]:
        print(f"phase 21 | {line}", flush=True)
    check(proc.returncode == 0 and len(lines) >= 2,
          f"phase 21 failed (exit {proc.returncode}): {proc.stderr[-2000:]}")
    return json.loads(lines[-2])["host"]


def _launches(torch, fn, calls: int = 10) -> list:
    """The device kernels (not copies) of one call of ``fn``, one entry per
    launch, from a profiler trace of ``calls`` calls: the launches of the
    first call, after checking that every call made as many. On the H100
    machine the profiler now and then traces no device event in a short
    window, or drops one (9 kernels of 10 one-kernel calls; once two empty
    windows and then such a one in a row). So the window holds several
    calls and is traced again, up to TRACE_TRIES times, when it comes back empty
    (then with twice the calls, up to 16 times as many: phase 26 once traced
    seven empty windows of two calls in a row), when it holds fewer port
    kernels than the wrappers counted launches in the window (each launch
    runs at least one; once the profiler kept a mask conversion of both
    calls and dropped both long K3 forwards, an even window that read as a
    call without its kernel), or when it is uneven
    only because the profiler saw fewer events of a port kernel than the
    wrappers' counters say were launched in the window (each port kernel
    runs once a wrapper launch). Any other uneven window fails the check.
    None when no window traced a device event ("not traced")."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    tries, most = _windows(), 16 * calls
    for attempt in range(1, tries + 1):
        before = sum(_kernel_counts().values())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        launched = sum(_kernel_counts().values()) - before
        names = [_short_name(e.name) for e in sorted(
            (e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and "Memcpy" not in e.name and "Memset" not in e.name),
            key=lambda e: e.time_range.start)]
        traced = sum(n.startswith(PORT_KERNELS) for n in names)
        if not names:
            print(f"launches: no device event traced in {calls} calls (the wrappers "
                  f"counted {launched} launches)", flush=True)
            calls = min(2 * calls, most)
            continue
        if traced < launched:
            print(f"launches: {traced} port kernels traced in {calls} calls, fewer than "
                  f"the {launched} launches the wrappers counted: a dropped profiler "
                  f"event" + (", traced again" if attempt < tries else ""), flush=True)
            continue
        if len(names) % calls == 0:
            break
        seen = Counter(names)
        ours = [c for n, c in seen.items() if n.startswith(PORT_KERNELS)]
        dropped = (ours and max(ours) <= launched and min(ours) < launched
                   and all(c % calls == 0 for n, c in seen.items()
                           if not n.startswith(PORT_KERNELS)))
        print(f"launches: {len(names)} kernels traced in {calls} calls, the wrappers "
              f"counted {launched} launches: "
              + ("uneven" if not dropped else "a dropped profiler event"
                 + (", traced again" if attempt < tries else "")), flush=True)
        if not dropped:
            break
    if not _traced(bool(names), fn, tries):
        return None
    check(len(names) % calls == 0 and traced >= launched,
          f"{len(names)} kernels in {calls} calls ({launched} wrapper launches counted, "
          f"{traced} port kernels traced): {names}")
    return names[:len(names) // calls]


# the port's own kernels, by their short names: each runs once a launch its
# wrapper counts
PORT_KERNELS = ("flash_", "bwd_rows_", "ring_")
# K2's row pre-pass and two Hopper kernels; K3's and K4's long Hopper
# kernels (Lq or Lk > 64) at the main paths' Dh 64, with K4's row pre-pass
K2_KERNELS = ("bwd_rows_kernel", "flash_bwd_dkv_sm90_kernel", "flash_bwd_dq_sm90_kernel")
TILE_FWD = ("flash_long_fwd_kernel<64>",)
TILE_BWD = ("bwd_rows_kernel<64, 8>", "flash_long_bwd_dkv_kernel<64>",
            "flash_long_bwd_dq_kernel<64>")
TILE_KERNELS = TILE_FWD + TILE_BWD
LONG_SOURCES = {"K3": "deepcoro_clip_tpu_torch/csrc/flash_fwd.cu",
                "K4": "deepcoro_clip_tpu_torch/csrc/flash_bwd.cu"}


def _use_tree_kernel_names() -> None:
    """The long K3/K4 kernels' names in the tree this script runs against:
    this tree's Hopper kernels, or an older tree's mma.sync tile kernels;
    and the fp32 forward's and backward's: the register-tiled kernels, or
    an older tree's SIMT ones; the wide bf16 forwards' and backward's: the
    Hopper kernels, or an older tree's SIMT ones (the A B B A call copies
    the script into the parent's tree)."""
    from deepcoro_clip_tpu_torch.ops import _flash_cuda

    global TILE_FWD, TILE_BWD, TILE_KERNELS, REGTILE_FWD, REGTILE_PROJ, REGTILE_BWD
    if not hasattr(_flash_cuda, "visit_keys"):
        TILE_FWD = ("flash_fwd_kernel<64>",)
        TILE_BWD = ("bwd_rows_kernel<64>", "flash_bwd_dkv_kernel<64>",
                    "flash_bwd_dq_kernel<64>")
        TILE_KERNELS = TILE_FWD + TILE_BWD
    if not hasattr(_flash_cuda, "regtile_smem_bytes"):  # the fp32 forward on the SIMT kernels
        REGTILE_FWD, REGTILE_PROJ = SIMT_FWD["float32"], SIMT_PROJ["float32"]
    if not hasattr(_flash_cuda, "regtile_bwd_smem_bytes"):  # the fp32 backward on the SIMT ones
        REGTILE_BWD = SIMT_BWD["float32"][1:]
    if not hasattr(_flash_cuda, "wide_smem_bytes"):  # the wide bf16 forwards on the SIMT ones
        SIMT_FWD["bfloat16"], SIMT_PROJ["bfloat16"] = WIDE_OLD[:1], WIDE_OLD[1:2]
    if not hasattr(_flash_cuda, "wide_bwd_smem_bytes"):  # the wide bf16 backward on the SIMT ones
        SIMT_BWD["bfloat16"] = WIDE_OLD_BWD


def _short_name(name: str) -> str:
    """A kernel's name without namespace, return type and arguments."""
    return name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]


def build_kernels(torch, sources) -> None:
    """nvcc for the sources side by side, with their ptxas lines."""
    from deepcoro_clip_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all(sources)  # one nvcc each, side by side
    for name in sources:
        _build.load(name)
        info = _build.build_info.get(name, {})
        print(f"build: {name}.cu ready {time.perf_counter() - t0:.1f} s after the "
              f"start (nvcc {info.get('seconds', 0.0):.1f} s)", flush=True)
        for line in info.get("log", "").splitlines():
            if "Compiling entry" in line:
                fn = line.split("'")[1]
                print(f"build: ptxas {name}: {fn[fn.index('_cu_') + 13:][:56]}", flush=True)
            elif "registers" in line or "spill" in line:
                print(f"build: ptxas   {line.strip()}", flush=True)


# --------------------------------------------------------------------------- #
# phase 22: the contrastive training run through main, at the flagship
# quality recipe, on a rendered corpus

QUALITY_TRAIN, QUALITY_VAL = 48, 16  # clips of the rendered corpus
QUALITY_WORKERS = 4
# launches per train step, per eval batch and per bank chunk of 64 reports:
# K1 / K2 in the 12 video blocks, K3 / K4 in the 12 text layers (L = 128,
# the tile kernels) and the aggregator's 2 blocks (L = 1, the short kernels)
# ("K3 long", "K4 long": those of them on the long Hopper kernels)
QUALITY_PER_STEP = {"K1": 12, "K2": 12, "K3": 14, "K4": 14, "K5": 0, "K6": 0,
                    "K3 long": 12, "K4 long": 12}
QUALITY_PER_EVAL = {"K1": 12, "K2": 0, "K3": 14, "K4": 0, "K5": 0, "K6": 0,
                    "K3 long": 12, "K4 long": 0}
QUALITY_PER_BANK = {"K1": 0, "K2": 0, "K3": 12, "K4": 0, "K5": 0, "K6": 0,
                    "K3 long": 12, "K4 long": 0}
# phases 33 and 38 run the towers at this depth (full width, the pool at
# block 3 kept; each against its own world-1 step at the same depth), so
# that the script stays within its time limit on the slower machines.
# (Phases 32 and 37 stay at 12: at 4, phase 37's grad_norm from the same
# weights read 8.8e-3 off world 1's, past its bar of 5e-3, set at 12 blocks
# where it read 3.9e-4: a rank's bf16 partial products add a rounding that
# the shallow random model amplifies more.)
MP_DEPTH = 4
CARD = ""  # nvidia-smi's name and power limit, set by main()


def quality_train_config(**over):
    """config/quality/flagship_quality_train.yaml, field by field (a CPU test
    holds this dict equal to the YAML as the port's parser reads it; the
    machine with the card need not have a YAML reader)."""
    from deepcoro_clip_tpu_torch.configs import ClipConfig

    d = dict(
        pipeline_project="DeepCORO_clip", run_mode="train",
        data_filename=".synth_corpus/data.csv", output_dir=".quality_run_v2_s0/outputs",
        epochs=25, batch_size=16, frames=16, resize=224, stride=1, num_workers=2,
        multi_video=False, max_text_length=128, lr=1.0e-4,
        scheduler_name="cosine_with_warmup", loss_name="contrastive", dropout=0.1,
        optimizer="AdamW", use_wandb=False, recall_k=[1, 5, 10], ndcg_k=[5],
        early_stopping_patience=5, seed=0, log_layer_grad_norms=True,
        model_name="mvit", vit_dim=512, vit_depth=12, vit_heads=4, vit_patch=[2, 16, 16],
        vit_pool_stages=[3], use_cls_token=True, embedding_dim=512, num_heads=8,
        aggregator_depth=2, text_dim=768, text_depth=12, text_heads=12,
        text_vocab_size=30522, temperature=0.0588, precision="bf16",
        use_pallas_attention=True,
    )
    d.update(over)
    return ClipConfig.from_dict(d)


def _attention_rows(torch, label: str, cases, seed: int):
    """K3 and K4 on the long kernels at a main path's [B,H,Lq|Lk,64] bf16
    calls, against their plain versions (phase 3's and phase 7's bars),
    with their times, busy times, bounds and SDPA's (and its busy time),
    and the key tiles the skip rule's mirror predicts the kernels visit.
    ``cases``: (what, B, H, Lq, Lk, mask, causal), ``mask`` the batch's own
    [B, Lk] key mask as the path hands it to the kernel, or None. q/k/v and
    dO are strided views of [B, L, H * 64] projections, as the layers hand
    them over. Returns (K3 rows, K4 rows)."""
    from deepcoro_clip_tpu_torch.ops import _flash_cuda
    import torch.nn.functional as F

    from deepcoro_clip_tpu_torch.ops.attention import flash_bwd_plain, multi_head_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    Dh = 64
    rows_f, rows_b = [], []
    for what, B, H, L, Lk, mask, causal in cases:

        def heads(n):
            t = torch.randn(B, n, H * Dh, generator=g, device=dev).to(torch.bfloat16)
            return t.reshape(B, n, H, Dh).transpose(1, 2)

        q, k, v, do = heads(L), heads(Lk), heads(Lk), heads(L)
        m = None if mask is None else mask.bool()
        kw, pkw = dict(kv_mask=mask, causal=causal), dict(kv_mask=m, causal=causal)
        shape = f"[{B},{H},{L}{'' if Lk == L else f'|{Lk}'},{Dh}] bf16, {what}"
        with torch.no_grad():
            err_f = check_forward(torch, label, f"K3 {shape}", flash_attention(q, k, v, **kw),
                                  multi_head_attention(q, k, v, **pkw))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, **kw)
        got = torch.autograd.grad(out, leaves, do, retain_graph=True)
        err_f = max(err_f, check_forward(torch, label, f"K3 {shape}, statistics written",
                                         out.detach(), multi_head_attention(q, k, v, **pkw)))
        ref = flash_bwd_plain(q, k, v, do, out.detach(), **pkw)
        err_b = max(_rel_check(f"K4 {shape}", w, a, r)
                    for w, a, r in zip(("dq", "dk", "dv"), got, ref))
        print(f"{label}: K4 {shape}: max|kernel-plain| {err_b:.3e} (bars: max|d| <= "
              f"{BWD_MAX_REL} max|plain|, rel l2 <= {BWD_L2_REL}) ok", flush=True)

        # what this run's data needs: the (query, key) pairs the mask and
        # causality leave; Q, dO read and O, dQ, dK, dV written whole (O read
        # again by the backward), K and V read at the real keys, the mask once
        allowed = torch.ones(B, L, Lk, dtype=torch.bool, device=dev)
        if m is not None:
            allowed &= m[:, None, :]
        if causal:
            allowed &= torch.ones(L, Lk, dtype=torch.bool, device=dev).tril()
        pairs = float(allowed.sum()) * H
        keys = float(B * Lk if m is None else m.sum())
        q_bytes = B * H * L * Dh * 2
        kv = 2 * keys * H * Dh * 2
        extra = 0 if m is None else B * Lk
        b_fwd = bound(4 * pairs * Dh, 2 * q_bytes + kv + extra)
        b_bwd = bound(10 * pairs * Dh, 4 * q_bytes + kv + 2 * B * H * Lk * Dh * 2 + extra)
        am = allowed[:, None] if m is not None or causal else None
        sq = [t.detach().requires_grad_() for t in (q, k, v)]
        sout = F.scaled_dot_product_attention(*sq, attn_mask=am)
        tiles = ""
        if hasattr(_flash_cuda, "visited_key_tiles"):  # this tree's skip rule
            nk = {t: -(-Lk // t[1]) for t in (_flash_cuda.FWD_TILES, _flash_cuda.DQ_TILES)}
            seen = {t: int(_flash_cuda.visited_key_tiles(m, B, L, Lk, causal, t).sum())
                    for t in nk}
            tiles = "; key tiles visited (the mirror's prediction, over the batch rows): " + \
                ", ".join(f"{w} {seen[t]} of {-(-L // t[0]) * nk[t] * B}" for w, t in (
                    ("forward", _flash_cuda.FWD_TILES), ("dQ", _flash_cuda.DQ_TILES)))
        with torch.no_grad():
            rows_f.append({
                "shape": shape,
                "ms": cuda_ms(torch, lambda: flash_attention(q, k, v, **kw), REPS),
                "plain_ms": cuda_ms(torch, lambda: multi_head_attention(q, k, v, **pkw),
                                    max(1, REPS // 5)),
                "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=am), REPS),
                "bound_ms": b_fwd[0], "bound_by": b_fwd[1],
                "device_ms": device_ms(torch, lambda: flash_attention(q, k, v, **kw), REPS,
                                       TILE_FWD),
                "library_device_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=am), REPS),
                "max_abs_err": err_f})
        rows_b.append({
            "shape": shape,
            "ms": cuda_ms(torch, lambda: torch.autograd.grad(out, leaves, do,
                                                             retain_graph=True), REPS),
            "plain_ms": cuda_ms(torch, lambda: flash_bwd_plain(q, k, v, do, out.detach(),
                                                               **pkw), max(1, REPS // 5)),
            "library_ms": cuda_ms(torch, lambda: torch.autograd.grad(sout, sq, do,
                                                                     retain_graph=True),
                                  REPS),
            "bound_ms": b_bwd[0], "bound_by": b_bwd[1],
            "device_ms": device_ms(torch, lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True), REPS, TILE_BWD),
            "library_device_ms": device_ms(torch, lambda: torch.autograd.grad(
                sout, sq, do, retain_graph=True), REPS),
            "max_abs_err": err_b})
        for name, r in (("K3 forward", rows_f[-1]), ("K4 backward", rows_b[-1])):
            print(f"{label}: {name} {shape}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {pairs:.0f} (q, k) pairs over "
                  f"the heads, {keys:.0f} real keys of {B * Lk}); card busy "
                  f"{r['device_ms']:.4f} ms, sdpa {r['library_device_ms']:.4f} ms"
                  f"{tiles if name.startswith('K3') else ''} | {CARD}", flush=True)
        del q, k, v, do, leaves, out, got, ref, sq, sout, allowed, am
        torch.cuda.empty_cache()
    return rows_f, rows_b


def _aggregator_attention(torch, vmask, label="quality attention", H=8, Dh=64, timed=False):
    """K3 and K4 at the aggregator's [B,H,N,Dh] bf16 (the short kernels;
    Dh 32 runs them at 64 on zero-padded operands), with the video mask the
    train step passes it and the operands as its blocks hand them over,
    against their plain versions by phase 3's and phase 7's bars. Returns
    max|kernel - plain| of the forward and of the gradients, and with
    ``timed`` a K3 row and a K4 row as ``_attention_rows`` gives them."""
    import torch.nn.functional as F

    from deepcoro_clip_tpu_torch.ops.attention import flash_bwd_plain, multi_head_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    B, N = vmask.shape
    shape = f"[{B},{H},{N},{Dh}] bf16, the batch's video mask ({str(vmask.dtype)[6:]})"
    # strided views of the block's [B, N, 3 * H * Dh] projection
    qkv = torch.randn(B, N, 3 * H * Dh, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = (t.reshape(B, N, H, Dh).transpose(1, 2) for t in qkv.split(H * Dh, -1))
    do = torch.randn(B, N, H, Dh, generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, kv_mask=vmask)
    got = torch.autograd.grad(out, leaves, do, retain_graph=timed)
    m = vmask != 0
    ref_out = multi_head_attention(q, k, v, kv_mask=m)
    err_f = check_forward(torch, label, f"K3 {shape}", out.detach(), ref_out)
    err_b = _short_grad_check(f"{label}: K4 {shape}", got,
                              flash_bwd_plain(q, k, v, do, ref_out, kv_mask=m), fp32=False)
    print(f"{label}: K4 {shape}: max|kernel-plain| {err_b:.3e} (bars: max|d| <= "
          f"{BWD_MAX_REL} max|plain|, rel l2 <= {BWD_L2_REL}) ok", flush=True)
    if not timed:
        return err_f, err_b
    # every query (a padded video's too) against the real videos; the bound
    # counts the call at its own Dh, not the kernel's padded one
    pairs = float(m.sum()) * N * H
    nbytes = B * H * N * Dh * 2
    b_fwd = bound(4 * pairs * Dh, 4 * nbytes + B * N)
    b_bwd = bound(10 * pairs * Dh, 8 * nbytes + B * N)
    am = m[:, None, None, :]
    sq = [t.detach().requires_grad_() for t in (q, k, v)]
    sout = F.scaled_dot_product_attention(*sq, attn_mask=am)
    short_f, short_b = ("flash_short_fwd_bf16_kernel",), ("flash_short_bwd_bf16_kernel",)
    with torch.no_grad():
        row_f = {"shape": shape, "max_abs_err": err_f,
                 "ms": cuda_ms(torch, lambda: flash_attention(q, k, v, kv_mask=vmask), REPS),
                 "plain_ms": cuda_ms(torch, lambda: multi_head_attention(q, k, v, kv_mask=m),
                                     REPS),
                 "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                     q, k, v, attn_mask=am), REPS),
                 "bound_ms": b_fwd[0], "bound_by": b_fwd[1],
                 "device_ms": device_ms(torch, lambda: flash_attention(q, k, v, kv_mask=vmask),
                                        REPS, short_f)}
    row_b = {"shape": shape, "max_abs_err": err_b,
             "ms": cuda_ms(torch, lambda: torch.autograd.grad(out, leaves, do,
                                                              retain_graph=True), REPS),
             "plain_ms": cuda_ms(torch, lambda: flash_bwd_plain(q, k, v, do, ref_out,
                                                                kv_mask=m), REPS),
             "library_ms": cuda_ms(torch, lambda: torch.autograd.grad(
                 sout, sq, do, retain_graph=True), REPS),
             "bound_ms": b_bwd[0], "bound_by": b_bwd[1],
             "device_ms": device_ms(torch, lambda: torch.autograd.grad(
                 out, leaves, do, retain_graph=True), REPS, short_b)}
    for name, r in (("K3 forward", row_f), ("K4 backward", row_b)):
        print(f"{label}: {name} {shape}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, sdpa {r['library_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}, {pairs:.0f} (q, k) pairs); card busy {r['device_ms']:.4f} ms "
              f"| {CARD}", flush=True)
    return err_f, err_b, row_f, row_b


def render_corpus(root: Path) -> Path:
    """The corpus of phases 22 and 23: QUALITY_TRAIN + QUALITY_VAL clips of
    16x224x224 by synthetic_angio.generate_corpus (seed 0); returns its
    manifest."""
    from deepcoro_clip_tpu_torch.data.synthetic_angio import generate_corpus

    t0 = time.perf_counter()
    manifest = generate_corpus(root / "corpus", n_train=QUALITY_TRAIN, n_val=QUALITY_VAL,
                               size=224, frames=16, seed=0)
    print(f"quality run: corpus of {QUALITY_TRAIN} train + {QUALITY_VAL} val clips "
          f"16x224x224 (synthetic_angio, seed 0) rendered in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return manifest


def phase_quality_run(torch, manifest: Path, keep: Optional[Path] = None) -> dict:
    """Phase 22 on the corpus of ``manifest`` (``render_corpus``); returns
    {"K1".."K4": launches of the run, "rows": (K3 row, K4 row) of the text
    tower's call, "aggregator_max_abs_err": (K3, K4) at the aggregator's
    call, "times": ...}. With ``keep`` the uninterrupted run's last
    checkpoint is copied there (phases 27 to 29 start from it), and epoch 0's
    checkpoint beside it as ``quality_epoch0.pt`` (phase 29 swaps it into
    an artifact)."""
    from deepcoro_clip_tpu_torch.runners.common import batch_to_device
    from deepcoro_clip_tpu_torch.runners.contrastive import VideoContrastiveLearningRunner

    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)

        def cfg(name, **over):
            return quality_train_config(data_filename=str(manifest), output_dir=str(tmp / name),
                                        epochs=2, num_workers=QUALITY_WORKERS, **over)

        print(f"quality run: config/quality/flagship_quality_train.yaml with data_filename="
              f"{manifest.name} (the rendered corpus), output_dir=<tmp>, epochs=2, "
              f"num_workers={QUALITY_WORKERS}; nothing else changed", flush=True)
        full, resumed, counts, wall, peak_gib = _runs_through_main(
            torch, "quality run", cfg,
            keep_cut=None if keep is None else keep.with_name("quality_epoch0.pt"))
        hist = full["history"]
        steps = QUALITY_TRAIN // 16
        n_epochs = len(hist)
        for h in hist:
            print(f"quality run: epoch {h['epoch']}: train loss {h['loss']:.4f}, val loss "
                  f"{h['val_loss']:.4f}, val R@1 {h['val_Recall@1']:.3f} R@5 "
                  f"{h['val_Recall@5']:.3f} MRR {h['val_MRR']:.3f} NDCG@5 "
                  f"{h['val_NDCG@5']:.3f} median rank {h['val_MedianRank']:.1f} alignment "
                  f"{h['val_alignment']:.4f}, temperature {h['temperature']:.5f}, lr "
                  f"{h['lr']:.2e}, grad_norm {h['grad_norm']:.3f} (block0 "
                  f"{h['grad_norm_video_block0']:.3f})", flush=True)
        check(all(math.isfinite(h[k]) for h in hist + resumed["history"]
                  for k in ("loss", "val_loss")), f"non-finite loss in {hist}")
        check(n_epochs == 2, f"{n_epochs} epochs in the history")
        want = {k: QUALITY_PER_STEP[k] * steps * n_epochs + QUALITY_PER_EVAL[k] * n_epochs
                + QUALITY_PER_BANK[k] * n_epochs for k in QUALITY_PER_STEP}
        print(f"quality run: launches over {n_epochs} x {steps} train steps, {n_epochs} "
              f"validation batches and {n_epochs} bank chunks: "
              + ", ".join(f"{k} {counts[k]} (expected {want[k]})" for k in want)
              + "; per train step K1 12, K2 12, K3 14, K4 14 (12 each long)", flush=True)
        check(counts == want, f"launches {counts}, expected {want}")

        # the files a run leaves
        run = Path(full["output_dir"])
        ck = sorted(p.name for p in (run / "checkpoints").iterdir())
        print(f"quality run: checkpoints {ck}", flush=True)
        for prefix in ("checkpoint.", "best_model_epoch_", "highest_alignment_epoch_"):
            kind = [n for n in ck if n.startswith(prefix)]
            check(sorted(Path(n).suffix for n in kind) == [".json", ".pt"],
                  f"checkpoint files {prefix}*: {kind} (one .pt and its .json)")
        meta = json.loads((run / "checkpoints" / "checkpoint.json").read_text())
        meta_keys = {"epoch", "train_loss", "val_loss", "alignment", "temperature",
                     "best_val_loss", "best_epoch", "highest_alignment", "dataset_mean",
                     "dataset_std"}
        check(meta_keys <= set(meta) and meta["epoch"] == 1, f"checkpoint meta {meta}")
        blocks = sorted(k for k in hist[0] if k.startswith("grad_norm_video_")
                        and k != "grad_norm_video_encoder")
        hist_keys = {"loss", "alignment", "temperature", "grad_norm", "lr",
                     "grad_norm_video_encoder", "grad_norm_text_encoder", "epoch_seconds",
                     "loader_wait_ms", "val_loss", "val_Recall@1", "val_Recall@5",
                     "val_Recall@10", "val_NDCG@5", "val_MRR", "val_MAP", "val_MedianRank",
                     "val_alignment", "val_seconds"}
        check(hist_keys <= set(hist[0]), f"history keys missing: {hist_keys - set(hist[0])}")
        want_blocks = ({f"grad_norm_video_block{i}" for i in range(12)}
                       | {"grad_norm_video_pool3", "grad_norm_video_patch_embed",
                          "grad_norm_video_cls", "grad_norm_video_norm"})
        check(set(blocks) == want_blocks, f"per-block norms {blocks}")
        print(f"quality run: meta keys {sorted(meta)}; history keys include "
              f"{len(blocks)} per-block norms grad_norm_video_<block> ({', '.join(blocks[:3])}, "
              "...)", flush=True)

        # resume: epoch 0's checkpoint, then epoch 1 as in the uninterrupted run
        _check_resume(torch, "quality run", full, resumed)
        if keep is not None:
            shutil.copyfile(run / "checkpoints" / "checkpoint.pt", keep)

        # times of the uninterrupted run (epoch 1: no first-call set-up)
        h = hist[1]
        step_ms = h["epoch_seconds"] * 1e3 / steps
        times = {"step_ms": step_ms, "clips_per_s": 16 * steps / h["epoch_seconds"],
                 "loader_wait_ms": h["loader_wait_ms"], "validate_s": h["val_seconds"],
                 "peak_gib": peak_gib, "run_s": wall,
                 "epoch0_seconds": hist[0]["epoch_seconds"]}
        print(f"quality run: step {step_ms:.1f} ms (host clock, epoch 1: "
              f"{h['epoch_seconds']:.3f} s over {steps} steps), {times['clips_per_s']:.1f} "
              f"clips/s | {CARD}", flush=True)
        print(f"quality run: loader wait {h['loader_wait_ms']:.2f} ms a step | {CARD}",
              flush=True)
        print(f"quality run: validation pass {h['val_seconds']:.3f} s (16 clips, "
              f"bank of the deduplicated reports, metrics) | {CARD}", flush=True)
        print(f"quality run: peak memory {peak_gib:.2f} GiB (torch.cuda.max_memory_allocated); "
              f"epoch 0 {hist[0]['epoch_seconds']:.2f} s with first-call set-up | {CARD}",
              flush=True)

        # one step traced, and K3/K4 on the corpus reports' mask
        cfg = quality_train_config(data_filename=str(manifest), output_dir=str(tmp / "trace"),
                                   epochs=2, num_workers=QUALITY_WORKERS)
        runner = VideoContrastiveLearningRunner(cfg, output_dir=tmp / "trace")
        batch = batch_to_device(next(iter(runner.loaders["train"])), runner.device)
        args = (batch, runner.generator, 0.0, 0.0, -1.0)
        runner.train_step(runner.state, *args)  # warm
        per_name, wall_ms = device_events(torch, lambda: runner.train_step(runner.state, *args))
        print_profile("quality profile", "one step at the quality recipe", per_name,
                      wall_ms, top=14)
        check_main_path_kernels(
            "quality profile, the text tower's K3 and K4 (L 128)", per_name, TILE_KERNELS, ())
        check_main_path_kernels(
            "quality profile, the aggregator's K3 and K4 (L 1) and K1, K2", per_name,
            ("flash_short_fwd_bf16_kernel", "flash_short_bwd_bf16_kernel",
             "flash_fwd_sm90_kernel", "flash_bwd_dkv_sm90_kernel", "flash_bwd_dq_sm90_kernel"),
            ("ring_step",))
        mask = batch["attention_mask"].bool()
        print(f"quality attention: the mask: {int(mask.sum())} real tokens of {mask.numel()} "
              f"(shortest report {int(mask.sum(1).min())}, longest {int(mask.sum(1).max())})",
              flush=True)
        vmask = batch["video_mask"]
        del runner, batch, args
        torch.cuda.empty_cache()
        B, L = mask.shape
        rows = tuple(r[0] for r in _attention_rows(
            torch, "quality attention",
            [("the corpus reports' padding mask", B, 12, L, L, mask, False)], seed=22))
        agg = _aggregator_attention(torch, vmask)
    return {**counts, "rows": rows, "aggregator_max_abs_err": agg, "times": times}


# --------------------------------------------------------------------------- #
# phase 23: the multitask run through main, at config/multitask/multitask_config.yaml,
# on phase 22's corpus grouped into studies

MT_BATCH = 8  # studies a batch, 4 clips each
MT_TIMED_STEPS = 5
# launches per train step and per validation batch: K1 / K2 in the 12 video
# blocks; K3 / K4 in the 12 text layers (L 512), the decoder's 4 causal
# self-attentions (L 128, the captions' padding mask) and 4 cross-attentions
# (128 queries over 4 x 393 video tokens), all on the tile kernels, and the
# aggregator's 2 blocks (L 4, the short kernels). Caption generation is
# plain torch (no kernel); the MVM decoder runs the plain attention.
MT_PER_STEP = {"K1": 12, "K2": 12, "K3": 22, "K4": 22, "K5": 0, "K6": 0,
               "K3 long": 20, "K4 long": 20}
MT_PER_VAL = {"K1": 12, "K2": 0, "K3": 22, "K4": 0, "K5": 0, "K6": 0,
              "K3 long": 20, "K4 long": 0}


def multitask_config(**over):
    """config/multitask/multitask_config.yaml, field by field (a CPU test
    holds this dict equal to the YAML as the port's parser reads it)."""
    from deepcoro_clip_tpu_torch.configs import MultitaskConfig

    d = dict(
        pipeline_project="DeepCORO_multitask", run_mode="train", epochs=30, num_workers=8,
        seed=42, data_filename="data/reports.csv", target_label="Report",
        datapoint_loc_label="FileName", frames=16, stride=2, resize=224, batch_size=8,
        multi_video=True, num_videos=4, max_text_length=512, model_name="mvit",
        vit_dim=512, vit_depth=12, vit_heads=4, vit_patch=[2, 16, 16], vit_pool_stages=[3],
        use_cls_token=True, embedding_dim=512, num_heads=8, aggregator_depth=2,
        dropout=0.1, decoder_dim=512, decoder_depth=4, decoder_heads=8,
        decoder_max_length=128, caption_label_smoothing=0.1, locca_enabled=True,
        locca_weight=0.5, captioning_lr=0.0001, mvm_lr=0.0001, mask_ratio=0.75,
        mvm_decoder_dim=256, mvm_decoder_depth=2,
        loss_weights={"contrastive": 1.0, "captioning": 1.0, "mvm": 1.0},
        optimizer="AdamW", scheduler_name="cosine_with_warmup", lr=0.0001,
        text_lr=0.00002, temperature=0.0588, precision="bf16", use_pallas_attention=True,
        use_wandb=False,
    )
    d.update(over)
    return MultitaskConfig.from_dict(d)


def _study_counts(manifest: Path) -> dict:
    """Studies per split of a study manifest."""
    from deepcoro_clip_tpu_torch.data.csv_utils import read_csv_with_fallback

    table = read_csv_with_fallback(manifest)
    out: dict = {}
    for r in table.rows:
        out.setdefault(r["Split"], set()).add(r["StudyInstanceUID"])
    return {k: len(v) for k, v in out.items()}


def phase_multitask_run(torch, manifest: Path) -> dict:
    """Phase 23 on phase 22's corpus (``manifest``, grouped into studies of
    2 to 4 clips); returns {"counts": launches of the run, "rows": (K3 rows,
    K4 rows) at the text tower's and the decoder's shapes, "times": ...}."""
    from deepcoro_clip_tpu_torch.data.synthetic_angio import write_study_manifest
    from deepcoro_clip_tpu_torch.runners.common import batch_to_device
    from deepcoro_clip_tpu_torch.runners.multitask import MultitaskRunner

    studies = write_study_manifest(manifest.parent, seed=0)
    n = _study_counts(studies)
    steps = n["train"] // MT_BATCH
    val_batches = -(-n["val"] // MT_BATCH)
    print(f"multitask run: {n['train']} train and {n['val']} val studies of 2 to 4 clips "
          f"(write_study_manifest, group seed 1234): {steps} steps and {val_batches} "
          "validation batch(es) an epoch", flush=True)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)

        def cfg(name, **over):
            return multitask_config(data_filename=str(studies), output_dir=str(tmp / name),
                                    epochs=2, num_workers=QUALITY_WORKERS, **over)

        print(f"multitask run: config/multitask/multitask_config.yaml with data_filename="
              f"{studies.name} (the corpus grouped into studies), output_dir=<tmp>, epochs=2, "
              f"num_workers={QUALITY_WORKERS}; nothing else changed", flush=True)
        full, resumed, counts, wall, peak_gib = _runs_through_main(
            torch, "multitask run", cfg)
        hist = full["history"]
        for h in hist:
            print(f"multitask run: epoch {h['epoch']}: train loss {h['loss']:.4f} "
                  f"(contrastive {h['loss_contrastive']:.4f}, captioning "
                  f"{h['loss_captioning']:.4f}, mvm {h['loss_mvm']:.4f}), val loss "
                  f"{h['val_loss']:.4f}, BLEU-1 {h['val_bleu1']:.4f} BLEU-4 "
                  f"{h['val_bleu4']:.4f} ROUGE-L {h['val_rouge_l']:.4f} METEOR "
                  f"{h['val_meteor']:.4f}, temperature {h['temperature']:.5f}, lr "
                  f"{h['lr']:.2e}", flush=True)
        loss_keys = ("loss", "loss_contrastive", "loss_captioning", "loss_mvm", "val_loss")
        check(all(math.isfinite(h[k]) for h in hist + resumed["history"] for k in loss_keys),
              f"non-finite loss in {hist}")
        check(len(hist) == 2, f"{len(hist)} epochs in the history")
        want = {k: 2 * (MT_PER_STEP[k] * steps + MT_PER_VAL[k] * val_batches)
                for k in MT_PER_STEP}
        print(f"multitask run: launches over 2 x {steps} train steps and 2 x {val_batches} "
              "validation batch(es): " + ", ".join(f"{k} {counts[k]} (expected {want[k]})"
                                                   for k in want)
              + "; per train step K1 12, K2 12, K3 22, K4 22 (20 each long)", flush=True)
        check(counts == want, f"launches {counts}, expected {want}")

        run = Path(full["output_dir"])
        ck = sorted(p.name for p in (run / "checkpoints").iterdir())
        print(f"multitask run: checkpoints {ck}", flush=True)
        for prefix in ("checkpoint.", "best_model_epoch_"):
            kind = [c for c in ck if c.startswith(prefix)]
            check(sorted(Path(c).suffix for c in kind) == [".json", ".pt"],
                  f"checkpoint files {prefix}*: {kind} (one .pt and its .json)")
        meta = json.loads((run / "checkpoints" / "checkpoint.json").read_text())
        check(meta["epoch"] == 1 and meta["global_step"] == 2 * steps,
              f"checkpoint meta {meta}")
        metric_keys = {"val_bleu1", "val_bleu2", "val_bleu3", "val_bleu4", "val_rouge_l",
                       "val_meteor", "val_seconds", "loader_wait_ms", "epoch_seconds"}
        check(metric_keys <= set(hist[0]), f"history keys missing: {metric_keys - set(hist[0])}")
        for epoch in (0, 1):
            caps = (run / "val" / f"captions_epoch_{epoch}.csv").read_text().splitlines()
            check(caps[0] == "generated,reference" and len(caps) == 1 + n["val"],
                  f"captions_epoch_{epoch}.csv: {len(caps) - 1} rows for {n['val']} studies")
        print(f"multitask run: captions of epoch 1, first study: {caps[1][:150]!r}", flush=True)

        _check_resume(torch, "multitask run", full, resumed)

        h = hist[1]
        step_ms = h["epoch_seconds"] * 1e3 / steps
        times = {"step_ms": step_ms, "studies_per_s": MT_BATCH * steps / h["epoch_seconds"],
                 "loader_wait_ms": h["loader_wait_ms"], "validate_s": h["val_seconds"],
                 "peak_gib": peak_gib, "run_s": wall,
                 "epoch0_seconds": hist[0]["epoch_seconds"]}
        print(f"multitask run: step {step_ms:.1f} ms (host clock, epoch 1: "
              f"{h['epoch_seconds']:.3f} s over {steps} steps), "
              f"{times['studies_per_s']:.2f} studies/s, loader wait "
              f"{h['loader_wait_ms']:.2f} ms a step | {CARD}", flush=True)
        print(f"multitask run: validation pass {h['val_seconds']:.3f} s ({n['val']} studies: "
              f"the forward, {min(32, 128)}-token greedy captions with the K/V cache, "
              f"metrics) | {CARD}", flush=True)
        print(f"multitask run: peak memory {peak_gib:.2f} GiB (torch.cuda.max_memory_allocated);"
              f" epoch 0 {hist[0]['epoch_seconds']:.2f} s with first-call set-up | {CARD}",
              flush=True)

        # one step traced, and K3/K4 at the text tower's and the decoder's shapes on
        # this batch's masks
        cfg = multitask_config(data_filename=str(studies), output_dir=str(tmp / "trace"),
                               epochs=2, num_workers=QUALITY_WORKERS)
        runner = MultitaskRunner(cfg, output_dir=tmp / "trace")
        times["parameters"] = sum(p.numel() for p in runner.state.params.values())
        print(f"multitask run: {times['parameters']} parameters (video, text, decoder, MVM, "
              "log_temp)", flush=True)
        batch = batch_to_device(next(iter(runner.loaders["train"])), runner.device)
        args = (batch, runner.generator, 1.0, 1.0, 1.0, 0.0, 0.0, -1.0)
        runner.train_step(runner.state, *args)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MT_TIMED_STEPS):  # the run has one step an epoch: time a few more
            runner.train_step(runner.state, *args)
        torch.cuda.synchronize()
        times["step_ms_same_batch"] = (time.perf_counter() - t0) * 1e3 / MT_TIMED_STEPS
        print(f"multitask run: {MT_TIMED_STEPS} more steps on one batch (no loader): "
              f"{times['step_ms_same_batch']:.1f} ms a step (host clock, synchronised) | "
              f"{CARD}", flush=True)
        per_name, wall_ms = device_events(torch, lambda: runner.train_step(runner.state,
                                                                          *args))
        print_profile("multitask profile", "one train step at the multitask recipe",
                      per_name, wall_ms, top=16)
        times["busy_ms"] = sum(per_name.values())
        times["profiled_step_ms"] = wall_ms
        times["tile_k3_k4_busy_ms"] = sum(ms for name, ms in per_name.items()
                                          if any(t in name for t in TILE_KERNELS))
        print(f"multitask profile: the tile kernels of K3/K4 (text L 512, decoder self "
              f"and cross) busy {times['tile_k3_k4_busy_ms']:.3f} ms of the step's "
              f"{times['busy_ms']:.2f} | {CARD}", flush=True)
        check_main_path_kernels(
            "multitask profile, K3 and K4 on the long kernels (text L 512, decoder L 128 "
            "causal, cross 128|1572)", per_name, TILE_KERNELS, ())
        check_main_path_kernels(
            "multitask profile, the aggregator's K3 and K4 (L 4) and K1, K2", per_name,
            ("flash_short_fwd_bf16_kernel", "flash_short_bwd_bf16_kernel",
             "flash_fwd_sm90_kernel", "flash_bwd_dkv_sm90_kernel", "flash_bwd_dq_sm90_kernel"),
            ("ring_step", "flash_fwd_proj"))
        text_mask, cap_mask = batch["attention_mask"], batch["caption_mask"]
        n_tok = runner.bundle.mvm.pos_emb.shape[1] * cfg.num_videos
        for what, m in (("text", text_mask), ("caption", cap_mask)):
            print(f"multitask attention: the {what} mask [{m.shape[0]},{m.shape[1]}]: "
                  f"{int(m.sum())} real tokens of {m.numel()} (shortest "
                  f"{int(m.sum(1).min())}, longest {int(m.sum(1).max())})", flush=True)
        print(f"multitask attention: {n_tok} video tokens a study", flush=True)
        del runner, batch, args
        torch.cuda.empty_cache()
        B, L = cap_mask.shape
        rows = _attention_rows(torch, "multitask attention", [
            ("the text tower, the reports' padding mask", B, cfg.text_heads,
             text_mask.shape[1], text_mask.shape[1], text_mask, False),
            ("the decoder's causal self-attention, the captions' padding mask", B,
             cfg.decoder_heads, L, L, cap_mask, True),
            ("the decoder's cross-attention over the video tokens, no mask", B,
             cfg.decoder_heads, L, n_tok, None, False)], seed=23)
    return {"counts": counts, "rows": rows, "times": times}


# --------------------------------------------------------------------------- #
# phases 24 and 25: SigLIP pretraining through main, at
# config/clip/siglip_multi_positive_config.yaml and config/clip/multivideo_config.yaml


def siglip_config(**over):
    """config/clip/siglip_multi_positive_config.yaml, field by field (a CPU
    test holds this dict equal to the YAML as the port's parser reads it)."""
    from deepcoro_clip_tpu_torch.configs import ClipConfig

    d = dict(
        pipeline_project="DeepCORO_clip", run_mode="train", epochs=30, num_workers=8,
        seed=42, data_filename="output_dataset/siglip_generated/videos.csv",
        datapoint_loc_label="FileName", target_label=None, frames=16, stride=1, resize=224,
        batch_size=20, multi_video=False, max_text_length=512,
        siglip_texts_path="output_dataset/siglip_generated/texts.csv",
        siglip_edges_path="output_dataset/siglip_generated/edges.csv",
        siglip_max_positive_per_video=8, siglip_negatives_per_video=32,
        siglip_round_robin_sampling=True, siglip_enable_severity_weighting=True,
        siglip_use_class_aware_sampler=True, siglip_abnormal_ratio=0.5,
        siglip_bias_init=-10.0, siglip_entropy_reg_weight=0.01, loss_name="siglip_pairwise",
        model_name="mvit", vit_dim=512, vit_depth=12, vit_heads=4, vit_patch=[2, 16, 16],
        vit_pool_stages=[3], use_cls_token=True, embedding_dim=512, num_heads=16,
        aggregator_depth=1, dropout=0.12, optimizer="AdamW", scheduler_name="linear_warmup",
        lr=0.00002, video_weight_decay=0.00001, text_weight_decay=0.0000001,
        video_max_grad_norm=1.0, text_max_grad_norm=1.0, video_freeze_ratio=0.8,
        text_freeze_ratio=0.75, temperature=0.07, precision="bf16",
        use_pallas_attention=True, use_wandb=False,
    )
    d.update(over)
    return ClipConfig.from_dict(d)


def multivideo_config(**over):
    """config/clip/multivideo_config.yaml, field by field (held equal to the
    YAML by the same CPU test)."""
    from deepcoro_clip_tpu_torch.configs import ClipConfig

    d = dict(
        pipeline_project="DeepCORO_clip", run_mode="train", epochs=30, num_workers=8,
        seed=42, data_filename="data/reports_study_level.csv", target_label="Report",
        datapoint_loc_label="FileName", frames=16, stride=1, resize=224, batch_size=8,
        multi_video=True, num_videos=5, groupby_column="StudyInstanceUID",
        shuffle_videos=True, max_text_length=512, model_name="mvit", vit_dim=512,
        vit_depth=12, vit_heads=4, vit_patch=[2, 16, 16], vit_pool_stages=[3],
        use_cls_token=True, embedding_dim=512, num_heads=8, aggregator_depth=2, dropout=0.1,
        optimizer="AdamW", scheduler_name="cosine_with_warmup", lr=0.0001,
        loss_name="siglip", temperature=0.079, max_grad_norm=1.0, recall_k=[1, 5, 10, 50],
        ndcg_k=[5], precision="bf16", use_pallas_attention=True, use_wandb=False,
    )
    d.update(over)
    return ClipConfig.from_dict(d)


def siglip_cto_columns() -> dict:
    """{segment: its CTO flag column} of ``siglip_rows``."""
    from deepcoro_clip_tpu_torch.data.dataset_creation import SEGMENT_INFO

    return {seg: f"{seg}_cto" for seg in SEGMENT_INFO}


def siglip_rows(manifest: Path, seed: int = 0) -> list:
    """One row a clip of a rendered corpus (its ``data.csv``), for
    ``build_siglip_manifests``: FileName, Split, video_id (the clip's
    StudyInstanceUID) and, for each finding ``synthetic_angio.sample_findings``
    gave the clip, ``<segment>_stenosis`` (its percent; 100 for a CTO) and
    ``<segment>_cto``. A corpus segment's key is the one whose aliases name
    it (``stenosis_extractor.SEGMENT_ALIASES``)."""
    from deepcoro_clip_tpu_torch.data.csv_utils import read_csv_with_fallback
    from deepcoro_clip_tpu_torch.data.synthetic_angio import SEGMENTS, sample_findings
    from deepcoro_clip_tpu_torch.utils.stenosis_extractor import SEGMENT_ALIASES

    keys = [next(k for k, names in SEGMENT_ALIASES.items() if name in names)
            for name, *_ in SEGMENTS]
    rows = []
    for r in read_csv_with_fallback(manifest).rows:
        row = {"FileName": r["FileName"], "video_id": r["StudyInstanceUID"],
               "Split": r["Split"]}
        clip = int(str(r["StudyInstanceUID"]).replace("SYN", ""))
        for f in sample_findings(clip, seed):
            key = keys[f.segment]
            row[f"{key}_stenosis"] = 100.0 if f.severity == "cto" else float(f.pct)
            row[f"{key}_cto"] = f.severity == "cto"
        rows.append(row)
    return rows


# batch_size of phase 24's run: 20 in the YAML does not fit one 80 GB card
# (phase 24's memory reckoning prints why); every other shape is the YAML's
SIGLIP_BATCH = 7
SIGLIP_MEASURE = (2, 4)  # batch sizes of the memory reckoning
CARD_MARGIN = 0.85  # of the card's memory a batch may reckon to use
# launches per train step and per validation batch of phase 24: K1 / K2 in
# the 12 video blocks; K3 / K4 in the text tower's 12 layers over the bank of
# batch_size x 40 texts at L 512 (the tile kernels) and the aggregator's 1
# block at N 1 (16 heads of 32, padded to 64: the short kernels); each bank
# chunk of 64 validation texts: 12 K3
SIGLIP_PER_STEP = {"K1": 12, "K2": 12, "K3": 13, "K4": 13, "K5": 0, "K6": 0,
                   "K3 long": 12, "K4 long": 12}
SIGLIP_PER_VAL = {"K1": 12, "K2": 0, "K3": 13, "K4": 0, "K5": 0, "K6": 0,
                  "K3 long": 12, "K4 long": 0}
# phase 25: the text tower's 12 layers at [8,12,512,64] and the aggregator's
# 2 blocks at [8,8,5,64]
MV_BATCH = 8
MV_PER_STEP = {"K1": 12, "K2": 12, "K3": 14, "K4": 14, "K5": 0, "K6": 0,
               "K3 long": 12, "K4 long": 12}
MV_PER_VAL = {"K1": 12, "K2": 0, "K3": 14, "K4": 0, "K5": 0, "K6": 0,
              "K3 long": 12, "K4 long": 0}
PER_BANK_CHUNK = {"K1": 0, "K2": 0, "K3": 12, "K4": 0, "K5": 0, "K6": 0,
                  "K3 long": 12, "K4 long": 0}


def _runs_through_main(torch, label: str, cfg, keep_cut: Optional[Path] = None,
                       resume: bool = True):
    """``cfg(name, **over)``'s run through main, counted from 0 and its peak
    memory read; with ``resume``, epoch 0's checkpoint is copied out of that
    run as it is written (what a run killed after epoch 0 leaves: its
    ``checkpoints/checkpoint.{pt,json}``) and resumed through main.
    ``keep_cut``: that checkpoint is copied there too; the resumed run
    takes the first run's dataset statistics. Returns (full,
    resumed, counts, wall seconds, peak GiB); resumed is None without
    ``resume``."""
    from deepcoro_clip_tpu_torch.main import main
    from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager

    copy = Path(cfg("cut").output_dir) / "epoch0"
    save_latest = CheckpointManager.save_latest

    def saving(self, state, meta, *a, **kw):
        path = save_latest(self, state, meta, *a, **kw)
        if resume and meta.get("epoch") == 0:
            (copy / "checkpoints").mkdir(parents=True, exist_ok=True)
            for suffix in (".pt", ".json"):
                shutil.copyfile(self.dir / f"checkpoint{suffix}",
                                copy / "checkpoints" / f"checkpoint{suffix}")
        return path

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_kernel_counts()
    CheckpointManager.save_latest = saving
    t0 = time.perf_counter()
    c_full = cfg("full")
    try:
        full = main(config=c_full)
    finally:
        CheckpointManager.save_latest = save_latest
    wall = time.perf_counter() - t0
    counts = {**_kernel_counts(), **_long_counts()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label}: main took {wall:.1f} s for 2 epochs (set-up, dataset statistics and "
          f"checkpoint writes included) | {CARD}", flush=True)
    if not resume:
        return full, None, counts, wall, peak_gib
    check((copy / "checkpoints" / "checkpoint.pt").exists(),
          f"{label}: no checkpoint of epoch 0 was written")
    if keep_cut is not None:
        shutil.copyfile(copy / "checkpoints" / "checkpoint.pt", keep_cut)
    # (the run's dataset statistics: the same values, no second pass over the clips)
    resumed = main(config=cfg("cut", resume_training=True, checkpoint=str(copy),
                              dataset_mean=c_full.dataset_mean, dataset_std=c_full.dataset_std))
    return full, resumed, counts, wall, peak_gib


def _check_resume(torch, label: str, full, resumed) -> None:
    """The resumed run's epoch 1 and final checkpoint bit-equal to the
    uninterrupted run's (the single-head sampler's state too, where the run
    has one)."""
    hist = full["history"]
    a = torch.load(Path(full["output_dir"]) / "checkpoints" / "checkpoint.pt", weights_only=True)
    b = torch.load(Path(resumed["output_dir"]) / "checkpoints" / "checkpoint.pt",
                   weights_only=True)
    differ = [k for k in a["params"] if not torch.equal(a["params"][k], b["params"][k])]
    l_full, l_res = hist[1]["loss"], resumed["history"][0]["loss"]
    print(f"{label}: resume from epoch 0's checkpoint: epoch-1 train loss {l_res!r} vs "
          f"{l_full!r} uninterrupted, val loss {resumed['history'][0]['val_loss']!r} vs "
          f"{hist[1]['val_loss']!r}; {len(differ)} of {len(a['params'])} parameter tensors "
          "differ (tolerance: none, bit-equal)", flush=True)
    check([h["epoch"] for h in resumed["history"]] == [1],
          f"{label}: the resumed run ran epochs {[h['epoch'] for h in resumed['history']]}")
    check(l_res == l_full and not differ and a["step"] == b["step"]
          and torch.equal(a["generator"], b["generator"])
          and a.get("sampler") == b.get("sampler"),
          f"{label}: the resumed run differs: loss {l_res} vs {l_full}, params {differ[:5]}")


def _run_checks(torch, label: str, full, counts, want) -> dict:
    """Losses finite, launches as predicted, logit_bias moved from its
    initial value, the checkpoints and the validation artifacts; returns
    the final checkpoint's logit_bias and temperature."""
    hist = full["history"]
    check(len(hist) == 2, f"{label}: {len(hist)} epochs in the history")
    check(all(math.isfinite(h[k]) for h in hist for k in ("loss", "val_loss")),
          f"{label}: non-finite loss in {hist}")
    print(f"{label}: launches over the whole run: "
          + ", ".join(f"{k} {counts[k]} (predicted {want[k]})" for k in want), flush=True)
    check(counts == want, f"{label}: launches {counts}, predicted {want}")
    run = Path(full["output_dir"])
    ck = sorted(p.name for p in (run / "checkpoints").iterdir())
    for prefix in ("checkpoint.", "best_model_epoch_"):
        kind = [n for n in ck if n.startswith(prefix)]
        check(sorted(Path(n).suffix for n in kind) == [".json", ".pt"],
              f"{label}: checkpoint files {prefix}*: {kind}")
    for epoch in (0, 1):
        for name in (f"unique_texts_epoch_{epoch}.csv", f"retrieval_results_epoch_{epoch}.csv",
                     f"text_embeddings_epoch_{epoch}.npz"):
            check((run / "val" / name).exists(), f"{label}: no val/{name}")
    params = torch.load(run / "checkpoints" / "checkpoint.pt", weights_only=True)["params"]
    bias, temp = float(params["logit_bias"]), math.exp(float(params["log_temp"]))
    print(f"{label}: checkpoints {ck}; validation artifacts of both epochs written; "
          f"logit_bias {bias!r} after {len(hist)} epochs (initial -10.0), temperature "
          f"{temp:.6f}", flush=True)
    check(bias != -10.0 and math.isfinite(bias), f"{label}: logit_bias {bias} did not move")
    return {"logit_bias": bias, "temperature": temp}


def _bank_chunks(run: Path, epochs=(0, 1)) -> int:
    """Chunks of 64 in which validation encoded its bank, over ``epochs``."""
    n = 0
    for epoch in epochs:
        texts = (run / "val" / f"unique_texts_epoch_{epoch}.csv").read_text().splitlines()
        n += -(-(len(texts) - 1) // 64)
    return n


def _profile_step(torch, label: str, runner, times: dict) -> dict:
    """One train step of ``runner`` on its first batch traced: busy time, the
    tile K3/K4 share, the kernels that ran. Returns the device batch."""
    from deepcoro_clip_tpu_torch.runners.common import batch_to_device

    batch = batch_to_device(next(iter(runner.loaders["train"])), runner.device)
    cfg = runner.config
    args = (batch, runner.generator, cfg.video_freeze_ratio, cfg.text_freeze_ratio, -1.0)
    runner.train_step(runner.state, *args)  # warm
    per_name, wall_ms = device_events(torch, lambda: runner.train_step(runner.state, *args))
    print_profile(label, "one train step", per_name, wall_ms, top=14)
    times["busy_ms"] = sum(per_name.values())
    times["profiled_step_ms"] = wall_ms
    times["tile_k3_k4_busy_ms"] = sum(ms for n, ms in per_name.items()
                                      if any(t in n for t in TILE_KERNELS))
    print(f"{label}: the tile kernels of K3/K4 (the text tower, L 512) busy "
          f"{times['tile_k3_k4_busy_ms']:.3f} ms of the step's {times['busy_ms']:.2f} | {CARD}",
          flush=True)
    check_main_path_kernels(f"{label}, the text tower's K3 and K4 (L 512)", per_name,
                            TILE_KERNELS, ())
    check_main_path_kernels(
        f"{label}, the aggregator's K3 and K4 and K1, K2", per_name,
        ("flash_short_fwd_bf16_kernel", "flash_short_bwd_bf16_kernel", "flash_fwd_sm90_kernel",
         "flash_bwd_dkv_sm90_kernel", "flash_bwd_dq_sm90_kernel"), ("ring_step", "flash_fwd_proj"))
    return batch


def _epoch_times(label: str, hist, steps: int, per_step: int, unit: str, peak_gib: float,
                 wall: float) -> dict:
    h = hist[1]
    step_ms = h["epoch_seconds"] * 1e3 / steps
    times = {"step_ms": step_ms, f"{unit}_per_s": per_step * steps / h["epoch_seconds"],
             "loader_wait_ms": h["loader_wait_ms"], "validate_s": h["val_seconds"],
             "peak_gib": peak_gib, "run_s": wall, "epoch0_seconds": hist[0]["epoch_seconds"]}
    print(f"{label}: step {step_ms:.1f} ms (host clock, epoch 1: {h['epoch_seconds']:.3f} s "
          f"over {steps} steps, loader wait {h['loader_wait_ms']:.2f} ms a step), "
          f"{times[f'{unit}_per_s']:.2f} {unit}/s; validation pass {h['val_seconds']:.3f} s; "
          f"peak memory {peak_gib:.2f} GiB (torch.cuda.max_memory_allocated) | {CARD}",
          flush=True)
    return times


def _siglip_memory(torch, siglip: dict) -> dict:
    """Peak memory of one train step at the full recipe and batch sizes
    SIGLIP_MEASURE (over what the card held before the runner was built:
    earlier phases' leftovers are not the run's), the line through them
    reckoned at the YAML's 20 and at SIGLIP_BATCH, which must stay under
    CARD_MARGIN of the card."""
    from deepcoro_clip_tpu_torch.runners.common import batch_to_device
    from deepcoro_clip_tpu_torch.runners.contrastive import VideoContrastiveLearningRunner

    total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    peaks = {}
    for b in SIGLIP_MEASURE:
        cfg = siglip_config(**dict(siglip, output_dir=siglip["output_dir"] + f"_b{b}"),
                            batch_size=b)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        runner = VideoContrastiveLearningRunner(cfg)
        batch = batch_to_device(next(iter(runner.loaders["train"])), runner.device)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        runner.train_step(runner.state, batch, runner.generator, cfg.video_freeze_ratio,
                          cfg.text_freeze_ratio, -1.0)
        torch.cuda.synchronize()
        peaks[b] = (torch.cuda.max_memory_allocated() - before) / 2 ** 30
        del runner, batch
        torch.cuda.empty_cache()
    (b0, p0), (b1, p1) = sorted(peaks.items())
    per = (p1 - p0) / (b1 - b0)
    at = {b: p0 + per * (b - b0) for b in (20, SIGLIP_BATCH)}
    fits = int((CARD_MARGIN * total - p0) // per + b0)
    print(f"siglip memory: one train step at the recipe's shapes (model, optimizer state, "
          f"activations, gradients): peak "
          + ", ".join(f"{p:.2f} GiB at batch {b} ({b * 40} texts x 512 tokens)"
                      for b, p in sorted(peaks.items()))
          + f"; {per:.2f} GiB a video with its 40 texts; reckoned {at[20]:.1f} GiB at the "
          f"YAML's batch 20 against the card's {total:.1f} GiB; at most batch {fits} within "
          f"{CARD_MARGIN:.0%} of it; this run takes batch {SIGLIP_BATCH} (reckoned "
          f"{at[SIGLIP_BATCH]:.1f} GiB) | {CARD}", flush=True)
    check(at[SIGLIP_BATCH] <= CARD_MARGIN * total and SIGLIP_BATCH <= fits,
          f"siglip memory: batch {SIGLIP_BATCH} reckons {at[SIGLIP_BATCH]:.1f} GiB")
    return {"peak_gib": peaks, "gib_per_video": per, "reckoned_gib_at_20": at[20],
            "largest_batch_within_margin": fits, "card_gib": total}


def phase_siglip_run(torch, manifest: Path) -> dict:
    """Phase 24: config/clip/siglip_multi_positive_config.yaml through main
    on the manifests build_siglip_manifests writes from the corpus of
    ``manifest``; returns {"counts", "rows" (K3 rows, K4 rows), "times",
    "aggregator_max_abs_err"}."""
    from deepcoro_clip_tpu_torch.data.dataset_creation import build_siglip_manifests
    from deepcoro_clip_tpu_torch.runners.contrastive import VideoContrastiveLearningRunner

    label = "siglip run"
    t0 = time.perf_counter()
    rows = siglip_rows(manifest, seed=0)
    paths = build_siglip_manifests(rows, manifest.parent / "siglip",
                                   cto_columns=siglip_cto_columns())
    n_texts = len(paths["texts"].read_text().splitlines()) - 1
    n_edges = len(paths["edges"].read_text().splitlines()) - 1
    print(f"{label}: manifests from the corpus's findings (build_siglip_manifests): "
          f"{len(rows)} videos, {n_texts} texts, {n_edges} edges, in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        siglip = dict(data_filename=str(paths["videos"]), siglip_texts_path=str(paths["texts"]),
                      siglip_edges_path=str(paths["edges"]), epochs=2,
                      num_workers=QUALITY_WORKERS, output_dir=str(tmp / "mem"))
        memory = _siglip_memory(torch, siglip)

        def cfg(name, **over):
            return siglip_config(**dict(siglip, output_dir=str(tmp / name)),
                                 batch_size=SIGLIP_BATCH, **over)

        steps = QUALITY_TRAIN // SIGLIP_BATCH  # the class-aware sampler's batches
        val_batches = -(-QUALITY_VAL // SIGLIP_BATCH)
        print(f"{label}: config/clip/siglip_multi_positive_config.yaml with data_filename, "
              f"siglip_texts_path, siglip_edges_path (the manifests), output_dir=<tmp>, "
              f"epochs=2, num_workers={QUALITY_WORKERS}, batch_size={SIGLIP_BATCH} (20: see the "
              f"memory line); {steps} steps and {val_batches} validation batches an epoch, a "
              f"bank of {SIGLIP_BATCH * 40} texts a step", flush=True)
        full, resumed, counts, wall, peak_gib = _runs_through_main(
            torch, label, cfg)
        hist = full["history"]
        for h in hist:
            print(f"{label}: epoch {h['epoch']}: train loss {h['loss']:.4f}, val loss "
                  f"{h['val_loss']:.4f}, val R@1 {h['val_Recall@1']:.3f} R@5 "
                  f"{h['val_Recall@5']:.3f} MRR {h['val_MRR']:.3f} alignment "
                  f"{h['val_alignment']:.4f}, tree_recall@5 "
                  f"{h['val_semantic/tree_recall@5']:.3f}, segment_severity_alignment@15 "
                  f"{h.get('val_semantic/segment_severity_alignment@15', float('nan')):.3f}, "
                  f"temperature {h['temperature']:.5f}, lr {h['lr']:.2e}", flush=True)
        chunks = _bank_chunks(Path(full["output_dir"]))
        want = {k: 2 * (SIGLIP_PER_STEP[k] * steps + SIGLIP_PER_VAL[k] * val_batches)
                + PER_BANK_CHUNK[k] * chunks for k in SIGLIP_PER_STEP}
        out = _run_checks(torch, label, full, counts, want)
        semantic = sorted(k for k in hist[1] if k.startswith("val_semantic/"))
        check("val_semantic/tree_recall@5" in semantic and all(
            math.isfinite(hist[1][k]) for k in semantic), f"{label}: semantic panel {semantic}")
        print(f"{label}: semantic panel {', '.join(f'{k[4:]} {hist[1][k]:.3f}' for k in semantic)}",
              flush=True)
        _check_resume(torch, label, full, resumed)
        times = _epoch_times(label, hist, steps, SIGLIP_BATCH, "clips", peak_gib, wall)
        times.update(out, memory=memory, batch_size=SIGLIP_BATCH)

        runner = VideoContrastiveLearningRunner(cfg("trace"))
        batch = _profile_step(torch, "siglip profile", runner, times)
        mask = batch["attention_mask"]
        valid = batch["text_valid"]
        real = mask.sum(1)
        print(f"siglip attention: the bank's mask [{mask.shape[0]},{mask.shape[1]}]: "
              f"{int(valid.sum())} real texts, {int(mask.sum())} real tokens of {mask.numel()} "
              f"(shortest {int(real.min())}, longest {int(real.max())})", flush=True)
        vmask = batch["video_mask"]
        del runner, batch
        torch.cuda.empty_cache()
        rows = _attention_rows(torch, "siglip attention", [
            ("the SigLIP bank's padding mask", mask.shape[0], 12, mask.shape[1],
             mask.shape[1], mask, False)], seed=24)
        *agg, agg_f, agg_b = _aggregator_attention(torch, vmask, "siglip attention", H=16,
                                                   Dh=32, timed=True)
    rows = (rows[0] + [agg_f], rows[1] + [agg_b])
    return {"counts": counts, "rows": rows, "times": times, "aggregator_max_abs_err": agg,
            "bank_mask": mask}


def phase_multivideo_run(torch, manifest: Path) -> dict:
    """Phase 25: config/clip/multivideo_config.yaml through main on the
    corpus of ``manifest`` grouped into studies; returns as phase 24."""
    from deepcoro_clip_tpu_torch.data.synthetic_angio import write_study_manifest
    from deepcoro_clip_tpu_torch.runners.contrastive import VideoContrastiveLearningRunner

    label = "multivideo run"
    studies = write_study_manifest(manifest.parent, seed=0)
    n = _study_counts(studies)
    steps = n["train"] // MV_BATCH
    val_batches = -(-n["val"] // MV_BATCH)
    print(f"{label}: config/clip/multivideo_config.yaml with data_filename={studies.name} "
          f"({n['train']} train and {n['val']} val studies of 2 to 4 clips, "
          f"write_study_manifest), output_dir=<tmp>, epochs=2, num_workers={QUALITY_WORKERS}; "
          f"nothing else changed: {steps} step(s) and {val_batches} validation batch(es) an "
          "epoch", flush=True)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)

        def cfg(name, **over):
            return multivideo_config(data_filename=str(studies), output_dir=str(tmp / name),
                                     epochs=2, num_workers=QUALITY_WORKERS, **over)

        full, resumed, counts, wall, peak_gib = _runs_through_main(
            torch, label, cfg)
        hist = full["history"]
        for h in hist:
            print(f"{label}: epoch {h['epoch']}: train loss {h['loss']:.4f}, val loss "
                  f"{h['val_loss']:.4f}, val R@1 {h['val_Recall@1']:.3f} MRR "
                  f"{h['val_MRR']:.3f} alignment {h['val_alignment']:.4f}, temperature "
                  f"{h['temperature']:.5f}, lr {h['lr']:.2e}", flush=True)
        chunks = _bank_chunks(Path(full["output_dir"]))
        want = {k: 2 * (MV_PER_STEP[k] * steps + MV_PER_VAL[k] * val_batches)
                + PER_BANK_CHUNK[k] * chunks for k in MV_PER_STEP}
        out = _run_checks(torch, label, full, counts, want)
        _check_resume(torch, label, full, resumed)
        times = _epoch_times(label, hist, steps, MV_BATCH, "studies", peak_gib, wall)
        times.update(out)

        runner = VideoContrastiveLearningRunner(cfg("trace"))
        batch = _profile_step(torch, "multivideo profile", runner, times)
        mask, vmask = batch["attention_mask"], batch["video_mask"]
        print(f"multivideo attention: the reports' mask [{mask.shape[0]},{mask.shape[1]}]: "
              f"{int(mask.sum())} real tokens of {mask.numel()}; {int(vmask.sum())} real clips "
              f"of {vmask.numel()}", flush=True)
        del runner, batch
        torch.cuda.empty_cache()
        rows = _attention_rows(torch, "multivideo attention", [
            ("the study reports' padding mask", mask.shape[0], 12, mask.shape[1],
             mask.shape[1], mask, False)], seed=25)
        *agg, agg_f, agg_b = _aggregator_attention(torch, vmask, "multivideo attention",
                                                   timed=True)
    rows = (rows[0] + [agg_f], rows[1] + [agg_b])
    return {"counts": counts, "rows": rows, "times": times, "aggregator_max_abs_err": agg}


# --------------------------------------------------------------------------- #
# phases 30 and 31: single-head SigLIP pretraining through main, at
# config/clip/siglip_single_head_config.yaml, without and with the LocCa head


def siglip_single_head_config(**over):
    """config/clip/siglip_single_head_config.yaml, field by field (a CPU test
    holds this dict equal to the YAML as the port's parser reads it)."""
    from deepcoro_clip_tpu_torch.configs import ClipConfig

    d = dict(
        pipeline_project="DeepCORO_clip", run_mode="train", epochs=30, num_workers=8,
        seed=42, data_filename="output_dataset/siglip_generated/videos.csv",
        datapoint_loc_label="FileName", target_label=None, frames=16, stride=1, resize=224,
        batch_size=20, multi_video=False, max_text_length=512,
        siglip_texts_path="output_dataset/siglip_generated/texts.csv",
        siglip_edges_path="output_dataset/siglip_generated/edges.csv",
        siglip_sampler="single_head", siglip_max_positive_per_video=8,
        siglip_negatives_per_video=32, siglip_round_robin_sampling=True,
        siglip_base_negative_weight=0.04, siglip_contradiction_boost=1.0,
        siglip_contradiction_min_severity="moderate", siglip_enable_severity_weighting=True,
        siglip_bias_init=-10.0, loss_name="siglip_single_head", model_name="mvit",
        vit_dim=512, vit_depth=12, vit_heads=4, vit_patch=[2, 16, 16], vit_pool_stages=[3],
        use_cls_token=True, embedding_dim=512, num_heads=16, aggregator_depth=1, dropout=0.12,
        optimizer="AdamW", scheduler_name="linear_warmup", lr=0.00002,
        video_weight_decay=0.00001, text_weight_decay=0.0000001, video_max_grad_norm=1.0,
        text_max_grad_norm=1.0, video_freeze_ratio=0.8, text_freeze_ratio=0.75,
        temperature=0.07, precision="bf16", use_pallas_attention=True, use_wandb=False,
    )
    d.update(over)
    return ClipConfig.from_dict(d)


# phase 30's launches are phase 24's (the sampler changes what the bank holds,
# not its shape); phase 31's LocCa head (ClipConfig's defaults: 4 layers, d
# 512, 8 heads, 256 tokens) adds per layer a causal self-attention at
# [B,8,256,64] under the caption mask and a cross-attention at [B,8,256|393,64]
# over the clip's tokens, all on the long kernels, forward and backward in a
# train step, forward in a validation batch
LOCCA_LAYERS = 4
LOCCA_PER_STEP = {k: v + 2 * LOCCA_LAYERS * (k in ("K3", "K4", "K3 long", "K4 long"))
                  for k, v in SIGLIP_PER_STEP.items()}
LOCCA_PER_VAL = {k: v + 2 * LOCCA_LAYERS * (k in ("K3", "K3 long"))
                 for k, v in SIGLIP_PER_VAL.items()}


def _held_gib(torch) -> float:
    """What the card holds before a run, once the garbage of earlier phases
    is collected: a run's own peak is its peak less this."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2 ** 30


def _single_head_cfg(paths: dict, tmp: Path, **fixed):
    """siglip_single_head_config() on the corpus's manifests, as phase 24
    cuts it: data, epochs 2, the workers, batch_size SIGLIP_BATCH."""
    def cfg(name, **over):
        return siglip_single_head_config(
            data_filename=str(paths["videos"]), siglip_texts_path=str(paths["texts"]),
            siglip_edges_path=str(paths["edges"]), epochs=2, num_workers=QUALITY_WORKERS,
            output_dir=str(tmp / name), batch_size=SIGLIP_BATCH, **fixed, **over)
    return cfg


def _bank_record(record: list):
    """Wrap the runner's collate_single_head: each batch's bank lands in
    ``record`` as (real texts, dropped texts, positives, share of the W
    matrix over the real bank that is not 0, fewest positives a row, rows).
    Returns the undo."""
    from deepcoro_clip_tpu_torch.runners import contrastive

    inner = contrastive.collate_single_head

    def wrapped(*args, **kw):
        b = inner(*args, **kw)
        m = int(b["text_valid"].sum())
        w, pos = b["positive_weights"][:, :m], b["positive_mask"]
        record.append((m, int(b["n_dropped_texts"]), int(pos.sum()),
                       float((w != 0).mean()) if m else 0.0, int(pos.sum(1).min()),
                       pos.shape[0]))
        return b

    contrastive.collate_single_head = wrapped
    return lambda: setattr(contrastive, "collate_single_head", inner)


def _print_banks(label: str, record: list, steps: int, val_batches: int) -> None:
    """The banks of one run (its collates in order: each epoch's train
    batches, then its validation batches) and their checks."""
    check(len(record) == 2 * (steps + val_batches),
          f"{label}: {len(record)} banks for {2 * (steps + val_batches)} batches")
    per = steps + val_batches
    for i, (m, dropped, npos, nz, least, rows) in enumerate(record):
        epoch, j = divmod(i, per)
        kind = f"step {j}" if j < steps else f"validation batch {j - steps}"
        print(f"{label}: epoch {epoch} {kind}: bank of {m} real texts of "
              f"{SIGLIP_BATCH * 40} slots, {dropped} dropped, {npos} positive pairs, W not 0 "
              f"on {nz:.1%} of [{rows},{m}], fewest positives a row {least}", flush=True)
    check(all(r[0] > 0 and r[4] >= 1 for r in record),
          f"{label}: a bank without texts or a row without a positive: {record}")


def phase_single_head_run(torch, manifest: Path, memory: dict) -> dict:
    """Phase 30: config/clip/siglip_single_head_config.yaml through main on
    the SigLIP manifests of the corpus of ``manifest``, at phase 24's batch
    (``memory``: phase 24's reckoning); returns {"counts", "times"}."""
    from deepcoro_clip_tpu_torch.data.dataset_creation import build_siglip_manifests
    from deepcoro_clip_tpu_torch.runners.contrastive import VideoContrastiveLearningRunner

    label = "single-head run"
    paths = build_siglip_manifests(siglip_rows(manifest, seed=0),
                                   manifest.parent / "siglip_single_head",
                                   cto_columns=siglip_cto_columns())
    steps = QUALITY_TRAIN // SIGLIP_BATCH  # the sharded order drops the last partial batch
    val_batches = -(-QUALITY_VAL // SIGLIP_BATCH)
    print(f"{label}: config/clip/siglip_single_head_config.yaml with data_filename, "
          f"siglip_texts_path, siglip_edges_path (phase 24's manifests, written anew), "
          f"output_dir=<tmp>, epochs=2, num_workers={QUALITY_WORKERS}, "
          f"batch_size={SIGLIP_BATCH}; {steps} steps and {val_batches} validation batches an "
          f"epoch, a bank of at most {SIGLIP_BATCH} x (8 + 32) texts of 512 tokens a batch",
          flush=True)
    print(f"{label}: the batch cut: the bank has phase 24's shape, so phase 24's reckoning "
          f"holds: {memory['gib_per_video']:.2f} GiB a video with its 40 texts, "
          f"{memory['reckoned_gib_at_20']:.1f} GiB reckoned at the YAML's 20 against the "
          f"card's {memory['card_gib']:.1f}, at most batch "
          f"{memory['largest_batch_within_margin']} within {CARD_MARGIN:.0%} of it | {CARD}",
          flush=True)
    record: list = []
    undo = _bank_record(record)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        cfg = _single_head_cfg(paths, tmp)
        held = _held_gib(torch)
        try:
            full, _, counts, wall, peak_gib = _runs_through_main(
                torch, label, cfg, resume=False)
        finally:
            undo()
        hist = full["history"]
        for h in hist:
            print(f"{label}: epoch {h['epoch']}: train loss {h['loss']:.4f}, val loss "
                  f"{h['val_loss']:.4f}, val R@1 {h['val_Recall@1']:.3f} R@5 "
                  f"{h['val_Recall@5']:.3f} MRR {h['val_MRR']:.3f} alignment "
                  f"{h['val_alignment']:.4f}, tree_recall@5 "
                  f"{h['val_semantic/tree_recall@5']:.3f}, temperature "
                  f"{h['temperature']:.5f}, lr {h['lr']:.2e}", flush=True)
        _print_banks(label, record, steps, val_batches)
        chunks = _bank_chunks(Path(full["output_dir"]))
        want = {k: 2 * (SIGLIP_PER_STEP[k] * steps + SIGLIP_PER_VAL[k] * val_batches)
                + PER_BANK_CHUNK[k] * chunks for k in SIGLIP_PER_STEP}
        out = _run_checks(torch, label, full, counts, want)
        semantic = sorted(k for k in hist[1] if k.startswith("val_semantic/"))
        check("val_semantic/tree_recall@5" in semantic and all(
            math.isfinite(hist[1][k]) for k in semantic), f"{label}: semantic panel {semantic}")
        print(f"{label}: semantic panel {', '.join(f'{k[4:]} {hist[1][k]:.3f}' for k in semantic)}",
              flush=True)
        times = _epoch_times(label, hist, steps, SIGLIP_BATCH, "clips", peak_gib, wall)
        times["run_peak_gib"] = peak_gib - held
        print(f"{label}: the run's own peak {times['run_peak_gib']:.2f} GiB over the "
              f"{held:.2f} GiB the card held before it | {CARD}", flush=True)
        times.update(out, batch_size=SIGLIP_BATCH,
                     banks=[dict(zip(("texts", "dropped", "positives", "w_nonzero_share",
                                      "fewest_positives", "rows"), r)) for r in record])
        runner = VideoContrastiveLearningRunner(cfg("trace"))
        _profile_step(torch, "single-head profile", runner, times)
        del runner
        torch.cuda.empty_cache()
    return {"counts": counts, "times": times}


def phase_locca_run(torch, manifest: Path, single_head: dict) -> dict:
    """Phase 31: phase 30's run with ``locca_enabled: true`` (ClipConfig's
    LocCa defaults), resumed once; returns {"counts", "rows" (K3 rows, K4
    rows), "times"}."""
    from deepcoro_clip_tpu_torch.models.video_encoder import clip_token_count
    from deepcoro_clip_tpu_torch.runners.contrastive import VideoContrastiveLearningRunner

    label = "locca run"
    paths = {k: manifest.parent / "siglip_single_head" / f"{k}.csv"
             for k in ("videos", "texts", "edges")}
    steps = QUALITY_TRAIN // SIGLIP_BATCH
    val_batches = -(-QUALITY_VAL // SIGLIP_BATCH)
    made: list = []
    init = VideoContrastiveLearningRunner.__init__

    def capture(self, *args, **kw):
        init(self, *args, **kw)
        # the decoder as built, and each step's LocCa loss (read after the run)
        self.locca_init = {k: v.detach().clone() for k, v in self.state.params.items()
                           if k.startswith("locca_decoder.")}
        self.locca_losses = []
        step = self.train_step

        def recording(state, *a):
            state, metrics = step(state, *a)
            self.locca_losses.append(metrics["locca_loss"])
            return state, metrics

        self.train_step = recording
        made.append(self)

    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        cfg = _single_head_cfg(paths, tmp, locca_enabled=True)
        c = cfg("probe")
        tokens = clip_token_count(c)
        print(f"{label}: phase 30's run with locca_enabled=true and ClipConfig's LocCa "
              f"defaults: {c.locca_num_layers} layers, d {c.locca_d_model}, "
              f"{c.locca_num_heads} heads, {c.locca_max_seq_len} tokens, weight "
              f"{c.locca_weight}; the decoder reads the clip's {tokens} tokens; targets: each "
              "clip's report rebuilt from its positives (locca_report)", flush=True)
        check(c.locca_num_layers == LOCCA_LAYERS, f"{label}: {c.locca_num_layers} layers")
        held = _held_gib(torch)
        VideoContrastiveLearningRunner.__init__ = capture
        try:
            full, resumed, counts, wall, peak_gib = _runs_through_main(
                torch, label, cfg)
        finally:
            VideoContrastiveLearningRunner.__init__ = init
        hist = full["history"]
        for h in hist:
            print(f"{label}: epoch {h['epoch']}: train loss {h['loss']:.4f} (LocCa "
                  f"{h['locca_loss']:.4f}, decoder grad norm {h['grad_norm_locca_decoder']:.4f}),"
                  f" val loss {h['val_loss']:.4f} (LocCa {h['val_locca_loss']:.4f}), val R@1 "
                  f"{h['val_Recall@1']:.3f} MRR {h['val_MRR']:.3f}, temperature "
                  f"{h['temperature']:.5f}, lr {h['lr']:.2e}", flush=True)
        chunks = _bank_chunks(Path(full["output_dir"]))
        want = {k: 2 * (LOCCA_PER_STEP[k] * steps + LOCCA_PER_VAL[k] * val_batches)
                + PER_BANK_CHUNK[k] * chunks for k in LOCCA_PER_STEP}
        out = _run_checks(torch, label, full, counts, want)
        whole = made[0]
        losses = [float(x) for x in whole.locca_losses]
        print(f"{label}: LocCa loss of each of the whole run's {len(losses)} steps: "
              + ", ".join(f"{x:.4f}" for x in losses), flush=True)
        check(len(losses) == 2 * steps and all(math.isfinite(x) for x in losses),
              f"{label}: LocCa losses {losses}")
        final = torch.load(Path(full["output_dir"]) / "checkpoints" / "checkpoint.pt",
                           weights_only=True)["params"]
        still = [k for k, v in whole.locca_init.items() if torch.equal(final[k], v.cpu())]
        print(f"{label}: {len(whole.locca_init) - len(still)} of {len(whole.locca_init)} "
              f"decoder tensors moved over the run", flush=True)
        check(whole.locca_init and not still, f"{label}: decoder tensors unmoved: {still[:5]}")
        _check_resume(torch, label, full, resumed)
        times = _epoch_times(label, hist, steps, SIGLIP_BATCH, "clips", peak_gib, wall)
        times.update(out, batch_size=SIGLIP_BATCH, locca_losses=losses)
        times["run_peak_gib"] = peak_gib - held
        plain_peak = single_head["times"]["run_peak_gib"]
        print(f"{label}: the run's own peak {times['run_peak_gib']:.2f} GiB over the "
              f"{held:.2f} GiB the card held before it, against phase 30's {plain_peak:.2f} "
              f"(the head's share {times['run_peak_gib'] - plain_peak:+.2f} GiB at batch "
              f"{SIGLIP_BATCH}) | {CARD}", flush=True)
        del made, whole
        runner = VideoContrastiveLearningRunner(cfg("trace"))
        batch = _profile_step(torch, "locca profile", runner, times)
        args = (runner.generator, c.video_freeze_ratio, c.text_freeze_ratio, -1.0)
        plain = {k: v for k, v in batch.items()
                 if k not in ("caption_ids", "caption_mask", "location_mask")}
        runner.train_step(runner.state, plain, *args)  # warm
        per_plain, _ = device_events(torch, lambda: runner.train_step(runner.state, plain,
                                                                      *args))
        times["busy_ms_without_head"] = sum(per_plain.values())
        without = share(times["busy_ms_without_head"], times["busy_ms"])
        times["decoder_share"] = None if without is None else 1 - without
        print(f"locca profile: the same batch without caption ids (the head not run, its "
              f"optimizer update still): busy {times['busy_ms_without_head']:.2f} ms; the "
              f"LocCa head's share of the step's busy {times['busy_ms']:.2f} ms: "
              f"{fmt(times['decoder_share'], '.1%')} | {CARD}", flush=True)
        cap_mask = batch["caption_mask"]
        print(f"locca attention: the caption mask [{cap_mask.shape[0]},{cap_mask.shape[1]}]: "
              f"{int(cap_mask.sum())} real tokens of {cap_mask.numel()} (shortest "
              f"{int(cap_mask.sum(1).min())}, longest {int(cap_mask.sum(1).max())})", flush=True)
        del runner, batch, plain
        torch.cuda.empty_cache()
        B, L = cap_mask.shape
        rows = _attention_rows(torch, "locca attention", [
            ("the LocCa decoder's causal self-attention, the captions' padding mask", B,
             c.locca_num_heads, L, L, cap_mask, True),
            ("the LocCa decoder's cross-attention over the clip's tokens, no mask", B,
             c.locca_num_heads, L, tokens, None, False)], seed=31)
        times["decoder_attention_busy_ms"] = LOCCA_LAYERS * sum(
            r["device_ms"] for r in rows[0] + rows[1])
        print(f"locca attention: the decoder's K3/K4 a train step, busy "
              f"{times['decoder_attention_busy_ms']:.3f} ms ({LOCCA_LAYERS} layers x the two "
              f"calls forward and backward) of the step's {times['busy_ms']:.2f} | {CARD}",
              flush=True)
    return {"counts": counts, "rows": rows, "times": times}


# --------------------------------------------------------------------------- #
# phase 26: the long K3/K4 kernels at the SigLIP bank: the skip's cases and
# its exactness


def _long_grads(flash_attention, torch, q, k, v, do, mask):
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, kv_mask=mask)
    return out.detach(), torch.autograd.grad(out, leaves, do)


def phase_long_kernels(torch, bank_mask) -> dict:
    """Phase 26, at phase 24's bank ([B, 12, 512, 64], ``bank_mask`` the
    step's own [B, 512] text mask): the mirror's prediction of the key
    tiles the three kernels visit; K3/K4 against their plain versions with
    times, busy times, bound and SDPA at a bank whose rows are all real
    prompts of 2 to 21 tokens (the gain must not rest on filler rows) and
    at one whose every key is real (nothing skipped); at the bank's mask
    the forward and dQ bit-equal to a call whose K, V and mask are cut to
    ``key_cut`` keys, dK and dV exactly 0 past the cut, two calls bit-equal,
    batch rows alone (B = 1) and in fours (B = 4) bit-equal to the batch;
    the kernels a call runs, by profiler name. Returns {"rows": (K3 rows,
    K4 rows), "cut": ..., "routes": ...}."""
    from deepcoro_clip_tpu_torch.ops import _flash_cuda
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention

    label = "long kernels"
    dev = torch.device("cuda")
    B, L = bank_mask.shape
    H, Dh = 12, 64
    for what, tiles in (("forward", _flash_cuda.FWD_TILES), ("dQ", _flash_cuda.DQ_TILES),
                        ("dK/dV", _flash_cuda.DKV_TILES)):
        seen = int(_flash_cuda.visited_key_tiles(bank_mask, B, L, L, False, tiles).sum())
        total = B * -(-L // tiles[0]) * -(-L // tiles[1])
        print(f"{label}: at the bank's mask the {what} kernel visits {seen} of {total} (q "
              f"tile, key tile) pairs of {tiles[0]} x {tiles[1]} a head (the skip rule's "
              f"mirror, _flash_cuda.visited_key_tiles)", flush=True)
    g = torch.Generator().manual_seed(26)
    lengths = torch.randint(2, 22, (B,), generator=g)
    prompts = (torch.arange(L)[None, :] < lengths[:, None]).to(bank_mask.dtype).to(dev)
    every = torch.ones_like(bank_mask)
    rows = _attention_rows(torch, label, [
        ("every row a real prompt of 2 to 21 tokens", B, H, L, L, prompts, False),
        ("every key real (nothing skipped)", B, H, L, L, every, False)], seed=26)

    # exactness at the bank's mask
    gq = torch.Generator(device=dev).manual_seed(27)

    def heads(n):
        t = torch.randn(B, n, H * Dh, generator=gq, device=dev).to(torch.bfloat16)
        return t.reshape(B, n, H, Dh).transpose(1, 2)

    q, k, v, do = heads(L), heads(L), heads(L), heads(L)
    cut = _flash_cuda.key_cut(bank_mask, B, L)
    out, got = _long_grads(flash_attention, torch, q, k, v, do, bank_mask)
    out2, got2 = _long_grads(flash_attention, torch, q, k, v, do, bank_mask)
    out_c, got_c = _long_grads(flash_attention, torch, q, k[:, :, :cut], v[:, :, :cut], do,
                               bank_mask[:, :cut].contiguous())
    torch.cuda.synchronize()
    check(torch.equal(out, out_c) and torch.equal(got[0], got_c[0]),
          f"{label}: the forward or dQ differs from the call cut to {cut} keys")
    check(all(torch.equal(a[:, :, :cut], b) for a, b in zip(got[1:], got_c[1:])),
          f"{label}: dK or dV differs from the call cut to {cut} keys")
    past = max(float(a[:, :, cut:].abs().max()) for a in got[1:]) if cut < L else 0.0
    check(past == 0.0, f"{label}: dK or dV past the cut is {past}, not 0")
    check(torch.equal(out, out2) and all(torch.equal(a, b) for a, b in zip(got, got2)),
          f"{label}: two calls differ")
    for i in (0, B // 2, B - 4):
        for n in (1, 4):
            sl = slice(i, i + n)
            o1, g1 = _long_grads(flash_attention, torch, q[sl], k[sl], v[sl], do[sl],
                                 bank_mask[sl])
            check(torch.equal(out[sl], o1) and all(torch.equal(a[sl], b)
                                                    for a, b in zip(got, g1)),
                  f"{label}: batch rows {i}..{i + n - 1} alone differ from the batch of {B}")
    print(f"{label}: at the bank's mask [{B},{H},{L},{Dh}]: the forward and dQ bit-equal to "
          f"the call cut to {cut} keys, dK and dV bit-equal there and exactly 0 past it; two "
          f"calls bit-equal; B = 1 and B = 4 bit-equal to the batch of {B}", flush=True)
    del out2, got2, out_c, got_c

    # the kernels a call runs
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = flash_attention(*leaves, kv_mask=bank_mask)
    fwd = _launches(torch, lambda: flash_attention(q, k, v, kv_mask=bank_mask), calls=2)
    bwd = _launches(torch, lambda: torch.autograd.grad(o, leaves, do, retain_graph=True),
                    calls=2)
    if fwd is None or bwd is None:
        ours = [["not traced"], ["not traced"]]
        print(f"{label}: the kernels of a call at the bank not traced (the profiler traced "
              f"no device event)", flush=True)
    else:
        ours = [[n for n in run if n.startswith(PORT_KERNELS)] for run in (fwd, bwd)]
        check(ours == [list(TILE_FWD), list(TILE_BWD)],
              f"{label}: the bank's call ran {fwd} / {bwd}, expected {TILE_FWD} / {TILE_BWD}")
        print(f"{label}: a forward at the bank ran {fwd}, a backward {bwd}", flush=True)
    del q, k, v, do, out, got, leaves, o
    torch.cuda.empty_cache()
    return {"rows": rows, "cut": cut, "routes": {"K3": ours[0], "K4": ours[1]}}


# --------------------------------------------------------------------------- #
# phase 27: the linear-probing run through main, at
# config/linear_probing/stenosis_config.yaml, on phase 22's backbone

PROBE_RUN_STUDIES = (("train", 24), ("val", 16))
PROBE_RUN_CLIPS = (6, 10)  # clips a study, drawn
PROBE_RUN_CALCIF = 0.3  # the share of studies calcif_binary marks (a seeded draw)
# launches per train step and per validation or inference batch, K5 on
# (DEEPCORO_FUSED_OUTPROJ=1): the 12 backbone blocks (3 at L 1569, 9 at 393)
# and the head's one fp32 CLS block [8,8,11,64] (the short kernels); with the
# switch off K1 takes K5's place
PROBE_RUN_PER_STEP = {"K1": 0, "K2": 0, "K3": 1, "K4": 1, "K5": 12, "K6": 0,
                      "K3 long": 0, "K4 long": 0}
PROBE_RUN_PER_BATCH = {"K1": 0, "K2": 0, "K3": 1, "K4": 0, "K5": 12, "K6": 0,
                       "K3 long": 0, "K4 long": 0}
PROBE_RUN_PER_BATCH_K1 = dict(PROBE_RUN_PER_BATCH, K1=12, K5=0)


def probe_study_manifest(manifest: Path, out: Path, seed: int = 0) -> tuple:
    """Phase 22's clips grouped into studies of 6 to 10 clips, 24 train and
    16 val (each study's clips drawn from its split's without repeats, so a
    clip may serve several studies), labelled from the findings that
    rendered the study's first clip, the row whose targets VideoDataset
    reads (synthetic_angio.probe_labels_for, the corpus' seed 0; over all
    of a study's 6 to 10 clips nearly every study would be positive):
    stenosis <- max_stenosis_pct, stenosis_binary <- severe_any, CTO <-
    cto_any; calcif_binary is a seeded draw (the corpus renders no
    calcium). Returns (path, rows)."""
    from deepcoro_clip_tpu_torch.data.csv_utils import read_csv_with_fallback, write_csv
    from deepcoro_clip_tpu_torch.data.synthetic_angio import probe_labels_for

    clips = read_csv_with_fallback(manifest).rows
    rng = np.random.default_rng(seed)
    rows = []
    for split, n_studies in PROBE_RUN_STUDIES:
        pool = [c for c in clips if c["Split"] == split]
        for s in range(n_studies):
            n = int(rng.integers(PROBE_RUN_CLIPS[0], PROBE_RUN_CLIPS[1] + 1))
            members = [pool[int(i)] for i in rng.choice(len(pool), n, replace=False)]
            first = probe_labels_for(int(str(members[0]["StudyInstanceUID"])
                                         .replace("SYN", "")), 0)
            calcif = float(rng.random() < PROBE_RUN_CALCIF)
            for c in members:
                rows.append({"FileName": c["FileName"], "StudyInstanceUID": f"P{split}{s:03d}",
                             "Split": split, "stenosis": first["max_stenosis_pct"],
                             "stenosis_binary": first["severe_any"], "calcif_binary": calcif,
                             "CTO": first["cto_any"]})
    write_csv(out, list(rows[0]), rows)
    return out, rows


def _capture(cls, made: list):
    """Wrap ``cls.__init__`` so that each instance main builds lands in
    ``made``; returns the undo."""
    init = cls.__init__

    def capture(self, *args, **kw):
        init(self, *args, **kw)
        made.append(self)

    cls.__init__ = capture
    return lambda: setattr(cls, "__init__", init)


def _fused_switch(on: bool) -> None:
    """DEEPCORO_FUSED_OUTPROJ, read when a runner builds its encoder."""
    import os

    os.environ["DEEPCORO_FUSED_OUTPROJ"] = "1" if on else "0"


def _inference_files(runner):
    from deepcoro_clip_tpu_torch.data.csv_utils import read_csv_with_fallback

    run = Path(runner.output_dir) / "inference"
    preds = read_csv_with_fallback(run / "predictions.csv").rows
    emb = np.load(run / "study_embeddings.npz")
    return preds, emb["embeddings"], emb["study_ids"].tolist()


def phase_probing_run(torch, manifest: Path, backbone: Path, tmp: Path) -> dict:
    """Phase 27 on phase 22's corpus and checkpoint ``backbone``; returns
    {"counts": launches of the train run, "val_counts", "infer_counts":
    {"K5", "K1"}, "times": ...}."""
    import os

    import torch.nn.functional as F

    from deepcoro_clip_tpu_torch.convert import flatten_tree, module_to_jax_tree
    from deepcoro_clip_tpu_torch.main import main
    from deepcoro_clip_tpu_torch.models.video_encoder import init_params
    from deepcoro_clip_tpu_torch.runners import linear_probing as lp
    from deepcoro_clip_tpu_torch.runners.common import batch_to_device
    from deepcoro_clip_tpu_torch.train.linear_probe import mil_from_config

    studies, rows = probe_study_manifest(manifest, tmp / "probe_studies.csv")
    heads = ("stenosis", "stenosis_binary", "calcif_binary", "CTO")
    by_study = {}
    for r in rows:
        by_study.setdefault((r["Split"], r["StudyInstanceUID"]), []).append(r)
    uses = {}
    for r in rows:
        uses[r["FileName"]] = uses.get(r["FileName"], 0) + 1
    for split, n in PROBE_RUN_STUDIES:
        st = [v for (s, _), v in by_study.items() if s == split]
        pos = {h: sum(v[0][h] > 0 for v in st) for h in heads[1:]}
        print(f"probing run: {split}: {n} studies of {min(map(len, st))} to "
              f"{max(map(len, st))} clips ({sum(map(len, st))} clip slots over "
              f"{len({r['FileName'] for v in st for r in v})} clips: a clip serves up to "
              f"{max(uses[r['FileName']] for v in st for r in v)} studies); positives "
              + ", ".join(f"{h} {pos[h]}" for h in pos)
              + f"; stenosis {min(v[0]['stenosis'] for v in st):.0f} to "
              f"{max(v[0]['stenosis'] for v in st):.0f} %", flush=True)
    print("probing run: labels from synthetic_angio.probe_labels_for of each study's first "
          "clip (the row VideoDataset reads targets from): stenosis <- max_stenosis_pct, "
          "stenosis_binary <- severe_any, CTO <- cto_any; calcif_binary a seeded draw (p "
          f"{PROBE_RUN_CALCIF}: the corpus renders no calcium)", flush=True)

    def cfg(name, **over):
        return probe_config(data_filename=str(studies), output_dir=str(tmp / "probe" / name),
                            epochs=2, video_encoder_checkpoint_path=str(backbone), **over)

    print(f"probing run: config/linear_probing/stenosis_config.yaml with data_filename="
          f"{studies.name} (phase 22's clips as studies), output_dir=<tmp>, "
          f"video_encoder_checkpoint_path=<phase 22's checkpoint.pt>, epochs=2 (the YAML: "
          f"25); nothing else changed (ci_n_bootstrap {cfg('x').ci_n_bootstrap}, "
          f"num_workers {cfg('x').num_workers}); DEEPCORO_FUSED_OUTPROJ=1 (K5) unless "
          "said", flush=True)
    made: list = []
    undo = _capture(lp.LinearProbingRunner, made)
    switch = os.environ.get("DEEPCORO_FUSED_OUTPROJ")
    try:
        _fused_switch(True)
        full, resumed, counts, wall, peak_gib = _runs_through_main(
            torch, "probing run", cfg)
        hist = full["history"]
        steps = PROBE_RUN_STUDIES[0][1] // 8
        val_batches = -(-PROBE_RUN_STUDIES[1][1] // 8)
        for h in hist:
            print(f"probing run: epoch {h['epoch']}: train loss {h['loss']:.4f} ("
                  + ", ".join(f"{k} {h['loss_' + k]:.4f}" for k in heads)
                  + f"), val loss {h['val_loss']:.4f}, val stenosis MAE "
                  f"{h['val_stenosis/mae']:.2f}, AUROC stenosis_binary "
                  f"{h['val_stenosis_binary/auc']:.3f} CTO {h['val_CTO/auc']:.3f} calcif "
                  f"{h['val_calcif_binary/auc']:.3f}, lr {h['lr']:.2e}", flush=True)
        check(len(hist) == 2 and all(math.isfinite(h[k]) for h in hist + resumed["history"]
                                     for k in ("loss", "val_loss")),
              f"probing run: losses {hist}")
        want = {k: PROBE_RUN_PER_STEP[k] * steps * 2 + PROBE_RUN_PER_BATCH[k] * val_batches * 2
                for k in PROBE_RUN_PER_STEP}
        print(f"probing run: launches over 2 x {steps} train steps and 2 x {val_batches} "
              "validation batches: " + ", ".join(f"{k} {counts[k]} (predicted {want[k]})"
                                                 for k in want), flush=True)
        check(counts == want, f"probing run: launches {counts}, predicted {want}")

        # the encoder from phase 22's checkpoint: every backbone leaf, none moved
        first = made[0]
        loaded, total = first.encoder_loaded
        tree = flatten_tree(module_to_jax_tree(first.bundle.video_model))
        backbone_leaves = sorted(k for k in tree if k.startswith("backbone/"))
        missing = sorted(set(backbone_leaves) - set(loaded))
        print(f"probing run: encoder leaves loaded from phase 22's checkpoint: {len(loaded)} of "
              f"{total} ({len(backbone_leaves) - len(missing)} of the {len(backbone_leaves)} "
              f"backbone leaves; not loaded: {sorted(set(tree) - set(loaded))[:6]})",
              flush=True)
        check(not missing, f"probing run: backbone leaves not loaded: {missing[:5]}")
        del first, tree
        src = torch.load(backbone, map_location="cpu", weights_only=True)["params"]
        final = torch.load(Path(full["output_dir"]) / "checkpoints" / "checkpoint.pt",
                           map_location="cpu", weights_only=True)["params"]
        enc = [k for k in final if k.startswith("video_encoder.backbone.")]
        moved = [k for k in enc if not torch.equal(final[k], src[k].float())]
        fresh = dict(init_params(mil_from_config(cfg("x")), cfg("x").seed + 1)
                     .named_parameters())
        stuck = [k for k, v in fresh.items() if torch.equal(final["mil." + k], v)]
        print(f"probing run: after 2 epochs {len(enc) - len(moved)} of {len(enc)} backbone "
              f"tensors equal to phase 22's (frozen), {len(fresh) - len(stuck)} of "
              f"{len(fresh)} head tensors moved from their seeded values", flush=True)
        check(not moved and not stuck, f"probing run: encoder moved {moved[:3]}, head stuck "
                                       f"{stuck[:3]}")
        del src, final, fresh
        _check_resume(torch, "probing run", full, resumed)
        h = hist[1]
        times = {"step_ms": h["epoch_seconds"] * 1e3 / steps,
                 "studies_per_s": 8 * steps / h["epoch_seconds"],
                 "loader_wait_ms": h["loader_wait_ms"], "validate_s": h["val_seconds"],
                 "validate_metrics_s": h["val_metrics_seconds"], "peak_gib": peak_gib,
                 "run_s": wall, "epoch0_seconds": hist[0]["epoch_seconds"]}
        print(f"probing run: step {times['step_ms']:.1f} ms (host clock, epoch 1: "
              f"{h['epoch_seconds']:.3f} s over {steps} steps, loader wait "
              f"{h['loader_wait_ms']:.2f} ms a step), {times['studies_per_s']:.2f} studies/s; "
              f"validation pass {h['val_seconds']:.3f} s (16 studies, of it per-head metrics "
              f"{h['val_metrics_seconds']:.3f} s, no bootstrap in training); peak memory "
              f"{peak_gib:.2f} GiB (torch.cuda.max_memory_allocated) | {CARD}", flush=True)

        # run_mode val: the bootstrap intervals (the head starts from its seed:
        # neither package reads `checkpoint` outside training)
        meta = json.loads((Path(full["output_dir"]) / "checkpoints" / "checkpoint.json")
                          .read_text())
        stats = dict(dataset_mean=meta["dataset_mean"], dataset_std=meta["dataset_std"])
        _zero_kernel_counts()
        val = main(config=cfg("val", run_mode="val", **stats))
        val_counts = {**_kernel_counts(), **_long_counts()}
        want = {k: v * val_batches for k, v in PROBE_RUN_PER_BATCH.items()}
        keys = {"stenosis": "mae", "stenosis_binary": "auc", "calcif_binary": "auc",
                "CTO": "auc"}
        print(f"probing run: run_mode val: loss {val['loss']:.4f}; "
              + ", ".join(f"{h} {keys[h]} {val[f'{h}/{keys[h]}']:.3f} [{val[f'{h}/{keys[h]}_ci']['lo']:.3f}, "
                          f"{val[f'{h}/{keys[h]}_ci']['hi']:.3f}]" for h in heads)
              + f" ({cfg('x').ci_confidence_level:.0%} intervals, {cfg('x').ci_n_bootstrap} "
              f"resamples); pass {val['seconds']:.3f} s, of it per-head metrics with the "
              f"bootstrap {val['metrics_seconds']:.3f} s | {CARD}", flush=True)
        print("probing run: run_mode val launches: " + ", ".join(
            f"{k} {val_counts[k]} (predicted {want[k]})" for k in want), flush=True)
        check(val_counts == want, f"probing run (val): launches {val_counts}, predicted {want}")
        check(all(f"{h}/{keys[h]}_ci" in val for h in heads), f"no intervals in {sorted(val)}")
        times.update(val_s=val["seconds"], val_bootstrap_s=val["metrics_seconds"])

        # run_mode inference with the study embeddings: K5 on, K1 (switch off),
        # and K5 at batch 2
        infer = {}
        infer_counts = {}
        for label, fused, bs in (("K5", True, 8), ("K1", False, 8), ("K5 batch 2", True, 2)):
            _fused_switch(fused)
            _zero_kernel_counts()
            t0 = time.perf_counter()
            res = main(config=cfg(f"infer_{len(infer)}", run_mode="inference",
                                  split_filter="val", batch_size=bs, **stats))
            seconds = time.perf_counter() - t0
            counts_i = {**_kernel_counts(), **_long_counts()}
            per = PROBE_RUN_PER_BATCH if fused else PROBE_RUN_PER_BATCH_K1
            want = {k: v * -(-PROBE_RUN_STUDIES[1][1] // bs) for k, v in per.items()}
            print(f"probing run: run_mode inference, {label} ({bs} studies a batch): "
                  f"{res['rows']} rows in {seconds:.2f} s through main (set-up included); "
                  "launches " + ", ".join(f"{k} {counts_i[k]} (predicted {want[k]})"
                                          for k in want), flush=True)
            check(res["rows"] == PROBE_RUN_STUDIES[1][1] and counts_i == want,
                  f"probing run (inference, {label}): {res}, launches {counts_i}")
            infer[label] = _inference_files(made[-1])
            infer_counts[label] = counts_i
        (p5, e5, ids5), (p1, e1, ids1), (p2, e2, ids2) = (infer[k] for k in
                                                          ("K5", "K1", "K5 batch 2"))
        check(ids5 == ids1 == ids2 and e5.shape == (16, 2 * cfg("x").embedding_dim),
              f"study ids or embedding shape differ: {e5.shape}")
        for label, (p, e) in (("K5 vs K1 + F.linear", (p1, e1)),
                              ("batch 8 vs batch 2", (p2, e2))):
            cos = float(F.cosine_similarity(torch.from_numpy(e5), torch.from_numpy(e),
                                            dim=1).min())
            d_emb = float(np.abs(e5 - e).max())
            d_out = max(abs(float(a[h]) - float(b[h])) for a, b in zip(p5, p) for h in heads)
            bits = bool(np.array_equal(e5, e)) and d_out == 0.0
            print(f"probing run: inference {label}: study embeddings min cosine {cos:.6f} "
                  f"(bar >= {E2E_MIN_COSINE}), max|d| {d_emb:.3e}; head outputs max|d| "
                  f"{d_out:.3e}; bit-equal {bits}", flush=True)
            check(cos >= E2E_MIN_COSINE, f"probing run: {label}: cosine {cos}")
            times[f"infer_{'k1' if 'K1' in label else 'b2'}_max_abs_emb"] = d_emb

        # one train step traced
        _fused_switch(True)
        runner = lp.LinearProbingRunner(cfg("trace", **stats), output_dir=tmp / "probe_trace")
        batch = batch_to_device(next(iter(runner.loaders["train"])), runner.device)
        runner.train_step(runner.state, batch, runner.generator, 1.0)  # warm
        per_name, wall_ms = device_events(
            torch, lambda: runner.train_step(runner.state, batch, runner.generator, 1.0))
        print_profile("probing run profile", "one train step of the run", per_name, wall_ms,
                      top=12)
        check_main_path_kernels("probing run profile, K5 and the CLS block's K3/K4", per_name,
                                ("flash_fwd_proj_kernel", "flash_short_fwd_f32_kernel",
                                 "flash_short_bwd_f32_kernel"),
                                ("flash_fwd_sm90_kernel", "flash_bwd_dkv", "ring_step"))
        times["busy_ms"] = sum(per_name.values())
        times["profiled_step_ms"] = wall_ms
        times["busy_share"] = times["busy_ms"] / wall_ms
        print(f"probing run: a profiled step busy {times['busy_ms']:.2f} ms of "
              f"{wall_ms:.2f} ms (share {times['busy_share']:.2f}) | {CARD}", flush=True)
        del runner, batch
    finally:
        undo()
        if switch is None:
            os.environ.pop("DEEPCORO_FUSED_OUTPROJ", None)
        else:
            os.environ["DEEPCORO_FUSED_OUTPROJ"] = switch
    torch.cuda.empty_cache()
    return {"counts": counts, "val_counts": val_counts, "infer_counts": infer_counts,
            "times": times, "studies": studies, "stats": stats,
            "checkpoint": Path(full["output_dir"]) / "checkpoints"}


# --------------------------------------------------------------------------- #
# phase 28: contrastive inference through main, at
# config/inference/clip_retrieval_inference.yaml, with a bank the port writes

CLIP_INFER_STUDY_CLIPS = (1, 4)  # clips a study, drawn (the YAML's num_videos 4)
CLIP_INFER_CATEGORIES = ("LAD", "LCX", "RCA", "LM")
# per inference batch: the video tower's 12 blocks (K1) and the aggregator's
# 2 blocks (K3, short); per bank chunk of 64 texts: the text tower's 12
# layers at L 512 (K3, long)
CLIP_INFER_PER_BATCH = {"K1": 12, "K2": 0, "K3": 2, "K4": 0, "K5": 0, "K6": 0,
                        "K3 long": 0, "K4 long": 0}
CLIP_INFER_TOPK_GAP = 1e-3  # ranks compared where the neighbouring scores are this far apart
CLIP_INFER_SCORE_ATOL = 1e-2


def clip_inference_config(**over):
    """config/inference/clip_retrieval_inference.yaml, field by field (a CPU
    test holds this dict equal to the YAML as the port's parser reads it)."""
    from deepcoro_clip_tpu_torch.configs import ClipConfig

    d = dict(
        pipeline_project="DeepCORO_clip", run_mode="inference", seed=42, use_wandb=False,
        text_embeddings_path="artifacts/text_embeddings.npz",
        metadata_path="artifacts/metadata.parquet", topk=5, checkpoint=None,
        data_filename="data/inference_studies.csv", datapoint_loc_label="FileName",
        target_label="Report", batch_size=4, num_workers=4, rand_augment=False,
        shuffle_videos=False, resize=224, frames=16, stride=1, max_text_length=512,
        dataset_mean=[110.4954833984375] * 3, dataset_std=[37.805782318115234] * 3,
        model_name="mvit", vit_dim=512, vit_depth=12, vit_heads=4, vit_patch=[2, 16, 16],
        vit_pool_stages=[3], use_cls_token=True, embedding_dim=512, num_heads=8,
        aggregator_depth=2, dropout=0.0, text_dim=768, text_depth=12, text_heads=12,
        text_vocab_size=30522, multi_video=True, num_videos=4,
        groupby_column="StudyInstanceUID", precision="bf16", use_pallas_attention=True,
    )
    d.update(over)
    return ClipConfig.from_dict(d)


def clip_study_manifest(manifest: Path, out: Path, seed: int = 0) -> tuple:
    """Phase 22's clips in their order grouped into studies of 1 to 4 clips
    (sizes drawn), Split ``inference``; returns (path, number of studies)."""
    from deepcoro_clip_tpu_torch.data.csv_utils import read_csv_with_fallback, write_csv

    clips = read_csv_with_fallback(manifest).rows
    rng = np.random.default_rng(seed)
    rows, i, s = [], 0, 0
    while i < len(clips):
        n = int(rng.integers(CLIP_INFER_STUDY_CLIPS[0], CLIP_INFER_STUDY_CLIPS[1] + 1))
        for c in clips[i:i + n]:
            rows.append({"FileName": c["FileName"], "Report": c["Report"],
                         "StudyInstanceUID": f"Q{s:03d}", "Split": "inference"})
        i += n
        s += 1
    write_csv(out, list(rows[0]), rows)
    return out, s


def _bank_metadata(manifest: Path, texts, out: Path, seed: int = 0) -> None:
    """One row a bank text: the worst stenosis of the first clip with that
    report (a number; empty for every seventh text) and a vessel drawn from
    CLIP_INFER_CATEGORIES (strings, so that a top-5 ties now and then)."""
    from deepcoro_clip_tpu_torch.data.csv_utils import read_csv_with_fallback, write_csv
    from deepcoro_clip_tpu_torch.data.synthetic_angio import probe_labels_for

    clips = read_csv_with_fallback(manifest).rows
    first = {}
    for c in clips:
        first.setdefault(c["Report"], int(str(c["StudyInstanceUID"]).replace("SYN", "")))
    rng = np.random.default_rng(seed)
    rows = [{"max_stenosis_pct": (None if j % 7 == 3
                                  else probe_labels_for(first[t], 0)["max_stenosis_pct"]),
             "vessel": CLIP_INFER_CATEGORIES[int(rng.integers(len(CLIP_INFER_CATEGORIES)))]}
            for j, t in enumerate(texts)]
    write_csv(out, ["max_stenosis_pct", "vessel"], rows, sep=",")


def phase_clip_inference(torch, manifest: Path, backbone: Path, tmp: Path) -> dict:
    """Phase 28 on phase 22's corpus and checkpoint ``backbone``; returns
    {"counts": the inference run's launches, "bank_counts", "times"}."""
    from collections import Counter

    from deepcoro_clip_tpu_torch import generate_embeddings
    from deepcoro_clip_tpu_torch.data.csv_utils import read_csv_with_fallback
    from deepcoro_clip_tpu_torch.main import main
    from deepcoro_clip_tpu_torch.runners.contrastive import VideoContrastiveLearningRunner
    from deepcoro_clip_tpu_torch.serve import load_text_bank

    studies, n_studies = clip_study_manifest(manifest, tmp / "clip_studies.csv")
    bank_path = tmp / "text_bank.npz"
    meta_path = tmp / "metadata.csv"

    def cfg(name, **over):
        return clip_inference_config(
            data_filename=str(studies), output_dir=str(tmp / "clip" / name),
            text_embeddings_path=str(bank_path), metadata_path=str(meta_path),
            inference_results_path=str(tmp / "clip" / name / "inference"), **over)

    print(f"clip inference: config/inference/clip_retrieval_inference.yaml with "
          f"data_filename={studies.name} (phase 22's {QUALITY_TRAIN + QUALITY_VAL} clips in "
          f"{n_studies} studies of 1 to 4), text_embeddings_path=<the bank below>, "
          "metadata_path=<a CSV a bank text>, output_dir and inference_results_path=<tmp>, "
          "init_from_checkpoint=<phase 22's checkpoint.pt>; nothing else changed", flush=True)
    made: list = []
    undo = _capture(VideoContrastiveLearningRunner, made)
    try:
        # the bank: generate_embeddings over the corpus' reports
        _zero_kernel_counts()
        t0 = time.perf_counter()
        generate_embeddings.main(["--checkpoint", str(backbone), "--texts_csv", str(manifest),
                                  "--text_column", "Report", "--out", str(bank_path)],
                                 config=cfg("bank"))
        bank_s = time.perf_counter() - t0
        bank_counts = {**_kernel_counts(), **_long_counts()}
        emb, texts = load_text_bank(bank_path)  # serve --text_bank's reader
        chunks = -(-len(texts) // 64)
        want = {k: v * chunks for k, v in PER_BANK_CHUNK.items()}
        print(f"clip inference: bank of {len(texts)} unique reports -> {emb.shape} "
              f"{emb.dtype} by generate_embeddings in {bank_s:.2f} s (runner set-up "
              f"included), read back by serve's load_text_bank; launches "
              + ", ".join(f"{k} {bank_counts[k]} (predicted {want[k]})" for k in want),
              flush=True)
        check(bank_counts == want and emb.shape == (len(texts), 512)
              and bool(np.isfinite(emb).all()), f"bank: {emb.shape}, launches {bank_counts}")
        bank_runner = made[-1]
        uniq = texts.tolist()
        bank_runner._encode_texts(uniq)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = bank_runner._encode_texts(uniq)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        check(np.array_equal(again, emb), "the bank encoded twice differs")
        times = {"bank_texts": len(texts), "bank_texts_per_s": len(texts) / enc_s,
                 "bank_encode_s": enc_s}
        print(f"clip inference: bank encoding {enc_s * 1e3:.1f} ms for {len(texts)} texts "
              f"({times['bank_texts_per_s']:.0f} texts/s, chunks of 64 at 512 tokens, host "
              f"clock) | {CARD}", flush=True)
        del bank_runner
        made.clear()
        torch.cuda.empty_cache()
        _bank_metadata(manifest, uniq, meta_path)

        # inference through main
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_kernel_counts()
        t0 = time.perf_counter()
        res = main(config=cfg("infer", init_from_checkpoint=str(backbone)))
        wall = time.perf_counter() - t0
        counts = {**_kernel_counts(), **_long_counts()}
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        batches = -(-n_studies // 4)
        want = {k: v * batches for k, v in CLIP_INFER_PER_BATCH.items()}
        print(f"clip inference: {res['inference_rows']} rows ({n_studies} studies) through "
              f"main in {wall:.2f} s (set-up included); launches over {batches} batches: "
              + ", ".join(f"{k} {counts[k]} (predicted {want[k]})" for k in want), flush=True)
        check(res["inference_rows"] == n_studies and counts == want,
              f"clip inference: {res}, launches {counts}")
        runner = made[-1]
        src = torch.load(backbone, map_location="cpu", weights_only=True)["params"]
        differ = [k for k, v in runner.state.params.items()
                  if not torch.equal(v.detach().cpu(), src[k])]
        print(f"clip inference: {len(runner.state.params) - len(differ)} of "
              f"{len(runner.state.params)} parameter tensors from phase 22's checkpoint "
              "(init_from_checkpoint)", flush=True)
        check(not differ, f"clip inference: parameters not loaded: {differ[:5]}")
        del src

        # the output against the plain attention with the same weights
        out_rows = read_csv_with_fallback(
            tmp / "clip" / "infer" / "inference" / "averaged_metadata.csv").rows
        check(len(out_rows) == n_studies and list(out_rows[0])[:3] ==
              ["path", "topk_indices", "topk_scores"], f"averaged_metadata.csv: {out_rows[:1]}")
        tn = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-8)
        loader = runner.loaders["inference"]
        attn = [m for m in runner.bundle.video_model.modules() if hasattr(m, "use_flash")]
        for m in attn:
            m.use_flash = False
        _zero_kernel_counts()
        plain = np.concatenate([runner.video_embeddings(b) for b in loader])
        check(_kernel_counts()["K1"] == 0, "the plain pass launched a kernel")
        for m in attn:
            m.use_flash = True
        plain /= np.maximum(np.linalg.norm(plain, axis=1, keepdims=True), 1e-8)
        sim = plain @ tn.T
        compared = agreed = 0
        worst = 0.0
        meta_cols = read_csv_with_fallback(meta_path)
        ties = 0
        lists = set()
        for b, row in enumerate(out_rows):
            got = json.loads(row["topk_indices"])
            scores = json.loads(row["topk_scores"])
            order = np.argsort(-sim[b])[: len(got)]
            ref = sim[b, order]
            worst = max(worst, float(np.abs(np.asarray(scores) - ref).max()))
            for j in range(len(got)):
                gaps = [abs(ref[j] - ref[i]) for i in (j - 1, j + 1) if 0 <= i < len(got)]
                if all(g > CLIP_INFER_TOPK_GAP for g in gaps):
                    compared += 1
                    agreed += got[j] == int(order[j])
            lists.add(tuple(got))
            vessels = Counter(meta_cols.rows[i]["vessel"] for i in got)
            top = max(vessels.values())
            ties += sum(n == top for n in vessels.values()) > 1
            check(row["vessel"] == min(v for v, n in vessels.items() if n == top),
                  f"row {b}: vessel {row['vessel']} is not the smallest mode of {vessels}")
        print(f"clip inference: top-{len(got)} against the plain attention's with the same "
              f"weights: {agreed} of {compared} ranks equal where the neighbouring scores are "
              f"more than {CLIP_INFER_TOPK_GAP} apart ({n_studies * len(got)} ranks in all); "
              f"scores max|kernel - plain| {worst:.3e} (bar {CLIP_INFER_SCORE_ATOL}); the "
              f"vessel column's mode tied in {ties} of {n_studies} rows (the smallest taken; "
              f"{len(lists)} distinct top-{len(got)} lists)", flush=True)
        check(agreed == compared and worst <= CLIP_INFER_SCORE_ATOL,
              f"clip inference: top-k {agreed}/{compared}, scores {worst}")
        # studies/s: the inference again, warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.inference()
        torch.cuda.synchronize()
        infer_s = time.perf_counter() - t0
        times.update(studies_per_s=n_studies / infer_s, infer_s=infer_s, peak_gib=peak_gib,
                     run_s=wall, topk_compared=compared, mode_ties=ties)
        print(f"clip inference: {n_studies} studies in {infer_s:.3f} s ("
              f"{times['studies_per_s']:.1f} studies/s, loader, video tower, top-k and "
              f"metadata, host clock, warm); peak memory {peak_gib:.2f} GiB "
              f"(torch.cuda.max_memory_allocated, the inference run) | {CARD}", flush=True)
        del runner, loader
    finally:
        undo()
    torch.cuda.empty_cache()
    return {"counts": counts, "bank_counts": bank_counts, "times": times}


# --------------------------------------------------------------------------- #
# phase 29: deployment: serve --checkpoint, the frozen artifacts (torch.export
# programs whose attention is the port's operators), external validation

DEPLOY_BANK = 1000  # texts of the served bank
DEPLOY_REQUESTS = 8  # concurrent /retrieve requests a server answers
DEPLOY_TIMED = 20  # dispatches timed a side in (e)
DEPLOY_MIN_COSINE = 0.9999  # artifact vs engine embeddings
DEPLOY_PROBE_MIN_COSINE = 0.999  # artifact vs runner logits
DEPLOY_PER_DISPATCH = CLIP_INFER_PER_BATCH  # 12 K1 + 2 K3 (the aggregator), as phase 4
DEPLOY_DROP = {"main_structure": 2, "contrast_agent": 0}  # a dropped row's value


def _deploy_bank(backbone: Path, tmp: Path) -> Path:
    """A bank of DEPLOY_BANK distinct synthetic reports (synthetic_angio's
    report_text of sample_findings, seed 0), written from phase 22's
    checkpoint by generate_embeddings' main."""
    from deepcoro_clip_tpu_torch import generate_embeddings
    from deepcoro_clip_tpu_torch.data.csv_utils import write_csv
    from deepcoro_clip_tpu_torch.data.synthetic_angio import report_text, sample_findings

    texts, i = {}, 0
    while len(texts) < DEPLOY_BANK:
        texts.setdefault(report_text(sample_findings(i, 0), i, 0), i)
        i += 1
    # (two columns: the manifest reader takes a one-column file for a wrong separator)
    write_csv(tmp / "deploy_reports.csv", ["Report", "video_id"],
              [{"Report": t, "video_id": i} for t, i in texts.items()])
    out = tmp / "deploy_bank.npz"
    cfg = clip_inference_config(data_filename=str(tmp / "clip_studies.csv"),
                                output_dir=str(tmp / "deploy" / "bank"),
                                text_embeddings_path=str(out),
                                metadata_path=str(tmp / "metadata.csv"),
                                inference_results_path=str(tmp / "deploy" / "bank" / "inference"))
    generate_embeddings.main(["--checkpoint", str(backbone), "--texts_csv",
                              str(tmp / "deploy_reports.csv"), "--text_column", "Report",
                              "--out", str(out)], config=cfg)
    return out


def _deploy_studies(tmp: Path, n: int, seed: int = 29) -> list:
    """``n`` studies of 1 to 10 of the corpus' clips (sizes and clips drawn)."""
    from deepcoro_clip_tpu_torch.data.csv_utils import read_csv_with_fallback

    clips = [r["FileName"] for r in read_csv_with_fallback(tmp / "clip_studies.csv").rows]
    rng = np.random.default_rng(seed)
    return [[clips[int(j)] for j in rng.choice(len(clips), int(rng.integers(1, 11)),
                                               replace=False)] for _ in range(n)]


def _serve_round(httpd, studies) -> tuple:
    """Concurrent /retrieve requests for ``studies``, one /embed of the first
    and /stats, launches counted from 0 just before them; returns (the
    retrieve answers, the embed answer, stats, counts, dispatches)."""
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        b0 = httpd.batcher.stats["batches"]
        _zero_kernel_counts()
        with concurrent.futures.ThreadPoolExecutor(len(studies)) as ex:
            futs = [ex.submit(_post, port, "/retrieve", {"videos": v}) for v in studies]
            answers = [f.result() for f in futs]
        embed = _post(port, "/embed", {"videos": studies[0]})
        counts = {**_kernel_counts(), **_long_counts()}
        code, stats = _get(port, "/stats")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    check(code == 200 and all(c == 200 for c, _ in answers + [embed]),
          f"deployment: an answer failed: {[c for c, _ in answers + [embed]]}")
    return answers, embed[1], stats, counts, stats["batches"] - b0


def _check_answers(label: str, answers, embed, ref, studies, texts) -> None:
    """Each /retrieve answer's top-k against ``ref``'s (an engine's or an
    artifact's) on the same study alone, and /embed's embedding, bit for
    bit (a row's numbers do not depend on the studies it is batched with:
    every dispatch is padded to max_batch)."""
    worst = 0.0
    for (_, out), paths in zip(answers, studies):
        study, mask = ref.load_study(paths)
        _, scores, idx = ref.infer_batch(study[None], mask[None])
        got = [t["text"] for t in out["topk"]]
        check(got == [texts[int(j)] for j in idx[0]] and out["n_clips"] == len(paths),
              f"{label}: a top-k differs from the reference's")
        worst = max(worst, float(np.abs(np.asarray([t["score"] for t in out["topk"]])
                                        - scores[0]).max()))
    study, mask = ref.load_study(studies[0])
    emb = ref.infer_batch(study[None], mask[None])[0][0]
    got = np.asarray(embed["embedding"], np.float32)
    print(f"{label}: {len(answers)} top-k lists equal to the reference's, scores max|d| "
          f"{worst:.3e}; /embed bit-equal {bool(np.array_equal(got, emb))}", flush=True)
    check(worst == 0.0 and np.array_equal(got, emb), f"{label}: answers differ from the "
                                                     f"reference's (scores {worst})")


def _times_ms(torch, fn, n: int) -> list:
    """Host-clock times of ``n`` calls of ``fn`` after one warm call, sorted
    (each call ends in a copy of its result to the host)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)


def _p(ts, q: float) -> float:
    return ts[min(len(ts) - 1, int(round(q * (len(ts) - 1))))]


def _artifact_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.iterdir())


def _per(counts: dict, per: dict, n: int, label: str) -> None:
    want = {k: v * n for k, v in per.items()}
    print(f"{label}: launches " + ", ".join(f"{k} {counts[k]} (predicted {want[k]})"
                                           for k in want), flush=True)
    check(counts == want, f"{label}: launches {counts}, predicted {want}")


def _retrieval_deploy(torch, backbone: Path, tmp: Path, counts: dict, times: dict) -> None:
    """(a), (b) and (e)'s retrieval half."""
    from deepcoro_clip_tpu_torch import serve, serving
    from deepcoro_clip_tpu_torch.serve import InferenceEngine, load_text_bank, load_video_params

    t0 = time.perf_counter()
    bank_path = _deploy_bank(backbone, tmp)
    bank, texts = load_text_bank(bank_path)
    texts = [str(t) for t in texts]
    check(bank.shape == (DEPLOY_BANK, 512), f"deployment bank {bank.shape}")
    print(f"deployment: a bank of {DEPLOY_BANK} distinct synthetic reports x 512 written "
          f"from phase 22's checkpoint by generate_embeddings in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cfg = quality_train_config(multi_video=True, num_videos=10)
    args = ["--checkpoint", str(backbone.parent), "--ckpt_name", backbone.stem, "--port", "0",
            "--num_videos", "10", "--max_batch", "4", "--top_k", "5", "--text_bank",
            str(bank_path), "--batch_window_ms", "20"]
    studies = _deploy_studies(tmp, DEPLOY_REQUESTS)

    # (a) serve --checkpoint
    httpd, engine = serve.build_server(serve.parse_args(args), cfg=quality_train_config())
    study, mask = engine.load_study([])
    engine.infer_batch(study[None], mask[None])  # warm
    tree = load_video_params(backbone.parent, backbone.stem)
    ref = InferenceEngine(cfg, bank, texts, max_batch=4, top_k=5, video_params=tree)
    sd = engine.model.state_dict()
    check(sd.keys() == tree.keys() and all(torch.equal(sd[k].cpu(), tree[k]) for k in tree),
          "deployment: the served tower is not phase 22's video_encoder")
    answers, embed, stats, c, batches = _serve_round(httpd, studies)
    print(f"deployment (a) serve --checkpoint {backbone.name}: {len(tree)} video_encoder "
          f"tensors loaded strictly; {len(studies)} concurrent /retrieve + 1 /embed in "
          f"{batches} dispatches (avg occupancy {stats['avg_occupancy']}, dispatch p50 "
          f"{stats['dispatch_p50_ms']} ms host clock) | {CARD}", flush=True)
    _per(c, DEPLOY_PER_DISPATCH, batches, "deployment (a) serve --checkpoint")
    counts["serve_checkpoint"] = c
    _check_answers("deployment (a) against an InferenceEngine on the same tree", answers,
                   embed, ref, studies, texts)
    del engine, httpd
    torch.cuda.empty_cache()

    # (b) the retrieval artifact
    art_dir = tmp / "deploy" / "retrieval"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meta = serving.export_retrieval_artifact(cfg, art_dir, bank, texts, max_batch=4, top_k=5,
                                             video_params=tree)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = serving.RetrievalArtifact(art_dir)
    load_s = time.perf_counter() - t0
    ops = serving.program_ops(art.program)
    bad = serving.decomposed_attention(art.program)
    nbytes = _artifact_bytes(art_dir)
    print(f"deployment (b) retrieval artifact: exported in {export_s:.2f} s, loaded in "
          f"{load_s:.2f} s, {nbytes} bytes ({', '.join(f'{p.name} {p.stat().st_size}' for p in sorted(art_dir.iterdir()))}); "
          f"platforms {meta['platforms']} {meta['cuda_arch']}, torch {meta['torch_version']}; "
          f"kernels in the graph {meta['kernels']}, operators "
          f"{ {k: v for k, v in ops.items() if k.startswith('deepcoro')} }, softmax "
          f"{ops.get('aten::softmax.int', 0)} (the aggregator's pooling), attention taken "
          f"apart: {bad or 'none'} | {CARD}", flush=True)
    check(meta["kernels"] == {"K1": 12, "K3": 2} and not bad
          and ops.get("aten::softmax.int", 0) == 1,
          f"deployment (b): graph kernels {meta['kernels']}, decomposed {bad}")
    times.update(export_s=export_s, load_s=load_s, artifact_bytes=nbytes)
    loaded = [art.load_study(p) for p in studies]
    xs, ms = np.stack([a for a, _ in loaded]), np.stack([b for _, b in loaded])
    emb_a, sc_a, idx_a = zip(*(art.infer_batch(xs[i:i + 4], ms[i:i + 4])
                               for i in range(0, len(xs), 4)))
    _zero_kernel_counts()
    art.infer_batch(xs[:4], ms[:4])
    c = {**_kernel_counts(), **_long_counts()}
    _per(c, DEPLOY_PER_DISPATCH, 1, "deployment (b) artifact, one dispatch")
    counts["retrieval_artifact"] = c
    emb_r, sc_r, idx_r = zip(*(ref.infer_batch(xs[i:i + 4], ms[i:i + 4])
                               for i in range(0, len(xs), 4)))
    emb_a, sc_a, idx_a, emb_r, sc_r, idx_r = map(np.concatenate,
                                                 (emb_a, sc_a, idx_a, emb_r, sc_r, idx_r))
    cos = float(((emb_a * emb_r).sum(1) / (np.linalg.norm(emb_a, axis=1)
                                           * np.linalg.norm(emb_r, axis=1))).min())
    d_emb, d_sc = float(np.abs(emb_a - emb_r).max()), float(np.abs(sc_a - sc_r).max())
    compared = agreed = 0
    for b in range(len(idx_r)):
        for j in range(idx_r.shape[1]):
            gaps = [abs(sc_r[b, j] - sc_r[b, i]) for i in (j - 1, j + 1)
                    if 0 <= i < idx_r.shape[1]]
            if all(g > CLIP_INFER_TOPK_GAP for g in gaps):
                compared += 1
                agreed += int(idx_a[b, j] == idx_r[b, j])
    bits = bool(np.array_equal(emb_a, emb_r) and np.array_equal(idx_a, idx_r))
    print(f"deployment (b) artifact vs the in-process engine, {len(xs)} studies: embeddings "
          f"min cosine {cos:.7f} (bar >= {DEPLOY_MIN_COSINE}), max|d| {d_emb:.3e}; scores "
          f"max|d| {d_sc:.3e} (bar {CLIP_INFER_SCORE_ATOL}); top-5 ranks {agreed} of "
          f"{compared} equal where neighbours are more than {CLIP_INFER_TOPK_GAP} apart; "
          f"bit-equal {bits}", flush=True)
    check(cos >= DEPLOY_MIN_COSINE and d_sc <= CLIP_INFER_SCORE_ATOL and agreed == compared,
          f"deployment (b): cosine {cos}, scores {d_sc}, ranks {agreed}/{compared}")

    # serve --artifact
    httpd, served = serve.build_server(serve.parse_args(["--artifact", str(art_dir),
                                                         "--port", "0",
                                                         "--batch_window_ms", "20"]))
    check(isinstance(served, serving.RetrievalArtifact), "serve --artifact built an engine")
    answers, embed, stats, c, batches = _serve_round(httpd, studies)
    _per(c, DEPLOY_PER_DISPATCH, batches, "deployment (b) serve --artifact")
    counts["serve_artifact"] = c
    _check_answers("deployment (b) serve --artifact against the artifact alone", answers, embed,
                   art, studies, texts)
    del served, httpd

    # swap_params: phase 22's epoch-0 checkpoint
    epoch0 = backbone.with_name("quality_epoch0.pt")
    tree0 = load_video_params(epoch0.parent, epoch0.stem)
    art.swap_params(tree0)
    ref0 = InferenceEngine(cfg, bank, texts, max_batch=4, top_k=5, video_params=tree0)
    a0, r0 = art.infer_batch(xs[:4], ms[:4]), ref0.infer_batch(xs[:4], ms[:4])
    moved = float(np.abs(a0[0] - emb_a[:4]).max())
    same = all(np.array_equal(a, b) for a, b in zip(a0, r0))
    print(f"deployment (b) swap_params with {epoch0.name}: outputs bit-equal to that "
          f"checkpoint's engine {same}, embeddings moved by max|d| {moved:.3e} from the "
          "epoch-1 tower's", flush=True)
    check(same and moved > 1e-3, f"deployment (b): swap_params (equal {same}, moved {moved})")
    try:
        serving.RetrievalArtifact(art_dir, device="cpu")
        refused = False
    except ValueError as e:
        refused = "exported for" in str(e)
    print(f"deployment (b) the CUDA artifact on the CPU: refused {refused}", flush=True)
    check(refused, "deployment (b): a CUDA artifact loaded on the CPU")
    del ref0
    art.swap_params(tree)

    # (e) dispatch times: the artifact and the engine, full batches of 4
    ta = _times_ms(torch, lambda: art.infer_batch(xs[:4], ms[:4]), DEPLOY_TIMED)
    te = _times_ms(torch, lambda: ref.infer_batch(xs[:4], ms[:4]), DEPLOY_TIMED)
    for name, ts in (("artifact", ta), ("engine", te)):
        times[f"{name}_dispatch_p50_ms"], times[f"{name}_dispatch_p95_ms"] = (_p(ts, .5),
                                                                               _p(ts, .95))
    print(f"deployment (e) dispatch of 4 studies x 10 clips (host clock, H2D and D2H "
          f"included, {DEPLOY_TIMED} each): artifact p50 {_p(ta, .5):.2f} ms p95 "
          f"{_p(ta, .95):.2f} ms, in-process engine p50 {_p(te, .5):.2f} ms p95 "
          f"{_p(te, .95):.2f} ms; export {export_s:.2f} s, load {load_s:.2f} s, artifact "
          f"{nbytes} bytes | {CARD}", flush=True)
    del art, ref
    torch.cuda.empty_cache()


def _ev_input(probing: dict, tmp: Path) -> tuple:
    """The input CSV of (d): phase 27's validation studies, a row a clip, in
    the documented template's columns (ids, per-segment cells, DICOMPath ->
    the clip's .npy), with main_structure / contrast_agent / stent_presence
    columns that mark known rows to drop: clip 1 of every third study
    non-coronary, clip 2 of every fourth without contrast, a PCI at clip 0
    of study 5 (its later clips POST_PCI). Returns (path, the (study, clip)
    pairs the reference filter keeps, the number of rows)."""
    from deepcoro_clip_tpu_torch import external_validation as ev
    from deepcoro_clip_tpu_torch.data.csv_utils import read_csv_with_fallback, write_csv

    ev.write_input_template(tmp / "template.csv")
    template = read_csv_with_fallback(tmp / "template.csv")
    blank = {c: template.rows[0][c] for c in template.columns}
    rows, keep, seen = [], [], {}
    for r in read_csv_with_fallback(probing["studies"]).rows:
        if r["Split"] != "val":
            continue
        sid = r["StudyInstanceUID"]
        s, j = int(sid[-3:]), seen.setdefault(sid, 0)
        seen[sid] += 1
        row = dict(blank, ss_patient_id=f"P{s}", ss_event_cath_id=sid, DICOMPath=r["FileName"],
                   main_structure=DEPLOY_DROP["main_structure"] if (s % 3 == 0 and j == 1)
                   else j % 2, contrast_agent=DEPLOY_DROP["contrast_agent"]
                   if (s % 4 == 1 and j == 2) else 1, stent_presence=int(s == 5 and j == 0))
        rows.append(row)
        if not (s == 5 or (s % 3 == 0 and j == 1) or (s % 4 == 1 and j == 2)):
            keep.append((sid, r["FileName"]))
    path = tmp / "ev_input.csv"
    write_csv(path, list(rows[0]), rows, sep=",")
    return path, keep, len(rows)


def _restored_runner(cfg, ckpt: Path, out: Path):
    from deepcoro_clip_tpu_torch.runners.linear_probing import LinearProbingRunner
    from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager

    runner = LinearProbingRunner(cfg, output_dir=out)
    runner.state = CheckpointManager(ckpt).restore(runner.state)
    return runner


def _probing_deploy(torch, probing: dict, tmp: Path, counts: dict, times: dict) -> None:
    """(c) and (d)."""
    from deepcoro_clip_tpu_torch import external_validation as ev
    from deepcoro_clip_tpu_torch import serving
    from deepcoro_clip_tpu_torch.data.csv_utils import read_csv_with_fallback
    from deepcoro_clip_tpu_torch.data.patch_wire import patchify_videos
    from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager

    ckpt, stats = probing["checkpoint"], probing["stats"]
    heads = ("stenosis", "stenosis_binary", "calcif_binary", "CTO")
    _fused_switch(True)
    cfg = probe_config(data_filename=str(probing["studies"]), run_mode="inference",
                       split_filter="val", output_dir=str(tmp / "deploy" / "runner"),
                       **stats)
    runner = _restored_runner(cfg, ckpt, tmp / "deploy" / "runner")
    batches = list(runner.loaders["inference"])
    # the artifact takes the patch-major wire; the YAML's loader sends
    # whole clips, which the encoder patchifies on the card (the same bytes)
    wire = [patchify_videos(b["videos"], tuple(cfg.vit_patch)) for b in batches]
    rows = runner.inference()
    ref = np.asarray([[r[h] for h in heads] for r in rows], np.float64)
    params = CheckpointManager(ckpt).load()["params"]
    n_batches = len(batches)
    for label, fused, per in (("K5", True, PROBE_RUN_PER_BATCH),
                              ("K1", False, PROBE_RUN_PER_BATCH_K1)):
        out = tmp / "deploy" / f"probing_{label}"
        t0 = time.perf_counter()
        meta = serving.export_probing_artifact(cfg, out, max_batch=cfg.batch_size,
                                               probe_params=params, fused_outproj=fused)
        export_s = time.perf_counter() - t0
        art = serving.ProbingArtifact(out)
        bad = serving.decomposed_attention(art.program)
        want_k = {"K5": 12, "K3": 1} if fused else {"K1": 12, "K3": 1}
        print(f"deployment (c) probing artifact, {label} (fused_outproj {fused}): exported "
              f"in {export_s:.2f} s, {_artifact_bytes(out)} bytes; kernels in the graph "
              f"{meta['kernels']}, attention taken apart: {bad or 'none'}", flush=True)
        check(meta["kernels"] == want_k and meta["fused_outproj"] == fused and not bad,
              f"deployment (c) {label}: graph kernels {meta['kernels']}, decomposed {bad}")
        _zero_kernel_counts()
        got = [art.infer_batch(x, b["video_mask"]) for x, b in zip(wire, batches)]
        c = {**_kernel_counts(), **_long_counts()}
        _per(c, per, n_batches, f"deployment (c) probing artifact {label}, {n_batches} "
                                "batches")
        counts[f"probing_artifact_{label}"] = c
        logits = np.concatenate([np.concatenate([g[h] for h in heads], 1) for g in got])
        cos = float((logits * ref).sum() / (np.linalg.norm(logits) * np.linalg.norm(ref)))
        d = float(np.abs(logits - ref).max())
        print(f"deployment (c) {label}: logits of {len(ref)} studies x {len(heads)} heads "
              f"against the restored runner's inference (K5): cosine {cos:.7f} (bar >= "
              f"{DEPLOY_PROBE_MIN_COSINE}), max|d| {d:.3e}, bit-equal "
              f"{bool(d == 0.0)}", flush=True)
        check(cos >= DEPLOY_PROBE_MIN_COSINE, f"deployment (c) {label}: cosine {cos}")
        probs = art.predict(wire[0], batches[0]["video_mask"])
        acts = {h: (1 / (1 + np.exp(-got[0][h])) if cfg.head_task[h] == "binary"
                    else got[0][h]) for h in heads}
        check(all(np.allclose(probs[h], acts[h], rtol=1e-6, atol=0) for h in heads),
              f"deployment (c) {label}: predict's activations")
        times[f"probing_{label}_export_s"] = export_s
        del art
    print("deployment (c) predict: sigmoid on the binary heads "
          f"({', '.join(h for h in heads if cfg.head_task[h] == 'binary')}), identity on "
          f"the regression head (stenosis)", flush=True)
    del runner, batches

    # (d) external validation
    src, keep, n_rows = _ev_input(probing, tmp)
    ev_cfg = probe_config(**stats)
    results = {}
    for label, filt in (("plain", None), ("filter model", ev_cfg)):
        out = tmp / "deploy" / f"ev_{len(results)}"
        argv = ["--input_csv", str(src), "--checkpoint", str(ckpt), "--output_dir", str(out)]
        if filt is not None:
            argv += ["--filter_checkpoint", str(ckpt)]
        _zero_kernel_counts()
        t0 = time.perf_counter()
        preds = ev.main(argv, config=ev_cfg, filter_config=filt)
        seconds = time.perf_counter() - t0
        c = {**_kernel_counts(), **_long_counts()}
        counts[f"external_validation_{'filter' if filt else 'plain'}"] = c
        man = read_csv_with_fallback(out / "runtime_manifest.csv").rows
        kept = [(r["StudyInstanceUID"], r["FileName"]) for r in man]
        file_rows = read_csv_with_fallback(out / "predictions.csv").rows
        studies = sorted({s for s, _ in keep})
        print(f"deployment (d) external_validation ({label}): {len(kept)} of the input's "
              f"{n_rows} rows kept by the reference filter (predicted {len(keep)}), "
              f"{len(file_rows)} predictions for {len(studies)} studies in {seconds:.1f} s "
              f"(runner set-up included); launches K5 {c['K5']}, K3 {c['K3']} | {CARD}",
              flush=True)
        check(kept == keep and [r["study_id"] for r in file_rows] == studies,
              f"deployment (d) {label}: kept {len(kept)} rows, predicted {len(keep)}")
        check(c["K5"] > 0 and c["K3"] > 0, f"deployment (d) {label}: launches {c}")
        results[label] = preds
        times[f"external_validation_{'filter' if filt else 'plain'}_s"] = seconds
    rcfg = probe_config(data_filename=str(tmp / "deploy" / "ev_0" / "runtime_manifest.csv"),
                        run_mode="inference", output_dir=str(tmp / "deploy" / "ev_ref"),
                        **stats)
    by_hand = _restored_runner(rcfg, ckpt, tmp / "deploy" / "ev_ref").inference()
    same = results["plain"] == by_hand == results["filter model"]
    print(f"deployment (d) predictions equal to a restored runner's inference on the "
          f"runtime manifest, and with the same checkpoint as the filter model: {same}",
          flush=True)
    check(same, "deployment (d): the predictions differ from the runner's")
    torch.cuda.empty_cache()


def phase_deployment(torch, backbone: Path, probing: dict, tmp: Path) -> dict:
    """Phase 29 on phase 22's checkpoint ``backbone`` (and its epoch-0 one
    beside it) and phase 27's ``probing`` run; returns {"counts": launches
    of each path, "times": ...}."""
    import os

    counts: dict = {}
    times: dict = {}
    switch = os.environ.get("DEEPCORO_FUSED_OUTPROJ")
    try:
        _fused_switch(False)  # the retrieval tower: K1 + F.linear, as phase 4
        _retrieval_deploy(torch, backbone, tmp, counts, times)
        _probing_deploy(torch, probing, tmp, counts, times)
    finally:
        if switch is None:
            os.environ.pop("DEEPCORO_FUSED_OUTPROJ", None)
        else:
            os.environ["DEEPCORO_FUSED_OUTPROJ"] = switch
    return {"counts": counts, "times": times}


# --------------------------------------------------------------------------- #
# --compare: one run of an A B B A call against an older tree (copy this
# script into it), where only what both trees have is measured


def _digest(torch, tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def hopper_checksums(torch) -> dict:
    """sha256 (16 hex digits) of the outputs of the kernels this PR did not
    mean to change, on seeded inputs: K1 and K2 (fused qkv + RoPE at L 393,
    the text tower's shape with padded reports, causal), K5 (fused qkv +
    RoPE at L 393), K6 (4 shards of [2,4,6272,128]), the short K3/K4 in bf16
    and fp32. Two trees whose kernels compute the same bits print the same
    digests."""
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables
    from deepcoro_clip_tpu_torch.parallel import ring_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(29)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    t = build_rope3d_tables(128, 8, 7, 7, n_special=1)
    sin, cos = torch.from_numpy(t.sin).to(dev), torch.from_numpy(t.cos).to(dev)
    out = {}

    def fwd_bwd(key, fn, inputs, do):
        leaves = [x.clone().requires_grad_() for x in inputs]
        y = fn(*leaves)
        grads = torch.autograd.grad(y, leaves, do)
        out[f"{key} forward"] = _digest(torch, [y])
        out[f"{key} backward"] = _digest(torch, grads)

    qkv = randn(8, 393, 1536)
    fwd_bwd("K1/K2 fused qkv + RoPE [8,393,1536]",
            lambda x: flash_attention_packed(qkv=x, num_heads=4, sin=sin, cos=cos), [qkv],
            randn(8, 393, 512))
    q, k, v = randn(8, 512, 768), randn(8, 512, 768), randn(8, 512, 768)
    m = torch.arange(512, device=dev)[None, :] < torch.tensor(
        [512, 300, 77, 5, 450, 512, 200, 130], device=dev)[:, None]
    fwd_bwd("K1/K2 q/k/v + kv_mask [8,512,768] H 6",
            lambda a, b, c: flash_attention_packed(a, b, c, num_heads=6, kv_mask=m),
            [q, k, v], randn(8, 512, 768))
    qc = randn(2, 150, 768)
    fwd_bwd("K1/K2 causal fused [2,150,768]",
            lambda x: flash_attention_packed(qkv=x, num_heads=2, causal=True), [qc],
            randn(2, 150, 256))
    wo = randn(512, 512)
    with torch.no_grad():
        out["K5 fused qkv + RoPE [8,393,1536] @ wo"] = _digest(torch, [flash_attention_packed(
            qkv=qkv, num_heads=4, sin=sin, cos=cos, wo=wo)])
        rq, rk, rv = ring_inputs(torch, 4 * 1568, seed=30)
        out["K6 4 shards [2,4,6272,128]"] = _digest(torch, [ring_attention(
            rq, rk, rv, ring_mesh(torch, 4), backend="rdma")])
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        q4, k4, v4 = (randn(8, 8, 11, 64, dtype=dtype) for _ in range(3))
        m4 = torch.ones(8, 11, dtype=torch.bool, device=dev)
        m4[2, 5:] = False
        fwd_bwd(f"K3/K4 short {name} [8,8,11,64] + mask",
                lambda a, b, c: flash_attention(a, b, c, kv_mask=m4), [q4, k4, v4],
                randn(8, 8, 11, 64, dtype=dtype))
    for key, d in out.items():
        print(f"compare: checksum {key}: {d}", flush=True)
    return out


def packed_times(torch) -> dict:
    """K1 and K2, which share the Hopper bodies with the long K3/K4, at the
    train step's video-tower shape (fused qkv + RoPE, [32,1569,1536]) and
    the text tower's ([8,512,768] H 6 with padded reports): time between
    CUDA events and busy time, forward and backward."""
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    t = build_rope3d_tables(128, 8, 14, 14, n_special=1)
    sin, cos = torch.from_numpy(t.sin).to(dev), torch.from_numpy(t.cos).to(dev)
    qkv = torch.randn(32, 1569, 1536, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = (torch.randn(8, 512, 768, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    m = torch.arange(512, device=dev)[None, :] < torch.tensor(
        [512, 300, 77, 20, 450, 512, 200, 130], device=dev)[:, None]
    rows = {}
    for name, fn, inputs in (
            ("fused qkv + RoPE [32,1569,1536]",
             lambda x: flash_attention_packed(qkv=x, num_heads=4, sin=sin, cos=cos), [qkv]),
            ("q/k/v + kv_mask [8,512,768] H 6",
             lambda a, b, c: flash_attention_packed(a, b, c, num_heads=6, kv_mask=m),
             [q, k, v])):
        leaves = [x.clone().requires_grad_() for x in inputs]
        out = fn(*leaves)
        do = torch.randn(out.shape, generator=g, device=dev).to(torch.bfloat16)
        with torch.no_grad():
            fwd = (cuda_ms(torch, lambda: fn(*inputs), REPS),
                   device_ms(torch, lambda: fn(*inputs), REPS, ("flash_fwd_sm90_kernel",)))
        bwd = (cuda_ms(torch, lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                       REPS),
               device_ms(torch, lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                         REPS, K2_KERNELS))
        rows[name] = {"K1_ms": fwd[0], "K1_device_ms": fwd[1], "K2_ms": bwd[0],
                      "K2_device_ms": bwd[1]}
        print(f"compare packed: {name}: K1 {fwd[0]:.4f} ms (busy {fwd[1]:.4f}), K2 "
              f"{bwd[0]:.4f} ms (busy {bwd[1]:.4f}) | {CARD}", flush=True)
        del leaves, out, do
    return rows


def _prefix(torch, B, L, lo, hi, seed):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(lo, hi + 1, (B,), generator=g)
    return (torch.arange(L)[None, :] < lengths[:, None]).to(torch.int32).to("cuda")


def run_compare(torch) -> dict:
    """One run of an A B B A call: the build, the checksums of the kernels
    meant to stay bit-equal, K1's and K2's times (packed_times), phase 24's
    train step on one batch (host-clock
    step time over 5 steps after a warm one, a profiled step's busy time,
    busy share and tile K3/K4 share) and K3/K4 rows at the long shapes of
    the main paths: the bank with that batch's mask, a bank of real prompts
    of 2 to 21 tokens, one with every key real, the text tower at
    [16,12,128,64] and [8,12,512,64], the decoder's causal [8,8,128,64] and
    its cross-attention [8,8,128|1572,64], the masks but the bank's seeded
    prefixes. Runs against the package of the tree the script lies in."""
    from deepcoro_clip_tpu_torch.data.dataset_creation import build_siglip_manifests
    from deepcoro_clip_tpu_torch.ops import _build
    from deepcoro_clip_tpu_torch.runners.contrastive import VideoContrastiveLearningRunner

    build_kernels(torch, [n for n in ("flash_fwd", "flash_fwd_proj", "flash_bwd",
                                      "flash_short", "ring_attention")
                          if (_build.SRC_DIR / f"{n}.cu").exists()])
    _use_tree_kernel_names()
    result = {"checksums": hopper_checksums(torch), "packed": packed_times(torch)}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        manifest = render_corpus(Path(root))
        paths = build_siglip_manifests(siglip_rows(manifest, seed=0),
                                       manifest.parent / "siglip",
                                       cto_columns=siglip_cto_columns())
        runner = VideoContrastiveLearningRunner(siglip_config(
            data_filename=str(paths["videos"]), siglip_texts_path=str(paths["texts"]),
            siglip_edges_path=str(paths["edges"]), epochs=2, num_workers=QUALITY_WORKERS,
            output_dir=str(Path(root) / "run"), batch_size=SIGLIP_BATCH))
        times = {}
        batch = _profile_step(torch, "compare siglip profile", runner, times)
        cfg = runner.config
        args = (batch, runner.generator, cfg.video_freeze_ratio, cfg.text_freeze_ratio, -1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            runner.train_step(runner.state, *args)
        torch.cuda.synchronize()
        times["step_ms"] = (time.perf_counter() - t0) * 1e3 / 5
        times["busy_share"] = times["busy_ms"] / times["profiled_step_ms"]
        print(f"compare siglip step: {times['step_ms']:.1f} ms a step (host clock, 5 steps on "
              f"one batch), busy {times['busy_ms']:.2f} ms (share {times['busy_share']:.3f}), "
              f"tile K3/K4 {times['tile_k3_k4_busy_ms']:.3f} ms | {CARD}", flush=True)
        bank = batch["attention_mask"]
        del runner, batch, args
    torch.cuda.empty_cache()
    B, L = bank.shape
    result["siglip_step"] = times
    result["rows"] = _attention_rows(torch, "compare attention", [
        ("the SigLIP bank's padding mask", B, 12, L, L, bank, False),
        ("every row a real prompt of 2 to 21 tokens", B, 12, L, L,
         _prefix(torch, B, L, 2, 21, 26), False),
        ("every key real (nothing skipped)", B, 12, L, L, torch.ones_like(bank), False),
        ("text, reports of 8 to 40 tokens", 16, 12, 128, 128, _prefix(torch, 16, 128, 8, 40, 31),
         False),
        ("text, reports of 8 to 60 tokens", 8, 12, 512, 512, _prefix(torch, 8, 512, 8, 60, 32),
         False),
        ("decoder causal, captions of 8 to 60 tokens", 8, 8, 128, 128,
         _prefix(torch, 8, 128, 8, 60, 33), True),
        ("decoder cross-attention, no mask", 8, 8, 128, 1572, None, False)], seed=28)
    return result


# --------------------------------------------------------------------------- #
# phases 32 and 33: data parallelism over torch.distributed, one process a
# rank, launched by torch.distributed.run

# Bars, stated before the first run on the card. A world-N run and the
# world-1 run of the same config differ in rounding only: the bf16 GEMMs at
# B/N rows a rank against B, the fp32 order of the gathered loss and of the
# gradient all-reduce. Phase 9 lets two bf16 gradient paths of one step sit
# at cosine 0.97 (video) / 0.985 (text) from each other
# (GRAD_MIN_KERNEL_VS_PLAIN), and phase 33 holds the world-N gradient of one
# step to those bars against the world-1 one. Paths that close move a loss
# near ln 16 by far less than 1% over phase 32's six steps at lr <= 1e-4;
# a wrong reduction lands outside: the loss over a rank's 8 rows instead of
# the global 16 (ln 8 against ln 16 at the start, 25% apart), a gradient
# summed over the ranks instead of averaged (its norm doubled).
DDP_LOSS_REL = 1e-2
# grad_norm is held where the two runs' weights are the same bits (every
# earlier step at lr 0: the warmup's first step): only the row blocking of
# the bf16 GEMMs and the order of the fp32 sums differ there. Past the first
# update the weights drift apart by rounding that Adam's normalised step
# amplifies, so later steps' norms are printed beside world 1's, not held
# (a bar of 5% there, stated before the first card run, failed at step 4:
# 1.65416 against 1.56643, while that step's loss agreed to 2e-4)
DDP_GRAD_NORM_REL = 1e-3
# phase 32's validation against world 1: the loss by the loss bar; the
# alignment, a mean cosine near 0 here, by an absolute bar (a relative one,
# stated before the first four-card run, failed there at epoch 1: 0.034214
# against 0.034889, while the train steps' alignments drift by up to 6e-4
# once the weights part by rounding); Recall@k may move by one of the 16
# clips swapping ranks
DDP_VAL_ALIGN_ABS = 5e-3
DDP_VAL_RECALL_ABS = 1.0 / QUALITY_VAL
# phase 33's global SigLIP multi-positive batch: a multiple of the world,
# and two ranks that share one card each hold the bank's 160 texts of 512
# tokens (SIGLIP_BATCH = 7 is one rank's worth of a card: 7.88 GiB a clip)
DDP_SIGLIP_BATCH = 4
DDP_TIMEOUT_S = 420
DDP_TIMES = ("loader_wait_ms", "epoch_seconds", "val_seconds")


def ddp_topology(torch) -> tuple:
    """(world, backend, description): one rank a card with NCCL where the
    machine shows two cards or more, else two ranks sharing card 0 with gloo
    (NCCL refuses two ranks on one device)."""
    n = torch.cuda.device_count()
    if n >= 2:
        return n, "nccl", f"{n} ranks, one a card (NCCL)"
    return 2, "gloo", ("2 ranks sharing card 0 (gloo; NCCL refuses two ranks on one "
                       "device): the times are a correctness run's, not a scaling figure")


def _launch(world: int, spec: dict, tmp: Path, label: str) -> tuple:
    """``python -m torch.distributed.run --standalone --nproc_per_node world
    chip_smoke.py --ddp-rank <spec>``; its exit code must be 0. Returns (each
    rank's result, wall seconds). The launch runs in a session of its own,
    killed whole at DDP_TIMEOUT_S."""
    import os
    import signal

    spec = dict(spec, out=str(tmp / label))
    spec_path = tmp / f"{label}.json"
    spec_path.write_text(json.dumps(spec))
    log = tmp / f"{label}.log"
    here = Path(__file__).resolve()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(world), str(here), "--ddp-rank", str(spec_path)]
    t0 = time.perf_counter()
    with open(log, "w") as f:
        p = subprocess.Popen(cmd, cwd=here.parent, stdout=f, stderr=subprocess.STDOUT,
                             start_new_session=True)
        try:
            rc = p.wait(timeout=DDP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
            rc = "killed at the time limit"
    wall = time.perf_counter() - t0
    text = log.read_text()
    for line in text.splitlines():
        if line.startswith(("[deepcoro_clip_tpu_torch] data parallel", "rank ")):
            print(f"{label}: {line}", flush=True)
    check(rc == 0, f"{label}: torch.distributed.run exited {rc}:\n{text[-4000:]}")
    return [json.loads(Path(f"{spec['out']}.rank{r}.json").read_text())
            for r in range(world)], wall


def _audit_writes(torch, root: Path, record: list) -> None:
    """Record in ``record`` each file this process opens for writing and
    each directory it makes under ``root`` (an audit hook sees open,
    io.open and os.open; torch.save, which opens its file in C++, is
    wrapped)."""
    import os

    root_s = str(root)
    flags_w = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND

    def hook(event, args):
        if event == "open" and args and isinstance(args[0], (str, os.PathLike)):
            path, mode, flags = (list(args) + [None, 0])[:3]
            w = (any(c in mode for c in "wax+") if isinstance(mode, str)
                 else bool((flags or 0) & flags_w))
            if w and str(path).startswith(root_s):
                record.append(str(path))
        elif event == "os.mkdir" and str(args[0]).startswith(root_s):
            record.append(str(args[0]))

    sys.addaudithook(hook)
    save = torch.save

    def recorded_save(obj, f, *a, **kw):
        if isinstance(f, (str, os.PathLike)) and str(f).startswith(root_s):
            record.append(str(f))
        return save(obj, f, *a, **kw)

    torch.save = recorded_save


def _quality_recorder(torch, rank: int, keep_epoch0: Optional[str] = None,
                      time_reduce_step: Optional[int] = None) -> dict:
    """Patch the contrastive runner so that each train step's loss,
    grad_norm and alignment are kept (read after the run) and the text
    head's projection dropout, which no config field reaches, is off; each
    epoch's checkpoint save records the parameters' checksum (and that of
    the replicated ones alone), and with
    ``keep_epoch0`` rank 0 copies epoch 0's checkpoint there (the run a
    killed run after epoch 0 would leave). With ``time_reduce_step`` the
    model group's all-reduces of that step (its index in the run) are timed
    on the host, each synchronised (``_model_reduce_timer``), and the step
    synchronised after (``model_all_reduce``). Returns the record;
    ``undo()`` restores the classes."""
    from deepcoro_clip_tpu_torch.runners.contrastive import VideoContrastiveLearningRunner
    from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager

    rec: dict = {"steps": [], "checksums": [], "replicated": []}
    init, save_latest = VideoContrastiveLearningRunner.__init__, CheckpointManager.save_latest

    def wrapped(self, *a, **kw):
        init(self, *a, **kw)
        self.bundle.text_model.proj.dropout = 0.0
        step = self.train_step

        def recorded(state, *args):
            if time_reduce_step is None or len(rec["steps"]) != time_reduce_step:
                state, m = step(state, *args)
            else:
                torch.cuda.synchronize()
                timer, undo_timer = _model_reduce_timer(torch)
                t0 = time.perf_counter()
                try:
                    state, m = step(state, *args)
                    torch.cuda.synchronize()
                finally:
                    undo_timer()
                rec["model_all_reduce"] = dict(timer, step_ms=(time.perf_counter() - t0) * 1e3)
            rec["steps"].append({k: torch.as_tensor(m[k]).detach()
                                 for k in ("loss", "grad_norm", "alignment", "lr")})
            return state, m

        self.train_step = recorded

    def saving(self, state, meta, *a):
        path = save_latest(self, state, meta, *a)
        rec["checksums"].append(_digest(torch, state.params.values()))
        # (under tensor parallelism the leaves every rank holds whole)
        rec["replicated"].append(_digest(torch, [
            p for p in state.params.values() if getattr(p, "model_split", None) is None]))
        if keep_epoch0 and meta["epoch"] == 0 and rank == 0:
            dst = Path(keep_epoch0) / "checkpoints"
            dst.mkdir(parents=True)
            for suffix in (".pt", ".json"):
                shutil.copyfile(self.dir / f"checkpoint{suffix}", dst / f"checkpoint{suffix}")
        return path

    def undo():
        VideoContrastiveLearningRunner.__init__ = init
        CheckpointManager.save_latest = save_latest

    VideoContrastiveLearningRunner.__init__ = wrapped
    CheckpointManager.save_latest = saving
    rec["undo"] = undo
    return rec


def _quality_ddp_config(manifest: str, output_dir: str, **over):
    """Phase 22's config at dropout 0."""
    return quality_train_config(data_filename=manifest, output_dir=output_dir, epochs=2,
                                num_workers=QUALITY_WORKERS, dropout=0.0, **over)


def _ddp_profiled_step(torch, cfg) -> dict:
    """One warm step and one profiled step of a runner built from ``cfg``
    on every rank (the same calls on every rank: no retrace): the step's
    host wall, the card's busy time, the gradient all-reduce's host time
    (synchronised before and after) and the collectives' device time
    (NCCL kernels; under gloo the copies to and from the host)."""
    from torch.profiler import ProfilerActivity, profile

    from deepcoro_clip_tpu_torch.runners.common import batch_to_device
    from deepcoro_clip_tpu_torch.runners.contrastive import VideoContrastiveLearningRunner
    from deepcoro_clip_tpu_torch.train import optim

    cfg.set_device_info_in_place()  # (rank 0 alone writes, as under main)
    runner = VideoContrastiveLearningRunner(cfg, output_dir=cfg.output_dir)
    runner.bundle.text_model.proj.dropout = 0.0
    batch = batch_to_device(next(iter(runner.loaders["train"])), runner.device,
                            runner.replicated_keys)
    args = (batch, runner.generator, 0.0, 0.0, -1.0)
    runner.train_step(runner.state, *args)  # warm
    torch.cuda.synchronize()
    reduce = optim.all_reduce_grads
    timed = {}

    def timed_reduce(grads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce(grads)
        torch.cuda.synchronize()
        timed["ms"] = (time.perf_counter() - t0) * 1e3

    optim.all_reduce_grads = timed_reduce
    # every rank takes this step whether or not its profiler starts (the
    # ranks' collectives must pair up); a profiler that fails to start
    # leaves the busy times "not measured"
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.__enter__()
    except RuntimeError as e:
        print(f"rank profiler did not start: {e}", flush=True)
        prof = None
    try:
        t0 = time.perf_counter()
        runner.train_step(runner.state, *args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        optim.all_reduce_grads = reduce
        if prof is not None:
            prof.__exit__(None, None, None)
    busy = {}
    for e in (prof.events() if prof is not None else ()):
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    coll = {k: v for k, v in busy.items() if "nccl" in k.lower() or "memcpy" in k.lower()}
    grad_bytes = sum(p.numel() * 4 for p in runner.state.params.values())
    del runner, batch, args
    torch.cuda.empty_cache()
    return {"wall_ms": wall, "busy_ms": sum(busy.values()) if busy else None,
            "all_reduce_host_ms": timed.get("ms"), "collective_device_ms": coll,
            "gradient_bytes": grad_bytes}


def _ddp_quality_rank(torch, spec: dict, rank: int) -> dict:
    """A rank of phase 32 or 35 (or of ``--drift``): the quality run through
    main, with the config overrides ``over``. With ``resume`` the group is
    started here (``ddp_rank`` ends it) and outlives main: the run (epoch 0's checkpoint copied to
    ``keep_epoch0``), that checkpoint resumed through main, then (unless
    ``profile`` is false) a profiled step, all on one group; the result's
    ``resumed`` holds the resumed run's, ``grid`` the process grid's shape.
    With ``embed`` (phase 37) the run's checkpoint, restored on the same
    grid, embeds ``_tp_embed_batch`` (``embeddings``); with ``probe`` the
    ranks then take phase 38's probing step (``_tp_probe_step``) at the
    run's ``mesh_model`` (``probe``)."""
    from deepcoro_clip_tpu_torch.main import main as port_main
    from deepcoro_clip_tpu_torch.parallel import distributed

    written: list = []
    _audit_writes(torch, Path(spec["root"]), written)
    if spec.get("resume"):
        distributed.init_from_env(quality_train_config().device)

    def run(keep_epoch0=None, **over):
        rec = _quality_recorder(torch, rank, keep_epoch0, spec.get("time_reduce_step"))
        cfg = _quality_ddp_config(spec["manifest"], spec["output_dir"],
                                  **spec.get("over", {}), **over)
        torch.cuda.reset_peak_memory_stats()
        _zero_kernel_counts()
        t0 = time.perf_counter()
        result = port_main(config=cfg)
        wall = time.perf_counter() - t0
        rec["undo"]()
        return cfg, {"history": result["history"], "output_dir": result["output_dir"],
                     "steps": [{k: float(v) for k, v in s.items()} for s in rec["steps"]],
                     "checksums": rec["checksums"], "replicated": rec["replicated"],
                     "model_all_reduce": rec.get("model_all_reduce"),
                     "counts": {**_kernel_counts(), **_long_counts()},
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "main_s": wall}

    cfg, out = run(spec.get("keep_epoch0"))
    if spec.get("resume"):
        out["grid"] = dict(distributed.grid().shape)
        _, out["resumed"] = run(resume_training=True, checkpoint=spec["resume"])
        if spec.get("embed"):  # phase 37: the run's model on fixed clips and reports
            out["embeddings"] = _tp_embeddings(torch, cfg, Path(out["output_dir"])
                                               / "checkpoints")
        if spec.get("probe"):  # phase 38's probing step, on the same ranks
            pcfg = probe_config(dropout=0.0, dropout_attention=0.0, vit_depth=MP_DEPTH,
                                mesh_model=cfg.mesh_model)
            pcfg.set_device_info_in_place()
            out["probe"] = dict(_tp_probe_step(torch, pcfg),
                                grid=dict(distributed.grid().shape))
        if spec.get("profile", True):
            # (the run's dataset statistics: no second pass over the clips)
            out["profile"] = _ddp_profiled_step(torch, _quality_ddp_config(
                spec["manifest"], str(Path(spec["root"]) / "trace"),
                dataset_mean=cfg.dataset_mean, dataset_std=cfg.dataset_std))
    print(f"rank {rank}: cuda:{torch.cuda.current_device()}, {len(out['steps'])} steps, "
          f"main {out['main_s']:.1f} s, peak {out['peak_gib']:.2f} GiB", flush=True)
    out.update(written=written, device=torch.cuda.current_device())
    return out


def _quality_world1(torch, manifest: Path, tmp: Path) -> dict:
    """Phase 32's control: its config at world 1 in this process; returns
    the run's steps, history, launches, peak memory and dataset statistics
    (which go to the ranks: the same values, without a pass over the clips
    a run)."""
    from deepcoro_clip_tpu_torch.main import main as port_main

    rec = _quality_recorder(torch, 0)
    _zero_kernel_counts()
    cfg_one = _quality_ddp_config(str(manifest), str(tmp / "ddp_one"))
    torch.cuda.reset_peak_memory_stats()
    try:
        one = port_main(config=cfg_one)
    finally:
        rec["undo"]()
    out = {"run": one, "history": one["history"],
           "counts": {**_kernel_counts(), **_long_counts()},
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "steps": [{k: float(v) for k, v in s.items()} for s in rec["steps"]],
           "stats": {"dataset_mean": cfg_one.dataset_mean, "dataset_std": cfg_one.dataset_std}}
    torch.cuda.empty_cache()
    return out


def phase_ddp_quality_run(torch, manifest: Path, tmp: Path, world1: dict,
                          then: tuple = ()) -> dict:
    """Phase 32: phase 22's config at dropout 0 through torch.distributed.run
    at world N (``ddp_topology``) against ``world1`` (``_quality_world1``),
    on phase 22's corpus; the jobs of ``then`` (phase 33's, and phase 37's
    where its ranks are these) run on the same launch after it. Returns
    {"world", "backend", "counts": a rank's launches, "times": ..., "then":
    each chained job's results by rank}."""
    world, backend, topology = ddp_topology(torch)
    steps = QUALITY_TRAIN // 16
    print(f"ddp quality run: {topology}; config/quality/flagship_quality_train.yaml as "
          f"phase 22 runs it, dropout 0 (and the text head's projection dropout, which no "
          f"field reaches), global batch 16 ({16 // world} rows a rank), {steps} steps an "
          f"epoch, 2 epochs | {CARD}", flush=True)
    print(f"ddp quality run: bars: per step |loss_N - loss_1| <= {DDP_LOSS_REL} |loss_1|; "
          f"|grad_norm_N - grad_norm_1| <= {DDP_GRAD_NORM_REL} grad_norm_1 at the steps "
          f"taken from the same weights (before the first update); validation loss by "
          f"the loss bar, alignment within {DDP_VAL_ALIGN_ABS} absolute, Recall@k within "
          f"{DDP_VAL_RECALL_ABS:.4f} (one clip of {QUALITY_VAL})", flush=True)
    root = tmp / "ddp_quality"
    keep = root / "epoch0"
    one, one_counts, one_steps = world1["run"], world1["counts"], world1["steps"]
    stats = world1["stats"]
    # the run, epoch 0's checkpoint resumed and a profiled step (then the
    # chained jobs): one launch
    full, full_s = _launch(world, {"job": "quality", "manifest": str(manifest),
                                   "root": str(root), "output_dir": str(root / "full"),
                                   "keep_epoch0": str(keep), "resume": str(keep),
                                   "over": stats, "then": list(then)}, tmp, "ddp_full")
    resumed = [r["resumed"] for r in full]

    # the ranks agree: every step's metrics and each epoch's parameters
    for r in full[1:]:
        check(r["steps"] == full[0]["steps"],
              f"ddp quality run: rank steps differ: {r['steps']} vs {full[0]['steps']}")
        check(r["checksums"] == full[0]["checksums"],
              f"ddp quality run: parameters differ across ranks: {r['checksums']} vs "
              f"{full[0]['checksums']}")
        check([{k: v for k, v in h.items() if k not in DDP_TIMES} for h in r["history"]]
              == [{k: v for k, v in h.items() if k not in DDP_TIMES}
                  for h in full[0]["history"]], "ddp quality run: rank histories differ")
    print(f"ddp quality run: parameter checksums after each epoch, every rank: "
          f"{full[0]['checksums']} (bit-equal across the {world} ranks)", flush=True)
    got = full[0]["steps"]
    check(len(got) == len(one_steps) == 2 * steps, f"steps {len(got)} / {len(one_steps)}")
    same_weights = True  # no update has moved a parameter yet
    for i, (a, b) in enumerate(zip(got, one_steps)):
        dl = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        dg = abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
        held = "held" if same_weights else "after an update: not held"
        print(f"ddp quality run: step {i}: loss {a['loss']:.6f} (world 1 {b['loss']:.6f}, "
              f"rel {dl:.2e}), grad_norm {a['grad_norm']:.5f} (world 1 "
              f"{b['grad_norm']:.5f}, rel {dg:.2e}, {held}), alignment "
              f"{a['alignment']:.5f} ({b['alignment']:.5f}), lr {a['lr']:.2e}", flush=True)
        check(math.isfinite(a["loss"]) and dl <= DDP_LOSS_REL
              and (dg <= DDP_GRAD_NORM_REL or not same_weights),
              f"ddp quality run: step {i} off the world-1 run: {a} vs {b}")
        same_weights = same_weights and a["lr"] == 0.0 and b["lr"] == 0.0
    for h, w in zip(full[0]["history"], one["history"]):
        d = abs(h["val_loss"] - w["val_loss"]) / abs(w["val_loss"])
        check(d <= DDP_LOSS_REL, f"ddp quality run: epoch {h['epoch']} val_loss "
              f"{h['val_loss']} vs {w['val_loss']} (rel {d:.2e})")
        d = abs(h["val_alignment"] - w["val_alignment"])
        check(d <= DDP_VAL_ALIGN_ABS, f"ddp quality run: epoch {h['epoch']} val_alignment "
              f"{h['val_alignment']} vs {w['val_alignment']} (|d| {d:.2e})")
        for key in ("val_Recall@1", "val_Recall@5", "val_Recall@10"):
            check(abs(h[key] - w[key]) <= DDP_VAL_RECALL_ABS + 1e-9,
                  f"ddp quality run: epoch {h['epoch']} {key} {h[key]} vs {w[key]}")
        print(f"ddp quality run: epoch {h['epoch']} validation: loss {h['val_loss']:.6f} "
              f"(world 1 {w['val_loss']:.6f}), alignment {h['val_alignment']:.5f} "
              f"({w['val_alignment']:.5f}), R@1/5/10 {h['val_Recall@1']:.3f}/"
              f"{h['val_Recall@5']:.3f}/{h['val_Recall@10']:.3f} "
              f"({w['val_Recall@1']:.3f}/{w['val_Recall@5']:.3f}/{w['val_Recall@10']:.3f}), "
              f"MRR {h['val_MRR']:.4f} ({w['val_MRR']:.4f})", flush=True)

    # launches: a rank runs every step's whole model on its rows, every
    # validation batch and the whole bank: the one-process counts
    want = {k: QUALITY_PER_STEP[k] * steps * 2 + QUALITY_PER_EVAL[k] * 2
            + QUALITY_PER_BANK[k] * 2 for k in QUALITY_PER_STEP}
    for r, res in enumerate(full):
        check(res["counts"] == want, f"ddp quality run: rank {r} launches {res['counts']}, "
              f"expected {want}")
    check(one_counts == want, f"ddp quality run: world-1 launches {one_counts}")
    print(f"ddp quality run: launches per rank over the run: "
          + ", ".join(f"{k} {full[0]['counts'][k]}" for k in ("K1", "K2", "K3", "K4"))
          + f" = per step K1 12, K2 12, K3 14, K4 14 (phase 22's), as at world 1 "
          f"({', '.join(f'{k} {one_counts[k]}' for k in ('K1', 'K2', 'K3', 'K4'))})",
          flush=True)

    # the files: one run directory, written by rank 0 alone
    run = Path(full[0]["output_dir"])
    runs = sorted(p.parent for p in (root / "full").rglob("checkpoints"))
    check(runs == [run], f"ddp quality run: run directories {runs}")
    for rank, res in enumerate(full):  # (the run and the resumed run)
        check(bool(res["written"]) == (rank == 0),
              f"ddp quality run: rank {rank} wrote {res['written'][:5]}")
    saved = torch.load(run / "checkpoints" / "checkpoint.pt", weights_only=True)
    check(len(saved["generators"]) == world and saved["step"] == 2 * steps,
          f"ddp quality run: checkpoint step {saved['step']}, "
          f"{len(saved['generators'])} generator states")
    print(f"ddp quality run: one run directory {run.name}; rank 0 wrote "
          f"{len(full[0]['written'])} files and directories, the other ranks none; the "
          f"checkpoint holds {world} generator states", flush=True)

    # resume at world N from epoch 0's checkpoint, bit-equal
    res0 = resumed[0]
    check([h["epoch"] for h in res0["history"]] == [1],
          f"ddp quality run: the resumed run ran epochs {res0['history']}")
    check(res0["history"][0]["loss"] == full[0]["history"][1]["loss"]
          and res0["checksums"][-1] == full[0]["checksums"][-1]
          and all(r["checksums"] == res0["checksums"] for r in resumed),
          f"ddp quality run: resumed epoch 1 loss {res0['history'][0]['loss']!r} vs "
          f"{full[0]['history'][1]['loss']!r}, checksums {res0['checksums']} vs "
          f"{full[0]['checksums']}")
    print(f"ddp quality run: resumed at world {world} from epoch 0's checkpoint: epoch-1 "
          f"loss {res0['history'][0]['loss']!r} (uninterrupted "
          f"{full[0]['history'][1]['loss']!r}), parameters {res0['checksums'][-1]} "
          f"(uninterrupted {full[0]['checksums'][-1]}): bit-equal", flush=True)

    h = full[0]["history"][1]
    step_ms = h["epoch_seconds"] * 1e3 / steps
    h1 = one["history"][1]
    times = {"world": world, "backend": backend, "step_ms": step_ms,
             "clips_per_s": 16 * steps / h["epoch_seconds"],
             "world1_step_ms": h1["epoch_seconds"] * 1e3 / steps,
             "world1_clips_per_s": 16 * steps / h1["epoch_seconds"],
             "peak_gib": [r["peak_gib"] for r in full], "launch_s": full_s,
             "profiled_step": [r["profile"] for r in full]}
    print(f"ddp quality run: step {step_ms:.1f} ms (host clock, epoch 1 over {steps} steps), "
          f"{times['clips_per_s']:.1f} global clips/s; world 1 {times['world1_step_ms']:.1f} "
          f"ms, {times['world1_clips_per_s']:.1f} clips/s | {topology} | {CARD}", flush=True)
    print(f"ddp quality run: peak memory per rank "
          + ", ".join(f"{g:.2f}" for g in times["peak_gib"])
          + f" GiB (torch.cuda.max_memory_allocated, each rank's process) | {CARD}",
          flush=True)
    for r, p in enumerate(times["profiled_step"]):
        coll = ", ".join(f"{k[:60]} {v:.3f} ms" for k, v in sorted(
            p["collective_device_ms"].items(), key=lambda kv: -kv[1])[:4]) or "none traced"
        busy = "not measured" if p["busy_ms"] is None else f"{p['busy_ms']:.1f} ms"
        print(f"ddp quality run: rank {r} profiled step: wall {p['wall_ms']:.1f} ms, card "
              f"busy {busy}; the gradient all-reduce ({p['gradient_bytes'] / 2 ** 20:.0f} "
              f"MiB fp32, one call) {p['all_reduce_host_ms']:.1f} ms host time; collectives "
              f"on the card: {coll} | {topology} | {CARD}", flush=True)
    print(f"ddp quality run: torch.distributed.run launch {full_s:.1f} s (the run, its "
          f"resumption and a profiled step, then {[j['job'] for j in then]}), process start "
          f"and set-up included", flush=True)
    return {"world": world, "backend": backend, "counts": full[0]["counts"], "times": times,
            "then": [[r["then"][i] for r in full] for i in range(len(then))]}


def _ddp_step_cases(torch) -> list:
    """Phase 33's pipelines at their full widths, dropout 0 (the text head's
    projection dropout too), each with its seeded global batch: (name, kind,
    config, batch, the per-tower names)."""
    r = np.random.default_rng(33)
    cases = []
    depth = dict(vit_depth=MP_DEPTH, text_depth=MP_DEPTH)
    cfg = siglip_config(dropout=0.0, batch_size=DDP_SIGLIP_BATCH, **depth)
    B = DDP_SIGLIP_BATCH
    M = B * (cfg.siglip_max_positive_per_video + cfg.siglip_negatives_per_video)
    L = cfg.max_text_length
    lengths = r.integers(8, min(48, L), M)
    lengths[-M // 10:] = 2  # the bank's padded slots: [CLS] [SEP]
    att = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    pos = np.zeros((B, M), np.float32)
    for i in range(B):
        pos[i, r.choice(M - M // 10, size=int(r.integers(1, 6)), replace=False)] = 1.0
    cases.append(("siglip_multi_positive", "clip", cfg, {
        "videos": r.integers(0, 255, (B, 1, cfg.frames, cfg.resize, cfg.resize, 3),
                             dtype=np.uint8),
        "video_mask": np.ones((B, 1), bool),
        "input_ids": (r.integers(1000, cfg.text_vocab_size, (M, L)) * att).astype(np.int32),
        "attention_mask": att, "positive_mask": pos,
        "positive_weights": r.uniform(0.75, 2.5, (B, M)).astype(np.float32),
        "text_valid": (lengths > 2).astype(np.float32)}))
    cfg = multitask_config(dropout=0.0, **depth)
    B, N, C = MT_BATCH, cfg.num_videos, cfg.decoder_max_length
    vmask = np.ones((B, N), bool)
    vmask[1, 2:] = vmask[B - 1, 1:] = False
    tl = r.integers(cfg.max_text_length // 8, cfg.max_text_length * 5 // 8, B)
    cl = r.integers(C // 6, C, B)
    cap = (np.arange(C)[None, :] < cl[:, None]).astype(np.int32)
    cases.append(("multitask", "multitask", cfg, {
        "videos": r.integers(0, 255, (B, N, cfg.frames, cfg.resize, cfg.resize, 3),
                             dtype=np.uint8),
        "video_mask": vmask,
        "input_ids": r.integers(1000, cfg.text_vocab_size, (B, cfg.max_text_length)
                                ).astype(np.int32),
        "attention_mask": (np.arange(cfg.max_text_length)[None, :] < tl[:, None]
                           ).astype(np.int32),
        "caption_ids": (r.integers(1000, cfg.text_vocab_size, (B, C)) * cap).astype(np.int32),
        "caption_mask": cap,
        "location_mask": ((r.random((B, C)) > 0.8) & (cap > 0)).astype(np.float32),
        "caption_weights": r.uniform(1.0, 4.0, B).astype(np.float32)}))
    cfg = probe_config(dropout=0.0, dropout_attention=0.0, vit_depth=MP_DEPTH)
    cases.append(("probing", "probe", cfg, probe_batch(cfg, 8)))
    return cases


def _ddp_bundle(torch, kind: str, cfg):
    """(bundle, state) of a phase-33 case, seeded, the text head's projection
    dropout off."""
    if kind == "clip":
        from deepcoro_clip_tpu_torch.train.clip import build_clip_bundle

        bundle, state = build_clip_bundle(cfg, seed=0, steps_per_epoch=1, device=cfg.device)
    elif kind == "multitask":
        from deepcoro_clip_tpu_torch.train.multitask import build_multitask_bundle

        bundle, state = build_multitask_bundle(cfg, seed=0, steps_per_epoch=1,
                                               device=cfg.device)
    else:
        from deepcoro_clip_tpu_torch.train.linear_probe import build_probe_bundle

        return build_probe_bundle(cfg, seed=0, steps_per_epoch=1, device=cfg.device)
    bundle.text_model.proj.dropout = 0.0
    return bundle, state


def _ddp_step_grads(torch, kind: str, bundle, state, batch, mvm_mask):
    """One optimizer step of the case's train step; returns (state, its loss,
    {tower: flat fp32 gradient}), the gradients as the step averaged them
    over the ranks (copied where ``optim.loss_grads`` has them averaged)."""
    import importlib

    from deepcoro_clip_tpu_torch.train import optim

    module = importlib.import_module("deepcoro_clip_tpu_torch.train." + {
        "clip": "clip", "multitask": "multitask", "probe": "linear_probe"}[kind])
    reduce = optim.all_reduce_grads
    towers: dict = {}

    def kept(grads):
        reduce(grads)
        for n, g in grads.items():
            towers.setdefault(n.split(".")[0], []).append(g.detach().reshape(-1).float())
        for t, parts in towers.items():
            towers[t] = [torch.cat(parts)]

    optim.all_reduce_grads = kept
    try:
        if kind == "clip":
            state, m = module.make_train_step(bundle)(state, batch, None, 0.0, 0.0, -1.0)
        elif kind == "multitask":
            state, m = module.make_multitask_train_step(bundle)(
                state, batch, None, 1.0, 1.0, 1.0, 0.0, 0.0, -1.0, mvm_mask=mvm_mask)
        else:
            state, m = module.make_probe_train_step(bundle)(state, batch, None,
                                                            bundle.config.video_freeze_ratio)
    finally:
        optim.all_reduce_grads = reduce
    return state, float(m["loss"]), {t: v[0] for t, v in towers.items()}


def _ddp_steps_rank(torch, spec: dict, rank: int) -> dict:
    """A rank of phase 33: one optimizer step of each case on this rank's
    rows of the global batch (launches counted), the cosines of its averaged
    gradients to the world-1 ones the parent wrote, and the parameters'
    checksum after the step."""
    from deepcoro_clip_tpu_torch.parallel import distributed
    from deepcoro_clip_tpu_torch.parallel.batching import make_batch_sharding_fn
    from deepcoro_clip_tpu_torch.train.clip import replicated_keys

    cases = _ddp_step_cases(torch)
    _, world, dev = distributed.init_from_env(cases[0][2].device)
    distributed.init_grid(1)  # data parallelism alone (a job before may have cut the grid)
    out = {}
    for name, kind, cfg, batch in cases:
        bundle, state = _ddp_bundle(torch, kind, cfg)
        keys = replicated_keys(cfg) if kind == "clip" else ()
        local = make_batch_sharding_fn(world, rank, keys)(batch, dev)
        mask = None
        if kind == "multitask":
            full = torch.from_numpy(np.load(Path(spec["dir"]) / f"{name}_mvm_mask.npy"))
            per = len(full) // world
            mask = full[rank * per:(rank + 1) * per].to(dev)
        _zero_kernel_counts()
        state, loss, towers = _ddp_step_grads(torch, kind, bundle, state, local, mask)
        counts = _kernel_counts()
        ref = torch.load(Path(spec["dir"]) / f"{name}_grads.pt", weights_only=True)
        cos, digest = {}, _digest(torch, towers.values())
        for t, g in towers.items():
            r = ref[t].to(dev)
            ng, nr = torch.linalg.vector_norm(g), torch.linalg.vector_norm(r)
            cos[t] = (float(torch.dot(g, r) / (ng * nr)) if float(ng) > 0 and float(nr) > 0
                      else (1.0 if float(ng) == float(nr) == 0 else 0.0))
        del towers, ref
        out[name] = {"loss": loss, "counts": counts, "cosines": cos, "grad_digest": digest,
                     "params": _digest(torch, state.params.values()),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        print(f"rank {rank}: {name}: loss {loss:.6f}, cosines "
              + ", ".join(f"{t} {c:.6f}" for t, c in cos.items()), flush=True)
        del bundle, state, local
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return out


def _ddp_steps_prepare(torch, tmp: Path) -> dict:
    """Phase 33's world-1 side, before the ranks run: each case's world-1
    step (its loss and launches kept, its gradients and the MVM mask written
    for the ranks); returns {"dir", "want"}."""
    world, backend, topology = ddp_topology(torch)
    d = tmp / "ddp_steps"
    d.mkdir()
    print(f"ddp steps: {topology}; the towers at depth {MP_DEPTH}; global batches: SigLIP "
          f"multi-positive "
          f"{DDP_SIGLIP_BATCH} clips (cut from the YAML's 20, phase 24's 7: every rank "
          f"holds the bank of {DDP_SIGLIP_BATCH * 40} texts, twice on a shared card), "
          f"multitask "
          f"{MT_BATCH} studies x 4 clips, probing 8 studies x 10 clips; dropout 0; bars: "
          f"loss rel <= {DDP_LOSS_REL}, per-tower gradient cosine to world 1 >= phase 9's "
          f"(video {GRAD_MIN_KERNEL_VS_PLAIN['video_encoder']}, text "
          f"{GRAD_MIN_KERNEL_VS_PLAIN['text_encoder']}, other towers "
          f"{GRAD_MIN_KERNEL_VS_PLAIN['video_encoder']}) | {CARD}", flush=True)
    from deepcoro_clip_tpu_torch.device import resolve_device
    from deepcoro_clip_tpu_torch.runners.common import batch_to_device
    from deepcoro_clip_tpu_torch.train.clip import replicated_keys

    want = {}
    for name, kind, cfg, batch in _ddp_step_cases(torch):
        dev = resolve_device(cfg.device)
        bundle, state = _ddp_bundle(torch, kind, cfg)
        mask = None
        if kind == "multitask":
            from deepcoro_clip_tpu_torch.models.masked_video_modeling import (
                random_token_mask,
            )

            g = torch.Generator(device=dev).manual_seed(33)
            mask = random_token_mask(g, batch["videos"].shape[0] * cfg.num_videos,
                                     bundle.mvm.pos_emb.shape[1], cfg.mask_ratio, dev)
            np.save(d / f"{name}_mvm_mask.npy", mask.cpu().numpy())
        db = batch_to_device(batch, dev, replicated_keys(cfg) if kind == "clip" else ())
        _zero_kernel_counts()
        state, loss, towers = _ddp_step_grads(torch, kind, bundle, state, db, mask)
        want[name] = {"loss": loss, "counts": _kernel_counts()}
        torch.save({t: g.cpu() for t, g in towers.items()}, d / f"{name}_grads.pt")
        del bundle, state, db, towers
        torch.cuda.empty_cache()
    return {"dir": str(d), "want": want}


def phase_ddp_steps(torch, prepared: dict, ranks: list) -> dict:
    """Phase 33: one train step each of SigLIP multi-positive (the bank
    replicated), multitask (LocCa on, the MVM mask handed over) and
    probing, at full width, over the group against the world-1 step on the
    same global batch and weights (``_ddp_steps_prepare``); ``ranks``: the
    ranks' results (the job ``steps``, run on phase 32's launch). Returns
    {case: {"loss", "counts"}}."""
    want = prepared["want"]
    for name, w in want.items():
        got = [r[name] for r in ranks]
        for key in ("loss", "grad_digest", "params", "counts"):
            check(all(g[key] == got[0][key] for g in got),
                  f"ddp steps: {name}: ranks differ in {key}: {[g[key] for g in got]}")
        g = got[0]
        dl = abs(g["loss"] - w["loss"]) / abs(w["loss"])
        check(dl <= DDP_LOSS_REL, f"ddp steps: {name}: loss {g['loss']} vs world 1 "
              f"{w['loss']}")
        check(g["counts"]["K1"] > 0, f"ddp steps: {name}: no K1 launched: {g['counts']}")
        for t, c in g["cosines"].items():
            bar = GRAD_MIN_KERNEL_VS_PLAIN.get(t, GRAD_MIN_KERNEL_VS_PLAIN["video_encoder"])
            check(c >= bar, f"ddp steps: {name}: {t} gradient cosine {c} below {bar}")
        check(g["counts"] == w["counts"], f"ddp steps: {name}: launches per rank "
              f"{g['counts']}, world 1 {w['counts']}")
        print(f"ddp steps: {name}: loss {g['loss']:.6f} (world 1 {w['loss']:.6f}, rel "
              f"{dl:.2e}); gradient cosines to world 1: "
              + ", ".join(f"{t} {c:.6f}" for t, c in g["cosines"].items())
              + "; launches per rank "
              + ", ".join(f"{k} {v}" for k, v in g["counts"].items() if v)
              + f" (world 1 the same); parameters after the step bit-equal across the "
              f"ranks ({g['params']}); peak per rank "
              + ", ".join(f"{r[name]['peak_gib']:.2f}" for r in ranks) + " GiB", flush=True)
    return {name: {"loss": [r[name] for r in ranks][0]["loss"],
                   "counts": ranks[0][name]["counts"]} for name in want}


# --------------------------------------------------------------------------- #
# phases 34 to 36: the ring across processes (K6 on each rank's chunk, the
# ring train run through main on a (data, model) grid of ranks) and the
# reference-checkpoint importers

# Bars, stated before the first run on the card. Phase 34's ranks run the
# step kernel on the chunks the one-process pass of phase 16 gives its
# shards, in the same order from the same state: bit-equal to it; against
# the plain version, phase 16's bars (check_forward's and RING_L2_REL).
# Phase 35: a rank of the 3-rank grid computes what the one-process ring of
# 3 shards computes, but its ring's backward forms the probabilities from
# the final row statistics where autograd goes back through each step's,
# so the runs part by rounding from the first backward on: per-step loss
# within DDP_LOSS_REL of the one-process run's, as phase 32 holds world N
# to world 1.
RINGP_RANKS = 4  # phase 34: one chunk of 3920 tokens a rank
RING_MAIN_RANKS = 3  # phase 35: 3 divides 1569 and 393, as in phase 19
# phase 35's towers cut from 12 blocks to 2, so that the script holds
# phases 37 and 38 within its limit (3 ranks still divide the 1569 tokens)
RING_MAIN_DEPTH = 2
RINGP_REPS = 10
IMPORT_MIN_COSINE = 0.999
IMPORT_TEXTS = 8  # phase 36: reports of 512 tokens through the imported text tower


def ring_topology(torch, n: int) -> tuple:
    """(backend, description) of n ranks: one a card over NCCL where the
    machine shows n cards or more, else n ranks sharing card 0 over gloo."""
    if torch.cuda.device_count() >= n:
        return "nccl", f"{n} ranks, one a card (NCCL)"
    return "gloo", (f"{n} ranks sharing card 0 (gloo; NCCL refuses two ranks on one "
                    "device): each chunk goes through pinned host memory; the times "
                    "are a correctness run's, not a scaling figure")


def _rank_ms(torch, dist, fn, reps: int) -> float:
    """Median host time of ``fn``, each call started together on every rank
    (a barrier) and synchronised before and after."""
    ts = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def _ring_pass_rank(torch, spec: dict, rank: int) -> dict:
    """A rank of phase 34: its chunk of q/k/v through ring_attention over the
    process group (backend "rdma": K6 on this rank's card), launches counted
    from 0 just before; against K6's plain version across the same ranks
    and the one-process pass's chunk; the pass, its plain version and the
    exchanges alone timed; the pass's peak memory above its inputs."""
    import torch.distributed as dist

    from deepcoro_clip_tpu_torch.parallel import distributed, ring_attention
    from deepcoro_clip_tpu_torch.parallel.mesh import MODEL_AXIS
    from deepcoro_clip_tpu_torch.parallel.ring_attention import _Link

    _, world, dev = distributed.init_from_env(None)
    mesh = distributed.init_grid(world)
    m = mesh.index[MODEL_AXIS]
    saved = torch.load(spec["inputs"], weights_only=True)
    c = slice(m * RING_L // world, (m + 1) * RING_L // world)
    q, k, v, one, one_f32 = (saved[x][:, :, c].to(dev).contiguous()
                             for x in ("q", "k", "v", "one", "one_f32"))
    del saved
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        _zero_kernel_counts()
        out = ring_attention(q, k, v, mesh, backend="rdma")  # the main path
        torch.cuda.synchronize()
        launches = _kernel_counts()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        again = ring_attention(q, k, v, mesh, backend="rdma")
        plain = ring_attention(q, k, v, mesh, backend="rdma_interpret")
        torch.cuda.synchronize()
        d = (out.float() - plain.float()).abs()
        within = bool(torch.isfinite(out).all()) and bool(
            (d <= KERNEL_ATOL + KERNEL_RTOL * plain.float().abs()).all())
        link = _Link(mesh, MODEL_AXIS)
        slots = torch.empty((2, 2) + tuple(q.shape), dtype=torch.bfloat16, device=dev)
        side = torch.cuda.Stream(dev)

        def exchanges():  # the pass's n - 1 slot exchanges, no kernel
            side.wait_stream(torch.cuda.current_stream())
            for r in range(world - 1):
                torch.cuda.current_stream().wait_event(
                    link.post(slots[r % 2], slots[(r + 1) % 2], None, side).finish())

        times = {"ms": _rank_ms(torch, dist, lambda: ring_attention(q, k, v, mesh,
                                                                     backend="rdma"),
                                RINGP_REPS),
                 "plain_ms": _rank_ms(torch, dist, lambda: ring_attention(
                     q, k, v, mesh, backend="rdma_interpret"), 3),
                 "exchange_ms": _rank_ms(torch, dist, exchanges, RINGP_REPS)}
        # the same chunks in fp32 (phase 39's route across ranks): K6's fp32
        # SIMT step on each rank, against the plain version and the
        # one-process fp32 pass's chunk
        qf, kf, vf = q.float(), k.float(), v.float()
        _zero_kernel_counts()
        out_f = ring_attention(qf, kf, vf, mesh, backend="rdma")
        torch.cuda.synchronize()
        f32_launches = _kernel_counts()["K6"]
        plain_f = ring_attention(qf, kf, vf, mesh, backend="rdma_interpret")
        d_f = (out_f - plain_f).abs()
        f32 = {"launches": f32_launches, "max_abs_err": float(d_f.max()),
               "within": bool(torch.isfinite(out_f).all()) and bool(
                   (d_f <= F32_ATOL + F32_RTOL * plain_f.abs()).all()),
               "bit_equal_to_one_process": bool(torch.equal(out_f, one_f32)),
               "ms": _rank_ms(torch, dist, lambda: ring_attention(qf, kf, vf, mesh,
                                                                  backend="rdma"), 2)}
        del qf, kf, vf, out_f, plain_f, d_f
    result = {"chunk": m, "launches": launches, "max_abs_err": float(d.max()), "f32": f32,
              "within": within, "rel_l2": _rel_l2(out, plain),
              "bit_equal_run_to_run": bool(torch.equal(out, again)),
              "bit_equal_to_one_process": bool(torch.equal(out, one)),
              "max_abs_vs_one_process": float((out.float() - one.float()).abs().max()),
              "peak_gib": peak, "device": torch.cuda.current_device(),
              "backend": dist.get_backend(), **times}
    print(f"rank {rank}: chunk {m} on cuda:{result['device']} ({result['backend']}): "
          f"K6 {launches['K6']} launches, max|K6 - plain| {result['max_abs_err']:.3e}, "
          f"pass {times['ms']:.2f} ms, exchanges alone {times['exchange_ms']:.2f} ms",
          flush=True)
    distributed.shutdown()
    return result


def phase_ring_processes(torch, tmp: Path) -> dict:
    """Phase 34: the ring pass of phase 16 ([2,4,15680,128] bf16) over 4
    ranks of a process group (torch.distributed.run, as phase 32 launches
    it), each rank's chunk of 3920 tokens through K6 on its card; returns
    the K6 entry's additions."""
    from deepcoro_clip_tpu_torch.parallel import ring_attention

    n = RINGP_RANKS
    backend, topology = ring_topology(torch, n)
    print(f"ring processes: [{RING_B},{RING_H},{RING_L},{RING_DH}] bf16 over {n} ranks "
          f"(chunks of {RING_L // n} tokens), ring_attention(backend=\"rdma\") on each "
          f"rank's chunk; {topology} | {CARD}", flush=True)
    q, k, v = ring_inputs(torch, RING_L, seed=34)
    mesh = ring_mesh(torch, n)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        one = ring_attention(q, k, v, mesh, backend="rdma")
        torch.cuda.synchronize()
        one_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        one_ms = cuda_ms(torch, lambda: ring_attention(q, k, v, mesh, backend="rdma"), REPS)
        one_f32 = ring_attention(q.float(), k.float(), v.float(), mesh, backend="rdma")
    path = tmp / "ring_inputs.pt"
    torch.save({"q": q.cpu(), "k": k.cpu(), "v": v.cpu(), "one": one.cpu(),
                "one_f32": one_f32.cpu()}, path)
    del one_f32
    del q, k, v, one
    torch.cuda.empty_cache()
    ranks, wall = _launch(n, {"job": "ring_pass", "inputs": str(path)}, tmp, "ring_pass")
    path.unlink()
    check(sorted(r["chunk"] for r in ranks) == list(range(n)), f"chunks {ranks}")
    for r, res in enumerate(ranks):
        check(res["launches"]["K6"] == n and sum(res["launches"].values()) == n,
              f"ring processes: rank {r} launched {res['launches']}, expected {n} K6")
        check(res["within"] and res["rel_l2"] <= RING_L2_REL,
              f"ring processes: rank {r}: K6 against its plain version: max "
              f"{res['max_abs_err']}, rel l2 {res['rel_l2']}")
        check(res["bit_equal_run_to_run"], f"ring processes: rank {r}: two passes differ")
        check(res["bit_equal_to_one_process"], f"ring processes: rank {r}: its chunk "
              f"differs from the one-process pass's by {res['max_abs_vs_one_process']}")
        f = res["f32"]
        check(f["launches"] == n and f["within"] and f["bit_equal_to_one_process"],
              f"ring processes: rank {r}: the fp32 pass: {f['launches']} K6 launches, max "
              f"|K6 - plain| {f['max_abs_err']} (bars {F32_ATOL}+{F32_RTOL}|plain|), "
              f"bit-equal to the one-process fp32 pass: {f['bit_equal_to_one_process']}")
    B, H, L, Dh = RING_B, RING_H, RING_L, RING_DH
    Lc = L // n
    # a rank: its q, k, v and output once, and the n - 1 chunks it receives
    b_ms, b_by = bound(4 * B * H * Lc * L * Dh, 4 * B * H * Lc * Dh * 2
                       + (n - 1) * 2 * B * H * Lc * Dh * 2)
    ms = max(r["ms"] for r in ranks)
    share = [r["exchange_ms"] / r["ms"] for r in ranks]
    print(f"ring processes: K6 against its plain version on every rank (phase 16's bars: "
          f"max|d| {max(r['max_abs_err'] for r in ranks):.3e}, rel l2 "
          f"{max(r['rel_l2'] for r in ranks):.3e} <= {RING_L2_REL}); every chunk bit-equal "
          f"to the one-process pass of {n} shards and run to run", flush=True)
    print(f"ring processes: launches per rank "
          + ", ".join(str(r["launches"]["K6"]) for r in ranks)
          + f" K6 (n = {n} a rank a pass, the one-process pass {n * n})", flush=True)
    print(f"ring processes: pass {ms:.2f} ms (slowest rank, host clock, median of "
          f"{RINGP_REPS} passes started together), plain version "
          f"{max(r['plain_ms'] for r in ranks):.2f} ms; the exchanges alone "
          + ", ".join(f"{r['exchange_ms']:.2f}" for r in ranks)
          + " ms, share of the pass " + ", ".join(f"{s:.2f}" for s in share)
          + f"; the one-process pass {one_ms:.3f} ms (CUDA events); a rank's bound "
          f"{b_ms:.4f} ms ({b_by}) | {topology} | {CARD}", flush=True)
    print(f"ring processes: peak memory of the pass above its inputs per rank "
          + ", ".join(f"{r['peak_gib']:.3f}" for r in ranks)
          + f" GiB; the one-process pass of {n} shards {one_peak:.3f} GiB | {CARD}",
          flush=True)
    print(f"ring processes: the same chunks in fp32 (K6's fp32 SIMT step through "
          f"ring_fwd_rank): {', '.join(str(r['f32']['launches']) for r in ranks)} launches a "
          f"rank, max|K6 - plain| {max(r['f32']['max_abs_err'] for r in ranks):.3e} (bars "
          f"{F32_ATOL}+{F32_RTOL}|plain|), every chunk bit-equal to the one-process fp32 pass; "
          f"pass {max(r['f32']['ms'] for r in ranks):.2f} ms (slowest rank, median of 2) | "
          f"{topology} | {CARD}", flush=True)
    print(f"ring processes: torch.distributed.run launch {wall:.1f} s", flush=True)
    return {"process_ring_launches_per_rank": [r["launches"]["K6"] for r in ranks],
            "process_ring_f32": {
                "ranks": n, "launches_per_rank": [r["f32"]["launches"] for r in ranks],
                "ms": max(r["f32"]["ms"] for r in ranks),
                "max_abs_err": max(r["f32"]["max_abs_err"] for r in ranks)},
            "process_ring": {
                "ranks": n, "backend": backend, "ms": ms,
                "plain_ms": max(r["plain_ms"] for r in ranks), "bound_ms": b_ms,
                "bound_by": b_by, "exchange_share": share, "one_process_ms": one_ms,
                "max_abs_err": max(r["max_abs_err"] for r in ranks),
                "peak_gib": [r["peak_gib"] for r in ranks],
                "one_process_peak_gib": one_peak}}


def phase_ring_main_run(torch, manifest: Path, tmp: Path) -> dict:
    """Phase 35: phase 22's config at dropout 0 and depth RING_MAIN_DEPTH
    with use_ring_attention and mesh_model 3 through main on 3 ranks (the grid (1, 3): each rank's model
    group holds the ring's three chunks), 2 epochs of 3 steps, then resumed
    from epoch 0's checkpoint; against the same config in this process as a
    one-process ring of 3 shards on card 0."""
    from deepcoro_clip_tpu_torch.main import main as port_main
    from deepcoro_clip_tpu_torch.train import clip as clip_train

    n = RING_MAIN_RANKS
    backend, topology = ring_topology(torch, n)
    steps = QUALITY_TRAIN // 16
    over = {"use_ring_attention": True, "mesh_model": n, "vit_depth": RING_MAIN_DEPTH,
            "text_depth": RING_MAIN_DEPTH}
    print(f"ring main run: config/quality/flagship_quality_train.yaml as phase 22 runs it, "
          f"at depth {RING_MAIN_DEPTH} (video and text towers), "
          f"dropout 0, use_ring_attention true, mesh_model {n}: {n} ranks on the grid "
          f"(data 1, model {n}), batch 16 on every rank, {steps} steps an epoch, 2 epochs, "
          f"then resumed from epoch 0; {topology}; bar: per step |loss - loss_one| <= "
          f"{DDP_LOSS_REL} |loss_one| | {CARD}", flush=True)
    root = tmp / "ring_main"
    keep = root / "epoch0"
    # the same config in this process, the ring over 3 shards on card 0; its
    # dataset statistics go to the ranks (as in phase 32)
    build = clip_train.build_clip_bundle
    clip_train.build_clip_bundle = lambda *a, **kw: build(*a, mesh=ring_mesh(torch, n), **kw)
    rec = _quality_recorder(torch, 0)
    torch.cuda.reset_peak_memory_stats()
    _zero_kernel_counts()
    cfg_one = _quality_ddp_config(str(manifest), str(tmp / "ring_one"), **over)
    try:
        one = port_main(config=cfg_one)
    finally:
        clip_train.build_clip_bundle = build
        rec["undo"]()
    one_counts = {**_kernel_counts(), **_long_counts()}
    one_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    one_steps = [{k: float(v) for k, v in s.items()} for s in rec["steps"]]
    torch.cuda.empty_cache()
    over = dict(over, dataset_mean=cfg_one.dataset_mean, dataset_std=cfg_one.dataset_std)
    ranks, wall = _launch(n, {"job": "quality", "manifest": str(manifest),
                              "root": str(root), "output_dir": str(root / "full"),
                              "keep_epoch0": str(keep), "resume": str(keep), "over": over,
                              "profile": False}, tmp, "ring_main")

    for r, res in enumerate(ranks):
        check(res["grid"] == {"data": 1, "model": n}, f"ring main run: rank {r} grid "
              f"{res['grid']}")
    first = ranks[0]
    for r in ranks[1:]:
        check(r["steps"] == first["steps"], "ring main run: rank steps differ: "
              f"{r['steps']} vs {first['steps']}")
        check(r["checksums"] == first["checksums"],
              "ring main run: parameters differ across ranks: "
              f"{r['checksums']} vs {first['checksums']}")
    print(f"ring main run: parameter checksums after each epoch, every rank: "
          f"{first['checksums']} (bit-equal across the {n} ranks)", flush=True)
    got = first["steps"]
    check(len(got) == len(one_steps) == 2 * steps, f"steps {len(got)} / {len(one_steps)}")
    for i, (a, b) in enumerate(zip(got, one_steps)):
        dl = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        print(f"ring main run: step {i}: loss {a['loss']:.6f} (one process "
              f"{b['loss']:.6f}, rel {dl:.2e}), grad_norm {a['grad_norm']:.5f} "
              f"({b['grad_norm']:.5f}), alignment {a['alignment']:.5f} "
              f"({b['alignment']:.5f})", flush=True)
        check(math.isfinite(a["loss"]) and dl <= DDP_LOSS_REL,
              f"ring main run: step {i} off the one-process ring: {a} vs {b}")
    for r, res in enumerate(ranks):
        check(res["counts"] == one_counts, f"ring main run: rank {r} launches "
              f"{res['counts']}, one process {one_counts}")
    check(one_counts["K3"] > 0 and one_counts["K4"] > 0 and one_counts["K6"] == 0,
          f"ring main run: launches {one_counts}")
    print(f"ring main run: launches per rank over the run "
          + ", ".join(f"{k} {first['counts'][k]}" for k in ("K1", "K2", "K3", "K4", "K6"))
          + f" (the backbone's {RING_MAIN_DEPTH} blocks on the \"xla\" ring: no K1, K2; the "
          "text tower's and the aggregator's K3, K4), as the one-process ring "
          + ", ".join(f"{k} {one_counts[k]}" for k in ("K1", "K2", "K3", "K4", "K6")),
          flush=True)
    run = Path(first["output_dir"])
    runs = sorted(p.parent for p in (root / "full").rglob("checkpoints"))
    check(runs == [run], f"ring main run: run directories {runs}")
    for r, res in enumerate(ranks):
        check(bool(res["written"]) == (r == 0),
              f"ring main run: rank {r} wrote {res['written'][:5]}")
    saved = torch.load(run / "checkpoints" / "checkpoint.pt", weights_only=True)
    check(len(saved["generators"]) == 1 and saved["step"] == 2 * steps,
          f"ring main run: checkpoint step {saved['step']}, {len(saved['generators'])} "
          "generator states (one a data index)")
    res_h = first["resumed"]["history"]
    check([h["epoch"] for h in res_h] == [1] and res_h[0]["loss"] == first["history"][1]["loss"]
          and all(r["resumed"]["checksums"][-1:] == first["checksums"][-1:] for r in ranks),
          f"ring main run: resumed {res_h} vs {first['history'][1]}, checksums "
          f"{[r['resumed']['checksums'] for r in ranks]} vs {first['checksums']}")
    print(f"ring main run: one run directory, written by rank 0 alone; the checkpoint "
          f"holds 1 generator state (one a data index); resumed from epoch 0: epoch-1 loss "
          f"{res_h[0]['loss']!r} (uninterrupted {first['history'][1]['loss']!r}), "
          f"parameters bit-equal on every rank", flush=True)
    h, h1 = first["history"][1], one["history"][1]
    times = {"ranks": n, "backend": backend,
             "step_ms": h["epoch_seconds"] * 1e3 / steps,
             "one_process_step_ms": h1["epoch_seconds"] * 1e3 / steps,
             "peak_gib": [r["peak_gib"] for r in ranks], "one_process_peak_gib": one_peak,
             "launch_s": wall}
    print(f"ring main run: step {times['step_ms']:.1f} ms (host clock, epoch 1 over "
          f"{steps} steps; every rank runs the whole batch), the one-process ring "
          f"{times['one_process_step_ms']:.1f} ms; peak memory per rank "
          + ", ".join(f"{g:.2f}" for g in times["peak_gib"])
          + f" GiB, one process {one_peak:.2f} GiB | {topology} | {CARD}", flush=True)
    print(f"ring main run: torch.distributed.run launch {wall:.1f} s (the run and its "
          f"resumption, process start and set-up included)", flush=True)
    return {"counts": first["counts"], "times": times}


def reference_text_checkpoint(cfg, seed: int = 36) -> dict:
    """A reference-named checkpoint (the layout the upstream runners save:
    component-keyed state dicts) at the text tower's width: ``text_encoder``
    as HF BERT names under ``bert.`` (pooler, token types) and the ``proj.1``
    head; a video encoder of mVIT keys and its head, optimizer state and
    metadata beside it. Seeded: BERT's init scale (std 0.02), LayerNorm
    weights 1."""
    import torch

    r = np.random.default_rng(seed)
    D, M = cfg.text_dim, cfg.text_dim * 4

    def t(*shape, std=0.02):
        return torch.from_numpy((std * r.standard_normal(shape)).astype(np.float32))

    def ln(name):
        return {f"{name}.weight": 1.0 + t(D, std=0.05), f"{name}.bias": t(D)}

    def lin(name, dout, din):
        return {f"{name}.weight": t(dout, din), f"{name}.bias": t(dout)}

    bert = {"embeddings.word_embeddings.weight": t(cfg.text_vocab_size, D),
            "embeddings.position_embeddings.weight": t(512, D),
            "embeddings.token_type_embeddings.weight": t(2, D),
            **ln("embeddings.LayerNorm"), **lin("pooler.dense", D, D)}
    for i in range(cfg.text_depth):
        b = f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            bert.update(lin(f"{b}.attention.self.{name}", D, D))
        bert.update(lin(f"{b}.attention.output.dense", D, D))
        bert.update(ln(f"{b}.attention.output.LayerNorm"))
        bert.update(lin(f"{b}.intermediate.dense", M, D))
        bert.update(lin(f"{b}.output.dense", D, M))
        bert.update(ln(f"{b}.output.LayerNorm"))
    text = {f"bert.{k}": v for k, v in bert.items()}
    text.update(lin("proj.1", cfg.embedding_dim, D))
    video = {"model.blocks.0.attn.qkv.weight": t(3 * 96, 96),
             "model.patch_embed.proj.weight": t(96, 3, 3, 7, 7),
             **lin("proj.1", cfg.embedding_dim, 768)}
    return {"epoch": 11, "best_val_loss": 1.25, "text_encoder": text,
            "video_encoder": video,
            "optimizer": {"state": {0: {"exp_avg": t(4)}}, "param_groups": [{"lr": 1e-4}]}}


def phase_checkpoint_import(torch, tmp: Path) -> dict:
    """Phase 36: a seeded reference-named checkpoint at the text tower's
    width through ``python -m deepcoro_clip_tpu_torch.convert_checkpoint``,
    its text tower loaded strictly into the port's TextEncoder on the card
    (flagship width: 12 layers, 6 heads of 128: K1), embeddings of 8 seeded
    reports of 512 tokens through K1 against the plain attention."""
    from deepcoro_clip_tpu_torch.models.text_encoder import text_encoder_from_config
    from deepcoro_clip_tpu_torch.utils.torch_import import load_converted

    cfg = train_config(dropout=0.0)
    t0 = time.perf_counter()
    src, out, rep = tmp / "reference.pt", tmp / "converted.pt", tmp / "report.json"
    torch.save(reference_text_checkpoint(cfg), src)
    here = Path(__file__).resolve().parent
    proc = subprocess.run([sys.executable, "-m", "deepcoro_clip_tpu_torch.convert_checkpoint",
                           str(src), "--out", str(out), "--report", str(rep)], cwd=here,
                          capture_output=True, text=True)
    check(proc.returncode == 0, f"convert_checkpoint exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    for line in proc.stdout.splitlines():
        print(f"checkpoint import: {line}", flush=True)
    convert_s = time.perf_counter() - t0
    report = json.loads(rep.read_text())
    check(report["converted"] == ["text_encoder", "video_encoder (partial)"]
          and report["skipped"] == {
              "video_encoder.model (mVIT backbone — no CoroViT mapping)": 2,
              "optimizer": 2} and report["meta"] == {"epoch": 11, "best_val_loss": 1.25},
          f"checkpoint import: report {report}")
    states = load_converted(str(out))
    dev = torch.device("cuda")
    models = {}
    for flash in (True, False):
        cfg_ = train_config(dropout=0.0, use_pallas_attention=flash)
        model = text_encoder_from_config(cfg_)
        model.load_state_dict(states["text_encoder"], strict=True)
        models[flash] = model.to(dev).eval()
    r = np.random.default_rng(36)
    L = cfg.max_text_length
    lengths = r.integers(16, L, IMPORT_TEXTS)
    lengths[0] = L
    mask = torch.from_numpy((np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)).to(dev)
    ids = torch.from_numpy(r.integers(1000, cfg.text_vocab_size, (IMPORT_TEXTS, L))
                           .astype(np.int64)).to(dev) * mask
    with torch.no_grad():
        _zero_kernel_counts()
        emb = models[True](ids, mask)
        torch.cuda.synchronize()
        counts = _kernel_counts()
        ref = models[False](ids, mask)
    cos = torch.nn.functional.cosine_similarity(emb.float(), ref.float(), dim=-1)
    check(counts["K1"] == cfg.text_depth and sum(counts.values()) == cfg.text_depth,
          f"checkpoint import: launches {counts}, expected {cfg.text_depth} K1")
    check(bool(torch.isfinite(emb).all()) and float(cos.min()) >= IMPORT_MIN_COSINE,
          f"checkpoint import: K1 vs plain attention cosine {float(cos.min())}")
    print(f"checkpoint import: the text tower ({sum(v.numel() for v in states['text_encoder'].values())} "
          f"parameters, loaded strictly) on the card: {counts['K1']} K1 launches for "
          f"{IMPORT_TEXTS} reports of {L} tokens; embeddings through K1 against the plain "
          f"attention: min cosine {float(cos.min()):.6f} (bar {IMPORT_MIN_COSINE}); write, "
          f"convert and read back {convert_s:.1f} s", flush=True)
    for p in (src, out, rep):
        p.unlink()
    del models, states
    torch.cuda.empty_cache()
    return {"counts": counts, "min_cosine": float(cos.min())}


def run_drift(torch) -> dict:
    """``--drift``: phase 32's world-1 control against runs that compute
    the same function another way, to size the grad_norm drift phase 32
    prints past the first update: world 2 (``ddp_topology``), world 1 with
    each batch's rows in reverse order (the same loss and gradient, summed
    in another order), and world 1 with gradient_accumulation_steps 2 (an
    update over two batches: another trajectory after the first update).
    Each step's loss and grad_norm beside the control's."""
    from deepcoro_clip_tpu_torch.main import main as port_main
    from deepcoro_clip_tpu_torch.runners.contrastive import VideoContrastiveLearningRunner

    build_kernels(torch, ("flash_fwd", "flash_bwd", "flash_short"))
    out = {}
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        manifest = render_corpus(tmp)

        def world1(name, reverse=False, **over):
            rec = _quality_recorder(torch, 0)
            init = VideoContrastiveLearningRunner.__init__

            def reversed_rows(self, *a, **kw):
                init(self, *a, **kw)
                step = self.train_step

                def flipped(state, batch, *args):
                    n = len(batch["videos"])
                    return step(state, {k: v.flip(0) if hasattr(v, "flip") and len(v) == n
                                        else v for k, v in batch.items()}, *args)

                self.train_step = flipped

            if reverse:
                VideoContrastiveLearningRunner.__init__ = reversed_rows
            try:
                port_main(config=_quality_ddp_config(str(manifest), str(tmp / name), **over))
            finally:
                VideoContrastiveLearningRunner.__init__ = init
                rec["undo"]()
            torch.cuda.empty_cache()
            return [{k: float(v) for k, v in s.items()} for s in rec["steps"]]

        world, _, topology = ddp_topology(torch)
        ranks, _ = _launch(world, {"job": "quality", "manifest": str(manifest),
                                   "root": str(tmp / "drift"),
                                   "output_dir": str(tmp / "drift" / "full")}, tmp, "drift")
        out = {"control": world1("control"), f"world {world}": ranks[0]["steps"],
               "reversed rows": world1("reversed", reverse=True),
               "accumulation 2": world1("accumulation", gradient_accumulation_steps=2)}
    ctl = out["control"]
    print(f"drift: phase 32's config at world 1 (control) against world {world} "
          f"({topology}), the rows of each batch reversed, and gradient_accumulation_steps "
          f"2 | {CARD}", flush=True)
    for i, c in enumerate(ctl):
        print(f"drift: step {i} (lr {c['lr']:.2e}): control loss {c['loss']:.6f} grad_norm "
              f"{c['grad_norm']:.5f}; " + "; ".join(
                  f"{name} loss {s[i]['loss']:.6f} grad_norm {s[i]['grad_norm']:.5f} (rel "
                  f"{abs(s[i]['grad_norm'] - c['grad_norm']) / c['grad_norm']:.2e})"
                  for name, s in out.items() if name != "control"), flush=True)
    return {name: [{k: s[k] for k in ("loss", "grad_norm")} for s in steps]
            for name, steps in out.items()}


# --------------------------------------------------------------------------- #
# phases 37 and 38: tensor parallelism over the model axis

TP_RANKS = 2  # mesh_model: every attention's heads and MLP's hidden width cut in two
# the bars, written before the first run on the card. Per step, the loss
# against world 1 by phase 32's bar at every step; at the steps taken from the
# same weights (before the first update: lr 0 in the warmup) tighter: there
# only the bf16 rounding of each row-parallel product's partial (summed in
# fp32 over the model group) and the order of the sums differ, as the GEMMs'
# row blocking does between world N and world 1 in phase 32 (grad_norm
# within 5e-5 there); a wrong cut (a head, a bias added twice) moves both
# by far more. After an update Adam amplifies rounding (phase 32's
# --drift): the loss bar alone holds there.
TP_LOSS_REL = DDP_LOSS_REL
TP_SAME_WEIGHTS_LOSS_REL = 1e-3
TP_GRAD_NORM_REL = 5e-3
# the M = 2 run's checkpoint restored at M = 1 against the M = 2 model on
# the same clips and reports: the cosine of each embedding
TP_MIN_COSINE = 0.9999
TP_EMBED_ROWS = 4
TP_PROBE_STEPS = 1  # timed probing steps after one warm step
# a rank's heads at M = 2: the aggregator's 8 / 2, the text tower's 12 / 2,
# the video tower's 4 / 2
TP_AGG_HEADS, TP_TEXT_HEADS, TP_VIDEO_HEADS = 4, 6, 2


def _tp_embed_batch(cfg) -> dict:
    """Seeded clips and reports for the embedding check: TP_EMBED_ROWS uint8
    clips at the run's frames and size, reports of max_text_length tokens
    with padding."""
    r = np.random.default_rng(37)
    n, L = TP_EMBED_ROWS, cfg.max_text_length
    lengths = r.integers(L // 8, L, n)
    att = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    return {"videos": r.integers(0, 255, (n, cfg.frames, cfg.resize, cfg.resize, 3),
                                 dtype=np.uint8),
            "input_ids": (r.integers(1000, cfg.text_vocab_size, (n, L)) * att).astype(np.int32),
            "attention_mask": att}


def _tp_embeddings(torch, cfg, checkpoints: Path) -> list:
    """The video and text embeddings of ``_tp_embed_batch`` by the models of
    ``cfg`` (on the grid it asks for) restored from ``checkpoints``, as
    nested lists ``[rows, 2 * embedding_dim]``."""
    from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager
    from deepcoro_clip_tpu_torch.train.clip import build_clip_bundle

    bundle, state = build_clip_bundle(cfg, seed=0, steps_per_epoch=1, device=cfg.device)
    CheckpointManager(checkpoints).restore(state, "checkpoint")
    b = {k: torch.as_tensor(v).to(bundle.device) for k, v in _tp_embed_batch(cfg).items()}
    with torch.no_grad():
        v = bundle.video_model(b["videos"], deterministic=True)
        t = bundle.text_model(b["input_ids"], attention_mask=b["attention_mask"],
                              deterministic=True)
    out = torch.cat([v.float(), t.float()], dim=1).cpu().tolist()
    del bundle, state, b, v, t
    torch.cuda.empty_cache()
    return out


def _model_reduce_timer(torch) -> tuple:
    """Wrap torch.distributed.all_reduce so that the calls on the grid's
    model group are timed on the host, the card synchronised before and
    after each (every other call passes through); returns (record, undo)."""
    import torch.distributed as dist

    from deepcoro_clip_tpu_torch.parallel import distributed
    from deepcoro_clip_tpu_torch.parallel.mesh import MODEL_AXIS

    group = distributed.grid().groups[MODEL_AXIS]
    reduce = dist.all_reduce
    rec = {"calls": 0, "ms": 0.0, "bytes": 0}

    def timed(tensor, *a, **kw):
        if group is None or kw.get("group") is not group:
            return reduce(tensor, *a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work = reduce(tensor, *a, **kw)
        torch.cuda.synchronize()
        rec["ms"] += (time.perf_counter() - t0) * 1e3
        rec["calls"] += 1
        rec["bytes"] += tensor.numel() * tensor.element_size()
        return work

    def undo():
        dist.all_reduce = reduce

    dist.all_reduce = timed
    return rec, undo


def _tp_packed_rows(torch, label: str, B: int, H: int) -> tuple:
    """K1 and K2 at a rank's heads of the video tower: the fused qkv
    ``[B, L, 3*H*128]`` with RoPE at 1569 and 393 tokens (before and after
    the pool), against their plain versions (phase 3's and phase 7's bars),
    with times, busy times, bounds and SDPA's. Returns (K1 rows, K2 rows)."""
    import torch.nn.functional as F

    from deepcoro_clip_tpu_torch.ops.attention import (
        apply_rope,
        flash_bwd_plain,
        multi_head_attention,
    )
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(37)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    rows_f, rows_b = [], []
    for T, HW in ((8, 14), (8, 7)):
        t = build_rope3d_tables(128, T, HW, HW, n_special=1)
        sin, cos = torch.from_numpy(t.sin).to(dev), torch.from_numpy(t.cos).to(dev)
        D, L, Dh = H * 128, sin.shape[0], 128
        qkv, do = randn(B, L, 3 * D), randn(B, L, D)
        heads = [_to_heads(u, H) for u in qkv.split(D, -1)]
        shape = f"qkv [{B},{L},{3 * D}] bf16, H {H}, Dh 128, RoPE"
        with torch.no_grad():
            ref_out = multi_head_attention(*heads, sin=sin, cos=cos)
            err_f = check_forward(torch, label, f"K1 {shape}", _to_heads(
                flash_attention_packed(qkv=qkv, num_heads=H, sin=sin, cos=cos), H), ref_out)
        leaf = qkv.clone().requires_grad_()
        out = flash_attention_packed(qkv=leaf, num_heads=H, sin=sin, cos=cos)
        (dqkv,) = torch.autograd.grad(out, [leaf], do, retain_graph=True)
        doh, outh = _to_heads(do, H), _to_heads(out.detach(), H)
        ref = flash_bwd_plain(*heads, doh, ref_out, sin=sin, cos=cos)
        err_b = max(_rel_check(f"K2 {shape}", w, _to_heads(a, H), r)
                    for w, a, r in zip(("dq", "dk", "dv"), dqkv.split(D, -1), ref))
        print(f"{label}: K2 {shape}: max|kernel-plain| {err_b:.3e} (bars: max|d| <= "
              f"{BWD_MAX_REL} max|plain|, rel l2 <= {BWD_L2_REL}) ok", flush=True)
        sq = [apply_rope(heads[0], sin, cos), apply_rope(heads[1], sin, cos), heads[2]]
        sl = [u.detach().clone().requires_grad_() for u in sq]
        sout = F.scaled_dot_product_attention(*sl)
        tables = 2 * L * Dh * 4
        b_fwd = bound(4 * B * H * L * L * Dh, (B * L * 3 * D + B * L * D) * 2 + tables)
        b_bwd = bound(10 * B * H * L * L * Dh, 8 * B * L * D * 2 + tables)
        with torch.no_grad():
            row = {"shape": shape, "max_abs_err": err_f,
                   "ms": cuda_ms(torch, lambda: flash_attention_packed(
                       qkv=qkv, num_heads=H, sin=sin, cos=cos), REPS),
                   "plain_ms": cuda_ms(torch, lambda: multi_head_attention(
                       *heads, sin=sin, cos=cos), max(1, REPS // 5)),
                   "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(*sq),
                                         REPS),
                   "bound_ms": b_fwd[0], "bound_by": b_fwd[1],
                   "device_ms": device_ms(torch, lambda: flash_attention_packed(
                       qkv=qkv, num_heads=H, sin=sin, cos=cos), REPS,
                       ("flash_fwd_sm90_kernel",))}
            row["tflops"] = 4 * B * H * L * L * Dh / row["ms"] / 1e9
        rows_f.append(row)
        rows_b.append({
            "shape": shape, "max_abs_err": err_b,
            "ms": cuda_ms(torch, lambda: torch.autograd.grad(out, [leaf], do,
                                                             retain_graph=True), REPS),
            "plain_ms": cuda_ms(torch, lambda: flash_bwd_plain(*heads, doh, outh, sin=sin,
                                                               cos=cos), max(1, REPS // 5)),
            "library_ms": cuda_ms(torch, lambda: torch.autograd.grad(sout, sl, doh,
                                                                     retain_graph=True),
                                  REPS),
            "bound_ms": b_bwd[0], "bound_by": b_bwd[1],
            "device_ms": device_ms(torch, lambda: torch.autograd.grad(
                out, [leaf], do, retain_graph=True), REPS, K2_KERNELS)})
        for name, r in (("K1 forward", rows_f[-1]), ("K2 backward", rows_b[-1])):
            print(f"{label}: {name} {shape}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}); card busy "
                  f"{r['device_ms']:.4f} ms | {CARD}", flush=True)
        del qkv, do, heads, leaf, out, dqkv, doh, outh, ref, ref_out, sq, sl, sout
        torch.cuda.empty_cache()
    return rows_f, rows_b


def _tp_quality_spec(manifest: Path, tmp: Path, world1: dict) -> dict:
    """The ranks' job of phases 37 and 38: phase 22's config at dropout 0
    with mesh_model TP_RANKS and the world-1 run's dataset statistics, 2
    epochs (the model group's all-reduces of the last step timed), resumed
    from epoch 0's checkpoint, the embeddings of the run's checkpoint, then
    phase 38's probing step."""
    root = tmp / "tp_quality"
    keep = root / "epoch0"
    return {"job": "quality", "manifest": str(manifest), "root": str(root),
            "output_dir": str(root / "full"), "keep_epoch0": str(keep), "resume": str(keep),
            "over": dict(world1["stats"], mesh_model=TP_RANKS), "embed": True, "probe": True,
            "profile": False, "time_reduce_step": 2 * (QUALITY_TRAIN // 16) - 1}


def _tp_bars(torch) -> None:
    """Phases 37 and 38's configurations and bars, printed before their
    ranks run."""
    n = TP_RANKS
    _, topology = ring_topology(torch, n)
    print(f"tensor-parallel run: config/quality/flagship_quality_train.yaml as phase 22 "
          f"runs it, dropout 0, mesh_model {n} without the ring: {n} ranks on the grid "
          f"(data 1, model {n}), each with {TP_VIDEO_HEADS} of the video tower's 4 heads, "
          f"{TP_TEXT_HEADS} of the text tower's 12, {TP_AGG_HEADS} of the aggregator's 8 and "
          f"half of every MLP; batch 16 on every rank, {QUALITY_TRAIN // 16} steps an epoch, "
          f"2 epochs, then resumed from epoch 0; {topology} | {CARD}", flush=True)
    print(f"tensor-parallel run: bars: per step |loss - loss_1| <= {TP_LOSS_REL} |loss_1|; "
          f"at the steps from the same weights (before the first update) |loss - loss_1| "
          f"<= {TP_SAME_WEIGHTS_LOSS_REL} |loss_1| and |grad_norm - grad_norm_1| <= "
          f"{TP_GRAD_NORM_REL} grad_norm_1; launches of K1 to K4 on each rank equal to "
          f"world 1's; the replicated parameters bit-equal across the model group; resume "
          f"bit-equal; rank 0 alone writes; the checkpoint restored at mesh_model 1: cosine "
          f">= {TP_MIN_COSINE} of each embedding to the mesh_model-2 model's", flush=True)
    print(f"tensor-parallel probing: config/linear_probing/stenosis_config.yaml (phase 12's "
          f"step: {PROBE_CLIPS} clips, the encoder frozen at depth {MP_DEPTH}, "
          f"DEEPCORO_FUSED_OUTPROJ on), "
          f"dropout 0, mesh_model {n} on the same {n} ranks: each rank's K5 at "
          f"{TP_VIDEO_HEADS} heads with its [256, 512] rows of wo, the partial summed over "
          f"the model group; bars: head outputs |d| <= {HEAD_ATOL} + {HEAD_RTOL}|world 1|, "
          f"the first step's loss and grad_norm within {TP_LOSS_REL} of world 1's, K5 "
          f"launches per rank equal to world 1's | {CARD}", flush=True)


def phase_tp_quality_run(torch, manifest: Path, tmp: Path, world1: dict,
                         ranks: Optional[list] = None) -> dict:
    """Phase 37: ``_tp_quality_spec``'s job on 2 ranks through main
    (tensor parallelism: each rank holds half of every attention's heads
    and of every MLP's hidden width) against phase 32's world-1 run of the
    same config (``world1``); ``ranks``: the ranks' results where phase
    32's launch ran the job, else it is launched here (after ``_tp_bars``).
    Then the run's checkpoint restored at M = 1 in this process against the
    M = 2 model, and every kernel at a rank's shapes against its plain
    version. Returns the ranks' probing results too (``probe``, phase
    38's)."""
    n = TP_RANKS
    backend, topology = ring_topology(torch, n)
    steps = QUALITY_TRAIN // 16
    root = tmp / "tp_quality"
    wall = None
    if ranks is None:
        _tp_bars(torch)
        ranks, wall = _launch(n, _tp_quality_spec(manifest, tmp, world1), tmp, "tp_quality")
    first = ranks[0]
    for r, res in enumerate(ranks):
        check(res["grid"] == {"data": 1, "model": n}, f"tensor-parallel run: rank {r} grid "
              f"{res['grid']}")
    for r in ranks[1:]:
        check(r["steps"] == first["steps"], "tensor-parallel run: rank steps differ: "
              f"{r['steps']} vs {first['steps']}")
        check(r["replicated"] == first["replicated"],
              "tensor-parallel run: replicated parameters differ across the model group: "
              f"{r['replicated']} vs {first['replicated']}")
    check(first["checksums"] != ranks[1]["checksums"],
          "tensor-parallel run: the ranks hold the same parameters (nothing was cut)")
    print(f"tensor-parallel run: checksums after each epoch of the replicated parameters "
          f"{first['replicated']} (bit-equal across the {n} ranks), of each rank's whole "
          f"share {[r['checksums'][-1] for r in ranks]} (its own parts)", flush=True)

    got, one_steps = first["steps"], world1["steps"]
    check(len(got) == len(one_steps) == 2 * steps, f"steps {len(got)} / {len(one_steps)}")
    same_weights = True
    for i, (a, b) in enumerate(zip(got, one_steps)):
        dl = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        dg = abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
        held = "held" if same_weights else "after an update: not held"
        print(f"tensor-parallel run: step {i}: loss {a['loss']:.6f} (world 1 "
              f"{b['loss']:.6f}, rel {dl:.2e}), grad_norm {a['grad_norm']:.5f} (world 1 "
              f"{b['grad_norm']:.5f}, rel {dg:.2e}, {held}), alignment {a['alignment']:.5f} "
              f"({b['alignment']:.5f}), lr {a['lr']:.2e}", flush=True)
        check(math.isfinite(a["loss"]) and dl <= TP_LOSS_REL,
              f"tensor-parallel run: step {i} off the world-1 run: {a} vs {b}")
        check(not same_weights or (dl <= TP_SAME_WEIGHTS_LOSS_REL and dg <= TP_GRAD_NORM_REL),
              f"tensor-parallel run: step {i}, from the same weights, off the world-1 run: "
              f"{a} vs {b}")
        same_weights = same_weights and a["lr"] == 0.0 and b["lr"] == 0.0
    for h, w in zip(first["history"], world1["history"]):
        d = abs(h["val_loss"] - w["val_loss"]) / abs(w["val_loss"])
        check(d <= TP_LOSS_REL, f"tensor-parallel run: epoch {h['epoch']} val_loss "
              f"{h['val_loss']} vs {w['val_loss']}")
        print(f"tensor-parallel run: epoch {h['epoch']} validation loss {h['val_loss']:.6f} "
              f"(world 1 {w['val_loss']:.6f}, rel {d:.2e}), alignment "
              f"{h['val_alignment']:.5f} ({w['val_alignment']:.5f})", flush=True)

    for r, res in enumerate(ranks):
        check(all(res["counts"][k] == world1["counts"][k] for k in ("K1", "K2", "K3", "K4",
                                                                   "K5", "K6")),
              f"tensor-parallel run: rank {r} launches {res['counts']}, world 1 "
              f"{world1['counts']}")
    print(f"tensor-parallel run: launches per rank over the run "
          + ", ".join(f"{k} {first['counts'][k]}" for k in ("K1", "K2", "K3", "K4"))
          + " (each at the rank's heads), as at world 1 ("
          + ", ".join(f"{k} {world1['counts'][k]}" for k in ("K1", "K2", "K3", "K4"))
          + ")", flush=True)

    run = Path(first["output_dir"])
    runs = sorted(p.parent for p in (root / "full").rglob("checkpoints"))
    check(runs == [run], f"tensor-parallel run: run directories {runs}")
    for r, res in enumerate(ranks):
        check(bool(res["written"]) == (r == 0),
              f"tensor-parallel run: rank {r} wrote {res['written'][:5]}")
    res_h = first["resumed"]["history"]
    check([h["epoch"] for h in res_h] == [1] and res_h[0]["loss"] == first["history"][1]["loss"]
          and all(r["resumed"]["checksums"][-1:] == r["checksums"][-1:] for r in ranks),
          f"tensor-parallel run: resumed {res_h} vs {first['history'][1]}, checksums "
          f"{[r['resumed']['checksums'] for r in ranks]} vs {[r['checksums'] for r in ranks]}")
    print(f"tensor-parallel run: one run directory, written by rank 0 alone; resumed from "
          f"epoch 0: epoch-1 loss {res_h[0]['loss']!r} (uninterrupted "
          f"{first['history'][1]['loss']!r}), each rank's parameters bit-equal to its "
          f"uninterrupted run's", flush=True)

    # the whole tree in the file: it restores at mesh_model 1, here
    saved = torch.load(run / "checkpoints" / "checkpoint.pt", weights_only=True)
    qkv = saved["params"]["video_encoder.backbone.block0.attn.qkv.weight"]
    mu = saved["opt_state"]["mu"]["text_encoder.layer0.intermediate.weight"]
    check(tuple(qkv.shape) == (3 * 512, 512) and tuple(mu.shape) == (3072, 768),
          f"tensor-parallel run: the checkpoint holds qkv {tuple(qkv.shape)}, a moment of "
          f"intermediate {tuple(mu.shape)}: not the whole tree")
    del saved
    cfg_one = _quality_ddp_config(str(manifest), str(root / "restore"), **world1["stats"])
    one = _tp_embeddings(torch, cfg_one, run / "checkpoints")
    cos = []
    for r, res in enumerate(ranks):
        a, b = torch.tensor(res["embeddings"]), torch.tensor(one)
        for part in (slice(0, 512), slice(512, 1024)):
            cos += torch.nn.functional.cosine_similarity(a[:, part], b[:, part], dim=1).tolist()
    check(min(cos) >= TP_MIN_COSINE, f"tensor-parallel run: the checkpoint at mesh_model 1 "
          f"against the mesh_model-2 model: cosines {cos}")
    print(f"tensor-parallel run: the checkpoint holds the whole tree (qkv "
          f"{tuple(qkv.shape)}, Adam moments whole); restored at mesh_model 1 in this "
          f"process, its {TP_EMBED_ROWS} video and text embeddings against the mesh_model-2 "
          f"model's on each rank: min cosine {min(cos):.7f}", flush=True)

    # each kernel at a rank's shapes against its plain version, timed
    k1_rows, k2_rows = _tp_packed_rows(torch, "tensor-parallel kernels", 16, TP_VIDEO_HEADS)
    tmask = torch.from_numpy(_tp_embed_batch(cfg_one)["attention_mask"]).cuda()
    tmask = tmask.repeat(4, 1)  # 16 reports of the run's lengths
    k3_rows, k4_rows = _attention_rows(torch, "tensor-parallel kernels", (
        ("the text tower at a rank's 6 of 12 heads, the batch's padding mask", 16,
         TP_TEXT_HEADS, 128, 128, tmask.to(torch.int32), False),), seed=37)
    vmask = torch.ones(16, 1, dtype=torch.bool, device="cuda")
    _, _, agg_f, agg_b = _aggregator_attention(torch, vmask, label="tensor-parallel kernels",
                                               H=TP_AGG_HEADS, timed=True)
    k3_rows.append(agg_f)
    k4_rows.append(agg_b)

    h, h1 = first["history"][1], world1["history"][1]
    times = {"ranks": n, "backend": backend,
             "step_ms": h["epoch_seconds"] * 1e3 / steps,
             "world1_step_ms": h1["epoch_seconds"] * 1e3 / steps,
             "peak_gib": [r["peak_gib"] for r in ranks], "world1_peak_gib": world1["peak_gib"],
             "model_all_reduce": [r["model_all_reduce"] for r in ranks], "launch_s": wall}
    print(f"tensor-parallel run: step {times['step_ms']:.1f} ms (host clock, epoch 1 over "
          f"{steps} steps), world 1 {times['world1_step_ms']:.1f} ms; peak memory per rank "
          + ", ".join(f"{g:.2f}" for g in times["peak_gib"])
          + f" GiB, world 1 {world1['peak_gib']:.2f} GiB (torch.cuda.max_memory_allocated) "
          f"| {topology} | {CARD}", flush=True)
    for r, m in enumerate(times["model_all_reduce"]):
        print(f"tensor-parallel run: rank {r}, the run's last step: the model group's "
              f"all-reduces {m['calls']} calls, {m['bytes'] / 2 ** 30:.3f} GiB, {m['ms']:.1f} ms "
              f"host time (each synchronised before and after) in a step of {m['step_ms']:.1f} "
              f"ms (synchronised) | {topology} | {CARD}", flush=True)
    if wall is not None:
        print(f"tensor-parallel run: torch.distributed.run launch {wall:.1f} s (the run, its "
              f"resumption, the embeddings and phase 38's probing step; process start and "
              f"set-up included)", flush=True)
    return {"counts": first["counts"], "times": times,
            "rows": {"K1": k1_rows, "K2": k2_rows, "K3": k3_rows, "K4": k4_rows},
            "probe": [r["probe"] for r in ranks]}


def _tp_probe_step(torch, cfg) -> dict:
    """The probing bundle of ``cfg`` (K5 on: the output projection fused into
    the attention kernel; on the grid ``cfg`` asks for): the eval step's
    head outputs on the seeded batch, then one warm and TP_PROBE_STEPS timed
    train steps, with the launches of each and the model group's
    all-reduces in one more step."""
    from deepcoro_clip_tpu_torch.parallel import distributed
    from deepcoro_clip_tpu_torch.train.linear_probe import (
        build_probe_bundle,
        make_probe_eval_step,
        make_probe_train_step,
        to_device_batch,
    )

    bundle, state = build_probe_bundle(cfg, seed=0, steps_per_epoch=1, device=cfg.device,
                                       fused_outproj=True)
    batch = to_device_batch(bundle, probe_batch(cfg, cfg.batch_size))
    step_fn, eval_fn = make_probe_train_step(bundle), make_probe_eval_step(bundle)
    ratio = cfg.video_freeze_ratio
    torch.cuda.reset_peak_memory_stats()
    _zero_kernel_counts()
    out = eval_fn(state.params, batch)
    eval_counts = _kernel_counts()
    outputs = {h: o.float().cpu().tolist() for h, o in out["outputs"].items()}
    state, m = step_fn(state, batch, None, ratio)
    first = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    _zero_kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TP_PROBE_STEPS):
        state, m = step_fn(state, batch, None, ratio)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TP_PROBE_STEPS
    counts = _kernel_counts()
    reduce = {"calls": 0, "ms": 0.0, "bytes": 0, "step_ms": 0.0}
    if distributed.is_active():
        rec, undo = _model_reduce_timer(torch)
        t0 = time.perf_counter()
        try:
            state, m = step_fn(state, batch, None, ratio)
            torch.cuda.synchronize()
        finally:
            undo()
        reduce = dict(rec, step_ms=(time.perf_counter() - t0) * 1e3)
    res = {"outputs": outputs, "eval_counts": eval_counts, "counts": counts,
           "step_ms": step_ms, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "model_all_reduce": reduce, **first}
    del bundle, state, batch
    torch.cuda.empty_cache()
    return res


def _tp_k5_rows(torch) -> list:
    """K5 at a rank's share of the probing path: the fused qkv of its 2 heads
    ``[80, L, 768]`` with RoPE and its rows ``[256, 512]`` of wo, against the
    plain version (phase 11's bars), timed with its bound; and the two
    ranks' partial products, summed in fp32, against K5 over all 4 heads and
    the whole wo (the same bars)."""
    import torch.nn.functional as F

    from deepcoro_clip_tpu_torch.ops.attention import (
        apply_rope,
        multi_head_attention,
        project_plain,
    )
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(38)
    rows = []
    B, H, Dout, Dh = PROBE_CLIPS, TP_VIDEO_HEADS, 512, 128
    D = H * Dh
    with torch.no_grad():
        for T, HW in ((8, 14), (8, 7)):
            t = build_rope3d_tables(128, T, HW, HW, n_special=1)
            kw = dict(sin=torch.from_numpy(t.sin).to(dev), cos=torch.from_numpy(t.cos).to(dev))
            L = kw["sin"].shape[0]
            # the whole layer: 4 heads, wo [512, 512]; rank r holds heads 2r, 2r+1
            qkv_all = torch.randn(B, L, 3 * 2 * D, generator=g, device=dev).to(torch.bfloat16)
            wo_all = (torch.randn(2 * D, Dout, generator=g, device=dev)
                      * (2 * D) ** -0.5).to(torch.bfloat16)
            q, k, v = qkv_all.split(2 * D, -1)
            parts = []
            for r in range(2):
                cols = slice(r * D, (r + 1) * D)
                qkv = torch.cat([q[..., cols], k[..., cols], v[..., cols]], -1).contiguous()
                wo = wo_all[cols].contiguous()
                parts.append(flash_attention_packed(qkv=qkv, num_heads=H, wo=wo, **kw))
            shape = (f"qkv [{B},{L},{3 * D}] bf16, H {H}, Dh 128, wo [{D},{Dout}] (a rank's "
                     "heads and rows), RoPE")
            heads = [_to_heads(u, H) for u in qkv.split(D, -1)]

            def fused():
                return flash_attention_packed(qkv=qkv, num_heads=H, wo=wo, **kw)

            def plain():
                out = multi_head_attention(*heads, **kw)
                return project_plain(out.transpose(1, 2).flatten(2), wo)

            sq = [apply_rope(heads[0], **kw), apply_rope(heads[1], **kw), heads[2]]
            w_t = wo.t().contiguous()

            def library():
                return F.linear(F.scaled_dot_product_attention(*sq).transpose(1, 2).flatten(2),
                                w_t)

            err = check_forward(torch, "tensor-parallel K5", f"K5 {shape}", fused(), plain())
            whole = flash_attention_packed(qkv=qkv_all, num_heads=2 * H, wo=wo_all, **kw)
            summed = (parts[0].float() + parts[1].float()).to(torch.bfloat16)
            err_sum = check_forward(torch, "tensor-parallel K5",
                                    f"the 2 ranks' partials summed vs K5 over qkv "
                                    f"[{B},{L},{6 * D}] and wo [{2 * D},{Dout}]", summed, whole)
            flops = 4 * B * H * L * L * Dh + 2 * B * L * D * Dout
            nbytes = (B * L * 3 * D + D * Dout + B * L * Dout) * 2 + 2 * L * Dh * 4
            b_ms, b_by = bound(flops, nbytes)
            row = {"shape": shape, "max_abs_err": max(err, err_sum),
                   "ms": cuda_ms(torch, fused, REPS),
                   "plain_ms": cuda_ms(torch, plain, max(1, REPS // 5)),
                   "library_ms": cuda_ms(torch, library, REPS),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "device_ms": device_ms(torch, fused, REPS, ("flash_fwd_proj_kernel",)),
                   "partial_sum_max_abs_err": err_sum}
            row["tflops"] = flops / row["ms"] / 1e9
            print(f"tensor-parallel K5 {shape}: kernel {row['ms']:.4f} ms "
                  f"({row['tflops']:.1f} TFLOP/s), plain {row['plain_ms']:.4f} ms, sdpa + "
                  f"F.linear {row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); card "
                  f"busy {row['device_ms']:.4f} ms | {CARD}", flush=True)
            rows.append(row)
            del qkv_all, wo_all, q, k, v, parts, qkv, wo, heads, sq, whole, summed
            torch.cuda.empty_cache()
    return rows


def phase_tp_probe(torch, ranks: list) -> dict:
    """Phase 38: the probing step of phases 12 to 15
    (config/linear_probing/stenosis_config.yaml at full width, K5 on,
    dropout 0) with mesh_model 2 on phase 37's 2 ranks (``ranks``: their
    results) against the same step at world 1 in this process: each rank
    launches K5 at its 2 heads with its rows of wo, and the head outputs,
    summed over the model group, match world 1's."""
    n = TP_RANKS
    backend, topology = ring_topology(torch, n)
    rows = _tp_k5_rows(torch)
    cfg = probe_config(dropout=0.0, dropout_attention=0.0, vit_depth=MP_DEPTH)
    one = _tp_probe_step(torch, cfg)
    for r, res in enumerate(ranks):
        check(res["grid"] == {"data": 1, "model": n}, f"tensor-parallel probing: rank {r} "
              f"grid {res['grid']}")
        check(res["eval_counts"] == one["eval_counts"] and res["counts"] == one["counts"]
              and res["counts"]["K5"] == MP_DEPTH * TP_PROBE_STEPS,
              f"tensor-parallel probing: rank {r} launches {res['eval_counts']} / "
              f"{res['counts']}, world 1 {one['eval_counts']} / {one['counts']}")
        worst = 0.0
        for h, ref in one["outputs"].items():
            a, b = torch.tensor(res["outputs"][h]), torch.tensor(ref)
            d = (a - b).abs()
            check(bool((d <= HEAD_ATOL + HEAD_RTOL * b.abs()).all()),
                  f"tensor-parallel probing: rank {r} head {h} {a.tolist()} vs world 1 "
                  f"{b.tolist()}")
            worst = max(worst, float(d.max()))
        for key in ("loss", "grad_norm"):
            d = abs(res[key] - one[key]) / abs(one[key])
            check(d <= TP_LOSS_REL, f"tensor-parallel probing: rank {r} {key} {res[key]} vs "
                  f"world 1 {one[key]}")
        print(f"tensor-parallel probing: rank {r}: head outputs max|d| {worst:.3e} from "
              f"world 1's; first step loss {res['loss']:.6f} (world 1 {one['loss']:.6f}), "
              f"grad_norm {res['grad_norm']:.5f} ({one['grad_norm']:.5f}); launches: eval "
              f"K5 {res['eval_counts']['K5']}, K3 {res['eval_counts']['K3']}, over "
              f"{TP_PROBE_STEPS} steps K5 {res['counts']['K5']}, K3 {res['counts']['K3']}, K4 "
              f"{res['counts']['K4']} (world 1 the same)", flush=True)
    times = {"ranks": n, "backend": backend,
             "step_ms": [r["step_ms"] for r in ranks], "world1_step_ms": one["step_ms"],
             "peak_gib": [r["peak_gib"] for r in ranks], "world1_peak_gib": one["peak_gib"],
             "model_all_reduce": [r["model_all_reduce"] for r in ranks]}
    print(f"tensor-parallel probing: step "
          + ", ".join(f"{s:.1f}" for s in times["step_ms"])
          + f" ms a rank (host clock, synchronised, {TP_PROBE_STEPS} steps), world 1 "
          f"{one['step_ms']:.1f} ms; peak memory per rank "
          + ", ".join(f"{g:.2f}" for g in times["peak_gib"])
          + f" GiB, world 1 {one['peak_gib']:.2f} GiB | {topology} | {CARD}", flush=True)
    for r, m in enumerate(times["model_all_reduce"]):
        print(f"tensor-parallel probing: rank {r}: the model group's all-reduces in a step: "
              f"{m['calls']} calls, {m['bytes'] / 2 ** 20:.1f} MiB, {m['ms']:.1f} ms host time "
              f"(synchronised, in a step of {m['step_ms']:.1f} ms) | {topology} | {CARD}",
              flush=True)
    return {"counts": ranks[0]["counts"], "eval_counts": ranks[0]["eval_counts"],
            "times": times, "rows": rows}


# --------------------------------------------------------------------------- #
# phases 39 to 41: the attention kernels at every precision and head width
# the JAX wrappers take: the CUDA-core kernels (fp32 K1, K2, K5, K6 and bf16
# at Dh 256 to 512; the fp32 forward at Dh 64 / 128 register-tiled), the
# padded K3/K4 head dims, and precision fp32 through main

# fp32 gradients against flash_bwd_plain in fp32 on the card, per tensor:
# max|kernel - plain| <= F32_BWD_REL max|plain| and ||kernel - plain|| <=
# F32_BWD_L2 ||plain||: nothing is rounded below fp32, but a gradient sums
# up to 1569 products a row in another order than the plain matrix products
# (about sqrt(1569) * 2^-24 relative a sum), so an elementwise bar at the
# forward's F32_ATOL would read the sums' size, not the kernel
F32_BWD_REL = 1e-4
F32_BWD_L2 = 1e-5
# fused projection, fp32 (K5 SIMT vs attention then @ wo in fp32): the
# product sums 512 more terms a row, |d| <= F32_PROJ_ATOL + F32_PROJ_RTOL|ref|
F32_PROJ_ATOL = 2e-5
F32_PROJ_RTOL = 2e-5
# phase 41: the fp32 probing heads through K5 against the plain attention's,
# |d| <= FP32_HEAD_ATOL + FP32_HEAD_RTOL |plain| (fp32 throughout: the runs
# read 1.9e-6; HEAD_ATOL, phase 13's bf16 bar, would pass a K5 in TF32)
FP32_HEAD_ATOL = 1e-5
FP32_HEAD_RTOL = 1e-5
# timed launches of a SIMT kernel (tens of ms a call at the video tower's
# shapes in fp32: REPS would take a while)
SIMT_REPS = 5
# phase 40: the fp32 quality run through main with the kernels against the
# same run with the plain attention, from the same seed at dropout 0: per
# step |loss - loss_plain| <= FP32_RUN_LOSS_REL |loss_plain| (both fp32: the
# two attentions' sums differ in order only, and Adam carries that rounding
# from one step to the next); the validation loss by the same bar
FP32_RUN_LOSS_REL = 1e-4
# launches per train step, validation batch and bank chunk of the fp32 run:
# K1 / K2 on the SIMT fp32 kernels in the 12 video blocks, K3 / K4 on them
# in the 12 text layers (none long: the long kernels are bf16's) and the
# short fp32 kernels in the aggregator's 2 blocks
FP32_PER_STEP = {"K1": 12, "K2": 12, "K3": 14, "K4": 14, "K5": 0, "K6": 0,
                 "K3 long": 0, "K4 long": 0}
FP32_PER_EVAL = {"K1": 12, "K2": 0, "K3": 14, "K4": 0, "K5": 0, "K6": 0,
                 "K3 long": 0, "K4 long": 0}
FP32_PER_BANK = {"K1": 0, "K2": 0, "K3": 12, "K4": 0, "K5": 0, "K6": 0,
                 "K3 long": 0, "K4 long": 0}
# (bf16 at Dh 256 to 512: the wide Hopper kernels of csrc/flash_fwd.cu,
# csrc/flash_fwd_proj.cu and csrc/flash_bwd.cu, which took the SIMT kernels'
# place; WIDE_OLD names those SIMT kernels, the forward's, K5's and the
# backward's pre-pass and pair: an older tree's, --wide-rows' and
# --wide-bwd-rows' A runs, and what no trace of this tree may show)
SIMT_FWD = {"float32": ("flash_fwd_f32_kernel",), "bfloat16": ("flash_fwd_wide_sm90_kernel",)}
SIMT_BWD = {"float32": ("bwd_rows_f32_kernel", "flash_bwd_dkv_f32_kernel",
                        "flash_bwd_dq_f32_kernel"),
            "bfloat16": ("bwd_rows_kernel", "flash_bwd_dkv_wide_sm90_kernel",
                         "flash_bwd_dq_wide_sm90_kernel")}
SIMT_PROJ = {"float32": ("flash_fwd_proj_f32_kernel",),
             "bfloat16": ("flash_fwd_proj_wide_sm90_kernel",)}
WIDE_OLD = ("flash_fwd_wide_bf16_kernel", "flash_fwd_proj_wide_bf16_kernel",
            "bwd_rows_wide_bf16_kernel", "flash_bwd_dkv_wide_bf16_kernel",
            "flash_bwd_dq_wide_bf16_kernel")
WIDE_OLD_BWD = WIDE_OLD[2:]
# fp32 at Dh 64 and 128 (K1, K3) and K5 at Dh 128: the register-tiled
# kernels of csrc/fwd_f32_regtile.cuh (the SIMT names above serve the wider
# heads; neither name is a substring of the other)
REGTILE_FWD = ("flash_fwd_f32_regtile_kernel",)
REGTILE_PROJ = ("flash_fwd_proj_f32_regtile_kernel",)
# fp32 at Dh 64 and 128 (K2, K4): the register-tiled dK/dV and dQ kernels of
# csrc/bwd_f32_regtile.cuh after the SIMT row pre-pass F32_ROWS (the SIMT
# dK/dV and dQ names above serve the wider heads; no name of the two is a
# substring of another)
REGTILE_BWD = ("flash_bwd_dkv_f32_regtile_kernel", "flash_bwd_dq_f32_regtile_kernel")
F32_ROWS = ("bwd_rows_f32_kernel",)


def fwd_names(dtype, Dh: int) -> tuple:
    """The forward kernel a tile call (past the short lengths) runs at
    ``dtype`` and ``Dh``, as the trace lookups name it."""
    if str(dtype) == "torch.float32" and Dh <= 128:
        return REGTILE_FWD
    return SIMT_FWD[str(dtype).split(".")[1]]


def bwd_names(dtype, Dh: int) -> tuple:
    """The backward kernels a tile call (past the short lengths) runs at
    ``dtype`` and ``Dh``: the row pre-pass, then the dK/dV and dQ kernels."""
    if str(dtype) == "torch.float32" and Dh <= 128:
        return F32_ROWS + REGTILE_BWD
    return SIMT_BWD[str(dtype).split(".")[1]]


def proj_names(dtype, Dh: int) -> tuple:
    """The same for K5 off the bf16 Hopper kernel."""
    if str(dtype) == "torch.float32" and Dh == 128:
        return REGTILE_PROJ
    return SIMT_PROJ[str(dtype).split(".")[1]]


def _f32_check(name: str, which: str, a, r, grad: bool) -> float:
    """An fp32 output against its plain version: the forward by F32_ATOL +
    F32_RTOL|plain| elementwise, a gradient by F32_BWD_REL and F32_BWD_L2;
    returns max|kernel - plain|."""
    import torch

    a, r = a.float(), r.float()
    d = (a - r).abs()
    err, top = float(d.max()), float(r.abs().max())
    if grad:
        l2 = float(torch.linalg.vector_norm(a - r) / torch.linalg.vector_norm(r).clamp_min(1e-30))
        ok = err <= F32_BWD_REL * top and (l2 <= F32_BWD_L2 or top == 0.0)
    else:
        ok = bool((d <= F32_ATOL + F32_RTOL * r.abs()).all())
    check(bool(torch.isfinite(a).all()) and ok,
          f"{name}: {which} disagrees with the plain version in fp32 (max|d| {err:.3e}, "
          f"max|plain| {top:.3e})")
    return err


def _float_leaves(tree):
    """The floating-point tensors of a checkpoint's tree, depth first."""
    import torch

    if isinstance(tree, dict):
        for v in tree.values():
            yield from _float_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _float_leaves(v)
    elif torch.is_tensor(tree) and tree.is_floating_point():
        yield tree


def _simt_row(torch, label: str, shape: str, fn, plain, lib, flops: float, nbytes: float,
              fp32: bool, kernels, err: float, busy: bool = False) -> dict:
    """Times of one call (CUDA events over SIMT_REPS after 3 warm-up calls,
    the plain version once, the library call) and its bound (fp32: the
    card's 67 TFLOP/s outside the tensor cores, no TF32; bf16: 989). No
    profiler window (a call of milliseconds reads the same between events,
    and which kernels ran is phase 40's trace's and the counters' to show),
    but with ``busy`` (``--fp32-rows``' backward rows, whose host enqueue can
    outlast the card's work) also the card's busy time a call."""
    b_ms, b_by = bound(flops, nbytes, PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS)
    row = {"shape": shape, "max_abs_err": err, "ms": cuda_ms(torch, fn, SIMT_REPS),
           "plain_ms": cuda_ms(torch, plain, 1),
           "library_ms": None if lib is None else cuda_ms(torch, lib, SIMT_REPS),
           "bound_ms": b_ms, "bound_by": b_by, "kernels": list(kernels)}
    row["tflops"] = flops / row["ms"] / 1e9
    busy_s = ""
    if busy:
        row["busy_ms"] = device_ms(torch, fn, SIMT_REPS, kernels)
        busy_s = f" (busy {row['busy_ms']:.4f} ms)"
    lib_s = "none" if lib is None else f"{row['library_ms']:.4f} ms"
    print(f"{label}: {shape}: kernel {row['ms']:.4f} ms{busy_s} ({row['tflops']:.2f} TFLOP/s; "
          f"{', '.join(kernels)}), plain {row['plain_ms']:.4f} ms, library {lib_s}, bound "
          f"{b_ms:.4f} ms ({b_by}) | {CARD}", flush=True)
    return row


def call_split(torch, label: str, fn, kernels, host_parts: dict, reps: int = SIMT_REPS) -> dict:
    """Where a call's time between CUDA events goes: the host's time a call
    to issue it (``reps`` calls back to back, timed before the final
    synchronise: the card keeps up whenever it is busy for less), that of
    each of ``host_parts`` (name: a part of the call, issued alone), and the
    card's busy time a call, split into ``kernels`` and the rest (copies,
    fills) from one trace of ``reps`` calls. Between events the card idles
    for the rest."""
    def host_ms(f):
        for _ in range(3):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        return ms

    out = {"host_ms": host_ms(fn), "host_parts_ms": {k: host_ms(f) for k, f in host_parts.items()}}
    per_name, _ = device_events(torch, lambda: [fn() for _ in range(reps)])
    mine = [n for n in per_name if any(k in n for k in kernels)]
    out["kernel_ms"] = sum(per_name[n] for n in mine) / reps
    out["other_ms"] = sum(ms for n, ms in per_name.items() if n not in mine) / reps
    out["other"] = {_short_name(n)[:60]: ms / reps for n, ms in per_name.items() if n not in mine}
    parts = ", ".join(f"{k} {v:.4f}" for k, v in out["host_parts_ms"].items())
    print(f"{label}: split of a call: host {out['host_ms']:.4f} ms to issue it ({parts}); card "
          f"busy {out['kernel_ms']:.4f} ms in {', '.join(kernels)}, {out['other_ms']:.4f} ms in "
          f"{len(out['other'])} other kernels ({', '.join(out['other'])}) | {CARD}", flush=True)
    return out


def _packed_simt_rows(torch, dtype, B, H, Dh, L, split=False, busy=False,
                      busy_fwd=False, fwd_only=False) -> tuple:
    """K1 and K2 on the SIMT kernels (bf16 K1 at Dh 256 to 512 on the wide
    Hopper kernel) at a packed shape: ``qkv`` ``[B, L, 3*H*Dh]`` with the
    video tower's 3D RoPE (fused, or ``split`` into three tensors), against
    their plain versions (fp32: ``_f32_check``'s bars; bf16: phase 3's and
    7's), with times and bounds (``busy``, ``busy_fwd``: K2's, K1's busy
    time too; ``fwd_only``: K1 alone). Returns (K1 row, K2 row or None)."""
    import torch.nn.functional as F

    from deepcoro_clip_tpu_torch.ops.attention import (
        apply_rope,
        flash_bwd_plain,
        multi_head_attention,
    )
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(39 + Dh + L)
    fp32 = dtype == torch.float32
    name = "fp32" if fp32 else "bf16"
    hw = {1569: 14, 393: 7}[L]
    t = build_rope3d_tables(Dh, 8, hw, hw, n_special=1)
    sin, cos = torch.from_numpy(t.sin).to(dev), torch.from_numpy(t.cos).to(dev)
    D = H * Dh
    wide = not fp32 and Dh > 128
    x = torch.randn(B, L, 3 * D, generator=g, device=dev) * 0.5
    if wide:
        x[..., :2 * D] *= WIDE_QK_SCALE
    qkv = x.to(dtype)
    do = (torch.randn(B, L, D, generator=g, device=dev) * 0.5).to(dtype)
    del x
    heads = [_to_heads(u, H) for u in qkv.split(D, -1)]
    rope = dict(sin=sin, cos=cos)
    shape = (f"{'q, k, v' if split else 'qkv'} [{B},{L},{3 * D if not split else D}] "
             f"{name}, H {H}, Dh {Dh}, RoPE")
    leaves = ([u.clone().requires_grad_() for u in qkv.split(D, -1)] if split
              else [qkv.clone().requires_grad_()])

    def call(args):
        return (flash_attention_packed(*args, num_heads=H, **rope) if split
                else flash_attention_packed(qkv=args[0], num_heads=H, **rope))

    plain_args = [u.contiguous() for u in qkv.split(D, -1)] if split else [qkv]
    with torch.no_grad():
        ref = multi_head_attention(*heads, **rope)
        got = _to_heads(call(plain_args), H)
        wrong = (multi_head_attention(misrotated(heads[0], sin, cos),
                                      misrotated(heads[1], sin, cos), heads[2])
                 if wide else None)
    err_f = (_f32_check(f"K1 {shape}", "out", got, ref, False) if fp32
             else check_wide(torch, "simt check", f"K1 {shape}", got, ref, wrong) if wide
             else check_forward(torch, "simt check", f"K1 {shape}", got, ref))
    del wrong
    esz = qkv.element_size()
    tables = 2 * L * Dh * 4
    sq = [apply_rope(heads[0], sin, cos), apply_rope(heads[1], sin, cos), heads[2]]
    with torch.no_grad():
        row_f = _simt_row(torch, "simt times K1", shape, lambda: call(plain_args),
                          lambda: multi_head_attention(*heads, **rope),
                          lambda: F.scaled_dot_product_attention(*sq),
                          4 * B * H * L * L * Dh, 4 * B * L * D * esz + tables, fp32,
                          fwd_names(dtype, Dh), err_f, busy_fwd)
    if fwd_only:
        del qkv, do, heads, leaves, sq, ref, got
        torch.cuda.empty_cache()
        return row_f, None
    out = call(leaves)
    grads = torch.autograd.grad(out, leaves, do, retain_graph=True)
    grads = list(grads[0].split(D, -1)) if not split else list(grads)
    want = flash_bwd_plain(*heads, _to_heads(do, H), ref, **rope)
    err_b = max((_f32_check(f"K2 {shape}", w, _to_heads(a, H), r, True) if fp32
                 else _rel_check(f"K2 {shape}", w, _to_heads(a, H), r))
                for w, a, r in zip(("dq", "dk", "dv"), grads, want))
    bars = (f"fp32: forward {F32_ATOL}+{F32_RTOL}|plain|, gradients {F32_BWD_REL} max|plain|, "
            f"rel l2 {F32_BWD_L2}" if fp32 else
            f"bf16: phase 3's {KERNEL_ATOL}+{KERNEL_RTOL}|plain|, phase 7's {BWD_MAX_REL} "
            f"max|plain| and rel l2 {BWD_L2_REL}")
    print(f"simt check: K1/K2 {shape}: max|kernel-plain| forward {err_f:.3e}, gradients "
          f"{err_b:.3e} ({bars}) ok", flush=True)
    sl = [u.detach().clone().requires_grad_() for u in sq]
    sout = F.scaled_dot_product_attention(*sl)
    doh, outh = _to_heads(do, H), _to_heads(out.detach(), H)
    row_b = _simt_row(torch, "simt times K2", shape,
                      lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                      lambda: flash_bwd_plain(*heads, doh, outh, **rope),
                      lambda: torch.autograd.grad(sout, sl, doh, retain_graph=True),
                      10 * B * H * L * L * Dh, 8 * B * L * D * esz + tables, fp32,
                      bwd_names(dtype, Dh), err_b, busy)
    del qkv, do, heads, leaves, out, grads, want, sq, sl, sout, ref, got
    torch.cuda.empty_cache()
    return row_f, row_b


def _padded_rows(torch, dtype, B, H, L, Dh, rope: bool, what: str = "", busy=False,
                 busy_fwd=False) -> tuple:
    """K3 and K4 at ``[B, H, L, Dh]``: a head dim no kernel is built for is
    padded as the JAX wrapper pads (``pad_head_dim``) to
    ``kernel_head_dim(Dh)``; q/k/v strided views of ``[B, L, H*Dh]``, a key
    mask of the text tower's kind (a real prefix a row, at least one key),
    against the plain version at Dh. ``what`` names the main path's call
    the shape is; ``busy``, ``busy_fwd``: K4's, K3's busy time too. Returns
    (K3 row, K4 row)."""
    import torch.nn.functional as F

    from deepcoro_clip_tpu_torch.ops.attention import (
        apply_rope,
        flash_bwd_plain,
        multi_head_attention,
    )
    from deepcoro_clip_tpu_torch.ops._flash_cuda import SHORT_MAX
    from deepcoro_clip_tpu_torch.ops.flash_attention import (
        flash_attention,
        kernel_head_dim,
        pad_head_dim,
    )
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(Dh + L)
    width = kernel_head_dim(Dh)
    fp32 = dtype == torch.float32
    wide = not fp32 and width > 128
    q, k, v, do = ((torch.randn(B, L, H * Dh, generator=g, device=dev)
                    * (0.5 * WIDE_QK_SCALE if wide and i < 2 else 0.5)).to(dtype)
                   .unflatten(2, (H, Dh)).transpose(1, 2) for i in range(4))
    kw = {}
    if rope:
        t = build_rope3d_tables(Dh, 8, 7, 7, n_special=L - 392)
        kw = dict(sin=torch.from_numpy(t.sin).to(dev), cos=torch.from_numpy(t.cos).to(dev))
    lengths = torch.randint(max(1, L // 4), L + 1, (B,), generator=g, device=dev)
    mask = torch.arange(L, device=dev)[None] < lengths[:, None]
    kw["kv_mask"] = mask
    name = "fp32" if fp32 else "bf16"
    shape = (f"[{B},{H},{L},{Dh}] {name}{', RoPE' if rope else ''}{what}, a real prefix a row"
             + (f": padded to {width}" if width != Dh else ""))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    with torch.no_grad():
        ref = multi_head_attention(q, k, v, **kw)
        got = flash_attention(q, k, v, **kw)
        err_f = (_f32_check(f"K3 {shape}", "out", got, ref, False) if fp32
                 else check_wide(torch, "simt check", f"K3 {shape}", got, ref) if wide
                 else check_forward(torch, "simt check", f"K3 {shape}", got, ref))
        del got
    out = flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, do, retain_graph=True)
    want = flash_bwd_plain(q, k, v, do, ref, **kw)
    # (a short call's fp32 gradients by the forward's elementwise bar, as
    # phase 13 holds the short fp32 K4: at one key dq and dk are rounding
    # noise around 0, which a bar relative to max|plain| would read)
    err_b = max((_f32_check(f"K4 {shape}", w, a, r, L > SHORT_MAX) if fp32
                 else _rel_check(f"K4 {shape}", w, a, r))
                for w, a, r in zip(("dq", "dk", "dv"), grads, want))
    print(f"simt check: K3/K4 {shape}: max|kernel-plain| forward {err_f:.3e}, gradients "
          f"{err_b:.3e} ok", flush=True)
    if L <= SHORT_MAX and width <= 128:
        suffix = "f32" if fp32 else "bf16"
        kf, kb = (f"flash_short_fwd_{suffix}_kernel",), (f"flash_short_bwd_{suffix}_kernel",)
    elif width > 128:
        kf, kb = SIMT_FWD[str(dtype).split(".")[1]], SIMT_BWD[str(dtype).split(".")[1]]
    elif fp32:
        kf, kb = REGTILE_FWD, F32_ROWS + REGTILE_BWD
    else:
        kf = (f"flash_long_fwd_kernel<{width}>",)
        kb = (f"bwd_rows_kernel<{width}", f"flash_long_bwd_dkv_kernel<{width}>",
              f"flash_long_bwd_dq_kernel<{width}>")
    pairs = float(mask.sum()) * L * H
    esz = q.element_size()
    qd = B * H * L * Dh * esz
    sq = [apply_rope(t, kw["sin"], kw["cos"]) if rope else t for t in (q, k)] + [v]
    am = mask[:, None, None, :]
    sl = [t.detach().clone().requires_grad_() for t in sq]
    sout = F.scaled_dot_product_attention(*sl, attn_mask=am)
    with torch.no_grad():
        row_f = _simt_row(torch, "simt times K3", shape, lambda: flash_attention(q, k, v, **kw),
                          lambda: multi_head_attention(q, k, v, **kw),
                          lambda: F.scaled_dot_product_attention(*sq, attn_mask=am),
                          4 * pairs * Dh, 4 * qd, fp32, kf, err_f, busy_fwd)
        if busy_fwd and wide:  # the events hold more than the kernel: where it goes
            pw = kernel_head_dim(Dh)
            row_f["split"] = call_split(
                torch, f"simt times K3 {shape}", lambda: flash_attention(q, k, v, **kw), kf,
                {"pad_head_dim": lambda: pad_head_dim(q, k, v, kw.get("sin"), kw.get("cos"), pw)},
                REPS)
    row_b = _simt_row(torch, "simt times K4", shape,
                      lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                      lambda: flash_bwd_plain(q, k, v, do, out.detach(), **kw),
                      lambda: torch.autograd.grad(sout, sl, do, retain_graph=True),
                      10 * pairs * Dh, 8 * qd, fp32, kb, err_b, busy)
    del q, k, v, do, leaves, out, grads, want, sq, sl, sout
    torch.cuda.empty_cache()
    return row_f, row_b


def _proj_simt_row(torch, dtype, B, H, Dh, L, busy=False) -> dict:
    """K5 on the SIMT kernel (bf16 at Dh 256 to 512 on the wide Hopper
    kernel): ``qkv`` ``[B, L, 3*H*Dh]`` with 3D RoPE and ``wo`` ``[H*Dh,
    512]`` as the probing encoder calls it (no gradient), against the plain
    attention then ``wo`` (``project_plain``); ``busy``: its busy time too."""
    import torch.nn.functional as F

    from deepcoro_clip_tpu_torch.ops.attention import (
        apply_rope,
        multi_head_attention,
        project_plain,
    )
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(41 + Dh)
    fp32 = dtype == torch.float32
    hw = {1569: 14, 393: 7}[L]
    t = build_rope3d_tables(Dh, 8, hw, hw, n_special=1)
    sin, cos = torch.from_numpy(t.sin).to(dev), torch.from_numpy(t.cos).to(dev)
    D, Dout = H * Dh, 512
    wide = not fp32 and Dh > 128
    x = torch.randn(B, L, 3 * D, generator=g, device=dev) * 0.5
    if wide:
        x[..., :2 * D] *= WIDE_QK_SCALE
    qkv = x.to(dtype)
    del x
    wo = (torch.randn(D, Dout, generator=g, device=dev) * D ** -0.5).to(dtype)
    heads = [_to_heads(u, H) for u in qkv.split(D, -1)]
    name = "fp32" if fp32 else "bf16"
    shape = f"qkv [{B},{L},{3 * D}] {name}, H {H}, Dh {Dh}, RoPE, wo [{D},{Dout}]"

    def plain():
        return project_plain(multi_head_attention(*heads, sin=sin, cos=cos)
                             .transpose(1, 2).flatten(2), wo)

    with torch.no_grad():
        y = flash_attention_packed(qkv=qkv, num_heads=H, sin=sin, cos=cos, wo=wo)
        ref = plain()
        d = (y.float() - ref.float()).abs()
        if fp32:
            ok = bool((d <= F32_PROJ_ATOL + F32_PROJ_RTOL * ref.abs()).all())
            bars = f"{F32_PROJ_ATOL}+{F32_PROJ_RTOL}|plain|"
        else:
            ok = bool((d <= KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()).all())
            bars = f"{KERNEL_ATOL}+{KERNEL_RTOL}|plain|"
        err = float(d.max())
        check(ok and bool(torch.isfinite(y).all()),
              f"K5 {shape}: disagrees with its plain version (max|d| {err:.3e})")
        print(f"simt check: K5 {shape}: max|kernel-plain| {err:.3e} ({bars}) ok", flush=True)
        if wide:
            wrong = project_plain(multi_head_attention(
                misrotated(heads[0], sin, cos), misrotated(heads[1], sin, cos), heads[2])
                .transpose(1, 2).flatten(2), wo)
            check_wide(torch, "simt check", f"K5 {shape}", y, ref, wrong)
            del wrong
        sq = [apply_rope(heads[0], sin, cos), apply_rope(heads[1], sin, cos), heads[2]]
        wt = wo.t().contiguous()
        row = _simt_row(
            torch, "simt times K5", shape,
            lambda: flash_attention_packed(qkv=qkv, num_heads=H, sin=sin, cos=cos, wo=wo),
            plain, lambda: F.linear(F.scaled_dot_product_attention(*sq).transpose(1, 2)
                                    .flatten(2), wt),
            4 * B * H * L * L * Dh + 2 * B * L * D * Dout,
            (3 * B * L * D + B * L * Dout + D * Dout) * qkv.element_size() + 2 * L * Dh * 4,
            fp32, proj_names(dtype, Dh), err, busy)
    del qkv, wo, heads, y, ref, d, sq
    torch.cuda.empty_cache()
    return row


def _ring_row(torch, dtype, H: int = RING_H, Dh: int = RING_DH) -> dict:
    """K6's step over phase 16's 15680 tokens (2 batch rows) at ``H`` heads
    of ``Dh`` over 4 shards on one card, against the whole sequence's plain
    attention (phase 16's rel-l2 bar, and in fp32 the fp32 forward bar; in
    bf16 phase 3's): fp32 at ``[2,4,15680,128]`` on the SIMT step, bf16 at
    ``[2,4,15680,64]`` (the ``mma.sync`` step) and ``[2,2,15680,256]`` (the
    wide SIMT step)."""
    import torch.nn.functional as F

    from deepcoro_clip_tpu_torch.ops._ring_cuda import step_symbol
    from deepcoro_clip_tpu_torch.ops.attention import multi_head_attention
    from deepcoro_clip_tpu_torch.parallel import ring_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(39 + Dh)
    q, k, v = (torch.randn(RING_B, H, RING_L, Dh, generator=g, device=dev).to(dtype)
               for _ in range(3))
    fp32 = dtype == torch.float32
    kernel = {"deepcoro_ring_step_f32": "ring_step_f32_kernel",
              "deepcoro_ring_step_bf16": "ring_step_kernel",
              "deepcoro_ring_step_wide_bf16": "ring_step_wide_bf16_kernel"}[step_symbol(Dh, dtype)]
    mesh = ring_mesh(torch, RING_SHARDS)
    shape = (f"[{RING_B},{H},{RING_L},{Dh}] {'fp32' if fp32 else 'bf16'} over {RING_SHARDS} "
             f"shards")
    with torch.no_grad():
        _zero_kernel_counts()
        out = ring_attention(q, k, v, mesh, backend="rdma")
        launches = _kernel_counts()["K6"]
        ref = multi_head_attention(q, k, v)
        err = (_f32_check(f"K6 {shape}", "out", out, ref, False) if fp32
               else check_forward(torch, "simt check", f"K6 {shape}", out, ref))
        l2 = _rel_l2(out, ref)
        check(l2 <= RING_L2_REL, f"K6 {shape}: rel l2 {l2}")
        check(launches == RING_SHARDS ** 2, f"K6 {shape}: {launches} launches")
        print(f"simt check: K6 {shape}: max|kernel-plain| {err:.3e}, rel l2 {l2:.3e}; "
              f"{launches} launches (n x n) ok", flush=True)
        del ref
        torch.cuda.empty_cache()
        row = _simt_row(torch, "simt times K6", shape,
                        lambda: ring_attention(q, k, v, mesh, backend="rdma"),
                        lambda: multi_head_attention(q, k, v),
                        lambda: F.scaled_dot_product_attention(q, k, v),
                        4 * RING_B * H * RING_L * RING_L * Dh,
                        4 * RING_B * H * RING_L * Dh * q.element_size(), fp32, (kernel,), err)
    row["launches"] = launches
    del q, k, v, out
    torch.cuda.empty_cache()
    return row


def _regtile_routes(torch) -> dict:
    """Phase 39's traces of the register-tiled fp32 kernels by name: K1 at
    the video tower's ``[16,393,1536]`` (Dh 128, RoPE), K3 at the text
    tower's ``[16,12,128,64]`` with a key mask (Dh 64), K5 at
    ``[8,393,1536]``, ``wo`` ``[512,512]``, and the backward of the K1 and
    K3 calls (K2 at Dh 128, K4 at Dh 64): each call counts one launch on its
    entry point and runs its new kernels, not the SIMT ones (a trace that
    drops a new kernel's event is said so: the launch was counted, and the
    SIMT kernel did not run). Prints each kernel's registers and shared
    memory a block, the latter held against ``_flash_cuda.regtile_smem_bytes``
    and ``regtile_bwd_smem_bytes``."""
    from deepcoro_clip_tpu_torch.ops._flash_cuda import (
        REGTILE_KEYS,
        REGTILE_PROJ_KEYS,
        regtile_bwd_kernel_attrs,
        regtile_bwd_smem_bytes,
        regtile_kernel_attrs,
        regtile_smem_bytes,
    )
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(390)
    attrs = regtile_kernel_attrs()
    for key, a in attrs.items():
        want = regtile_smem_bytes(int(key.split()[-1]), REGTILE_PROJ_KEYS if key.startswith("K5")
                                  else REGTILE_KEYS)
        check(a["smem_bytes"] == want,
              f"{key}: {a['smem_bytes']} B of shared memory, the Python mirror says {want}")
    bwd_attrs = regtile_bwd_kernel_attrs()
    for key, a in bwd_attrs.items():
        want = regtile_bwd_smem_bytes(int(key.split()[-1]))["dQ" in key]
        check(a["smem_bytes"] == want,
              f"{key}: {a['smem_bytes']} B of shared memory, the Python mirror says {want}")
    attrs.update(bwd_attrs)
    for key, a in attrs.items():
        print(f"regtile attrs: {key}: {a['kernel']} {a['registers']} registers, "
              f"{a['smem_bytes']} B shared a block (the mirror's) | {CARD}", flush=True)
    t = build_rope3d_tables(128, 8, 7, 7, n_special=1)
    rope = dict(sin=torch.from_numpy(t.sin).to(dev), cos=torch.from_numpy(t.cos).to(dev))
    qkv = torch.randn(16, 393, 1536, generator=g, device=dev) * 0.5
    text = [torch.randn(16, 128, 768, generator=g, device=dev).unflatten(2, (12, 64))
            .transpose(1, 2) for _ in range(3)]
    tmask = torch.arange(128, device=dev)[None] < torch.randint(
        8, 129, (16, 1), generator=g, device=dev)
    wo = torch.randn(512, 512, generator=g, device=dev) * 512 ** -0.5
    qkv_leaf = qkv.clone().requires_grad_()
    text_leaves = [u.clone().requires_grad_() for u in text]
    k1_out = flash_attention_packed(qkv=qkv_leaf, num_heads=4, **rope)
    k3_out = flash_attention(*text_leaves, kv_mask=tmask)
    simt_bwd = SIMT_BWD["float32"][1:]
    cases = {
        "K1": ("regtile route K1 fp32 [16,393,1536] Dh 128", (flash_attention_packed, "launches"),
               lambda: flash_attention_packed(qkv=qkv, num_heads=4, **rope), REGTILE_FWD,
               SIMT_FWD["float32"]),
        "K3": ("regtile route K3 fp32 [16,12,128,64] + mask", (flash_attention, "launches"),
               lambda: flash_attention(*text, kv_mask=tmask), REGTILE_FWD, SIMT_FWD["float32"]),
        "K5": ("regtile route K5 fp32 [8,393,1536] wo [512,512]",
               (flash_attention_packed, "proj_launches"),
               lambda: flash_attention_packed(qkv=qkv[:8], num_heads=4, wo=wo, **rope),
               REGTILE_PROJ, SIMT_PROJ["float32"]),
        "K2": ("regtile route K2 fp32 [16,393,1536] Dh 128",
               (flash_attention_packed, "bwd_launches"),
               lambda: torch.autograd.grad(k1_out, [qkv_leaf], torch.ones_like(k1_out),
                                           retain_graph=True), REGTILE_BWD, simt_bwd),
        "K4": ("regtile route K4 fp32 [16,12,128,64] + mask", (flash_attention, "bwd_launches"),
               lambda: torch.autograd.grad(k3_out, text_leaves, torch.ones_like(k3_out),
                                           retain_graph=True), REGTILE_BWD, simt_bwd),
    }
    ran = {}
    for key, (label, (entry, counter), fn, want, not_want) in cases.items():
        n = getattr(entry, counter)
        with torch.set_grad_enabled(key in ("K2", "K4")):
            fn()
            check(getattr(entry, counter) == n + 1,
                  f"{label}: {getattr(entry, counter) - n} launches counted, expected 1")
            ran[key] = check_route(torch, label, fn, want, not_want, untraced_ok=True)
    del qkv, text, wo, qkv_leaf, text_leaves, k1_out, k3_out
    torch.cuda.empty_cache()
    return {"ran": ran, "attrs": attrs}


def phase_simt_kernels(torch) -> dict:
    """Phase 39: each SIMT route and padded head dim against its plain
    version, at the fp32 main paths' shapes and the widths the JAX wrappers
    take, with times and bounds; returns rows by key (K1 to K6)."""
    f32, bf16 = torch.float32, torch.bfloat16
    rows = {k: [] for k in ("K1", "K2", "K3", "K4", "K5", "K6")}
    for dtype, B, H, Dh, L, split in ((f32, 16, 4, 128, 1569, False),
                                      (f32, 16, 4, 128, 1569, True),
                                      (f32, 16, 4, 128, 393, False),
                                      (bf16, 16, 2, 256, 393, False),
                                      (f32, 16, 2, 256, 393, False),
                                      (bf16, 16, 1, 512, 393, False),
                                      (f32, 16, 1, 512, 393, False)):
        f, b = _packed_simt_rows(torch, dtype, B, H, Dh, L, split, busy=dtype == bf16,
                                 busy_fwd=dtype == bf16)
        rows["K1"].append(f)
        rows["K2"].append(b)
    for f, b in wide_1569_rows(torch):
        rows["K1"].append(f)
        rows["K2"].append(b)
    # (phase 40's fp32 calls first: the text tower's [16,12,128,64] on the
    # SIMT kernels, the aggregator's [16,8,1,64] on the short fp32 ones)
    for dtype, B, H, L, Dh, rope, what in (
            (f32, 16, 12, 128, 64, False, ", the text tower (phase 40)"),
            (f32, 16, 8, 1, 64, False, ", the aggregator (phase 40)"),
            (bf16, 8, 8, 393, 32, True, ""), (bf16, 8, 4, 512, 96, False, ""),
            (bf16, 8, 2, 512, 192, False, ""), (f32, 8, 2, 512, 192, False, "")):
        f, b = _padded_rows(torch, dtype, B, H, L, Dh, rope, what,
                            busy=dtype == bf16 and Dh > 128, busy_fwd=dtype == bf16 and Dh > 128)
        rows["K3"].append(f)
        rows["K4"].append(b)
    # (phase 41's fp32 calls: the probing encoder's 1569 and 393 tokens)
    rows["K5"].append(_proj_simt_row(torch, f32, PROBE_CLIPS, 4, 128, 1569))
    rows["K5"].append(_proj_simt_row(torch, f32, PROBE_CLIPS, 4, 128, 393))
    rows["K5"] += wide_k5_rows(torch)
    rows["K5"].append(_proj_simt_row(torch, f32, PROBE_CLIPS, 2, 256, 393))
    rows["K6"].append(_ring_row(torch, f32))
    # (bf16 K6 at Dh 64, which no other phase times, and on its wide step)
    rows["K6"] += [_ring_row(torch, bf16, 4, 64), _ring_row(torch, bf16, 2, 256)]
    rows["regtile"] = _regtile_routes(torch)
    rows["wide"] = _wide_routes(torch)
    return rows


def wide_1569_rows(torch, fwd_only: bool = False) -> list:
    """Phase 39's rows of K1 and K2 in bf16 at Dh 256 and 512 at the video
    tower's 1569 tokens (16 clips, H 2 and 1: phase 43's training step; the
    forward alone with ``fwd_only``: phase 42's probing step), beside the
    393-token ones above; (K1 row, K2 row or None) each, with busy times."""
    return [_packed_simt_rows(torch, torch.bfloat16, 16, H, Dh, 1569, busy=not fwd_only,
                              busy_fwd=True, fwd_only=fwd_only) for H, Dh in ((2, 256), (1, 512))]


def wide_k5_rows(torch) -> list:
    """Phase 39's rows of K5 in bf16 at Dh 256 (H 2, ``wo`` ``[512, 512]``):
    the probing step's 80 clips at 393 and 1569 tokens."""
    return [_proj_simt_row(torch, torch.bfloat16, PROBE_CLIPS, 2, 256, L, busy=True)
            for L in (393, 1569)]


def _wide_routes(torch) -> dict:
    """Phase 39's traces of the wide bf16 Hopper kernels by name: K1 at
    ``[16,393,1536]`` (Dh 256, H 2, RoPE; Dh 512, H 1), K3 at
    ``[8,2,512,192]`` with a key mask (padded to 256), K5 at
    ``[8,393,1536]`` Dh 256 H 2 and Dh 512 H 1, ``wo`` ``[512,512]``, and
    the backward of the K1 and K3 calls (K2 at Dh 256 and 512, K4 at the
    padded 256): each call counts one launch on its entry point and runs
    the new kernels, not the SIMT ones they replaced. Prints each kernel's
    registers and local (spilled) bytes a thread as the runtime reads them,
    and the backward's shared memory a block, held against
    ``_flash_cuda.wide_bwd_smem_bytes``."""
    from deepcoro_clip_tpu_torch.ops._flash_cuda import (
        wide_bwd_kernel_attrs,
        wide_bwd_smem_bytes,
        wide_kernel_attrs,
    )
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(392)
    attrs = wide_kernel_attrs()
    for key, a in attrs.items():
        print(f"wide attrs: {key}: {a['kernel']} {a['registers']} registers a thread at entry "
              f"(setmaxnreg: 232 a consumer, 40 the producer), {a['local_bytes']} B of local "
              f"memory a thread (spills) | {CARD}", flush=True)
    for key, a in wide_bwd_kernel_attrs().items():
        want = wide_bwd_smem_bytes(a["dh"])["dQ" in key]
        check(a["smem_bytes"] == want,
              f"{key}: {a['smem_bytes']} B of shared memory, the Python mirror says {want}")
        print(f"wide attrs: {key}: {a['kernel']} {a['registers']} registers a thread (two "
              f"warpgroups, no setmaxnreg), {a['local_bytes']} B of local memory a thread "
              f"(spills), {a['smem_bytes']} B shared a block (the mirror's) | {CARD}", flush=True)
        attrs[key] = a
    bf = torch.bfloat16
    qkv = {dh: (torch.randn(16, 393, 1536, generator=g, device=dev) * 0.5).to(bf)
           for dh in (256, 512)}
    rope = {}
    for dh in (256, 512):
        t = build_rope3d_tables(dh, 8, 7, 7, n_special=1)
        rope[dh] = dict(sin=torch.from_numpy(t.sin).to(dev), cos=torch.from_numpy(t.cos).to(dev))
    q3 = [(torch.randn(8, 512, 384, generator=g, device=dev) * 0.5).to(bf).unflatten(
        2, (2, 192)).transpose(1, 2) for _ in range(3)]
    m3 = torch.arange(512, device=dev)[None] < torch.randint(
        64, 513, (8, 1), generator=g, device=dev)
    wo = (torch.randn(512, 512, generator=g, device=dev) * 512 ** -0.5).to(bf)
    old_f, old_p = (WIDE_OLD[0],), (WIDE_OLD[1],)
    # the backward of a K1 and a K3 call: K2 at Dh 256 and 512, K4 padded to 256
    leaves = {dh: qkv[dh].clone().requires_grad_() for dh in (256, 512)}
    k1_out = {dh: flash_attention_packed(qkv=leaves[dh], num_heads=1024 // dh // 2, **rope[dh])
              for dh in (256, 512)}
    q3_leaves = [u.clone().requires_grad_() for u in q3]
    k3_out = flash_attention(*q3_leaves, kv_mask=m3)

    def bwd(out, inputs):
        return lambda: torch.autograd.grad(out, inputs, torch.ones_like(out), retain_graph=True)

    cases = {
        "K1 Dh 256": ("wide route K1 bf16 [16,393,1536] H 2 Dh 256, RoPE",
                      (flash_attention_packed, "launches"),
                      lambda: flash_attention_packed(qkv=qkv[256], num_heads=2, **rope[256]),
                      ("flash_fwd_wide_sm90_kernel<256>",), old_f),
        "K1 Dh 512": ("wide route K1 bf16 [16,393,1536] H 1 Dh 512, RoPE",
                      (flash_attention_packed, "launches"),
                      lambda: flash_attention_packed(qkv=qkv[512], num_heads=1, **rope[512]),
                      ("flash_fwd_wide_sm90_kernel<512>",), old_f),
        "K3": ("wide route K3 bf16 [8,2,512,192] + mask, padded to 256",
               (flash_attention, "launches"), lambda: flash_attention(*q3, kv_mask=m3),
               ("flash_fwd_wide_sm90_kernel<256>",), old_f),
        "K5 Dh 256": ("wide route K5 bf16 [8,393,1536] H 2 Dh 256, wo [512,512]",
                      (flash_attention_packed, "proj_launches"),
                      lambda: flash_attention_packed(qkv=qkv[256][:8], num_heads=2, wo=wo,
                                                     **rope[256]),
                      ("flash_fwd_proj_wide_sm90_kernel<256>",), old_p),
        "K5 Dh 512": ("wide route K5 bf16 [8,393,1536] H 1 Dh 512, wo [512,512]",
                      (flash_attention_packed, "proj_launches"),
                      lambda: flash_attention_packed(qkv=qkv[512][:8], num_heads=1, wo=wo,
                                                     **rope[512]),
                      ("flash_fwd_proj_wide_sm90_kernel<512>",), old_p),
        "K2 Dh 256": ("wide route K2 bf16 [16,393,1536] H 2 Dh 256, RoPE",
                      (flash_attention_packed, "bwd_launches"), bwd(k1_out[256], [leaves[256]]),
                      ("flash_bwd_dkv_wide_sm90_kernel<256>", "flash_bwd_dq_wide_sm90_kernel<256>"),
                      WIDE_OLD_BWD),
        "K2 Dh 512": ("wide route K2 bf16 [16,393,1536] H 1 Dh 512, RoPE",
                      (flash_attention_packed, "bwd_launches"), bwd(k1_out[512], [leaves[512]]),
                      ("flash_bwd_dkv_wide_sm90_kernel<512>", "flash_bwd_dq_wide_sm90_kernel<512>"),
                      WIDE_OLD_BWD),
        "K4": ("wide route K4 bf16 [8,2,512,192] + mask, padded to 256",
               (flash_attention, "bwd_launches"), bwd(k3_out, q3_leaves),
               ("flash_bwd_dkv_wide_sm90_kernel<256>", "flash_bwd_dq_wide_sm90_kernel<256>"),
               WIDE_OLD_BWD),
    }
    ran = {}
    for key, (label, (entry, counter), fn, want, not_want) in cases.items():
        n = getattr(entry, counter)
        with torch.set_grad_enabled(key.startswith(("K2", "K4"))):
            fn()
            check(getattr(entry, counter) == n + 1,
                  f"{label}: {getattr(entry, counter) - n} launches counted, expected 1")
            ran[key] = check_route(torch, label, fn, want, not_want, untraced_ok=True)
    del qkv, rope, q3, m3, wo, leaves, k1_out, q3_leaves, k3_out
    torch.cuda.empty_cache()
    return {"ran": ran, "attrs": attrs}


def phase_fp32_quality_run(torch, manifest: Path, stats: dict) -> dict:
    """Phase 40: config/quality/flagship_quality_train.yaml through main at
    ``precision: fp32`` (CoroViT 512/12 at Dh 128 on the fp32 K1/K2, the
    text tower 768/12 and the aggregator on the fp32 K3/K4), one epoch
    of 3 steps and its validation, against the same run with the plain
    attention from the same seed, both at dropout 0 with phase 22's dataset
    statistics; launches counted over the kernels' run; a step traced.
    Returns the launches and the times."""
    from deepcoro_clip_tpu_torch.main import main as port_main
    from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager

    steps = QUALITY_TRAIN // 16
    print(f"fp32 quality run: config/quality/flagship_quality_train.yaml with "
          f"precision=fp32, dropout 0, epochs 1 ({steps} steps of 16 clips, one validation "
          f"pass), phase 22's corpus and dataset statistics; against the same run with "
          f"use_pallas_attention=false; bars: per step |loss - loss_plain| <= "
          f"{FP32_RUN_LOSS_REL} |loss_plain|, the validation loss by the same bar, launches "
          f"per step K1 12, K2 12, K3 14, K4 14 (the fp32 kernels; no long bf16 one) | {CARD}",
          flush=True)
    runs = {}
    # the kernels run writes its checkpoints as main does (read back below);
    # the plain run, the reference, writes none: an fp32 checkpoint of the
    # towers and their moments is ~1.9 GB a file, and the machine's disk
    # budget counts every byte the script writes
    save = CheckpointManager._save
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        for name, over in (("kernels", {}), ("plain", {"use_pallas_attention": False})):
            rec = _quality_recorder(torch, 0)
            cfg = quality_train_config(
                data_filename=str(manifest), output_dir=str(tmp / name), epochs=1,
                num_workers=QUALITY_WORKERS, dropout=0.0, precision="fp32", **stats, **over)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _zero_kernel_counts()
            t0 = time.perf_counter()
            if name == "plain":
                CheckpointManager._save = lambda self, name, *a, **kw: self.dir / f"{name}.pt"
            try:
                out = port_main(config=cfg)
            finally:
                rec["undo"]()
                CheckpointManager._save = save
            runs[name] = {"history": out["history"], "wall": time.perf_counter() - t0,
                          "output_dir": Path(out["output_dir"]),
                          "counts": {**_kernel_counts(), **_long_counts()},
                          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                          "losses": [float(s["loss"]) for s in rec["steps"]]}
            print(f"fp32 quality run ({name}): main took {runs[name]['wall']:.1f} s; losses "
                  + " ".join(f"{x:.6f}" for x in runs[name]["losses"])
                  + f"; val loss {out['history'][0]['val_loss']:.6f}; peak memory "
                  f"{runs[name]['peak_gib']:.2f} GiB | {CARD}", flush=True)
        k, p = runs["kernels"], runs["plain"]
        check(len(k["losses"]) == steps == len(p["losses"]),
              f"fp32 quality run: steps {len(k['losses'])} / {len(p['losses'])}")
        for i, (a, b) in enumerate(zip(k["losses"], p["losses"])):
            check(math.isfinite(a) and abs(a - b) <= FP32_RUN_LOSS_REL * abs(b),
                  f"fp32 quality run: step {i} loss {a} vs plain {b}")
        va, vb = k["history"][0]["val_loss"], p["history"][0]["val_loss"]
        check(abs(va - vb) <= FP32_RUN_LOSS_REL * abs(vb),
              f"fp32 quality run: val loss {va} vs plain {vb}")
        want = {key: FP32_PER_STEP[key] * steps + FP32_PER_EVAL[key]
                + FP32_PER_BANK[key] * _bank_chunks(k["output_dir"], (0,))
                for key in FP32_PER_STEP}
        print(f"fp32 quality run: launches over {steps} train steps, one validation batch "
              f"and its bank: " + ", ".join(f"{key} {k['counts'][key]} (expected "
                                            f"{want[key]})" for key in want), flush=True)
        check(k["counts"] == want, f"fp32 quality run: launches {k['counts']}, expected {want}")
        check(p["counts"]["K1"] == 0 and p["counts"]["K3"] == 0,
              f"fp32 quality run: the plain run launched {p['counts']}")
        # the kernels run's checkpoint: written after its epoch, every
        # parameter and moment fp32 and finite, at step 3
        ckpt = torch.load(k["output_dir"] / "checkpoints" / "checkpoint.pt", weights_only=True)
        params = list(_float_leaves(ckpt["params"]))
        moments = list(_float_leaves(ckpt["opt_state"]))
        check(ckpt["step"] == steps and len(params) == len(ckpt["params"])
              and len(moments) >= len(params)
              and all(t.dtype == torch.float32 and bool(torch.isfinite(t).all())
                      for t in params + moments),
              f"fp32 quality run: checkpoint at step {ckpt['step']}, {len(params)} float "
              f"parameters of {len(ckpt['params'])}, {len(moments)} moments, dtypes "
              f"{sorted({str(t.dtype) for t in params + moments})}")
        written = sorted(x.name for x in (k["output_dir"] / "checkpoints").glob("*.pt"))
        print(f"fp32 quality run: the kernels run wrote {written}; checkpoint.pt read back: "
              f"step {ckpt['step']}, {len(params)} parameters and {len(moments)} optimizer "
              f"moments, every one fp32 and finite", flush=True)
        del ckpt, params, moments
        print(f"fp32 quality run: per-step loss max |d| "
              f"{max(abs(a - b) for a, b in zip(k['losses'], p['losses'])):.3e}, val loss "
              f"|d| {abs(va - vb):.3e} (bar {FP32_RUN_LOSS_REL} relative) ok", flush=True)

        step = _fp32_quality_step(torch, manifest, stats, tmp / "trace")
    times = {**step, "peak_gib": k["peak_gib"],
             "plain_peak_gib": p["peak_gib"], "run_s": k["wall"], "plain_run_s": p["wall"],
             "epoch_seconds": k["history"][0]["epoch_seconds"],
             "plain_epoch_seconds": p["history"][0]["epoch_seconds"],
             "max_loss_abs_diff": max(abs(a - b) for a, b in zip(k["losses"], p["losses"]))}
    print(f"fp32 quality run: epoch {times['epoch_seconds']:.2f} s against the plain "
          f"attention's {times['plain_epoch_seconds']:.2f} s; peak memory "
          f"{k['peak_gib']:.2f} GiB (plain {p['peak_gib']:.2f}) | {CARD}", flush=True)
    return {"counts": k["counts"], "times": times}


def _fp32_quality_step(torch, manifest: Path, stats: dict, out_dir: Path) -> dict:
    """Phase 40's traced step: flagship_quality_train.yaml at ``precision:
    fp32`` on one batch of the corpus (``stats``: the dataset statistics,
    or {} for the runner to compute them), a warm step, two on the host
    clock, one traced: the busy time and share, the fp32 attention's part,
    the forward's (K1 and K3, REGTILE_FWD) and the backward's (K2 and K4,
    F32_ROWS + REGTILE_BWD) by name, and the backward's busy time a call."""
    from deepcoro_clip_tpu_torch.runners.common import batch_to_device
    from deepcoro_clip_tpu_torch.runners.contrastive import VideoContrastiveLearningRunner

    cfg = quality_train_config(data_filename=str(manifest), output_dir=str(out_dir),
                               epochs=1, num_workers=QUALITY_WORKERS, dropout=0.0,
                               precision="fp32", **stats)
    runner = VideoContrastiveLearningRunner(cfg, output_dir=out_dir)
    batch = batch_to_device(next(iter(runner.loaders["train"])), runner.device)
    args = (batch, runner.generator, 0.0, 0.0, -1.0)
    runner.train_step(runner.state, *args)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        runner.train_step(runner.state, *args)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 2
    # a step's forward: K1 in the 12 video blocks, K3 in the 12 text layers
    # (the aggregator's 2 K3 run the short kernel)
    per_name, wall_ms = device_events(torch, lambda: runner.train_step(runner.state, *args),
                                      expect={REGTILE_FWD[0]: 24, REGTILE_BWD[0]: 24,
                                              REGTILE_BWD[1]: 24})
    print_profile("fp32 quality profile", "one step at precision fp32", per_name, wall_ms,
                  top=12)
    check_main_path_kernels(
        "fp32 quality profile, the video tower's K1/K2 and the text tower's K3/K4", per_name,
        REGTILE_FWD + F32_ROWS + REGTILE_BWD
        + ("flash_short_fwd_f32_kernel", "flash_short_bwd_f32_kernel"),
        ("flash_fwd_sm90_kernel", "flash_long_fwd_kernel", "flash_bwd_dkv_sm90_kernel")
        + tuple(n for n in SIMT_FWD["float32"] if n not in REGTILE_FWD)
        + tuple(n for n in SIMT_BWD["float32"][1:] if n not in REGTILE_BWD))
    busy = sum(per_name.values())
    bwd_names_ = F32_ROWS + REGTILE_BWD
    attn = sum(ms for n, ms in per_name.items() if any(k in n for k in REGTILE_FWD + bwd_names_))
    fwd = sum(ms for n, ms in per_name.items() if REGTILE_FWD[0] in n)
    bwd = sum(ms for n, ms in per_name.items() if any(k in n for k in bwd_names_))
    # a step's backward: K2 at Dh 128 in the 12 video blocks, K4 at Dh 64 in
    # the 12 text layers (each with its row pre-pass)
    k2 = sum(ms for n, ms in per_name.items()
             if any(k in n for k in bwd_names_) and "<128>" in n) / 12
    k4 = sum(ms for n, ms in per_name.items()
             if any(k in n for k in bwd_names_) and "<64>" in n) / 12
    print(f"fp32 quality run: step {step_ms:.1f} ms (host clock, 2 steps on one batch), busy "
          f"{busy:.1f} ms of a traced {wall_ms:.1f} ms (share {busy / wall_ms:.2f}), the fp32 "
          f"K1/K2/K3/K4 {attn:.1f} ms of it, the forward ({REGTILE_FWD[0]}, K1 and K3) "
          f"{fwd:.2f} ms (share {fmt(share(fwd, busy), '.3f')}), the backward "
          f"({', '.join(bwd_names_)}, K2 and K4) {bwd:.2f} ms (share "
          f"{fmt(share(bwd, busy), '.3f')}; busy a call: K2 [16,1569|393,1536] "
          f"{k2:.3f} ms over 3 + 9, K4 [16,12,128,64] {k4:.4f} ms) | {CARD}", flush=True)
    del runner, batch, args
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "busy_ms": busy, "busy_share": busy / wall_ms,
            "simt_attention_busy_ms": attn, "regtile_fwd_busy_ms": fwd,
            "regtile_fwd_share": share(fwd, busy), "regtile_bwd_busy_ms": bwd,
            "regtile_bwd_share": share(bwd, busy), "k2_busy_ms_a_call": k2,
            "k4_text_busy_ms_a_call": k4}


def phase_fp32_probe(torch) -> dict:
    """Phase 41: phase 12's probing step (stenosis_config.yaml, 80 clips) at
    ``precision: fp32`` with DEEPCORO_FUSED_OUTPROJ=1: the frozen encoder's
    attention on the fp32 K5 (12 a step), against the same bundle with the
    plain attention (``use_flash`` off on the encoder's modules); the heads'
    outputs by the fp32 bars FP32_HEAD_ATOL / FP32_HEAD_RTOL."""
    from deepcoro_clip_tpu_torch.train.linear_probe import (
        build_probe_bundle,
        make_probe_eval_step,
        make_probe_train_step,
        to_device_batch,
    )

    _fused_switch(True)
    try:
        cfg = probe_config(precision="fp32")
        bundle, state = build_probe_bundle(cfg, seed=0, steps_per_epoch=1)
    finally:
        _fused_switch(False)
    step_fn, eval_fn = make_probe_train_step(bundle), make_probe_eval_step(bundle)
    batch = to_device_batch(bundle, probe_batch(cfg, cfg.batch_size))
    gen = torch.Generator(device=bundle.device).manual_seed(0)
    state, _ = step_fn(state, batch, gen, cfg.video_freeze_ratio)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_kernel_counts()
    t0 = time.perf_counter()
    state, m = step_fn(state, batch, gen, cfg.video_freeze_ratio)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = _kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(math.isfinite(float(m["loss"])), f"fp32 probing: loss {float(m['loss'])}")
    check(counts == {"K1": 0, "K2": 0, "K3": 1, "K4": 1, "K5": 12, "K6": 0},
          f"fp32 probing: a step launched {counts}, expected K5 12, K3 1, K4 1")
    with torch.no_grad():
        fused = eval_fn(state.params, batch)["outputs"]
        mods = [mm for mm in bundle.video_model.modules() if hasattr(mm, "use_flash")]
        for mm in mods:
            mm.use_flash = False
        plain = eval_fn(state.params, batch)["outputs"]
        for mm in mods:
            mm.use_flash = True
    worst = 0.0
    for h in fused:
        a, r = fused[h].float(), plain[h].float()
        d = (a - r).abs()
        worst = max(worst, float(d.max()))
        check(bool(torch.isfinite(a).all())
              and bool((d <= FP32_HEAD_ATOL + FP32_HEAD_RTOL * r.abs()).all()),
              f"fp32 probing: head {h} through K5 vs the plain attention: max|d| {float(d.max())}")
    # one step traced: the busy step, K5 by name and its share
    per_name, wall_ms = device_events(torch, lambda: step_fn(state, batch, gen,
                                                             cfg.video_freeze_ratio),
                                      expect={REGTILE_PROJ[0]: counts["K5"]})
    print_profile("fp32 probing profile", "one step at precision fp32", per_name, wall_ms, top=8)
    check_main_path_kernels("fp32 probing profile, the encoder's K5", per_name, REGTILE_PROJ,
                            tuple(n for n in SIMT_PROJ["float32"] if n not in REGTILE_PROJ)
                            + ("flash_fwd_proj_kernel",))
    busy = sum(per_name.values())
    k5 = sum(ms for n, ms in per_name.items() if REGTILE_PROJ[0] in n)
    print(f"fp32 probing: stenosis_config.yaml at precision fp32, DEEPCORO_FUSED_OUTPROJ=1, "
          f"{PROBE_CLIPS} clips: a step launched K5 {counts['K5']} ({REGTILE_PROJ[0]}), K3 "
          f"{counts['K3']}, K4 {counts['K4']}; heads against the plain attention's max|d| "
          f"{worst:.3e} (bars {FP32_HEAD_ATOL}+{FP32_HEAD_RTOL}|plain|) ok; step {step_ms:.1f} ms "
          f"(host clock, synchronised), busy {busy:.1f} ms of a traced {wall_ms:.1f} ms, K5 "
          f"{k5:.1f} ms of it (share {fmt(share(k5, busy), '.3f')}), peak {peak:.2f} GiB | "
          f"{CARD}", flush=True)
    del bundle, state, step_fn, eval_fn, batch
    torch.cuda.empty_cache()
    return {"counts": counts, "times": {"step_ms": step_ms, "peak_gib": peak,
                                        "busy_ms": busy, "busy_share": busy / wall_ms,
                                        "k5_busy_ms": k5, "k5_share": share(k5, busy),
                                        "heads_max_abs_diff": worst}}


# --------------------------------------------------------------------------- #
# phase 42: the wide-head forward path: phase 12's probing step with a head
# of 256 or 512 columns, its attention on the wide bf16 Hopper forwards

WIDE_HEADS = (2, 1)  # vit_heads at vit_dim 512: Dh 256 and 512


def _wide_probe_step(torch, heads: int, fused: bool) -> dict:
    """Phase 12's probing step (``probe_config()``, 80 clips, bf16) at
    ``vit_heads`` ``heads``, with the output projection fused into the
    attention (12 wide K5 a step) or not (12 wide K1 a step, then
    ``F.linear``): launches against the prediction, the heads against the
    same bundle with the plain attention (HEAD_ATOL / HEAD_RTOL), step time
    (host clock, synchronised), a traced step's busy time and the wide
    kernel's share of it by name, peak memory."""
    from deepcoro_clip_tpu_torch.train.linear_probe import (
        build_probe_bundle,
        make_probe_eval_step,
        make_probe_train_step,
        to_device_batch,
    )

    cfg = probe_config(vit_heads=heads)
    dh = cfg.vit_dim // heads
    bundle, state = build_probe_bundle(cfg, seed=0, steps_per_epoch=1, fused_outproj=fused)
    step_fn, eval_fn = make_probe_train_step(bundle), make_probe_eval_step(bundle)
    batch = to_device_batch(bundle, probe_batch(cfg, cfg.batch_size))
    gen = torch.Generator(device=bundle.device).manual_seed(0)
    ratio = cfg.video_freeze_ratio
    label = (f"wide probing vit_heads {heads} (Dh {dh}), "
             f"{'K5 fused' if fused else 'K1 + F.linear'}")
    state, _ = step_fn(state, batch, gen, ratio)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_kernel_counts()
    t0 = time.perf_counter()
    state, m = step_fn(state, batch, gen, ratio)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = _kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"K1": 0 if fused else 12, "K2": 0, "K3": 1, "K4": 1, "K5": 12 if fused else 0,
            "K6": 0}
    check(math.isfinite(float(m["loss"])), f"{label}: loss {float(m['loss'])}")
    check(counts == want, f"{label}: a step launched {counts}, expected {want}")
    with torch.no_grad():
        got = eval_fn(state.params, batch)["outputs"]
        mods = [mm for mm in bundle.video_model.modules() if hasattr(mm, "use_flash")]
        for mm in mods:
            mm.use_flash = False
        plain = eval_fn(state.params, batch)["outputs"]
        for mm in mods:
            mm.use_flash = True
    worst = 0.0
    for h in got:
        a, r = got[h].float(), plain[h].float()
        d = (a - r).abs()
        worst = max(worst, float(d.max()))
        check(bool(torch.isfinite(a).all()) and bool((d <= HEAD_ATOL + HEAD_RTOL * r.abs()).all()),
              f"{label}: head {h} against the plain attention: max|d| {float(d.max())}")
    name = (SIMT_PROJ if fused else SIMT_FWD)["bfloat16"][0]
    others = tuple(n for n in WIDE_OLD + ("flash_fwd_wide_sm90_kernel",
                                          "flash_fwd_proj_wide_sm90_kernel") if n != name)
    per_name, wall_ms = device_events(torch, lambda: step_fn(state, batch, gen, ratio),
                                      expect={name: 12})
    print_profile(f"{label} profile", "one step", per_name, wall_ms, top=6)
    check_main_path_kernels(f"{label} profile", per_name, (name,), others)
    busy = sum(per_name.values())
    ms = sum(t for n, t in per_name.items() if name in n)
    print(f"{label}: stenosis_config.yaml, {PROBE_CLIPS} clips: a step launched K5 "
          f"{counts['K5']}, K1 {counts['K1']}, K3 {counts['K3']}, K4 {counts['K4']} (predicted "
          f"{want['K5']}, {want['K1']}, 1, 1; {name}); heads against the plain attention's "
          f"max|d| {worst:.3e} (bars {HEAD_ATOL}+{HEAD_RTOL}|plain|) ok; step {step_ms:.1f} ms "
          f"(host clock, synchronised), busy {busy:.2f} ms of a traced {wall_ms:.1f} ms, "
          f"{name} {ms:.2f} ms of it (share {fmt(share(ms, busy), '.3f')}), peak {peak:.2f} GiB "
          f"| {CARD}",
          flush=True)
    del bundle, state, step_fn, eval_fn, batch, got, plain
    torch.cuda.empty_cache()
    return {"vit_heads": heads, "dh": dh, "fused": fused, "counts": counts,
            "predicted": want, "kernel": name, "step_ms": step_ms, "busy_ms": busy,
            "traced_wall_ms": wall_ms, "kernel_busy_ms": ms, "kernel_share": share(ms, busy),
            "peak_gib": peak, "heads_max_abs_diff": worst}


def phase_wide_probe(torch) -> list:
    """Phase 42: ``_wide_probe_step`` at each of WIDE_HEADS, with and
    without the fused projection (DEEPCORO_FUSED_OUTPROJ: the switch a run
    through main reads)."""
    return [_wide_probe_step(torch, heads, fused) for heads in WIDE_HEADS
            for fused in (True, False)]


# phase 43: the wide-head training path: config/quality/flagship_quality_train.yaml
# through main at vit_heads 2 and 1 (heads of 256 and 512), its video
# tower's attention on the wide bf16 Hopper kernels, forward and backward,
# against the same run with the plain attention from the same seed at
# dropout 0: the first step's loss within WIDE_RUN_FIRST_REL relative (the
# same weights, the same batch: the two attentions' bf16 rounding alone),
# every later step and the validation loss within WIDE_RUN_LOSS_REL (Adam
# carries that rounding from one step to the next); at the initial weights,
# the video tower's attention gradients through the kernels, each parameter's
# and all of them concatenated, no further from the fp32 gradient (the same
# weights in fp32, the plain attention) than the plain bf16 attention's, by
# cosine, within WIDE_GRAD_SLACK. The kernels' cosine to the plain bf16
# attention's is printed, not held: bf16 rounding alone keeps it under
# 0.999 on the deep blocks' qkv weights whatever the attention (the
# control at the recipe's 4 heads, K2's Hopper kernels at Dh 128, reads
# ~0.998 there, and the plain bf16 attention reads ~0.9985 against fp32).
# Launches a train step,
# validation batch and bank chunk as phase 22's (QUALITY_PER_*): K1 and K2
# on the wide kernels in the 12 video blocks.
WIDE_RUN_FIRST_REL = 1e-3
WIDE_RUN_LOSS_REL = 1e-2
WIDE_GRAD_SLACK = 1e-3


def _attention_grads(torch, runner, batch, label: str) -> dict:
    """At the runner's initial weights, its video tower's attention
    parameters' gradients (``compute_loss``, deterministic) through the
    kernels (12 K2 launches), with every module's ``use_flash`` off, and in
    fp32 (the same weights, the plain attention), by cosine: held to
    WIDE_GRAD_SLACK, each parameter's and the tower's concatenated; the
    cosine to the plain bf16 gradient printed."""
    import dataclasses

    from deepcoro_clip_tpu_torch.models.layers import Attention
    from deepcoro_clip_tpu_torch.train.clip import build_clip_bundle, compute_loss

    b, cfg = runner.bundle, runner.bundle.config
    flash_mods = [m for tower in (b.video_model, b.text_model) for m in tower.modules()
                  if hasattr(m, "use_flash")]

    def grads(bundle):
        params = [prm for m in bundle.video_model.modules() if isinstance(m, Attention)
                  for prm in m.parameters()]
        log_temp = torch.tensor(math.log(cfg.temperature), device=bundle.device)
        out = compute_loss(bundle, log_temp, batch, deterministic=True)
        return float(out["loss"].detach()), torch.autograd.grad(out["loss"], params)

    def cosine(a, r):
        a, r = a.double().flatten(), r.double().flatten()
        return float(torch.dot(a, r) / (torch.linalg.vector_norm(a)
                                        * torch.linalg.vector_norm(r)).clamp_min(1e-300))

    names = [f"{mn}.{pn}" for mn, m in b.video_model.named_modules() if isinstance(m, Attention)
             for pn, _ in m.named_parameters()]
    _zero_kernel_counts()
    loss_k, gk = grads(b)
    counts = _kernel_counts()
    check(counts["K2"] == 12, f"{label}: the gradient launched K2 {counts['K2']}, expected 12")
    for m in flash_mods:
        m.use_flash = False
    try:
        loss_p, gp = grads(b)
    finally:
        for m in flash_mods:
            m.use_flash = True
    fb, _ = build_clip_bundle(dataclasses.replace(cfg, precision="fp32",
                                                  use_pallas_attention=False),
                              seed=0, steps_per_epoch=QUALITY_TRAIN // 16,
                              device=str(b.device))
    fb.video_model.load_state_dict(b.video_model.state_dict())
    fb.text_model.load_state_dict(b.text_model.state_dict())
    fb.text_model.proj.dropout = 0.0
    loss_f, gf = grads(fb)
    del fb
    check(_kernel_counts()["K1"] == counts["K1"], f"{label}: a plain gradient launched K1")
    kf, pf, kp = {}, {}, {}
    for name, a, r, f in zip(names, gk, gp, gf):
        kf[name], pf[name], kp[name] = cosine(a, f), cosine(r, f), cosine(a, r)
        check(bool(torch.isfinite(a).all()) and kf[name] >= pf[name] - WIDE_GRAD_SLACK,
              f"{label}: {name}'s gradient through the kernels at cosine {kf[name]} to the "
              f"fp32 gradient, the plain bf16 attention's at {pf[name]} (slack "
              f"{WIDE_GRAD_SLACK})")
    whole = [torch.cat([x.flatten() for x in g]) for g in (gk, gp, gf)]
    tk, tp, tkp = cosine(whole[0], whole[2]), cosine(whole[1], whole[2]), cosine(*whole[:2])
    check(tk >= tp - WIDE_GRAD_SLACK,
          f"{label}: the tower's attention gradients through the kernels at cosine {tk} to the "
          f"fp32 gradient, the plain bf16 attention's at {tp} (slack {WIDE_GRAD_SLACK})")
    wk, wp = min(kf, key=kf.get), min(kp, key=kp.get)
    print(f"{label}: at the initial weights, loss through the kernels {loss_k:.6f}, plain bf16 "
          f"{loss_p:.6f}, fp32 {loss_f:.6f}; the {len(kf)} video-tower attention parameters' "
          f"gradients at cosine >= {kf[wk]:.6f} to the fp32 gradient ({wk}; the plain bf16 "
          f"attention's {pf[wk]:.6f}, >= {min(pf.values()):.6f} over all), the tower's "
          f"{tk:.6f} (plain bf16 {tp:.6f}; bar: no further than it, within {WIDE_GRAD_SLACK}) "
          f"ok; to the plain bf16 attention's gradient >= {kp[wp]:.6f} ({wp}), the tower's "
          f"{tkp:.6f}", flush=True)
    return {"grad_min_cosine_fp32": kf[wk], "grad_worst": wk,
            "plain_grad_min_cosine_fp32": min(pf.values()), "grad_min_cosine_plain": kp[wp],
            "grad_worst_plain": wp, "grad_tower_cosine_fp32": tk,
            "plain_grad_tower_cosine_fp32": tp, "grad_tower_cosine_plain": tkp,
            "initial_loss": loss_k, "initial_loss_plain": loss_p, "initial_loss_fp32": loss_f}


def _quality_runner(torch, manifest: Path, stats: dict, heads: int, out_dir: Path):
    """The quality recipe's runner at ``vit_heads`` ``heads`` (dropout 0,
    the text head's projection dropout off as ``_quality_recorder`` sets it)
    and its first train batch on the card."""
    from deepcoro_clip_tpu_torch.runners.common import batch_to_device
    from deepcoro_clip_tpu_torch.runners.contrastive import VideoContrastiveLearningRunner

    cfg = quality_train_config(data_filename=str(manifest), output_dir=str(out_dir), epochs=1,
                               num_workers=QUALITY_WORKERS, dropout=0.0, vit_heads=heads,
                               **stats)
    runner = VideoContrastiveLearningRunner(cfg, output_dir=out_dir)
    runner.bundle.text_model.proj.dropout = 0.0
    return runner, batch_to_device(next(iter(runner.loaders["train"])), runner.device)


def _wide_train_step(torch, manifest: Path, stats: dict, heads: int, out_dir: Path) -> dict:
    """Phase 43's step: flagship_quality_train.yaml at ``vit_heads``
    ``heads`` on one batch of the corpus (``stats``: the dataset statistics,
    or {} for the runner to compute them). At the runner's initial weights
    the attention gradients (``_attention_grads``); then a warm step, two
    on the host clock, one traced: busy time and share, the wide forward's
    and backward's parts by name (no SIMT wide kernel), K2's busy time a
    call, peak memory."""
    dh = 512 // heads
    label = f"wide training vit_heads {heads} (Dh {dh})"
    runner, batch = _quality_runner(torch, manifest, stats, heads, out_dir)
    grads = _attention_grads(torch, runner, batch, label)
    args = (batch, runner.generator, 0.0, 0.0, -1.0)
    runner.train_step(runner.state, *args)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(2):
        runner.train_step(runner.state, *args)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 2
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # this tree's wide kernels (an older tree's SIMT backward: _use_tree_kernel_names)
    fwd_k = f"{SIMT_FWD['bfloat16'][0]}<{dh}>"
    rows_k, bwd_k = SIMT_BWD["bfloat16"][0], tuple(f"{n}<{dh}>" for n in SIMT_BWD["bfloat16"][1:])
    others = tuple(n for n in WIDE_OLD + ("flash_bwd_dkv_wide_sm90_kernel",
                                          "flash_bwd_dq_wide_sm90_kernel")
                   if n not in SIMT_FWD["bfloat16"] + SIMT_BWD["bfloat16"])
    per_name, wall_ms = device_events(torch, lambda: runner.train_step(runner.state, *args),
                                      expect={fwd_k: 12, bwd_k[0]: 12, bwd_k[1]: 12})
    print_profile(f"{label} profile", "one step", per_name, wall_ms, top=12)
    check_main_path_kernels(f"{label} profile, the video tower's K1/K2", per_name,
                            (fwd_k,) + bwd_k, others + ("flash_fwd_sm90_kernel",
                                                        "flash_bwd_dkv_sm90_kernel"))
    busy = sum(per_name.values())
    fwd = sum(ms for n, ms in per_name.items() if fwd_k in n)
    # K2: the two wide kernels and their row pre-pass (the video tower's
    # only rows kernel at Dh 256 / 512)
    k2 = sum(ms for n, ms in per_name.items()
             if any(k in n for k in bwd_k) or (rows_k in n and f"<{dh}" in n))
    print(f"{label}: step {step_ms:.1f} ms (host clock, 2 steps on one batch), busy "
          f"{busy:.2f} ms of a traced {wall_ms:.1f} ms (share {fmt(share(busy, wall_ms), '.2f')}), "
          f"the wide K1 {fwd:.2f} ms (share {fmt(share(fwd, busy), '.3f')}), K2 {k2:.2f} ms "
          f"(share {fmt(share(k2, busy), '.3f')}; {k2 / 12:.3f} ms a call over 3 at 1569 tokens "
          f"and 9 at 393), peak {peak:.2f} GiB | {CARD}", flush=True)
    del runner, batch, args
    torch.cuda.empty_cache()
    return {"vit_heads": heads, "dh": dh, **grads, "step_ms": step_ms,
            "busy_ms": busy, "traced_wall_ms": wall_ms, "busy_share": share(busy, wall_ms),
            "k1_busy_ms": fwd, "k1_share": share(fwd, busy), "k2_busy_ms": k2,
            "k2_share": share(k2, busy), "k2_busy_ms_a_call": k2 / 12, "step_peak_gib": peak}


def _wide_train_run(torch, manifest: Path, stats: dict, heads: int, tmp: Path) -> dict:
    """Phase 43 at ``vit_heads`` ``heads``: the kernels run and the plain run
    through main (one epoch, no checkpoint written: the quality run's are
    phase 22's to check), held to the bars above; launches counted over the
    kernels run; then ``_wide_train_step``."""
    from deepcoro_clip_tpu_torch.main import main as port_main
    from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager

    steps = QUALITY_TRAIN // 16
    dh = 512 // heads
    label = f"wide training vit_heads {heads} (Dh {dh})"
    print(f"{label}: config/quality/flagship_quality_train.yaml with vit_heads={heads}, dropout "
          f"0, epochs 1 ({steps} steps of 16 clips, one validation pass), phase 22's corpus and "
          f"dataset statistics; against the same run with use_pallas_attention=false; bars: "
          f"step 0 |loss - loss_plain| <= {WIDE_RUN_FIRST_REL} |loss_plain|, later steps and "
          f"the validation loss {WIDE_RUN_LOSS_REL}, the attention gradients by cosine no "
          f"further from fp32 than the plain bf16 attention's (slack {WIDE_GRAD_SLACK}), "
          f"launches per step K1 12, K2 12 (wide), K3 14, K4 14 | "
          f"{CARD}", flush=True)
    runs = {}
    save = CheckpointManager._save
    for name, over in (("kernels", {}), ("plain", {"use_pallas_attention": False})):
        rec = _quality_recorder(torch, 0)
        cfg = quality_train_config(
            data_filename=str(manifest), output_dir=str(tmp / f"wide{heads}_{name}"), epochs=1,
            num_workers=QUALITY_WORKERS, dropout=0.0, vit_heads=heads, **stats, **over)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_kernel_counts()
        t0 = time.perf_counter()
        CheckpointManager._save = lambda self, name, *a, **kw: self.dir / f"{name}.pt"
        try:
            out = port_main(config=cfg)
        finally:
            rec["undo"]()
            CheckpointManager._save = save
        runs[name] = {"history": out["history"], "wall": time.perf_counter() - t0,
                      "output_dir": Path(out["output_dir"]),
                      "counts": {**_kernel_counts(), **_long_counts()},
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "losses": [float(x["loss"]) for x in rec["steps"]]}
        print(f"{label} ({name}): main took {runs[name]['wall']:.1f} s; losses "
              + " ".join(f"{x:.6f}" for x in runs[name]["losses"])
              + f"; val loss {out['history'][0]['val_loss']:.6f}; peak memory "
              f"{runs[name]['peak_gib']:.2f} GiB | {CARD}", flush=True)
    k, p = runs["kernels"], runs["plain"]
    check(len(k["losses"]) == steps == len(p["losses"]),
          f"{label}: steps {len(k['losses'])} / {len(p['losses'])}")
    rel = [abs(a - b) / abs(b) for a, b in zip(k["losses"], p["losses"])]
    for i, (a, b) in enumerate(zip(k["losses"], p["losses"])):
        bar = WIDE_RUN_FIRST_REL if i == 0 else WIDE_RUN_LOSS_REL
        check(math.isfinite(a) and abs(a - b) <= bar * abs(b),
              f"{label}: step {i} loss {a} vs plain {b} (bar {bar} relative)")
    va, vb = k["history"][0]["val_loss"], p["history"][0]["val_loss"]
    check(math.isfinite(va) and abs(va - vb) <= WIDE_RUN_LOSS_REL * abs(vb),
          f"{label}: val loss {va} vs plain {vb}")
    want = {key: QUALITY_PER_STEP[key] * steps + QUALITY_PER_EVAL[key]
            + QUALITY_PER_BANK[key] * _bank_chunks(k["output_dir"], (0,))
            for key in QUALITY_PER_STEP}
    print(f"{label}: launches over {steps} train steps, one validation batch and its bank: "
          + ", ".join(f"{key} {k['counts'][key]} (expected {want[key]})" for key in want),
          flush=True)
    check(k["counts"] == want, f"{label}: launches {k['counts']}, expected {want}")
    check(p["counts"]["K1"] == 0 and p["counts"]["K2"] == 0 and p["counts"]["K3"] == 0,
          f"{label}: the plain run launched {p['counts']}")
    print(f"{label}: per-step loss rel |d| " + " ".join(f"{x:.3e}" for x in rel)
          + f", val loss rel |d| {abs(va - vb) / abs(vb):.3e} (bars {WIDE_RUN_FIRST_REL} at step "
          f"0, {WIDE_RUN_LOSS_REL} after) ok", flush=True)
    step = _wide_train_step(torch, manifest, stats, heads, tmp / f"wide{heads}_trace")
    out = {**step, "counts": k["counts"], "predicted": want, "losses": k["losses"],
           "plain_losses": p["losses"], "loss_rel_diff": rel,
           "val_loss_rel_diff": abs(va - vb) / abs(vb), "peak_gib": k["peak_gib"],
           "plain_peak_gib": p["peak_gib"], "run_s": k["wall"], "plain_run_s": p["wall"],
           "epoch_seconds": k["history"][0]["epoch_seconds"],
           "plain_epoch_seconds": p["history"][0]["epoch_seconds"]}
    print(f"{label}: epoch {out['epoch_seconds']:.2f} s against the plain attention's "
          f"{out['plain_epoch_seconds']:.2f} s; peak memory {k['peak_gib']:.2f} GiB (plain "
          f"{p['peak_gib']:.2f}) | {CARD}", flush=True)
    return out


def phase_wide_train_run(torch, manifest: Path, stats: dict, tmp: Path) -> dict:
    """Phase 43: ``_wide_train_run`` at each of WIDE_HEADS, and the gradient
    check's control: the same at the recipe's own 4 heads (Dh 128, K2's
    Hopper kernels)."""
    runs = [_wide_train_run(torch, manifest, stats, heads, tmp) for heads in WIDE_HEADS]
    runner, batch = _quality_runner(torch, manifest, stats, 4, tmp / "grad_control")
    control = _attention_grads(torch, runner, batch, "wide training control: vit_heads 4 (Dh 128)")
    del runner, batch
    torch.cuda.empty_cache()
    return {"runs": runs, "grad_control_vit_heads_4": control}


def run_wide_bwd_rows(torch) -> dict:
    """One run of the wide bf16 backward's A B B A call (``--wide-bwd-rows``)
    against the package of the tree the script lies in (copy it into an
    older tree): the build; phase 39's bf16 rows of K1 and K2 at Dh 256 and
    512 at ``[16,393|1569,1536]`` (with busy times) and of K3 / K4 at
    ``[8,2,512,192]`` padded to 256; phase 43's step at vit_heads 2 and 1
    (``_wide_train_step``) on a rendered corpus."""
    from deepcoro_clip_tpu_torch.ops import _build

    build_kernels(torch, [n for n in ("flash_fwd", "flash_fwd_proj", "flash_bwd", "flash_short")
                          if (_build.SRC_DIR / f"{n}.cu").exists()])
    _use_tree_kernel_names()
    bf16 = torch.bfloat16
    rows = {k: [] for k in ("K1", "K2", "K3", "K4")}
    for H, Dh in ((2, 256), (1, 512)):
        f, b = _packed_simt_rows(torch, bf16, 16, H, Dh, 393, busy=True, busy_fwd=True)
        rows["K1"].append(f)
        rows["K2"].append(b)
    for f, b in wide_1569_rows(torch):
        rows["K1"].append(f)
        rows["K2"].append(b)
    f, b = _padded_rows(torch, bf16, 8, 2, 512, 192, False, busy=True, busy_fwd=True)
    rows["K3"].append(f)
    rows["K4"].append(b)
    split = _wide_bwd_split(torch)
    with tempfile.TemporaryDirectory() as root:
        manifest = render_corpus(Path(root))
        steps = [_wide_train_step(torch, manifest, {}, heads, Path(root) / f"trace{heads}")
                 for heads in WIDE_HEADS]
    return {"kernels": {"fwd": SIMT_FWD["bfloat16"], "bwd": SIMT_BWD["bfloat16"]},
            "rows": rows, "k2_393_split": split, "wide_train_steps": steps}


def _wide_bwd_split(torch) -> dict:
    """Where the time of K2's backward call at ``[16,393,1536]`` Dh 256 (H 2,
    RoPE) goes (``call_split``): the host's time to issue the
    ``autograd.grad`` call, that of ``_flash_cuda.flash_bwd`` called alone
    on the same views (its checks, scratch and the C entry), and the card's
    busy time by kernel."""
    from deepcoro_clip_tpu_torch.ops import _flash_cuda
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(43)
    B, L, H, Dh = 16, 393, 2, 256
    D = H * Dh
    t = build_rope3d_tables(Dh, 8, 7, 7, n_special=1)
    rope = dict(sin=torch.from_numpy(t.sin).to(dev), cos=torch.from_numpy(t.cos).to(dev))
    x = torch.randn(B, L, 3 * D, generator=g, device=dev) * 0.5
    x[..., :2 * D] *= WIDE_QK_SCALE
    qkv = x.to(torch.bfloat16).requires_grad_()
    do = (torch.randn(B, L, D, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    out = flash_attention_packed(qkv=qkv, num_heads=H, **rope)
    q, k, v = (_to_heads(u, H) for u in qkv.detach().split(D, -1))
    o, doh = _to_heads(out.detach(), H), _to_heads(do, H)
    stats = torch.empty(2, B, H, L, device=dev)
    kw = dict(kv_mask=None, causal=False, scale=Dh ** -0.5, packed=True, **rope)
    _flash_cuda.flash_fwd(q, k, v, torch.empty_like(o), stats=stats, **kw)
    grads = [torch.empty_like(u) for u in (q, k, v)]
    split = call_split(torch, "wide bwd split K2 qkv [16,393,1536] bf16, H 2, Dh 256, RoPE",
                       lambda: torch.autograd.grad(out, [qkv], do, retain_graph=True),
                       SIMT_BWD["bfloat16"],
                       {"flash_bwd alone": lambda: _flash_cuda.flash_bwd(q, k, v, o, doh, stats,
                                                                         *grads, **kw)})
    del qkv, do, out, q, k, v, o, doh, grads
    torch.cuda.empty_cache()
    return split


def run_wide_rows(torch) -> dict:
    """One run of the wide bf16 forward's A B B A call (``--wide-rows``)
    against the package of the tree the script lies in (copy it into an
    older tree): the build; phase 39's bf16 rows of K1 at Dh 256 and 512
    (``[16,393|1569,1536]``, the forward alone), K3 at ``[8,2,512,192]``
    padded to 256 (with K4) and K5 at ``[80,393|1569,1536]`` Dh 256, ``wo``
    ``[512,512]``; phase 42's four probing steps."""
    from deepcoro_clip_tpu_torch.ops import _build

    build_kernels(torch, [n for n in ("flash_fwd", "flash_fwd_proj", "flash_bwd", "flash_short")
                          if (_build.SRC_DIR / f"{n}.cu").exists()])
    _use_tree_kernel_names()
    bf16 = torch.bfloat16
    rows = {"K1": [_packed_simt_rows(torch, bf16, 16, H, Dh, 393, busy_fwd=True,
                                     fwd_only=True)[0] for H, Dh in ((2, 256), (1, 512))]}
    rows["K1"] += [f for f, _ in wide_1569_rows(torch, fwd_only=True)]
    rows["K3"] = [_padded_rows(torch, bf16, 8, 2, 512, 192, False, busy_fwd=True)[0]]
    rows["K5"] = wide_k5_rows(torch)
    return {"kernels": {"fwd": SIMT_FWD["bfloat16"], "proj": SIMT_PROJ["bfloat16"]},
            "rows": rows, "wide_probe": phase_wide_probe(torch)}


def run_fp32_rows(torch) -> dict:
    """One run of the fp32 forward's A B B A call (``--fp32-rows``) against
    the package of the tree the script lies in (copy it into an older
    tree): the build; phase 39's fp32 rows of K1 at ``[16,1569|393,1536]``
    (with K2 from its statistics, and its busy time), K3 at the text tower's
    ``[16,12,128,64]`` with a real-prefix mask (with K4, and its busy time)
    and K5 at ``[80,1569|393,1536]``,
    ``wo`` ``[512,512]``; phase 41's fp32 probing step and phase 40's traced
    fp32 quality step on a rendered corpus."""
    from deepcoro_clip_tpu_torch.ops import _build

    build_kernels(torch, [n for n in ("flash_fwd", "flash_fwd_proj", "flash_bwd", "flash_short")
                          if (_build.SRC_DIR / f"{n}.cu").exists()])
    _use_tree_kernel_names()
    f32 = torch.float32
    rows = {k: [] for k in ("K1", "K2", "K3", "K4", "K5")}
    for L in (1569, 393):
        f, b = _packed_simt_rows(torch, f32, 16, 4, 128, L, busy=True)
        rows["K1"].append(f)
        rows["K2"].append(b)
    f, b = _padded_rows(torch, f32, 16, 12, 128, 64, False, ", the text tower (phase 40)",
                        busy=True)
    rows["K3"].append(f)
    rows["K4"].append(b)
    for L in (1569, 393):
        rows["K5"].append(_proj_simt_row(torch, f32, PROBE_CLIPS, 4, 128, L))
    probe = phase_fp32_probe(torch)
    with tempfile.TemporaryDirectory() as root:
        quality = _fp32_quality_step(torch, render_corpus(Path(root)), {}, Path(root) / "trace")
    return {"kernels": {"fwd": REGTILE_FWD, "proj": REGTILE_PROJ, "bwd": REGTILE_BWD},
            "rows": rows,
            "fp32_probe_step": probe["times"], "fp32_quality_step": quality}


SIMT_NAMES = {
    "K1": ("flash_attention_packed, fp32 and bf16 at Dh 256 to 512 (K1 on the CUDA cores: "
           "flash_fwd_f32_regtile_kernel<128> in fp32 at Dh 128, flash_fwd_f32_kernel<Dh>; "
           "bf16 on the tensor cores: flash_fwd_wide_sm90_kernel<Dh>)", KERNEL_SOURCE,
           K1_REPLACES),
    "K2": ("flash_attention_packed backward, fp32 and bf16 at Dh 256 to 512 (K2 on the CUDA "
           "cores: bwd_rows_f32_kernel, then flash_bwd_dkv_f32_regtile_kernel<128> and "
           "flash_bwd_dq_f32_regtile_kernel<128> in fp32 at Dh 128, flash_bwd_dkv_f32_kernel<Dh>"
           " and flash_bwd_dq_f32_kernel<Dh> above; bf16 on the tensor cores: bwd_rows_kernel, "
           "then flash_bwd_dkv_wide_sm90_kernel<Dh> and flash_bwd_dq_wide_sm90_kernel<Dh>)",
           BWD_SOURCE, K2_REPLACES),
    "K3": ("flash_attention, fp32 above 64 tokens and every padded head dim (K3: "
           "flash_fwd_f32_regtile_kernel<64|128> in fp32 at Dh 64 / 128, flash_fwd_f32_kernel, "
           "flash_fwd_wide_sm90_kernel<Dh> in bf16 at a padded 256 to 512, the long kernels at a "
           "padded 64 / 128)", KERNEL_SOURCE, K3_REPLACES),
    "K4": ("flash_attention backward, fp32 above 64 tokens and every padded head dim (K4: "
           "flash_bwd_dkv_f32_regtile_kernel<64|128> and flash_bwd_dq_f32_regtile_kernel<64|128>"
           " in fp32 at Dh 64 / 128, the SIMT kernels above, the long ones at a padded 64 / 128, "
           "flash_bwd_dkv_wide_sm90_kernel<Dh> and flash_bwd_dq_wide_sm90_kernel<Dh> in bf16 at "
           "a padded 256 to 512)", BWD_SOURCE, K4_REPLACES),
    "K5": ("flash_attention_packed(wo=), fp32 and bf16 at Dh 256 to 512 (K5 on the CUDA "
           "cores: flash_fwd_proj_f32_regtile_kernel in fp32 at Dh 128, "
           "flash_fwd_proj_f32_kernel<Dh>; bf16 on the tensor cores: "
           "flash_fwd_proj_wide_sm90_kernel<Dh>)", PROJ_SOURCE, K5_REPLACES),
    "K6": ("ring_attention(backend=\"rdma\"), fp32 and bf16 at Dh 256 to 512 (K6 on the SIMT "
           "step: ring_step_f32_kernel<Dh>, ring_step_wide_bf16_kernel<Dh>)", RING_SOURCE,
           K6_REPLACES),
}


def simt_entries(rows: dict, quality: dict, probe: dict, ranks: dict, wide: list,
                 wide_train: list) -> list:
    """The kernels line's entries of the SIMT, register-tiled and wide
    routes: launches on their main paths (phase 40's fp32 run for K1 to K4,
    phase 41's step for K5, phase 39's one-process pass for K6, with phase
    34's ranks beside it; phase 42's steps for the wide K1 and K5, phase
    43's runs for the wide K1 to K4), the first row's numbers (the main
    path's shape), every row under ``shapes`` and, for K1 to K5, the
    register-tiled kernels and the wide ones that phase 39 traced by name;
    then the wide backward's own entry (``wide_bwd_entry``)."""
    out = []
    launches = {"K1": quality["counts"]["K1"], "K2": quality["counts"]["K2"],
                "K3": quality["counts"]["K3"], "K4": quality["counts"]["K4"],
                "K5": probe["counts"]["K5"], "K6": rows["K6"][0]["launches"]}
    for key, (name, source, replaces) in SIMT_NAMES.items():
        r = rows[key][0]
        e = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches[key],
             "max_abs_err": max(x["max_abs_err"] for x in rows[key]),
             **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
             "shapes": rows[key]}
        if key in ("K1", "K2", "K3", "K4"):
            e["fp32_quality_train_launches"] = quality["counts"][key]
        if key == "K5":
            e["fp32_probe_step_launches"] = probe["counts"]["K5"]
        if key != "K6":  # the register-tiled kernels by name, and their blocks
            group = {"K1": "K1/K3", "K3": "K1/K3", "K2": "K2/K4", "K4": "K2/K4"}.get(key, key)
            e["regtile_ran"] = rows["regtile"]["ran"][key]
            e["regtile_attrs"] = {k: a for k, a in rows["regtile"]["attrs"].items()
                                  if k.startswith(group)}
        if key in ("K1", "K5"):  # phase 42's steps, each counted from 0
            e["wide_probe_launches"] = {
                f"vit_heads {w['vit_heads']}, {'fused' if w['fused'] else 'unfused'}":
                    w["counts"][key] for w in wide}
        if key in ("K1", "K2", "K3", "K4"):  # phase 43's runs, each counted from 0
            e["wide_train_launches"] = {f"vit_heads {w['vit_heads']}": w["counts"][key]
                                        for w in wide_train}
        if key != "K6":  # the wide bf16 Hopper kernels by name, and their blocks
            group = {"K1": "K1/K3", "K3": "K1/K3", "K2": "K2/K4", "K4": "K2/K4"}.get(key, key)
            e["wide_ran"] = {k: v for k, v in rows["wide"]["ran"].items() if k.startswith(key)}
            e["wide_attrs"] = {k: a for k, a in rows["wide"]["attrs"].items()
                               if k.startswith(group)}
        if key == "K6":
            e.update(ranks)
        out.append(e)
    out.append(wide_bwd_entry(rows, wide_train))
    return out


def wide_bwd_entry(rows: dict, wide_train: list) -> dict:
    """The kernels line's entry of the wide bf16 backward (K2 at Dh 256 to
    512, K4 at the padded widths): launches over phase 43's two kernels
    runs, its numbers at the training step's ``[16,1569,1536]`` Dh 256 row,
    every wide row of phase 39 under ``shapes``, the kernels phase 39 traced
    by name with their blocks, and phase 43's steps."""
    mine = [r for key in ("K2", "K4") for r in rows[key]
            if any("wide_sm90" in k for k in r["kernels"])]
    head = next(r for r in mine if r["shape"].startswith("qkv [16,1569,") and "Dh 256" in r["shape"])
    e = {"name": "flash_attention_packed and flash_attention backward, bf16 at Dh 256 to 512 (K2 "
                 "at those head dims, K4 at the padded widths; on the tensor cores: "
                 "bwd_rows_kernel<Dh, 32>, then flash_bwd_dkv_wide_sm90_kernel<Dh> and "
                 "flash_bwd_dq_wide_sm90_kernel<Dh>)",
         "route": "cuda", "source": BWD_SOURCE, "replaces": K2_REPLACES,
         "also_replaces": K4_REPLACES,
         "launches": sum(w["counts"]["K2"] for w in wide_train),
         "wide_train_launches": {f"vit_heads {w['vit_heads']}": w["counts"]["K2"]
                                 for w in wide_train},
         "max_abs_err": max(r["max_abs_err"] for r in mine),
         **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "busy_ms": head.get("busy_ms"), "shapes": mine,
         "wide_ran": {k: v for k, v in rows["wide"]["ran"].items() if k.startswith(("K2", "K4"))},
         "wide_attrs": {k: a for k, a in rows["wide"]["attrs"].items() if k.startswith("K2/K4")},
         "wide_train": wide_train}
    return e


def ddp_rank(torch, spec_path: str) -> int:
    """A rank of phase 32, 33, 34, 35, 37 or 38 (or of ``--drift``) under
    torch.distributed.run: runs its job, then each job of ``then`` in the
    same process (``then`` of the result holds theirs), ends the process
    group where one runs, and writes the result to
    ``{spec["out"]}.rank{RANK}.json``."""
    import gc
    import os

    from deepcoro_clip_tpu_torch.parallel import distributed

    spec = json.loads(Path(spec_path).read_text())
    rank = int(os.environ["RANK"])
    jobs = {"quality": _ddp_quality_rank, "steps": _ddp_steps_rank,
            "ring_pass": _ring_pass_rank}
    out = jobs[spec["job"]](torch, spec, rank)
    out["then"] = []
    for job in spec.get("then", ()):
        gc.collect()  # (a runner's closures hold it in reference cycles)
        torch.cuda.empty_cache()
        out["then"].append(jobs[job["job"]](torch, job, rank))
    distributed.shutdown()
    Path(f"{spec['out']}.rank{rank}.json").write_text(json.dumps(out))
    return 0


def main(argv) -> int:
    """``--host-only``: phase 1, the build and phase 21 alone, against the
    package of the directory the script lies in (an older tree's too: copy
    the script there). ``--compare``: the A B B A call's measurements
    (``run_compare``), likewise in any tree; ``--fp32-rows``: those of the
    fp32 forward's (``run_fp32_rows``); ``--wide-rows``: those of the wide
    bf16 forward's (``run_wide_rows``); ``--wide-bwd-rows``: those of the
    wide bf16 backward's (``run_wide_bwd_rows``). ``--drift``: phase 32's
    world-1 control against world N and two other world-1 runs
    (``run_drift``)."""
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if argv[:1] == ["--ddp-rank"]:  # a rank of phase 32, 33, 34 or 35
        return ddp_rank(torch, argv[1])
    # fail fast, before any work, where the port's package is missing
    from deepcoro_clip_tpu_torch.ops import _build

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    print(smi, flush=True)  # name, power limit
    global CARD
    CARD = smi
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        if "--host-only" in argv:
            build_kernels(torch, [n for n in ("flash_fwd", "flash_bwd", "flash_short")
                                  if (_build.SRC_DIR / f"{n}.cu").exists()])
            kernels = {"host": phase_host(torch)}
        elif "--compare" in argv:
            kernels = {"compare": run_compare(torch)}
        elif "--fp32-rows" in argv:
            kernels = {"fp32_rows": run_fp32_rows(torch)}
        elif "--wide-rows" in argv:
            kernels = {"wide_rows": run_wide_rows(torch)}
        elif "--wide-bwd-rows" in argv:
            kernels = {"wide_bwd_rows": run_wide_bwd_rows(torch)}
        elif "--drift" in argv:
            kernels = {"drift": run_drift(torch)}
        else:
            kernels = run_all(torch)
    except PhaseError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


_STARTED = [time.perf_counter()]


def _mark(label: str) -> None:
    """The script's seconds so far, after ``label``."""
    print(f"timeline: {label} done at {time.perf_counter() - _STARTED[0]:.1f} s", flush=True)


def run_all(torch) -> dict:
    """Phases 2 to 43; returns the "kernels" line."""
    _STARTED[0] = time.perf_counter()
    build_kernels(torch, ("flash_fwd", "flash_fwd_proj", "flash_bwd", "flash_short",
                          "ring_attention"))
    for key, a in hopper_attrs().items():
        regs = f"{a['registers']} registers a thread"
        if a["setmaxnreg"]:
            regs += (" at entry (setmaxnreg moves them to 232 a consumer, 40 the "
                     "producer)")
        else:
            regs += " (no producer warpgroup, no setmaxnreg)"
        print(f"build: {key} Hopper kernel {a['kernel']}: {a['consumers']} consumer "
              f"warpgroup(s), {regs}, {a['smem_bytes']} B dynamic shared memory a block "
              f"(of the 232448 a block may take)", flush=True)

    errs = phase_kernels(torch)
    with tempfile.TemporaryDirectory() as tmp:
        engine, paths, launches = phase_serving(torch, Path(tmp))
        x, m = phase_e2e(torch, engine, paths)
    kernels = phase_times(torch, engine, x, m, errs, launches)
    del engine, x, m
    torch.cuda.empty_cache()
    _mark("phases 2 to 6")

    bwd_errs = phase_bwd_kernels(torch)
    # phase 20 here: traced after the training phases, a short call showed no
    # device event in any trace on the H100 machine
    short_errs = phase_short_kernels(torch)
    short_rt = short_routes(torch)
    routes = {"K2": bwd_routes(torch), "K4": short_rt["K4"]}
    _mark("phases 7 and 20")
    bundle, state, step_fn, batch, gen, counts, times = phase_training(torch)
    phase_grad_e2e(torch, bundle)
    phase_train_profile(torch, state, step_fn, batch, gen)
    del bundle, state, step_fn, batch
    torch.cuda.empty_cache()
    bwd_entries, k1_text = phase_train_times(torch, bwd_errs, counts, routes)
    for e, key in zip(kernels["kernels"], ("K1", "K3")):
        e["train_launches"] = counts[key]
        # the forward at the train step's shapes, row statistics written
        e["train_max_abs_err"] = bwd_errs[key]
        e["max_abs_err"] = max(e["max_abs_err"], bwd_errs[key])
    kernels["kernels"][0]["shapes"].append(k1_text)
    kernels["kernels"] += bwd_entries
    kernels["train_step"] = times
    _mark("phases 8 to 10")

    proj_errs = phase_proj_kernels(torch)
    bundle, state, step_fn, batch, gen, p_counts, p_times = phase_probing(torch)
    p_times["eval_ms"] = phase_probe_e2e(torch, bundle, state, batch)
    phase_probe_profile(torch, state, step_fn, batch, gen,
                        bundle.config.video_freeze_ratio)
    del state, step_fn, batch
    partial_counts = phase_probe_partial(torch, bundle)
    del bundle
    torch.cuda.empty_cache()
    k5, row_k3, row_k4 = phase_probe_times(torch, proj_errs, p_counts, partial_counts)
    by_key = dict(zip(("K1", "K3", "K2", "K4"), kernels["kernels"]))
    for key, e in by_key.items():  # the probing path's launches of the older kernels
        e["probe_launches"] = p_counts[key]
        e["partial_freeze_launches"] = partial_counts[key]
    for key, row, err in (("K3", row_k3, "K3_f32"), ("K4", row_k4, "K4_f32")):
        by_key[key]["shapes"].append(row)
        by_key[key]["fp32_max_abs_err"] = proj_errs[err]
    by_key["K3"]["attention_pool_max_abs_err"] = proj_errs["K3_pool"]
    kernels["kernels"].append(k5)
    kernels["probe_step"] = p_times
    del k5, row_k3, row_k4
    torch.cuda.empty_cache()
    _mark("phases 11 to 15")

    ring = phase_ring_kernel(torch)
    ring["bwd_max_abs_err"] = phase_ring_grads(torch)
    torch.cuda.empty_cache()
    k6 = phase_ring_times(torch, ring)
    kernels["kernels"].append(k6)
    torch.cuda.empty_cache()
    kernels["ring_train_step"] = phase_ring_training(torch)
    torch.cuda.empty_cache()
    _mark("phases 2 to 19")

    host = phase_host_process()
    kernels["launch_floor"] = host[0]
    for key, source in (("K3", KERNEL_SOURCE), ("K4", BWD_SOURCE)):
        e = by_key[key]
        e["source"], e["long_source"] = SHORT_SOURCE, source
        e["kernels"] = short_rt[key]
        e["short_max_abs_err"] = short_errs["fwd" if key == "K3" else "bwd"]
        e["host"] = [r for r in host[1:] if r["kind"] == key]
    by_key["K3"]["short_bit_equal_to_flash_long_fwd_kernel"] = short_errs["tile_equal"]

    with tempfile.TemporaryDirectory() as corpus_root:
        manifest = render_corpus(Path(corpus_root))
        backbone = Path(corpus_root) / "quality_checkpoint.pt"
        _mark("phases 20 and 21")
        quality = phase_quality_run(torch, manifest, keep=backbone)
        _mark("phase 22")
        for key, e in by_key.items():  # the training run's launches
            e["quality_train_launches"] = quality[key]
        for key, row, agg in zip(("K3", "K4"), quality["rows"],
                                 quality["aggregator_max_abs_err"]):
            by_key[key]["shapes"].append(row)
            by_key[key]["quality_aggregator_max_abs_err"] = agg
            by_key[key]["max_abs_err"] = max(by_key[key]["max_abs_err"], row["max_abs_err"],
                                             agg)
        kernels["quality_train"] = quality["times"]
        torch.cuda.empty_cache()

        multitask = phase_multitask_run(torch, manifest)
        _mark("phase 23")
        torch.cuda.empty_cache()
        siglip = phase_siglip_run(torch, manifest)
        _mark("phase 24")
        torch.cuda.empty_cache()
        multivideo = phase_multivideo_run(torch, manifest)
        _mark("phase 25")
        torch.cuda.empty_cache()
        single_head = phase_single_head_run(torch, manifest, siglip["times"]["memory"])
        _mark("phase 30")
        torch.cuda.empty_cache()
        locca = phase_locca_run(torch, manifest, single_head)
        _mark("phase 31")
        torch.cuda.empty_cache()
        probing = phase_probing_run(torch, manifest, backbone, Path(corpus_root))
        _mark("phase 27")
        torch.cuda.empty_cache()
        clip_inference = phase_clip_inference(torch, manifest, backbone, Path(corpus_root))
        _mark("phase 28")
        torch.cuda.empty_cache()
        deployment = phase_deployment(torch, backbone, probing, Path(corpus_root))
        torch.cuda.empty_cache()
        _mark("phases 22 to 31")
        # phase 32's ranks also run phase 33's steps, and phases 37 and 38's
        # job where their ranks are the same (one launch: each process's
        # start-up once)
        world1 = _quality_world1(torch, manifest, Path(corpus_root))
        steps_prep = _ddp_steps_prepare(torch, Path(corpus_root))
        then = [{"job": "steps", "dir": steps_prep["dir"]}]
        chain_tp = ddp_topology(torch)[0] == TP_RANKS
        if chain_tp:
            _tp_bars(torch)
            then.append(_tp_quality_spec(manifest, Path(corpus_root), world1))
        ddp = phase_ddp_quality_run(torch, manifest, Path(corpus_root), world1, then)
        torch.cuda.empty_cache()
        ddp_steps = phase_ddp_steps(torch, steps_prep, ddp["then"][0])
        torch.cuda.empty_cache()
        _mark("phases 32 and 33")
        ring_processes = phase_ring_processes(torch, Path(corpus_root))
        torch.cuda.empty_cache()
        _mark("phase 34")
        ring_main = phase_ring_main_run(torch, manifest, Path(corpus_root))
        torch.cuda.empty_cache()
        _mark("phase 35")
        imported = phase_checkpoint_import(torch, Path(corpus_root))
        _mark("phase 36")
        torch.cuda.empty_cache()
        tp = phase_tp_quality_run(torch, manifest, Path(corpus_root), world1,
                                  ddp["then"][1] if chain_tp else None)
        torch.cuda.empty_cache()
        _mark("phase 37")
        tp_probe = phase_tp_probe(torch, tp.pop("probe"))
        _mark("phase 38")
        torch.cuda.empty_cache()
        # (phases 27 to 38's trees, read by no later phase, go before phase
        # 40 writes its fp32 checkpoints, so that the file system can give
        # their blocks to those: the machine's disk budget counts every block
        # the script first writes, deleted or not)
        for name in ("probe", "clip", "deploy", "ddp_one", "ddp_quality", "ddp_steps",
                     "ring_inputs.pt", "ring_one", "ring_main", "reference.pt",
                     "converted.pt", "tp_quality"):
            path = Path(corpus_root) / name
            if path.is_dir():
                shutil.rmtree(path)
            else:
                path.unlink(missing_ok=True)
        fp32_quality = phase_fp32_quality_run(torch, manifest, world1["stats"])
        _mark("phase 40")
        torch.cuda.empty_cache()
        wide_train = phase_wide_train_run(torch, manifest, world1["stats"], Path(corpus_root))
        _mark("phase 43")
        kernels["wide_train_grad_control"] = wide_train["grad_control_vit_heads_4"]
        wide_train = wide_train["runs"]
    torch.cuda.empty_cache()
    simt = phase_simt_kernels(torch)
    _mark("phase 39")
    fp32_probe = phase_fp32_probe(torch)
    _mark("phase 41")
    torch.cuda.empty_cache()
    wide = phase_wide_probe(torch)
    _mark("phase 42")
    torch.cuda.empty_cache()
    long = phase_long_kernels(torch, siglip.pop("bank_mask"))
    for run, result in (("multitask", multitask), ("siglip", siglip),
                        ("multivideo", multivideo), ("single_head", single_head),
                        ("locca", locca)):
        for key, e in zip(("K1", "K3", "K2", "K4", "K5", "K6"), kernels["kernels"]):
            e[f"{run}_train_launches"] = result["counts"][key]
        for key, rows in zip(("K3", "K4"), result.get("rows", ((), ()))):
            by_key[key]["shapes"] += rows
            by_key[key]["max_abs_err"] = max([by_key[key]["max_abs_err"]]
                                             + [r["max_abs_err"] for r in rows])
        kernels[f"{run}_train"] = result["times"]
    # phases 27 and 28: the launches of the probing run (its train run through
    # main, K5 on), and of the contrastive inference (the bank apart)
    for key, e in zip(("K1", "K3", "K2", "K4", "K5", "K6"), kernels["kernels"]):
        e["probing_run_launches"] = probing["counts"][key]
        e["probing_val_launches"] = probing["val_counts"][key]
        e["probing_inference_launches"] = {k: c[key]
                                           for k, c in probing["infer_counts"].items()}
        e["clip_inference_launches"] = clip_inference["counts"][key]
    for key, e in zip(("K1", "K3", "K2", "K4", "K5", "K6"), kernels["kernels"]):
        if key in ("K1", "K3", "K5"):  # phase 29's paths, each counted from 0
            e["deployment_launches"] = {k: c[key] for k, c in deployment["counts"].items()}
    kernels["deployment"] = deployment["times"]
    k5 = kernels["kernels"][4]
    k5["probe_step_launches"] = k5["launches"]  # phase 12's steps
    k5["launches"] = probing["counts"]["K5"]  # the probing run through main
    kernels["probing_run"] = probing["times"]
    kernels["clip_inference"] = clip_inference["times"]
    for run, result in (("siglip", siglip), ("multivideo", multivideo)):
        for key, err in zip(("K3", "K4"), result["aggregator_max_abs_err"]):
            by_key[key][f"{run}_aggregator_max_abs_err"] = err
            by_key[key]["max_abs_err"] = max(by_key[key]["max_abs_err"], err)
    kernels["single_head_train"] = single_head["times"]
    kernels["locca_train"] = locca["times"]
    # phases 32 and 33: a rank's launches over the data-parallel quality run
    # and in one step of each other pipeline
    for key, e in zip(("K1", "K3", "K2", "K4", "K5", "K6"), kernels["kernels"]):
        e["ddp_quality_launches_per_rank"] = ddp["counts"][key]
        e["ddp_step_launches_per_rank"] = {k: c["counts"][key] for k, c in ddp_steps.items()}
    kernels["ddp_quality_train"] = ddp["times"]
    kernels["ddp_steps"] = {k: c["loss"] for k, c in ddp_steps.items()}
    # phases 34 to 36: K6 on each rank of the ring across processes, a rank's
    # launches over the ring run through main, K1 behind the importer
    f32_ranks = ring_processes.pop("process_ring_f32")
    kernels["kernels"][5].update(ring_processes)
    for key, e in zip(("K1", "K3", "K2", "K4", "K5", "K6"), kernels["kernels"]):
        e["ring_main_launches_per_rank"] = ring_main["counts"][key]
        e["checkpoint_import_launches"] = imported["counts"][key]
    kernels["ring_main_train"] = ring_main["times"]
    kernels["checkpoint_import"] = {"min_cosine": imported["min_cosine"]}
    # phases 37 and 38: a rank's launches under tensor parallelism (the
    # quality run through main; the probing path's TP_PROBE_STEPS steps) and
    # each kernel at a rank's shapes
    for key, e in zip(("K1", "K3", "K2", "K4", "K5", "K6"), kernels["kernels"]):
        e["tp_quality_launches_per_rank"] = tp["counts"][key]
        e["tp_probe_launches_per_rank"] = tp_probe["counts"][key]
        rows = tp["rows"].get(key, []) + (tp_probe["rows"] if key == "K5" else [])
        if rows:
            e["tp_shapes"] = rows
            e["max_abs_err"] = max([e["max_abs_err"]] + [r["max_abs_err"] for r in rows])
    kernels["tp_quality_train"] = tp["times"]
    kernels["tp_probe"] = tp_probe["times"]
    # the long calls' Hopper kernels, an entry each: launches over phases 22
    # to 25's, 30's and 31's runs, the head row at the SigLIP bank's own mask
    # (phase 24), every long row of phases 22 to 26 and 31 beside it
    runs = (quality, multitask["counts"], siglip["counts"], multivideo["counts"],
            single_head["counts"], locca["counts"])
    for key, names, rows, bank in (
            ("K3", long["routes"]["K3"], [quality["rows"][0]] + multitask["rows"][0]
             + siglip["rows"][0][:1] + multivideo["rows"][0][:1] + long["rows"][0]
             + locca["rows"][0], siglip["rows"][0][0]),
            ("K4", long["routes"]["K4"], [quality["rows"][1]] + multitask["rows"][1]
             + siglip["rows"][1][:1] + multivideo["rows"][1][:1] + long["rows"][1]
             + locca["rows"][1], siglip["rows"][1][0])):
        what = "forward" if key == "K3" else "backward"
        e = {"name": f"flash_attention, Lq or Lk > 64 ({key} {what}: {', '.join(names)})",
             "route": "cuda", "source": LONG_SOURCES[key],
             "replaces": K3_REPLACES if key == "K3" else K4_REPLACES,
             "launches": sum(c[f"{key} long"] for c in runs),
             "locca_train_launches": locca["counts"][f"{key} long"],
             "single_head_train_launches": single_head["counts"][f"{key} long"],
             "max_abs_err": max(r["max_abs_err"] for r in rows), "kernels": names,
             "skip_cut_keys_at_the_bank": long["cut"],
             "bank_launches": clip_inference["bank_counts"][f"{key} long"]}
        e.update({k: bank[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                       "device_ms", "library_device_ms")})
        e["shapes"] = rows
        kernels["kernels"].append(e)
    # phases 39 to 41: the SIMT routes (fp32, bf16 at Dh 256 to 512) and the
    # padded head dims, an entry each, with their main paths' launches
    kernels["kernels"] += simt_entries(simt, fp32_quality, fp32_probe,
                                       {"process_ring_f32": f32_ranks}, wide, wide_train)
    kernels["wide_probe"] = wide
    kernels["fp32_quality_train"] = fp32_quality["times"]
    kernels["fp32_probe_step"] = fp32_probe["times"]
    kernels["untraced"] = UNTRACED
    print(f"trace: {len(UNTRACED)} reading(s) not traced (no device event in the profiler's "
          f"windows){': ' + ', '.join(UNTRACED) if UNTRACED else ''}", flush=True)
    return kernels


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
