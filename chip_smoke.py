#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``aphrodite_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and nothing of JAX. ``python3 chip_smoke.py --ab
PARENT [PART ...]`` instead runs phases 8, 12, 14, 6, 15, 16 and 24, the
attention wrappers' host time a call, the window kernel's device time, both
MLA instances at ``MLA_GEOMS``, the bf16 span instance at phase 26's wave
with and without the spans, the attention kernels' tensor-core instances
at head dims 64, 128 and 256 at their paths' shapes (``ATTN_PROBE``), the
bf16 grouped GEMM at phase 8's shapes, a Llama-3.1-8B layer's four bf16 W4
GEMMs (int4 and packed, M = 128 and 32) and a layer's four bf16 W8 and
uint4 GEMMs (at phases 15's, 16's and 5's shapes, M = 32) and the
sampler's token-history block at phase 20's draw (``HISTORY_PROBE``) of
the checkout unpacked at PARENT and of this one, in turns
(``compare_serving``; PARTs from ``AB_PARTS`` pick some). ``python3 chip_smoke.py --variants [LAYOUT
...]`` times the bf16 weight-only kernel with parts removed
(``w4_variants``); ``python3 chip_smoke.py --span-builds`` times phase 1's
build with ALiBi in the span instances as a uniform branch and as a
template switch (``span_build_times``). Phases, each fatal on failure:

1. Print the card's name and power limit; build the CUDA kernels from
   ``aphrodite_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel).
2. Hold each kernel against its plain PyTorch version at the main paths'
   shapes, in bf16 and fp32 (fp16: the paragraphs after the list), and
   time kernel, plain version and a library
   yardstick that the port itself never calls: both attention kernels at
   the Qwen2.5-1.5B, Llama-3.1-8B and Qwen2.5-7B paths' heads, prefill
   wave and decode window, against ``scaled_dot_product_attention`` over
   gathered dense K/V; the quantized GEMMs (Llama-3.1-8B decode shapes for
   the packed W4 kernel, Qwen2.5-1.5B shapes for the unpacked W4 and the W8
   kernel, and phases 15's and 16's for these two in bf16) against
   ``torch._weight_int4pack_mm`` / ``torch._weight_int8pack_mm`` where
   the card's torch has them, else ``torch.matmul`` on the dequantized
   weight, each by its time a call and its device time (profiler). Also
   time the W4 prefill product (M > 256) at the 8B wave's shapes.
3. Run a tiny model end to end in fp32 through the port's ``LLM`` on the
   card and on the CPU with the same weights: greedy tokens must be equal.
4. Qwen2.5-1.5B geometry, bf16 dummy weights, block 64, max_num_seqs 32,
   64 prompts x (500 + 50) greedy through ``LLM.generate``; one warm-up
   run, then timed runs and a profiled run. Exactly 3200 tokens must come
   out and both attention kernels must have been launched.
5. Quantized parity: Qwen2.5-1.5B widths at 2 layers, fp32, gptq (the
   unpacked W4 kernel) and w8a16 (the W8 kernel), card vs CPU with the
   same quantized weights: greedy tokens must be equal and each kernel
   launched.
6. The main path of the quantized slice: Llama-3.1-8B at full width,
   W4A16 (gptq, group 128; every projection packed), bf16, 32 prompts x
   (512 + 64) greedy; one warm-up, 2 cold runs (prefix cache reset before
   each), 2 warm runs, one profiled run. Exactly 2048 tokens a run, the
   packed W4 kernel exactly 4 x 32 x 63 = 8064 times a run, and both
   attention kernels must have been launched.
7. MoE parity: a tiny Qwen2-MoE (8 experts, top-2, a gated shared expert,
   one dense layer) in fp32, card vs CPU with the same weights: greedy
   tokens must be equal and the grouped GEMM launched.
8. The main path of the MoE slice: Qwen1.5-MoE-A2.7B at full width and
   6 of its 24 layers (``QWEN15_MOE_QUARTER``; 60 experts, top-4), bf16, the
   same traffic and runs as phase 6.
   Exactly 2048 tokens a run; the grouped GEMM and both attention kernels
   must have been launched.
9. SSM parity: a tiny Mamba, FalconMamba and Mamba-2 in fp32 (weights
   redrawn at fan-in scale), card vs CPU with the same weights, chunked
   prefill at a 16-token budget and decode windows: greedy tokens must be
   equal and the selective scan launched.
10. The main path of the SSM slice: Mamba-2.8B (``state-spaces/
   mamba-2.8b-hf``) at full width, its depth cut to ``MAMBA_DEPTH`` (16 of
   64 layers), bf16, a 4096-token batch budget, phase 6's traffic. Prefix
   caching is off for recurrent-state models, so every run is cold: one
   warm-up, 2 timed runs, one profiled run. Exactly 2048 tokens and no
   cached prompt token a run; the scan launched 16 times (once a layer)
   for every forward of the runner.
11. Gemma parity: a tiny Gemma-2 (head_dim 256) and Gemma-3 (MQA, linear
   rope on its global layer) in fp32 with a 16-token sliding window and
   soft caps, card vs CPU with the same weights, prompts past the window,
   16-step decode windows: greedy tokens must be equal and the decode
   kernel launched.
12. The main path of the Gemma slice: Gemma-2-9B (``google/gemma-2-9b``)
   at full width and 11 of its 42 layers (``GEMMA2_9B_QUARTER``), bf16, phase
   6's traffic and runs. Exactly 2048 tokens a run; decode runs the
   non-window multi-step path, so in every cold and warm run the decode
   kernel launches 11 x 63 = 693 times, the ragged kernel 11 times and
   the window kernel never.
13. Int4 + cascade parity: a one-layer Llama at K = 2048 (every projection
   packs under gptq's group of 128), gptq realized to native int4
   (``realize_int4_leaves``), fp32, 72 prompts sharing a 100-token prefix on
   16-token pages (decode M = 72 > 64; 6 shared pages), card vs CPU with
   the same weights: greedy tokens must be equal, the int4 kernel and the
   shared-prefix pass launched; on the card, the same tokens again with
   the cascade turned off (``_detect_shared_prefix`` patched to None).
14. The main path of the int4 + cascade slice: Llama-3.1-8B at full width
   and half its depth (16 of 32 layers, ``LLAMA31_8B_HALF``), W4A16 (gptq,
   group 128) realized to native int4, bf16, 128 requests sharing a
   seeded 1024-token system prompt, each with a 128-token suffix new in
   every run, 64 greedy tokens. The warm-up caches the prefix, so every
   timed run prefills one 16384-token wave (131072 cached prompt tokens)
   and runs one 63-step window at R = 128 sharing 16 pages: exactly 4 x 16
   x 63 = 4032 int4 launches, 16 x 63 = 1008 shared-prefix passes and
   window launches, 16 ragged and 0 packed W4 launches a run.
15. The main path of the W8 layout: Llama-3.1-8B at full width and a
   quarter of its depth (8 of 32 layers, ``LLAMA31_8B_QUARTER``), W8A16
   (per-column int8) on seeded dummy weights, bf16, phase 6's traffic and
   runs. Exactly 2048 tokens a run, the W8 GEMM exactly 4 x 8 x 63 = 2016 times
   in every cold and warm run, the other quantized GEMMs never, both
   attention kernels launched.
16. The main path of the uint4 layout: Qwen2.5-7B (``Qwen/Qwen2.5-7B``:
   28 / 4 heads of 128, qkv bias, untied head) at full width and a quarter
   of its depth (7 of 28 layers, ``QWEN25_7B_QUARTER``),
   gptq (group 128; no projection packs at K = 3584 and 18944) on seeded
   dummy weights, bf16, phase 6's traffic and runs. Exactly 2048 tokens a
   run, the uint4 GEMM exactly 4 x 7 x 63 = 1764 times, the other
   quantized GEMMs never, both attention kernels (at 7 query heads a KV
   head, held in phase 2 first) launched.
17. FP8 parity: fp32 greedy tokens on the card and on the CPU with the
   same weights for a 2-layer Qwen2.5-1.5B with (quantization,
   kv_cache_dtype) = (fp8, fp8_e4m3) and (fp8_w8a8, fp8_e5m2) (int8 W8A8
   is held card = CPU in phase 30, in fp16), a tiny Gemma-2 on an e4m3
   cache (the decode kernel's fp8 instance) and phase 13's int4 + cascade layer on an e4m3 cache (the
   shared pass's): equal but where the free runs part (``same_tokens``:
   there the two engines' logprob differences of the two tokens, read
   from both free runs at that step, lie less than ``GAP`` apart, at most
   a tenth of the tokens part, and both go on from the CPU's token);
   kFp8's fp32 twin and the fp8-cache attention instances launched.
18. The main path of the FP8 slice, BASELINE config 3: Llama-3.1-8B at full
   width and half its depth (16 of 32 layers, ``LLAMA31_8B_HALF``), fp8
   weights (e4m3, a scale a column) and an fp8 e4m3 KV cache, bf16, phase
   6's traffic and runs. Exactly 2048 tokens a run, kFp8 exactly 4 x 16 x
   63 = 4032 times, the other quantized GEMMs never, the ragged kernel 16
   and the window kernel 1008 times in every cold and warm run; a profile
   with an "fp8" family.
19. Sampling parity (run after phase 5): seeded sampled requests through
   the port on the card and on the CPU with the same weights, fp32: a
   tiny Qwen2 under the three presets of phase 20 in rotation (a chunked
   wave, decode windows, one request n = 2, logprobs = 5, one request
   prompt_logprobs = 3), a tiny Gemma-2 (the multi-step path) and a tiny
   Mamba (the SSM window) with one preset each. Tokens equal but where a
   completion parts at a near tie (``sampled_partings``: the CPU's noisy
   scores of the two tokens within ``SAMPLE_GAP``, at most a tenth of the
   completions); the Gumbel kernel and the token-history pass launched.
20. The main path of the sampler slice (run right after phase 6, on its
   engine): Llama-3.1-8B W4A16, phase 6's traffic with every request
   seeded and the API, creative-chat and penalised presets of
   ``SAMPLED_PRESETS`` in rotation. Two cold and two warm runs, each
   exactly 2048 tokens and launches exactly: packed W4 8064, ragged 32,
   window 2016 (as phase 6), Gumbel 64 (the wave's draw and 63 sub-steps'),
   the token-history pass 64 (one launch a draw: DRY, the penalties and
   no-repeat-ngram); the two cold runs' tokens compared; one captured
   sub-step held against the plain ``sample_tokens`` (every token in its
   row's support, the kernel's token the plain one's but at gaps <
   ``NOISE_GAP``); walls beside phase 6's and a profile with the
   sampler's device time ("under sample") and the history pass's launches
   and device time a draw.
21. ALiBi parity: tiny BLOOM, MPT (clip_qkv), Falcon-rw / 7b / new
   architecture and Baichuan (ALiBi) in their config.json spellings
   (``FLEX_TINY``), fp32, weights redrawn (``redraw_flexible``), card vs
   CPU with the same weights, a 16-token batch budget (mixed waves whose
   chunks sit past the keys earlier chunks cached) and 8-step decode
   windows on the multi-step path: greedy tokens must be equal; on the card
   every call of the ragged and decode kernels carries the model's slopes
   for the ALiBi families and none for Falcon's rope ones (``SlopeSpy``).
22. The main path of the ALiBi slice: Baichuan2-13B
   (``baichuan-inc/Baichuan2-13B-Chat``: 40 / 40 heads of 128, ALiBi on
   every head, SwiGLU 13696, vocab 125696, untied head) at full width and
   depth, bf16 dummy weights (27.8 GB), phase 6's traffic and runs.
   Exactly 2048 tokens a run; in every cold and warm run the ragged kernel
   exactly 40 and the decode kernel exactly 40 x 63 = 2520 launches, every
   call with the slopes, the window kernel never; a profiled run.
23. DeepSeek parity (``deepseek_parity``): tiny DeepSeek V2 (greedy, and
   q_lora with group-limited routing) and V3 in fp32 (``DS_TINY``:
   weights redrawn, ``redraw_deepseek``), card vs CPU with the same
   weights, a 32-token batch budget, 16-step windows and a second batch of
   three requests sharing a 4-page prompt (the cascade at the latent
   head): greedy tokens equal, every attention launch on the scalar
   instances; V2 and V3 again on e4m3 and e5m2 caches (tokens equal but
   at ties, ``same_tokens``); then ``DS_TINY_BF16`` (16 heads on one
   latent head of 512 + 64, dense MLPs) in bf16, on a bf16 and an e4m3
   cache, on the MLA instances only, its logprobs within
   ``DS_BF16_LOGPROB_TOL`` of the CPU's up to the first token where the
   runs part.
24. The main path of the MLA slice: DeepSeek-V2-Lite
   (``deepseek-ai/DeepSeek-V2-Lite`` config.json: 27 layers, 16 query
   heads on one latent head of 576, 64 experts top-6 with 2 shared, a
   dense first layer, DeepSeek-YaRN) at full width, its depth cut to
   ``DEEPSEEK_DEPTH`` = 14 layers (phase 27 serves all 27 again), bf16
   dummy weights, phase 6's traffic and runs. Exactly 2048 tokens a run;
   in every cold and warm run the ragged kernel exactly 14 and the window
   kernel exactly 14 x 63 = 882 launches, all on their MLA instances, the
   grouped GEMM 26 (13 MoE layers x 2, the wave only), the other attention
   instances never; a profiled run.
25. Vision parity (``mm_parity``): tiny Gemma-3 multimodal and PaliGemma
   on a Gemma and a Gemma-2 base (``MM_TINY``, dict configs with nested
   ``text_config`` / ``vision_config``), fp32, weights redrawn
   (``redraw_mm``), card vs CPU with the same weights: a batch with one
   image, two images and a text-only row, a 16-token batch budget that
   cuts a prompt inside an image span, 16-step decode windows; greedy
   tokens must be equal; on the card Gemma-3's ragged launches all carry
   the spans (the scalar instance's span branch), PaliGemma's none.
26. The main path of the vision slice: Gemma-3-4B-it (``GEMMA3_4B_IT``,
   ``google/gemma-3-4b-it`` config.json written out: 34 layers, 8 / 4
   heads of 256, five sliding layers to one global, a SigLIP tower of 27
   layers on 896 x 896 images, 256 image tokens) at full width and 17 of
   its 34 text layers (``GEMMA3_HALF_DEPTH``, as phase 35),
   bf16 dummy weights redrawn at fan-in scale on the card (``redraw_mm``),
   32 requests of 512 prompt tokens (one seeded 896 x 896 uint8 image
   each, expanded to its 256-token span between boi and eoi) + 64 decode
   tokens, ``block_size=64``, a 16384-token budget (one wave). A warm-up,
   2 cold runs (prefix and encoder caches emptied), 2 warm runs, a batch
   of the same ids with other images (no prefix hit, other tokens), and a
   profiled cold run (the tower's device time under its ``vision`` host
   range, "ragged (spans)", "decode"). Exactly 2048 tokens a run; in
   every run the ragged kernel exactly 17 launches, all bf16 with the
   spans on the tensor-core instance (``csrc/ragged_spans.cu``), the decode
   kernel 17 x 63 = 1071, the window kernel never; the tower 32 images in
   a cold run and none in a warm one.
27. The main path of the fp8 MLA slice (run after phase 24): phase 24's
   model at full depth (27 layers), traffic and runs with
   ``kv_cache_dtype="fp8_e4m3"`` (the KV pool
   at one byte an element: 31,104 bytes a token against phase 24's
   62,208). In every cold and warm run exactly: ragged 27 and window 1701,
   all on the MLA instances' e4m3 ones, grouped 52, 0 on the other
   instances; the pool's bytes a token logged; a profiled run.
28. fp16 parity (``fp16_parity``): fp16 greedy runs on the card and on the
   CPU with the same weights, every model with heads of 64 (the fp16
   tensor-core instances): a tiny Llama on fp16, e4m3 and e5m2 caches (20
   prompts sharing a 96-token prefix on 16-token pages, a 128-token
   budget: chunked prefill, decode windows, the shared pass and the window
   from its state) and a tiny BLOOM (ALiBi; the decode kernel). Tokens
   equal but where the runs part at a gap below ``GAP``
   (``same_tokens``); chosen logprobs within ``F16_LOGPROB_TOL`` where
   they agree; every kernel's card launches exactly its CPU twin's calls
   (``CallSpy``), all on the tensor-core instances.
29. The main path of the fp16 slice (``main_path_llama2_fp16``):
   Llama-2-7B (``LLAMA2_7B``: 32 / 32 heads of 128, published in fp16)
   at full width and 16 of its 32 layers (``LLAMA2_7B_HALF``) in fp16 on
   seeded dummy weights, phase 6's traffic, cold and warm (ragged 16 and
   window 1008 a run, all on the tensor-core instances, every logprob
   finite), then on the same engine 32 requests sharing a seeded
   1024-token system prompt, a 64-token suffix each and 64 new tokens
   (ragged 16, shared pass 1008, window 1008 from its state a run; 32768
   cached prompt tokens); the KV bytes a token logged (262,144); a
   profiled run of each.
30. fp16 quantized parity (``fp16_quant_parity``): fp16 greedy runs on the
   card and on the CPU with the same weights (``F16_QUANT_TINY``: a tiny
   Qwen2 whose projections stay uint4, a one-layer Llama at K = 2048 whose
   projections pack): gptq at both, awq packed, the packed leaves realized
   to int4, w8a16, fp8, fp8_w8a8 and int8; 12 prompts, a 64-token budget,
   16-step windows. Tokens equal (but where activations round to 8 bits:
   partings at gaps below ``GAP``, ``same_tokens``); chosen logprobs within
   ``F16_LOGPROB_TOL``; every quantized GEMM's card launches exactly its
   CPU twin's calls (``GemmSpy``), all on the fp16 instance.
31. The main path of the fp16 GEMM slice (``main_path_awq_fp16``):
   Llama-3.1-8B-Instruct AWQ-INT4's geometry (``LLAMA31_8B``; the
   checkpoint ``hugging-quants/Meta-Llama-3.1-8B-Instruct-AWQ-INT4`` is
   published in fp16) at full width and depth in fp16, ``quantization=
   "awq"`` (group 128, zero points) on seeded dummy weights, phase 6's
   traffic and runs, cold and warm: exactly 8064 packed-GEMM launches a
   run, all on the fp16 instance, ragged 32 and window 2016, all on the
   fp16 tensor-core instances, the other quantized GEMMs never; every
   logprob finite; walls beside phase 6's; the KV bytes a token (131,072);
   a profiled run.
32. fp16 MoE and MLA parity (``moe_mla_fp16_parity``): fp16 greedy runs on
   the card and on the CPU with the same weights (``F16_MOE_TINY``): tiny
   DeepSeek V2 and V3 at the MLA geometry (16 heads on one latent head of
   576) with a MoE layer, on fp16, e4m3 and e5m2 caches, and a tiny
   Qwen2-MoE (heads of 64), every token on all 8 experts (no top-k choice
   that a rounding could flip), the grouped route from 4 tokens a wave;
   phase 23's plain batch (a 32-token budget, 16-step windows) in each run
   and its shared 4-page prompt (the cascade at 576) in V2's on the fp16
   cache. Tokens equal but where the runs part at a gap below ``GAP``;
   chosen logprobs within ``F16_LOGPROB_TOL`` where they agree; every
   attention kernel's and the grouped GEMM's card launches exactly its CPU
   twin's calls (``CallSpy``, ``GroupedSpy``), all fp16, the attention at
   head_dim 576 all on the MLA instances.
33. The main path of the fp16 MoE and MLA slice (``main_path_deepseek(
   dtype="float16")``): DeepSeek-V2-Lite at full width and
   ``DEEPSEEK_DEPTH`` = 14 of its 27 layers (phase 27 serves all 27) in
   fp16 on an fp16 cache, phase 6's traffic and runs, cold and warm. In
   every run exactly: ragged 14 and window 882, all on the MLA instances'
   fp16 ones, grouped 26, all fp16, 0 on the other instances
   and in bf16; every logprob finite; the KV bytes a token; a profiled
   run.
34. fp16 multimodal parity (``mm_fp16_parity``): fp16 greedy runs on the
   card and on the CPU with the same weights (``F16_MM_TINY``, phase 25's
   batch and settings): a tiny Gemma-3 at head_dim 64 (the fp16 span instances
   of ``csrc/ragged_spans_f16.cu``) on fp16 and e4m3 caches, at head_dim 32
   (the same instances in 64-wide tiles), and a tiny PaliGemma-2 (head_dim
   32: ``csrc/ragged_f16.cu``). Tokens equal but where the runs part at a gap
   below ``GAP`` (``same_tokens``; a parting's continuation keeps the images);
   chosen logprobs within ``F16_LOGPROB_TOL``; every attention kernel's card
   launches exactly its CPU twin's calls (``CallSpy``), every ragged launch
   fp16 from its run's library, Gemma-3's all with the spans.
35. The main path of the slice of the ragged kernel's last options
   (``main_path_gemma3_mm(dtype="float16")``): Gemma-3-4B-it at full width and
   17 of its 34 text layers (``GEMMA3_HALF_DEPTH``, which keeps the script
   inside its time limit) in fp16, phase 26's traffic, images
   and runs (not the batch with other images: phase 26 holds the content
   hash). In every run exactly: ragged 17, all fp16 with the spans on the fp16
   span instances (``csrc/ragged_spans_f16.cu``), decode 1071, window 0; 32
   images encoded a cold run and none a warm one; every logprob finite; its
   walls beside phase 26's; a profiled run.
36. Parity on the tensor-core routes at other geometries
   (``tc_route_parity``): fp16 greedy runs on the card and on the CPU with
   the same weights (``TC23_TINY``): a tiny BLOOM at head_dim 80 (ALiBi)
   on fp16 and e4m3 caches and a Falcon-7B-style multi-query model with 18
   query heads of 64 on one KV head. Tokens equal but where the runs part
   at a gap below ``GAP``; chosen logprobs within ``F16_LOGPROB_TOL``; the
   ragged and decode kernels' card launches exactly the CPU's calls, every
   one on the tensor-core instances.
37. BLOOM-3b (``BLOOM_3B``, ``bigscience/bloom-3b`` config.json written
   out: 30 layers, 32 heads of 80, ALiBi, vocab 250880) bf16 at full width
   and depth, phase 6's traffic (``main_path_tc_route``): every cold and
   warm run exactly ragged 30 and decode 30 x 63 = 1890, all on the
   tensor-core instances and with the slopes, window 0; a profiled run.
38. Falcon-7B (``FALCON_7B_HALF``: ``tiiuae/falcon-7b``, 71 query heads of
   64 on one KV head, at 16 of its 32 layers) bf16, phase 6's traffic:
   exactly ragged 16 and decode 16 x 63 = 1008 a run, all on the
   tensor-core instances (the decode kernel in five row slices), none with
   slopes, window 0; a profiled run.

For the fp16 GEMM slice phase 2 (``fp16_gemm_checks``) holds each layout's
fp16 instance (``csrc/w4_wgmma_f16.cu``) against its plain version at
``W4_CASES``, ``BYTE_CASES`` and ``FP8_CASES`` (every M tile, forced K
splits, integral and fractional zeros, row scales) within ``gemm_tol``,
two launches bit-equal; every e4m3 and int8 byte and every nibble less
every admitted zero (fp16 and bf16) bit for bit against the CPU models
(``check_gemm_bytes_f16``); and times a layer's four GEMMs of each of
``F16_GEMM_TIMED`` beside the bf16 instance on the same weights, the plain
version, a dense fp16 ``torch.matmul`` of the dequantized weights and
``_weight_int4pack_mm`` where the card's torch takes fp16 x.

For the fp16 slice phase 2 (``fp16_checks``) holds each fp16 instance of
the ragged, window, decode and shared-prefix kernels against its plain
version at ``TOL["float16"]`` (5e-3) at phase 29's shapes on fp16, e4m3
and e5m2 caches, timed beside its bf16 self at the same shapes and cache
and beside SDPA in fp16: the ragged kernel at the wave (``F16_WAVE``;
with ALiBi too), the window at sub-step 24, the decode kernel with ALiBi
at 32 heads of 128 (``F16_DECODE_CASES``), the shared pass over a
1024-token prefix at R = 32 and the window from its state
(``F16_SHARED``); and the ragged and window kernels' mask cases and two
ALiBi cases in fp16.

For the MLA slice phase 2 (``mla_checks``) holds both MLA instances
(``csrc/mla_attention.cu``: wgmma, TMA and a producer warp) against their
plain versions at phase 24's wave and window and at V3's group of 128
(``MLA_GEOMS``), two launches of each bit-equal, each timed beside SDPA
over the gathered K/V (the backend its dispatch picks named) and, at
phase 24's shapes, beside the bf16 scalar instances
(``scalar_instances``); the fp32 scalar instances at the same geometries
(a group cut into row slices); both instances with a soft cap and a
sliding window on 16-token pages (``MLA_MASK_CASE``), and again with NaN
in every cache slot past the contexts, in the null page and in the
window tail's unwritten slots (``poison_stale``) on pages of 16 and 64;
the shared-prefix pass at head_dim 576 and the window from its state
(pages of 16 and 64); and the grouped GEMM at V2-Lite's MoE wave (98,304
rows, 64 experts, top-6: ``V2_LITE_MOE``) beside ``_grouped_mm``. For the
fp8 MLA slice (``mla_fp8_checks``) it holds both MLA instances on e4m3
and e5m2 caches (the window's tails e4m3 beside e4m3, bf16 beside e5m2)
at ``MLA_GEOMS`` and ``MLA_MASK_CASE`` (NaN bytes in the stale slots on
pages of 16 and 64) and the cascade at 576 on them, each against its
plain version, bit-equal to its bf16 self on the cache upcast to bf16
and two launches bit-equal, timed beside its bf16 self and SDPA on the
upcast K/V (the bound with K/V at one byte); and bf16 and e4m3 launches
in turns over one allocation whose layer has one base and row count in
both views (``OneAllocation``: the tensor maps' key must hold the
element type).
``--ab PARENT mla 24`` times the MLA instances (``MLA_PROBE``) and phase
24 of a parent checkout and of this one in turns.

For the fp16 MoE and MLA slice phase 2 (``moe_mla_fp16_checks``) holds
the grouped GEMM's fp16 instance (``csrc/grouped_matmul_f16.cu``) at phase
8's shapes and cases (``GROUPED_EDGE_CASES``: empty groups, rows that no
group covers) and at V2-Lite's wave, and both MLA instances' fp16 ones
(``csrc/mla_attention_f16.cu``) at ``MLA_GEOMS`` on fp16, e4m3 and e5m2
caches (the fp8 ones bit-equal to their fp16 selves on the upcast cache),
at ``MLA_MASK_CASE`` with NaN in the stale slots, from the cascade's
state, two launches bit-equal, against their plain versions at
``TOL["float16"]``, each timed beside its bf16 self in the same call; and
bf16 and fp16 launches in turns over one allocation
(``check_mla_map_key_f16``).

Phase 2 also holds the grouped GEMM (which stands in for the megablox
``gmm`` TPU kernel) against its plain version at phase 8's shapes: one
prefill wave's 65536 sorted rows over 60 experts, gate|up and down, with
balanced (random top-4) and skewed group sizes (empty groups, one group
holding ~45 % of the rows), at M = 240, where the grouped route
starts, and where the bf16 kernel's tiles, TMA boxes and clusters bite
(``GROUPED_EDGE_CASES``: M = 65536 - 37, K = 1000, N = 1416, a 1-row group,
one expert holding every row, E = 33); two launches on the same inputs
must be bit-equal. It times the balanced cases (call, device and host
time) beside the plain version, ``torch._grouped_mm`` where the card's
torch has it, and a dense ``torch.matmul`` of the same operations.
It holds the decode kernel (which stands in for the TPU
``decode_paged_attention``) in bf16 and fp32 at phase 12's decode step
(32 rows, 16 / 8 heads of 256, contexts 513-576, soft cap 50), with a
256-token sliding window over ~1030-token contexts, with ALiBi and
chunked local attention at head_dim 128, and at the Llama-3.1-8B heads
(32 / 8 of 128) without options, each at TOL x min(1, max|ref|) with the
split plan bounded by the longest context, by the block tables'
capacity and by 0 (one split, which must take every tile), against
``scaled_dot_product_attention`` over gathered dense K/V; and the ragged
and window kernels at head_dim 256 (phase 12's heads).
It holds the selective scan (which stands in for the TPU
``selective_scan``) against its plain version in fp32, where the two must
be equal bit for bit, at phase 10's shapes (a 4096-token wave of 8
segments of 512 and a 32-row decode step, over 5120 x 16 columns) and at
a ragged edge; no single PyTorch call computes the recurrence, so it has
no library yardstick. It holds the native-int4 GEMM (which stands in for
``w4a16_int4_matmul_pallas``) in bf16 and fp32 at the Llama-3.1-8B layer's
four GEMMs at M = 128, 65 and 256, timed at M = 128 (time a call, device
and host time) and at 32 beside the packed W4 kernel on the same weights,
with ``torch._weight_int4pack_mm`` and a dense bf16 ``torch.matmul`` of the
dequantized weights as yardsticks; the bf16 kernel of ``csrc/w4_wgmma.cu``
in its four layouts, int4 and packed at ``W4_CASES`` (M 1-256, groups
32-256, a ragged N, forced K splits, both forms of the zero), uint4 and w8
at ``BYTE_CASES`` (the same, groups up to K, w8's bytes -128 and 127 in
every column, and the shapes of phases 15 and 16), two launches bit-equal,
and the W8 and uint4 GEMMs timed at a layer of phase 15's and 16's shapes
(time a call, device and host time, beside ``torch._weight_int8pack_mm``
/ ``_weight_int4pack_mm`` and a dense bf16 ``torch.matmul``); the
shared-prefix pass (``shared_prefix_attention``) in
bf16 and fp32 at phase 14's decode step (R 128, 32 / 8 heads of 128, S =
1024; also S = 1000 and 64, where one split takes every key), against
``scaled_dot_product_attention`` over the gathered shared
K/V (which returns the normalized output, not the state); and the window
kernel started from that state against the window kernel over the whole
context, timed with and without the cascade. It holds the ragged and window
kernels, in bf16 (tensor cores) and fp32, where their masks bite: head_dim
256 with soft cap 50 and a 256-token sliding window over ~1030-token
contexts, chunked attention (256) at head_dim 128, 16-token pages with
work items that start mid-page and query lengths that are not a multiple
of block_q, and (the window) one request at an 8192-token context, which
the split plan cuts into many splits. For the FP8 slice it holds every
attention kernel at its geometries above on e4m3 and e5m2 caches, in bf16
and fp32 (the window's tails e4m3 beside e4m3, bf16 beside e5m2), timing
the 8B path's (bf16) and Qwen2.5-1.5B's (fp32) instances beside their
bf16-cache selves; kFp8 at ``FP8_CASES`` (its e4m3 bytes holding +-448,
+-2^-9 and +-0 in every column) with and without the row scales, two
launches bit-equal; every finite e4m3 byte through kFp8 and the fp32
kernel exactly (identity x, unit scales: ``check_fp8_bytes``);
``fp8_matmul`` at a Llama-3.1-8B layer's four GEMMs (bf16, beside a dense
bf16 matmul, its library yardstick, and, with row scales,
``torch._scaled_mm`` with row-wise scales) and a Qwen2.5-1.5B layer's
(fp32); and whether ``torch._int_mm``
takes M <= 16 (``int8_matmul`` on the card == on the CPU).

For the sampler slice phase 2 holds the Gumbel-max kernel (seeded
threefry noise and the masked argmax, which XLA fuses in JAX) at R in
(1, 32, 128) x V in (151936, 128256), with top-k masked rows and an all
-inf row: its noise bits and uniforms equal to the plain stream's, its
Gumbel values within ``GUMBEL_ULPS`` ulps, its tokens equal but at gaps
< ``NOISE_GAP``; timed at phase 20's shape beside the plain version and
``torch.multinomial`` over the same probabilities (another stream), its
bound the int32 operations at the card's INT32 rate (``int32_ops_per_s``).
And the token-history pass (``check_history``: DRY, the penalties and
no-repeat-ngram in one launch) at R = 32, L in (1024, 2048) on random,
periodic and phase-20-like histories, at R = 128, at the longest L phase
20's engine builds, with one stage on alone, and on device-memory tables
(L = 8192 at R = 48, L = 32768): equal to the plain version bit for bit
(or DRY's power within 1 ulp); timed at phase 20's shape beside the plain
version, with the launches of both and the pass's peak allocation with
the logits handed over; no library call.

For the vision slice phase 2 holds the ragged kernel with image spans
against its plain version in bf16 (the tensor-core instance's span switch)
and fp32 (the scalar instance's span branch): at phase 26's wave (timed
beside ``scaled_dot_product_attention`` with (causal OR span) as a boolean
mask, and in bf16 beside the same wave without spans), at
``SPAN_RAGGED_CASES`` (spans across 32/64-key tiles, work items and a
warp's rows; later chunks whose span began earlier or runs past the keys
written; two spans in a request beside requests without; a 64-key window
shorter than a span; a soft cap on 16-token pages; head_dim 64, 128 and
256), and in bf16 on an e4m3 cache.

For the slice of the ragged kernel's last options phase 2
(``ragged_option_checks``) holds, each against its plain version and
every launch counted by the library it came from (``only_source``): the
fp16 span instances (``csrc/ragged_spans_f16.cu``) at phase 26's wave on
fp16, e4m3 and e5m2 caches, timed beside the bf16 selves, SDPA in fp16
with (causal OR span) as a boolean mask and the bound, and at
``SPAN_RAGGED_CASES`` (head_dim 32: the scalar instance in fp16); ALiBi
beside spans on the tensor-core span instances in bf16 and fp16
(``ALIBI_SPAN_CASES``: head_dim 64, 128 and 256, with and without a soft
cap; phase 26's wave with its heads' slopes, timed beside spans alone);
and the MLA option instances (``csrc/mla_opts.cu``,
``csrc/mla_opts_f16.cu``) in bf16 and fp16 on three caches at
``MLA_SPAN_CASES`` and ``MLA_ALIBI_CASES`` (V2-Lite's 16 and V3's 128
heads, pages of 16 and 64, a sliding window and a soft cap, NaN in the
stale slots), two launches bit-equal; V2-Lite's wave with a 256-token span
a request (``V2L_SPAN_WAVE``) timed beside the instances without options
in the same call, SDPA on expanded K/V with the mask and the bound; the
same wave without options on the option instances
(``option_instances``), and in bf16 with ALiBi.

For the ALiBi slice phase 2 holds the ragged kernel with the model's
slopes (``alibi_slopes``) against its plain version in bf16 (the
tensor-core instance's ALiBi switch) and fp32 (the scalar one): at phase
22's wave (timed beside ``scaled_dot_product_attention`` with the bias as a
float mask, and in bf16 beside the same wave without ALiBi), and at
``ALIBI_RAGGED_CASES`` (group 8 over later chunks, a soft cap at groups 1
and 8, head_dim 64 on 16-token pages, head_dim 256 with a cap); and the
decode kernel at phase 22's step (``DECODE_CASES["baichuan2-13b-alibi"]``;
every ALiBi case takes ``alibi_slopes(nq)``).

For the slice of the tensor-core routes at other geometries phase 2
(``tc_route_checks``) holds, in bf16 and fp16 on caches of q's dtype, e4m3
and e5m2, the ragged kernel at head dims 32, 48, 80, 96 and 112
(``TC23_RAGGED_CASES``: causal, ALiBi, image spans, a soft cap with a
window on 16-token pages, group 18) and the decode kernel at head dims
80, 96 and 112 and groups 18 and 71 (``TC23_DECODE_CASES``, with and
without ALiBi), every launch on the tensor-core instances, each against
its plain version; then times in bf16 BLOOM-3b's and MPT-30B's waves and
steps and Falcon-7B's wave and step, each beside the same call on the
scalar or CUDA-core instance (the "before", launched directly through
``scalar_instances``), SDPA, the bound and the plain version.

The last lines are the kernels' JSON record (one row per kernel and path
that runs it, with that path's launches and shapes), the card line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM (NVIDIA data sheet)
PEAK_OPS = {"bfloat16": 989e12,  # dense bf16 tensor cores
            "float16": 989e12,   # dense fp16 tensor cores
            "float32": 67e12}    # fp32 outside the tensor cores
PAGE, HD = 64, 128
# max-abs, outputs are O(1); fp16 keeps 3 more bits than bf16 (P and the
# output rounded at 2^-11 rather than 2^-8): 5e-3.
TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 5e-3}

LLAMA31_8B = dict(  # meta-llama/Llama-3.1-8B config.json
    vocab_size=128256, hidden_size=4096, num_hidden_layers=32,
    num_attention_heads=32, num_key_value_heads=8, head_dim=128,
    intermediate_size=14336, rms_norm_eps=1e-5, rope_theta=500000.0,
    rope_scaling={"rope_type": "llama3", "factor": 8.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192},
    max_position_embeddings=131072, tie_word_embeddings=False,
    architectures=["LlamaForCausalLM"])
# Phases 14 and 18 serve Llama-3.1-8B at half its depth (16 of its 32
# layers) and phase 15 at a quarter (8), which keeps the script inside its
# time limit as it grows: phases 6 and 31 serve the same model at full
# depth, every layer runs the same kernels, and each launch count is
# reckoned for the depth served.
LLAMA31_8B_HALF = dict(LLAMA31_8B, num_hidden_layers=16)
LLAMA31_8B_QUARTER = dict(LLAMA31_8B, num_hidden_layers=8)
# (K, N) of a layer's four GEMMs with QKV and gate/up fused, M = 32.
LLAMA8B_GEMMS = {"qkv": (4096, 6144), "o": (4096, 4096),
                 "gate_up": (4096, 28672), "down": (14336, 4096)}
QWEN_GEMMS = {"qkv": (1536, 2048), "o": (1536, 1536),
              "gate_up": (1536, 17920), "down": (8960, 1536)}
QWEN25_7B = dict(  # Qwen/Qwen2.5-7B config.json
    vocab_size=152064, hidden_size=3584, num_hidden_layers=28,
    num_attention_heads=28, num_key_value_heads=4, intermediate_size=18944,
    max_position_embeddings=131072, rope_theta=1000000.0, rms_norm_eps=1e-6,
    tie_word_embeddings=False, use_sliding_window=False,
    architectures=["Qwen2ForCausalLM"])
# Phase 16's layers: half the published 28, which keeps the script inside
# its time limit (every layer runs the same kernels).
QWEN25_7B_QUARTER = dict(QWEN25_7B, num_hidden_layers=7)
# Every projection stays unpacked under gptq's group of 128 ((K/2) % 1024
# != 0 at K = 3584 and 18944): all run the uint4 layout.
QWEN7B_GEMMS = {"qkv": (3584, 4608), "o": (3584, 3584),
                "gate_up": (3584, 37888), "down": (18944, 3584)}
QUANT_KERNELS = {  # name: (replaces, shapes)
    "w4a16_packed_matmul": (
        "aphrodite_tpu/ops/quant_matmul_pallas.py:206", LLAMA8B_GEMMS),
    "w4a16_matmul": (
        "aphrodite_tpu/ops/quant_matmul_pallas.py:119", QWEN_GEMMS),
    "w8a16_matmul": (
        "aphrodite_tpu/ops/quant_matmul_pallas.py:50", QWEN_GEMMS),
}
# The paths of the byte layouts (phases 15 and 16): name -> (path, shapes).
BYTE_PATHS = {"w8a16_matmul": ("llama-3.1-8b-w8a16", LLAMA8B_GEMMS),
              "w4a16_matmul": ("qwen2.5-7b-gptq", QWEN7B_GEMMS)}
# Phase 14: 128 requests x (1024 shared + 128 own) tokens, 64 generated.
CASCADE_R, CASCADE_S, CASCADE_SUFFIX, CASCADE_DECODE = 128, 1024, 128, 64

# Attention shapes of each path's run: heads, one prefill wave's (context,
# query) lengths per request, one decode window's paged lengths.
ATTN_GEOMS = {
    "qwen2.5-1.5b-bf16": dict(  # phase 4: 28 prompts + 4 decode rows
        nq=12, kvh=2, ctx=[500] * 28 + [521, 527, 533, 540],
        qlen=[500] * 28 + [1] * 4,
        paged=[500 + (37 * r) % 51 for r in range(32)]),
    "llama-3.1-8b-w4a16": dict(  # phases 6 and 15: 32 x 512 in one wave
        nq=32, kvh=8, ctx=[512] * 32, qlen=[512] * 32, paged=[512] * 32),
    "qwen2.5-7b-gptq": dict(  # phase 16: 32 x 512, 7 query heads a KV head
        nq=28, kvh=4, ctx=[512] * 32, qlen=[512] * 32, paged=[512] * 32),
    "qwen1.5-moe-a2.7b-bf16": dict(  # phase 8: 32 x 512 in one wave
        nq=16, kvh=16, ctx=[512] * 32, qlen=[512] * 32, paged=[512] * 32),
    # phase 12: 32 x 512 in one wave at head_dim 256 (bf16: the ragged
    # kernel's 64-row tensor-core items; Gemma decodes on the decode
    # kernel, so the window kernel is held here only)
    "gemma-2-9b-bf16": dict(
        nq=16, kvh=8, hd=256, ctx=[512] * 32, qlen=[512] * 32,
        paged=[512] * 32),
    # phase 14: 128 x 128 new tokens over 1152-token contexts in one wave;
    # the window kernel here over the whole context (no cascade)
    "llama-3.1-8b-int4-cascade": dict(
        nq=32, kvh=8, ctx=[1152] * 128, qlen=[128] * 128,
        paged=[1152] * 128),
}

# Where the ragged kernel's masks bite (phase 2, bf16 and fp32, against the
# plain version only): Gemma-2-9B heads at head_dim 256 with soft cap 50 and
# a 256-token sliding window over ~1030-token contexts (whole prompts and
# later chunks); chunked attention at the 8B heads; Qwen2.5-1.5B heads on
# 16-token pages with items that start mid-page and query lengths that are
# no multiple of block_q (21 tokens at group 6 in bf16).
_LONG = [1000 + (37 * r) % 64 for r in range(8)]
RAGGED_MASK_CASES = {
    "hd256-softcap-window256": dict(
        nq=16, kvh=8, hd=256, ctx=_LONG, qlen=_LONG[:4] + [200, 77, 1, 64],
        opts=dict(logits_soft_cap=50.0, sliding_window=256)),
    "hd128-chunk256": dict(
        nq=32, kvh=8, ctx=_LONG, qlen=_LONG[:4] + [300, 129, 1, 40],
        opts=dict(chunk_attn=256)),
    "page16-mid-page": dict(
        nq=12, kvh=2, page=16, ctx=[517, 300, 45, 1000],
        qlen=[100, 299, 44, 333]),
}
# The same masks for the window kernel, plus one request at an 8192-token
# context, which the split plan cuts into many splits.
WINDOW_MASK_CASES = {
    "hd256-softcap-window256": dict(
        nq=16, kvh=8, hd=256, paged=[1000 + (37 * r) % 64 for r in range(32)],
        opts=dict(logits_soft_cap=50.0, sliding_window=256)),
    "hd128-chunk256": dict(
        nq=32, kvh=8, paged=[1000 + (37 * r) % 64 for r in range(32)],
        opts=dict(chunk_attn=256)),
    "page16": dict(nq=12, kvh=2, page=16,
                   paged=[500 + (37 * r) % 51 for r in range(32)]),
    "context-8192": dict(nq=32, kvh=8, paged=[8192]),
}

QWEN15_MOE_A27B = dict(  # Qwen/Qwen1.5-MoE-A2.7B config.json
    vocab_size=151936, hidden_size=2048, num_hidden_layers=24,
    num_attention_heads=16, num_key_value_heads=16, intermediate_size=5632,
    moe_intermediate_size=1408, shared_expert_intermediate_size=5632,
    num_experts=60, num_experts_per_tok=4, norm_topk_prob=False,
    decoder_sparse_step=1, mlp_only_layers=[], rope_theta=1000000.0,
    rms_norm_eps=1e-6, max_position_embeddings=8192, use_sliding_window=False,
    tie_word_embeddings=False, architectures=["Qwen2MoeForCausalLM"])
# Phase 8's layers: half the published 24 (every layer is a MoE layer
# with the same kernels), to keep the script inside its time limit.
QWEN15_MOE_QUARTER = dict(QWEN15_MOE_A27B, num_hidden_layers=6)
# (K, N) of a MoE layer's two grouped GEMMs (gate|up fused on N).
MOE_GEMMS = {"gate_up": (2048, 2 * 1408), "down": (1408, 2048)}
MOE_E, MOE_K = 60, 4

MAMBA_2P8B = dict(  # state-spaces/mamba-2.8b-hf config.json
    vocab_size=50280, hidden_size=2560, num_hidden_layers=64,
    intermediate_size=5120, state_size=16, conv_kernel=4,
    time_step_rank=160, use_conv_bias=True, use_bias=False,
    layer_norm_epsilon=1e-5, tie_word_embeddings=True, model_type="mamba",
    architectures=["MambaForCausalLM"])
SCAN_COLUMNS = 5120 * 16  # d_inner x d_state of a Mamba-2.8B layer
# Phase 10's layers: a quarter of the published 64, which keeps the
# script's time inside its limit as it grows (every layer runs the same
# scan).
MAMBA_DEPTH = 16

QWEN25_1P5B = dict(
    vocab_size=151936, hidden_size=1536, num_hidden_layers=28,
    num_attention_heads=12, num_key_value_heads=2, intermediate_size=8960,
    max_position_embeddings=4096, rope_theta=1000000.0, rms_norm_eps=1e-6,
    tie_word_embeddings=True, use_sliding_window=False,
    architectures=["Qwen2ForCausalLM"])


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: the kernels it launches, summed
    from a profiler trace of ``reps`` calls (without the host's time
    between launches, which ``cuda_ms`` sees when the host is slower). A
    trace that comes back without device events is taken again (up to
    five times); if none has any (the profiler's CUPTI trace has come back
    empty on that machine), the call is timed with CUDA events instead
    (``cuda_ms``) and the log says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ns = sum(e.end_ns() - e.start_ns()
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA)
        if ns > 0:
            return ns / 1e6 / reps
    log("# device_ms: five traces without a device event; timed with CUDA "
        "events instead")
    return cuda_ms(fn, reps)


def bound_ms(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_cache(gen, ctx_lens, dtype, kvh, num_layers=2, hd=HD, page=PAGE):
    """Random [L, P, 2, kvh, page, hd] cache (in ``dtype``: q's, or an fp8
    cache's) and shuffled block tables covering ctx_lens tokens per
    request."""
    import torch
    pages_per = [-(-n // page) for n in ctx_lens]
    max_pages = max(pages_per)
    num_pages = sum(pages_per) + 1
    cache = torch.randn((num_layers, num_pages, 2, kvh, page, hd),
                        generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    bt = torch.zeros((len(ctx_lens), max_pages), dtype=torch.int32,
                     device="cuda")
    o = 0
    for r, n in enumerate(pages_per):
        bt[r, :n] = perm[o:o + n].int()
        o += n
    return cache, bt


def poison_stale(cache, bt, lens) -> None:
    """NaN in every slot of ``cache`` [L, P, 2, kvh, page, hd] past each
    request's length in its last page, and in the null page 0 (block table
    entries past a request's pages): what a kernel that loads whole pages
    or boxes finds there in a real cache, where those slots were never
    written. Only masked keys lie there."""
    page = cache.shape[-2]
    cache[:, 0] = float("nan")
    for r, n in enumerate(lens):
        pg, off = divmod(int(n), page)
        if off:
            cache[:, int(bt[r, pg]), :, :, off:] = float("nan")


def kv_type(dtype, kv: str | None):
    """The cache's torch dtype: ``kv`` (an fp8 name) or q's ``dtype``."""
    import torch
    return dtype if kv is None else getattr(torch, kv)


def kv_label(kv: str | None) -> str:
    return "" if kv is None else f", {kv} cache"


def dense_kv(cache_layer, bt, ctx_lens, s_max):
    """Gather each request's K/V into dense [R, kvh, s_max, hd] (the
    library yardstick's operands; an fp8 cache's upcast by the caller)."""
    R, kvh, hd = len(ctx_lens), cache_layer.shape[2], cache_layer.shape[-1]
    kv = cache_layer[bt.long()]                 # [R, MP, 2, kvh, page, hd]
    kv = kv.permute(0, 2, 3, 1, 4, 5).reshape(R, 2, kvh, -1, hd)
    return kv[:, 0, :, :s_max].contiguous(), kv[:, 1, :, :s_max].contiguous()


def check_ragged(gen, dtype_name: str, geom: dict, timed: bool = True,
                 kv: str | None = None, make_cache=None,
                 before: bool = False):
    """Kernel A on one prefill/mixed wave (``ATTN_GEOMS``, or a case of
    ``RAGGED_MASK_CASES`` or ``ALIBI_RAGGED_CASES`` with its page size,
    masks and ALiBi), on a cache of q's dtype or of the fp8 dtype ``kv``:
    its error against the plain version, and at a path's shapes the times
    (the yardstick's K/V upcast to q's dtype once, outside the timing; the
    bound's K/V bytes the cache's; with ALiBi the yardstick takes the bias
    as a float mask, and the bound counts its multiply-add a score; with
    image spans, ``geom["spans"]`` a list of (lo, hi) a request, the
    yardstick's mask is (causal OR inside one span) below the context and
    the bound counts the keys each row sees). The MLA instance on an fp8
    cache must equal its self on the cache upcast to q's dtype (bf16 or
    fp16), bit for bit. The limit is TOL, or ``large_tol`` row by row with
    ALiBi and at the MLA geometry on an fp8 cache or with image spans (rows
    that see a few keys give a few V rows' values, past 1). With spans, at
    a path's shapes, the plain version without them (what a kernel that
    ignored the spans would give) must break that limit, and its error is
    returned (``blind_err``, ``blind_over``: the values past the limit).
    ``make_cache``: ``paged_cache``'s stand-in (``OneAllocation``).
    ``before``: also the same call on the scalar instance, launched
    directly (``scalar_instances``), timed (``before_ms``,
    ``before_device_ms``) and held to the same limit."""
    import torch
    import torch.nn.functional as F
    from aphrodite_tpu_torch.attention.backend import alibi_slopes
    from aphrodite_tpu_torch.attention.metadata import (AttentionMetadata,
                                                        build_work_items)
    from aphrodite_tpu_torch.ops import cuda_build
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention, ragged_work_item_tokens,
        ref_ragged_paged_attention)
    dtype = getattr(torch, dtype_name)
    NQ, KVH, ctx, qn = geom["nq"], geom["kvh"], geom["ctx"], geom["qlen"]
    HD = geom.get("hd", 128)
    opts = dict(geom.get("opts", {}))
    if geom.get("alibi"):  # the model's slopes: alibi_slopes(nq)
        opts["alibi"] = alibi_slopes(NQ).cuda()
    spans = geom.get("spans")
    kvd = kv_type(dtype, kv)
    cache, bt = (make_cache or paged_cache)(gen, ctx, kvd, KVH, hd=HD,
                                            page=geom.get("page", PAGE))
    R, T = len(ctx), sum(qn)
    qsl = np.concatenate([[0], np.cumsum(qn)]).astype(np.int32)
    tok_req = np.repeat(np.arange(R), qn).astype(np.int32)
    tok_pos = np.concatenate([np.arange(c - n, c) for c, n in zip(ctx, qn)])
    block_q = ragged_work_item_tokens(dtype, NQ // KVH, HD,
                                      cuda_build.smem_optin(), kvd)
    items = build_work_items(qsl[:-1], np.diff(qsl),
                             np.asarray(ctx, np.int32), R, block_q)
    dev = lambda a: torch.from_numpy(np.asarray(a)).cuda()  # noqa: E731
    md = AttentionMetadata(
        token_req_idx=dev(tok_req), token_pos=dev(tok_pos.astype(np.int32)),
        slot_mapping=None,
        seq_lens=dev(np.asarray(ctx, np.int32)), block_tables=bt,
        block_q=block_q,
        mm_bidir_spans=span_rows(spans) if spans is not None else None,
        **{k: dev(v) for k, v in items.items()})
    q = torch.randn((T, NQ, HD), generator=gen, device="cuda").to(dtype)
    scale = geom.get("scale", HD ** -0.5)
    layer = 1
    ref = ref_ragged_paged_attention(q, cache[layer], md, scale, **opts)
    if geom.get("stale"):  # the plain version read the clean cache
        poison_stale(cache, bt, ctx)
    out = ragged_paged_attention(q, cache, layer, md, scale, **opts)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    mla16 = geom.get("mla") and dtype in (torch.bfloat16, torch.float16)
    if mla16 and not torch.equal(
            out, ragged_paged_attention(q, cache, layer, md, scale, **opts)):
        raise AssertionError("ragged MLA instance: two launches differ")
    if mla16 and kv is not None and not torch.equal(
            out, ragged_paged_attention(q, cache.to(dtype), layer, md, scale,
                                        **opts)):
        raise AssertionError(f"ragged MLA instance {dtype_name} on a {kv} "
                             f"cache: not its {dtype_name}-cache self on the "
                             "upcast cache, bit for bit")
    scaled = "alibi" in opts or (geom.get("mla") and (
        kv is not None or spans is not None))
    limit = large_tol(dtype_name, ref) if scaled else TOL[dtype_name]
    over = int((diff > limit).sum())
    del diff
    if not (over == 0 and torch.isfinite(out).all()):
        raise AssertionError(
            f"ragged kernel {dtype_name}{kv_label(kv)} "
            f"{'alibi' if 'alibi' in opts else opts}: max_abs_err {err}, "
            f"{over} values past the limit (TOL {TOL[dtype_name]}"
            f"{' x max(1, max|ref row|)' if scaled else ''})")
    if not timed:
        return err
    blind = {}
    if spans is not None:  # the limit must fail a kernel blind to spans
        md0 = dataclasses.replace(md, mm_bidir_spans=None)
        d0 = (ref_ragged_paged_attention(q, cache[layer], md0, scale, **opts)
              .float() - ref.float()).abs()
        blind = dict(blind_err=d0.max().item(),
                     blind_over=int((d0 > limit).sum()))
        del d0, md0
        if blind["blind_over"] == 0:
            raise AssertionError(
                f"ragged kernel {dtype_name}{kv_label(kv)} with spans: the "
                f"plain version without spans is within the limit "
                f"(max_abs_err {blind['blind_err']:.3g}): the check cannot "
                "see the span mask")
    ms = cuda_ms(lambda: ragged_paged_attention(q, cache, layer, md, scale,
                                                **opts), 20)
    dev_ms = device_ms(lambda: ragged_paged_attention(
        q, cache, layer, md, scale, **opts), 10)
    if before:  # the scalar instance on the same items
        with scalar_instances(), only_instance(
                ragged_paged_attention, "scalar", "ragged before"):
            out0 = ragged_paged_attention(q, cache, layer, md, scale, **opts)
            torch.cuda.synchronize()
            over0 = int(((out0.float() - ref.float()).abs() > limit).sum())
            if over0:
                raise AssertionError(f"ragged scalar instance: {over0} "
                                     "values past the limit")
            blind["before_ms"] = cuda_ms(lambda: ragged_paged_attention(
                q, cache, layer, md, scale, **opts), 5)
            blind["before_device_ms"] = device_ms(
                lambda: ragged_paged_attention(q, cache, layer, md, scale,
                                               **opts), 3)
        del out0
    plain_ms = cuda_ms(lambda: ref_ragged_paged_attention(
        q, cache[layer], md, scale, **opts), 2)
    # Library yardstick: one SDPA call over the wave padded to a dense
    # [R, nq, max qlen, hd] batch with a [R, 1, max qlen, S] mask.
    s_max, lq = max(ctx), max(qn)
    k_d, v_d = (t.to(dtype) for t in dense_kv(cache[layer], bt, ctx, s_max))
    q_d = torch.zeros((R, NQ, lq, HD), dtype=dtype, device="cuda")
    mask = torch.zeros((R, 1, lq, s_max), dtype=torch.bool, device="cuda")
    kv_pos = torch.arange(s_max, device="cuda")
    dist = torch.zeros((R, 1, lq, s_max), device="cuda")
    for r in range(R):
        a, b = int(qsl[r]), int(qsl[r + 1])
        q_d[r, :, :b - a] = q[a:b].transpose(0, 1)
        pos = torch.arange(ctx[r] - (b - a), ctx[r], device="cuda")
        mask[r, 0, :b - a] = kv_pos[None, :] <= pos[:, None]
        for lo, hi in (spans[r] if spans is not None else ()):
            mask[r, 0, :b - a] |= (((pos >= lo) & (pos < hi))[:, None]
                                   & ((kv_pos >= lo) & (kv_pos < hi)
                                      & (kv_pos < ctx[r]))[None, :])
        dist[r, 0, :b - a] = (kv_pos[None, :] - pos[:, None]).float()
    vis = (int(mask.sum()) if spans is not None   # the keys each row sees
           else sum(int(p) + 1 for p in tok_pos))
    if "alibi" in opts:  # [R, nq, lq, S] bias, -inf where masked
        mask = torch.where(mask, opts["alibi"][None, :, None, None] * dist,
                           float("-inf")).to(dtype)
    del dist
    gqa = not geom.get("mla")
    if not gqa:  # the fused backends take one K/V head a query head only
        k_d, v_d = (t.expand(-1, NQ, -1, -1) for t in (k_d, v_d))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q_d, k_d, v_d, attn_mask=mask, scale=scale, enable_gqa=gqa)
    lib_ms = cuda_ms(sdpa, 5)
    lib_dev_ms = device_ms(sdpa, 5)
    backends = (None if gqa else
                sdpa_backends(sdpa, q_d, k_d, v_d, mask, scale))
    item = torch.finfo(dtype).bits // 8
    nbytes = (item * 2 * T * NQ * HD
              + kvd.itemsize * 2 * KVH * HD * sum(ctx)
              + (4 * NQ if "alibi" in opts else 0)
              + (md.mm_bidir_spans.nbytes if spans is not None else 0))
    ops = (4.0 * HD + (2 if "alibi" in opts else 0)) * NQ * vis
    b_ms, b_by = bound_ms(nbytes, ops, dtype_name)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                library_device_ms=lib_dev_ms, sdpa_backends=backends,
                **blind)


def blind_text(r: dict) -> str:
    """How the check of a timed wave with spans reads against the plain
    version without them (``check_ragged``'s ``blind_err``)."""
    return (f"the plain version without spans reads max_abs_err "
            f"{r['blind_err']:.3g}, {r['blind_over']} values past the limit")


def sdpa_backends(sdpa, q, k, v, mask, scale) -> str:
    """Which backend SDPA's dispatch picks for this call (K/V expanded to
    the query heads: ``torch._fused_sdp_choice``) and which of its
    backends take the call, each tried alone: MLA's head_dim 576 is past
    the flash backend's 256."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    took, refused = [], []
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
              SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]):
                sdpa()
            torch.cuda.synchronize()
            took.append(b.name)
        except RuntimeError:
            refused.append(b.name)
    try:
        pick = SDPBackend(torch._fused_sdp_choice(
            q, k, v, mask, 0.0, False, scale=scale)).name
    except Exception as e:  # noqa: BLE001 (a private entry point)
        pick = f"not read ({e!r:.80})"
    return f"picks {pick}; takes {took}; refuses {refused}"


def large_tol(dtype_name: str, ref):
    """The error limits of a ragged output that may hold single V rows, one
    a row (a query token's head): TOL scaled to the reference row's largest
    value where that is above 1, TOL itself elsewhere. With ALiBi a steep
    slope puts a row's weight on its nearest keys, and at the MLA geometry
    V3's early rows and the first rows of an image span see a few keys
    each, so such a row is one V row rather than an average (values past 4
    on randn V, where one bf16 ulp is 0.031 and the kernel's and the plain
    version's roundings may part by one; e5m2 rounds such values up to 4
    or 5); the rows that average many keys keep TOL."""
    return TOL[dtype_name] * ref.float().abs().amax(
        -1, keepdim=True).clamp(min=1.0)


def scaled_tol(dtype_name: str, ref) -> float:
    """The error limit of a decode or window output: TOL scaled to the
    reference's largest value where that is below 1. A long context
    averages many values into a small output (~0.06 at 8192 keys), where
    an unscaled limit would pass a kernel that lost whole tiles or
    splits."""
    return TOL[dtype_name] * min(1.0, ref.float().abs().max().item())


def tol_text(name: str, dtype_name: str) -> str:
    """How a kernel's error limit reads in the log."""
    if name in ("window_decode_attention", "decode_paged_attention"):
        return f"{TOL[dtype_name]} x min(1, max|ref|)"
    return str(TOL[dtype_name])


def host_ms(fn, reps: int = 50) -> float:
    """Host time of one call of ``fn`` (launches enqueued, not waited)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def check_window(gen, dtype_name: str, geom: dict, timed: bool = True,
                 kv: str | None = None, make_cache=None):
    """Kernel B on one decode window (``ATTN_GEOMS``, or a case of
    ``WINDOW_MASK_CASES``), on a cache of q's dtype or of the fp8 dtype
    ``kv`` with tails in ``tail_dtype`` of it (e4m3 beside e4m3, bf16
    beside e5m2): its paged lengths with a 64-slot tail, at
    several window steps, each held at ``scaled_tol``, with the split plan
    bounded by the longest paged length as the runner bounds it, by the
    block tables' capacity, and by 0 (one split, which must take every
    tile); at a path's shapes also the times, with the plan made once as
    the runner makes it. The MLA instance on an fp8 cache must equal its
    self on the cache and tails upcast to q's dtype (bf16 or fp16), bit for
    bit, at every step and plan. ``make_cache``: ``paged_cache``'s
    stand-in."""
    import torch
    import torch.nn.functional as F
    from aphrodite_tpu_torch.ops.window_decode_attention import (
        ref_window_decode_attention, tail_dtype, window_decode_attention,
        window_plan)
    dtype = getattr(torch, dtype_name)
    NQ, KVH, plens = geom["nq"], geom["kvh"], geom["paged"]
    HD = geom.get("hd", 128)
    opts = geom.get("opts", {})
    R, Kw, layer = len(plens), 64, 1
    kvd = kv_type(dtype, kv)
    cache, bt = (make_cache or paged_cache)(
        gen, [p + Kw for p in plens], kvd, KVH, hd=HD,
        page=geom.get("page", PAGE))
    tail_k = torch.randn((2, R, KVH, Kw, HD), generator=gen,
                         device="cuda").to(tail_dtype(kvd))
    tail_v = torch.randn((2, R, KVH, Kw, HD), generator=gen,
                         device="cuda").to(tail_dtype(kvd))
    q = torch.randn((R, NQ, HD), generator=gen, device="cuda").to(dtype)
    pl = torch.tensor(plens, dtype=torch.int32, device="cuda")
    scale = geom.get("scale", HD ** -0.5)
    plan = lambda bound: window_plan(  # noqa: E731
        dtype, R, NQ, KVH, HD, q.device, bound, Kw - 1,
        sliding_window=opts.get("sliding_window"),
        chunk_attn=opts.get("chunk_attn"), kv_dtype=kvd)
    plans = {"the longest paged length": plan(max(plens)),
             "the block tables": None, "0": plan(0)}
    stale = geom.get("stale")
    clean = (cache.clone(), tail_k, tail_v) if stale else None
    if stale:  # page slots past the paged lengths and the null page
        poison_stale(cache, bt, plens)
    # The 16-bit self of an fp8 MLA instance: the upcast cache, its own
    # plans.
    mla16 = geom.get("mla") and dtype in (torch.bfloat16, torch.float16)
    upcast = mla16 and kv is not None
    up_cache = cache.to(dtype) if upcast else None
    err = 0.0
    for step in (0, 1, 31, 48, 63):
        if stale:  # and the tail's slots past the step
            tail_k, tail_v = (t.clone() for t in clean[1:])
            tail_k[:, :, :, step + 1:] = tail_v[:, :, :, step + 1:] = \
                float("nan")
        src = clean if stale else (cache, tail_k, tail_v)
        ref = ref_window_decode_attention(q, src[0][layer], src[1][layer],
                                          src[2][layer], step, pl, bt, scale,
                                          **opts)
        limit = scaled_tol(dtype_name, ref)
        for bound, p in plans.items():
            out = window_decode_attention(q, cache, tail_k, tail_v, layer,
                                          step, pl, bt, scale, plan=p,
                                          **opts)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise AssertionError("window kernel: non-finite output")
            if mla16 and not torch.equal(out, window_decode_attention(
                    q, cache, tail_k, tail_v, layer, step, pl, bt, scale,
                    plan=p, **opts)):
                raise AssertionError("window MLA instance: two launches "
                                     "differ")
            if upcast and not torch.equal(out, window_decode_attention(
                    q, up_cache, tail_k.to(dtype), tail_v.to(dtype), layer,
                    step, pl, bt, scale,
                    plan=p and p._replace(kv_dtype=dtype), **opts)):
                raise AssertionError(
                    f"window MLA instance {dtype_name} on a {kv} cache, step "
                    f"{step}, plan bounded by {bound}: not its "
                    f"{dtype_name}-cache self on the upcast cache and tails, "
                    "bit for bit")
            e = (out.float() - ref.float()).abs().max().item()
            if e > limit:
                raise AssertionError(
                    f"window kernel {dtype_name}{kv_label(kv)} {opts} step "
                    f"{step}, plan bounded by {bound}: max_abs_err {e} > "
                    f"{limit:.3g} (TOL scaled to the output)")
            err = max(err, e)
    if not timed:
        return err
    step = 24  # the middle of a 49-step window
    path_plan = plans["the longest paged length"]
    win = lambda: window_decode_attention(  # noqa: E731
        q, cache, tail_k, tail_v, layer, step, pl, bt, scale, plan=path_plan)
    ms = cuda_ms(win, 200)
    dev_ms = device_ms(win, 50)
    host = host_ms(win)
    plain_ms = cuda_ms(lambda: ref_window_decode_attention(
        q, cache[layer], tail_k[layer], tail_v[layer], step, pl, bt, scale),
        5)
    # Library yardstick: SDPA over dense [R, kvh, S + Kw, hd] with a mask.
    s_max = max(plens)
    k_p, v_p = dense_kv(cache[layer], bt, plens, s_max)
    k_d = torch.cat([k_p.to(dtype), tail_k[layer].to(dtype)], dim=2)
    v_d = torch.cat([v_p.to(dtype), tail_v[layer].to(dtype)], dim=2)
    j = torch.arange(s_max + Kw, device="cuda")
    mask = torch.where(j[None, :] < s_max, j[None, :] < pl[:, None].long(),
                       (j[None, :] - s_max) <= step)[:, None, None, :]
    q_d = q[:, :, None, :]
    gqa = not geom.get("mla")
    if not gqa:  # the fused backends take one K/V head a query head only
        k_d, v_d = (t.expand(-1, NQ, -1, -1) for t in (k_d, v_d))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q_d, k_d, v_d, attn_mask=mask, scale=scale, enable_gqa=gqa)
    lib_ms = cuda_ms(sdpa, 50)
    lib_dev_ms = device_ms(sdpa, 20)
    backends = (None if gqa else
                sdpa_backends(sdpa, q_d, k_d, v_d, mask, scale))
    item = torch.finfo(dtype).bits // 8
    vis = sum(plens) + R * (step + 1)
    nbytes = (item * 2 * R * NQ * HD + 2 * KVH * HD * (
        kvd.itemsize * sum(plens) + tail_dtype(kvd).itemsize * R * (step + 1)))
    ops = 4.0 * NQ * HD * vis
    b_ms, b_by = bound_ms(nbytes, ops, dtype_name)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                host_ms=host, library_device_ms=lib_dev_ms,
                sdpa_backends=backends)


# Decode kernel cases: (heads, head_dim, context lengths, options). The
# Gemma-2-9B path's decode step (contexts 513-576 while 32 requests decode
# 64 tokens after 512-token prompts; soft cap 50), the same with a 256-token
# sliding window over ~1030-token contexts (so the mask bites), ALiBi and
# chunked local attention at head_dim 128, the Llama-3.1-8B heads (32 /
# 8 of 128, group 4) with no option, and the Baichuan2-13B path's decode
# step (phase 22: 40 / 40 heads of 128 with ALiBi, 32 rows over 513-576
# token contexts).
DECODE_CASES = {
    "gemma-2-9b": (16, 8, 256, [513 + (37 * r) % 64 for r in range(32)],
                   dict(logits_soft_cap=50.0)),
    "gemma-2-9b-window": (16, 8, 256, [1000 + (37 * r) % 64
                                       for r in range(32)],
                          dict(logits_soft_cap=50.0, sliding_window=256)),
    "alibi-hd128": (16, 8, 128, [513 + (37 * r) % 64 for r in range(32)],
                    dict(alibi=True)),
    "chunk-hd128": (16, 8, 128, [1000 + (37 * r) % 64 for r in range(32)],
                    dict(chunk_attn=256)),
    "llama-3.1-8b": (32, 8, 128, [513 + (37 * r) % 64 for r in range(32)],
                     {}),
    "baichuan2-13b-alibi": (40, 40, 128,
                            [513 + (37 * r) % 64 for r in range(32)],
                            dict(alibi=True)),
    "gemma-3-4b": (8, 4, 256, [513 + (37 * r) % 64 for r in range(32)], {}),
}


def check_decode(gen, dtype_name: str, case: str, kv: str | None = None,
                 timed: bool = True, before: bool = False) -> dict:
    """The decode kernel on one case of ``DECODE_CASES``: error against
    its plain version at ``scaled_tol``, with the split plan
    (``decode_plan``) bounded by the longest context, by the block tables'
    capacity and by 0 (one split, which must take every tile); the
    kernel's time a call (CUDA events), its device time
    (profiler) and its host time a call, with the first plan; the plain
    time; the bound (each visible K/V row read once, q read and the output
    written once) and the yardstick, one ``scaled_dot_product_attention``
    call over K/V gathered into dense [R, kvh, S, hd] with the same mask
    (ALiBi as an additive bias; SDPA has no soft cap, so it computes the
    uncapped function there). ``kv``: an fp8 cache's dtype name (the
    yardstick's K/V upcast to q's dtype outside the timing; the bound's
    K/V bytes the cache's). ``before``: also the same call on the CUDA-core
    instance (``dpa_kernel``, its plan made under ``scalar_instances``),
    held to the same limit and timed (``before_ms``,
    ``before_device_ms``)."""
    import torch
    import torch.nn.functional as F
    from aphrodite_tpu_torch.attention.backend import alibi_slopes
    from aphrodite_tpu_torch.ops.decode_paged_attention import (
        decode_paged_attention, decode_plan, ref_decode_paged_attention)
    dtype = getattr(torch, dtype_name)
    nq, kvh, hd, ctx, opts = {**DECODE_CASES, **F16_DECODE_CASES,
                              **TC23_DECODE_CASES}[case]
    opts = dict(opts)
    if opts.pop("alibi", False):  # the model's slopes: alibi_slopes(nq)
        opts["alibi"] = alibi_slopes(nq).cuda()
    R, layer = len(ctx), 1
    kvd = kv_type(dtype, kv)
    cache, bt = paged_cache(gen, ctx, kvd, kvh, hd=hd)
    sl = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    q = torch.randn((R, nq, hd), generator=gen, device="cuda").to(dtype)
    scale = hd ** -0.5
    ref = ref_decode_paged_attention(q, cache[layer], bt, sl, scale, **opts)
    limit = scaled_tol(dtype_name, ref)
    plan = lambda bound: decode_plan(  # noqa: E731
        dtype, R, nq, kvh, hd, q.device, bound, kv_dtype=kvd)
    plans = {"the longest context": plan(max(ctx)),
             "the block tables": None, "0": plan(0)}
    err = 0.0
    for bound, p in plans.items():
        out = decode_paged_attention(q, cache, layer, bt, sl, scale, plan=p,
                                     **opts)
        torch.cuda.synchronize()
        e = (out.float() - ref.float()).abs().max().item()
        if not (e <= limit and torch.isfinite(out).all()):
            raise AssertionError(
                f"decode kernel {case} {dtype_name}{kv_label(kv)}, plan "
                f"bounded by {bound}: max_abs_err {e} > {limit:.3g} (TOL "
                "scaled to the output)")
        err = max(err, e)
    if not timed:
        return dict(max_abs_err=err)
    path_plan = plans["the longest context"]
    dec = lambda: decode_paged_attention(  # noqa: E731
        q, cache, layer, bt, sl, scale, plan=path_plan, **opts)
    ms = cuda_ms(dec, 200)
    dev_ms = device_ms(dec, 50)
    host = host_ms(dec)
    prior = {}
    if before:  # the CUDA-core instance, its own plan
        with scalar_instances():
            p0 = plan(max(ctx))
        dec0 = lambda: decode_paged_attention(  # noqa: E731
            q, cache, layer, bt, sl, scale, plan=p0, **opts)
        e0 = (dec0().float() - ref.float()).abs().max().item()
        if p0.tensor_cores or not e0 <= limit:
            raise AssertionError(f"decode {case}: the CUDA-core instance's "
                                 f"max_abs_err {e0} (limit {limit:.3g})")
        prior = dict(before_ms=cuda_ms(dec0, 20),
                     before_device_ms=device_ms(dec0, 10))
    plain_ms = cuda_ms(lambda: ref_decode_paged_attention(
        q, cache[layer], bt, sl, scale, **opts), 5)
    s_max = max(ctx)
    k_d, v_d = (t.to(dtype) for t in dense_kv(cache[layer], bt, ctx, s_max))
    j = torch.arange(s_max, device="cuda")[None, :]
    pos = (sl.long() - 1)[:, None]
    keep = j <= pos
    if "sliding_window" in opts:
        keep &= j > pos - opts["sliding_window"]
    if "chunk_attn" in opts:
        keep &= j // opts["chunk_attn"] == pos // opts["chunk_attn"]
    mask = keep[:, None, None, :]
    if "alibi" in opts:
        mask = torch.where(mask, opts["alibi"][None, :, None, None]
                           * (j - pos).float()[:, None, None, :],
                           float("-inf")).to(dtype)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[:, :, None, :], k_d, v_d, attn_mask=mask, scale=scale,
        enable_gqa=True)
    lib_ms = cuda_ms(sdpa, 50)
    lib_dev_ms = device_ms(sdpa, 20)
    vis = int(keep.sum().item())   # K/V rows this run's masks let in
    item = torch.finfo(dtype).bits // 8
    nbytes = (item * 2 * R * nq * hd + kvd.itemsize * 2 * kvh * hd * vis
              + (4 * nq if "alibi" in opts else 0))
    ops = (4.0 * hd + (2 if "alibi" in opts else 0)) * nq * vis
    b_ms, b_by = bound_ms(nbytes, ops, dtype_name)
    how = (f"tensor cores, {path_plan.splits} splits of "
           f"{path_plan.tiles_per_split} tiles" if path_plan.tensor_cores
           else "CUDA cores")
    log(f"# phase 2: decode_paged_attention {case} {dtype_name}"
        f"{kv_label(kv)} (R {R}, nq "
        f"{nq}, kvh {kvh}, hd {hd}, contexts {min(ctx)}-{max(ctx)}, "
        f"{opts if 'alibi' not in opts else 'alibi'}; {how}): max_abs_err "
        f"{err:.3g} (tol {tol_text('decode_paged_attention', dtype_name)} "
        f"= {limit:.3g}, plans bounded by {', '.join(plans)}); kernel "
        f"{ms:.4f} ms (device {dev_ms:.4f} ms, host {host:.4f} ms a call), "
        f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (device "
        f"{lib_dev_ms:.4f} ms), bound {b_ms:.4f} ms ({b_by}, {vis} K/V "
        f"rows), {nbytes / dev_ms / 1e6:.0f} GB/s on the device"
        + (f"; the CUDA-core instance (before) {prior['before_ms']:.4f} ms "
           f"(device {prior['before_device_ms']:.4f} ms)" if prior else ""))
    del cache, k_d, v_d, ref
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                host_ms=host, library_device_ms=lib_dev_ms, **prior)


def quant_inputs(gen, name: str, K: int, N: int, M: int, dtype):
    """Random quantized weights and x scaled so that y is O(1) (standard
    deviation ~0.25: (q - z) has deviation ~6.5, int8 q ~73.6): x, the
    kernel's weight arguments, the plain version, and the dense fp32 W."""
    import torch
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    from aphrodite_tpu_torch.quantization.loader import pack_w4
    dev = dict(device="cuda", generator=gen)
    x = torch.randn((M, K), **dev).to(dtype)
    if name == "w8a16_matmul":
        q = torch.randint(-127, 128, (K, N), **dev).to(torch.int8)
        s = (0.5 + torch.rand((N,), **dev)) / (4 * 73.6 * K ** 0.5)
        args = (q, s)
        dense = q.float() * s
        plain = lambda xf: qm.ref_w8a16_matmul(xf, q, s)  # noqa: E731
    else:
        G = K // 128
        q = torch.randint(0, 16, (K, N), **dev).to(torch.int8)
        z = torch.randint(0, 16, (G, N), **dev).float()
        s = (0.5 + torch.rand((G, N), **dev)) / (4 * 6.5 * K ** 0.5)
        args = ((pack_w4(q) if name == "w4a16_packed_matmul" else q), s, z)
        dense = qm.dequant_w4(q, s, z)
        plain = lambda xf: qm.ref_w4a16_matmul(xf, q, s, z)  # noqa: E731
    return x, args, plain, dense


def library_call(name: str, x, args, dense):
    """(label, fn): one PyTorch call computing the same product, which the
    port never calls."""
    import torch
    if x.dtype in (torch.bfloat16, torch.float16):
        try:
            if name == "w8a16_matmul":
                q, s = args
                qt, sb = q.t().contiguous(), s.to(x.dtype)
                fn = lambda: torch._weight_int8pack_mm(x, qt, sb)  # noqa
            else:
                # Its layout: [N, K/2] bytes of two consecutive k, then
                # (q - 8) * s + zero' with zero' = (8 - z) * s.
                from aphrodite_tpu_torch.ops import quant_matmul as qm
                q = (args[0] if name == "w4a16_matmul"
                     else qm.unpack_w4(args[0]))
                s, z = args[1], args[2]
                qn = q.t().contiguous().to(torch.uint8)          # [N, K]
                packed = (qn[:, ::2] << 4 | qn[:, 1::2]).contiguous()
                w4 = torch._convert_weight_to_int4pack(packed, 8)
                sz = torch.stack([s, (8.0 - z) * s], dim=-1).to(
                    x.dtype).contiguous()                        # [G, N, 2]
                fn = lambda: torch._weight_int4pack_mm(  # noqa: E731
                    x, w4, 128, sz)
            fn()
            torch.cuda.synchronize()
            return ("int8pack_mm" if name == "w8a16_matmul"
                    else "int4pack_mm"), fn
        except Exception as e:  # the card's torch lacks the op
            log(f"# phase 2: {name}: library op unavailable ({e!r:.120}); "
                "yardstick is torch.matmul on the dequantized weight")
    w = dense.to(x.dtype)
    return "matmul", lambda: torch.matmul(x, w)


def check_quant(gen, name: str, dtype_name: str,
                shapes: dict | None = None) -> dict:
    """One quant kernel at a path's four GEMM shapes (M = 32; ``shapes``,
    else those of ``QUANT_KERNELS``): error against the plain version on
    fp32 copies of the same inputs; times and bounds summed over the four
    GEMMs of a layer. Then errors only at other M."""
    import torch
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    dtype = getattr(torch, dtype_name)
    kernel = qm.KERNELS[name]
    shapes = shapes or QUANT_KERNELS[name][1]
    M = 32
    tot = dict(max_abs_err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0,
               bound_ms=0.0, library_ms=0.0, library_device_ms=0.0,
               bytes=0.0, ops=0.0, host_ms=0.0, dense_device_ms=0.0)
    lib_label = None
    for gemm, (K, N) in shapes.items():
        x, args, plain, dense = quant_inputs(gen, name, K, N, M, dtype)
        out = kernel(x, *args)
        ref = plain(x.float())
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        if not (err <= TOL[dtype_name] and torch.isfinite(out).all()):
            raise AssertionError(f"{name} {gemm} {dtype_name}: max_abs_err "
                                 f"{err} > {TOL[dtype_name]}")
        ms = cuda_ms(lambda: kernel(x, *args), 50)
        dev = device_ms(lambda: kernel(x, *args), 20)
        t_host = time.perf_counter()
        for _ in range(50):
            kernel(x, *args)
        host_ms = (time.perf_counter() - t_host) * 1e3 / 50
        torch.cuda.synchronize()
        plain_ms = cuda_ms(lambda: plain(x), 3)
        lib_label, lib = library_call(name, x, args, dense)
        lib_ms = cuda_ms(lib, 50)
        lib_dev = device_ms(lib, 20)
        wd = dense.to(dtype)
        dense_dev = device_ms(lambda: x @ wd, 20)
        del wd
        nbytes = (x.numel() * x.element_size()
                  + sum(a.numel() * a.element_size() for a in args)
                  + M * N * x.element_size())
        ops = 2.0 * M * K * N
        b_ms, _ = bound_ms(nbytes, ops, dtype_name)
        log(f"# phase 2: {name} {gemm} {dtype_name} M={M} K={K} N={N}: "
            f"err {err:.3g}; kernel {ms:.4f} ms (device {dev:.4f} ms, host "
            f"{host_ms:.4f} ms a call), plain {plain_ms:.4f} ms, "
            f"{lib_label} {lib_ms:.4f} ms (device {lib_dev:.4f} ms), dense "
            f"{dtype_name} matmul device {dense_dev:.4f} ms, bound "
            f"{b_ms:.4f} ms")
        for k, v in (("max_abs_err", err), ("ms", ms), ("device_ms", dev),
                     ("plain_ms", plain_ms), ("library_ms", lib_ms),
                     ("library_device_ms", lib_dev), ("bytes", nbytes),
                     ("ops", ops), ("host_ms", host_ms),
                     ("dense_device_ms", dense_dev)):
            tot[k] = max(tot[k], v) if k == "max_abs_err" else tot[k] + v
    # Other batch sizes (other M tiles and K splits) at the first shape:
    # correctness only.
    K, N = next(iter(shapes.values()))
    for M in (1, 5, 13, 40, 200):
        x, args, plain, _ = quant_inputs(gen, name, K, N, M, dtype)
        out = kernel(x, *args)
        err = (out.float() - plain(x.float())).abs().max().item()
        if not (err <= TOL[dtype_name] and torch.isfinite(out).all()):
            raise AssertionError(f"{name} M={M} K={K} N={N} {dtype_name}: "
                                 f"max_abs_err {err} > {TOL[dtype_name]}")
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot.pop("bytes"),
                                                tot.pop("ops"), dtype_name)
    tot["library"] = lib_label
    return tot


def check_prefill_w4(gen) -> None:
    """The W4 prefill product (M > 256) at the 8B wave's shapes (M = 16384,
    packed leaves, bf16): ``quant_gemm.w4a16_matmul``, which dequantizes W
    a slab of groups at a time straight to bf16, against the same product
    through a whole-W fp32 dequantize (``dequant_w4``, then a cast). The
    outputs must be equal; device ms and the peak memory above the inputs
    (output included) over a layer's four GEMMs."""
    import torch
    from aphrodite_tpu_torch.layers.linear import matmul_f32
    from aphrodite_tpu_torch.ops import quant_gemm, quant_matmul as qm
    M = 16384
    ms, peak = {}, {}
    for gemm, (K, N) in LLAMA8B_GEMMS.items():
        x, (p, s, z), _, _ = quant_inputs(gen, "w4a16_packed_matmul", K, N,
                                          M, torch.bfloat16)
        fns = {"slabs": lambda: quant_gemm.w4a16_matmul(x, None, s, z,
                                                        qpacked=p),
               "whole fp32": lambda: matmul_f32(x, qm.dequant_w4(
                   qm.unpack_w4(p), s, z).to(x.dtype)).to(x.dtype)}
        outs = {}
        for label, fn in fns.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            outs[label] = fn()
            torch.cuda.synchronize()
            peak[label] = max(peak.get(label, 0),
                              torch.cuda.max_memory_allocated() - base)
            ms[label] = ms.get(label, 0.0) + cuda_ms(fn, 3)
        if not torch.equal(outs["slabs"], outs["whole fp32"]):
            raise AssertionError(f"W4 prefill product {gemm}: slab-wise "
                                 "dequantize differs from the whole-W one")
        del outs
    log(f"# phase 2: W4 prefill product, 8B wave M={M} bf16, a layer's 4 "
        "GEMMs (equal outputs): " + "; ".join(
            f"{k} dequantize {ms[k]:.4f} ms, peak +{peak[k] / 2**30:.3f} GiB"
            for k in ms))


def int4_inputs(gen, K: int, N: int, M: int, dtype):
    """Random native-int4 weights (q4 and zeros in [-8, 8), group 128) and
    x, scaled as in ``quant_inputs``: x, (packed q4, s, z), the plain
    version, and the same weights as uint4 (q4 + 8, z + 8) for the packed
    W4 kernel and the library call."""
    import torch
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    dev = dict(device="cuda", generator=gen)
    G = K // 128
    x = torch.randn((M, K), **dev).to(dtype)
    q4 = torch.randint(-8, 8, (K, N), **dev).to(torch.int8)
    z = torch.randint(-8, 8, (G, N), **dev).float()
    s = (0.5 + torch.rand((G, N), **dev)) / (4 * 6.5 * K ** 0.5)
    p = qm.pack_int4(q4)
    plain = lambda xf: qm.ref_w4a16_int4_matmul(xf, p, s, z)  # noqa: E731
    return x, (p, s, z), plain, (q4 + 8, s, z + 8)


def check_int4(gen, dtype_name: str) -> dict:
    """The native-int4 GEMM at the Llama-3.1-8B layer's four GEMMs at M =
    128 (phase 14's decode batch): error against the plain version on fp32
    copies of the same inputs; kernel, plain and library times and the
    bound summed over the layer. The same weights as uint4 through the
    packed W4 kernel at M = 128 and 32, and the int4 kernel at M = 32, for
    comparison (bf16). Then errors only at M = 65 and 256."""
    import torch
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    from aphrodite_tpu_torch.quantization.loader import pack_w4
    dtype = getattr(torch, dtype_name)
    tc = dtype_name == "bfloat16"
    tot = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
               bytes=0.0, ops=0.0, device_ms=0.0, host_ms=0.0,
               library_device_ms=0.0, dense_device_ms=0.0)
    side = {"int4 M=32": 0.0, "packed M=128": 0.0, "packed M=32": 0.0}
    lib_label = None
    for gemm, (K, N) in LLAMA8B_GEMMS.items():
        M = 128
        x, args, plain, uint4 = int4_inputs(gen, K, N, M, dtype)
        out = qm.w4a16_int4_matmul(x, *args)
        ref = plain(x.float())
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        if not (err <= TOL[dtype_name] and torch.isfinite(out).all()):
            raise AssertionError(f"w4a16_int4_matmul {gemm} M={M} "
                                 f"{dtype_name}: max_abs_err {err} > "
                                 f"{TOL[dtype_name]}")
        kern = lambda: qm.w4a16_int4_matmul(x, *args)  # noqa: E731
        ms = cuda_ms(kern, 50 if tc else 5)
        dev = device_ms(kern, 20 if tc else 3)
        host = host_ms(kern, 50 if tc else 5)
        plain_ms = cuda_ms(lambda: plain(x), 3)
        dense = qm.dequant_w4(*uint4)
        lib_label, lib = library_call("w4a16_matmul", x, uint4, dense)
        lib_ms = cuda_ms(lib, 50 if tc else 5)
        lib_dev = device_ms(lib, 20 if tc else 3)
        wd = dense.to(dtype)
        dense_dev = device_ms(lambda: x @ wd, 20 if tc else 3)
        del wd, dense
        nbytes = (x.numel() * x.element_size()
                  + sum(a.numel() * a.element_size() for a in args)
                  + M * N * x.element_size())
        ops = 2.0 * M * K * N
        msg = (f"# phase 2: w4a16_int4_matmul {gemm} {dtype_name} M={M} K={K}"
               f" N={N}: err {err:.3g}; kernel {ms:.4f} ms (device "
               f"{dev:.4f} ms, host {host:.4f} ms a call), plain "
               f"{plain_ms:.4f} ms, {lib_label} {lib_ms:.4f} ms (device "
               f"{lib_dev:.4f} ms), dense {dtype_name} matmul device "
               f"{dense_dev:.4f} ms, bound "
               f"{bound_ms(nbytes, ops, dtype_name)[0]:.4f} ms")
        if tc:  # the same weights through the packed W4 kernel
            packed = (pack_w4(uint4[0]), uint4[1], uint4[2])
            x32 = x[:32].contiguous()
            t = {"int4 M=32": cuda_ms(
                     lambda: qm.w4a16_int4_matmul(x32, *args), 50),
                 "packed M=128": cuda_ms(
                     lambda: qm.w4a16_packed_matmul(x, *packed), 50),
                 "packed M=32": cuda_ms(
                     lambda: qm.w4a16_packed_matmul(x32, *packed), 50)}
            msg += "; " + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
            for k, v in t.items():
                side[k] += v
        log(msg)
        for k, v in (("ms", ms), ("plain_ms", plain_ms),
                     ("library_ms", lib_ms), ("bytes", nbytes), ("ops", ops),
                     ("device_ms", dev), ("host_ms", host),
                     ("library_device_ms", lib_dev),
                     ("dense_device_ms", dense_dev)):
            tot[k] += v
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        del x, args, uint4, out, ref
        for M in (65, 256):
            x, args, plain, _ = int4_inputs(gen, K, N, M, dtype)
            out = qm.w4a16_int4_matmul(x, *args)
            err = (out.float() - plain(x.float())).abs().max().item()
            if not (err <= TOL[dtype_name] and torch.isfinite(out).all()):
                raise AssertionError(f"w4a16_int4_matmul {gemm} M={M} "
                                     f"{dtype_name}: max_abs_err {err} > "
                                     f"{TOL[dtype_name]}")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            del x, args, out
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot.pop("bytes"),
                                                tot.pop("ops"), dtype_name)
    tot["library"] = lib_label
    if tc:
        log("# phase 2: a layer's 4 GEMMs, bf16, the same weights: int4 "
            f"M=128 {tot['ms']:.4f} ms, " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in side.items()))
    return tot


# Where the bf16 W4 kernel (csrc/w4_wgmma.cu) bites, both layouts (phase 2):
# (M, K, N, group, forced K splits, zeros inside the product (None: where
# they are integers), fractional zeros). N = 1424: 12 column tiles, the
# last 16 wide; K = 4032 (group 96) and 2112: a short last stage, and for
# packed a high half that starts mid-group.
W4_BATCHES = (1, 5, 13, 32, 40, 65, 128, 200, 256)
W4_CASES = ([(M, 2048, 1424, 128, None, None, False) for M in W4_BATCHES]
            + [(M, 2048, 1424, g, s, None, False) for g in (32, 64, 256)
               for M, s in ((40, None), (200, 3))]
            + [(128, 4096, 4096, 128, 5, None, False),
               (13, 14336, 4096, 128, 7, None, False),
               (65, 2048, 1424, 128, None, False, False),
               (32, 2048, 1424, 64, 2, False, False),
               (13, 2048, 1424, 128, None, None, True),
               (200, 2048, 1424, 32, 2, None, True),
               (13, 4032, 272, 96, None, None, False),
               (200, 2112, 160, 64, 2, None, False),
               (65, 96, 64, 32, None, None, False)])


# Where the byte layouts bite (phase 2), as W4_CASES: every M tile and two
# M tiles, groups 32, 64, 128 and K (one group; w8 reads no group), a
# ragged N (1424: the last tile 16 wide), forced K splits, both forms of
# the zero and fractional zeros (uint4; w8 has no zeros), a short last
# stage (K = 4032, group 96; K = 96), and the two paths' shapes: a Llama-
# 3.1-8B layer's (phase 15) and a Qwen2.5-7B layer's (phase 16) four GEMMs
# at M = 32, down also split 7 ways at M = 13. w8's bytes hold -128 and
# 127 in every column.
BYTE_CASES = ([(M, 2048, 1424, 128, None, None, False) for M in W4_BATCHES]
              + [(M, 2048, 1424, g, s, None, False) for g in (32, 64, 2048)
                 for M, s in ((40, None), (200, 3))]
              + [(32, K, N, 128, None, None, False)
                 for K, N in (*LLAMA8B_GEMMS.values(),
                              *QWEN7B_GEMMS.values())]
              + [(13, 18944, 3584, 128, 7, None, False),
                 (13, 14336, 4096, 128, 7, None, False),
                 (65, 2048, 1424, 128, None, False, False),
                 (32, 2048, 1424, 64, 2, False, False),
                 (13, 2048, 1424, 128, None, None, True),
                 (200, 2048, 1424, 32, 2, None, True),
                 (13, 4032, 272, 96, None, None, False),
                 (200, 2112, 160, 64, 2, None, False),
                 (65, 96, 64, 32, None, None, False)])


def fp8_weights(gen, K: int, N: int):
    """e4m3fn weights [K, N] (64 x N(0, 1), so about e4m3's range), rows
    0-5 of every column +448, -448, +2^-9 and -2^-9 (the smallest
    subnormal), +0 and -0, and per-column scales that make y O(1)."""
    import torch
    from aphrodite_tpu_torch.utils import to_fp8
    dev = dict(device="cuda", generator=gen)
    q = to_fp8((64 * torch.randn((K, N), **dev)).clamp(-448, 448),
               torch.float8_e4m3fn)
    for r, b in enumerate((0x7E, 0xFE, 0x01, 0x81, 0x00, 0x80)):
        q.view(torch.uint8)[r] = b
    s = (0.5 + torch.rand((N,), **dev)) / (4 * 64 * K ** 0.5)
    return q, s


def w4_inputs(gen, layout: str, M: int, K: int, N: int, group: int,
              frac: bool, dtype_name: str = "bfloat16"):
    """x in ``dtype_name`` and one layout's weights, scaled as in
    ``int4_inputs`` (w8 as in ``quant_inputs``, with -128 and 127 in rows 0
    and 1 of every column; fp8 as ``fp8_weights``): x, (q, s, z) (w8 and
    fp8: (q, s, None)), the plain version. ``frac`` moves every zero by
    0.37."""
    import torch
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    from aphrodite_tpu_torch.quantization.loader import pack_w4
    dev = dict(device="cuda", generator=gen)
    G = K // group
    x = torch.randn((M, K), **dev).to(getattr(torch, dtype_name))
    if layout == "fp8":
        q, s = fp8_weights(gen, K, N)
        return x, (q, s, None), lambda xf: qm.ref_fp8_matmul(xf, q, s)
    if layout == "w8":
        q = torch.randint(-128, 128, (K, N), **dev).to(torch.int8)
        q[0], q[1] = -128, 127
        s = (0.5 + torch.rand((N,), **dev)) / (4 * 73.6 * K ** 0.5)
        return x, (q, s, None), lambda xf: qm.ref_w8a16_matmul(xf, q, s)
    s = (0.5 + torch.rand((G, N), **dev)) / (4 * 6.5 * K ** 0.5)
    if layout == "int4":
        q = qm.pack_int4(torch.randint(-8, 8, (K, N), **dev).to(torch.int8))
        z = torch.randint(-8, 8, (G, N), **dev).float()
        ref = qm.ref_w4a16_int4_matmul
    else:
        q = torch.randint(0, 16, (K, N), **dev).to(torch.int8)
        z = torch.randint(0, 16, (G, N), **dev).float()
        ref = qm.ref_w4a16_matmul
        if layout == "packed":
            q = pack_w4(q)
            ref = qm.ref_w4a16_packed_matmul
    if frac:
        z += 0.37
    return x, (q, s, z), lambda xf: ref(xf, q, s, z)


def gemm_tol(dtype_name: str, ref) -> float:
    """The error limit of a quantized GEMM's output (O(1) by construction):
    bf16 TOL["bfloat16"]; fp16 TOL["float16"] scaled to the reference's
    largest value where that is below 1 (``scaled_tol``)."""
    return (TOL[dtype_name] if dtype_name == "bfloat16"
            else scaled_tol(dtype_name, ref))


def check_w4_wgmma(gen, layouts=("int4", "packed", "uint4", "w8"),
                   dtype_name: str = "bfloat16") -> float:
    """The kernel's instances of x's dtype (``csrc/w4_wgmma.cu`` bf16,
    ``csrc/w4_wgmma_f16.cu`` fp16) in each layout against the plain
    versions, the nibble layouts at ``W4_CASES`` and the byte ones at
    ``BYTE_CASES``: every M tile and two M tiles, groups 32-256 (and K), a
    ragged N, forced K splits, both forms of the zero; two launches on the
    same inputs must be bit-equal. Returns the largest error (tolerance
    ``gemm_tol``, max-abs, the outputs O(1)). The "fp8" layout takes
    ``FP8_CASES`` (``check_fp8_layout``)."""
    import torch
    from aphrodite_tpu_torch.ops import w4_wgmma
    worst = 0.0
    for layout in layouts:
        cases = BYTE_CASES if layout in w4_wgmma.BYTE_LAYOUTS else W4_CASES
        for M, K, N, group, splits, zero_in, frac in cases:
            x, args, plain = w4_inputs(gen, layout, M, K, N, group, frac,
                                       dtype_name)
            y = w4_wgmma.matmul(layout, x, *args, splits=splits,
                                zero_in=zero_in)
            y2 = w4_wgmma.matmul(layout, x, *args, splits=splits,
                                 zero_in=zero_in)
            torch.cuda.synchronize()
            ref = plain(x.float())
            err = (y.float() - ref).abs().max().item()
            tol = gemm_tol(dtype_name, ref)
            what = (f"w4_wgmma {layout} {dtype_name} M={M} K={K} N={N} "
                    f"group={group} splits={splits} zeros in the product "
                    f"{zero_in} fractional zeros {frac}")
            if not (err <= tol and torch.isfinite(y).all()
                    and y.dtype == x.dtype):
                raise AssertionError(f"{what}: max_abs_err {err} > {tol}")
            if not torch.equal(y, y2):
                raise AssertionError(f"{what}: two launches differ")
            worst = max(worst, err)
            del x, args, y, y2
    return worst


# The "fp8" layout's cases (phase 2): BYTE_CASES's (M, K, N, forced splits)
# where the zero's form plays no part (fp8 has no zeros or groups): every M
# tile and two M tiles, a ragged N, forced K splits, a short last stage, and
# both paths' layers at M = 32.
FP8_CASES = list(dict.fromkeys((M, K, N, s)
                               for M, K, N, _, s, zi, fr in BYTE_CASES
                               if zi is None and not fr))


def check_fp8_layout(gen, dtype_name: str = "bfloat16") -> float:
    """kFp8 (``w4_wgmma``'s "fp8" layout) of x's dtype at ``FP8_CASES``,
    weight-only and with a scale a row of x (the W8A8 epilogue, kRowScale),
    against the plain version: the e4m3 bytes of every column include
    +-448, +-2^-9 and +-0 (``fp8_weights``); two launches bit-equal.
    Returns the largest error (tolerance ``gemm_tol``, max-abs, outputs
    O(1))."""
    import torch
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    from aphrodite_tpu_torch.ops import w4_wgmma
    worst = 0.0
    for M, K, N, splits in FP8_CASES:
        x, (q, s, _), _ = w4_inputs(gen, "fp8", M, K, N, K, False,
                                    dtype_name)
        rs = 0.5 + torch.rand((M,), device="cuda", generator=gen)
        for r in (None, rs):
            y = w4_wgmma.matmul("fp8", x, q, s, None, splits=splits,
                                row_scales=r)
            y2 = w4_wgmma.matmul("fp8", x, q, s, None, splits=splits,
                                 row_scales=r)
            torch.cuda.synchronize()
            ref = qm.ref_fp8_matmul(x.float(), q, s, r)
            err = (y.float() - ref).abs().max().item()
            tol = gemm_tol(dtype_name, ref)
            what = (f"w4_wgmma fp8 {dtype_name} M={M} K={K} N={N} "
                    f"splits={splits} row scales {r is not None}")
            if not (err <= tol and torch.isfinite(y).all()
                    and y.dtype == x.dtype):
                raise AssertionError(f"{what}: max_abs_err {err} > {tol}")
            if not torch.equal(y, y2):
                raise AssertionError(f"{what}: two launches differ")
            worst = max(worst, err)
        del x, q, s, y, y2
    return worst


def e4m3_table():
    """The value of every e4m3fn byte by its definition (sign, 4 exponent
    bits of bias 7, 3 mantissa bits; exponent 0 subnormal, 0x7F and 0xFF
    NaN), fp32 [256], independent of any conversion in torch or the
    kernels."""
    import torch
    v = []
    for b in range(256):
        e, m = (b >> 3) & 15, b & 7
        mag = (m / 8 * 2.0 ** -6 if e == 0 else (1 + m / 8) * 2.0 ** (e - 7))
        v.append(float("nan") if b & 0x7F == 0x7F
                 else -mag if b & 0x80 else mag)
    return torch.tensor(v, dtype=torch.float32)


def check_fp8_bytes() -> str:
    """Every finite e4m3 byte through both fp8 kernels, exactly: q [256,
    256] holds byte (k + n) mod 256 at (k, n), its two NaN bytes replaced
    by 0x00 and 0x80, so each finite byte lies in every row and column; s
    = 1 and x the identity, so y[k, n] is the byte's value (bf16: kFp8
    weight-only and with row scales of 1, with no K split and with 4;
    fp32: ``qmm_kernel``'s e4m3 case). y must equal ``e4m3_table`` by ==
    at every position (the sign of a zero is not compared: a sum of
    products keeps no -0). Returns a line for the log."""
    import torch
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    from aphrodite_tpu_torch.ops import w4_wgmma
    idx = torch.arange(256, device="cuda")
    b = (idx[:, None] + idx[None, :]) % 256
    b = torch.where(b == 0x7F, 0, torch.where(b == 0xFF, 0x80, b))
    q = b.to(torch.uint8).view(torch.float8_e4m3fn)
    want = e4m3_table().cuda()[b]
    eye, ones = torch.eye(256, device="cuda"), torch.ones(256, device="cuda")
    got = {f"kFp8 splits {sp} row scales {r is not None}":
           w4_wgmma.matmul("fp8", eye.bfloat16(), q, ones, None, splits=sp,
                           row_scales=r)
           for sp in (None, 4) for r in (None, ones)}
    got["qmm_kernel e4m3 fp32"] = qm.fp8_matmul(eye, q, ones)
    for what, y in got.items():
        bad = (y.float() != want).nonzero()
        if len(bad):
            k, n = bad[0].tolist()
            raise AssertionError(
                f"{what}: {len(bad)} of 65536 values differ from the e4m3 "
                f"table, e.g. byte {int(b[k, n]):#04x} at ({k}, {n}): "
                f"{y[k, n].item()!r}, want {want[k, n].item()!r}")
    return (f"fp8 bytes: all 254 finite e4m3 bytes (+-448, the subnormals "
            f"+-2^-9 .. +-7 * 2^-9, +-0) at every row and column through "
            f"{', '.join(got)}: y equals the byte table exactly")


def check_fp8(gen, dtype_name: str, shapes: dict) -> dict:
    """``quant_matmul.fp8_matmul`` at a path's four GEMM shapes (M = 32):
    weight-only, error against the plain version; time a call, device and
    host time, plain time, bound (bytes: x, e4m3 W, s and y once), a dense
    ``torch.matmul`` of the dequantized weights in ``dtype_name`` (the
    weight-only call's library yardstick, ``library_ms``); then with x's
    row scales (W8A8: x rounded to e4m3 first), its time beside
    ``torch._scaled_mm`` with row-wise scales on the same e4m3 x (bf16
    only), which computes that function (logged, not in ``library_ms``).
    Errors at other M (1, 5, 13, 40, 200) too. Sums over the layer."""
    import torch
    from aphrodite_tpu_torch.ops import quant_gemm
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    dtype = getattr(torch, dtype_name)
    tc = dtype_name == "bfloat16"
    M = 32
    tot = dict(max_abs_err=0.0, ms=0.0, device_ms=0.0, host_ms=0.0,
               plain_ms=0.0, dense_ms=0.0, dense_device_ms=0.0, bytes=0.0,
               ops=0.0,
               rs_ms=0.0, rs_device_ms=0.0, scaled_mm_ms=0.0,
               scaled_mm_device_ms=0.0)
    scaled_mm = tc
    for gemm, (K, N) in shapes.items():
        x = torch.randn((M, K), device="cuda", generator=gen).to(dtype)
        q, s = fp8_weights(gen, K, N)
        out = qm.fp8_matmul(x, q, s)
        ref = qm.ref_fp8_matmul(x.float(), q, s)
        x8, xs = quant_gemm.fp8_quantize_rows(x)
        rs = xs.reshape(M).contiguous()
        out_rs = qm.fp8_matmul(x8, q, s, rs)
        ref_rs = qm.ref_fp8_matmul(x8.float(), q, s, rs)
        torch.cuda.synchronize()
        err = max((out.float() - ref).abs().max().item(),
                  (out_rs.float() - ref_rs).abs().max().item())
        if not (err <= TOL[dtype_name] and torch.isfinite(out).all()
                and torch.isfinite(out_rs).all()):
            raise AssertionError(f"fp8_matmul {gemm} {dtype_name}: "
                                 f"max_abs_err {err} > {TOL[dtype_name]}")
        kern = lambda: qm.fp8_matmul(x, q, s)  # noqa: E731
        kern_rs = lambda: qm.fp8_matmul(x8, q, s, rs)  # noqa: E731
        reps = 50 if tc else 5
        t = dict(ms=cuda_ms(kern, reps), device_ms=device_ms(kern, 20),
                 host_ms=host_ms(kern, reps),
                 plain_ms=cuda_ms(lambda: qm.ref_fp8_matmul(x, q, s), 3),
                 rs_ms=cuda_ms(kern_rs, reps),
                 rs_device_ms=device_ms(kern_rs, 20))
        wd = (q.float() * s).to(dtype)
        t["dense_ms"] = cuda_ms(lambda: x @ wd, reps)
        t["dense_device_ms"] = device_ms(lambda: x @ wd, 20)
        del wd
        if scaled_mm:
            try:  # the same W8A8 function on the tensor cores' fp8 path
                a8 = x8.to(torch.float8_e4m3fn)
                b8 = q.t().contiguous().t()  # column-major [K, N]
                sa, sb = xs.contiguous(), s.reshape(1, N).contiguous()
                lib = lambda: torch._scaled_mm(  # noqa: E731
                    a8, b8, scale_a=sa, scale_b=sb, out_dtype=dtype)
                e_lib = (lib().float() - ref_rs).abs().max().item()
                t["scaled_mm_ms"] = cuda_ms(lib, reps)
                t["scaled_mm_device_ms"] = device_ms(lib, 20)
                log(f"# phase 2: torch._scaled_mm {gemm} (row-wise scales) "
                    f"vs the plain version: max_abs_err {e_lib:.3g}")
            except Exception as ex:  # the card's torch lacks the op
                scaled_mm = False
                log(f"# phase 2: torch._scaled_mm with row-wise scales is "
                    f"unavailable ({ex!r:.160})")
        nbytes = (x.numel() * x.element_size() + q.numel() + 4 * N
                  + M * N * x.element_size())
        ops = 2.0 * M * K * N
        log(f"# phase 2: fp8_matmul {gemm} {dtype_name} M={M} K={K} N={N}: "
            f"err {err:.3g}; kernel {t['ms']:.4f} ms (device "
            f"{t['device_ms']:.4f} ms, host {t['host_ms']:.4f} ms a call), "
            f"with row scales {t['rs_ms']:.4f} ms (device "
            f"{t['rs_device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
            f"dense {dtype_name} matmul {t['dense_ms']:.4f} ms (device "
            f"{t['dense_device_ms']:.4f} ms), bound "
            f"{bound_ms(nbytes, ops, dtype_name)[0]:.4f} ms")
        for k, v in t.items():
            tot[k] += v
        tot["bytes"] += nbytes
        tot["ops"] += ops
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        del x, q, s, x8, out, out_rs
    K, N = next(iter(shapes.values()))
    for M in (1, 5, 13, 40, 200):
        x = torch.randn((M, K), device="cuda", generator=gen).to(dtype)
        q, s = fp8_weights(gen, K, N)
        x8, xs = quant_gemm.fp8_quantize_rows(x)
        for a, r in ((x, None), (x8, xs.reshape(M).contiguous())):
            err = (qm.fp8_matmul(a, q, s, r).float()
                   - qm.ref_fp8_matmul(a.float(), q, s, r)).abs().max().item()
            if not err <= TOL[dtype_name]:
                raise AssertionError(f"fp8_matmul M={M} K={K} N={N} "
                                     f"{dtype_name}: max_abs_err {err}")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot.pop("bytes"),
                                                tot.pop("ops"), dtype_name)
    tot["library_ms"] = tot["dense_ms"]
    if not scaled_mm:
        tot["scaled_mm_ms"] = tot["scaled_mm_device_ms"] = None
    return tot


def check_int_mm() -> str:
    """Whether ``torch._int_mm`` takes M <= 16 on the card (older releases
    required M > 16), and ``quant_gemm.int8_matmul`` at M 1-32 (padded to
    ``INT_MM_MIN_M`` rows where M is below it) against the same int32
    product on the CPU: equal."""
    import torch
    from aphrodite_tpu_torch.ops import quant_gemm
    took = []
    for M in (1, 2, 8, 16):
        try:
            torch._int_mm(torch.ones((M, 64), dtype=torch.int8, device="cuda"),
                          torch.ones((64, 32), dtype=torch.int8,
                                     device="cuda"))
            torch.cuda.synchronize()
            took.append(M)
        except Exception:
            pass
    g = torch.Generator().manual_seed(11)
    for M in (1, 5, 16, 17, 32):
        x = torch.randn((M, 4096), generator=g)
        q = torch.randint(-128, 128, (4096, 6144), generator=g).to(torch.int8)
        s = torch.rand((6144,), generator=g) * 1e-3
        got = quant_gemm.int8_matmul(x.cuda(), q.cuda(), s.cuda()).cpu()
        want = quant_gemm.int8_matmul(x, q, s)
        if not torch.equal(got, want):
            raise AssertionError(f"int8_matmul M={M}: card != CPU (max "
                                 f"{(got - want).abs().max().item():.3g})")
    return (f"torch._int_mm takes M in {took} of (1, 2, 8, 16) unpadded; "
            f"int8_matmul (padded to {quant_gemm.INT_MM_MIN_M} rows below "
            "it) == the CPU at M 1, 5, 16, 17, 32")


def cascade_cache(gen, dtype, R: int, S: int, plen: int, kw: int,
                  kvh: int = 8):
    """A [2, P, 2, kvh, 64, 128] cache whose R requests share their first
    S // 64 pages, each with its own pages past them up to plen + kw, in
    shuffled order: (cache, shared pages, block tables)."""
    import torch
    n_shared = S // PAGE
    own = -(-(plen + kw) // PAGE) - n_shared
    num_pages = 1 + n_shared + R * own
    cache = torch.randn((2, num_pages, 2, kvh, PAGE, HD), generator=gen,
                        device="cuda").to(dtype)
    perm = (torch.randperm(num_pages - 1, generator=gen, device="cuda")
            + 1).int()
    shared = perm[:n_shared].contiguous()
    bt = torch.cat([shared[None].expand(R, n_shared),
                    perm[n_shared:].reshape(R, own)], dim=1).contiguous()
    return cache, shared, bt


def check_cascade(gen, dtype_name: str, kv: str | None = None,
                  timed: bool = True, R: int = CASCADE_R, NQ: int = 32,
                  KVH: int = 8, plen: int = 1152) -> tuple[dict, dict]:
    """Phase 14's decode step (by default R 128, 32 / 8 heads of 128,
    paged lengths 1152; phase 29's shared-prompt run: R 32, 32 / 32 heads,
    1088), 16 shared pages (S = 1024) and a 64-slot tail: the shared-prefix
    pass, its plan made once as the runner makes it, against its plain
    version (and an unaligned S = 1000, and S = 64: one split), and the
    window kernel started from its state against the plain window and the
    window kernel over the whole context, at several steps. Times: the
    pass, the window with the init state, both together and the window
    alone over the whole context (step 24). Returns the pass's and the
    window-with-init's results. ``kv``: an fp8 cache's dtype name (tails in
    ``tail_dtype`` of it; the yardsticks' K/V upcast to q's dtype outside
    the timing; the bounds' K/V bytes the cache's); ``timed`` False checks
    errors only."""
    import torch
    import torch.nn.functional as F
    from aphrodite_tpu_torch.ops.cascade_attention import (
        ref_shared_prefix_attention, shared_prefix_attention,
        shared_prefix_plan)
    from aphrodite_tpu_torch.ops.window_decode_attention import (
        ref_window_decode_attention, tail_dtype, window_decode_attention,
        window_plan)
    dtype = getattr(torch, dtype_name)
    S, Kw, layer = CASCADE_S, 64, 1
    kvd = kv_type(dtype, kv)
    cache, shared, bt = cascade_cache(gen, kvd, R, S, plen, Kw, KVH)
    q = torch.randn((R, NQ, HD), generator=gen, device="cuda").to(dtype)
    tail_k = torch.randn((2, R, KVH, Kw, HD), generator=gen,
                         device="cuda").to(tail_dtype(kvd))
    tail_v = torch.randn((2, R, KVH, Kw, HD), generator=gen,
                         device="cuda").to(tail_dtype(kvd))
    pl = torch.full((R,), plen, dtype=torch.int32, device="cuda")
    scale = HD ** -0.5
    item = torch.finfo(dtype).bits // 8
    # The pass with its plan made once, as the runner makes it a window.
    spa_plans = {s_len: shared_prefix_plan(dtype, R, NQ, KVH, HD, s_len,
                                           q.device, kvd)
                 for s_len in (S, 1000, 64)}
    spa = lambda s_len=S: shared_prefix_attention(  # noqa: E731
        q, cache, layer, shared, s_len, scale, spa_plans[s_len])
    err = 0.0
    for s_len in spa_plans:
        got = spa(s_len)
        want = ref_shared_prefix_attention(q, cache[layer], shared, s_len,
                                           scale)
        torch.cuda.synchronize()
        # m and l exactly as the plain version's up to rounding; acc is
        # O(l) = O(S), so its error is taken relative to l.
        e = max((got[1] - want[1]).abs().max().item(),
                ((got[0] - want[0]) / want[2][..., None]).abs().max().item(),
                ((got[2] - want[2]) / want[2]).abs().max().item())
        if not (e <= TOL[dtype_name] and all(torch.isfinite(t).all()
                                             for t in got)):
            raise AssertionError(f"shared_prefix_attention S={s_len} "
                                 f"{dtype_name}{kv_label(kv)}: max error "
                                 f"{e} > {TOL[dtype_name]}")
        err = max(err, e)
    p = spa_plans[S]
    how = (f"tensor cores, {p.splits} splits of {p.tiles_per_split} tiles"
           if p.tensor_cores else "CUDA cores")
    spa_res = dict(max_abs_err=err)
    if timed:
        ms = cuda_ms(spa, 200)
        spa_dev_ms = device_ms(spa, 50)
        spa_host = host_ms(spa)
        plain_ms = cuda_ms(lambda: ref_shared_prefix_attention(
            q, cache[layer], shared, S, scale), 5)
        # Library yardstick: one SDPA over the gathered shared K/V (in q's
        # dtype) with every request's query rows of a KV head as one
        # sequence, no mask. It returns the normalized output, not (acc, m,
        # l).
        kvs = cache[layer][shared.long()]            # [16, 2, kvh, 64, hd]
        kvs = kvs.permute(1, 2, 0, 3, 4).reshape(2, 1, KVH, S, HD)
        q_h = q.reshape(R, KVH, NQ // KVH, HD).permute(1, 0, 2, 3).reshape(
            1, KVH, -1, HD).contiguous()
        k_d, v_d = kvs[0].to(dtype).contiguous(), kvs[1].to(dtype).contiguous()
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q_h, k_d, v_d, scale=scale)
        lib_ms = cuda_ms(sdpa, 200)
        lib_dev_ms = device_ms(sdpa, 50)
        nbytes = (item * R * NQ * HD + kvd.itemsize * 2 * KVH * S * HD
                  + 4 * (R * NQ * HD + 2 * R * NQ))
        b_ms, b_by = bound_ms(nbytes, 4.0 * R * NQ * HD * S, dtype_name)
        spa_res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                       device_ms=spa_dev_ms, host_ms=spa_host,
                       library_device_ms=lib_dev_ms)
        del kvs, k_d, v_d
    log(f"# phase 2: shared_prefix_attention {dtype_name}{kv_label(kv)} (R "
        f"{R}, nq {NQ}, kvh {KVH}, S {S}; {how}): max error {err:.3g} (tol "
        f"{TOL[dtype_name]}, S {', '.join(map(str, spa_plans))})" + (
            f"; kernel {spa_res['ms']:.4f} ms (device "
            f"{spa_res['device_ms']:.4f} ms, host {spa_res['host_ms']:.4f} "
            f"ms a call), plain {spa_res['plain_ms']:.4f} ms, sdpa "
            f"(normalized output) {spa_res['library_ms']:.4f} ms (device "
            f"{spa_res['library_device_ms']:.4f} ms), bound "
            f"{spa_res['bound_ms']:.4f} ms ({spa_res['bound_by']})"
            if timed else ""))

    # The runner's plans: one from the cascade's state, one over the whole
    # context.
    plans = [window_plan(dtype, R, NQ, KVH, HD, q.device, plen, Kw - 1,
                         shared_len=s_len, kv_dtype=kvd) for s_len in (0, S)]
    win = lambda step, init=None: window_decode_attention(  # noqa: E731
        q, cache, tail_k, tail_v, layer, step, pl, bt, scale,
        cascade_init=init, shared_len=S if init is not None else 0,
        plan=plans[init is not None])
    err = 0.0
    for step in (0, 24, 63):
        init = spa()
        out = win(step, init)
        full = win(step)
        ref = ref_window_decode_attention(q, cache[layer], tail_k[layer],
                                          tail_v[layer], step, pl, bt, scale)
        torch.cuda.synchronize()
        e = (out.float() - ref.float()).abs().max().item()
        e_full = (out.float() - full.float()).abs().max().item()
        limit = scaled_tol(dtype_name, ref)
        if not (max(e, e_full) <= limit and torch.isfinite(out).all()):
            raise AssertionError(f"window kernel with the cascade init "
                                 f"{dtype_name}{kv_label(kv)} step {step}: "
                                 f"max_abs_err {e} vs plain, {e_full} vs the "
                                 f"kernel over the whole context > "
                                 f"{limit:.3g} (TOL scaled to the output)")
        err = max(err, e)
    if not timed:
        log(f"# phase 2: window_decode_attention with the cascade init "
            f"{dtype_name}{kv_label(kv)}: max_abs_err {err:.3g} (tol "
            f"{TOL[dtype_name]} x min(1, max|ref|))")
        del cache
        return spa_res, dict(max_abs_err=err)
    step = 24
    init = spa()
    ms = cuda_ms(lambda: win(step, init), 50)
    dev_ms = device_ms(lambda: win(step, init), 20)
    both_ms = cuda_ms(lambda: win(step, spa()), 50)
    full_ms = cuda_ms(lambda: win(step), 50)
    plain_ms = cuda_ms(lambda: ref_window_decode_attention(
        q, cache[layer], tail_k[layer], tail_v[layer], step, pl, bt, scale,
        cascade_init=init, shared_len=S), 5)
    # Library yardstick: SDPA over the whole context, gathered dense with a
    # mask (the same output as the cascade's).
    k_p, v_p = dense_kv(cache[layer], bt, [plen] * R, plen)
    k_d = torch.cat([k_p.to(dtype), tail_k[layer].to(dtype)], dim=2)
    v_d = torch.cat([v_p.to(dtype), tail_v[layer].to(dtype)], dim=2)
    j = torch.arange(plen + Kw, device="cuda")
    mask = ((j < plen) | ((j - plen) <= step))[None, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], k_d, v_d, attn_mask=mask, scale=scale,
        enable_gqa=True), 50)
    vis = R * (plen - S + step + 1)   # K/V rows past the prefix
    nbytes = (item * 2 * R * NQ * HD + kvd.itemsize * 2 * KVH * HD * vis
              + 4 * (R * NQ * HD + 2 * R * NQ))
    b_ms, b_by = bound_ms(nbytes, 4.0 * NQ * HD * vis, dtype_name)
    log(f"# phase 2: window_decode_attention with the cascade init "
        f"{dtype_name}{kv_label(kv)} (R {R}, paged {plen}, S {S}, step "
        f"{step}): max_abs_err "
        f"{err:.3g} (tol {TOL[dtype_name]} x min(1, max|ref|)); kernel "
        f"{ms:.4f} ms (device {dev_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}); cascade (pass + window) {both_ms:.4f} ms vs the window "
        f"kernel over the whole context {full_ms:.4f} ms")
    del cache, k_d, v_d
    return spa_res, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         device_ms=dev_ms)


def group_offsets(gen, M: int, skewed: bool, E: int = MOE_E,
                  uniform: bool = False, k: int = MOE_K):
    """int32 [E + 1] offsets of M sorted rows over E experts. Balanced:
    the rows of M / k tokens, each routed to k distinct random experts.
    Skewed: expert e drawn with weight (e + 1)^-1.5, every sixth expert
    empty (expert 0 takes ~45 % of the rows). Uniform: each row's expert
    drawn at random (any M)."""
    import torch
    if uniform:
        ids = torch.sort(torch.randint(0, E, (M,), generator=gen,
                                       device="cuda")).values
    elif not skewed:
        topi = torch.rand((M // k, E), generator=gen,
                          device="cuda").topk(k, dim=-1).indices
        ids = torch.sort(topi.reshape(-1)).values
    else:
        p = (torch.arange(E, device="cuda") + 1.0) ** -1.5
        p[torch.arange(E, device="cuda") % 6 == 5] = 0.0
        ids = torch.sort(torch.multinomial(p, M, replacement=True,
                                           generator=gen)).values
    return torch.searchsorted(ids, torch.arange(E + 1, device="cuda"),
                              out_int32=True)


def sized_offsets(sizes: list[int]):
    import torch
    return torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                        dtype=torch.int32, device="cuda")


# Where the wgmma kernel's design bites (phase 2, bf16, fp16 and fp32,
# against the plain version): rows past the last tile, K and N past the TMA
# boxes, a 1-row group, one expert holding every row (every pair of items
# shares it), E = 33 (find_item's second 32-expert chunk), and empty groups
# with 300 rows past the last group, which no group covers (the kernels
# write none of them; the plain version's zeros there are not compared).
# name: (M, K, N, E, group sizes or None for a uniform draw).
GROUPED_EDGE_CASES = {
    "M=65499": (65536 - 37, 2048, 2816, MOE_E, None),
    "K=1000": (65536, 1000, 2048, MOE_E, None),
    "N=1416": (65536, 2048, 1416, MOE_E, None),
    "1-row group": (1000, 2048, 2816, MOE_E,
                    [1, 500, 1, 0, 498] + [0] * (MOE_E - 5)),
    "one expert": (4096, 2048, 2816, MOE_E,
                   [0] * 7 + [4096] + [0] * (MOE_E - 8)),
    "E=33": (8000, 1408, 2048, 33, None),
    "uncovered rows": (4396, 2048, 2816, MOE_E,
                       [0, 1200, 0, 0, 37, 2859] + [0] * (MOE_E - 6)),
}


def grouped_library(x, w, off, want):
    """(label, fn): one PyTorch call for the same grouped product, which the
    port never calls: ``torch._grouped_mm`` where the card's torch has it
    (and it agrees with the plain version), else a per-expert
    ``torch.matmul`` loop."""
    import torch
    if x.dtype in (torch.bfloat16, torch.float16) and hasattr(
            torch, "_grouped_mm"):
        ends = off[1:].contiguous()
        for layout, wl in (("row-major", w), ("column-major", w.transpose(
                1, 2).contiguous().transpose(1, 2))):
            try:
                fn = lambda wl=wl: torch._grouped_mm(x, wl, offs=ends)  # noqa
                err = (fn().float() - want).abs().max().item()
                if err <= TOL[str(x.dtype).removeprefix("torch.")]:
                    return f"_grouped_mm ({layout} w)", fn
                log(f"# phase 2: _grouped_mm ({layout} w) differs by {err}")
            except Exception as e:  # the card's torch refuses this form
                log(f"# phase 2: _grouped_mm ({layout} w) unavailable "
                    f"({e!r:.120})")
    bounds = off.tolist()
    spans = [(e, a, b) for e, (a, b) in enumerate(zip(bounds, bounds[1:]))
             if b > a]
    return "matmul loop", lambda: torch.cat([x[a:b] @ w[e]
                                             for e, a, b in spans])


def check_grouped(gen, dtype_name: str) -> dict:
    """The grouped GEMM at phase 8's shapes (a MoE layer's gate|up and down
    over one prefill wave, M = 65536 rows, 60 experts), balanced and
    skewed, at M = 240 (the grouped route's threshold, 4 x 60) and at
    ``GROUPED_EDGE_CASES``: error against the plain version on fp32 copies
    of the same inputs, and two launches on the same inputs bit-equal.
    Times and bounds of the balanced wave, summed over the layer's two
    GEMMs: time a call (CUDA events), device time (profiler), host time a
    call, the plain version, ``_grouped_mm`` and a dense ``torch.matmul``
    of the same operations (what the card gives at these shapes)."""
    import torch
    from aphrodite_tpu_torch.ops.grouped_matmul import (grouped_matmul,
                                                        ref_grouped_matmul)
    dtype = getattr(torch, dtype_name)
    item = torch.finfo(dtype).bits // 8
    keys = ("ms", "device_ms", "host_ms", "plain_ms", "library_ms",
            "dense_ms", "bytes", "ops")
    tot = dict.fromkeys(keys, 0.0)
    tot["max_abs_err"] = 0.0
    small = dict.fromkeys(keys, 0.0)
    lib_label = None

    def held(label, x, w, off):
        covered = int(off[-1])  # the rows some group covers
        out = grouped_matmul(x, w, off)[:covered]
        again = grouped_matmul(x, w, off)[:covered]
        ref = ref_grouped_matmul(x.float(), w.float(), off)
        torch.cuda.synchronize()
        err = (out.float() - ref[:covered]).abs().max().item()
        if not (err <= TOL[dtype_name] and torch.isfinite(out).all()):
            raise AssertionError(f"grouped_matmul {label} {dtype_name}: "
                                 f"max_abs_err {err} > {TOL[dtype_name]}")
        if not torch.equal(out, again):
            raise AssertionError(f"grouped_matmul {label} {dtype_name}: two "
                                 "launches on the same inputs differ")
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        return ref, err

    def operands(M, K, N, E):
        x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
        w = (torch.randn((E, K, N), generator=gen, device="cuda")
             * (0.5 / K ** 0.5)).to(dtype)
        return x, w

    for M, case in ((65536, "balanced"), (65536, "skewed"), (240, "balanced"),
                    (240, "skewed")):
        off = group_offsets(gen, M, case == "skewed")
        nonempty = int((off[1:] > off[:-1]).sum())
        for gemm, (K, N) in MOE_GEMMS.items():
            x, w = operands(M, K, N, MOE_E)
            ref, err = held(f"{gemm} M={M} {case}", x, w, off)
            reps = 50 if M < 4096 else (3 if dtype_name == "float32"
                                        else 10)
            call = lambda: grouped_matmul(x, w, off)  # noqa: E731
            ms = cuda_ms(call, reps)
            nbytes = item * (M * K + nonempty * K * N + M * N)
            ops = 2.0 * M * K * N
            b_ms, _ = bound_ms(nbytes, ops, dtype_name)
            msg = (f"# phase 2: grouped_matmul {gemm} {dtype_name} M={M} "
                   f"K={K} N={N} {case} ({nonempty} groups): err {err:.3g},"
                   f" two launches bit-equal; kernel {ms:.4f} ms, bound "
                   f"{b_ms:.4f} ms")
            if case == "balanced":
                dev = device_ms(call, reps)
                host = host_ms(call, reps)
                plain_ms = cuda_ms(lambda: ref_grouped_matmul(x, w, off),
                                   2 if M > 4096 else 5)
                lib_label, lib = grouped_library(x, w, off, ref)
                lib_ms = cuda_ms(lib, reps)
                wd = w[0]
                dense_ms = cuda_ms(lambda: x @ wd, reps)
                msg += (f", device {dev:.4f} ms, host {host:.4f} ms a call, "
                        f"plain {plain_ms:.4f} ms, {lib_label} {lib_ms:.4f} "
                        f"ms, dense matmul of the same operations "
                        f"{dense_ms:.4f} ms")
                acc = tot if M == 65536 else small
                for k, v in (("ms", ms), ("device_ms", dev),
                             ("host_ms", host), ("plain_ms", plain_ms),
                             ("library_ms", lib_ms), ("dense_ms", dense_ms),
                             ("bytes", nbytes), ("ops", ops)):
                    acc[k] += v
            log(msg)
            del x, w, ref
    for label, (M, K, N, E, sizes) in GROUPED_EDGE_CASES.items():
        off = (sized_offsets(sizes) if sizes is not None
               else group_offsets(gen, M, False, E, uniform=True))
        x, w = operands(M, K, N, E)
        _, err = held(label, x, w, off)
        log(f"# phase 2: grouped_matmul {label} {dtype_name} (M={M} K={K} "
            f"N={N} E={E}): err {err:.3g}, two launches bit-equal")
        del x, w
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot.pop("bytes"),
                                                tot.pop("ops"), dtype_name)
    tot["library"] = lib_label
    b_ms, b_by = bound_ms(small["bytes"], small["ops"], dtype_name)
    log(f"# phase 2: grouped_matmul {dtype_name} M=240, a layer's 2 GEMMs: "
        f"kernel {small['ms']:.4f} ms (device {small['device_ms']:.4f} ms, "
        f"host {small['host_ms']:.4f} ms a call), plain "
        f"{small['plain_ms']:.4f} ms, {lib_label} {small['library_ms']:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by})")
    return tot


def check_scan(gen) -> dict:
    """The selective scan at phase 10's shapes, fp32: a prefill wave (T =
    4096, 8 segments of 512, dA = 0 at each segment's first token) and a
    decode step (T = 32 rows, each its own segment), over a Mamba-2.8B
    layer's 81920 columns, then a ragged edge (T and C not multiples of
    the kernel's 8-row unroll or 128-thread block). The kernel must equal
    its plain version bit for bit. Times and bound of the wave."""
    import torch
    from aphrodite_tpu_torch.ops.selective_scan import (ref_selective_scan,
                                                        selective_scan)
    res = {}
    for label, T, C, seg in (("wave", 4096, SCAN_COLUMNS, 512),
                             ("decode", 32, SCAN_COLUMNS, 1),
                             ("ragged", 4101, 1003, 700)):
        dA = 0.5 + 0.5 * torch.rand((T, C), generator=gen, device="cuda")
        dA[::seg] = 0.0
        dBx = torch.randn((T, C), generator=gen, device="cuda")
        out = selective_scan(dA, dBx)
        ref = ref_selective_scan(dA, dBx)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not (torch.equal(out, ref) and torch.isfinite(out).all()):
            raise AssertionError(f"selective_scan {label} T={T} C={C}: "
                                 f"differs from its plain version by {err}")
        ms = cuda_ms(lambda: selective_scan(dA, dBx), 20)
        plain_ms = cuda_ms(lambda: ref_selective_scan(dA, dBx), 1)
        b_ms, b_by = bound_ms(12.0 * T * C, 2.0 * T * C, "float32")
        log(f"# phase 2: selective_scan {label} fp32 T={T} C={C}: equal to "
            f"the plain version; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{12.0 * T * C / ms / 1e6:.0f} GB/s")
        res[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del dA, dBx, out, ref
    return res["wave"]


def tiny_parity() -> None:
    """fp32 greedy tokens through the port on the card and on the CPU, with
    the same weights, across chunked prefill and decode windows."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
               num_attention_heads=8, num_key_value_heads=2,
               intermediate_size=256, max_position_embeddings=1024,
               tie_word_embeddings=False, architectures=["Qwen2ForCausalLM"])
    kw = dict(hf_config=cfg, tokenizer="unused", dtype="float32",
              block_size=64, num_kv_blocks=64, max_num_seqs=4,
              max_num_batched_tokens=96, max_model_len=512)
    cpu = LLM("tiny", device="cpu", **kw)
    gpu = LLM("tiny", device="cuda", **kw)
    state = {k: v.numpy() for k, v in
             cpu.engine.core.worker.model.state_dict().items()}
    gpu.engine.core.worker.load_params(state)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 500, size=n).tolist()
               for n in (7, 150, 64, 90, 33)]
    params = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)
    a = [o.outputs[0].token_ids for o in cpu.generate(prompts, params)]
    b = [o.outputs[0].token_ids for o in gpu.generate(prompts, params)]
    if a != b:
        raise AssertionError(f"cuda vs cpu greedy tokens differ:\n{a}\n{b}")
    log(f"# phase 3: cuda == cpu greedy tokens for {len(prompts)} prompts "
        f"x 24 (chunked prefill + decode windows)")


def main_path() -> dict:
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention)
    from aphrodite_tpu_torch.ops.window_decode_attention import (
        window_decode_attention)
    num_prompts, prefix_len, decode_len = 64, 500, 50
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = LLM("qwen2.5-1.5b-dummy", hf_config=QWEN25_1P5B,
              tokenizer="unused", dtype="bfloat16", load_format="dummy",
              block_size=64, max_num_batched_tokens=16384, max_num_seqs=32,
              max_model_len=prefix_len + decode_len + 64, device="cuda")
    torch.cuda.synchronize()
    log(f"# phase 4: engine init {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(10, 1000, size=prefix_len).tolist()
               for _ in range(num_prompts)]
    params = SamplingParams(temperature=0.0, max_tokens=decode_len,
                            ignore_eos=True)

    def one_run() -> float:
        t = time.perf_counter()
        outs = llm.generate(prompts, params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        toks = [o.outputs[0].token_ids for o in outs]
        n = sum(len(x) for x in toks)
        if n != num_prompts * decode_len:
            raise AssertionError(f"expected {num_prompts * decode_len} "
                                 f"tokens, got {n}")
        if not all(0 <= t < QWEN25_1P5B["vocab_size"] for x in toks
                   for t in x):
            raise AssertionError("token id out of the vocabulary")
        return dt

    log(f"# phase 4: warm-up run {one_run():.3f} s")
    times, counts = [], {}
    for i in range(3):
        ragged_paged_attention.launches = 0
        window_decode_attention.launches = 0
        times.append(one_run())
        counts = {"ragged_paged_attention": ragged_paged_attention.launches,
                  "window_decode_attention": window_decode_attention.launches}
        log(f"# phase 4: run {i}: {times[-1]:.3f} s, launches {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {counts}")
    s = float(np.mean(times))
    log(f"# phase 4: {s:.3f} s/run (runs {times}); "
        f"{num_prompts * decode_len / s:.0f} decode tok/s; "
        f"{num_prompts * (prefix_len + decode_len) / s:.0f} tok/s "
        f"(prefill+decode); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_run(one_run)
    return counts


QWEN_2L = dict(QWEN25_1P5B, num_hidden_layers=2)


def quant_parity() -> dict:
    """fp32 greedy tokens through the port on the card and on the CPU with
    the same quantized weights, at Qwen2.5-1.5B widths (K 1536 and 8960:
    no W4 leaf packs) and 2 layers. Returns each kernel's launches on the
    card run."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 150000, size=n).tolist()
               for n in (7, 150, 64, 90, 33)]
    params = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)
    launches = {}
    for quant, kernel in (("gptq", "w4a16_matmul"),
                          ("w8a16", "w8a16_matmul")):
        kw = dict(hf_config=QWEN_2L, tokenizer="unused", dtype="float32",
                  quantization=quant, block_size=64, num_kv_blocks=64,
                  max_num_seqs=4, max_num_batched_tokens=96,
                  max_model_len=512)
        cpu = LLM("qwen-2l", device="cpu", **kw)
        gpu = LLM("qwen-2l", device="cuda", **kw)
        state = {k: v.numpy() for k, v in
                 cpu.engine.core.worker.model.state_dict().items()}
        gpu.engine.core.worker.load_params(state)
        a = [o.outputs[0].token_ids for o in cpu.generate(prompts, params)]
        for fn in qm.KERNELS.values():
            fn.launches = 0
        b = [o.outputs[0].token_ids for o in gpu.generate(prompts, params)]
        launches[kernel] = qm.KERNELS[kernel].launches
        if a != b:
            raise AssertionError(f"{quant}: cuda vs cpu greedy tokens "
                                 f"differ:\n{a}\n{b}")
        if launches[kernel] <= 0:
            raise AssertionError(f"{quant}: {kernel} was not launched")
        log(f"# phase 5: {quant}: cuda == cpu greedy tokens for "
            f"{len(prompts)} prompts x 24; {kernel} launches "
            f"{launches[kernel]}")
        del cpu, gpu
    return launches


def moe_parity() -> int:
    """fp32 greedy tokens through the port on the card and on the CPU with
    the same weights for a tiny Qwen2-MoE: 8 experts, top-2, a gated
    shared expert, layer 1 dense. Waves of up to 96 tokens take the
    grouped route (T * 2 >= 32), decode windows the dense one. Returns the
    grouped GEMM's launches on the card run."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.grouped_matmul import grouped_matmul
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(vocab_size=512, hidden_size=128, num_hidden_layers=3,
               num_attention_heads=8, num_key_value_heads=2,
               intermediate_size=256, moe_intermediate_size=72,
               shared_expert_intermediate_size=136, num_experts=8,
               num_experts_per_tok=2, norm_topk_prob=False,
               mlp_only_layers=[1], max_position_embeddings=1024,
               use_sliding_window=False, tie_word_embeddings=False,
               architectures=["Qwen2MoeForCausalLM"])
    kw = dict(hf_config=cfg, tokenizer="unused", dtype="float32",
              block_size=64, num_kv_blocks=64, max_num_seqs=4,
              max_num_batched_tokens=96, max_model_len=512)
    cpu = LLM("tiny-moe", device="cpu", **kw)
    gpu = LLM("tiny-moe", device="cuda", **kw)
    state = {k: v.numpy() for k, v in
             cpu.engine.core.worker.model.state_dict().items()}
    gpu.engine.core.worker.load_params(state)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 500, size=n).tolist()
               for n in (7, 150, 64, 90, 33)]
    params = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)
    a = [o.outputs[0].token_ids for o in cpu.generate(prompts, params)]
    grouped_matmul.launches = 0
    b = [o.outputs[0].token_ids for o in gpu.generate(prompts, params)]
    launches = grouped_matmul.launches
    if a != b:
        raise AssertionError(f"MoE: cuda vs cpu greedy tokens differ:\n{a}"
                             f"\n{b}")
    if launches <= 0:
        raise AssertionError("MoE: grouped_matmul was not launched")
    log(f"# phase 7: cuda == cpu greedy tokens for {len(prompts)} prompts "
        f"x 24 (tiny Qwen2-MoE); grouped_matmul launches {launches}")
    return launches


# Cold and warm runs of each serving phase through ``serve_workload``
# after its warm-up: two of each keep the whole script well inside its
# time limit.
SERVE_RUNS = 2


def serve_workload(phase: str, name: str, hf: dict, counted: dict,
                   batch_tokens: int = 16384,
                   per_forward: dict | None = None,
                   exact: dict | None = None, dtype: str = "bfloat16",
                   max_model_len: int = 704, logprobs: bool = False,
                   **llm_kw):
    """32 prompts x (512 + 64) greedy through ``LLM.generate`` at full
    width: one warm-up, ``SERVE_RUNS`` cold runs (prefix cache reset before
    each), as many warm runs (only where the engine caches prefixes; where
    it does not,
    every run must find no cached prompt token), one profiled run. Each
    run must give exactly 2048 tokens in the vocabulary; every kernel in
    ``counted`` must have
    launched in the cold runs, and every kernel in ``per_forward`` exactly
    that many times for each call of the model's ``forward`` in every cold
    run; every kernel in ``exact`` exactly that many times in every cold and
    warm run (0: never). With ``logprobs`` every token's logprob must be
    finite. Returns the last cold run's launches, the engine and the mean
    cold and warm walls."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    num_prompts, prompt_len, decode_len = 32, 512, 64
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"# {phase}: allocated before init "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    llm = LLM(name, hf_config=hf, tokenizer="unused", dtype=dtype,
              load_format="dummy", block_size=64, max_num_seqs=32,
              max_num_batched_tokens=batch_tokens,
              max_model_len=max_model_len, device="cuda", **llm_kw)
    torch.cuda.synchronize()
    log(f"# {phase}: engine init {time.perf_counter() - t0:.2f} s, weights "
        f"+ KV {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prefix_cache = llm.engine.config.cache_config.enable_prefix_caching
    model = llm.engine.core.worker.model
    forward = model.forward
    forwards = [0]

    def counted_forward(*a, **kw):
        forwards[0] += 1
        return forward(*a, **kw)
    model.forward = counted_forward
    rng = np.random.RandomState(0)
    top = min(100000, hf["vocab_size"] - 10)
    prompts = [rng.randint(10, top, size=prompt_len).tolist()
               for _ in range(num_prompts)]
    params = SamplingParams(temperature=0.0, max_tokens=decode_len,
                            ignore_eos=True, logprobs=1 if logprobs else None)

    def check_exact(got: dict) -> None:
        for k, want in (exact or {}).items():
            if got[k] != want:
                raise AssertionError(f"{k}: {got[k]} launches in a run, "
                                     f"want {want}")

    def one_run() -> float:
        for fn in counted.values():
            fn.launches = 0
        forwards[0] = 0
        t = time.perf_counter()
        outs = llm.generate(prompts, params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        toks = [o.outputs[0].token_ids for o in outs]
        n = sum(len(x) for x in toks)
        if n != num_prompts * decode_len:
            raise AssertionError(f"expected {num_prompts * decode_len} "
                                 f"tokens, got {n}")
        if not all(0 <= t < hf["vocab_size"] for x in toks for t in x):
            raise AssertionError("token id out of the vocabulary")
        if logprobs:
            finite_logprobs(phase, outs)
        one_run.cached = sum(o.num_cached_tokens for o in outs)
        return dt

    log(f"# {phase}: warm-up run {one_run():.3f} s")
    cold, warm, counts = [], [], {}
    for i in range(SERVE_RUNS):
        if not llm.engine.reset_prefix_cache():
            raise AssertionError("reset_prefix_cache refused")
        cold.append(one_run())
        counts = {k: fn.launches for k, fn in counted.items()}
        log(f"# {phase}: cold run {i}: {cold[-1]:.3f} s, cached prompt "
            f"tokens {one_run.cached}, launches {counts}, model forwards "
            f"{forwards[0]}")
        for k, per in (per_forward or {}).items():
            if counts[k] != per * forwards[0]:
                raise AssertionError(f"{k}: {counts[k]} launches for "
                                     f"{forwards[0]} forwards, want {per} "
                                     "each")
        if not prefix_cache and one_run.cached:
            raise AssertionError(f"{one_run.cached} cached prompt tokens "
                                 "with prefix caching off")
        check_exact(counts)
    if any(v <= 0 for k, v in counts.items() if k not in (exact or {})):
        raise AssertionError(f"a kernel was not launched: {counts}")
    for i in range(SERVE_RUNS if prefix_cache else 0):
        warm.append(one_run())
        wc = {k: fn.launches for k, fn in counted.items()}
        log(f"# {phase}: warm run {i}: {warm[-1]:.3f} s, cached prompt "
            f"tokens {one_run.cached}, launches {wc}")
        check_exact(wc)
    n_dec = num_prompts * decode_len
    n_all = num_prompts * (prompt_len + decode_len)
    walls = {}
    for label, ts in (("cold", cold), ("warm", warm)):
        if not ts:
            continue
        s = walls[label] = float(np.mean(ts))
        log(f"# {phase}: {label} {s:.3f} s/run (runs {ts}); "
            f"{n_dec / s:.0f} decode tok/s; {n_all / s:.0f} tok/s "
            "(prefill+decode)")
    log(f"# {phase}: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    llm.engine.reset_prefix_cache()
    profile_run(one_run, phase)
    return counts, llm, walls


def attention_kernels() -> dict:
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention)
    from aphrodite_tpu_torch.ops.window_decode_attention import (
        window_decode_attention)
    return {"ragged_paged_attention": ragged_paged_attention,
            "window_decode_attention": window_decode_attention}


def main_path_8b() -> tuple[dict, dict, dict]:
    """Llama-3.1-8B W4A16 at full width: the repo's BASELINE config 2
    workload (benchmarks/baseline_configs.py:118-128) through the port;
    then phase 20 on the same engine (``main_path_sampled``). Returns the
    launches of phase 6's last cold run and of a phase 20 run, and phase
    6's mean cold and warm walls."""
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    layers, steps = LLAMA31_8B["num_hidden_layers"], 63
    counts, llm, walls = serve_workload(
        "phase 6", "llama-3.1-8b-w4a16-dummy", LLAMA31_8B,
        {"w4a16_packed_matmul": qm.w4a16_packed_matmul,
         **attention_kernels()},
        exact={"w4a16_packed_matmul": 4 * layers * steps},
        quantization="gptq")
    stamp("phase 20")
    sampled = main_path_sampled(llm, walls)
    return counts, sampled, walls


def main_path_moe() -> dict:
    """Qwen1.5-MoE-A2.7B bf16 at full width and 6 of its 24 layers
    (``QWEN15_MOE_QUARTER``), the same traffic: one prefill wave (65536
    sorted rows a MoE layer: the grouped GEMM), then a 63-step decode
    window (32 rows: the dense expert combine)."""
    from aphrodite_tpu_torch.ops.grouped_matmul import grouped_matmul
    return serve_workload(
        "phase 8", "qwen1.5-moe-a2.7b-dummy", QWEN15_MOE_QUARTER,
        {"grouped_matmul": grouped_matmul, **attention_kernels()})[0]


def serve_bytes(phase: str, name: str, hf: dict, quantization: str,
                kernel: str, more_exact: dict | None = None,
                **llm_kw) -> dict:
    """A byte layout's path at full width and depth (phases 15, 16 and 18):
    phase 6's settings, traffic and runs with ``quantization`` on seeded
    dummy weights. Every decode GEMM is that layout's: ``kernel`` exactly 4
    x layers x 63 times a run, the other quantized GEMMs never (and the
    kernels of ``more_exact`` exactly so many times)."""
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    layers, steps = hf["num_hidden_layers"], 63
    exact = {k: 0 for k in qm.KERNELS}
    exact[kernel] = 4 * layers * steps
    exact.update(more_exact or {})
    log(f"# {phase}: launches a run, reckoned: {exact} (4 GEMMs x {layers} "
        f"layers x {steps} window steps)")
    return serve_workload(phase, name, hf, {**qm.KERNELS,
                                            **attention_kernels()},
                          exact=exact, quantization=quantization,
                          **llm_kw)[0]


def main_path_w8() -> dict:
    """Llama-3.1-8B W8A16 at full width and 16 of its 32 layers
    (``LLAMA31_8B_QUARTER``; phase 15): the W8 GEMM at M = 32 in every decode
    window step (every layer runs the same GEMMs)."""
    return serve_bytes("phase 15", "llama-3.1-8b-w8a16-dummy",
                       LLAMA31_8B_QUARTER, "w8a16", "w8a16_matmul")


def main_path_qwen7b_gptq() -> dict:
    """Qwen2.5-7B GPTQ (group 128) at full width and 14 of its 28 layers
    (``QWEN25_7B_QUARTER``; phase 16): no projection packs, so every decode
    GEMM is the uint4 one; 7 query heads a KV head in the ragged and
    window kernels."""
    return serve_bytes("phase 16", "qwen2.5-7b-gptq-dummy", QWEN25_7B_QUARTER,
                       "gptq", "w4a16_matmul")


SSM_TINY = {  # tiny geometries of the three SSM families
    "MambaForCausalLM": dict(
        model_type="mamba", intermediate_size=128, time_step_rank=8,
        use_conv_bias=True, use_bias=True),
    "FalconMambaForCausalLM": dict(
        model_type="falcon_mamba", intermediate_size=128, time_step_rank=8,
        mixer_rms_eps=1e-6),
    "Mamba2ForCausalLM": dict(
        model_type="mamba2", expand=2, head_dim=16, num_heads=8, n_groups=2),
}


def redraw_at_fan_in(model, seed: int) -> None:
    """Weights at fan-in scale from a seeded CPU generator (the dummy
    recipe's 0.02 and zero biases make a near-identity model whose greedy
    tokens hardly depend on the state)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("dt_b", "dt_bias"):
                new = -1.0 - 2.0 * torch.rand(p.shape, generator=g)
            elif leaf == "A_log":
                new = p.float() + 0.1 * torch.randn(p.shape, generator=g)
            elif leaf == "conv_w":
                new = 0.5 * torch.randn(p.shape, generator=g)
            elif leaf.endswith("_b"):
                new = 0.1 * torch.randn(p.shape, generator=g)
            elif p.dim() == 2:  # [fan_in, fan_out] projections, embed
                new = torch.randn(p.shape, generator=g) / p.shape[0] ** 0.5
            else:  # norms, D
                new = 1.0 + 0.1 * torch.randn(p.shape, generator=g)
            p.copy_(new.to(p.dtype))


def ssm_parity() -> None:
    """fp32 greedy tokens through the port on the card and on the CPU with
    the same weights for a tiny Mamba, FalconMamba and Mamba-2: chunked
    prefill at a 16-token budget (state carried across the seams), ragged
    max_tokens (frozen rows in decode windows)."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.selective_scan import selective_scan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 250, size=n).tolist()
               for n in (5, 40, 17, 33, 2, 21)]
    params = [SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True)
              for n in (24, 9, 17, 24, 3, 12)]
    for arch, geom in SSM_TINY.items():
        cfg = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                   state_size=8, conv_kernel=4, tie_word_embeddings=False,
                   architectures=[arch], **geom)
        kw = dict(hf_config=cfg, tokenizer="unused", dtype="float32",
                  block_size=16, max_num_seqs=4, max_num_batched_tokens=16,
                  max_model_len=256)
        cpu = LLM("tiny-ssm", device="cpu", **kw)
        redraw_at_fan_in(cpu.engine.core.worker.model, 5)
        gpu = LLM("tiny-ssm", device="cuda", **kw)
        state = {k: v.numpy() for k, v in
                 cpu.engine.core.worker.model.state_dict().items()}
        gpu.engine.core.worker.load_params(state)
        a = [o.outputs[0].token_ids for o in cpu.generate(prompts, params)]
        selective_scan.launches = 0
        b = [o.outputs[0].token_ids for o in gpu.generate(prompts, params)]
        if a != b:
            raise AssertionError(f"{arch}: cuda vs cpu greedy tokens "
                                 f"differ:\n{a}\n{b}")
        if selective_scan.launches <= 0:
            raise AssertionError(f"{arch}: selective_scan was not launched")
        log(f"# phase 9: {arch}: cuda == cpu greedy tokens for "
            f"{len(prompts)} prompts (16-token chunks, ragged max_tokens); "
            f"selective_scan launches {selective_scan.launches}")
        del cpu, gpu


def main_path_mamba() -> dict:
    """Mamba-2.8B bf16 at full width (``MAMBA_DEPTH`` of its 64 layers:
    every layer runs the same scan), phase 6's traffic at the
    JAX SSM bench's 4096-token budget (benchmarks/ssm_bench.py:52):
    prefill waves of up to 4096 tokens (each [4096, 5120, 16] fp32 scan
    input 1.34 GB), then a decode window of 32 one-token rows. The scan must run
    once a layer in every forward of the runner."""
    from aphrodite_tpu_torch.ops.selective_scan import selective_scan
    hf = dict(MAMBA_2P8B, num_hidden_layers=MAMBA_DEPTH)
    log(f"# phase 10: depth cut to {MAMBA_DEPTH} of "
        f"{MAMBA_2P8B['num_hidden_layers']} layers")
    return serve_workload(
        "phase 10", "mamba-2.8b-dummy", hf,
        {"selective_scan": selective_scan}, batch_tokens=4096,
        per_forward={"selective_scan": MAMBA_DEPTH})[0]


GEMMA2_9B = dict(  # google/gemma-2-9b config.json
    vocab_size=256000, hidden_size=3584, num_hidden_layers=42,
    num_attention_heads=16, num_key_value_heads=8, head_dim=256,
    intermediate_size=14336, hidden_act="gelu_pytorch_tanh",
    hidden_activation="gelu_pytorch_tanh", rms_norm_eps=1e-6,
    rope_theta=10000.0, query_pre_attn_scalar=256,
    attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
    sliding_window=4096, max_position_embeddings=8192,
    tie_word_embeddings=True, model_type="gemma2",
    architectures=["Gemma2ForCausalLM"])
# Phase 12's layers: half the published 42 (every layer runs the same
# kernels; the sliding and global layers alternate), to keep the script
# inside its time limit.
GEMMA2_9B_QUARTER = dict(GEMMA2_9B, num_hidden_layers=11)

GEMMA_TINY = {  # phase 11: tiny Gemma-2 (head_dim 256) and Gemma-3 (MQA)
    "Gemma2ForCausalLM": dict(
        num_attention_heads=4, num_key_value_heads=2, head_dim=256,
        model_type="gemma2"),
    "Gemma3ForCausalLM": dict(
        num_attention_heads=4, num_key_value_heads=1, head_dim=128,
        rope_theta=1000000.0, rope_local_base_freq=10000.0,
        rope_scaling={"rope_type": "linear", "factor": 8.0},
        layer_types=["sliding_attention", "sliding_attention",
                     "full_attention"], model_type="gemma3_text"),
}


def redraw_gemma(model, seed: int) -> None:
    """Weights at fan-in scale from a seeded CPU generator, norms (stored
    as w - 1) near 0 and the embedding 4x smaller than fan-in scale: with
    the dummy recipe, and with a fan-in scale embedding that the sqrt(H)
    input scale makes dominate, Gemma repeats its input token."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                new = 0.1 * torch.randn(p.shape, generator=g)
            elif name == "embed":
                new = torch.randn(p.shape, generator=g) / (4 * p.shape[1]
                                                           ** 0.5)
            else:  # [fan_in, fan_out] projections
                new = torch.randn(p.shape, generator=g) / p.shape[0] ** 0.5
            p.copy_(new.to(p.dtype))


def gemma_parity(kv: str = "auto", archs=tuple(GEMMA_TINY)) -> int:
    """fp32 greedy tokens through the port on the card and on the CPU with
    the same weights for a tiny Gemma-2 and Gemma-3: a 16-token sliding
    window, attention and final soft caps, prompts past the window, 16-step
    decode windows on the decode kernel. ``kv``: the KV cache's dtype
    (phase 17 runs Gemma-2 on "fp8_e4m3", its tokens compared by
    ``same_tokens``). Returns the decode kernel's launches on the card
    runs."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.decode_paged_attention import (
        decode_paged_attention)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 250, size=n).tolist()
               for n in (5, 40, 17, 33, 70)]
    params = [SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True)
              for n in (24, 9, 30, 17, 24)]
    total = 0
    phase = "phase 11" if kv == "auto" else "phase 17"
    for arch in archs:
        geom = GEMMA_TINY[arch]
        cfg = dict(vocab_size=256, hidden_size=64, num_hidden_layers=3,
                   intermediate_size=128, sliding_window=16,
                   query_pre_attn_scalar=24, attn_logit_softcapping=50.0,
                   final_logit_softcapping=30.0, max_position_embeddings=512,
                   architectures=[arch], **geom)
        kw = dict(hf_config=cfg, tokenizer="unused", dtype="float32",
                  block_size=16, num_kv_blocks=128, max_num_seqs=4,
                  max_num_batched_tokens=32, max_model_len=256,
                  decode_window=16, kv_cache_dtype=kv)
        cpu = LLM("tiny-gemma", device="cpu", **kw)
        redraw_gemma(cpu.engine.core.worker.model, 6)
        gpu = LLM("tiny-gemma", device="cuda", **kw)
        state = {k: v.numpy() for k, v in
                 cpu.engine.core.worker.model.state_dict().items()}
        gpu.engine.core.worker.load_params(state)
        a = traced(cpu, prompts, params)
        decode_paged_attention.launches = 0
        b = traced(gpu, prompts, params)
        launches = decode_paged_attention.launches
        found = []
        if kv != "auto":
            found = same_tokens(f"{phase} {arch} {kv}", cpu, gpu, prompts,
                                a, b)
        elif a[0] != b[0]:
            raise AssertionError(f"{arch}: cuda vs cpu greedy tokens "
                                 f"differ:\n{a[0]}\n{b[0]}")
        if launches <= 0:
            raise AssertionError(f"{arch}: decode_paged_attention was not "
                                 "launched")
        if len({t for x in a[0] for t in x}) <= 10:
            raise AssertionError(f"{arch}: the tokens hardly vary: {a[0]}")
        total += launches
        log(f"# {phase}: {arch}: cuda == cpu greedy tokens for "
            f"{len(prompts)} prompts (window 16, soft caps, 16-step decode "
            f"windows, {kv} cache"
            + (f", partings {found}" if found else "")
            + f"); decode_paged_attention launches {launches}")
        del cpu, gpu
    return total


def main_path_gemma() -> dict:
    """Gemma-2-9B bf16 at full width and 11 of its 42 layers
    (``GEMMA2_9B_QUARTER``), phase 6's traffic: one 16384-token prefill wave
    (the ragged kernel's tensor-core instance, 64-row items at head_dim
    256), then one 63-step decode window through the runner's non-window
    multi-step path: the decode kernel once a layer a sub-step, 11 x 63 =
    693 launches a run, and the window kernel never."""
    from aphrodite_tpu_torch.ops.decode_paged_attention import (
        decode_paged_attention)
    L = GEMMA2_9B_QUARTER["num_hidden_layers"]
    kernels = {"decode_paged_attention": decode_paged_attention,
               **attention_kernels()}
    return serve_workload(
        "phase 12", "gemma-2-9b-dummy", GEMMA2_9B_QUARTER, kernels,
        exact={"decode_paged_attention": L * 63,
               "ragged_paged_attention": L,
               "window_decode_attention": 0})[0]


def int4_cascade_parity(kv: str = "auto"):
    """fp32 greedy tokens through the port on the card and on the CPU with
    the same weights: a one-layer Llama at K = 2048 (every W4 leaf packs
    under gptq's group of 128), realized to native int4, 72 prompts sharing
    a 100-token prefix on 16-token pages (decode M = 72, 6 shared pages).
    On the card, the tokens again with the cascade turned off. ``kv``: the
    KV cache's dtype (phase 17 runs "fp8_e4m3", its tokens compared by
    ``same_tokens``). Returns the int4 kernel's launches on the first card
    run (phase 17: the int4 kernel's and the shared pass's)."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.loader.weights import realize_int4_leaves
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    from aphrodite_tpu_torch.ops.cascade_attention import (
        shared_prefix_attention)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(vocab_size=512, hidden_size=2048, num_hidden_layers=1,
               num_attention_heads=16, num_key_value_heads=2,
               intermediate_size=2048, max_position_embeddings=1024,
               tie_word_embeddings=False, architectures=["LlamaForCausalLM"])
    kw = dict(hf_config=cfg, tokenizer="unused", dtype="float32",
              quantization="gptq", block_size=16, num_kv_blocks=1024,
              max_num_seqs=80, max_num_batched_tokens=2048,
              max_model_len=256, kv_cache_dtype=kv)
    phase = "phase 13" if kv == "auto" else "phase 17"
    rng = np.random.RandomState(7)
    shared = rng.randint(1, 500, size=100).tolist()
    prompts = [shared + rng.randint(1, 500, size=1 + i % 9).tolist()
               for i in range(72)]
    params = SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)
    cpu = LLM("tiny-int4", device="cpu", **kw)
    realize_int4_leaves(cpu.engine.core.worker.model)
    gpu = LLM("tiny-int4", device="cuda", **kw)
    realize_int4_leaves(gpu.engine.core.worker.model)
    gpu.engine.core.worker.load_params(
        cpu.engine.core.worker.model.state_dict())
    a = traced(cpu, prompts, params)
    runner = gpu.engine.core.worker.runner
    detect = runner._detect_shared_prefix
    found = []
    runner._detect_shared_prefix = lambda *x: found.append(detect(*x)) or \
        found[-1]
    qm.w4a16_int4_matmul.launches = 0
    shared_prefix_attention.launches = 0
    b = traced(gpu, prompts, params)
    launches = qm.w4a16_int4_matmul.launches
    passes = shared_prefix_attention.launches
    runner._detect_shared_prefix = lambda *x: None
    gpu.engine.reset_prefix_cache()
    shared_prefix_attention.launches = 0
    c = traced(gpu, prompts, params)
    off_passes = shared_prefix_attention.launches
    parted = []
    if kv != "auto":
        parted = same_tokens(f"{phase} int4 + cascade {kv}", cpu, gpu,
                             prompts, a, b)
        parted += same_tokens(f"{phase} int4 cascade off {kv}", cpu, gpu,
                              prompts, a, c)
    elif a[0] != b[0]:
        raise AssertionError(f"int4 + cascade: cuda vs cpu greedy tokens "
                             f"differ:\n{a[0]}\n{b[0]}")
    if (kv == "auto" and b[0] != c[0]) or off_passes:
        raise AssertionError(f"cuda tokens with the cascade differ from "
                             f"those without it:\n{b[0]}\n{c[0]}")
    if launches <= 0 or passes <= 0 or not any(found):
        raise AssertionError(f"int4 launches {launches}, shared-prefix "
                             f"passes {passes}, shared prefixes {found}")
    if len({t for x in a[0] for t in x}) <= 10:
        raise AssertionError(f"the tokens hardly vary: {a[0]}")
    log(f"# {phase}: cuda == cpu greedy tokens for {len(prompts)} prompts "
        f"x 12 (int4, decode M = 72, shared prefix {found[-1][1]} tokens, "
        f"{kv} cache" + (f", partings {parted}" if parted else "")
        + "), and == "
        f"cuda with the cascade off; w4a16_int4_matmul launches {launches}, "
        f"shared_prefix_attention launches {passes}")
    del cpu, gpu
    if kv != "auto":
        return {"w4a16_int4_matmul": launches,
                "shared_prefix_attention": passes}
    return launches


# Phase 17: (quantization, kv_cache_dtype) of the fp32 parity runs at
# Qwen2.5-1.5B widths, and the bound on the card's and the CPU's
# disagreement where their greedy runs part (``same_tokens``): W8A8 and an
# fp8 cache round activations or K/V to 8 bits, so two runs whose fp32
# products differ in the last bit may pick either of two tokens whose
# logprobs are close; GAP bounds how far the two engines' logprob
# differences of those two tokens may lie apart.
# Phase 17's quantized runs (fp32): int8 W8A8 (``torch._int_mm``, a
# library call) is held card = CPU in phase 30 (fp16) and in phase 2
# (``check_int_mm``).
FP8_PARITY = (("fp8", "fp8_e4m3"), ("fp8_w8a8", "fp8_e5m2"))
GAP = 5e-2


def traced(llm, prompts: list, params) -> tuple:
    """``llm``'s greedy tokens for ``prompts`` (``params``: one
    SamplingParams or one a prompt) and, for each request, the log-softmax
    rows its tokens were picked from: the sampler's ``greedy_sample`` (which
    ``sample_tokens`` runs for an all-greedy batch) is wrapped and its rows
    matched to requests by each step's output (row r of a step's k-th
    sample is request ``req_ids[r]``'s k-th token)."""
    import aphrodite_tpu_torch.sample.sampler as runner_mod
    runner, sample = llm.engine.core.worker.runner, runner_mod.greedy_sample
    execute = runner.execute_model
    seen, rows = [], {}

    def spy(logits):
        seen.append(logits.float().log_softmax(-1).cpu())
        return sample(logits)

    def step(so):
        seen.clear()
        out = execute(so)
        for r, (rid, toks) in enumerate(zip(out.req_ids,
                                            out.sampled_token_ids)):
            rows.setdefault(rid, []).extend(seen[k][r]
                                            for k in range(len(toks)))
        return out
    runner_mod.greedy_sample, runner.execute_model = spy, step
    try:
        outs = llm.generate(prompts, params)
    finally:
        runner_mod.greedy_sample = sample
        del runner.execute_model
    return ([o.outputs[0].token_ids for o in outs],
            [rows[o.request_id] for o in outs])


def partings(cpu, other, prompts: list, a: tuple, b: tuple) -> list:
    """Where ``other``'s greedy run ``b`` parts from the CPU's ``a`` (each
    ``traced``: tokens and rows). At a request's first differing step i
    both picked from the same tokens before i; the gap there is the CPU's
    logprob margin of its token over the other's plus the other's margin
    of its own over the CPU's: how far the two engines' logprob
    differences of the two tokens lie apart. Both then go on from the
    prompt and the CPU's tokens through i (a new run each, one request
    alone; a prompt with images keeps them), compared the same way, so that
    every later token is compared too. Returns (request, step, cpu token,
    other token, gap) for each."""
    from aphrodite_tpu_torch import SamplingParams

    def extended(prompt, toks: list):
        if isinstance(prompt, dict):
            return dict(prompt,
                        prompt_token_ids=prompt["prompt_token_ids"] + toks)
        return prompt + toks
    found = []
    for r, prompt in enumerate(prompts):
        base, done = prompt, 0
        (want, lw), (got, lg) = (a[0][r], a[1][r]), (b[0][r], b[1][r])
        n = len(want)
        while True:
            i = next((i for i in range(len(want)) if want[i] != got[i]),
                     None)
            if i is None:
                break
            w, g = want[i], got[i]
            gap = (lw[i][w] - lw[i][g] + lg[i][g] - lg[i][w]).item()
            found.append((r, done + i, w, g, round(gap, 5)))
            base, done = extended(base, want[:i + 1]), done + i + 1
            if done == n:
                break
            params = SamplingParams(temperature=0.0, max_tokens=n - done,
                                    ignore_eos=True)
            (want,), (lw,) = traced(cpu, [base], params)
            (got,), (lg,) = traced(other, [base], params)
    return found


def same_tokens(what: str, cpu, gpu, prompts: list, a: tuple,
                b: tuple) -> list:
    """The card's greedy run ``b`` against the CPU's ``a`` (``traced``)
    where 8-bit activations or K/V make a run's tokens depend on its
    products' last bits: every parting's gap (``partings``) must be below
    GAP, and at most a tenth of the tokens may part. Returns the
    partings."""
    found = partings(cpu, gpu, prompts, a, b)
    wide = [p for p in found if not p[-1] < GAP]
    if wide or len(found) > sum(map(len, a[0])) // 10:
        raise AssertionError(
            f"{what}: partings (request, step, cpu token, card token, gap) "
            f"{found}; gaps >= {GAP}: {wide}; at most "
            f"{sum(map(len, a[0])) // 10} may part:\n{a[0]}\n{b[0]}")
    return found


def fp8_parity() -> dict:
    """Phase 17: fp32 greedy tokens through the port on the card and on the
    CPU with the same weights (``same_tokens``): a 2-layer Qwen2.5-1.5B
    (phase 5's widths) for each of ``FP8_PARITY``, a tiny Gemma-2 on an
    e4m3 cache (the decode kernel's fp8 instance; phase 11's model) and the
    int4 + cascade layer on an e4m3 cache (the shared pass's; phase 13's
    model). Returns each kernel's launches on the card runs, keyed by
    (kernel, run)."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 150000, size=n).tolist()
               for n in (7, 150, 64, 90, 33)]
    params = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)
    kernels = {**qm.KERNELS, **attention_kernels()}
    launches = {}
    for quant, kv in FP8_PARITY:
        kw = dict(hf_config=QWEN_2L, tokenizer="unused", dtype="float32",
                  quantization=quant, kv_cache_dtype=kv, block_size=64,
                  num_kv_blocks=64, max_num_seqs=4, max_num_batched_tokens=96,
                  max_model_len=512)
        cpu = LLM("qwen-2l", device="cpu", **kw)
        gpu = LLM("qwen-2l", device="cuda", **kw)
        gpu.engine.core.worker.load_params(
            cpu.engine.core.worker.model.state_dict())
        a = traced(cpu, prompts, params)
        for fn in kernels.values():
            fn.launches = 0
        b = traced(gpu, prompts, params)
        run = f"{quant}/{kv}"
        got = {k: fn.launches for k, fn in kernels.items()}
        for k, n in got.items():
            launches[(k, run)] = n
        found = same_tokens(f"phase 17 {run}", cpu, gpu, prompts, a, b)
        want = {"fp8_matmul"} if quant.startswith("fp8") else set()
        if any(got[k] <= 0 for k in want | set(attention_kernels())) or any(
                got[k] for k in qm.KERNELS if k not in want):
            raise AssertionError(f"phase 17 {run}: launches {got}")
        log(f"# phase 17: {run}: cuda == cpu greedy tokens for "
            f"{len(prompts)} prompts x 24 but at partings (request, step, "
            f"cpu token, card token, gap < {GAP}) {found}; launches {got}")
        del cpu, gpu
    launches[("decode_paged_attention", "gemma2/fp8_e4m3")] = gemma_parity(
        "fp8_e4m3", archs=("Gemma2ForCausalLM",))
    launches.update({(k, "int4-cascade/fp8_e4m3"): v for k, v in
                     int4_cascade_parity("fp8_e4m3").items()})
    return launches


def main_path_fp8() -> dict:
    """Phase 18: BASELINE config 3 (``benchmarks/baseline_configs.py:
    137-140``): Llama-3.1-8B with fp8 weights (e4m3, a scale a column,
    quantized on the fly from seeded dummy weights) and an fp8 e4m3 KV
    cache at full width and half its depth (``LLAMA31_8B_HALF``), bf16,
    phase 6's settings, traffic and runs: kFp8 exactly 4 x 16 x 63 = 4032
    times a run, the other quantized GEMMs never, the ragged kernel 16 and
    the window kernel 1008 times (on the e4m3 cache and tails)."""
    layers, steps = LLAMA31_8B_HALF["num_hidden_layers"], 63
    return serve_bytes("phase 18", "llama-3.1-8b-fp8-dummy", LLAMA31_8B_HALF,
                       "fp8", "fp8_matmul",
                       {"ragged_paged_attention": layers,
                        "window_decode_attention": layers * steps},
                       kv_cache_dtype="fp8_e4m3")


def main_path_int4_cascade() -> dict:
    """Llama-3.1-8B W4A16 (gptq, group 128) realized to native int4, bf16,
    at full width and half its depth (``LLAMA31_8B_HALF``): 128 requests whose
    prompts start with one seeded 1024-token system prompt, each with a
    128-token suffix new in every run (seeded by the run's index), 64 greedy
    tokens. A warm-up run caches the prefix; each timed run then prefills one
    16384-token wave and decodes one 63-step window at R = 128 whose requests
    share 16 pages. Every run must give exactly 8192 tokens, find 131072 cached
    prompt tokens and launch each kernel exactly as reckoned."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.loader.weights import realize_int4_leaves
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    from aphrodite_tpu_torch.ops.cascade_attention import (
        shared_prefix_attention)
    phase = "phase 14"
    R, S, n_suf, n_dec = (CASCADE_R, CASCADE_S, CASCADE_SUFFIX,
                          CASCADE_DECODE)
    L = LLAMA31_8B_HALF["num_hidden_layers"]
    steps = n_dec - 1  # the first token comes from the prefill wave
    kernels = {"w4a16_int4_matmul": qm.w4a16_int4_matmul,
               "w4a16_packed_matmul": qm.w4a16_packed_matmul,
               "shared_prefix_attention": shared_prefix_attention,
               **attention_kernels()}
    exact = {"w4a16_int4_matmul": 4 * L * steps,
             "shared_prefix_attention": L * steps,
             "window_decode_attention": L * steps,
             "ragged_paged_attention": L, "w4a16_packed_matmul": 0}
    log(f"# {phase}: launches a run, reckoned: {exact} (4 GEMMs x {L} "
        f"layers x {steps} window steps; one pass and one window launch a "
        f"layer a step; one {R * n_suf}-token wave)")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = LLM("llama-3.1-8b-w4a16-int4-dummy", hf_config=LLAMA31_8B_HALF,
              tokenizer="unused", dtype="bfloat16", load_format="dummy",
              quantization="gptq", block_size=PAGE, max_num_seqs=R,
              max_num_batched_tokens=R * n_suf, max_model_len=1280,
              device="cuda")
    realize_int4_leaves(llm.engine.core.worker.model)
    torch.cuda.synchronize()
    log(f"# {phase}: engine init + realize {time.perf_counter() - t0:.2f} "
        f"s, weights + KV {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    top = LLAMA31_8B_HALF["vocab_size"] - 10
    prefix = np.random.RandomState(0).randint(10, top, size=S).tolist()
    params = SamplingParams(temperature=0.0, max_tokens=n_dec,
                            ignore_eos=True)
    runs = [0]

    def one_run() -> float:
        rng = np.random.RandomState(1000 + runs[0])
        runs[0] += 1
        prompts = [prefix + rng.randint(10, top, size=n_suf).tolist()
                   for _ in range(R)]
        for fn in kernels.values():
            fn.launches = 0
        t = time.perf_counter()
        outs = llm.generate(prompts, params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        toks = [o.outputs[0].token_ids for o in outs]
        if sum(len(x) for x in toks) != R * n_dec:
            raise AssertionError(f"expected {R * n_dec} tokens")
        if not all(0 <= t < LLAMA31_8B_HALF["vocab_size"] for x in toks
                   for t in x):
            raise AssertionError("token id out of the vocabulary")
        one_run.cached = sum(o.num_cached_tokens for o in outs)
        one_run.counts = {k: fn.launches for k, fn in kernels.items()}
        return dt

    def check(label: str) -> None:
        if one_run.counts != exact or one_run.cached != R * S:
            raise AssertionError(
                f"{label}: launches {one_run.counts}, cached prompt tokens "
                f"{one_run.cached}; want {exact} and {R * S}")

    log(f"# {phase}: warm-up run {one_run():.3f} s, cached prompt tokens "
        f"{one_run.cached}, launches {one_run.counts}")
    times = []
    for i in range(3):
        times.append(one_run())
        log(f"# {phase}: run {i}: {times[-1]:.3f} s, cached prompt tokens "
            f"{one_run.cached}, launches {one_run.counts}")
        check(f"run {i}")
    s_run = float(np.mean(times))
    log(f"# {phase}: {s_run:.3f} s/run (runs {times}); "
        f"{R * n_dec / s_run:.0f} decode tok/s; "
        f"{R * (S + n_suf + n_dec) / s_run:.0f} tok/s (prompt+decode); peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_run(one_run, phase)
    check("profiled run")
    counts = one_run.counts
    del llm
    return counts


def profile_run(one_run, phase: str = "phase 4",
                spans: tuple = ("aten::bmm",)) -> dict:
    """One more run under torch.profiler: device busy share of the wall
    time, device time by kernel family, and the device time launched under
    each host range named in ``spans`` (an op such as ``aten::bmm``, or a
    ``record_function`` range that ``one_run`` opens). Returns the device
    ns and launches of each kernel by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = one_run()
    t0 = time.perf_counter()
    # The raw events, read once: key_averages() would build a tree over
    # every host op of the run (minutes for a Mamba run). A device event's
    # linked_correlation_id is the correlation_id of the host op that
    # launched it, as key_averages() itself pairs them.
    kernels: dict[str, list] = {}  # name -> [device ns, launches]
    links: dict[int, list] = {}    # host op correlation id -> [ns, kernels]
    host_ops, span_of = [], {name: {} for name in spans}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if e.name() in span_of:  # a range's mirror on the device
                continue
            ns = e.end_ns() - e.start_ns()
            k = kernels.setdefault(e.name(), [0, 0])
            k[0] += ns
            k[1] += 1
            link = links.setdefault(e.linked_correlation_id(), [0, 0])
            link[0] += ns
            link[1] += 1
        elif e.linked_correlation_id() == 0:
            host_ops.append(e)
            if e.name() in span_of:
                span_of[e.name()].setdefault(e.start_thread_id(), []).append(
                    (e.start_ns(), e.end_ns()))
    fam = {"ragged": 0.0, "ragged (spans)": 0.0, "window": 0.0,
           "decode": 0.0, "cascade": 0.0,
           "quant": 0.0, "int4": 0.0, "fp8": 0.0, "moe": 0.0, "scan": 0.0,
           "sample": 0.0, "gemm": 0.0, "other": 0.0}
    for name, (ns, _) in kernels.items():
        n = name.lower()
        # the tensor-core instance's span switch: its 4th template argument
        k = ("ragged (spans)" if re.search(r"rpa_tc_kernel<\w+, \d+, \w+, "
                                           r"\w+, true", n) else
             "ragged" if "rpa_kernel" in n or "rpa_tc_kernel" in n
             or re.search(r"mla_kernel<\w+, false,", n) else
             "window" if "wd_split" in n or "wd_merge" in n
             or re.search(r"mla_kernel<\w+, true,", n)
             or "mla_merge" in n else
             "decode" if "dpa_" in n else
             "cascade" if "spa_kernel" in n or "spa_tc_kernel" in n else
             "fp8" if "w4_wgmma_kernel<4" in n else
             "quant" if "qmm_" in n or any(f"w4_wgmma_kernel<{i}" in n
                                            for i in (1, 2, 3)) else
             "int4" if "q4_kernel" in n or "w4_wgmma_kernel<0" in n else
             "moe" if "gmm_" in n else
             "scan" if "scan_kernel" in n else
             "sample" if "gumbel_" in n or "history_pass" in n else
             "gemm" if any(s in n for s in ("gemm", "cutlass", "sm90_xmma",
                                            "gemv", "nvjet")) else "other")
        fam[k] += ns / 1e9
    busy = sum(fam.values())
    # Device time under each span, its child ops included: under aten::bmm
    # the MoE dense (decode) expert combine's batched products (phase 8) or
    # the Mamba hs . C contraction (phase 10), the only bmm of the port's
    # forwards; under "sample" the sampler (phase 20).
    under, host = dict.fromkeys(spans, 0), dict.fromkeys(spans, 0)
    launched = dict.fromkeys(spans, 0)
    for name, by_thread in span_of.items():
        for ranges in by_thread.values():
            ranges.sort()
            host[name] += sum(b - a for a, b in ranges)
        for e in host_ops:
            ranges = by_thread.get(e.start_thread_id())
            if ranges and e.name() != name:
                i = bisect.bisect_right(ranges, (e.start_ns(), math.inf)) - 1
                if i >= 0 and e.start_ns() <= ranges[i][1]:
                    ns, n = links.get(e.correlation_id(), (0, 0))
                    under[name] += ns
                    launched[name] += n
    log(f"# {phase} profile: wall {wall:.3f} s (profiled), device busy "
        f"{busy:.3f} s ({busy / wall:.1%}); " + ", ".join(
            f"{k} {v:.3f} s" for k, v in fam.items())
        + "; of which " + ", ".join(
            f"under {k} {v / 1e9:.3f} s in {launched[k]} kernels (its host "
            f"ranges {host[k] / 1e9:.3f} s)" for k, v in under.items())
        + f"; trace read in {time.perf_counter() - t0:.1f} s")
    for name, (ns, count) in sorted(kernels.items(),
                                    key=lambda kv: -kv[1][0])[:8]:
        log(f"# {phase} profile: {ns / 1e6:9.1f} ms x{count:<6d} "
            f"{name[:90]}")
    return kernels


KERNEL_SOURCES = ["ragged_paged_attention", "ragged_spans", "ragged_f16",
                  "ragged_spans_f16", "window_decode_attention",
                  "decode_paged_attention", "quant_matmul", "grouped_matmul",
                  "selective_scan", "shared_prefix_attention", "w4_wgmma",
                  "w4_wgmma_f16", "gumbel_sample", "history_pass",
                  "mla_attention", "mla_attention_f16", "mla_opts",
                  "mla_opts_f16", "grouped_matmul_f16"]


# Run by each checkout in ``compare_serving``: the host time a call of the
# decode wrapper (Gemma-2-9B's decode step) and of the shared-prefix
# wrapper (phase 14's), each called as that checkout's runner calls it
# (with the window's plan where the checkout has one); then the window
# kernel's device time at the bf16 paths' shapes.
HOST_PROBE = """
import time, torch
from aphrodite_tpu_torch.ops import cascade_attention as cm
from aphrodite_tpu_torch.ops import decode_paged_attention as dm
def per_call(fn, reps=200):
    fn(); torch.cuda.synchronize(); t0 = time.perf_counter()
    for _ in range(reps): fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps; torch.cuda.synchronize()
    return ms
gen = torch.Generator(device='cuda').manual_seed(0)
nq, kvh, hd, ctx, opts = c.DECODE_CASES['gemma-2-9b']
cache, bt = c.paged_cache(gen, ctx, torch.bfloat16, kvh, hd=hd)
sl = torch.tensor(ctx, dtype=torch.int32, device='cuda')
q = torch.randn((len(ctx), nq, hd), generator=gen, device='cuda').bfloat16()
kw = dict(opts)
if hasattr(dm, 'decode_plan'):
    kw['plan'] = dm.decode_plan(torch.bfloat16, len(ctx), nq, kvh, hd,
                                q.device, max(ctx) + 63)
dec = per_call(lambda: dm.decode_paged_attention(q, cache, 1, bt, sl,
                                                 hd ** -0.5, **kw))
cache, shared, bt = c.cascade_cache(gen, torch.bfloat16, 128, 1024, 1152, 64)
q = torch.randn((128, 32, 128), generator=gen, device='cuda').bfloat16()
args = [q, cache, 1, shared, 1024, 128 ** -0.5]
if hasattr(cm, 'shared_prefix_plan'):
    args.append(cm.shared_prefix_plan(torch.bfloat16, 128, 32, 8, 128, 1024,
                                      q.device))
spa = per_call(lambda: cm.shared_prefix_attention(*args))
print(f'# host a call: decode_paged_attention {dec:.4f} ms, '
      f'shared_prefix_attention {spa:.4f} ms', flush=True)
del cache, q, args
for path in ('qwen2.5-1.5b-bf16', 'llama-3.1-8b-w4a16',
             'qwen1.5-moe-a2.7b-bf16', 'gemma-2-9b-bf16'):
    r = c.check_window(gen, 'bfloat16', c.ATTN_GEOMS[path])
    print(f"# window_decode_attention bf16 at {path}: device "
          f"{r['device_ms']:.4f} ms, max_abs_err {r['max_abs_err']:.3g}",
          flush=True)
"""

# Run by each checkout in ``compare_serving`` after ``HOST_PROBE``: the bf16
# grouped GEMM at phase 8's shapes, as that checkout's phase 2 holds and
# times it.
GROUPED_PROBE = """
r = c.check_grouped(gen, 'bfloat16')
print(f"# grouped_matmul bf16, a MoE layer's 2 GEMMs over a wave: "
      f"{r['ms']:.4f} ms, {r['library']} {r['library_ms']:.4f} ms, bound "
      f"{r['bound_ms']:.4f} ms", flush=True)
"""


# Run by each checkout in ``compare_serving``: a Llama-3.1-8B layer's four
# GEMMs of the bf16 int4 and packed W4 kernels at M = 128 and 32 on the
# same weights (the int4 phase-14 and the packed phase-6 batch, each at the
# other's too), as that checkout's wrappers run them: time a call (CUDA
# events), device time (profiler) and host time a call.
QUANT_PROBE = """
from aphrodite_tpu_torch.ops import quant_matmul as qm
from aphrodite_tpu_torch.quantization.loader import pack_w4
tot = {}
for gemm, (K, N) in c.LLAMA8B_GEMMS.items():
    x, args, _, uint4 = c.int4_inputs(gen, K, N, 128, torch.bfloat16)
    packed = (pack_w4(uint4[0]), uint4[1], uint4[2])
    for M in (128, 32):
        xm = x[:M].contiguous()
        for name, fn in (('int4', lambda: qm.w4a16_int4_matmul(xm, *args)),
                         ('packed',
                          lambda: qm.w4a16_packed_matmul(xm, *packed))):
            r = (c.cuda_ms(fn, 50), c.device_ms(fn, 20), c.host_ms(fn, 50))
            k = f'{name} M={M}'
            tot[k] = [a + b for a, b in zip(tot.get(k, (0, 0, 0)), r)]
    del x, args, uint4, packed
for k, (ms, dev, host) in tot.items():
    print(f"# quant GEMMs, a layer's 4, bf16 {k}: {ms:.4f} ms, device "
          f"{dev:.4f} ms, host {host:.4f} ms", flush=True)
"""
# Run by each checkout in ``compare_serving``: a layer's four bf16 GEMMs of
# rows 5 (W8) and 6 (uint4) at M = 32 as that checkout's wrappers run them,
# at the new paths' shapes (Llama-3.1-8B W8, Qwen2.5-7B uint4) and at
# Qwen2.5-1.5B's (phase 5's): time a call, device time and host time a
# call. The shapes are written out: the parent's script lacks them.
BYTE_PROBE = f"""
from aphrodite_tpu_torch.ops import quant_matmul as qm
for name, path, shapes in (
        ('w8a16_matmul', 'llama-3.1-8b', {LLAMA8B_GEMMS!r}),
        ('w4a16_matmul', 'qwen2.5-7b', {QWEN7B_GEMMS!r}),
        ('w8a16_matmul', 'qwen2.5-1.5b', {QWEN_GEMMS!r}),
        ('w4a16_matmul', 'qwen2.5-1.5b', {QWEN_GEMMS!r})):
    tot = (0.0, 0.0, 0.0)
    for gemm, (K, N) in shapes.items():
        x, args, _, _ = c.quant_inputs(gen, name, K, N, 32, torch.bfloat16)
        fn = lambda: qm.KERNELS[name](x, *args)
        r = (c.cuda_ms(fn, 50), c.device_ms(fn, 20), c.host_ms(fn, 50))
        tot = tuple(a + b for a, b in zip(tot, r))
        del x, args
    print(f"# quant GEMMs, a layer's 4, bf16 {{name}} at {{path}} M=32: "
          f"{{tot[0]:.4f}} ms, device {{tot[1]:.4f}} ms, host {{tot[2]:.4f}} "
          "ms", flush=True)
"""


def _ab_serve(phase: str, name: str, hf: dict, quantization: str,
              kernel: str) -> str:
    """A byte layout's path (phase 15 or 16) as an ``--ab`` part: the
    ``serve_workload`` both checkouts have, with the geometry and the exact
    launches written out (the parent's script lacks the phase)."""
    exact = {k: 0 for k in ("w8a16_matmul", "w4a16_matmul",
                            "w4a16_packed_matmul", "w4a16_int4_matmul")}
    exact[kernel] = 4 * hf["num_hidden_layers"] * 63
    return ("from aphrodite_tpu_torch.ops import quant_matmul as qm\n"
            f"c.serve_workload({phase!r}, {name!r}, {hf!r}, "
            "{**qm.KERNELS, **c.attention_kernels()}, "
            f"exact={exact!r}, quantization={quantization!r})")


# Run by each checkout in ``compare_serving``: both MLA instances at
# ``MLA_GEOMS`` (phase 24's wave and window, V3's group of 128) as that
# checkout's phase 2 holds and times them: device time (profiler), time a
# call, the window's host time a call, and the error against the plain
# version.
MLA_PROBE = """
for path, geom in c.MLA_GEOMS.items():
    for name, fn in (('ragged_paged_attention', c.check_ragged),
                     ('window_decode_attention', c.check_window)):
        r = fn(gen, 'bfloat16', geom)
        host = f", host {r['host_ms']:.4f} ms" if 'host_ms' in r else ''
        print(f"# {name} MLA instance bf16 at {path}: device "
              f"{r['device_ms']:.4f} ms, call {r['ms']:.4f} ms{host}, "
              f"max_abs_err {r['max_abs_err']:.3g}", flush=True)
"""


# Run by each checkout in ``compare_serving``: the bf16 span instance's
# device time at phase 26's wave, with the spans and without them.
SPAN_PROBE = """
r = c.check_ragged(gen, 'bfloat16', c.G3_WAVE)
r0 = c.check_ragged(gen, 'bfloat16',
                    {k: v for k, v in c.G3_WAVE.items() if k != 'spans'})
print(f"# ragged_paged_attention bf16 at gemma-3-4b-it shapes: device "
      f"{r['device_ms']:.4f} ms with the spans, {r0['device_ms']:.4f} ms "
      f"without", flush=True)
"""


# Run by each checkout in ``compare_serving``: the device time of the
# ragged, decode and window kernels' tensor-core instances at head dims
# 64, 128 and 256, at their paths' shapes, as that checkout's phase 2
# holds and times them (the geometries written out where the parent's
# script lacks them): the ragged kernel at the 8B wave (on a bf16 and an
# e4m3 cache), Gemma-2-9B's, Baichuan2-13B's with ALiBi and Falcon-7B's
# (71 query heads of 64 on one KV head); the decode kernel at Gemma-2-9B's,
# the 8B heads', Baichuan2-13B's and Gemma-3-4B's steps; the window kernel
# at the 8B, Qwen2.5-1.5B and Gemma-2-9B paths.
ATTN_PROBE = """
for path, geom, kv in (
        ('llama-3.1-8b', c.ATTN_GEOMS['llama-3.1-8b-w4a16'], None),
        ('llama-3.1-8b', c.ATTN_GEOMS['llama-3.1-8b-w4a16'],
         'float8_e4m3fn'),
        ('gemma-2-9b', c.ATTN_GEOMS['gemma-2-9b-bf16'], None),
        ('baichuan2-13b-alibi', dict(c.B13_WAVE, alibi=True), None),
        ('falcon-7b', dict(nq=71, kvh=1, hd=64, ctx=[512] * 32,
                           qlen=[512] * 32), None)):
    r = c.check_ragged(gen, 'bfloat16', geom, kv=kv)
    print(f"# ragged_paged_attention bf16 at {path}'s wave, {kv or 'bf16'} "
          f"cache: device {r['device_ms']:.4f} ms, max_abs_err "
          f"{r['max_abs_err']:.3g}", flush=True)
for case in ('gemma-2-9b', 'llama-3.1-8b', 'baichuan2-13b-alibi',
             'gemma-3-4b'):
    r = c.check_decode(gen, 'bfloat16', case)
    print(f"# decode_paged_attention bf16 at {case}'s step: device "
          f"{r['device_ms']:.4f} ms, max_abs_err {r['max_abs_err']:.3g}",
          flush=True)
for path in ('llama-3.1-8b-w4a16', 'qwen2.5-1.5b-bf16', 'gemma-2-9b-bf16'):
    r = c.check_window(gen, 'bfloat16', c.ATTN_GEOMS[path])
    print(f"# window_decode_attention bf16 at {path}: device "
          f"{r['device_ms']:.4f} ms, max_abs_err {r['max_abs_err']:.3g}",
          flush=True)
"""


# Run by each checkout in ``compare_serving``: the token-history block of
# that checkout's ``sample_tokens`` (DRY, the penalties and no-repeat-ngram)
# at phase 20's draw, built as ``phase20_history`` builds it (written out:
# the parent's script lacks it): the history pass with the logits handed
# over where the checkout has it, else the eager stages over the
# suffix-match kernel, as the parent's ``sample_tokens`` ran them. Time a
# call (CUDA events), device time (profiler), kernels a call and the peak
# allocation of a call.
HISTORY_PROBE = """
import numpy as np
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from aphrodite_tpu_torch import SamplingParams
from aphrodite_tpu_torch.sample import sampler as S
from aphrodite_tpu_torch.sample.metadata import (SamplingMetadata,
                                                 build_sampling_arrays)
rng = np.random.RandomState(0)
prompts = [rng.randint(10, 100000, size=512).tolist() for _ in range(32)]
names = list(c.SAMPLED_PRESETS)
reqs = []
for i, p in enumerate(prompts):
    out = rng.randint(10, 100000, size=int(rng.randint(0, 65))).tolist()
    reqs.append((SamplingParams(max_tokens=64, ignore_eos=True, seed=2000 + i,
                                **c.SAMPLED_PRESETS[names[i % 3]]),
                 p + out, 512, len(out)))
arrays, flags = build_sampling_arrays(reqs, 128256, 32, extra_len=65)
md = SamplingMetadata.from_arrays(arrays, 'cuda')
lg = 3 * torch.from_numpy(rng.randn(32, 128256).astype(np.float32)).cuda()
if hasattr(S, 'history_pass'):
    what = 'history pass, in place'
    block = lambda: S.history_pass(lg, md, flags, inplace=True)
else:
    what = 'eager stages over the suffix-match kernel'
    def block():
        bm, mp, mb = S._match_lengths(md, True)
        x = S._apply_dry(lg, md, bm, mb)
        x = S._apply_penalties(x, md)
        return S._apply_no_repeat_ngram(x, md, mp)
ms, dev = c.cuda_ms(block, 50), c.device_ms(block, 20)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    block()
    torch.cuda.synchronize()
n = sum(1 for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA)
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
base = torch.cuda.memory_allocated()
block()
torch.cuda.synchronize()
peak = torch.cuda.max_memory_allocated() - base
print(f"# history block at phase 20's draw ({what}): {ms:.4f} ms a call, "
      f"device {dev:.4f} ms, {n} kernels a call, peak {peak} B", flush=True)
"""


# What ``--ab`` runs, in this order, each by its name on the command line.
AB_PARTS = {"host": HOST_PROBE, "grouped": GROUPED_PROBE, "mla": MLA_PROBE,
            "spans": SPAN_PROBE, "attn": ATTN_PROBE,
            "history": HISTORY_PROBE,
            "quant": QUANT_PROBE, "bytes": BYTE_PROBE,
            "8": "c.main_path_moe()", "12": "c.main_path_gemma()",
            "14": "c.main_path_int4_cascade()", "6": "c.main_path_8b()",
            "15": _ab_serve("phase 15", "llama-3.1-8b-w8a16-dummy",
                            LLAMA31_8B, "w8a16", "w8a16_matmul"),
            "16": _ab_serve("phase 16", "qwen2.5-7b-gptq-dummy", QWEN25_7B,
                            "gptq", "w4a16_matmul"),
            "24": "c.main_path_deepseek()"}


def compare_serving(parent: str, parts: list[str]) -> int:
    """``python3 chip_smoke.py --ab PARENT [PART ...]``: the probes and
    phases of ``AB_PARTS`` (all, or the PARTs named: ``HOST_PROBE``,
    ``GROUPED_PROBE``, ``MLA_PROBE``, ``SPAN_PROBE``, ``ATTN_PROBE``,
    ``HISTORY_PROBE``, ``QUANT_PROBE`` and
    phases 8, 12, 14, 6, 15, 16 and 24: s/run,
    device busy and items) of the checkout at PARENT (a commit
    unpacked with ``git archive``) and of this one, in turns on one card:
    parent, this, this, parent. Each run is a process of its own, started
    from its checkout's root, which builds that checkout's kernels into its
    own build directory (the first run of each logs its kernels' parallel
    build time: phase 1 of both checkouts). Their logs are printed with a
    tag; fails if any run fails."""
    here = Path(__file__).resolve().parent
    roots = {"parent": Path(parent).resolve(), "change": here}
    unknown = [p for p in parts if p not in AB_PARTS]
    if unknown:
        raise SystemExit(f"--ab: unknown parts {unknown}; known "
                         f"{list(AB_PARTS)}")
    chosen = [v for k, v in AB_PARTS.items() if not parts or k in parts]
    # The history probe alone builds its one library at first use.
    build = ([] if parts == ["history"] else [
        "t = cuda_build.build_all(c.KERNEL_SOURCES)",
        "print(f'# kernels built in {t:.1f} s', flush=True)"])
    code = "\n".join([
        "import sys", "sys.path.insert(0, '.')", "import chip_smoke as c",
        "import torch",
        "from aphrodite_tpu_torch.ops import cuda_build", *build,
        "gen = torch.Generator(device='cuda').manual_seed(0)", *chosen])
    for i, tag in enumerate(("parent", "change", "change", "parent")):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=roots[tag],
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            log(f"[{tag} {i}] {line}")
        log(f"[{tag} {i}] exit {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s")
        if proc.returncode != 0:
            log(proc.stderr[-4000:])
            return 1
    return 0


# The two designs of ALiBi in the tensor-core span instances
# (``csrc/ragged_tc.cuh``): a uniform branch on the slopes' pointer (the
# sources as they are) and a template switch (the dispatch instantiates
# kAlibi beside kSpans, twice the span instances): name -> the dispatch's
# text and what replaces it.
SPAN_ALIBI_DESIGNS = {"uniform branch": None,
                      "template switch": ("!kSpans, kSpans, KV>",
                                          "true, kSpans, KV>")}


def span_build_times() -> int:
    """``python3 chip_smoke.py --span-builds``: phase 1's build (one
    ``nvcc`` per library of ``KERNEL_SOURCES``, all started together) of
    each design of ``SPAN_ALIBI_DESIGNS``, each a copy of the sources under
    ``build/span_builds/``, in turns: branch, switch, switch, branch. Logs
    each build's wall and each span library's own time (from the start to
    its ``nvcc``'s exit)."""
    import shutil
    from aphrodite_tpu_torch.ops import cuda_build
    src = Path(__file__).resolve().parent / "aphrodite_tpu_torch" / "csrc"
    order = ["uniform branch", "template switch", "template switch",
             "uniform branch"]
    for turn, design in enumerate(order):
        d = Path("build/span_builds") / f"{turn}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in src.glob("*.cu*"):
            shutil.copy(f, d / f.name)
        swap = SPAN_ALIBI_DESIGNS[design]
        if swap is not None:
            tc = (d / "ragged_tc.cuh").read_text()
            if tc.count(swap[0]) != 2:
                raise ValueError(f"{swap[0]!r} not twice in ragged_tc.cuh")
            (d / "ragged_tc.cuh").write_text(tc.replace(*swap))
        t0 = time.perf_counter()
        procs = {}
        for n in KERNEL_SOURCES:  # ptxas -v's report to a file, not a pipe
            with open(d / f"{n}.log", "w") as out:
                procs[n] = subprocess.Popen(
                    [cuda_build._nvcc(), *cuda_build._FLAGS, "-I", str(d),
                     "-o", str(d / f"{n}.so"), str(d / f"{n}.cu")],
                    stdout=out, stderr=subprocess.STDOUT)
        took = {}
        while len(took) < len(procs):
            for n, proc in procs.items():
                if n not in took and proc.poll() is not None:
                    took[n] = time.perf_counter() - t0
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed for {n}.cu ({design}):\n"
                            f"{(d / f'{n}.log').read_text()[-3000:]}")
            time.sleep(0.05)
        slowest = max(took, key=took.get)
        log(f"# span builds, turn {turn}, ALiBi a {design}: phase 1's "
            f"build {max(took.values()):.1f} s (the last: {slowest}.cu); "
            f"ragged_spans.cu {took['ragged_spans']:.1f} s, "
            f"ragged_spans_f16.cu {took['ragged_spans_f16']:.1f} s")
        shutil.rmtree(d, ignore_errors=True)
    return 0


# The kernel's parts, removed for timing (``W4_DROP`` bits in
# ``csrc/w4_wgmma.cu``), and w8's other conversions (``W8_CONVERT``): name
# -> (macros, whether y is still computed).
W4_VARIANTS = {
    "kernel": ({}, True),
    "no multicast": ({"W4_DROP": 4}, True),
    "no conversion (A zero)": ({"W4_DROP": 1}, False),
    "no fold (acc += d)": ({"W4_DROP": 2}, False),
    "no sums of x": ({"W4_DROP": 64}, False),
    "no fold, no sums": ({"W4_DROP": 66}, False),
    "no stores": ({"W4_DROP": 8}, False),
    "no K-split partials and fix-up": ({"W4_DROP": 128}, False),
    "no products": ({"W4_DROP": 16}, False),
    "no loads": ({"W4_DROP": 32}, False),
    "loads only": ({"W4_DROP": 1 | 2 | 8 | 16 | 64}, False),
    "products only": ({"W4_DROP": 1 | 2 | 8 | 32 | 64}, False),
    "w8 sign split": ({"W8_CONVERT": 1}, True),
    "w8 nibble split": ({"W8_CONVERT": 2}, True),
}
# Variants that change only one layout's code.
_VARIANT_LAYOUT = {"w8 sign split": "w8", "w8 nibble split": "w8"}
# What ``--variants`` times: layout -> (M, a layer's GEMMs); the ring
# depths (stages) timed beside the planned one for the byte layouts.
VARIANT_PATHS = {"int4": [(128, LLAMA8B_GEMMS), (32, LLAMA8B_GEMMS)],
                 "packed": [(32, LLAMA8B_GEMMS)],
                 "w8": [(32, LLAMA8B_GEMMS)],
                 "uint4": [(32, QWEN7B_GEMMS)],
                 "fp8": [(32, LLAMA8B_GEMMS)]}
VARIANT_RINGS = (4, 16)
# In every variant's copy an mbarrier wait that spins past 2^26 polls
# traps, so a variant that breaks the pipeline fails instead of hanging.
_W4_TRAP = [("  uint32_t done;\n  do {",
             "  uint32_t done;\n  long long spins = 0;\n  do {"),
            ("  } while (!done);",
             "    if (++spins > (1ll << 26)) __trap();\n  } while (!done);")]


def w4_variants(layouts: list[str]) -> int:
    """``python3 chip_smoke.py --variants [LAYOUT ...]``: the bf16 kernel
    (``csrc/w4_wgmma.cu``) with parts removed or w8's conversion swapped
    (``W4_VARIANTS``), each a copy of the sources under
    ``build/w4_variants/`` built with its macros (all ``nvcc`` at once).
    The variants that compute y are held against the plain versions
    first. Then each is timed on a layer's four GEMMs of each layout named
    (all of ``VARIANT_PATHS`` by default: int4 at M = 128 and 32, packed
    and w8 on Llama-3.1-8B's, uint4 on Qwen2.5-7B's at M = 32), and for
    the byte layouts the kernel and its loads alone with the ring capped at
    ``VARIANT_RINGS`` stages: device time (profiler), 4 rounds in a
    rotating order, the middle two rounds' mean and the range; beside them
    a dense bf16 ``torch.matmul`` of the same shapes."""
    import ctypes
    import shutil
    import torch
    from aphrodite_tpu_torch.ops import cuda_build, w4_wgmma
    layouts = layouts or list(VARIANT_PATHS)
    src = Path(__file__).resolve().parent / "aphrodite_tpu_torch" / "csrc"
    jobs = {}
    for name, (macros, _) in W4_VARIANTS.items():
        if _VARIANT_LAYOUT.get(name, layouts[0]) not in layouts:
            continue
        d = Path("build/w4_variants") / name.split(" (")[0].replace(
            " ", "_").replace(",", "")
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in src.glob("*.cu*"):
            shutil.copy(f, d / f.name)
        hc = (d / "hopper_common.cuh").read_text()
        for a, b in _W4_TRAP:
            if a not in hc:
                raise ValueError(f"{a!r} not in hopper_common.cuh")
            hc = hc.replace(a, b)
        (d / "hopper_common.cuh").write_text(hc)
        cmd = [cuda_build._nvcc(), *cuda_build._FLAGS,
               *(f"-D{k}={v}" for k, v in macros.items()), "-I", str(d),
               "-o", str(d / "lib.so"), str(d / "w4_wgmma.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      d)
    t0 = time.perf_counter()
    libs = {}
    for name, (proc, d) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out[-3000:]}")
        libs[name] = ctypes.CDLL(str(d / "lib.so"))
    log(f"# variants built in {time.perf_counter() - t0:.1f} s")

    def applies(name: str, layout: str) -> bool:
        return name in libs and _VARIANT_LAYOUT.get(name, layout) == layout

    gen = torch.Generator(device="cuda").manual_seed(0)
    for layout in layouts:
        for M in (128, 13) if layout == "int4" else (32, 200):
            K, N = 4096, 1424
            x, args, plain = w4_inputs(gen, layout, M, K, N, 128, False)
            ref = plain(x.float())
            for name, (_, computes) in W4_VARIANTS.items():
                if not (computes and applies(name, layout)):
                    continue
                for zero_in in ((None,) if layout in w4_wgmma.COL_SCALED
                                else (None, False)):
                    y = w4_wgmma.matmul(layout, x, *args, lib=libs[name],
                                        zero_in=zero_in)
                    torch.cuda.synchronize()
                    err = (y.float() - ref).abs().max().item()
                    if not err <= TOL["bfloat16"]:
                        raise AssertionError(f"{name} {layout} M={M} zeros "
                                             f"in {zero_in}: max_abs_err "
                                             f"{err}")
            log(f"# {layout} M={M} K={K} N={N}: every variant that computes "
                f"y within {TOL['bfloat16']} of the plain version")

    for layout in layouts:
        for M, shapes in VARIANT_PATHS[layout]:
            totals: dict[str, float] = {}
            for gemm, (K, N) in shapes.items():
                x, args, _ = w4_inputs(gen, layout, M, K, N, 128, False)
                wd = torch.randn((K, N), generator=gen,
                                 device="cuda").bfloat16()
                fns = {n: (lambda lib=lib: w4_wgmma.matmul(layout, x, *args,
                                                           lib=lib))
                       for n, lib in libs.items() if applies(n, layout)}
                if layout not in w4_wgmma.COL_SCALED:
                    fns["kernel, zero after the product"] = (
                        lambda: w4_wgmma.matmul(layout, x, *args,
                                                lib=libs["kernel"],
                                                zero_in=False))
                if layout in w4_wgmma.BYTE_LAYOUTS:
                    for r in VARIANT_RINGS:
                        for n in ("kernel", "loads only"):
                            fns[f"{n}, ring {r}"] = (
                                lambda lib=libs[n], r=r: w4_wgmma.matmul(
                                    layout, x, *args, lib=lib, stages=r))
                fns["dense matmul"] = lambda: x @ wd
                names = list(fns)
                got = {n: [] for n in names}
                for r in range(4):
                    order = names[r:] + names[:r]
                    for n in (order[::-1] if r % 2 else order):
                        got[n].append(device_ms(fns[n], 10))
                line = f"# {layout} {gemm} M={M}:"
                for n in names:
                    v = sorted(got[n])
                    mid = (v[1] + v[2]) / 2
                    totals[n] = totals.get(n, 0.0) + mid
                    line += f" {n} {mid:.4f} [{v[0]:.4f}-{v[-1]:.4f}];"
                log(line)
                del x, args, wd
            log(f"# {layout} M={M}, a layer's 4 GEMMs, device ms: "
                + "; ".join(f"{n} {v:.4f}" for n, v in totals.items()))
    return 0


T0 = time.perf_counter()


def stamp(what: str) -> None:
    """The script's elapsed time, logged before a phase."""
    log(f"# {time.perf_counter() - T0:.0f} s: {what}")


# The sampler slice (phases 2, 19 and 20).
# INT32 lanes of a Hopper SM (NVIDIA H100 Tensor Core GPU Architecture
# white paper: 64 INT32 units a streaming multiprocessor). The Gumbel
# kernel's bound counts its int32 operations as the source writes them, all
# at this rate; it leaves out adds folded into IADD3 and adds issued as IMAD
# on the FMA pipe beside the ALU's shifts and LOP3s, so the card's floor may
# lie below it (down to about half, with both pipes full).
INT32_LANES_PER_SM = 64
GUMBEL_ROWS, GUMBEL_VOCABS = (1, 32, 128), (151936, 128256)
# The kernel's Gumbel values within GUMBEL_ULPS ulps of max(1, |g|) of the
# plain version's (the logs' last ulp); tokens may differ only where the
# plain version's two best noisy scores lie within NOISE_GAP (twice the
# largest such error of a score, |g| < 17).
GUMBEL_ULPS, NOISE_GAP = 4, 2e-5
HISTORY_ROWS, HISTORY_LENS = 32, (1024, 2048)
# Phase 20's engine (max_model_len 704, a 64-step decode window): its
# sampler's longest histories, 704 tokens in next_power_of_2(704 + 65)
# slots.
HISTORY_LONGEST = (704, 1024)
# Phase 20's three presets, in rotation over the 32 requests: illustrative
# mixes that put every stage group of the path to work (top-k/top-p and top
# logprobs; min-p, penalties, DRY and XTC; penalties, no-repeat-ngram and
# temperature last), not the published defaults of any front end. The
# creative preset's DRY breakers are Llama-3's ".", "," and "\n" tokens.
SAMPLED_PRESETS = {
    "api": dict(temperature=0.7, top_p=0.9, top_k=40, logprobs=5),
    "creative": dict(temperature=1.0, min_p=0.05, repetition_penalty=1.1,
                     dry_multiplier=0.8, dry_base=1.75, dry_allowed_length=2,
                     dry_sequence_breaker_ids=[13, 11, 198],
                     xtc_threshold=0.1, xtc_probability=0.5),
    "penalised": dict(temperature=0.8, top_p=0.95, presence_penalty=0.5,
                      frequency_penalty=0.3, no_repeat_ngram_size=3,
                      temperature_last=True),
}
# Phase 19: a completion may part from the CPU's only at a near tie: the
# CPU's noisy scores of its token and the card's lie within SAMPLE_GAP (fp32
# forwards in another order move a logprob by ~1e-5), and at most a tenth
# of the completions part.
SAMPLE_GAP = 1e-3


def int32_ops_per_s() -> float:
    """The card's INT32 rate: SMs x INT32 lanes x its maximum SM clock
    (``nvidia-smi``)."""
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def check_gumbel(gen) -> dict:
    """Seeded Gumbel-max sampling at R in GUMBEL_ROWS x V in GUMBEL_VOCABS
    (Qwen's and Llama-3's vocabularies), fp32 logprobs with every fourth
    row top-k masked (40 finite columns) and, at R = 128, one row all
    -inf, random seeds and counters: the kernel's noise bits and uniforms
    equal to the plain stream's, its Gumbel values within GUMBEL_ULPS ulps,
    its tokens equal but where the plain version's two best noisy scores
    lie within NOISE_GAP, the -inf row's token 0. Times at phase 20's shape
    (R = 32, V = 128256): the kernel, the plain version and
    ``torch.multinomial`` over the same probabilities (another random
    stream: a yardstick of cost only); the bound counts the kernel's int32
    operations against ``int32_ops_per_s``."""
    import torch
    from aphrodite_tpu_torch.ops.gumbel_sample import (
        INT_OPS_PER_COLUMN, gumbel_noise, gumbel_sample, ref_gumbel_sample)
    from aphrodite_tpu_torch.sample import rng as trng
    rate = int32_ops_per_s()
    res = {}
    for R in GUMBEL_ROWS:
        for V in GUMBEL_VOCABS:
            lp = torch.log_softmax(3 * torch.randn(
                (R, V), generator=gen, device="cuda"), dim=-1)
            for r in range(0, R, 4):
                kth = lp[r].topk(40).values[-1]
                lp[r] = torch.where(lp[r] >= kth, lp[r], float("-inf"))
            if R == 128:
                lp[-1] = float("-inf")
            seeds = torch.randint(0, 2**31 - 1, (R,), generator=gen,
                                  device="cuda")
            out_len = torch.randint(0, 4096, (R,), generator=gen,
                                    device="cuda", dtype=torch.int32)
            step = 5
            bits, unif, noise = gumbel_noise(seeds, out_len, step, V)
            _, key = trng.sample_keys(seeds, out_len.long() + step)
            pbits = trng.random_bits(key, V)
            punif = trng.uniform(key, (V,), minval=trng.TINY)
            pnoise = -torch.log(-torch.log(punif))
            if not (torch.equal(bits, pbits) and torch.equal(unif, punif)):
                raise AssertionError(f"gumbel_sample R={R} V={V}: noise "
                                     "bits or uniforms differ")
            ulp = torch.abs(torch.nextafter(
                torch.clamp(pnoise.abs(), min=1.0),
                torch.tensor(float("inf"), device="cuda"))
                - torch.clamp(pnoise.abs(), min=1.0))
            err = (noise - pnoise).abs()
            if not bool((err <= GUMBEL_ULPS * ulp).all()):
                raise AssertionError(f"gumbel_sample R={R} V={V}: Gumbel "
                                     f"values {err.max().item():.3g} apart")
            del bits, unif, pbits, punif
            tok = gumbel_sample(lp, seeds, out_len, step)
            ref = ref_gumbel_sample(lp, seeds, out_len, step)
            noisy = torch.where(torch.isfinite(lp), lp + pnoise,
                                float("-inf"))
            top2 = noisy.topk(2, dim=-1).values
            gap = top2[:, 0] - top2[:, 1]
            part = tok != ref
            torch.cuda.synchronize()
            if bool((part & ~(gap < NOISE_GAP)).any()):
                raise AssertionError(
                    f"gumbel_sample R={R} V={V}: tokens {tok.tolist()} vs "
                    f"plain {ref.tolist()}, gaps {gap.tolist()}")
            if R == 128 and int(tok[-1]) != 0:
                raise AssertionError("gumbel_sample: an all -inf row gave "
                                     f"{int(tok[-1])}, want 0")
            line = (f"# phase 2: gumbel_sample R={R} V={V}: bits and "
                    f"uniforms equal, Gumbel max_abs_err "
                    f"{err.max().item():.3g} (<= {GUMBEL_ULPS} ulp), tokens "
                    f"equal in {R - int(part.sum())} of {R} rows (the rest "
                    f"at gaps < {NOISE_GAP})")
            if (R, V) == (32, 128256):
                probs = lp.exp()
                ms = cuda_ms(lambda: gumbel_sample(lp, seeds, out_len, step),
                             50)
                dev = device_ms(
                    lambda: gumbel_sample(lp, seeds, out_len, step), 20)
                plain_ms = cuda_ms(
                    lambda: ref_gumbel_sample(lp, seeds, out_len, step), 3)
                lib_ms = cuda_ms(lambda: torch.multinomial(probs, 1), 50)
                ops = float(R) * V * INT_OPS_PER_COLUMN
                t_ops = ops / rate * 1e3
                t_bytes = (4.0 * R * V + 24.0 * R) / HBM_BYTES_PER_S * 1e3
                b_ms, b_by = ((t_ops, "operations") if t_ops >= t_bytes
                              else (t_bytes, "bytes"))
                line += (f"; kernel {ms:.4f} ms (device {dev:.4f} ms), "
                         f"plain {plain_ms:.4f} ms, torch.multinomial "
                         f"(another stream) {lib_ms:.4f} ms, bound "
                         f"{b_ms:.4f} ms ({b_by}: {ops / 1e6:.0f} M int32 "
                         f"ops at {rate / 1e12:.2f} TOP/s; bytes "
                         f"{t_bytes:.4f} ms)")
                res = dict(max_abs_err=err.max().item(), ms=ms,
                           device_ms=dev, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
            log(line)
            del lp, noise, pnoise, noisy, err, ulp
    return res


def history_seq(gen, R: int, L: int, kind: str, lo: int, hi: int):
    """[R, L] int32 histories padded with Llama-3's vocabulary size and
    their lengths, drawn from [lo, hi] (the first two rows hi and lo).
    "random": a 6-token alphabet (many short matches); "periodic":
    repeated units of 1-8 tokens with a few breaks (matches up to the
    cap); "vocab": tokens of Llama-3's vocabulary (phase 20's prompts)."""
    import torch
    lens = torch.randint(lo, hi + 1, (R,), generator=gen, device="cuda")
    lens[:2] = torch.tensor([hi, lo])
    if kind == "vocab":
        seq = torch.randint(10, 100000, (R, L), generator=gen, device="cuda")
    elif kind == "random":
        seq = torch.randint(0, 6, (R, L), generator=gen, device="cuda")
    else:
        seq = torch.empty((R, L), dtype=torch.int64, device="cuda")
        for r in range(R):
            n = int(torch.randint(1, 9, (1,), generator=gen, device="cuda"))
            unit = torch.randint(0, 5, (n,), generator=gen, device="cuda")
            seq[r] = unit.repeat(L // n + 1)[:L]
        seq[torch.rand((R, L), generator=gen, device="cuda") < 0.02] = 7
    pos = torch.arange(L, device="cuda")[None, :]
    seq = torch.where(pos < lens[:, None], seq, 128256).to(torch.int32)
    return seq, lens.to(torch.int32)


def history_metadata(gen, seq, lens):
    """The fields the token-history pass reads, drawn on the card, each
    stage off in about a quarter of the rows: prompt lengths 0-T, DRY
    (multiplier 0.2-1.2, base 1.2-2, allowed 0-4, a range in a third of
    the rows, 0-16 breakers of tokens 0-7), no-repeat-ngram 1-5,
    repetition 0.8-1.5, frequency and presence -0.5-1."""
    import types
    import torch
    R, L = seq.shape
    dev = seq.device
    u = lambda: torch.rand((R,), generator=gen, device=dev)  # noqa: E731
    on = lambda: u() >= 0.25  # noqa: E731
    ints = lambda lo, hi, shape=(R,): torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)
    nbrk = ints(0, 17)
    brk = torch.where(torch.arange(16, device=dev)[None, :] < nbrk[:, None],
                      ints(0, 8, (R, 16)), -1).to(torch.int32)
    zero = torch.zeros((R,), device=dev)
    return types.SimpleNamespace(
        token_seq=seq, total_len=lens,
        prompt_len=(u() * (lens + 1)).floor().to(torch.int32),
        dry_multiplier=torch.where(on(), 0.2 + u(), zero),
        dry_base=1.2 + 0.8 * u(), dry_allowed=ints(0, 5),
        dry_range=torch.where(u() < 0.3, ints(1, L + 1), 0).to(torch.int32),
        dry_breakers=brk,
        no_repeat_ngram=torch.where(on(), ints(1, 6), 0).to(torch.int32),
        repetition_penalty=torch.where(on(), 0.8 + 0.7 * u(), zero + 1),
        frequency_penalty=torch.where(on(), 1.5 * u() - 0.5, zero),
        presence_penalty=torch.where(on(), 1.5 * u() - 0.5, zero))


def phase20_history(V: int = 128256):
    """Phase 20's draw of the window's tenth sub-step, built as its runner
    builds it: the 32 requests of phase 6 (seeded 512-token prompts) with
    0-64 generated tokens each and ``SAMPLED_PRESETS`` in rotation, packed
    by ``build_sampling_arrays`` with the window's room (L = 1024) and
    moved to the card; fp32 logits of 3 x N(0, 1). Returns (logits, md,
    flags)."""
    import torch
    from aphrodite_tpu_torch import SamplingParams
    from aphrodite_tpu_torch.sample.metadata import (SamplingMetadata,
                                                     build_sampling_arrays)
    rng = np.random.RandomState(0)  # phase 6's prompts
    prompts = [rng.randint(10, 100000, size=512).tolist() for _ in range(32)]
    names = list(SAMPLED_PRESETS)
    reqs = []
    for i, p in enumerate(prompts):
        out = rng.randint(10, 100000, size=int(rng.randint(0, 65))).tolist()
        params = SamplingParams(max_tokens=64, ignore_eos=True, seed=2000 + i,
                                **SAMPLED_PRESETS[names[i % 3]])
        reqs.append((params, p + out, 512, len(out)))
    arrays, flags = build_sampling_arrays(reqs, V, 32, extra_len=65)
    md = SamplingMetadata.from_arrays(arrays, "cuda")
    logits = 3 * torch.from_numpy(rng.randn(32, V).astype(np.float32)).cuda()
    return logits, md, flags


def kernels_a_call(fn) -> int:
    """The device kernels one call of ``fn`` launches (a profiler trace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA)


def peak_bytes(fn) -> int:
    """The bytes one call of ``fn`` allocates on the card at its peak,
    beyond what was allocated before it."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def history_parts(got, want, dry_moved, what: str) -> int:
    """The entries where the pass's logits differ from the plain
    version's; fails unless each is one that DRY penalised and lies within
    1 ulp (CUDA's powf against torch.pow's)."""
    import torch
    diff = got != want  # -inf equals -inf; the inputs hold no NaN
    n = int(diff.sum())
    if n:
        ulp = torch.nextafter(want.abs(), torch.full_like(want, math.inf)) \
            - want.abs()
        ok = dry_moved & ((got - want).abs() <= ulp)
        if bool((diff & ~ok).any()):
            bad = (diff & ~ok).nonzero()[:4].tolist()
            raise AssertionError(f"history_pass {what}: {n} entries differ "
                                 f"from the plain version, at {bad} past 1 "
                                 "ulp or not DRY's")
    return n


def check_history(gen) -> dict:
    """The token-history pass (DRY, the penalties and no-repeat-ngram in
    one launch) against its plain version on the card, V = 128256: at R =
    32 on random, periodic and Llama-vocabulary histories at L in
    HISTORY_LENS with every stage's parameters drawn per row (some rows
    off), at R = 128, at the longest L phase 20's engine builds (rows of
    704 tokens at L = 1024), with one stage on alone, on device-memory
    tables (L = 8192 at R = 48, more rows than blocks; L = 32768) and at
    phase 20's own draw (``phase20_history``). Each: equal bit for bit but
    where DRY's power parts by 1 ulp (``history_parts``), the caller's
    logits untouched, a second launch in place equal to the first, the
    device-memory tables zero after it. Times at phase 20's draw: the pass
    in place (as the window hands its logits over) and with its copy, the
    plain version (the sampler's eager stages over the plain suffix
    match), the kernels a call of each and their peak allocations; the
    bound is the larger of the bytes (each row's history read once, 8
    bytes a distinct token, 112 bytes of parameters a row) and the int32
    operations the data needs (2 a position, 4 a step of each match the
    kernel extends); no PyTorch call computes it."""
    import torch
    from aphrodite_tpu_torch.ops import history_pass as H
    from aphrodite_tpu_torch.ops.suffix_match import (MAX_MATCH,
                                                      ref_suffix_match)
    from aphrodite_tpu_torch.sample.metadata import SamplerFlags
    V = 128256
    every = SamplerFlags(all_greedy=False, do_dry=True, do_penalties=True,
                         do_ngram=True)
    dry_only = every._replace(do_penalties=False, do_ngram=False)
    cases = [(f"R={HISTORY_ROWS} L={L} {kind}", HISTORY_ROWS, L, kind, 0, L,
              every) for L in HISTORY_LENS
             for kind in ("random", "periodic", "vocab")]
    cases += [("R=128 L=1024 periodic", 128, 1024, "periodic", 0, 1024,
               every),
              (f"R=32 L={HISTORY_LONGEST[1]} rows of {HISTORY_LONGEST[0]} "
               "(phase 20's longest)", 32, HISTORY_LONGEST[1], "periodic",
               HISTORY_LONGEST[0], HISTORY_LONGEST[0], every)]
    cases += [(f"R=32 L=1024 periodic, {name} alone", 32, 1024, "periodic",
               0, 1024, SamplerFlags(all_greedy=False, **{flag: True}))
              for name, flag in (("DRY", "do_dry"),
                                 ("penalties", "do_penalties"),
                                 ("no-repeat-ngram", "do_ngram"))]
    cases += [("R=48 L=8192 periodic (device-memory tables)", 48, 8192,
               "periodic", 0, 8192, every),
              ("R=8 L=32768 random (device-memory tables)", 8, 32768,
               "random", 0, 32768, every)]
    cases.append(("phase 20's draw", None, 1024, None, 0, 0, None))
    res = {}
    for what, R, L, kind, lo, hi, flags in cases:
        if R is None:
            lg, md, flags = phase20_history(V)
        else:
            seq, lens = history_seq(gen, R, L, kind, lo, hi)
            md = history_metadata(gen, seq, lens)
            lg = 3 * torch.randn((R, V), generator=gen, device="cuda")
        plan = H.history_plan(lg.shape[0], L, V)
        before = lg.clone()
        got = H.history_pass(lg, md, flags)
        want = H.ref_history_pass(lg, md, flags)
        moved = (H.ref_history_pass(lg, md, dry_only) != lg
                 if flags.do_dry else torch.zeros_like(lg, dtype=torch.bool))
        again = lg.clone()
        H.history_pass(again, md, flags, inplace=True)
        torch.cuda.synchronize()
        if not torch.equal(lg, before):
            raise AssertionError(f"history_pass {what}: the caller's logits "
                                 "changed")
        if not torch.equal(again, got):
            raise AssertionError(f"history_pass {what}: two launches differ")
        if plan.table_ints and int(H._TABLES[torch.cuda.current_device()]
                                   .count_nonzero()):
            raise AssertionError(f"history_pass {what}: the device-memory "
                                 "tables are not zero after the launch")
        n = history_parts(got, want, moved, what)
        if bool(torch.equal(want, lg)):
            raise AssertionError(f"history_pass {what}: no stage moved a "
                                 "logit (a vacuous case)")
        line = (f"# phase 2: history_pass {what}: "
                + ("equal to the plain version" if not n else
                   f"equal to the plain version but {n} DRY entries within "
                   "1 ulp")
                + f" ({int((want != lg).sum())} logits moved, "
                f"{int(torch.isneginf(want).sum())} banned; "
                + (f"shared-memory tables, {plan.shared_bytes} B a block"
                   if not plan.table_ints else
                   f"device-memory tables, {plan.blocks} blocks x "
                   f"{4 * plan.table_ints // plan.blocks} B") + ")")
        if R is None:
            R = lg.shape[0]
            own = lg.clone()
            ms = cuda_ms(lambda: H.history_pass(own, md, flags,
                                                inplace=True), 50)
            copy_ms = cuda_ms(lambda: H.history_pass(lg, md, flags), 50)
            dev = device_ms(lambda: H.history_pass(own, md, flags,
                                                   inplace=True), 20)
            plain_ms = cuda_ms(lambda: H.ref_history_pass(lg, md, flags), 3)
            plain_dev = device_ms(
                lambda: H.ref_history_pass(lg, md, flags), 3)
            n_pass = kernels_a_call(
                lambda: H.history_pass(own, md, flags, inplace=True))
            n_plain = kernels_a_call(
                lambda: H.ref_history_pass(lg, md, flags))
            peak = peak_bytes(
                lambda: H.history_pass(own, md, flags, inplace=True))
            peak_copy = peak_bytes(lambda: H.history_pass(lg, md, flags))
            peak_plain = peak_bytes(
                lambda: H.ref_history_pass(lg, md, flags))
            # What the kernel reads and does on these rows.
            T, P = md.total_len.long(), md.prompt_len.long()
            n_pos = torch.maximum(T, P).clamp(max=L)
            distinct = sum(int(torch.unique(md.token_seq[r, :int(n_pos[r])])
                               .numel()) for r in range(R))
            m_plain, _ = ref_suffix_match(md.token_seq, md.total_len,
                                          torch.zeros_like(md.token_seq,
                                                           dtype=torch.bool))
            pos = torch.arange(L, device="cuda")[None, :]
            end = T[:, None] - 1
            last = md.token_seq.gather(1, end.clamp(min=0))
            cand = (md.token_seq == last) & (pos < end)
            steps = torch.clamp(m_plain + 1, max=MAX_MATCH)[cand].sum()
            ops = 2.0 * float(n_pos.sum()) + 4.0 * float(steps)
            t_ops = ops / int32_ops_per_s() * 1e3
            t_bytes = (4.0 * float(n_pos.sum()) + 8.0 * distinct
                       + 112.0 * R) / HBM_BYTES_PER_S * 1e3
            b_ms, b_by = ((t_ops, "operations") if t_ops >= t_bytes
                          else (t_bytes, "bytes"))
            line += (f"; in place {ms:.4f} ms (device {dev:.4f} ms, "
                     f"{n_pass} kernel a call), with its copy "
                     f"{copy_ms:.4f} ms; plain {plain_ms:.4f} ms (device "
                     f"{plain_dev:.4f} ms, {n_plain} kernels a call); bound "
                     f"{b_ms:.6f} ms ({b_by}: {distinct} distinct tokens, "
                     f"{ops:.0f} int32 ops; bytes {t_bytes:.6f} ms); peak "
                     f"allocation in place {peak} B, with its copy "
                     f"{peak_copy} B, plain {peak_plain} B, against R x V x "
                     f"4 = {R * V * 4} B; no library call")
            if peak >= R * V * 4:
                raise AssertionError(f"history_pass: {peak} B allocated with "
                                     "the logits handed over")
            res = dict(max_abs_err=float((got - want).abs().nan_to_num()
                                         .max()),
                       ms=ms, device_ms=dev, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
        log(line)
    return res


def sampled_trace(llm, prompts: list, params) -> tuple:
    """``llm.generate`` of sampled requests; returns (the outputs, {request
    id: [noisy score rows]}): the plain Gumbel-max's noisy scores each
    token was drawn from (``sample_tokens``' draw is wrapped; row r of a
    step's k-th draw is request ``req_ids[r]``'s k-th token). For the
    CPU run, where the plain version draws."""
    import torch
    import aphrodite_tpu_torch.sample.sampler as sampler_mod
    from aphrodite_tpu_torch.sample import rng as trng
    runner, draw = llm.engine.core.worker.runner, sampler_mod.gumbel_sample
    execute = runner.execute_model
    seen, rows = [], {}

    def spy(lp, seeds, out_len, step_offset=0):
        _, key = trng.sample_keys(seeds, out_len.long() + step_offset)
        noise = trng.gumbel(key, lp.shape[-1:])
        seen.append(torch.where(torch.isfinite(lp), lp + noise,
                                float("-inf")).cpu())
        return draw(lp, seeds, out_len, step_offset)

    def step(so):
        seen.clear()
        out = execute(so)
        for r, (rid, toks) in enumerate(zip(out.req_ids,
                                            out.sampled_token_ids)):
            rows.setdefault(rid, []).extend(seen[k][r]
                                            for k in range(len(toks)))
        return out
    sampler_mod.gumbel_sample, runner.execute_model = spy, step
    try:
        outs = llm.generate(prompts, params)
    finally:
        sampler_mod.gumbel_sample = draw
        del runner.execute_model
    return outs, rows


def sampled_partings(what: str, cpu_outs, rows, gpu_outs) -> list:
    """Completions of the card's run that part from the CPU's: at the
    first differing step, the CPU's noisy scores of its token and the
    card's must lie within SAMPLE_GAP, and at most a tenth of the
    completions may part (later tokens of a parted completion follow
    another history and are not compared). Returns (completion, step,
    cpu token, card token, gap) for each."""
    found, n = [], 0
    for a, b in zip(cpu_outs, gpu_outs):
        for ca, cb in zip(a.outputs, b.outputs):
            n += 1
            if len(ca.token_ids) != len(cb.token_ids):
                raise AssertionError(f"{what}: lengths differ")
            i = next((i for i, (x, y) in enumerate(
                zip(ca.token_ids, cb.token_ids)) if x != y), None)
            if i is None:
                continue
            rid = a.request_id if len(a.outputs) == 1 else \
                f"{a.request_id}-cld-{ca.index}"
            sc = rows[rid][i]
            w, g = ca.token_ids[i], cb.token_ids[i]
            found.append((rid, i, w, g, round(float(sc[w] - sc[g]), 6)))
    wide = [p for p in found if not p[-1] < SAMPLE_GAP]
    if wide or len(found) > n // 10:
        raise AssertionError(f"{what}: partings (completion, step, cpu "
                             f"token, card token, gap) {found}; gaps >= "
                             f"{SAMPLE_GAP}: {wide}; at most {n // 10} of "
                             f"{n} may part")
    return found


def sample_parity() -> dict:
    """Phase 19: seeded sampled requests through the port on the card and
    on the CPU with the same weights, fp32. A tiny Qwen2 (phase 3's) with
    the three phase-20 presets in rotation over five prompts (a chunked
    wave, 64-step windows), one request n = 2, logprobs = 5 on the API
    rows and prompt_logprobs = 3 on one; a tiny Gemma-2 (phase 11's; the
    multi-step path) under the creative preset and a tiny Mamba (phase 9's;
    the SSM window) under the penalised one. Tokens equal but at near ties
    (``sampled_partings``); both kernels launched on every card run.
    Returns each kernel's launches, summed over the card runs."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.gumbel_sample import gumbel_sample
    from aphrodite_tpu_torch.ops.history_pass import history_pass
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = {"gumbel_sample": gumbel_sample, "history_pass": history_pass}
    total = dict.fromkeys(kernels, 0)
    presets = list(SAMPLED_PRESETS.values())
    qwen = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                num_attention_heads=8, num_key_value_heads=2,
                intermediate_size=256, max_position_embeddings=1024,
                tie_word_embeddings=False, architectures=["Qwen2ForCausalLM"])
    gemma = dict(vocab_size=256, hidden_size=64, num_hidden_layers=3,
                 intermediate_size=128, sliding_window=16,
                 query_pre_attn_scalar=24, attn_logit_softcapping=50.0,
                 final_logit_softcapping=30.0, max_position_embeddings=512,
                 architectures=["Gemma2ForCausalLM"],
                 **GEMMA_TINY["Gemma2ForCausalLM"])
    mamba = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                 state_size=8, conv_kernel=4, tie_word_embeddings=False,
                 architectures=["MambaForCausalLM"],
                 **SSM_TINY["MambaForCausalLM"])
    cases = [
        ("tiny-qwen2", qwen, None, (7, 150, 64, 90, 33), None,
         dict(block_size=64, num_kv_blocks=64, max_num_batched_tokens=96,
              max_model_len=512)),
        ("tiny-gemma2", gemma, redraw_gemma, (5, 40, 17, 33), 1,
         dict(block_size=16, num_kv_blocks=128, max_num_batched_tokens=32,
              max_model_len=256, decode_window=16)),
        ("tiny-mamba", mamba, redraw_at_fan_in, (5, 40, 17, 33), 2,
         dict(block_size=16, max_num_batched_tokens=16, max_model_len=256)),
    ]
    for name, cfg, redraw, lens, preset, extra in cases:
        kw = dict(hf_config=cfg, tokenizer="unused", dtype="float32",
                  max_num_seqs=4, **extra)
        cpu = LLM(name, device="cpu", **kw)
        if redraw is not None:
            redraw(cpu.engine.core.worker.model, 6)
        gpu = LLM(name, device="cuda", **kw)
        gpu.engine.core.worker.load_params(
            {k: v.numpy() for k, v in
             cpu.engine.core.worker.model.state_dict().items()})
        rng = np.random.RandomState(7)
        prompts = [rng.randint(1, cfg["vocab_size"] - 6, size=n).tolist()
                   for n in lens]
        params = []
        for i in range(len(prompts)):
            p = dict(presets[i % 3] if preset is None else presets[preset])
            if p.get("dry_sequence_breaker_ids"):
                p["dry_sequence_breaker_ids"] = [1, 2]
            p.update(seed=500 + i, max_tokens=24, ignore_eos=True)
            if name == "tiny-qwen2" and i == 1:
                p["prompt_logprobs"] = 3
            if name == "tiny-qwen2" and i == 4:
                p["n"] = 2
            params.append(SamplingParams(**p))
        a, rows = sampled_trace(cpu, prompts, params)
        for fn in kernels.values():
            fn.launches = 0
        b = gpu.generate(prompts, params)
        got = {k: fn.launches for k, fn in kernels.items()}
        if min(got.values()) <= 0:
            raise AssertionError(f"phase 19 {name}: launches {got}")
        found = sampled_partings(f"phase 19 {name}", a, rows, b)
        lp_err = max((abs(x[t].logprob - y[t].logprob)
                      for oa, ob in zip(a, b)
                      for ca, cb in zip(oa.outputs, ob.outputs)
                      if ca.logprobs and ca.token_ids == cb.token_ids
                      for x, y in zip(ca.logprobs, cb.logprobs)
                      for t in x), default=0.0)
        plp = [o.prompt_logprobs for o in b if o.prompt_logprobs]
        n_tok = sum(len(c.token_ids) for o in a for c in o.outputs)
        log(f"# phase 19: {name}: card == cpu sampled tokens for "
            f"{sum(len(o.outputs) for o in a)} completions ({n_tok} "
            f"tokens) but at partings (completion, step, cpu token, card "
            f"token, gap < {SAMPLE_GAP}) {found} ({len(found)} of the "
            f"completions); top logprobs max |card - cpu| {lp_err:.3g}; "
            f"prompt logprobs on {len(plp)} request(s); launches {got}")
        for k in total:
            total[k] += got[k]
        del cpu, gpu
    return total


def main_path_sampled(llm, greedy: dict) -> dict:
    """Phase 20, the sampler slice's main path: phase 6's Llama-3.1-8B
    W4A16 engine after its greedy runs, the same 32 x (512 + 64) traffic
    (``ignore_eos``) with each request seeded (2000 + i) and the three
    ``SAMPLED_PRESETS`` in rotation. Every cold and warm run: exactly 2048
    tokens, the packed W4 kernel 8064, ragged 32 and window 2016 times (as
    phase 6), the Gumbel kernel 64 times (one draw for the wave and one
    for each of the window's 63 sub-steps) and the token-history pass 64
    (one launch at each of those draws: DRY, the penalties and
    no-repeat-ngram). Two
    cold runs' tokens are compared (the noise is fixed by the seeds, so only the model's own
    run-to-run numerics can part them). One captured sub-step (the
    window's tenth): every token in the support the plain ``sample_tokens``
    keeps for its row, and the kernel's token the plain version's but at
    gaps < NOISE_GAP. Walls beside phase 6's greedy walls (``greedy``) and
    a profiled run with the sampler's device time as a "sample" item and
    the history pass's launches and device time a draw."""
    import dataclasses
    import torch
    import aphrodite_tpu_torch.sample.sampler as sampler_mod
    import aphrodite_tpu_torch.worker.runner as runner_mod
    from aphrodite_tpu_torch import SamplingParams
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    from aphrodite_tpu_torch.ops.gumbel_sample import (gumbel_sample,
                                                       ref_gumbel_sample)
    from aphrodite_tpu_torch.ops.history_pass import (history_pass,
                                                      ref_history_pass)
    from aphrodite_tpu_torch.sample import rng as trng
    phase, layers, steps = "phase 20", LLAMA31_8B["num_hidden_layers"], 63
    num_prompts, prompt_len, decode_len = 32, 512, 64
    rng = np.random.RandomState(0)  # phase 6's prompts
    prompts = [rng.randint(10, 100000, size=prompt_len).tolist()
               for _ in range(num_prompts)]
    names = list(SAMPLED_PRESETS)
    params = [SamplingParams(max_tokens=decode_len, ignore_eos=True,
                             seed=2000 + i,
                             **SAMPLED_PRESETS[names[i % 3]])
              for i in range(num_prompts)]
    counted = {"w4a16_packed_matmul": qm.w4a16_packed_matmul,
               **attention_kernels(), "gumbel_sample": gumbel_sample,
               "history_pass": history_pass}
    exact = {"w4a16_packed_matmul": 4 * layers * steps,
             "ragged_paged_attention": layers,
             "window_decode_attention": layers * steps,
             "gumbel_sample": 1 + steps, "history_pass": 1 + steps}
    log(f"# {phase}: launches a run, reckoned: {exact}")

    def one_run() -> float:
        for fn in counted.values():
            fn.launches = 0
        t = time.perf_counter()
        outs = llm.generate(prompts, params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        toks = [o.outputs[0].token_ids for o in outs]
        if sum(map(len, toks)) != num_prompts * decode_len:
            raise AssertionError(f"{phase}: {sum(map(len, toks))} tokens")
        if not all(0 <= t < LLAMA31_8B["vocab_size"] for x in toks
                   for t in x):
            raise AssertionError(f"{phase}: token id out of the vocabulary")
        got = {k: fn.launches for k, fn in counted.items()}
        if got != exact:
            raise AssertionError(f"{phase}: launches {got}, want {exact}")
        one_run.tokens = toks
        return dt

    cold, warm, cold_tokens = [], [], []
    for i in range(2):
        if not llm.engine.reset_prefix_cache():
            raise AssertionError("reset_prefix_cache refused")
        cold.append(one_run())
        cold_tokens.append(one_run.tokens)
        log(f"# {phase}: cold run {i}: {cold[-1]:.3f} s")
    for i in range(2):
        warm.append(one_run())
        log(f"# {phase}: warm run {i}: {warm[-1]:.3f} s")
    same = sum(x == y for a, b in zip(*cold_tokens) for x, y in zip(a, b))
    first = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                  None) for a, b in zip(*cold_tokens)]
    log(f"# {phase}: two cold runs agree on {same} of "
        f"{num_prompts * decode_len} tokens ({same / (num_prompts * decode_len):.1%}); "
        f"{sum(f is not None for f in first)} of {num_prompts} requests "
        f"part, first at steps {[f for f in first if f is not None]}")
    n_dec = num_prompts * decode_len
    n_all = num_prompts * (prompt_len + decode_len)
    for label, ts in (("cold", cold), ("warm", warm)):
        s = float(np.mean(ts))
        g = greedy.get(label)
        log(f"# {phase}: {label} {s:.3f} s/run (runs {ts}); "
            f"{n_dec / s:.0f} decode tok/s; {n_all / s:.0f} tok/s "
            f"(prefill+decode); phase 6 greedy in this call "
            + (f"{g:.3f} s/run (+{s - g:.3f} s)" if g else "not run"))

    # One captured sub-step against the plain pipeline on the same tensors.
    sample, cap = runner_mod.sample_tokens, {}

    def capture(logits, md, flags, max_lp=0, step_offset=0, **kw):
        # Before the call: the window hands its logits over to the pass.
        before = (logits.clone(), dataclasses.replace(
            md, **{f.name: getattr(md, f.name).clone()
                   for f in dataclasses.fields(md)}))
        out = sample(logits, md, flags, max_lp, step_offset, **kw)
        if step_offset == 10 and not cap:
            cap.update(logits=before[0], md=before[1], flags=flags,
                       max_lp=max_lp, tokens=out["tokens"].clone())
        return out
    runner_mod.sample_tokens = capture
    try:
        llm.engine.reset_prefix_cache()
        one_run()
    finally:
        runner_mod.sample_tokens = sample
    kept = {}

    def plain_draw(lp, seeds, out_len, step_offset=0):
        _, key = trng.sample_keys(seeds, out_len.long() + step_offset)
        kept["noisy"] = torch.where(torch.isfinite(lp), lp + trng.gumbel(
            key, lp.shape[-1:]), float("-inf"))
        return ref_gumbel_sample(lp, seeds, out_len, step_offset)

    def plain_history(logits, md, flags, inplace=False):
        return ref_history_pass(logits, md, flags)
    draw, hist = sampler_mod.gumbel_sample, sampler_mod.history_pass
    sampler_mod.gumbel_sample, sampler_mod.history_pass = (plain_draw,
                                                           plain_history)
    try:
        plain = sample(cap["logits"], cap["md"], cap["flags"],
                       cap["max_lp"], 10)["tokens"]
    finally:
        sampler_mod.gumbel_sample, sampler_mod.history_pass = draw, hist
    noisy, tok = kept["noisy"], cap["tokens"]
    support = torch.isfinite(noisy).sum(-1)
    in_support = torch.isfinite(noisy.gather(1, tok[:, None]))[:, 0]
    top2 = noisy.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    part = tok != plain
    if not bool(in_support.all()) or bool((part & ~(gap < NOISE_GAP)).any()):
        raise AssertionError(
            f"{phase}: captured sub-step: kernel tokens {tok.tolist()}, "
            f"plain {plain.tolist()}, in support {in_support.tolist()}, "
            f"gaps {gap.tolist()}")
    log(f"# {phase}: captured sub-step 10: every token in its row's "
        f"support (sizes {support.tolist()}); kernel == plain tokens in "
        f"{int((~part).sum())} of {num_prompts} rows (the rest at gaps < "
        f"{NOISE_GAP})")

    def profiled() -> float:
        from torch.profiler import record_function

        def spanned(*a, **kw):
            with record_function("sample"):
                return sample(*a, **kw)

        runner_mod.sample_tokens = spanned
        try:
            return one_run()
        finally:
            runner_mod.sample_tokens = sample
    llm.engine.reset_prefix_cache()
    # The pass's kernel by name: a ctypes launch has no torch op that a
    # host range could hold.
    kernels = profile_run(profiled, phase, spans=("aten::bmm", "sample"))
    ns, n = [sum(v[i] for k, v in kernels.items() if "history_pass" in k)
             for i in (0, 1)]
    if n != 1 + steps:
        raise AssertionError(f"{phase}: {n} history-pass kernels in the "
                             f"profiled run, want {1 + steps}")
    log(f"# {phase}: the history pass a draw: {n / (1 + steps):.0f} "
        f"launch, device {ns / 1e6 / (1 + steps):.4f} ms ({1 + steps} "
        "draws a run)")
    return {k: exact[k] for k in counted}


# The ALiBi slice (phases 2, 21 and 22).
BAICHUAN2_13B = dict(  # baichuan-inc/Baichuan2-13B-Chat config.json
    vocab_size=125696, hidden_size=5120, num_hidden_layers=40,
    num_attention_heads=40, intermediate_size=13696, hidden_act="silu",
    rms_norm_eps=1e-6, model_max_length=4096, tie_word_embeddings=False,
    model_type="baichuan", architectures=["BaichuanForCausalLM"])
# Phase 22's prefill wave: 32 x 512 at 40 / 40 heads of 128.
B13_WAVE = dict(nq=40, kvh=40, ctx=[512] * 32, qlen=[512] * 32)
# Where ALiBi meets the ragged kernel's other options (phase 2, bf16 and
# fp32, against the plain version only): group 8 over later chunks of
# ~1030-token prompts (queries at absolute positions past the cached keys),
# with and without a soft cap; a soft cap at group 1; head_dim 64 on
# 16-token pages with items that start mid-page; head_dim 256 with a cap.
ALIBI_RAGGED_CASES = {
    "group8-chunks": dict(
        nq=40, kvh=5, ctx=_LONG, qlen=_LONG[:4] + [200, 77, 1, 64],
        alibi=True),
    "group8-chunks-softcap30": dict(
        nq=40, kvh=5, ctx=_LONG, qlen=_LONG[:4] + [200, 77, 1, 64],
        alibi=True, opts=dict(logits_soft_cap=30.0)),
    "group1-softcap30": dict(
        nq=40, kvh=40, ctx=[600, 333, 91, 1000], qlen=[600, 100, 91, 37],
        alibi=True, opts=dict(logits_soft_cap=30.0)),
    "hd64-page16-mid-page": dict(
        nq=32, kvh=32, hd=64, page=16, ctx=[517, 300, 45, 1000],
        qlen=[100, 299, 44, 333], alibi=True),
    "hd256-softcap50": dict(
        nq=16, kvh=8, hd=256, ctx=_LONG, qlen=_LONG[:4] + [200, 77, 1, 64],
        alibi=True, opts=dict(logits_soft_cap=50.0)),
}


def alibi_checks(gen, dt: str, results: dict) -> None:
    """Phase 2 for the ALiBi slice in ``dt``: the ragged kernel with ALiBi
    at phase 22's wave (timed; in bf16 beside the same wave without ALiBi,
    in the same call) and at ``ALIBI_RAGGED_CASES``, each against the plain
    version. The decode kernel's ALiBi case at the path's step is
    ``DECODE_CASES["baichuan2-13b-alibi"]``."""
    name = "ragged_paged_attention"
    r = check_ragged(gen, dt, dict(B13_WAVE, alibi=True))
    results[(name, "baichuan2-13b-bf16", dt)] = r
    line = (f"# phase 2: {name} {dt} with ALiBi at baichuan2-13b shapes: "
            f"max_abs_err {r['max_abs_err']:.3g} (tol {TOL[dt]} x max(1, "
            f"max|ref row|)); "
            f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f} ms), "
            f"plain {r['plain_ms']:.4f} ms, sdpa with the bias as a float "
            f"mask {r['library_ms']:.4f} ms (device "
            f"{r['library_device_ms']:.4f} ms), bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']})")
    if dt == "bfloat16":
        r0 = check_ragged(gen, dt, B13_WAVE)
        line += (f"; the same wave without ALiBi {r0['ms']:.4f} ms (device "
                 f"{r0['device_ms']:.4f} ms): ALiBi costs "
                 f"{r['device_ms'] / r0['device_ms'] - 1:+.1%} device time")
    log(line)
    for case, geom in ALIBI_RAGGED_CASES.items():
        err = check_ragged(gen, dt, geom, timed=False)
        log(f"# phase 2: {name} {dt} ALiBi {case}: max_abs_err {err:.3g} "
            f"(tol {TOL[dt]} x max(1, max|ref row|))")


def span_rows(spans: list):
    """[R, M, 2] int32 image spans on the card, -1 padding, M the next
    power of two (at least 2) of the most spans a request has (the
    runner's ``_span_rows``)."""
    import torch
    most = max(len(s) for s in spans)
    arr = np.full((len(spans), 1 << max(1, (most - 1).bit_length()), 2), -1,
                  np.int32)
    for r, sp in enumerate(spans):
        for j, (lo, hi) in enumerate(sp):
            arr[r, j] = (lo, hi)
    return torch.from_numpy(arr).cuda()


# Phase 26's prompt: 512 tokens, one 896 x 896 image expanded to its 256
# placeholder tokens between boi and eoi (bos, 99 text tokens, boi, the
# span at 101-356, eoi, 154 text tokens).
G3_SPAN = (101, 357)
# Phase 26's prefill wave: 32 x 512 at 8 / 4 heads of 256, one span each.
G3_WAVE = dict(nq=8, kvh=4, hd=256, ctx=[512] * 32, qlen=[512] * 32,
               scale=256 ** -0.5, spans=[[G3_SPAN]] * 32)
# Where image spans meet the ragged kernel's other options (phase 2, bf16
# and fp32, against the plain version only): spans that start and end
# inside a 32/64-key tile, a work item and a warp's rows (5-300, 37-171);
# later chunks whose span began in an earlier chunk (250-450 at a chunk of
# 300-599) or runs past the keys written so far (350-500 at a context of
# 400); two spans in one request beside requests without any; a sliding
# window (64) shorter than a span; a soft cap; 16-token pages; head_dim
# 128 at group 4 and 256 at group 2 (Gemma-3-4B); head_dim 32 at group 2
# (phases 25 and 34's tiny Gemma-3: in 16 bits the tensor-core span
# instances in 64-wide tiles).
_SPAN_CTX = [600, 400, 517, 300, 45, 1000]
_SPAN_QLEN = [300, 150, 517, 299, 44, 333]
_SPAN_SETS = [[(250, 450)], [(350, 500)], [(5, 300), (301, 410)],
              [(37, 171)], [], []]
SPAN_RAGGED_CASES = {
    "hd256-group2": dict(nq=8, kvh=4, hd=256, ctx=_SPAN_CTX,
                         qlen=_SPAN_QLEN, spans=_SPAN_SETS),
    "hd128-group4": dict(nq=16, kvh=4, ctx=_SPAN_CTX, qlen=_SPAN_QLEN,
                         spans=_SPAN_SETS),
    "hd256-window64": dict(nq=8, kvh=4, hd=256, ctx=_SPAN_CTX,
                           qlen=_SPAN_QLEN, spans=_SPAN_SETS,
                           opts=dict(sliding_window=64)),
    "hd256-softcap50-page16": dict(nq=8, kvh=4, hd=256, page=16,
                                   ctx=_SPAN_CTX, qlen=_SPAN_QLEN,
                                   spans=_SPAN_SETS,
                                   opts=dict(logits_soft_cap=50.0)),
    "hd64-group1": dict(nq=4, kvh=4, hd=64, ctx=_SPAN_CTX, qlen=_SPAN_QLEN,
                        spans=_SPAN_SETS),
    "hd32-group2": dict(nq=4, kvh=2, hd=32, ctx=_SPAN_CTX, qlen=_SPAN_QLEN,
                        spans=_SPAN_SETS),
}


def span_checks(gen, dt: str, results: dict) -> None:
    """Phase 2 for the image-span option of the ragged kernel in ``dt``:
    phase 26's wave (timed, beside SDPA with (causal OR span) as a boolean
    mask, and in bf16 beside the same wave without spans, in the same
    call), the ``SPAN_RAGGED_CASES`` and, in bf16, the wave and two cases
    on an e4m3 cache, each against the plain version."""
    name = "ragged_paged_attention"
    r = check_ragged(gen, dt, G3_WAVE)
    results[(name, "gemma-3-4b-it-bf16", dt)] = r
    line = (f"# phase 2: {name} {dt} with image spans at gemma-3-4b-it "
            f"shapes: max_abs_err {r['max_abs_err']:.3g} (tol {TOL[dt]}); "
            f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f} ms), "
            f"plain {r['plain_ms']:.4f} ms, sdpa with (causal OR span) as a "
            f"boolean mask {r['library_ms']:.4f} ms (device "
            f"{r['library_device_ms']:.4f} ms), bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']}); {blind_text(r)}")
    if dt == "bfloat16":
        r0 = check_ragged(gen, dt, {k: v for k, v in G3_WAVE.items()
                                    if k != "spans"})
        line += (f"; the same wave without spans {r0['ms']:.4f} ms (device "
                 f"{r0['device_ms']:.4f} ms): spans cost "
                 f"{r['device_ms'] / r0['device_ms'] - 1:+.1%} device time")
    log(line)
    for case, geom in SPAN_RAGGED_CASES.items():
        err = check_ragged(gen, dt, geom, timed=False)
        log(f"# phase 2: {name} {dt} spans {case}: max_abs_err {err:.3g} "
            f"(tol {TOL[dt]})")
    if dt == "bfloat16":
        kv = "float8_e4m3fn"
        r = check_ragged(gen, dt, G3_WAVE, kv=kv)
        results[(name, "gemma-3-4b-it-bf16", dt, kv)] = r
        log(f"# phase 2: {name} {dt}, {kv} cache, with image spans at "
            f"gemma-3-4b-it shapes: max_abs_err {r['max_abs_err']:.3g} (tol "
            f"{TOL[dt]}); kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f} ms), sdpa on K/V upcast to {dt} with "
            f"(causal OR span) as a boolean mask {r['library_ms']:.4f} ms "
            f"(device {r['library_device_ms']:.4f} ms), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        for case in ("hd256-group2", "hd256-window64"):
            err = check_ragged(gen, dt, SPAN_RAGGED_CASES[case], timed=False,
                               kv=kv)
            log(f"# phase 2: {name} {dt}, {kv} cache, spans {case}: "
                f"max_abs_err {err:.3g} (tol {TOL[dt]})")


# Phase 21: tiny members of the ALiBi decoder families (and Falcon's rope
# generations) in their config.json spellings, which the port reads
# without ``transformers``: 2 layers, vocab 256, 6 or 12 query heads of 16
# (not a power of two: the slopes' interpolation branch).
FLEX_TINY = {
    "bloom": dict(architectures=["BloomForCausalLM"], model_type="bloom",
                  hidden_size=96, n_head=6, n_layer=2),
    "mpt-clip-qkv": dict(
        architectures=["MPTForCausalLM"], model_type="mpt", d_model=192,
        n_heads=12, n_layers=2, expansion_ratio=2,
        attn_config={"clip_qkv": 0.6, "alibi_bias_max": 8}),
    "falcon-rw": dict(
        architectures=["RWForCausalLM"], model_type="falcon",
        hidden_size=96, num_attention_heads=6, num_hidden_layers=2,
        alibi=True, parallel_attn=False, multi_query=False, bias=True),
    "falcon-7b": dict(
        architectures=["FalconForCausalLM"], model_type="falcon",
        hidden_size=96, num_attention_heads=6, num_hidden_layers=2,
        alibi=False, parallel_attn=True, multi_query=True, bias=False),
    "falcon-new-arch": dict(
        architectures=["FalconForCausalLM"], model_type="falcon",
        hidden_size=96, num_attention_heads=6, num_hidden_layers=2,
        alibi=False, new_decoder_architecture=True, num_kv_heads=2,
        bias=False),
    "baichuan-alibi": dict(
        architectures=["BaichuanForCausalLM"], model_type="baichuan",
        hidden_size=192, num_attention_heads=12, num_hidden_layers=2,
        intermediate_size=256, rms_norm_eps=1e-6, hidden_act="silu",
        tie_word_embeddings=False, model_max_length=512),
}


def redraw_flexible(model, seed: int) -> None:
    """Weights from a seeded CPU generator: the embedding at 1/sqrt(H),
    projections at 3x fan-in scale (with the dummy recipe, or at fan-in
    scale, a tied head repeats the input token), norm scales near 1 and
    biases near 0 (as ``tests/test_torch_flexible.perturb`` draws them)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            r = torch.randn(p.shape, generator=g)
            if leaf.startswith("b") or leaf.endswith("_b"):
                new = 0.1 * r
            elif "ln" in leaf or "norm" in leaf:
                new = 1 + 0.1 * r
            elif leaf == "embed":
                new = r / p.shape[1] ** 0.5
            else:  # [fan_in, fan_out] projections
                new = 3 * r / p.shape[0] ** 0.5
            p.copy_(new.to(p.dtype))


class SlopeSpy:
    """The attention backend's two kernel wrappers, patched to count the
    card calls that carry ALiBi slopes (``launches``, read and reset as a
    kernel's count is) and those that carry none (``without``)."""

    def __init__(self, name: str) -> None:
        from aphrodite_tpu_torch.attention import backend
        self.backend, self.name = backend, name
        self.fn = getattr(backend, name)
        self.launches = self.without = 0

    def __call__(self, q, *a, **kw):
        if q.is_cuda:
            if kw.get("alibi") is not None:
                self.launches += 1
            else:
                self.without += 1
        return self.fn(q, *a, **kw)

    def __enter__(self):
        setattr(self.backend, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.backend, self.name, self.fn)


def flexible_parity() -> dict:
    """fp32 greedy tokens through the port on the card and on the CPU with
    the same weights for ``FLEX_TINY``: a 16-token batch budget (mixed
    waves whose chunks sit past keys earlier chunks cached), 8-step decode
    windows on the multi-step path. Tokens must be equal; for the ALiBi
    families every card call of the ragged and decode kernels must carry
    the model's slopes (and no call for the rope ones). Returns the two
    kernels' launches on the card runs of the ALiBi families."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.decode_paged_attention import (
        decode_paged_attention)
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(21)
    prompts = [rng.randint(1, 250, size=n).tolist()
               for n in (5, 40, 17, 33, 70)]
    params = [SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True)
              for n in (24, 9, 30, 17, 24)]
    total = {"ragged_paged_attention": 0, "decode_paged_attention": 0}
    for fam, cfg in FLEX_TINY.items():
        kw = dict(hf_config=dict(cfg, vocab_size=256), tokenizer="unused",
                  dtype="float32", block_size=16, num_kv_blocks=128,
                  max_num_seqs=4, max_num_batched_tokens=16,
                  max_model_len=256, decode_window=8)
        cpu = LLM("tiny-flexible", device="cpu", **kw)
        redraw_flexible(cpu.engine.core.worker.model, 22)
        gpu = LLM("tiny-flexible", device="cuda", **kw)
        gpu.engine.core.worker.load_params(
            cpu.engine.core.worker.model.state_dict())
        alibi = gpu.engine.core.worker.model.alibi is not None
        a = traced(cpu, prompts, params)
        ragged_paged_attention.launches = 0
        decode_paged_attention.launches = 0
        with SlopeSpy("ragged_paged_attention") as rs, \
                SlopeSpy("decode_paged_attention") as ds:
            b = traced(gpu, prompts, params)
        got = {"ragged_paged_attention": ragged_paged_attention.launches,
               "decode_paged_attention": decode_paged_attention.launches}
        if a[0] != b[0]:
            raise AssertionError(f"{fam}: cuda vs cpu greedy tokens "
                                 f"differ:\n{a[0]}\n{b[0]}")
        if len({t for x in a[0] for t in x}) <= 10:
            raise AssertionError(f"{fam}: the tokens hardly vary: {a[0]}")
        with_slopes = (rs.launches, ds.launches)
        want = tuple(got.values()) if alibi else (0, 0)
        if min(got.values()) <= 0 or with_slopes != want or (
                alibi and (rs.without or ds.without)):
            raise AssertionError(
                f"{fam}: launches {got}, with slopes {with_slopes}, without "
                f"{(rs.without, ds.without)}; want every launch "
                + ("with" if alibi else "without") + " slopes")
        for k in total:
            total[k] += got[k] if alibi else 0
        log(f"# phase 21: {fam}: cuda == cpu greedy tokens for "
            f"{len(prompts)} prompts (16-token budget, 8-step decode "
            f"windows, {'ALiBi' if alibi else 'rope'}); launches {got}, "
            f"with slopes {with_slopes}")
        del cpu, gpu
    return total


def main_path_baichuan() -> dict:
    """Baichuan2-13B bf16 at full width and depth (ALiBi on all 40 heads),
    phase 6's traffic: one 16384-token wave on the ragged kernel with the
    slopes, then one 63-step window through the non-window multi-step path
    (the decode kernel with the slopes once a layer a sub-step). In every
    cold and warm run: ragged exactly 40 and decode exactly 40 x 63 = 2520
    launches, every one carrying the slopes, and the window kernel
    never."""
    from aphrodite_tpu_torch.ops.decode_paged_attention import (
        decode_paged_attention)
    L, steps = BAICHUAN2_13B["num_hidden_layers"], 63
    with SlopeSpy("ragged_paged_attention") as rs, \
            SlopeSpy("decode_paged_attention") as ds:
        counts = serve_workload(
            "phase 22", "baichuan2-13b-dummy", BAICHUAN2_13B,
            {"decode_paged_attention": decode_paged_attention,
             **attention_kernels(), "ragged with slopes": rs,
             "decode with slopes": ds},
            exact={"ragged_paged_attention": L,
                   "decode_paged_attention": L * steps,
                   "window_decode_attention": 0, "ragged with slopes": L,
                   "decode with slopes": L * steps})[0]
    if rs.without or ds.without:
        raise AssertionError(f"phase 22: {rs.without} ragged and "
                             f"{ds.without} decode calls without slopes")
    return counts


KV_FP8 = ("float8_e4m3fn", "float8_e5m2")
# The fp8-cache instances timed (beside their bf16-cache selves at the same
# call's shapes): the 8B path's in bf16 (phase 18), Qwen2.5-1.5B's heads in
# fp32 (phase 17's parity runs); the rest are held for errors only.
FP8_TIMED = {"bfloat16": "llama-3.1-8b-w4a16", "float32": "qwen2.5-1.5b-bf16"}


def fp8_attention_checks(gen, dt: str, results: dict) -> None:
    """Phase 2 on fp8 caches: every attention kernel at its existing
    geometries (the paths', the mask cases, the decode cases, the cascade)
    on e4m3 and e5m2 caches, in ``dt``, against the plain versions at the
    same tolerances; the window's tails e4m3 beside e4m3 and bf16 beside
    e5m2. Times as ``FP8_TIMED`` says, the decode kernel at Gemma-2-9B's
    step and the cascade on e4m3."""
    for kv in KV_FP8:
        for path, geom in ATTN_GEOMS.items():
            timed = FP8_TIMED[dt] == path
            for name, fn in (("ragged_paged_attention", check_ragged),
                             ("window_decode_attention", check_window)):
                r = fn(gen, dt, geom, timed=timed, kv=kv)
                if not timed:
                    log(f"# phase 2: {name} {dt}, {kv} cache, at {path} "
                        f"shapes: max_abs_err {r:.3g} (tol "
                        f"{tol_text(name, dt)})")
                    continue
                log(f"# phase 2: {name} {dt}, {kv} cache, at {path} shapes: "
                    f"max_abs_err {r['max_abs_err']:.3g} (tol "
                    f"{tol_text(name, dt)}); kernel {r['ms']:.4f} ms (device "
                    f"{r['device_ms']:.4f} ms), its {dt}-cache self "
                    f"{results[(name, path, dt)]['ms']:.4f} ms (device "
                    f"{results[(name, path, dt)]['device_ms']:.4f} ms), "
                    f"plain {r['plain_ms']:.4f} ms, sdpa on K/V upcast to "
                    f"{dt} {r['library_ms']:.4f} ms (device "
                    f"{r['library_device_ms']:.4f} ms), bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']}, K/V at "
                    f"{1} byte)")
                results[(name, path, dt, kv)] = r
        for cases, fn, name in (
                (RAGGED_MASK_CASES, check_ragged, "ragged_paged_attention"),
                (WINDOW_MASK_CASES, check_window,
                 "window_decode_attention")):
            for case, geom in cases.items():
                err = fn(gen, dt, geom, timed=False, kv=kv)
                log(f"# phase 2: {name} {dt}, {kv} cache, {case}: "
                    f"max_abs_err {err:.3g} (tol {tol_text(name, dt)})")
        for case in DECODE_CASES:
            timed = case == "gemma-2-9b" and kv == KV_FP8[0]
            r = check_decode(gen, dt, case, kv=kv, timed=timed)
            if timed:
                results[("decode_paged_attention", case, dt, kv)] = r
            else:
                log(f"# phase 2: decode_paged_attention {case} {dt}, {kv} "
                    f"cache: max_abs_err {r['max_abs_err']:.3g}")
        spa, _ = check_cascade(gen, dt, kv=kv, timed=kv == KV_FP8[0])
        results[("shared_prefix_attention", dt, kv)] = spa


# ----------------------------------------------------------- the MLA slice
DEEPSEEK_V2_LITE = dict(  # deepseek-ai/DeepSeek-V2-Lite config.json
    vocab_size=102400, hidden_size=2048, num_hidden_layers=27,
    num_attention_heads=16, num_key_value_heads=16, intermediate_size=10944,
    moe_intermediate_size=1408, n_routed_experts=64, num_experts_per_tok=6,
    n_shared_experts=2, first_k_dense_replace=1, moe_layer_freq=1,
    topk_method="greedy", n_group=1, topk_group=1, norm_topk_prob=False,
    routed_scaling_factor=1.0, scoring_func="softmax", q_lora_rank=None,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, hidden_act="silu", rms_norm_eps=1e-6, rope_theta=10000,
    rope_scaling={"type": "yarn", "factor": 40, "beta_fast": 32,
                  "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707,
                  "original_max_position_embeddings": 4096},
    max_position_embeddings=163840, tie_word_embeddings=False,
    architectures=["DeepseekV2ForCausalLM"])
# Phase 24's layers: about half the published 27 (the dense first layer
# and 13 MoE layers), which keeps the script inside its time limit as it
# grows; phase 27 serves the model again at full depth on an fp8 cache,
# and every MoE layer runs the same kernels.
DEEPSEEK_DEPTH = 14
# The model's softmax scale: qk_head_dim (192)^-0.5 times DeepSeek-YaRN's
# mscale_all_dim correction squared (models/deepseek.py).
MLA_SCALE = 192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2
# The MLA instances' shapes (phase 2): phase 24's wave (32 x 512 tokens,
# 16 query heads on one latent head of 576) and its window sub-steps (R =
# 32 over 513-576 keys: 512 frozen and a 64-slot tail); V3's group of 128
# (128 query heads on the one head) over a few requests of a few hundred
# tokens, the window at R = 4.
MLA_GEOMS = {
    "deepseek-v2-lite-bf16": dict(
        nq=16, kvh=1, hd=576, ctx=[512] * 32, qlen=[512] * 32,
        paged=[512] * 32, scale=MLA_SCALE, mla=True),
    "deepseek-v3-group128": dict(
        nq=128, kvh=1, hd=576, ctx=[300, 200, 257, 64],
        qlen=[300, 200, 257, 64], paged=[300, 200, 257, 64],
        scale=MLA_SCALE, mla=True),
}
# Where the MLA instances' masks bite (bf16 and fp32, errors only): a soft
# cap and a sliding window across a later chunk and decode rows, on
# 16-token pages (a 32-key tile spans two).
MLA_MASK_CASE = dict(nq=16, kvh=1, hd=576, ctx=[400, 130, 77],
                     qlen=[400, 3, 1], paged=[400, 130, 77], page=16,
                     opts=dict(logits_soft_cap=30.0, sliding_window=100),
                     mla=True)
# (K, N) of a V2-Lite MoE layer's two grouped GEMMs over its wave (32 x 512
# tokens x top-6 = 98,304 sorted rows, 64 experts).
V2_LITE_MOE = dict(M=32 * 512 * 6, E=64, k=6,
                   gemms={"gate_up": (2048, 2 * 1408), "down": (1408, 2048)})


class InstanceCount:
    """The launches of one instance of a wrapper, counted as a kernel of
    its own: an attention wrapper's ``instance_launches`` (by instance) or
    a quantized GEMM's ``dtype_launches`` (by x's dtype)."""

    def __init__(self, fn, instance: str,
                 table: str = "instance_launches") -> None:
        self.fn, self.instance, self.table = fn, instance, table

    @property
    def launches(self) -> int:
        return getattr(self.fn, self.table)[self.instance]

    @launches.setter
    def launches(self, value: int) -> None:
        getattr(self.fn, self.table)[self.instance] = value


def instance_counts() -> dict:
    """Each instance of the ragged and window kernels as a counted kernel:
    "ragged mla", "window scalar", ..."""
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention)
    from aphrodite_tpu_torch.ops.window_decode_attention import (
        window_decode_attention)
    return {f"{kind} {inst}": InstanceCount(fn, inst)
            for kind, fn in (("ragged", ragged_paged_attention),
                             ("window", window_decode_attention))
            for inst in ("mla", "tensor_cores", "scalar")}


@contextlib.contextmanager
def scalar_instances():
    """Within it, bf16 and fp16 size and launch the scalar instances of
    the ragged and window kernels and the decode kernel's CUDA-core one
    (the "before" of the MLA instances, and of the tensor-core instances
    at head dims other than 64, 128 and 256 and at groups past 16): the
    wrappers' MLA and tensor-core predicates answer False (the window's
    tensor-core gate is left as it is)."""
    from aphrodite_tpu_torch.ops import decode_paged_attention as dm
    from aphrodite_tpu_torch.ops import ragged_paged_attention as rm
    from aphrodite_tpu_torch.ops import window_decode_attention as wm
    saved = [(m, n, getattr(m, n)) for m, n in (
        (rm, "ragged_uses_mla"), (wm, "window_uses_mla"),
        (rm, "ragged_uses_tensor_cores"), (dm, "decode_uses_tensor_cores"))]
    for m, n, _ in saved:
        setattr(m, n, lambda *a: False)
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def check_mla_cascade(gen, dtype_name: str, page: int,
                      kv: str | None = None) -> float:
    """The shared-prefix pass at head_dim 576 (its CUDA-core instance, bf16
    and fp16 too) and the window kernel started from its state (the MLA
    instance in bf16 or fp16, two launches bit-equal): 8 requests of 16 heads
    sharing 4 pages, on a cache of q's dtype or of the fp8 dtype ``kv`` (tails
    in ``tail_dtype`` of it), against the plain cascade; returns the error
    (held at ``scaled_tol``)."""
    import torch
    from aphrodite_tpu_torch.ops.cascade_attention import (
        ref_cascade_window_decode, shared_prefix_attention)
    from aphrodite_tpu_torch.ops.window_decode_attention import (
        tail_dtype, window_decode_attention)
    dtype = getattr(torch, dtype_name)
    kvd = kv_type(dtype, kv)
    R, nq, hd, S, Kw = 8, 16, 576, 4 * page, 64
    plens = [S + 40 + 7 * r for r in range(R)]
    cache, bt = paged_cache(gen, [p + Kw for p in plens], kvd, 1, hd=hd,
                            page=page)
    bt[:, :S // page] = bt[0, :S // page]
    tk, tv = (torch.randn((2, R, 1, Kw, hd), generator=gen,
                          device="cuda").to(tail_dtype(kvd))
              for _ in range(2))
    q = torch.randn((R, nq, hd), generator=gen, device="cuda").to(dtype)
    pl = torch.tensor(plens, dtype=torch.int32, device="cuda")
    sp = bt[0, :S // page].contiguous()
    err = 0.0
    for step in (0, 10, 63):
        init = shared_prefix_attention(q, cache, 1, sp, S, MLA_SCALE)
        out = window_decode_attention(q, cache, tk, tv, 1, step, pl, bt,
                                      MLA_SCALE, cascade_init=init,
                                      shared_len=S)
        ref = ref_cascade_window_decode(q, cache[1], tk[1], tv[1], step, pl,
                                        bt, sp, S, MLA_SCALE)
        torch.cuda.synchronize()
        e = (out.float() - ref.float()).abs().max().item()
        if not (e <= scaled_tol(dtype_name, ref)
                and torch.isfinite(out).all()):
            raise AssertionError(f"MLA cascade {dtype_name}{kv_label(kv)} "
                                 f"step {step}: max_abs_err {e}")
        if dtype != torch.float32 and not torch.equal(
                out, window_decode_attention(
                    q, cache, tk, tv, 1, step, pl, bt, MLA_SCALE,
                    cascade_init=init, shared_len=S)):
            raise AssertionError(f"MLA cascade step {step}: two launches "
                                 "of the window MLA instance differ")
        err = max(err, e)
    return err


def check_grouped_v2lite(gen, dtype_name: str = "bfloat16") -> dict:
    """The grouped GEMM (bf16 or fp16) at phase 24's MoE wave
    (``V2_LITE_MOE``: a layer's gate|up and down over 98,304 rows sorted
    over 64 experts, each token routed to 6 distinct random experts): error
    against the plain version on fp32 copies, two launches bit-equal; time
    a call, device time, the plain version, ``_grouped_mm`` (or a matmul
    loop), and the bound, summed over the two GEMMs."""
    import torch
    from aphrodite_tpu_torch.ops.grouped_matmul import (grouped_matmul,
                                                        ref_grouped_matmul)
    M, E, k = V2_LITE_MOE["M"], V2_LITE_MOE["E"], V2_LITE_MOE["k"]
    off = group_offsets(gen, M, False, E, k=k)
    nonempty = int((off[1:] > off[:-1]).sum())
    tot = dict(max_abs_err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0,
               library_ms=0.0)
    nbytes = ops = 0.0
    for gemm, (K, N) in V2_LITE_MOE["gemms"].items():
        dtype = getattr(torch, dtype_name)
        x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
        w = (torch.randn((E, K, N), generator=gen, device="cuda")
             * (0.5 / K ** 0.5)).to(dtype)
        out, again = grouped_matmul(x, w, off), grouped_matmul(x, w, off)
        ref = ref_grouped_matmul(x.float(), w.float(), off)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        if not (err <= TOL[dtype_name] and torch.isfinite(out).all()
                and torch.equal(out, again)):
            raise AssertionError(f"grouped_matmul {gemm} {dtype_name} at "
                                 f"V2-Lite's wave: max_abs_err {err}, or two "
                                 "launches differ")
        call = lambda: grouped_matmul(x, w, off)  # noqa: E731
        label, lib = grouped_library(x, w, off, ref)
        del ref, out, again
        for key, val in (("ms", cuda_ms(call, 10)),
                         ("device_ms", device_ms(call, 10)),
                         ("plain_ms", cuda_ms(
                             lambda: ref_grouped_matmul(x, w, off), 2)),
                         ("library_ms", cuda_ms(lib, 10))):
            tot[key] += val
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        nbytes += 2 * (M * K + nonempty * K * N + M * N)
        ops += 2.0 * M * K * N
        del x, w
    tot["bound_ms"], tot["bound_by"] = bound_ms(nbytes, ops, dtype_name)
    tot["library"] = label
    log(f"# phase 2: grouped_matmul {dtype_name} at DeepSeek-V2-Lite's MoE "
        f"wave (M={M}, E={E}, {nonempty} groups), a layer's 2 GEMMs: "
        f"max_abs_err {tot['max_abs_err']:.3g} (tol {TOL[dtype_name]}), two "
        f"launches bit-equal; kernel {tot['ms']:.4f} ms (device "
        f"{tot['device_ms']:.4f} ms), plain {tot['plain_ms']:.4f} ms, "
        f"{label} {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} "
        f"ms ({tot['bound_by']})")
    return tot


class OneAllocation:
    """``paged_cache``'s caches, bf16 and fp8 alike, copied into one
    allocation so that layer 1 (the checks' layer) of each starts at the
    same address: a bf16 and an fp8 cache of the same pages then share the
    MLA instances' tensor-map key but for the element type."""

    def __init__(self) -> None:
        self.bufs = {}  # by the elements of a layer

    def __call__(self, gen, ctx, dtype, kvh, hd=HD, page=PAGE):
        import torch
        cache, bt = paged_cache(gen, ctx, dtype, kvh, hd=hd, page=page)
        layer = cache[0].numel()
        if layer not in self.bufs:  # two bf16 layers
            self.bufs[layer] = torch.empty(4 * layer, dtype=torch.uint8,
                                           device="cuda")
        off = 2 * layer - layer * cache.element_size()
        view = self.bufs[layer][off:off + cache.numel()
                                * cache.element_size()]
        view = view.view(cache.dtype).view(cache.shape)
        view.copy_(cache)
        return view, bt


def check_mla_map_key(gen) -> float:
    """Both MLA instances at ``MLA_MASK_CASE``, bf16 and e4m3 caches in
    turns (bf16, e4m3, bf16, e4m3) over one allocation whose layer 1 has
    one base and one row count in both views (``OneAllocation``): each
    launch against its plain version (and the e4m3 ones against their bf16
    selves on the upcast cache). A tensor-map cache keyed without the
    element type hands the second launch the first one's bf16 map.
    Returns the largest error."""
    one, err = OneAllocation(), 0.0
    for kv in (None, KV_FP8[0], None, KV_FP8[0]):
        for fn in (check_ragged, check_window):
            err = max(err, fn(gen, "bfloat16", MLA_MASK_CASE, timed=False,
                              kv=kv, make_cache=one))
    return err


def fp8_tol(name: str) -> str:
    """How an fp8 MLA instance's error limit reads in the log."""
    if name == "ragged_paged_attention":
        return f"{TOL['bfloat16']} x max(1, max|ref row|)"
    return tol_text(name, "bfloat16")


def mla_fp8_checks(gen, results: dict) -> None:
    """Phase 2 for the fp8 cache at the MLA geometry: each MLA instance on
    e4m3 and e5m2 caches (the window's tails e4m3 beside e4m3, bf16 beside
    e5m2) at ``MLA_GEOMS`` against its plain version, bit-equal to its bf16
    self on the upcast cache, two launches bit-equal, timed beside its
    bf16 self (``results``) and SDPA on the upcast K/V, the bound with K/V
    at one byte; at ``MLA_MASK_CASE`` with NaN in the stale slots on pages
    of 16 and 64; the cascade at 576 on the fp8 cache; and bf16 and fp8
    launches in turns over one allocation (``check_mla_map_key``)."""
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention)
    from aphrodite_tpu_torch.ops.window_decode_attention import (
        window_decode_attention)
    for kv in KV_FP8:
        for path, geom in MLA_GEOMS.items():
            for name, fn, wrapper in (
                    ("ragged_paged_attention", check_ragged,
                     ragged_paged_attention),
                    ("window_decode_attention", check_window,
                     window_decode_attention)):
                wrapper.instance_launches.update(mla=0, tensor_cores=0,
                                                 scalar=0)
                r = fn(gen, "bfloat16", geom, kv=kv)
                inst = wrapper.instance_launches
                if not (inst["mla"] > 0
                        and inst["scalar"] == inst["tensor_cores"] == 0):
                    raise AssertionError(f"{name} at {path}, {kv} cache: "
                                         f"{wrapper.instance_launches}")
                self_ = results[(f"{name}_mla", path, "bfloat16")]
                extra = (f"device {r['device_ms']:.4f} ms" + (
                    f", host {r['host_ms']:.4f} ms a call"
                    if "host_ms" in r else ""))
                log(f"# phase 2: {name} MLA instance bf16, {kv} cache, at "
                    f"{path} shapes: max_abs_err {r['max_abs_err']:.3g} (tol "
                    f"{fp8_tol(name)}), bit-equal to its bf16 "
                    f"self on the upcast cache; kernel {r['ms']:.4f} ms "
                    f"({extra}), its bf16-cache self {self_['ms']:.4f} ms "
                    f"(device {self_['device_ms']:.4f} ms), plain "
                    f"{r['plain_ms']:.4f} ms, sdpa on K/V upcast to bf16 "
                    f"{r['library_ms']:.4f} ms (device "
                    f"{r['library_device_ms']:.4f} ms), bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']}, K/V at 1 "
                    "byte)")
                results[(f"{name}_mla", path, "bfloat16", kv)] = r
        for name, fn in (("ragged_paged_attention", check_ragged),
                         ("window_decode_attention", check_window)):
            for page in (16, PAGE):
                for stale in (False, True):
                    err = fn(gen, "bfloat16", dict(MLA_MASK_CASE, page=page,
                                                   stale=stale),
                             timed=False, kv=kv)
                    log(f"# phase 2: {name} MLA instance, {kv} cache, at "
                        f"head_dim 576 on {page}-token pages, soft cap 30 "
                        f"and a 100-token window"
                        f"{', NaN in the stale slots' if stale else ''}: "
                        f"max_abs_err {err:.3g} (tol {fp8_tol(name)}), "
                        "bit-equal to its bf16 self on the upcast cache")
        for page in (16, PAGE):
            log(f"# phase 2: shared_prefix_attention + window at head_dim "
                f"576 bfloat16, {kv} cache (4 shared pages of {page}, R = "
                f"8): max_abs_err "
                f"{check_mla_cascade(gen, 'bfloat16', page, kv):.3g} (tol "
                f"{TOL['bfloat16']} x min(1, max|ref|))")
    log(f"# phase 2: both MLA instances, bf16 and {KV_FP8[0]} caches in "
        f"turns over one allocation (one tensor-map key but the element): "
        f"max_abs_err {check_mla_map_key(gen):.3g} (tol as above), each "
        "right")


def mla_checks(gen, results: dict) -> None:
    """Phase 2 for the MLA slice: each MLA instance (bf16) at
    ``MLA_GEOMS`` against its plain version (ragged at TOL, the window at
    ``scaled_tol``), two launches bit-equal, timed beside SDPA over the
    gathered K/V (its backend named) and, at phase 24's shapes, beside the
    scalar instances in bf16 (one token a work item, one warp a split
    block); the fp32 scalar instances at the same geometries (row slices
    at group 128); both at ``MLA_MASK_CASE``, and the MLA instances there
    with NaN in the stale slots (``poison_stale``) on pages of 16 and 64;
    the cascade at 576; the grouped GEMM at V2-Lite's MoE wave."""
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention)
    from aphrodite_tpu_torch.ops.window_decode_attention import (
        window_decode_attention)
    for path, geom in MLA_GEOMS.items():
        for name, fn, wrapper in (
                ("ragged_paged_attention", check_ragged,
                 ragged_paged_attention),
                ("window_decode_attention", check_window,
                 window_decode_attention)):
            wrapper.instance_launches.update(mla=0, tensor_cores=0, scalar=0)
            r = fn(gen, "bfloat16", geom)
            if not (wrapper.instance_launches["mla"] > 0
                    and wrapper.instance_launches["scalar"] == 0):
                raise AssertionError(f"{name} at {path}: instances "
                                     f"{wrapper.instance_launches}")
            before = ""
            if path == "deepseek-v2-lite-bf16":
                with scalar_instances():
                    b = fn(gen, "bfloat16", geom)
                r["before"] = b
                before = (f"; the bf16 scalar instance (before): "
                          f"{b['ms']:.4f} ms (device {b['device_ms']:.4f} "
                          f"ms), max_abs_err {b['max_abs_err']:.3g}")
            extra = (f"device {r['device_ms']:.4f} ms" + (
                f", host {r['host_ms']:.4f} ms a call"
                if "host_ms" in r else ""))
            log(f"# phase 2: {name} MLA instance bf16 at {path} shapes: "
                f"max_abs_err {r['max_abs_err']:.3g} (tol "
                f"{tol_text(name, 'bfloat16')}); kernel {r['ms']:.4f} ms "
                f"({extra}), plain {r['plain_ms']:.4f} ms, sdpa "
                f"{r['library_ms']:.4f} ms (device "
                f"{r['library_device_ms']:.4f} ms; {r['sdpa_backends']}), "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){before}")
            results[(f"{name}_mla", path, "bfloat16")] = r
            err = fn(gen, "float32", geom, timed=False)
            log(f"# phase 2: {name} scalar instance float32 at {path} "
                f"shapes (row slices): max_abs_err {err:.3g} (tol "
                f"{tol_text(name, 'float32')})")
    for dt in ("bfloat16", "float32"):
        for name, fn in (("ragged_paged_attention", check_ragged),
                         ("window_decode_attention", check_window)):
            err = fn(gen, dt, MLA_MASK_CASE, timed=False)
            log(f"# phase 2: {name} {dt} at head_dim 576 on 16-token pages, "
                f"soft cap 30 and a 100-token window: max_abs_err "
                f"{err:.3g} (tol {tol_text(name, dt)})")
            if dt == "bfloat16":  # the MLA instances load whole boxes
                for page in (16, PAGE):
                    err = fn(gen, dt, dict(MLA_MASK_CASE, page=page,
                                           stale=True), timed=False)
                    log(f"# phase 2: {name} MLA instance, the same with NaN "
                        f"in the stale slots, pages of {page}: max_abs_err "
                        f"{err:.3g} (tol {tol_text(name, dt)})")
        for page in (16, PAGE):
            log(f"# phase 2: shared_prefix_attention + window at head_dim "
                f"576 {dt} (4 shared pages of {page}, R = 8): max_abs_err "
                f"{check_mla_cascade(gen, dt, page):.3g} (tol {TOL[dt]} x "
                "min(1, max|ref|))")
    results[("grouped_matmul", "deepseek-v2-lite-bf16", "bfloat16")] = \
        check_grouped_v2lite(gen)
    mla_fp8_checks(gen, results)


# Phase 23's tiny DeepSeek geometries (fp32): V2 greedy without q_lora, V2
# with q_lora and group-limited routing, V3's sigmoid routing; latent 56 +
# rope 8 = 64 lanes, so that the shared-prefix pass's CUDA-core instance
# (head_dim 64, 128, 256 or 576) takes the cascade batch.
DS_TINY_BASE = dict(
    vocab_size=512, hidden_size=128, num_hidden_layers=3,
    num_attention_heads=8, num_key_value_heads=8, intermediate_size=192,
    kv_lora_rank=56, q_lora_rank=None, qk_nope_head_dim=32,
    qk_rope_head_dim=8, v_head_dim=32, n_routed_experts=8,
    num_experts_per_tok=2, moe_intermediate_size=64, n_shared_experts=1,
    first_k_dense_replace=1, max_position_embeddings=1024,
    rope_scaling=dict(DEEPSEEK_V2_LITE["rope_scaling"],
                      original_max_position_embeddings=256),
    tie_word_embeddings=False, architectures=["DeepseekV2ForCausalLM"])
DS_TINY = {
    "v2": {},
    "v2-qlora-group-limited": dict(q_lora_rank=48, n_group=4, topk_group=2,
                                   routed_scaling_factor=2.0),
    "v3": dict(q_lora_rank=48, n_group=4, topk_group=2, norm_topk_prob=True,
               routed_scaling_factor=2.5,
               architectures=["DeepseekV3ForCausalLM"]),
}
# The tiny configs phase 23 runs again on fp8 caches.
DS_FP8_TINY = ("v2", "v3")
# The bf16 tiny config at the real attention geometry: 16 heads on one
# latent head of 512 + 64, 2 layers, narrow dense MLPs. Dense, because a
# router's top-k flips between two experts at a near tie under bf16
# rounding: one step's logprobs then move by ~0.3 and come back (seen on
# the card between its own runs with the cascade on and off, and between
# the card and the CPU; the fp32 configs keep their experts).
DS_TINY_BF16 = dict(DS_TINY_BASE, num_hidden_layers=2, hidden_size=256,
                    num_attention_heads=16, num_key_value_heads=16,
                    kv_lora_rank=512, qk_nope_head_dim=128,
                    qk_rope_head_dim=64, v_head_dim=128,
                    n_routed_experts=None)
# bf16 logprobs, card vs CPU, where the two runs fed the same tokens: the
# card's bf16 products (P rounded to bf16 before P V, bf16 GEMM outputs)
# against the CPU's fp32 attention and its own bf16 GEMMs. The two differ
# by 0.03-0.06 at every step of this model, as much as the CPU's bf16 run
# differs from its fp32 one (0.03-0.10); a lost key tile or split moves
# the attention output, and a logprob, by far more.
DS_BF16_LOGPROB_TOL = 0.25


def redraw_deepseek(model, seed: int) -> None:
    """Weights from a seeded CPU generator at fan-in scale (the dummy
    recipe's 0.02 makes a model that repeats a few tokens): norms near 1,
    V3's score correction and biases (``b_qkv``: phase 32's Qwen2-MoE)
    near 0, products at 1/sqrt(fan-in) (the expert and absorbed-einsum
    stacks' fan-in is their middle axis)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if name.endswith("router_bias") or \
                    name.rsplit(".", 1)[-1].startswith("b_"):
                new = 0.1 * r
            elif p.dim() == 1:
                new = 1.0 + 0.1 * r
            elif p.dim() == 3:
                new = r / p.shape[1] ** 0.5
            else:
                new = r / p.shape[0] ** 0.5
            p.copy_(new.to(p.dtype))


def deepseek_parity() -> dict:
    """Phase 23: tiny DeepSeek V2 / V3 through the port on the card and on
    the CPU with the same weights (``DS_TINY``: fp32, greedy tokens
    equal; the scalar attention instances), with a 32-token batch budget,
    16-step decode windows and a second batch of three requests sharing a
    4-page prompt (the cascade: the shared-prefix pass, the window from its
    state); ``DS_FP8_TINY`` (V2 and V3) again on e4m3 and e5m2 caches,
    where the tokens may part only at ties (``same_tokens``: K/V rounded
    to 8 bits); then ``DS_TINY_BF16`` (dense MLPs) in bf16, on a bf16 and
    an e4m3 cache, whose every attention launch must be on the MLA
    instances and whose logprobs, up to the first token where the runs
    part, must lie within ``DS_BF16_LOGPROB_TOL`` of the CPU's. Returns the
    card runs' launches."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.cascade_attention import (
        shared_prefix_attention)
    from aphrodite_tpu_torch.ops.grouped_matmul import grouped_matmul
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(23)
    shared = rng.randint(10, 500, size=4 * 16).tolist()
    batches = {"plain": [rng.randint(1, 500, size=n).tolist()
                         for n in (5, 40, 17, 70)],
               "shared prompt": [shared + rng.randint(10, 500, size=3 + i)
                                 .tolist() for i in range(3)]}
    params = SamplingParams(temperature=0.0, max_tokens=20, ignore_eos=True)
    counted = {**instance_counts(), **attention_kernels(),
               "grouped_matmul": grouped_matmul,
               "shared_prefix_attention": shared_prefix_attention}
    total = dict.fromkeys(counted, 0)

    def engines(cfg, dtype, kv="auto"):
        kw = dict(hf_config=cfg, tokenizer="unused", dtype=dtype,
                  block_size=16, num_kv_blocks=128, max_num_seqs=4,
                  max_num_batched_tokens=32, max_model_len=256,
                  decode_window=16, kv_cache_dtype=kv)
        cpu = LLM("tiny-deepseek", device="cpu", **kw)
        redraw_deepseek(cpu.engine.core.worker.model, 24)
        gpu = LLM("tiny-deepseek", device="cuda", **kw)
        gpu.engine.core.worker.load_params(
            cpu.engine.core.worker.model.state_dict())
        return cpu, gpu

    def card_run(gpu, prompts):
        for fn in counted.values():
            fn.launches = 0
        out = traced(gpu, prompts, params)
        got = {k: fn.launches for k, fn in counted.items()}
        for k, v in got.items():
            total[k] += v
        return out, got

    runs = [(name, "auto") for name in DS_TINY]
    runs += [(name, kv) for kv in ("fp8_e4m3", "fp8_e5m2")
             for name in DS_FP8_TINY]
    for name, kv in runs:
        cpu, gpu = engines(dict(DS_TINY_BASE, **DS_TINY[name]), "float32",
                           kv)
        for what, prompts in batches.items():
            a = traced(cpu, prompts, params)
            b, got = card_run(gpu, prompts)
            parted = []
            if kv == "auto" and a[0] != b[0]:
                raise AssertionError(f"{name} {what}: cuda vs cpu greedy "
                                     f"tokens differ:\n{a[0]}\n{b[0]}")
            if kv != "auto":  # K/V rounded to 8 bits: ties may part
                parted = same_tokens(f"phase 23 {name} {kv} {what}", cpu,
                                     gpu, prompts, a, b)
            if len({t for x in a[0] for t in x}) <= 10:
                raise AssertionError(f"{name}: the tokens hardly vary")
            if got["ragged scalar"] <= 0 or got["window scalar"] <= 0 or \
                    got["ragged mla"] or got["window mla"] or (
                    what == "shared prompt"
                    and got["shared_prefix_attention"] <= 0):
                raise AssertionError(f"{name} {what}: launches {got}")
            log(f"# phase 23: {name} fp32, {kv} cache, {what}: cuda == cpu "
                f"greedy tokens for {len(prompts)} prompts x 20"
                + (f" but at partings (request, step, cpu, card, gap < "
                   f"{GAP}) {parted}" if parted else "")
                + f"; launches {got}")
        del cpu, gpu
    for kv in ("auto", "fp8_e4m3"):
        cpu, gpu = engines(DS_TINY_BF16, "bfloat16", kv)
        for what, prompts in batches.items():
            a = traced(cpu, prompts, params)
            b, got = card_run(gpu, prompts)
            worst, parted = 0.0, 0
            for (ta, ra), (tb, rb) in zip(zip(*a), zip(*b)):
                i = next((i for i, (x, y) in enumerate(zip(ta, tb))
                          if x != y), len(ta))
                parted += i < len(ta)
                for j in range(min(i + 1, len(ta))):
                    worst = max(worst, (ra[j] - rb[j]).abs().max().item())
            mla = got["ragged mla"] + got["window mla"]
            if not (worst <= DS_BF16_LOGPROB_TOL and mla > 0
                    and mla == got["ragged_paged_attention"]
                    + got["window_decode_attention"]
                    and got["ragged scalar"] == got["window scalar"] == 0):
                raise AssertionError(
                    f"bf16, {kv} cache, {what}: logprobs up to the first "
                    f"parting differ by {worst} (tol {DS_BF16_LOGPROB_TOL}); "
                    f"launches {got}")
            log(f"# phase 23: bf16 at the MLA geometry (16 / 1 heads of "
                f"576), {kv} cache, {what}: logprobs within {worst:.4f} of "
                f"the CPU's up to the first parting (tol "
                f"{DS_BF16_LOGPROB_TOL}; {parted} of {len(prompts)} requests "
                f"part); every attention launch on the MLA instances: {got}")
        del cpu, gpu
    return total


# The cold and warm walls of phases 24, 27 and 33 in this call, by phase.
DS_WALLS: dict = {}


def main_path_deepseek(kv: str = "auto", dtype: str = "bfloat16") -> dict:
    """Phase 24: DeepSeek-V2-Lite bf16 at full width (16 heads on one
    latent head of 576, 64 experts top-6 and 2 shared; seeded dummy
    weights), its depth cut to ``DEEPSEEK_DEPTH`` of 27 layers, phase 6's
    traffic: one 16384-token wave (the ragged MLA instance once a layer,
    the grouped GEMM twice a MoE layer), then one 63-step window (the
    window MLA instance once a layer a sub-step; the MoE on the dense
    route). In every cold and warm run exactly: ragged L and window 63 L,
    all on the MLA instances; grouped 2 (L - 1); 0 on the other
    instances (L = 14: 14, 882, 26), the ragged ones all from the
    library without options (``source_launches``). Phase 27 (``kv``
    "fp8_e4m3"): the same at full depth (27 layers: 27, 1701, 52) on an
    FP8-E4M3 cache, the MLA instances' fp8 ones. Phase 33 (``dtype``
    "float16"): the same at 14 layers in fp16 on an fp16 cache, every
    launch of the three kernels on its fp16 instance (``dtype_launches``),
    every logprob finite. Logs the KV pool's bytes a token."""
    from aphrodite_tpu_torch.ops.grouped_matmul import grouped_matmul
    phase = ("phase 33" if dtype == "float16" else
             "phase 24" if kv == "auto" else "phase 27")
    hf = (DEEPSEEK_V2_LITE if phase == "phase 27" else
          dict(DEEPSEEK_V2_LITE, num_hidden_layers=DEEPSEEK_DEPTH))
    L, steps = hf["num_hidden_layers"], 63
    moe = L - hf["first_k_dense_replace"]
    exact = {"ragged_paged_attention": L, "ragged mla": L,
             "window_decode_attention": L * steps, "window mla": L * steps,
             "grouped_matmul": 2 * moe}
    exact.update({f"{k} {i}": 0 for k in ("ragged", "window")
                  for i in ("tensor_cores", "scalar")})
    counted = {**attention_kernels(), **instance_counts(),
               "grouped_matmul": grouped_matmul}
    # Launches by the activations' dtype: all of them in ``dtype``.
    for k, fn in (("ragged", counted["ragged_paged_attention"]),
                  ("window", counted["window_decode_attention"]),
                  ("grouped", grouped_matmul)):
        for dt in ("bfloat16", "float16"):
            counted[f"{k} {dt}"] = InstanceCount(fn, dt, "dtype_launches")
            exact[f"{k} {dt}"] = (exact[f"{k} mla"] if k != "grouped"
                                  else exact["grouped_matmul"]) \
                if dt == dtype else 0
    # Ragged launches by library: all on the MLA instances without options
    # (DeepSeek's calls carry neither image spans nor ALiBi).
    own = "mla_attention_f16" if dtype == "float16" else "mla_attention"
    for lib in ("mla_attention", "mla_attention_f16", "mla_opts",
                "mla_opts_f16"):
        counted[f"ragged {lib}"] = InstanceCount(
            counted["ragged_paged_attention"], lib, "source_launches")
        exact[f"ragged {lib}"] = L if lib == own else 0
    log(f"# {phase}: launches a run, reckoned: {exact}")
    counts, llm, walls = serve_workload(
        phase, "deepseek-v2-lite-dummy", hf, counted, exact=exact,
        kv_cache_dtype=kv, dtype=dtype, logprobs=dtype == "float16")
    DS_WALLS[phase] = walls
    if phase == "phase 33" and "phase 24" in DS_WALLS:
        log(f"# {phase}: walls in fp16 against phase 24's (bf16, 14 "
            f"layers) in this call: " + ", ".join(
                f"{k} {walls[k]:.3f} / {DS_WALLS['phase 24'][k]:.3f} s/run "
                f"({walls[k] / DS_WALLS['phase 24'][k]:.3f})"
                for k in walls))
    pool = llm.engine.core.worker.runner.kv_cache
    L_, pages, _, kvh, page, hd = pool.shape
    log(f"# {phase}: KV pool {pool.dtype} {tuple(pool.shape)}: "
        f"{pool.numel() * pool.element_size() / 2**30:.2f} GiB, "
        f"{L_ * 2 * kvh * hd * pool.element_size()} bytes a token, "
        f"{pages * page} tokens")
    del llm, pool
    return counts


# Phase 25: tiny Gemma-3 multimodal and PaliGemma (Gemma and Gemma-2
# bases) in config.json spellings, nested text and vision configs, which
# the port reads without ``transformers``.
_MM_TINY_VISION = dict(hidden_size=32, num_hidden_layers=2,
                       num_attention_heads=2, intermediate_size=64,
                       image_size=16, hidden_act="gelu_pytorch_tanh",
                       layer_norm_eps=1e-6)
_MM_TINY_TEXT = dict(vocab_size=256, hidden_size=64, num_hidden_layers=3,
                     num_attention_heads=4, num_key_value_heads=2,
                     head_dim=32, intermediate_size=128,
                     max_position_embeddings=512,
                     hidden_activation="gelu_pytorch_tanh")
MM_IMG, MM_BOI, MM_EOI = 255, 253, 254
MM_TINY = {
    "gemma3": dict(
        architectures=["Gemma3ForConditionalGeneration"],
        image_token_index=MM_IMG, boi_token_index=MM_BOI,
        eoi_token_index=MM_EOI, mm_tokens_per_image=4,
        vision_config=dict(_MM_TINY_VISION, patch_size=4),
        text_config=dict(
            _MM_TINY_TEXT, model_type="gemma3_text", sliding_window=8,
            query_pre_attn_scalar=32, rope_theta=1e6,
            rope_local_base_freq=1e4,
            rope_scaling={"rope_type": "linear", "factor": 8.0},
            layer_types=["sliding_attention", "sliding_attention",
                         "full_attention"])),
    "paligemma": dict(
        architectures=["PaliGemmaForConditionalGeneration"],
        image_token_index=MM_IMG, projection_dim=64,
        vision_config=dict(_MM_TINY_VISION, patch_size=8),
        text_config=dict(_MM_TINY_TEXT, model_type="gemma")),
    "paligemma2": dict(
        architectures=["PaliGemmaForConditionalGeneration"],
        image_token_index=MM_IMG, projection_dim=64,
        vision_config=dict(_MM_TINY_VISION, patch_size=8),
        text_config=dict(
            _MM_TINY_TEXT, model_type="gemma2", sliding_window=8,
            query_pre_attn_scalar=24, attn_logit_softcapping=50.0,
            final_logit_softcapping=30.0,
            layer_types=["sliding_attention", "full_attention",
                         "sliding_attention"])),
}


def redraw_mm(model, seed: int) -> None:
    """A vision model's weights redrawn from a seeded generator on their
    device: the text decoder as ``redraw_gemma`` does; the tower's
    LayerNorm weights near 1, its biases and positions small, its weights
    [.., fan_in, fan_out] at fan-in scale; the projector's weights at
    fan-in scale, its norm (stored as w - 1) near 0."""
    import torch
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            r = torch.randn(p.shape, generator=g, device=dev)
            if name.startswith(("vision.", "projector.")) \
                    and "norm" not in leaf:
                if "ln" in leaf and leaf.endswith("_w"):
                    new = 1 + 0.1 * r
                elif p.dim() == 1 or leaf.startswith("b") \
                        or leaf.endswith("_b") or leaf == "pos":
                    new = 0.1 * r
                else:  # [.., fan_in, fan_out]
                    new = r / p.shape[-2] ** 0.5
            elif "norm" in name:
                new = 0.1 * r
            elif name == "embed":
                new = r / (4 * p.shape[1] ** 0.5)
            else:  # [fan_in, fan_out] projections
                new = r / p.shape[0] ** 0.5
            p.copy_(new.to(p.dtype))


def mm_prompts(arch: str, seed: int, size: int) -> list:
    """Phase 25's batch: one image after 12 text tokens (its span crosses
    the 16-token chunk edge), two images, and a text-only row."""
    rng = np.random.RandomState(seed)
    words = lambda n: rng.randint(10, 250, size=n).tolist()  # noqa: E731
    img = ([MM_BOI, MM_IMG, MM_EOI] if arch == "gemma3" else [MM_IMG])
    imgs = rng.randint(0, 256, size=(3, size, size, 3)).astype(np.uint8)
    return [
        {"prompt_token_ids": [2] + words(12) + img + words(5),
         "multi_modal_data": {"image": imgs[0]}},
        {"prompt_token_ids": [2] + words(3) + img + words(2) + img
         + words(4), "multi_modal_data": {"image": [imgs[1], imgs[2]]}},
        [2] + words(17)]


def mm_parity() -> dict:
    """Phase 25: fp32 greedy tokens through the port on the card and on the
    CPU with the same weights for ``MM_TINY``: one image, two images and a
    text row in one batch, a 16-token budget that cuts a prompt inside an
    image span, 16-step decode windows. On the card every ragged launch of
    Gemma-3 carries the image spans, none of PaliGemma's does. Returns the
    card runs' launches, all and with spans."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention as rpa)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = [SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True)
              for n in (20, 12, 24)]
    total = {"ragged_paged_attention": 0, "ragged spans": 0}
    for arch, cfg in MM_TINY.items():
        kw = dict(hf_config=cfg, tokenizer="unused", dtype="float32",
                  block_size=16, num_kv_blocks=128, max_num_seqs=4,
                  max_num_batched_tokens=16, max_model_len=256,
                  decode_window=16)
        cpu = LLM("tiny-vlm", device="cpu", **kw)
        redraw_mm(cpu.engine.core.worker.model, 7)
        gpu = LLM("tiny-vlm", device="cuda", **kw)
        gpu.engine.core.worker.load_params(
            cpu.engine.core.worker.model.state_dict())
        prompts = mm_prompts(arch, 8, 16)
        a = [o.outputs[0].token_ids for o in cpu.generate(prompts, params)]
        rpa.launches = rpa.span_launches = 0
        b = [o.outputs[0].token_ids for o in gpu.generate(prompts, params)]
        if a != b:
            raise AssertionError(f"phase 25 {arch}: cuda vs cpu greedy "
                                 f"tokens differ:\n{a}\n{b}")
        if len({t for x in a for t in x}) <= 10:
            raise AssertionError(f"phase 25 {arch}: the tokens hardly "
                                 f"vary: {a}")
        want = rpa.launches if arch == "gemma3" else 0
        if rpa.launches <= 0 or rpa.span_launches != want:
            raise AssertionError(f"phase 25 {arch}: ragged launches "
                                 f"{rpa.launches}, with spans "
                                 f"{rpa.span_launches}, want {want}")
        total["ragged_paged_attention"] += rpa.launches
        total["ragged spans"] += rpa.span_launches
        log(f"# phase 25: {arch}: cuda == cpu greedy tokens for "
            f"{len(prompts)} prompts (one image, two images, a text row; "
            f"16-token chunks, one cutting an image's tokens); ragged "
            f"launches {rpa.launches}, with spans {rpa.span_launches}")
        del cpu, gpu
    return total


GEMMA3_4B_IT = dict(  # google/gemma-3-4b-it config.json
    architectures=["Gemma3ForConditionalGeneration"], model_type="gemma3",
    image_token_index=262144, boi_token_index=255999,
    eoi_token_index=256000, mm_tokens_per_image=256,
    text_config=dict(
        model_type="gemma3_text", vocab_size=262208, hidden_size=2560,
        num_hidden_layers=34, num_attention_heads=8, num_key_value_heads=4,
        head_dim=256, intermediate_size=10240,
        hidden_activation="gelu_pytorch_tanh", query_pre_attn_scalar=256,
        rms_norm_eps=1e-6, rope_theta=1000000.0,
        rope_scaling={"rope_type": "linear", "factor": 8.0},
        rope_local_base_freq=10000.0, sliding_window=1024,
        # sliding_window_pattern 6: every sixth layer global
        layer_types=["full_attention" if (i + 1) % 6 == 0
                     else "sliding_attention" for i in range(34)],
        attn_logit_softcapping=None, final_logit_softcapping=None,
        max_position_embeddings=131072, tie_word_embeddings=True),
    vision_config=dict(
        model_type="siglip_vision_model", hidden_size=1152,
        num_hidden_layers=27, num_attention_heads=16,
        intermediate_size=4304, image_size=896, patch_size=14,
        hidden_act="gelu_pytorch_tanh", layer_norm_eps=1e-6))


def g3_prompts(seed: int, images_seed: int) -> list:
    """Phase 26's 32 prompts: bos, 99 text tokens, boi, the image
    placeholder, eoi, 154 text tokens (512 once the placeholder is
    expanded: the span at ``G3_SPAN``), each with a seeded 896 x 896 uint8
    image (``images_seed``: another seed gives other images, the same
    ids)."""
    tc = GEMMA3_4B_IT
    S = tc["vision_config"]["image_size"]
    rng, irng = (np.random.RandomState(seed),
                 np.random.RandomState(images_seed))
    out = []
    for _ in range(32):
        ids = ([2] + rng.randint(10, 200000, size=99).tolist()
               + [tc["boi_token_index"], tc["image_token_index"],
                  tc["eoi_token_index"]]
               + rng.randint(10, 200000, size=154).tolist())
        img = irng.randint(0, 256, size=(S, S, 3)).astype(np.uint8)
        out.append({"prompt_token_ids": ids,
                    "multi_modal_data": {"image": img}})
    return out


def gemma3_at_depth(layers: int) -> dict:
    """``GEMMA3_4B_IT`` with its text decoder cut to its first ``layers``
    layers (the published pattern of five sliding layers to one global
    kept); the tower whole."""
    text = GEMMA3_4B_IT["text_config"]
    return dict(GEMMA3_4B_IT, text_config=dict(
        text, num_hidden_layers=layers,
        layer_types=text["layer_types"][:layers]))


# Phases 26's and 35's text layers: half the published 34 (every layer
# runs the same kernels).
GEMMA3_HALF_DEPTH = 17
G3_WALLS: dict = {}


def main_path_gemma3_mm(dtype: str = "bfloat16",
                        layers: int | None = None) -> dict:
    """Phase 26, the vision slice's main path: Gemma-3-4B-it bf16 at full
    width and ``layers`` of its 34 text layers (all of them where None)
    with one image a request (see the module docstring); phase 35 (``dtype``
    "float16"): the same in fp16, every ragged launch on the
    fp16 span instances (``csrc/ragged_spans_f16.cu``) and every token's
    logprob finite. Returns a cold run's launches."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.decode_paged_attention import (
        decode_paged_attention)
    from aphrodite_tpu_torch.worker.encoder_cache import EncoderCache
    f16 = dtype == "float16"
    phase = "phase 35" if f16 else "phase 26"
    hf = gemma3_at_depth(layers) if layers else GEMMA3_4B_IT
    L = hf["text_config"]["num_hidden_layers"]
    kernels = {"decode_paged_attention": decode_paged_attention,
               **attention_kernels()}
    rpa = kernels["ragged_paged_attention"]
    lib = "ragged_spans_f16" if f16 else "ragged_spans"
    counted = {**kernels, "ragged spans": SpanCount(rpa),
               "ragged tensor_cores": InstanceCount(rpa, "tensor_cores"),
               f"ragged {lib}": InstanceCount(rpa, lib, "source_launches"),
               **{f"ragged {dt}": InstanceCount(rpa, dt, "dtype_launches")
                  for dt in ("bfloat16", "float16")}}
    exact = {"ragged_paged_attention": L, "ragged spans": L,
             "ragged tensor_cores": L, f"ragged {lib}": L,
             f"ragged {dtype}": L,
             f"ragged {'bfloat16' if f16 else 'float16'}": 0,
             "decode_paged_attention": L * 63,
             "window_decode_attention": 0}
    log(f"# {phase}: launches a run, reckoned: {exact}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = LLM("gemma-3-4b-it-dummy", hf_config=hf,
              tokenizer="unused", dtype=dtype, load_format="dummy",
              block_size=64, max_num_seqs=32, max_num_batched_tokens=16384,
              max_model_len=704, device="cuda")
    model = llm.engine.core.worker.model
    redraw_mm(model, 26)
    torch.cuda.synchronize()
    log(f"# {phase}: engine init and redraw {time.perf_counter() - t0:.2f} "
        f"s, weights + KV {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"(weights {sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30:.2f} GiB, "
        f"of which the tower {sum(p.numel() * p.element_size() for p in model.vision.parameters()) / 2**30:.2f})")
    runner = llm.engine.core.worker.runner
    encode = model.encode_images
    images = [0]

    def traced_encode(pv):
        images[0] += pv.shape[0]
        with torch.profiler.record_function("vision"):
            return encode(pv)
    model.encode_images = traced_encode
    # The host's time in the processor: the images' preprocessing, the
    # placeholders' expansion and the content hash, a request at a time.
    processor = llm.engine.processor
    process = processor.process
    host = [0.0]

    def timed_process(*a, **kw):
        t = time.perf_counter()
        try:
            return process(*a, **kw)
        finally:
            host[0] += time.perf_counter() - t
    processor.process = timed_process
    prompts = g3_prompts(26, 27)
    others = g3_prompts(26, 28)
    params = SamplingParams(temperature=0.0, max_tokens=64, ignore_eos=True,
                            logprobs=1 if f16 else None)
    V = GEMMA3_4B_IT["text_config"]["vocab_size"]

    def one_run(batch=prompts, cold=True):
        if cold:
            if not llm.engine.reset_prefix_cache():
                raise AssertionError("reset_prefix_cache refused")
            runner.encoder_cache = EncoderCache()
        for fn in counted.values():
            fn.launches = 0
        images[0] = 0
        host[0] = 0.0
        t = time.perf_counter()
        outs = llm.generate(batch, params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        toks = [o.outputs[0].token_ids for o in outs]
        if sum(len(x) for x in toks) != 32 * 64:
            raise AssertionError(f"{phase}: expected 2048 tokens")
        if not all(0 <= t < V for x in toks for t in x):
            raise AssertionError(f"{phase}: token id out of the vocabulary")
        if f16:
            finite_logprobs(phase, outs)
        one_run.toks = toks
        one_run.cached = sum(o.num_cached_tokens for o in outs)
        one_run.counts = {k: fn.launches for k, fn in counted.items()}
        for k, want in exact.items():
            if one_run.counts[k] != want:
                raise AssertionError(f"{phase}: {k}: {one_run.counts[k]} "
                                     f"launches in a run, want {want}")
        return dt

    log(f"# {phase}: warm-up run {one_run():.3f} s, images encoded "
        f"{images[0]}")
    walls = {"cold": [], "warm": []}
    for label in ("cold", "cold", "warm", "warm"):
        walls[label].append(one_run(cold=label == "cold"))
        want = 32 if label == "cold" else 0
        if images[0] != want:
            raise AssertionError(f"{phase}: {images[0]} images encoded in a "
                                 f"{label} run, want {want}")
        if (one_run.cached == 0) != (label == "cold"):
            raise AssertionError(f"{phase}: {one_run.cached} cached prompt "
                                 f"tokens in a {label} run")
        log(f"# {phase}: {label} run: {walls[label][-1]:.3f} s (of which "
            f"the processor's host time {host[0]:.3f} s), cached prompt "
            f"tokens {one_run.cached}, images encoded {images[0]}, launches "
            f"{one_run.counts}")
    if not f16:  # phase 35 leaves the images' content hash to phase 26
        warm_toks = one_run.toks
        dt = one_run(others, cold=False)
        if one_run.cached != 0 or images[0] != 32:
            raise AssertionError(f"{phase}: the same ids with other images "
                                 f"hit {one_run.cached} cached tokens, "
                                 f"encoded {images[0]} images")
        differ = sum(a != b for a, b in zip(one_run.toks, warm_toks))
        if not differ:
            raise AssertionError(f"{phase}: other images gave the same "
                                 "tokens")
        log(f"# {phase}: the same ids with other images: {dt:.3f} s, "
            f"cached prompt tokens 0, images encoded 32, {differ} of 32 "
            "requests' tokens differ")
    for label, ts in walls.items():
        s = float(np.mean(ts))
        log(f"# {phase}: {label} {s:.3f} s/run (runs {ts}); "
            f"{32 * 64 / s:.0f} decode tok/s; {32 * 576 / s:.0f} tok/s "
            "(prefill+decode)")
    G3_WALLS[phase] = {k: float(np.mean(v)) for k, v in walls.items()}
    if f16 and "phase 26" in G3_WALLS:
        log(f"# {phase}: walls in fp16 at {L} layers against phase 26's "
            f"(bf16 at {GEMMA3_HALF_DEPTH} layers) in this call: "
            + ", ".join(f"{k} {G3_WALLS[phase][k]:.3f} / "
                        f"{G3_WALLS['phase 26'][k]:.3f} s/run"
                        for k in walls))
    log(f"# {phase}: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_run(one_run, phase, spans=("vision",))
    counts = dict(one_run.counts)
    model.encode_images, processor.process = encode, process
    del llm, model, runner, processor
    gc.collect()
    torch.cuda.empty_cache()
    return counts


class SpanCount:
    """The ragged wrapper's launches with image spans (``span_launches``),
    counted as a kernel of its own."""

    def __init__(self, fn) -> None:
        self.fn = fn

    @property
    def launches(self) -> int:
        return self.fn.span_launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.fn.span_launches = value


# ----------------------------------------------------------- the fp16 slice
LLAMA2_7B = dict(  # meta-llama/Llama-2-7b-hf config.json ("float16")
    vocab_size=32000, hidden_size=4096, num_hidden_layers=32,
    num_attention_heads=32, num_key_value_heads=32, intermediate_size=11008,
    hidden_act="silu", rms_norm_eps=1e-5, rope_theta=10000.0,
    max_position_embeddings=4096, tie_word_embeddings=False,
    architectures=["LlamaForCausalLM"])
# Phase 29's layers: half the published 32 (every layer runs the same
# kernels), to keep the script inside its time limit.
LLAMA2_7B_HALF = dict(LLAMA2_7B, num_hidden_layers=16)
F16_PATH = "llama-2-7b-fp16"
F16_SHARED_PATH = "llama-2-7b-fp16-shared-prompt"
# Phase 29's prefill wave and decode window: 32 x 512, 32 / 32 heads of 128.
F16_WAVE = dict(nq=32, kvh=32, ctx=[512] * 32, qlen=[512] * 32,
                paged=[512] * 32)
# Phase 29's shared-prompt run: 32 requests, a 1024-token prefix and a
# 64-token suffix each (paged lengths 1088), 32 / 32 heads.
F16_SHARED = dict(R=32, NQ=32, KVH=32, plen=CASCADE_S + 64)
# The decode kernel with ALiBi at 32 heads of 128 (a 7B ALiBi model's
# step: BLOOM-7B1's heads, the family that decodes on this kernel).
F16_DECODE_CASES = {
    "alibi-32x128": (32, 32, 128, [513 + (37 * r) % 64 for r in range(32)],
                     dict(alibi=True)),
}
# Phase 28: tiny fp16 models with heads of 64, so that the fp16 tensor-core
# instances run (the ALiBi families of phase 21 have heads of 16).
F16_TINY_LLAMA = dict(
    vocab_size=512, hidden_size=256, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=512,
    max_position_embeddings=1024, rms_norm_eps=1e-5,
    tie_word_embeddings=False, architectures=["LlamaForCausalLM"])
F16_TINY_BLOOM = dict(architectures=["BloomForCausalLM"], model_type="bloom",
                      hidden_size=256, n_head=4, n_layer=2, vocab_size=512)
# Phase 28's bound on the chosen tokens' logprobs, card against CPU where
# the tokens agree: the card rounds P to fp16 and sums its GEMMs in
# another order, each a few fp16 ulps (2^-11) of a logit; a tenth of a nat.
F16_LOGPROB_TOL = 0.1
# Phase 28's runs: (model, kv_cache_dtype).
F16_PARITY = {"llama/auto": ("llama", "auto"),
              "llama/fp8_e4m3": ("llama", "fp8_e4m3"),
              "llama/fp8_e5m2": ("llama", "fp8_e5m2"),
              "bloom/auto": ("bloom", "auto")}


def finite_logprobs(what: str, outs) -> None:
    """Every generated token's logprob in ``outs`` finite."""
    bad = [(o.request_id, i) for o in outs
           for i, (t, lp) in enumerate(zip(o.outputs[0].token_ids,
                                           o.outputs[0].logprobs or []))
           if not math.isfinite(lp[t].logprob)]
    if bad or any(o.outputs[0].logprobs is None for o in outs):
        raise AssertionError(f"{what}: logprobs missing or not finite at "
                             f"(request, step) {bad[:10]}")


def fp16_checks(gen, results: dict) -> None:
    """Phase 2 for the fp16 slice: each fp16 tensor-core instance against
    its plain version at phase 29's shapes on fp16, e4m3 and e5m2 caches,
    timed beside its bf16 self at the same shapes and cache in the same
    call: the ragged kernel at the wave (and with ALiBi, the slopes of 32
    heads, timed on the fp16 cache and checked on the fp8 ones), the window
    at sub-step 24, the decode kernel with ALiBi at 32 heads of 128
    (``F16_DECODE_CASES``), the shared pass over a 1024-token prefix at R
    32 and the window from its state (``F16_SHARED``); then the ragged and
    window kernels' mask cases and two ALiBi cases in fp16, untimed."""
    f16, b16 = "float16", "bfloat16"
    for kv in (None, *KV_FP8):
        for name, fn, geom, path in (
                ("ragged_paged_attention", check_ragged, F16_WAVE, F16_PATH),
                ("ragged_paged_attention", check_ragged,
                 dict(F16_WAVE, alibi=True), f"{F16_PATH}-alibi"),
                ("window_decode_attention", check_window, F16_WAVE,
                 F16_PATH)):
            if geom.get("alibi") and kv is not None:
                err = fn(gen, f16, geom, timed=False, kv=kv)
                log(f"# phase 2: {name} {f16}{kv_label(kv)} with ALiBi at "
                    f"{F16_PATH} shapes: max_abs_err {err:.3g} (tol "
                    f"{TOL[f16]} x max(1, max|ref row|))")
                continue
            r, s = fn(gen, f16, geom, kv=kv), fn(gen, b16, geom, kv=kv)
            results[(name, path, f16, kv)] = r
            log(f"# phase 2: {name} {f16}{kv_label(kv)} at {path} shapes: "
                f"max_abs_err {r['max_abs_err']:.3g} (tol "
                f"{tol_text(name, f16)}); kernel {r['ms']:.4f} ms (device "
                f"{r['device_ms']:.4f} ms), its bf16 self {s['ms']:.4f} ms "
                f"(device {s['device_ms']:.4f} ms, fp16 / bf16 "
                f"{r['device_ms'] / s['device_ms']:.3f}); plain "
                f"{r['plain_ms']:.4f} ms, sdpa in fp16 on K/V upcast "
                f"{r['library_ms']:.4f} ms (device "
                f"{r['library_device_ms']:.4f} ms), bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        case = "alibi-32x128"
        r, s = (check_decode(gen, dt, case, kv=kv) for dt in (f16, b16))
        results[("decode_paged_attention", case, f16, kv)] = r
        log(f"# phase 2: decode_paged_attention {case} {f16}{kv_label(kv)}: "
            f"device {r['device_ms']:.4f} ms against its bf16 self "
            f"{s['device_ms']:.4f} ms (fp16 / bf16 "
            f"{r['device_ms'] / s['device_ms']:.3f})")
        (spa, win), (spa_b, win_b) = (
            check_cascade(gen, dt, kv=kv, **F16_SHARED) for dt in (f16, b16))
        results[("shared_prefix_attention", F16_SHARED_PATH, f16, kv)] = spa
        results[("window_decode_attention", F16_SHARED_PATH, f16, kv)] = win
        log(f"# phase 2: fp16{kv_label(kv)} at {F16_SHARED_PATH} against "
            f"bf16: shared_prefix_attention device {spa['device_ms']:.4f} "
            f"ms / {spa_b['device_ms']:.4f} ms, window from its state "
            f"{win['device_ms']:.4f} ms / {win_b['device_ms']:.4f} ms")
    for cases, fn, name in (
            (RAGGED_MASK_CASES, check_ragged, "ragged_paged_attention"),
            (WINDOW_MASK_CASES, check_window, "window_decode_attention")):
        for case, geom in cases.items():
            err = fn(gen, f16, geom, timed=False)
            log(f"# phase 2: {name} {f16} {case}: max_abs_err {err:.3g} "
                f"(tol {tol_text(name, f16)})")
    for case in ("hd64-page16-mid-page", "group8-chunks-softcap30"):
        err = check_ragged(gen, f16, ALIBI_RAGGED_CASES[case], timed=False)
        log(f"# phase 2: ragged_paged_attention {f16} ALiBi {case}: "
            f"max_abs_err {err:.3g} (tol {TOL[f16]} x max(1, max|ref row|))")


class CallSpy:
    """The attention backend's four kernel wrappers, patched to count every
    call (on either device) by wrapper: the reckoning of a card run's
    launches is its CPU twin's calls, since greedy runs with
    ``ignore_eos`` schedule the same forwards whatever their tokens."""

    NAMES = ("ragged_paged_attention", "window_decode_attention",
             "decode_paged_attention", "shared_prefix_attention")

    def __init__(self) -> None:
        from aphrodite_tpu_torch.attention import backend
        self.backend = backend
        self.fns = {n: getattr(backend, n) for n in self.NAMES}
        self.calls = dict.fromkeys(self.NAMES, 0)

    def __enter__(self):
        for n, fn in self.fns.items():
            def spy(*a, _n=n, _fn=fn, **kw):
                self.calls[_n] += 1
                return _fn(*a, **kw)
            setattr(self.backend, n, spy)
        return self

    def __exit__(self, *exc):
        for n, fn in self.fns.items():
            setattr(self.backend, n, fn)


def fp16_parity() -> dict:
    """Phase 28: fp16 greedy runs through the port on the card and on the
    CPU from one seed (the CPU's weights loaded on the card), each model
    with heads of 64 (the fp16 tensor-core instances): a tiny Llama on an
    fp16, an e4m3 and an e5m2 cache (a 128-token batch budget over 20
    prompts that share a 96-token prefix on 16-token pages, one of them
    300 tokens: chunked prefill, decode windows, the cascade's shared pass
    and the window from its state) and a tiny BLOOM (ALiBi; a 16-token
    budget, 8-step decode windows on the decode kernel). Tokens equal but
    where the runs part at a gap below ``GAP`` (``same_tokens``); the
    chosen tokens' logprobs within ``F16_LOGPROB_TOL`` where they agree;
    every kernel's card launches exactly its CPU twin's calls
    (``CallSpy``), all on the tensor-core instances. Returns each kernel's
    launches, keyed by (kernel, run)."""
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.cascade_attention import (
        shared_prefix_attention)
    from aphrodite_tpu_torch.ops.decode_paged_attention import (
        decode_paged_attention)
    kernels = {**attention_kernels(),
               "decode_paged_attention": decode_paged_attention,
               "shared_prefix_attention": shared_prefix_attention}
    rng = np.random.RandomState(28)
    shared = rng.randint(1, 500, size=96).tolist()
    prompts = {"llama": [shared + rng.randint(1, 500, size=n).tolist()
                         for n in [1 + (7 * i) % 23 for i in range(19)]
                         + [204]],
               "bloom": [rng.randint(1, 500, size=n).tolist()
                         for n in (5, 40, 17, 33, 70)]}
    params = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)
    launches = {}
    for run, (model, kv) in F16_PARITY.items():
        if model == "llama":
            kw = dict(hf_config=F16_TINY_LLAMA, block_size=16,
                      num_kv_blocks=512, max_num_seqs=20,
                      max_num_batched_tokens=128, max_model_len=512,
                      decode_window=16)
        else:
            kw = dict(hf_config=F16_TINY_BLOOM, block_size=16,
                      num_kv_blocks=128, max_num_seqs=4,
                      max_num_batched_tokens=16, max_model_len=256,
                      decode_window=8)
        kw.update(tokenizer="unused", dtype="float16", kv_cache_dtype=kv)
        cpu = LLM(f"tiny-{model}-fp16", device="cpu", **kw)
        if model == "bloom":
            redraw_flexible(cpu.engine.core.worker.model, 28)
        gpu = LLM(f"tiny-{model}-fp16", device="cuda", **kw)
        gpu.engine.core.worker.load_params(
            cpu.engine.core.worker.model.state_dict())
        ps = prompts[model]
        with CallSpy() as want:
            a = traced(cpu, ps, params)
        for fn in kernels.values():
            fn.launches = 0
        for fn in attention_kernels().values():
            fn.instance_launches = dict.fromkeys(fn.instance_launches, 0)
        with CallSpy() as calls:
            b = traced(gpu, ps, params)
        got = {k: fn.launches for k, fn in kernels.items()}
        tc = {k: fn.instance_launches["tensor_cores"]
              for k, fn in attention_kernels().items()}
        launches.update({(k, run): v for k, v in got.items()})
        need = (("ragged_paged_attention", "window_decode_attention",
                 "shared_prefix_attention") if model == "llama"
                else ("ragged_paged_attention", "decode_paged_attention"))
        if got != want.calls or got != calls.calls or any(
                got[k] <= 0 for k in need) or any(
                tc[k] != got[k] for k in tc):
            raise AssertionError(
                f"phase 28 {run}: launches {got}, tensor-core instances "
                f"{tc}; the card's calls {calls.calls}, the CPU's "
                f"{want.calls}")
        if len({t for x in a[0] for t in x}) <= 10:
            raise AssertionError(f"phase 28 {run}: the tokens hardly vary: "
                                 f"{a[0]}")
        found = same_tokens(f"phase 28 {run}", cpu, gpu, ps, a, b)
        gaps = [abs(float(la[i][t]) - float(lb[i][t]))
                for ta, tb, la, lb in zip(a[0], b[0], a[1], b[1])
                for i, t in enumerate(ta) if ta[:i + 1] == tb[:i + 1]]
        worst = max(gaps)
        if not worst <= F16_LOGPROB_TOL:
            raise AssertionError(f"phase 28 {run}: chosen logprobs card vs "
                                 f"CPU up to {worst:.4g} > {F16_LOGPROB_TOL}")
        log(f"# phase 28: {run}: cuda == cpu greedy fp16 tokens for "
            f"{len(ps)} prompts x 24 but at partings (request, step, cpu "
            f"token, card token, gap < {GAP}) {found}; chosen logprobs "
            f"within {worst:.4g} (tol {F16_LOGPROB_TOL}) over {len(gaps)} "
            f"agreeing tokens; launches {got} (= the CPU's calls), all on "
            f"the tensor-core instances")
        del cpu, gpu
    return launches


def main_path_llama2_fp16() -> tuple[dict, dict]:
    """Phase 29: Llama-2-7B (``meta-llama/Llama-2-7b-hf``, published in
    fp16) at full width and 16 of its 32 layers (``LLAMA2_7B_HALF``) in
    fp16, seeded dummy weights: phase 6's traffic, cold and warm (ragged
    16 and window 1008 a run, all on the fp16 tensor-core instances; every
    logprob finite), then on the same engine 32 requests that share a
    seeded 1024-token system prompt, each with a 64-token suffix new in
    every run and 64 new tokens: a warm-up caches the prefix, then each of
    2 runs prefills one 2048-token wave and decodes one 63-step window
    from the shared pass's state (ragged 16, shared pass 1008, window 1008,
    decode 0; 32768 cached prompt tokens a run). Logs the KV bytes a
    token. Returns the launches of the last cold run of phase 6's traffic and of the last shared-prompt
    run."""
    import torch
    from aphrodite_tpu_torch import SamplingParams
    from aphrodite_tpu_torch.ops.cascade_attention import (
        shared_prefix_attention)
    from aphrodite_tpu_torch.ops.decode_paged_attention import (
        decode_paged_attention)
    phase = "phase 29"
    L, steps = LLAMA2_7B_HALF["num_hidden_layers"], 63
    R, S, n_suf, n_dec = 32, CASCADE_S, 64, 64
    kernels = {**attention_kernels(), **instance_counts(),
               "decode_paged_attention": decode_paged_attention,
               "shared_prefix_attention": shared_prefix_attention}
    exact = {"ragged_paged_attention": L, "ragged tensor_cores": L,
             "window_decode_attention": L * steps,
             "window tensor_cores": L * steps,
             "decode_paged_attention": 0, "shared_prefix_attention": 0,
             **{f"{k} {i}": 0 for k in ("ragged", "window")
                for i in ("mla", "scalar")}}
    log(f"# {phase}: launches a run, reckoned: {exact}")
    counts, llm, _ = serve_workload(
        phase, "llama-2-7b-fp16-dummy", LLAMA2_7B_HALF, kernels,
        exact=exact,
        dtype="float16", max_model_len=S + n_suf + n_dec, logprobs=True)
    pool = llm.engine.core.worker.runner.kv_cache
    L_, pages, _, kvh, page, hd = pool.shape
    log(f"# {phase}: KV pool {pool.dtype} {tuple(pool.shape)}: "
        f"{L_ * 2 * kvh * hd * pool.element_size()} bytes a token, "
        f"{pages * page} tokens")
    exact = dict(exact, shared_prefix_attention=L * steps)
    log(f"# {phase}: the shared-prompt run's launches, reckoned: {exact}")
    top = LLAMA2_7B["vocab_size"] - 10
    prefix = np.random.RandomState(29).randint(10, top, size=S).tolist()
    params = SamplingParams(temperature=0.0, max_tokens=n_dec,
                            ignore_eos=True, logprobs=1)
    runs = [0]

    def one_run() -> float:
        rng = np.random.RandomState(2900 + runs[0])
        runs[0] += 1
        prompts = [prefix + rng.randint(10, top, size=n_suf).tolist()
                   for _ in range(R)]
        for fn in kernels.values():
            fn.launches = 0
        t = time.perf_counter()
        outs = llm.generate(prompts, params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if sum(len(o.outputs[0].token_ids) for o in outs) != R * n_dec:
            raise AssertionError(f"expected {R * n_dec} tokens")
        finite_logprobs(phase, outs)
        one_run.cached = sum(o.num_cached_tokens for o in outs)
        one_run.counts = {k: fn.launches for k, fn in kernels.items()}
        return dt

    def check(label: str) -> None:
        if one_run.counts != exact or one_run.cached != R * S:
            raise AssertionError(
                f"{phase} {label}: launches {one_run.counts}, cached prompt "
                f"tokens {one_run.cached}; want {exact} and {R * S}")

    log(f"# {phase}: shared-prompt warm-up run {one_run():.3f} s, cached "
        f"prompt tokens {one_run.cached}, launches {one_run.counts}")
    times = []
    for i in range(SERVE_RUNS):
        times.append(one_run())
        log(f"# {phase}: shared-prompt run {i}: {times[-1]:.3f} s, cached "
            f"prompt tokens {one_run.cached}, launches {one_run.counts}")
        check(f"shared-prompt run {i}")
    s_run = float(np.mean(times))
    log(f"# {phase}: shared prompt {s_run:.3f} s/run (runs {times}); "
        f"{R * n_dec / s_run:.0f} decode tok/s")
    profile_run(one_run, f"{phase} shared prompt")
    check("profiled shared-prompt run")
    shared = one_run.counts
    del llm, pool
    return counts, shared


# ------------------------------------------- the fp16 decode GEMM slice
# Each layout's wrapper in ops/quant_matmul.py.
LAYOUT_WRAPPER = {"int4": "w4a16_int4_matmul", "packed": "w4a16_packed_matmul",
                  "uint4": "w4a16_matmul", "w8": "w8a16_matmul",
                  "fp8": "fp8_matmul"}
F16_GEMM_PATH = "llama-3.1-8b-awq-fp16"       # phase 31
F16_GEMM_PARITY_PATH = "tiny-fp16-quant-parity"  # phase 30
# Phase 2's timed fp16 GEMMs, each beside its bf16 self on the same
# weights: (layout, a layer's shapes, M, with W8A8 row scales). The
# kernels line takes packed at M = 32 (phase 31's decode batch), int4 at
# M = 128 (phase 14's), the others at M = 32 (phases 15, 16 and 18's).
F16_GEMM_TIMED = (("packed", "LLAMA8B", 32, False),
                  ("packed", "LLAMA8B", 128, False),
                  ("int4", "LLAMA8B", 128, False),
                  ("int4", "LLAMA8B", 32, False),
                  ("uint4", "QWEN7B", 32, False),
                  ("w8", "LLAMA8B", 32, False),
                  ("fp8", "LLAMA8B", 32, False),
                  ("fp8", "LLAMA8B", 32, True))
F16_GEMM_ROW = {"packed": 32, "int4": 128, "uint4": 32, "w8": 32, "fp8": 32}


def as_uint4(layout: str, args):
    """A W4 layout's (q, s, z) as one byte a uint4 weight, [K, N]: the
    arguments of ``w4a16_matmul`` (and ``library_call``'s)."""
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    q, s, z = args
    if layout == "int4":
        return qm.unpack_int4(q) + 8, s, z + 8
    return (qm.unpack_w4(q) if layout == "packed" else q), s, z


def dequantized(layout: str, args):
    """The fp32 [K, N] weight of one layout's arguments (q, s, z)."""
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    q, s, _ = args
    if layout in ("w8", "fp8"):
        return q.float() * s
    return qm.dequant_w4(*as_uint4(layout, args))


def check_gemm_f16(gen, layout: str, shapes: dict, M: int,
                   row_scales: bool = False) -> dict:
    """One layout's fp16 instance at a layer's four GEMMs (``shapes``, M
    rows, group 128), through its wrapper: error against the plain version
    (fp32 from the same fp16 x) within ``gemm_tol``; time a call, device
    and host time, beside the bf16 instance on the same weights (x cast to
    bf16: device time and its error); the plain version; the library
    yardstick, a dense fp16 ``torch.matmul`` of the dequantized weights
    (``library_ms``), and ``_weight_int4pack_mm`` on fp16 x where the card's
    torch takes it (W4 layouts); the bound (x, the weight's bytes, scales
    and zeros and y once; 2 M K N operations at the fp16 rate). "fp8" with
    ``row_scales``: W8A8, x rounded to e4m3 per token first. Sums over the
    layer."""
    import torch
    from aphrodite_tpu_torch.ops import quant_gemm
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    f16 = "float16"
    fn = qm.KERNELS[LAYOUT_WRAPPER[layout]]
    tot = dict(max_abs_err=0.0, bf16_err=0.0, ms=0.0, device_ms=0.0,
               bf16_device_ms=0.0, host_ms=0.0, plain_ms=0.0, library_ms=0.0,
               library_device_ms=0.0, int4pack_ms=0.0, bytes=0.0, ops=0.0)
    tol = 0.0
    w4 = layout in ("int4", "packed", "uint4")
    int4pack = w4  # tried until the card's torch refuses it
    for gemm, (K, N) in shapes.items():
        x, args, plain = w4_inputs(gen, layout, M, K, N, 128, False, f16)
        wargs = args if args[2] is not None else args[:2]
        kw = {}
        if row_scales:
            x, xs = quant_gemm.fp8_quantize_rows(x)
            kw["row_scales"] = rs = xs.reshape(M).contiguous()
            plain = lambda xf, q=args[0], s=args[1], rs=rs: (  # noqa: E731
                qm.ref_fp8_matmul(xf, q, s, rs))
        xb = x.bfloat16()  # e4m3 values stay exact
        kern = lambda: fn(x, *wargs, **kw)  # noqa: E731
        kern_b = lambda: fn(xb, *wargs, **kw)  # noqa: E731
        y, yb = kern(), kern_b()
        ref, ref_b = plain(x.float()), plain(xb.float())
        torch.cuda.synchronize()
        err = (y.float() - ref).abs().max().item()
        err_b = (yb.float() - ref_b).abs().max().item()
        tol = max(tol, gemm_tol(f16, ref))
        if not (err <= gemm_tol(f16, ref) and y.dtype == torch.float16
                and torch.isfinite(y).all()
                and err_b <= TOL["bfloat16"]):
            raise AssertionError(
                f"{layout} {gemm} fp16 M={M}: max_abs_err {err} > "
                f"{gemm_tol(f16, ref)} (its bf16 self {err_b})")
        wd32 = dequantized(layout, args)
        wd = wd32.half()
        lib = lambda: x @ wd  # noqa: E731
        t = dict(ms=cuda_ms(kern, 50), device_ms=device_ms(kern, 20),
                 bf16_device_ms=device_ms(kern_b, 20),
                 host_ms=host_ms(kern, 50),
                 plain_ms=cuda_ms(lambda: plain(x.float()), 3),
                 library_ms=cuda_ms(lib, 50),
                 library_device_ms=device_ms(lib, 20))
        if int4pack:  # logs why where the card's torch refuses fp16 x
            label, lib4 = library_call("w4a16_matmul", x,
                                       as_uint4(layout, args), wd32)
            int4pack = label == "int4pack_mm"
            if int4pack:
                t["int4pack_ms"] = cuda_ms(lib4, 50)
            del lib4
        del wd, wd32
        nbytes = (x.numel() * 2 + sum(a.numel() * a.element_size()
                                      for a in wargs) + M * N * 2
                  + (4 * M if row_scales else 0))
        ops = 2.0 * M * K * N
        log(f"# phase 2: {LAYOUT_WRAPPER[layout]} fp16 {gemm} M={M} K={K} "
            f"N={N}{' (row scales)' if row_scales else ''}: err {err:.3g} "
            f"(tol {gemm_tol(f16, ref):.3g}); kernel {t['ms']:.4f} ms "
            f"(device {t['device_ms']:.4f} ms, host {t['host_ms']:.4f} ms a "
            f"call), its bf16 self device {t['bf16_device_ms']:.4f} ms "
            f"(fp16 / bf16 {t['device_ms'] / t['bf16_device_ms']:.3f}); "
            f"plain {t['plain_ms']:.4f} ms; dense fp16 matmul "
            f"{t['library_ms']:.4f} ms (device "
            f"{t['library_device_ms']:.4f} ms); bound "
            f"{bound_ms(nbytes, ops, f16)[0]:.4f} ms")
        for k, v in t.items():
            tot[k] += v
        tot["bytes"] += nbytes
        tot["ops"] += ops
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["bf16_err"] = max(tot["bf16_err"], err_b)
        del x, xb, args, wargs, y, yb, ref, ref_b
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot.pop("bytes"),
                                                tot.pop("ops"), f16)
    tot["tol"] = tol
    tot["int4pack"] = (f"{tot['int4pack_ms']:.4f} ms" if int4pack else
                       "unavailable on fp16 x (logged above)" if w4 else
                       "not a W4 layout")
    return tot


def check_gemm_bytes_f16() -> str:
    """Every conversion of the fp16 instances bit for bit against the CPU
    models (``w4_wgmma.fp8_model``, ``int8_model``, ``nibble_model``),
    through identity x (so y[k, n] is the converted weight, scales of 1):
    every e4m3 byte (kFp8, q [256, 256] holding byte (k + n) mod 256, its
    NaN bytes replaced by 0x00 and 0x80; with no K split and with 4, with
    and without row scales of 1) and every int8 byte (kW8, the same
    pattern); and every nibble less every zero that ``zeros_integral``
    admits, for int4, packed and uint4 in fp16 and bf16 (K = 256, group
    32, N = 512: zero [g, n] = lo + (512 g + n) mod (hi - lo + 1) covers
    the admitted range [lo, hi]; nibble (k + n) mod 16), with the zero
    inside the product and after it. Returns a line for the log."""
    import torch
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    from aphrodite_tpu_torch.ops import w4_wgmma
    from aphrodite_tpu_torch.quantization.loader import pack_w4
    f16 = torch.float16
    idx = torch.arange(256, device="cuda")
    b = (idx[:, None] + idx[None, :]) % 256
    ones = torch.ones(256, device="cuda")
    eye = torch.eye(256, device="cuda", dtype=f16)
    fin = torch.where(b == 0x7F, 0, torch.where(b == 0xFF, 0x80, b))
    got = {}
    q8 = fin.to(torch.uint8).view(torch.float8_e4m3fn)
    want8 = w4_wgmma.fp8_model(fin.cpu(), f16)
    if not torch.equal(want8.float(), e4m3_table()[fin.cpu()]):
        raise AssertionError("fp8_model in fp16 differs from the e4m3 table")
    for sp in (None, 4):
        for r in (None, ones):
            got[f"kFp8 fp16 splits {sp} row scales {r is not None}"] = (
                w4_wgmma.matmul("fp8", eye, q8, ones, None, splits=sp,
                                row_scales=r), want8)
    qi = b.to(torch.uint8).view(torch.int8)
    for sp in (None, 4):
        got[f"kW8 fp16 splits {sp}"] = (
            w4_wgmma.matmul("w8", eye, qi, ones, None, splits=sp),
            w4_wgmma.int8_model(qi.cpu(), f16))
    K, N, group = 256, 512, 32
    G = K // group
    u = (torch.arange(K)[:, None] + torch.arange(N)[None, :]) % 16
    ones_gn = torch.ones((G, N), device="cuda")
    for dt in (f16, torch.bfloat16):
        x = torch.eye(K, device="cuda", dtype=dt)
        for layout in ("int4", "packed", "uint4"):
            lo, hi = z_range(layout, dt)
            z = (lo + torch.arange(G * N) % (hi - lo + 1)).reshape(G, N)
            z = z.float()
            if not w4_wgmma.zeros_integral(layout, z, dt):
                raise AssertionError(f"{layout} {dt}: zeros {lo}..{hi} not "
                                     "admitted")
            q = {"int4": lambda: qm.pack_int4((u ^ 8) - 8),
                 "packed": lambda: pack_w4(u.to(torch.int8)),
                 "uint4": lambda: u.to(torch.int8)}[layout]()
            want = w4_wgmma.nibble_model(layout, u, z.repeat_interleave(
                group, dim=0), dt)
            for zero_in in (None, False):
                got[f"{layout} {str(dt)[6:]} zeros {lo}..{hi} in the "
                    f"product {zero_in is None}"] = (
                    w4_wgmma.matmul(layout, x, q.cuda(), ones_gn, z.cuda(),
                                    zero_in=zero_in), want)
    for what, (y, want) in got.items():
        y = y.cpu()
        if y.dtype != want.dtype or not torch.equal(y, want):
            bad = (y.float() != want.float()).nonzero()
            k, n = bad[0].tolist() if len(bad) else (0, 0)
            raise AssertionError(
                f"{what}: {len(bad)} of {y.numel()} values differ from the "
                f"CPU model, e.g. at ({k}, {n}): {y[k, n].item()!r}, want "
                f"{want[k, n].item()!r}")
    return (f"fp16 GEMM conversions: all 254 finite e4m3 bytes and all 256 "
            f"int8 bytes at every row and column (fp16), and every nibble "
            f"less every admitted zero (int4, packed, uint4 in fp16 and "
            f"bf16; both forms of the zero): y equals the CPU models "
            f"bit for bit in {len(got)} launches")


def z_range(layout: str, dtype) -> tuple[int, int]:
    """The integer zeros that ``w4_wgmma.zeros_integral`` admits for
    ``layout`` and x's ``dtype``: one interval [lo, hi] (its tests hold it
    tight: fp16 uint4 [-2033, 1024], bf16 [-241, 128])."""
    import torch
    from aphrodite_tpu_torch.ops import w4_wgmma
    ok = [z for z in range(-4096, 4096) if w4_wgmma.zeros_integral(
        layout, torch.tensor([float(z)]), dtype)]
    if ok != list(range(ok[0], ok[-1] + 1)):
        raise AssertionError(f"{layout} {dtype}: admitted zeros not one "
                             "interval")
    return ok[0], ok[-1]


def fp16_gemm_checks(gen, results: dict) -> None:
    """Phase 2 for the fp16 GEMM slice: every layout's fp16 instance
    (``csrc/w4_wgmma_f16.cu``) against its plain version at ``W4_CASES``,
    ``BYTE_CASES`` and ``FP8_CASES`` (every M tile, forced splits, both
    forms of the zero, fractional zeros), two launches bit-equal; the
    conversions bit for bit (``check_gemm_bytes_f16``); then a layer's
    four GEMMs of each of ``F16_GEMM_TIMED``, timed beside the bf16
    instance on the same weights (``check_gemm_f16``)."""
    f16 = "float16"
    log(f"# phase 2: w4_wgmma fp16 (int4 and packed at {len(W4_CASES)} "
        f"cases, uint4 and w8 at {len(BYTE_CASES)}): max_abs_err "
        f"{check_w4_wgmma(gen, dtype_name=f16):.3g} (tol {TOL[f16]} x "
        f"min(1, max|ref|)), two launches bit-equal")
    log(f"# phase 2: w4_wgmma fp16 fp8 (kFp8) at {len(FP8_CASES)} cases, "
        f"with and without row scales: max_abs_err "
        f"{check_fp8_layout(gen, f16):.3g} (tol {TOL[f16]} x min(1, "
        f"max|ref|)), two launches bit-equal")
    log(f"# phase 2: {check_gemm_bytes_f16()}")
    shapes = {"LLAMA8B": LLAMA8B_GEMMS, "QWEN7B": QWEN7B_GEMMS}
    for layout, model, M, rs in F16_GEMM_TIMED:
        r = check_gemm_f16(gen, layout, shapes[model], M, rs)
        log(f"# phase 2: {LAYOUT_WRAPPER[layout]} fp16 at {model} M={M}"
            f"{' with row scales' if rs else ''}, a layer's 4 GEMMs: "
            f"max_abs_err {r['max_abs_err']:.3g} (tol up to "
            f"{r['tol']:.3g}); kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f} ms, host {r['host_ms']:.4f} ms a layer), "
            f"its bf16 self device {r['bf16_device_ms']:.4f} ms (fp16 / bf16 "
            f"{r['device_ms'] / r['bf16_device_ms']:.3f}; its error "
            f"{r['bf16_err']:.3g}); plain {r['plain_ms']:.4f} ms; dense "
            f"fp16 matmul (library_ms) {r['library_ms']:.4f} ms (device "
            f"{r['library_device_ms']:.4f} ms); _weight_int4pack_mm "
            f"{r['int4pack']}; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        if M == F16_GEMM_ROW[layout] and not rs:
            results[(LAYOUT_WRAPPER[layout], "float16")] = r


class GemmSpy:
    """The quantized matmuls of ``ops/quant_gemm.py`` that the linear
    layers call, patched to count every call (on either device) by the
    hand-written GEMM it reaches on the card: a decode call (M <= 256)
    with per-column scales goes to ``LAYOUT_WRAPPER``'s wrapper of its
    layout (int4, packed or uint4 by the leaf it carries; int8 W8A8 to
    ``torch._int_mm``, none). The reckoning of a card run's GEMM launches
    is its CPU twin's calls."""

    NAMES = ("w8a16_matmul", "fp8_matmul", "w4a16_matmul")

    def __init__(self) -> None:
        from aphrodite_tpu_torch.ops import quant_gemm
        self.mod = quant_gemm
        self.fns = {n: getattr(quant_gemm, n) for n in self.NAMES}
        self.calls = dict.fromkeys(LAYOUT_WRAPPER.values(), 0)

    def kernel(self, name: str, x, a, kw) -> str | None:
        if x.shape[0] > self.mod.DECODE_M:
            return None
        if name == "w8a16_matmul":
            return name
        if name == "fp8_matmul":
            ws = a[2]
            blockwise = ws.dim() == 2 and tuple(ws.shape) != (1, ws.shape[1])
            return (None if blockwise or kw.get("input_scale") is not None
                    else name)
        return ("w4a16_int4_matmul" if kw.get("qweight4") is not None
                else "w4a16_packed_matmul" if kw.get("qpacked") is not None
                else "w4a16_matmul")

    def __enter__(self):
        for n, fn in self.fns.items():
            def spy(x, *a, _n=n, _fn=fn, **kw):
                k = self.kernel(_n, x, (x, *a), kw)
                if k is not None:
                    self.calls[k] += 1
                return _fn(x, *a, **kw)
            setattr(self.mod, n, spy)
        return self

    def __exit__(self, *exc):
        for n, fn in self.fns.items():
            setattr(self.mod, n, fn)


# Phase 30: tiny fp16 models, every attention head 64 wide (the fp16
# tensor-core instances): a Qwen2 whose projections stay unpacked under
# group 128 (K 256 and 512: uint4) and a one-layer Llama at K = 2048, where
# every W4 leaf packs (phase 31's layout; realized to int4 for "int4").
F16_QUANT_TINY = {
    "qwen": dict(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2,
                 intermediate_size=512, max_position_embeddings=1024,
                 rms_norm_eps=1e-6, tie_word_embeddings=False,
                 use_sliding_window=False,
                 architectures=["Qwen2ForCausalLM"]),
    "llama2048": dict(vocab_size=512, hidden_size=2048, num_hidden_layers=1,
                      num_attention_heads=32, num_key_value_heads=4,
                      intermediate_size=2048, max_position_embeddings=1024,
                      rms_norm_eps=1e-5, tie_word_embeddings=False,
                      architectures=["LlamaForCausalLM"])}
# Phase 30's runs: name -> (model, quantization, the GEMM it runs, whether
# activations round to 8 bits: there tokens may part at ties, as in phase
# 17).
F16_QUANT_PARITY = {
    "gptq-unpacked": ("qwen", "gptq", "w4a16_matmul", False),
    "gptq-packed": ("llama2048", "gptq", "w4a16_packed_matmul", False),
    "awq-packed": ("llama2048", "awq", "w4a16_packed_matmul", False),
    "int4": ("llama2048", "gptq", "w4a16_int4_matmul", False),
    "w8a16": ("qwen", "w8a16", "w8a16_matmul", False),
    "fp8": ("qwen", "fp8", "fp8_matmul", False),
    "fp8_w8a8": ("qwen", "fp8_w8a8", "fp8_matmul", True),
    "int8": ("qwen", "int8", None, True),
}


def fp16_quant_parity() -> dict:
    """Phase 30: fp16 greedy runs through the port on the card and on the
    CPU from one seed (the CPU's weights loaded on the card), for each of
    ``F16_QUANT_PARITY`` (``F16_QUANT_TINY``'s models; "int4" the packed
    leaves realized to int4 on both, ``realize_int4_leaves``): 12 prompts
    of 5-120 tokens, a 64-token batch budget (chunked prefill), 16-step
    decode windows, 16 new tokens. Tokens equal (but where activations
    round to 8 bits: partings at gaps below ``GAP``, ``same_tokens``); the
    chosen tokens' logprobs within ``F16_LOGPROB_TOL`` where they agree;
    every quantized GEMM's card launches exactly its CPU twin's calls
    (``GemmSpy``), every one on the fp16 instance (``dtype_launches``).
    Returns each GEMM's launches summed over the runs."""
    import torch
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.loader.weights import realize_int4_leaves
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    rng = np.random.RandomState(30)
    prompts = [rng.randint(1, 500, size=n).tolist()
               for n in (5, 120, 17, 64, 33, 90, 8, 47, 101, 12, 70, 29)]
    params = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True)
    total = dict.fromkeys(qm.KERNELS, 0)
    for run, (model, quant, kernel, eight_bit) in F16_QUANT_PARITY.items():
        kw = dict(hf_config=F16_QUANT_TINY[model], tokenizer="unused",
                  dtype="float16", quantization=quant, block_size=16,
                  num_kv_blocks=256, max_num_seqs=12,
                  max_num_batched_tokens=64, max_model_len=256,
                  decode_window=16)
        cpu = LLM(f"tiny-{model}-{quant}-fp16", device="cpu", **kw)
        gpu = LLM(f"tiny-{model}-{quant}-fp16", device="cuda", **kw)
        if run == "int4":
            for llm in (cpu, gpu):
                realize_int4_leaves(llm.engine.core.worker.model)
        gpu.engine.core.worker.load_params(
            cpu.engine.core.worker.model.state_dict())
        with GemmSpy() as want:
            a = traced(cpu, prompts, params)
        for fn in qm.KERNELS.values():
            fn.launches = 0
            fn.dtype_launches = dict.fromkeys(fn.dtype_launches, 0)
        with GemmSpy() as calls:
            b = traced(gpu, prompts, params)
        got = {k: fn.launches for k, fn in qm.KERNELS.items()}
        f16 = {k: fn.dtype_launches["float16"]
               for k, fn in qm.KERNELS.items()}
        if got != want.calls or got != calls.calls or got != f16 or any(
                v for k, v in got.items() if k != kernel) or (
                kernel is not None and got[kernel] <= 0):
            raise AssertionError(
                f"phase 30 {run}: launches {got}, on the fp16 instances "
                f"{f16}; the card's calls {calls.calls}, the CPU's "
                f"{want.calls}")
        if len({t for x in a[0] for t in x}) <= 10:
            raise AssertionError(f"phase 30 {run}: the tokens hardly vary: "
                                 f"{a[0]}")
        found = []
        if eight_bit:
            found = same_tokens(f"phase 30 {run}", cpu, gpu, prompts, a, b)
        elif a[0] != b[0]:
            raise AssertionError(
                f"phase 30 {run}: cuda vs cpu greedy fp16 tokens differ "
                f"(partings {partings(cpu, gpu, prompts, a, b)}):\n{a[0]}"
                f"\n{b[0]}")
        gaps = [abs(float(la[i][t]) - float(lb[i][t]))
                for ta, tb, la, lb in zip(a[0], b[0], a[1], b[1])
                for i, t in enumerate(ta) if ta[:i + 1] == tb[:i + 1]]
        margins = [float(r.topk(2).values[0] - r.topk(2).values[1])
                   for rows in a[1] for r in rows]
        if not max(gaps) <= F16_LOGPROB_TOL:
            raise AssertionError(f"phase 30 {run}: chosen logprobs card vs "
                                 f"CPU up to {max(gaps):.4g} > "
                                 f"{F16_LOGPROB_TOL}")
        for k, v in got.items():
            total[k] += v
        log(f"# phase 30: {run}: cuda == cpu greedy fp16 tokens for "
            f"{len(prompts)} prompts x 16"
            + (f" but at partings (request, step, cpu token, card token, "
               f"gap < {GAP}) {found}" if eight_bit else "")
            + f"; chosen logprobs within {max(gaps):.4g} (tol "
            f"{F16_LOGPROB_TOL}) over {len(gaps)} agreeing tokens; the CPU's "
            f"smallest top-2 margin {min(margins):.4g}; launches "
            f"{ {k: v for k, v in got.items() if v} } (= the CPU's calls, "
            f"all on the fp16 instance)")
        del cpu, gpu
        gc.collect()
        torch.cuda.empty_cache()
    return total


def main_path_awq_fp16(phase6_walls: dict) -> dict:
    """Phase 31: Llama-3.1-8B-Instruct AWQ-INT4's geometry (``LLAMA31_8B``;
    ``hugging-quants/Meta-Llama-3.1-8B-Instruct-AWQ-INT4`` is published in
    fp16) at full width and depth in fp16 with ``quantization="awq"``
    (group 128, zero points, quantized on the fly from seeded weights;
    every projection packs), phase 6's traffic and runs, cold and warm:
    exactly 4 x 32 x 63 = 8064 packed-GEMM launches a run, all on the fp16
    instance, ragged 32 and window 2016, all on the fp16 tensor-core
    instances, the other quantized GEMMs never; every logprob finite. Logs
    the walls beside phase 6's bf16 ones of the same call and the KV bytes
    a token. Returns the last cold run's launches."""
    from aphrodite_tpu_torch.ops import quant_matmul as qm
    phase = "phase 31"
    L, steps = LLAMA31_8B["num_hidden_layers"], 63
    packed = qm.w4a16_packed_matmul
    kernels = {**qm.KERNELS, **attention_kernels(), **instance_counts(),
               **{f"w4a16_packed_matmul {dt}": InstanceCount(
                   packed, dt, "dtype_launches")
                  for dt in ("float16", "bfloat16")}}
    exact = {k: 0 for k in kernels}
    exact.update({"w4a16_packed_matmul": 4 * L * steps,
                  "w4a16_packed_matmul float16": 4 * L * steps,
                  "ragged_paged_attention": L, "ragged tensor_cores": L,
                  "window_decode_attention": L * steps,
                  "window tensor_cores": L * steps})
    log(f"# {phase}: launches a run, reckoned: {exact}")
    counts, llm, walls = serve_workload(
        phase, "llama-3.1-8b-instruct-awq-fp16-dummy", LLAMA31_8B, kernels,
        exact=exact, dtype="float16", quantization="awq", logprobs=True)
    pool = llm.engine.core.worker.runner.kv_cache
    L_, pages, _, kvh, page, hd = pool.shape
    log(f"# {phase}: KV pool {pool.dtype} {tuple(pool.shape)}: "
        f"{L_ * 2 * kvh * hd * pool.element_size()} bytes a token, "
        f"{pages * page} tokens")
    n_dec = 32 * 64
    log(f"# {phase}: fp16 AWQ " + "; ".join(
        f"{k} {walls[k]:.3f} s/run ({n_dec / walls[k]:.0f} decode tok/s) "
        f"against phase 6's bf16 GPTQ {phase6_walls[k]:.3f} "
        f"({n_dec / phase6_walls[k]:.0f})" for k in walls))
    del llm, pool
    return counts


# ------------------------------------------ the fp16 MoE and MLA slice
F16_DS_PATH = "deepseek-v2-lite-fp16"          # phase 33
F16_MOE_PARITY_PATH = "tiny-moe-mla-fp16-parity"  # phase 32
# Phase 32's tiny models, fp16: DeepSeek V2 and V3 at the real attention
# geometry (16 heads on one latent head of 512 + 64; ``DS_TINY_BF16``) with
# a MoE second layer, and a tiny Qwen2-MoE (heads of 64: the fp16
# tensor-core attention). Every token takes all 8 experts (top-k = E),
# so that no top-k choice hinges on a rounding (ROADMAP C's trap: a
# router's flip at a near tie moves a step's logprobs by ~0.3); the
# grouped route still runs from 4 tokens a wave on (T * 8 >= 4 x 8), each
# expert's group as large as the wave, and the experts' weights still
# differ. V3 routes by sigmoid scores without group limits (a group pick
# is a top-k choice too).
_F16_MOE = dict(n_routed_experts=8, num_experts_per_tok=8,
                moe_intermediate_size=64, n_shared_experts=1,
                first_k_dense_replace=1)
F16_MOE_TINY = {
    "deepseek-v2": dict(DS_TINY_BF16, **_F16_MOE),
    "deepseek-v3": dict(DS_TINY_BF16, **_F16_MOE, q_lora_rank=48,
                        norm_topk_prob=True, routed_scaling_factor=2.5,
                        architectures=["DeepseekV3ForCausalLM"]),
    "qwen2-moe": dict(vocab_size=512, hidden_size=256, num_hidden_layers=3,
                      num_attention_heads=4, num_key_value_heads=2,
                      intermediate_size=256, moe_intermediate_size=72,
                      shared_expert_intermediate_size=136, num_experts=8,
                      num_experts_per_tok=8, norm_topk_prob=False,
                      mlp_only_layers=[1], max_position_embeddings=1024,
                      use_sliding_window=False, tie_word_embeddings=False,
                      architectures=["Qwen2MoeForCausalLM"]),
}
# Phase 32's runs: (model, KV cache dtype, batches): the MLA instances'
# fp16 ones on an fp16 cache (with the shared prompt: the cascade at 576),
# an e4m3 and an e5m2 cache; V2 and V3 routing; the CPU's plain attention
# at 576 is what this phase's time goes to, so each batch is run once.
F16_MOE_PARITY = {
    "deepseek-v2/auto": ("deepseek-v2", "auto", ("plain", "shared prompt")),
    "deepseek-v3/fp8_e4m3": ("deepseek-v3", "fp8_e4m3", ("plain",)),
    "deepseek-v2/fp8_e5m2": ("deepseek-v2", "fp8_e5m2", ("plain",)),
    "qwen2-moe/auto": ("qwen2-moe", "auto", ("plain",))}


def check_mla_map_key_f16(gen) -> float:
    """Both MLA instances at ``MLA_MASK_CASE`` over one allocation whose
    layer 1 has one base and one row count in every view
    (``OneAllocation``): bf16 and fp16 queries on a cache of their own
    dtype in turns, then fp16 on an e4m3 cache and on fp16 again, each
    against its plain version (the e4m3 one also against its fp16 self on
    the upcast cache). A tensor map or a prepared launch keyed without the
    element type would hand a launch another's. Returns the largest
    error."""
    one, err = OneAllocation(), 0.0
    for dt, kv in (("bfloat16", None), ("float16", None), ("bfloat16", None),
                   ("float16", None), ("float16", KV_FP8[0]),
                   ("float16", None)):
        for fn in (check_ragged, check_window):
            err = max(err, fn(gen, dt, MLA_MASK_CASE, timed=False, kv=kv,
                              make_cache=one))
    return err


def moe_mla_fp16_checks(gen, results: dict) -> None:
    """Phase 2 for the fp16 MoE and MLA slice, each fp16 instance against
    its plain version and timed beside its bf16 self (``results``, this
    call's): the grouped GEMM at phase 8's shapes and cases
    (``check_grouped``: balanced and skewed waves, M = 240, empty groups,
    rows no group covers) and at V2-Lite's wave; both MLA instances at
    ``MLA_GEOMS`` on fp16, e4m3 and e5m2 caches (the fp8 ones bit-equal to
    their fp16 selves on the upcast cache; two launches bit-equal), at
    ``MLA_MASK_CASE`` (soft cap, sliding window) with NaN in the stale
    slots on pages of 16 and 64, the window from the cascade's state, and
    bf16 / fp16 launches in turns over one allocation. fp16 errors are
    held at TOL["float16"] = 5e-3 (bf16: 2e-2; fp16 keeps 3 more bits)."""
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention)
    from aphrodite_tpu_torch.ops.window_decode_attention import (
        window_decode_attention)
    f16, b16 = "float16", "bfloat16"
    r, s = check_grouped(gen, f16), results[("grouped_matmul", b16)]
    results[("grouped_matmul", f16)] = r
    log(f"# phase 2: grouped_matmul {f16}, a MoE layer's 2 GEMMs over a wave "
        f"(M=65536, balanced): max_abs_err {r['max_abs_err']:.3g} (tol "
        f"{TOL[f16]}, all cases); kernel {r['ms']:.4f} ms (device "
        f"{r['device_ms']:.4f} ms), its bf16 self {s['ms']:.4f} ms (device "
        f"{s['device_ms']:.4f} ms, fp16 / bf16 "
        f"{r['device_ms'] / s['device_ms']:.3f}); plain {r['plain_ms']:.4f} "
        f"ms, {r['library']} {r['library_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    r = check_grouped_v2lite(gen, f16)
    s = results[("grouped_matmul", "deepseek-v2-lite-bf16", b16)]
    results[("grouped_matmul", F16_DS_PATH, f16)] = r
    log(f"# phase 2: grouped_matmul {f16} at V2-Lite's wave against its "
        f"bf16 self: device {r['device_ms']:.4f} / {s['device_ms']:.4f} ms "
        f"({r['device_ms'] / s['device_ms']:.3f})")
    for kv in (None, *KV_FP8):
        for path, geom in MLA_GEOMS.items():
            for name, fn, wrapper in (
                    ("ragged_paged_attention", check_ragged,
                     ragged_paged_attention),
                    ("window_decode_attention", check_window,
                     window_decode_attention)):
                wrapper.launches = 0
                wrapper.instance_launches.update(mla=0, tensor_cores=0,
                                                 scalar=0)
                wrapper.dtype_launches.update(float32=0, bfloat16=0,
                                              float16=0)
                r = fn(gen, f16, geom, kv=kv)
                inst, dts = wrapper.instance_launches, wrapper.dtype_launches
                if not (0 < inst["mla"] == dts["float16"] == wrapper.launches
                        and inst["scalar"] == inst["tensor_cores"] == 0):
                    raise AssertionError(f"{name} {f16} at {path}"
                                         f"{kv_label(kv)}: instances {inst}, "
                                         f"dtypes {dts}")
                s = results[(f"{name}_mla", path, b16) if kv is None
                            else (f"{name}_mla", path, b16, kv)]
                results[(f"{name}_mla", path, f16, kv)] = r
                extra = (f"device {r['device_ms']:.4f} ms" + (
                    f", host {r['host_ms']:.4f} ms a call"
                    if "host_ms" in r else ""))
                tol = (f"{TOL[f16]} x max(1, max|ref row|)"
                       if kv is not None and "ragged" in name
                       else tol_text(name, f16))
                log(f"# phase 2: {name} MLA instance {f16}{kv_label(kv)} at "
                    f"{path} shapes: max_abs_err {r['max_abs_err']:.3g} (tol "
                    f"{tol}; its bf16 self's {s['max_abs_err']:.3g})"
                    + ("" if kv is None else ", bit-equal to its fp16 self "
                       "on the upcast cache")
                    + f"; kernel {r['ms']:.4f} ms ({extra}), its bf16 self "
                    f"{s['ms']:.4f} ms (device {s['device_ms']:.4f} ms, fp16 "
                    f"/ bf16 {r['device_ms'] / s['device_ms']:.3f}); plain "
                    f"{r['plain_ms']:.4f} ms, sdpa in fp16 "
                    f"{r['library_ms']:.4f} ms (device "
                    f"{r['library_device_ms']:.4f} ms), bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        for name, fn in (("ragged_paged_attention", check_ragged),
                         ("window_decode_attention", check_window)):
            for page in (16, PAGE):
                for stale in (False, True):
                    err = fn(gen, f16, dict(MLA_MASK_CASE, page=page,
                                            stale=stale),
                             timed=False, kv=kv)
                    log(f"# phase 2: {name} MLA instance {f16}"
                        f"{kv_label(kv)} at head_dim 576 on {page}-token "
                        f"pages, soft cap 30 and a 100-token window"
                        f"{', NaN in the stale slots' if stale else ''}: "
                        f"max_abs_err {err:.3g}")
        for page in (16, PAGE):
            log(f"# phase 2: shared_prefix_attention + window MLA instance "
                f"at head_dim 576 {f16}{kv_label(kv)} (4 shared pages of "
                f"{page}, R = 8): max_abs_err "
                f"{check_mla_cascade(gen, f16, page, kv):.3g} (tol "
                f"{TOL[f16]} x min(1, max|ref|)), two launches bit-equal")
    log(f"# phase 2: both MLA instances, bf16 and fp16 (and fp16 on "
        f"{KV_FP8[0]}) in turns over one allocation: max_abs_err "
        f"{check_mla_map_key_f16(gen):.3g}, each right")


class GroupedSpy:
    """``moe_common.grouped_matmul`` patched to count every call (on either
    device): the reckoning of a card run's grouped launches is its CPU
    twin's calls."""

    def __init__(self) -> None:
        from aphrodite_tpu_torch.models import moe_common
        self.mod, self.fn, self.calls = moe_common, \
            moe_common.grouped_matmul, 0

    def __enter__(self):
        def spy(*a, **kw):
            self.calls += 1
            return self.fn(*a, **kw)
        self.mod.grouped_matmul = spy
        return self

    def __exit__(self, *exc):
        self.mod.grouped_matmul = self.fn


def moe_mla_fp16_parity() -> dict:
    """Phase 32: fp16 greedy runs through the port on the card and on the
    CPU from one seed (``redraw_deepseek``; the CPU's weights loaded on the
    card), ``F16_MOE_PARITY``: tiny DeepSeek V2 and V3 at the MLA geometry (the
    MLA instances' fp16 ones on fp16, e4m3 and e5m2 caches; a MoE layer on the
    grouped route; phase 23's batches: a 32-token budget, 16-step windows, and
    on V2's fp16-cache run three requests sharing a 4-page prompt for the
    cascade) and a tiny Qwen2-MoE (the fp16 tensor-core attention, the grouped
    route). Tokens equal but where the runs part at a gap below ``GAP``
    (``same_tokens``); chosen logprobs within ``F16_LOGPROB_TOL`` where the
    tokens agree; every attention kernel's and the grouped GEMM's card launches
    exactly its CPU twin's calls (``CallSpy``, ``GroupedSpy``), all in fp16,
    the attention at head_dim 576 all on the MLA instances. Returns each
    kernel's launches, keyed by (kernel, run)."""
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.cascade_attention import (
        shared_prefix_attention)
    from aphrodite_tpu_torch.ops.grouped_matmul import grouped_matmul
    kernels = {**attention_kernels(),
               "shared_prefix_attention": shared_prefix_attention,
               "grouped_matmul": grouped_matmul}
    rng = np.random.RandomState(32)
    shared = rng.randint(10, 500, size=4 * 16).tolist()
    batches = {"plain": [rng.randint(1, 500, size=n).tolist()
                         for n in (5, 40, 17, 70)],
               "shared prompt": [shared + rng.randint(10, 500, size=3 + i)
                                 .tolist() for i in range(3)]}
    params = SamplingParams(temperature=0.0, max_tokens=20, ignore_eos=True)
    launches = {}
    for run, (model, kv, names) in F16_MOE_PARITY.items():
        kw = dict(hf_config=F16_MOE_TINY[model], tokenizer="unused",
                  dtype="float16", block_size=16, num_kv_blocks=128,
                  max_num_seqs=4, max_num_batched_tokens=32,
                  max_model_len=256, decode_window=16, kv_cache_dtype=kv)
        cpu = LLM(f"tiny-{model}-fp16", device="cpu", **kw)
        redraw_deepseek(cpu.engine.core.worker.model, 32)
        gpu = LLM(f"tiny-{model}-fp16", device="cuda", **kw)
        gpu.engine.core.worker.load_params(
            cpu.engine.core.worker.model.state_dict())
        mla = model.startswith("deepseek")
        total = dict.fromkeys(kernels, 0)
        for what in names:
            ps = batches[what]
            with CallSpy() as want, GroupedSpy() as g_want:
                a = traced(cpu, ps, params)
            for fn in kernels.values():
                fn.launches = 0
            for fn in (grouped_matmul, *attention_kernels().values()):
                fn.dtype_launches = dict.fromkeys(fn.dtype_launches, 0)
            for fn in attention_kernels().values():
                fn.instance_launches = dict.fromkeys(fn.instance_launches, 0)
            with CallSpy() as calls, GroupedSpy() as g_calls:
                b = traced(gpu, ps, params)
            got = {k: fn.launches for k, fn in kernels.items()}
            want_calls = {**want.calls, "grouped_matmul": g_want.calls}
            card_calls = {**calls.calls, "grouped_matmul": g_calls.calls}
            inst = "mla" if mla else "tensor_cores"
            on_inst = {k: fn.instance_launches[inst]
                       for k, fn in attention_kernels().items()}
            f16 = {k: fn.dtype_launches["float16"]
                   for k, fn in (("grouped_matmul", grouped_matmul),
                                 *attention_kernels().items())}
            need = ["ragged_paged_attention", "window_decode_attention",
                    "grouped_matmul"]
            if mla and what == "shared prompt":
                need.append("shared_prefix_attention")
            if any(got[k] != want_calls.get(k, 0)
                   or got[k] != card_calls.get(k, 0) for k in got) or any(
                    got[k] <= 0 for k in need) or any(
                    on_inst[k] != got[k] for k in on_inst) or any(
                    f16[k] != got[k] for k in f16):
                raise AssertionError(
                    f"phase 32 {run} {what}: launches {got}, on the {inst} "
                    f"instances {on_inst}, fp16 {f16}; the card's calls "
                    f"{card_calls}, the CPU's {want_calls}")
            if len({t for x in a[0] for t in x}) <= 10:
                raise AssertionError(f"phase 32 {run} {what}: the tokens "
                                     f"hardly vary: {a[0]}")
            found = same_tokens(f"phase 32 {run} {what}", cpu, gpu, ps, a, b)
            gaps = [abs(float(la[i][t]) - float(lb[i][t]))
                    for ta, tb, la, lb in zip(a[0], b[0], a[1], b[1])
                    for i, t in enumerate(ta) if ta[:i + 1] == tb[:i + 1]]
            worst = max(gaps)
            if not worst <= F16_LOGPROB_TOL:
                raise AssertionError(
                    f"phase 32 {run} {what}: chosen logprobs card vs CPU up "
                    f"to {worst:.4g} > {F16_LOGPROB_TOL}")
            for k, v in got.items():
                total[k] += v
            log(f"# phase 32: {run}, {what}: cuda == cpu greedy fp16 tokens "
                f"for {len(ps)} prompts x 20 but at partings (request, "
                f"step, cpu token, card token, gap < {GAP}) {found}; chosen "
                f"logprobs within {worst:.4g} (tol {F16_LOGPROB_TOL}) over "
                f"{len(gaps)} agreeing tokens; launches {got} (= the CPU's "
                f"calls), all fp16, the attention on the {inst} instances")
        launches.update({(k, run): v for k, v in total.items()})
        del cpu, gpu
    return launches


# ----------------------------------- the ragged kernel's last options
# Phase 2 for the slice that ports what the ragged kernel still refused:
# image spans in fp16 (``csrc/ragged_spans_f16.cu``), ALiBi beside spans on
# the tensor-core instances (``csrc/ragged_spans.cu`` and its fp16 twin),
# and spans and ALiBi at the MLA geometry (the MLA option instances,
# ``csrc/mla_opts.cu`` and ``csrc/mla_opts_f16.cu``). No model has the last
# three: phase 2 alone holds them against the plain version.
@contextlib.contextmanager
def only_source(lib: str, what: str):
    """Within it, every ragged launch must come from ``csrc/<lib>.cu`` (the
    wrapper's ``source_launches``), and at least one must."""
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention as rpa, reset_launches)
    reset_launches()
    yield
    if not 0 < rpa.source_launches[lib] == rpa.launches:
        raise AssertionError(f"{what}: ragged launches {rpa.launches}, by "
                             f"source {rpa.source_launches}; want all from "
                             f"{lib}")


@contextlib.contextmanager
def option_instances():
    """Within it, the ragged wrapper sends every call at the MLA geometry
    to the MLA option instances, with or without options (their cost with
    none set, beside the instances without options). It swaps the
    module's ``ragged_route``, which the wrapper looks up at every call;
    wrap it in ``only_source``, which fails if the launches did not come
    from the option instance's library."""
    from aphrodite_tpu_torch.ops import ragged_paged_attention as rm
    route = rm.ragged_route

    def forced(dtype, hd, spans, alibi):
        r = route(dtype, hd, spans, alibi)
        return route(dtype, hd, True, alibi) if r[2] == "mla" else r
    rm.ragged_route = forced
    try:
        yield
    finally:
        rm.ragged_route = route


# ALiBi beside image spans on the tensor-core span instances (bf16, fp16):
# SPAN_RAGGED_CASES's requests at head_dim 64, 128 and 256, with and without
# a soft cap (the slopes of the query heads, ``alibi_slopes(nq)``).
ALIBI_SPAN_CASES = {
    f"{case}{cap}": dict(SPAN_RAGGED_CASES[case], alibi=True,
                         opts=dict(logits_soft_cap=50.0) if cap else {})
    for case in ("hd64-group1", "hd128-group4", "hd256-group2")
    for cap in ("", "-softcap50")}
# Image spans at the MLA geometry (the option instances): V2-Lite's 16 and
# V3's 128 query heads on one latent head of 576, SPAN_RAGGED_CASES's
# requests and span sets, on pages of 64 and 16 (a 32-key tile spans two),
# a 100-token sliding window and a soft cap; NaN in every stale slot on
# V2-Lite's 16-token pages (``poison_stale``).
MLA_SPAN_CASES = {
    "v2lite-page64": dict(nq=16, kvh=1, hd=576, ctx=_SPAN_CTX,
                          qlen=_SPAN_QLEN, spans=_SPAN_SETS,
                          scale=MLA_SCALE, mla=True),
    "v2lite-page16-window100-softcap30-stale": dict(
        nq=16, kvh=1, hd=576, ctx=_SPAN_CTX, qlen=_SPAN_QLEN,
        spans=_SPAN_SETS, page=16, scale=MLA_SCALE, mla=True, stale=True,
        opts=dict(sliding_window=100, logits_soft_cap=30.0)),
    "v3-page16": dict(nq=128, kvh=1, hd=576, ctx=_SPAN_CTX,
                      qlen=_SPAN_QLEN, spans=_SPAN_SETS, page=16,
                      scale=MLA_SCALE, mla=True),
    "v3-page64-softcap30": dict(nq=128, kvh=1, hd=576, ctx=_SPAN_CTX,
                                qlen=_SPAN_QLEN, spans=_SPAN_SETS,
                                scale=MLA_SCALE, mla=True,
                                opts=dict(logits_soft_cap=30.0)),
}
# ALiBi at the MLA geometry, with and without spans and a soft cap.
MLA_ALIBI_CASES = {
    "v2lite-alibi": dict(MLA_SPAN_CASES["v2lite-page64"], spans=None,
                         alibi=True),
    "v2lite-alibi-spans-softcap30-page16": dict(
        MLA_SPAN_CASES["v2lite-page64"], page=16, alibi=True,
        opts=dict(logits_soft_cap=30.0)),
    "v3-alibi-softcap30-page16": dict(
        MLA_SPAN_CASES["v3-page16"], spans=None, alibi=True,
        opts=dict(logits_soft_cap=30.0)),
    "v3-alibi-spans": dict(MLA_SPAN_CASES["v3-page16"], page=PAGE,
                           alibi=True),
}
# V2-Lite's wave (``MLA_GEOMS``) with one 256-token image span a request
# (phase 26's prompt layout, ``G3_SPAN``): the MLA option instance timed.
V2L_SPAN_WAVE = dict(MLA_GEOMS["deepseek-v2-lite-bf16"],
                     spans=[[G3_SPAN]] * 32)


def span_fp16_checks(gen, results: dict) -> None:
    """The fp16 span instances: phase 26's wave on fp16, e4m3 and e5m2
    caches, each against its plain version at TOL["float16"] and timed
    beside its bf16 self (this call's, where phase 2 ran one), SDPA in fp16
    with (causal OR span) as a boolean mask and its bound; every case of
    ``SPAN_RAGGED_CASES`` in fp16 (head_dim 32, in 64-wide tiles, timed for
    phase 34's hd-32 run). All launches from ``csrc/ragged_spans_f16.cu``.
    Then the decode kernel
    at phase 35's step in fp16 (``DECODE_CASES["gemma-3-4b"]``: 8 / 4
    heads of 256, the fp16 instance at head_dim 256, group 2), timed
    beside its bf16 self."""
    name, f16, b16 = "ragged_paged_attention", "float16", "bfloat16"
    g3 = "gemma-3-4b-it-bf16"
    for kv in (None, *KV_FP8):
        with only_source("ragged_spans_f16", f"fp16 spans{kv_label(kv)}"):
            r = check_ragged(gen, f16, G3_WAVE, kv=kv)
        results[(name, g3, f16) if kv is None else (name, g3, f16, kv)] = r
        s = results.get((name, g3, b16) if kv is None else (name, g3, b16,
                                                              kv))
        beside = ("" if s is None else
                  f", its bf16 self {s['ms']:.4f} ms (device "
                  f"{s['device_ms']:.4f} ms, fp16 / bf16 "
                  f"{r['device_ms'] / s['device_ms']:.3f})")
        log(f"# phase 2: {name} {f16}{kv_label(kv)} with image spans at "
            f"gemma-3-4b-it shapes (csrc/ragged_spans_f16.cu): max_abs_err "
            f"{r['max_abs_err']:.3g} (tol {TOL[f16]}); kernel "
            f"{r['ms']:.4f} ms (device {r['device_ms']:.4f} ms){beside}; "
            f"plain {r['plain_ms']:.4f} ms, sdpa in fp16 with (causal OR "
            f"span) as a boolean mask {r['library_ms']:.4f} ms (device "
            f"{r['library_device_ms']:.4f} ms), bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']}); {blind_text(r)}")
    lib = "ragged_spans_f16"
    for case, geom in SPAN_RAGGED_CASES.items():
        with only_source(lib, f"fp16 spans {case}"):
            err = check_ragged(gen, f16, geom, timed=False)
        log(f"# phase 2: {name} {f16} spans {case} ({lib}): max_abs_err "
            f"{err:.3g} (tol {TOL[f16]})")
    # head_dim 32 (phase 34's tiny Gemma-3) timed, beside the scalar
    # instance launched directly
    r = check_ragged(gen, f16, SPAN_RAGGED_CASES["hd32-group2"], before=True)
    results[(name, "mm-tiny-hd32", f16)] = r
    log(f"# phase 2: {name} {f16} spans hd32-group2 (64-wide tensor-core "
        f"tiles): kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f} ms), "
        f"the scalar instance (before) {r['before_ms']:.4f} ms (device "
        f"{r['before_device_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
        f"sdpa {r['library_ms']:.4f} ms (device "
        f"{r['library_device_ms']:.4f} ms), bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})")
    case, dpa = "gemma-3-4b", "decode_paged_attention"
    r = check_decode(gen, f16, case)
    s = results[(dpa, case, b16)]
    results[(dpa, case, f16)] = r
    log(f"# phase 2: {dpa} {case} {f16} (phase 35's step): device "
        f"{r['device_ms']:.4f} ms against its bf16 self {s['device_ms']:.4f} "
        f"ms (fp16 / bf16 {r['device_ms'] / s['device_ms']:.3f})")


def alibi_span_checks(gen, results: dict) -> None:
    """ALiBi beside image spans on the tensor-core span instances, bf16
    (``csrc/ragged_spans.cu``) and fp16 (``csrc/ragged_spans_f16.cu``): at
    ``ALIBI_SPAN_CASES`` against the plain version (at TOL x max(1,
    max|ref row|), as every ALiBi case: a steep slope makes an output one V
    row), and at phase 26's wave with the slopes of its 8 heads, timed
    beside the same wave with spans alone (this call's) and SDPA with the
    bias as a float mask (-inf outside (causal OR span))."""
    name, g3 = "ragged_paged_attention", "gemma-3-4b-it-bf16"
    for dt, lib in (("bfloat16", "ragged_spans"),
                    ("float16", "ragged_spans_f16")):
        with only_source(lib, f"ALiBi with spans {dt}"):
            r = check_ragged(gen, dt, dict(G3_WAVE, alibi=True))
            for case, geom in ALIBI_SPAN_CASES.items():
                err = check_ragged(gen, dt, geom, timed=False)
                log(f"# phase 2: {name} {dt} ALiBi with spans {case} "
                    f"({lib}): max_abs_err {err:.3g} (tol {TOL[dt]} x "
                    f"max(1, max|ref row|))")
        results[(name, "gemma-3-4b-it-alibi", dt)] = r
        s = results[(name, g3, dt)]
        log(f"# phase 2: {name} {dt} ALiBi with image spans at "
            f"gemma-3-4b-it shapes ({lib}): max_abs_err "
            f"{r['max_abs_err']:.3g} (tol {TOL[dt]} x max(1, max|ref row|)); "
            f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f} ms), "
            f"spans alone {s['ms']:.4f} ms (device {s['device_ms']:.4f} "
            f"ms): ALiBi costs {r['device_ms'] / s['device_ms'] - 1:+.1%} "
            f"device time; plain {r['plain_ms']:.4f} ms, sdpa with the "
            f"bias as a float mask {r['library_ms']:.4f} ms (device "
            f"{r['library_device_ms']:.4f} ms), bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']})")


def mla_option_checks(gen, results: dict) -> None:
    """The MLA option instances (bf16 ``csrc/mla_opts.cu``, fp16
    ``csrc/mla_opts_f16.cu``) in bf16 and fp16 on caches of q's dtype,
    e4m3 and e5m2: ``MLA_SPAN_CASES`` and ``MLA_ALIBI_CASES`` against the
    plain version at TOL x max(1, max|ref row|) (a row that sees one key is one
    V row; on fp8 caches also bit-equal to their selves on the upcast
    cache), two launches bit-equal; V2-Lite's wave with one 256-token span
    a request (``V2L_SPAN_WAVE``) timed beside the instances without
    options (this call's: ``mla_checks``, ``moe_mla_fp16_checks``), SDPA on
    expanded K/V with (causal OR span) as a boolean mask, and its bound;
    the wave without options on the option instances
    (``option_instances``) beside the instances without them; and in bf16
    the wave with ALiBi."""
    rpa, ds = "ragged_paged_attention_mla", "deepseek-v2-lite-bf16"
    for dt, lib in (("bfloat16", "mla_opts"), ("float16", "mla_opts_f16")):
        for kv in (None, *KV_FP8):
            with only_source(lib, f"MLA options {dt}{kv_label(kv)}"):
                for cases in (MLA_SPAN_CASES, MLA_ALIBI_CASES):
                    for case, geom in cases.items():
                        if kv is not None and cases is MLA_ALIBI_CASES \
                                and kv != KV_FP8[0]:
                            continue  # ALiBi on e4m3 alone of the fp8s
                        err = check_ragged(gen, dt, geom, timed=False, kv=kv)
                        log(f"# phase 2: ragged MLA option instance {dt}"
                            f"{kv_label(kv)} {case}: max_abs_err {err:.3g} "
                            f"(tol {TOL[dt]} x max(1, max|ref row|)), two "
                            "launches bit-equal")
        with only_source(lib, f"MLA spans wave {dt}"):
            r = check_ragged(gen, dt, V2L_SPAN_WAVE)
        with only_source(lib, f"MLA wave without options {dt}"), \
                option_instances():
            n = check_ragged(gen, dt, MLA_GEOMS[ds])
        s = results[(rpa, ds, dt) if dt == "bfloat16" else (rpa, ds, dt,
                                                              None)]
        results[(rpa, "deepseek-v2-lite-spans", dt)] = r
        results[(rpa, "deepseek-v2-lite-no-options", dt)] = n
        log(f"# phase 2: ragged MLA option instance {dt} ({lib}) at "
            f"DeepSeek-V2-Lite's wave with a 256-token image span a "
            f"request: max_abs_err {r['max_abs_err']:.3g} (tol {TOL[dt]} x "
            f"max(1, max|ref row|)); kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f} ms); the instance without options on "
            f"the causal wave {s['ms']:.4f} ms (device {s['device_ms']:.4f} "
            f"ms): spans cost {r['device_ms'] / s['device_ms'] - 1:+.1%} "
            f"device time; the option instance with no option set "
            f"{n['ms']:.4f} ms (device {n['device_ms']:.4f} ms, "
            f"{n['device_ms'] / s['device_ms']:.3f} x the instance without "
            f"options); plain {r['plain_ms']:.4f} ms, sdpa on expanded K/V "
            f"with (causal OR span) as a boolean mask {r['library_ms']:.4f} "
            f"ms (device {r['library_device_ms']:.4f} ms), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); {blind_text(r)}")
    with only_source("mla_opts", "MLA ALiBi wave"):
        r = check_ragged(gen, "bfloat16", dict(MLA_GEOMS[ds], alibi=True))
    results[(rpa, "deepseek-v2-lite-alibi", "bfloat16")] = r
    s = results[(rpa, ds, "bfloat16")]
    log(f"# phase 2: ragged MLA option instance bfloat16 with ALiBi at "
        f"DeepSeek-V2-Lite's wave: max_abs_err {r['max_abs_err']:.3g}; "
        f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f} ms, "
        f"{r['device_ms'] / s['device_ms']:.3f} x the instance without "
        f"options), sdpa with the bias as a float mask {r['library_ms']:.4f} "
        f"ms (device {r['library_device_ms']:.4f} ms), bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


def ragged_option_checks(gen, results: dict) -> None:
    """Phase 2 for the ragged kernel's last options (see above)."""
    span_fp16_checks(gen, results)
    alibi_span_checks(gen, results)
    mla_option_checks(gen, results)


# Phase 34's tiny fp16 multimodal models: Gemma-3 at head_dim 64 (its
# text group of 2 on the fp16 tensor-core span instances) and at 32 (the
# same instances in 64-wide tiles), and PaliGemma-2 (no spans, head_dim
# 32: the fp16 tensor-core instances).
F16_MM_TINY = {
    "gemma3-hd64": dict(MM_TINY["gemma3"], text_config=dict(
        MM_TINY["gemma3"]["text_config"], head_dim=64,
        query_pre_attn_scalar=64)),
    "gemma3": MM_TINY["gemma3"],
    "paligemma2": MM_TINY["paligemma2"]}
# Phase 34's runs: (model, KV cache dtype, the ragged kernel's library).
F16_MM_PARITY = {
    "gemma3-hd64/auto": ("gemma3-hd64", "auto", "ragged_spans_f16"),
    "gemma3-hd64/fp8_e4m3": ("gemma3-hd64", "fp8_e4m3", "ragged_spans_f16"),
    "gemma3/auto": ("gemma3", "auto", "ragged_spans_f16"),
    "paligemma2/auto": ("paligemma2", "auto", "ragged_f16")}


def mm_fp16_parity() -> dict:
    """Phase 34: fp16 greedy runs through the port on the card and on the
    CPU from one seed (``redraw_mm``; the CPU's weights loaded on the
    card), ``F16_MM_PARITY``, on phase 25's batch (one image, two images, a
    text row; 16-token chunks, one cutting an image's span; 16-step decode
    windows). Tokens equal but where the runs part at a gap below ``GAP``
    (``same_tokens``); chosen logprobs within ``F16_LOGPROB_TOL`` where the
    tokens agree; every attention kernel's card launches exactly its CPU
    twin's calls (``CallSpy``), every ragged launch in fp16 from its
    run's library, Gemma-3's all with the spans, PaliGemma-2's none.
    Returns each kernel's launches, keyed by (kernel, run)."""
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.decode_paged_attention import (
        decode_paged_attention)
    from aphrodite_tpu_torch.ops.ragged_paged_attention import reset_launches
    kernels = {**attention_kernels(),
               "decode_paged_attention": decode_paged_attention}
    rpa = kernels["ragged_paged_attention"]
    params = [SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True)
              for n in (20, 12, 24)]
    launches = {}
    for run, (model, kv, lib) in F16_MM_PARITY.items():
        arch = model.split("-")[0]
        kw = dict(hf_config=F16_MM_TINY[model], tokenizer="unused",
                  dtype="float16", block_size=16, num_kv_blocks=128,
                  max_num_seqs=4, max_num_batched_tokens=16,
                  max_model_len=256, decode_window=16, kv_cache_dtype=kv)
        cpu = LLM("tiny-vlm-fp16", device="cpu", **kw)
        redraw_mm(cpu.engine.core.worker.model, 34)
        gpu = LLM("tiny-vlm-fp16", device="cuda", **kw)
        gpu.engine.core.worker.load_params(
            cpu.engine.core.worker.model.state_dict())
        ps = mm_prompts(arch, 8, 16)
        with CallSpy() as want:
            a = traced(cpu, ps, params)
        for fn in kernels.values():
            fn.launches = 0
        reset_launches()
        with CallSpy() as calls:
            b = traced(gpu, ps, params)
        got = {k: fn.launches for k, fn in kernels.items()}
        n = got["ragged_paged_attention"]
        spans = n if arch == "gemma3" else 0
        if any(got[k] != want.calls[k] or got[k] != calls.calls[k]
               for k in got) or n <= 0 or rpa.span_launches != spans or \
                rpa.source_launches[lib] != n or \
                rpa.dtype_launches["float16"] != n:
            raise AssertionError(
                f"phase 34 {run}: launches {got}, with spans "
                f"{rpa.span_launches} (want {spans}), by source "
                f"{rpa.source_launches} (want all {lib}), by dtype "
                f"{rpa.dtype_launches}; the card's calls {calls.calls}, the "
                f"CPU's {want.calls}")
        if len({t for x in a[0] for t in x}) <= 10:
            raise AssertionError(f"phase 34 {run}: the tokens hardly vary: "
                                 f"{a[0]}")
        found = same_tokens(f"phase 34 {run}", cpu, gpu, ps, a, b)
        gaps = [abs(float(la[i][t]) - float(lb[i][t]))
                for ta, tb, la, lb in zip(a[0], b[0], a[1], b[1])
                for i, t in enumerate(ta) if ta[:i + 1] == tb[:i + 1]]
        worst = max(gaps)
        if not worst <= F16_LOGPROB_TOL:
            raise AssertionError(f"phase 34 {run}: chosen logprobs card vs "
                                 f"CPU up to {worst:.4g} > {F16_LOGPROB_TOL}")
        launches.update({(k, run): v for k, v in got.items()})
        log(f"# phase 34: {run}: cuda == cpu greedy fp16 tokens for "
            f"{len(ps)} prompts (one image, two images, a text row) but at "
            f"partings (request, step, cpu token, card token, gap < {GAP}) "
            f"{found}; chosen logprobs within {worst:.4g} (tol "
            f"{F16_LOGPROB_TOL}) over {len(gaps)} agreeing tokens; launches "
            f"{got} (= the CPU's calls), ragged all fp16 from {lib}, with "
            f"spans {rpa.span_launches}")
        del cpu, gpu
    return launches


# ------------------------ the tensor-core routes at other geometries
# Phase 2 and phases 36-38 for the slice that moves bf16 and fp16 off the
# ragged kernel's scalar instance and the decode kernel's CUDA-core one:
# both now run their tensor-core instances at every head_dim that is a
# multiple of 16 up to 256 (tiles 64, 128 or 256 wide, the model's head_dim
# a run-time stride), and decode at any group (row slices of 16 query
# heads). The served checkpoints that reach them: BLOOM-3b (32 / 32 heads
# of 80, ALiBi), MPT-30B (64 / 64 of 112, ALiBi), Falcon-7B (71 query
# heads of 64 on one KV head).
BLOOM_3B = dict(  # bigscience/bloom-3b config.json
    architectures=["BloomForCausalLM"], model_type="bloom",
    vocab_size=250880, hidden_size=2560, n_head=32, n_layer=30,
    layer_norm_epsilon=1e-5)
FALCON_7B = dict(  # tiiuae/falcon-7b config.json
    architectures=["FalconForCausalLM"], model_type="falcon",
    vocab_size=65024, hidden_size=4544, num_attention_heads=71,
    num_hidden_layers=32, alibi=False, bias=False, multi_query=True,
    new_decoder_architecture=False, parallel_attn=True,
    layer_norm_epsilon=1e-5)
# Phase 38 serves Falcon-7B at 16 of its 32 layers, which keeps the script
# inside its time limit (every layer runs the same kernels).
FALCON_7B_HALF = dict(FALCON_7B, num_hidden_layers=16)
_STEP = [513 + (37 * r) % 64 for r in range(32)]  # phase 6's decode step
# Phase 2's timed waves (32 x 512) and decode steps (R = 32 over 513-576
# keys) at the served geometries; MPT-30B (mosaicml/mpt-30b config.json:
# d_model 7168, 64 heads, ALiBi) is held and timed here only.
TC23_WAVES = {
    "bloom-3b": dict(nq=32, kvh=32, hd=80, ctx=[512] * 32, qlen=[512] * 32,
                     alibi=True),
    "mpt-30b": dict(nq=64, kvh=64, hd=112, ctx=[512] * 32,
                    qlen=[512] * 32, alibi=True),
    "falcon-7b": dict(nq=71, kvh=1, hd=64, ctx=[512] * 32, qlen=[512] * 32),
}
TC23_DECODE_CASES = {
    "bloom-3b": (32, 32, 80, _STEP, dict(alibi=True)),
    "mpt-30b": (64, 64, 112, _STEP, dict(alibi=True)),
    "falcon-7b": (71, 1, 64, _STEP, {}),
    # held, not timed: head dims 80, 96 and 112 at group 2, groups 18 and
    # 71 at head_dim 64, with and without ALiBi
    **{f"hd{hd}{'-alibi' * a}": (16, 8, hd, _STEP, dict(alibi=True) if a
                                 else {})
       for hd in (80, 96, 112) for a in (False, True)},
    **{f"group{g}{'-alibi' * a}": (g, 1, 64, _STEP, dict(alibi=True) if a
                                   else {})
       for g in (18, 71) for a in (False, True)},
}
# Held, not timed: the ragged kernel at head dims 32, 48, 80, 96 and 112
# (the narrowest tiles that hold them: 64 and 128 wide) over
# SPAN_RAGGED_CASES's requests (mid-tile spans, later chunks): causal at
# group 2, ALiBi at group 3 (the slopes' interpolation branch), image
# spans, a soft cap with a sliding window on 16-token pages, and a group
# past 16 (18 on one KV head).
TC23_RAGGED_CASES = {
    f"hd{hd}-{kind}": dict(
        dict(nq=8, kvh=4, hd=hd, ctx=_SPAN_CTX, qlen=_SPAN_QLEN), **extra)
    for hd in (32, 48, 80, 96, 112)
    for kind, extra in (
        ("causal", {}), ("alibi-group3", dict(nq=9, kvh=3, alibi=True)),
        ("spans", dict(spans=_SPAN_SETS)),
        ("softcap30-window64-page16", dict(
            page=16, opts=dict(logits_soft_cap=30.0, sliding_window=64))),
        ("group18", dict(nq=18, kvh=1)))}


@contextlib.contextmanager
def only_instance(fn, inst: str, what: str):
    """Within it, every launch of the attention wrapper ``fn`` must be on
    its instance ``inst`` (its ``instance_launches``), and at least one
    must be."""
    fn.instance_launches = dict.fromkeys(fn.instance_launches, 0)
    yield
    n = fn.instance_launches
    if not 0 < n[inst] == sum(n.values()):
        raise AssertionError(f"{what}: launches by instance {n}; want all "
                             f"on {inst}")


def tc_route_checks(gen, results: dict) -> None:
    """Phase 2 for the tensor-core routes at other geometries: in bf16 and
    fp16, on caches of q's dtype, e4m3 and e5m2, ``TC23_RAGGED_CASES`` (the
    ragged kernel) and ``TC23_DECODE_CASES`` (the decode kernel, three
    plans each), every launch on the tensor-core instances, each against
    its plain version (the ragged at TOL, or TOL x max(1, max|ref row|)
    with ALiBi; the decode at TOL x min(1, max|ref|)); then in bf16 the
    served geometries timed (``TC23_WAVES``, the decode steps): call and
    device time, the same call on the scalar or CUDA-core instance
    (launched directly, the "before"), SDPA (ALiBi as a float mask, the
    group by expanding K/V), the bound and the plain version."""
    import torch
    from aphrodite_tpu_torch.ops.cuda_build import H100_SMEM_OPTIN
    from aphrodite_tpu_torch.ops.decode_paged_attention import (
        decode_launch_geometry, decode_paged_attention as dpa)
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention as rpa, ragged_route)
    rname, dname = "ragged_paged_attention", "decode_paged_attention"
    for dt in ("bfloat16", "float16"):
        for kv in (None, *KV_FP8):
            worst = {}
            with only_instance(rpa, "tensor_cores", f"ragged {dt}{kv}"):
                for geom in TC23_RAGGED_CASES.values():
                    err = check_ragged(gen, dt, geom, timed=False, kv=kv)
                    worst[geom["hd"]] = max(worst.get(geom["hd"], 0.0),
                                            float(f"{err:.3g}"))
            log(f"# phase 2: {rname} {dt}{kv_label(kv)} tensor-core "
                f"instances at head dims 32-112 ({len(TC23_RAGGED_CASES)} "
                f"cases: causal, ALiBi, spans, soft cap + window, group "
                f"18): max_abs_err by head_dim {worst} (tol {TOL[dt]}, x "
                "max(1, max|ref row|) with ALiBi)")
            worst = {}
            with only_instance(dpa, "tensor_cores", f"decode {dt}{kv}"):
                for case in TC23_DECODE_CASES:
                    r = check_decode(gen, dt, case, kv=kv, timed=False)
                    worst[case] = float(f"{r['max_abs_err']:.3g}")
            log(f"# phase 2: {dname} {dt}{kv_label(kv)} tensor-core "
                f"instance (row slices past group 16): max_abs_err {worst} "
                f"(tol {TOL[dt]} x min(1, max|ref|), plans bounded by the "
                "longest context, the block tables and 0)")
    dt = "bfloat16"
    for path, geom in TC23_WAVES.items():
        # the routes of the timed calls (their "before" runs the others)
        nq, kvh, hd = geom["nq"], geom["kvh"], geom["hd"]
        if ragged_route(torch.bfloat16, hd, False, bool(geom.get(
                "alibi")))[2] != "tensor_cores" or not decode_launch_geometry(
                torch.bfloat16, nq // kvh, hd, H100_SMEM_OPTIN)[0]:
            raise AssertionError(f"{path}: not on the tensor-core routes")
        before = path != "falcon-7b"  # head_dim 64 ran tensor cores before
        r = check_ragged(gen, dt, geom, before=before)
        results[(rname, path, dt)] = r
        prior = (f"; the scalar instance (before) {r['before_ms']:.4f} ms "
                 f"(device {r['before_device_ms']:.4f} ms, "
                 f"{r['before_device_ms'] / r['device_ms']:.1f}x)"
                 if before else "")
        alibi = " with the bias as a float mask" if geom.get("alibi") else ""
        log(f"# phase 2: {rname} {dt} at {path}'s wave ({geom['nq']} / "
            f"{geom['kvh']} heads of {geom['hd']}"
            f"{', ALiBi' if alibi else ''}; tensor cores): max_abs_err "
            f"{r['max_abs_err']:.3g}; kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f} ms){prior}; plain {r['plain_ms']:.4f} "
            f"ms, sdpa{alibi} {r['library_ms']:.4f} ms (device "
            f"{r['library_device_ms']:.4f} ms, the kernel "
            f"{r['device_ms'] / r['library_device_ms']:.2f}x), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        r = check_decode(gen, dt, path, before=True)
        results[(dname, path, dt)] = r
        log(f"# phase 2: {dname} {dt} at {path}'s step: the kernel "
            f"{r['device_ms'] / r['library_device_ms']:.2f}x sdpa's device "
            f"time, the CUDA-core instance "
            f"{r['before_device_ms'] / r['device_ms']:.1f}x the kernel's")


# Phase 36's tiny fp16 models on the new routes: a BLOOM at BLOOM-3b's
# head_dim 80 (ALiBi, the ragged kernel in 128-wide tiles) and a
# Falcon-7B-style multi-query model with 18 query heads of 64 on one KV
# head (the decode kernel in two row slices).
TC23_TINY = {
    "bloom-hd80": dict(architectures=["BloomForCausalLM"],
                       model_type="bloom", hidden_size=320, n_head=4,
                       n_layer=2, vocab_size=512),
    "falcon-mqa-group18": dict(
        architectures=["FalconForCausalLM"], model_type="falcon",
        hidden_size=1152, num_attention_heads=18, num_hidden_layers=2,
        alibi=False, parallel_attn=True, multi_query=True, bias=False,
        vocab_size=512),
}
# Phase 36's runs: (model, kv_cache_dtype).
TC23_PARITY = {"bloom-hd80/auto": ("bloom-hd80", "auto"),
               "bloom-hd80/fp8_e4m3": ("bloom-hd80", "fp8_e4m3"),
               "falcon-mqa-group18/auto": ("falcon-mqa-group18", "auto")}


def tc_route_parity() -> None:
    """Phase 36: fp16 greedy runs of ``TC23_PARITY`` through the port on
    the card and on the CPU from one seed (``redraw_flexible``; the CPU's
    weights loaded on the card), a 16-token batch budget (chunked prefill)
    and 8-step decode windows on the decode kernel. Tokens equal but where
    the runs part at a gap below ``GAP`` (``same_tokens``); chosen logprobs
    within ``F16_LOGPROB_TOL`` where they agree; the ragged and decode
    kernels' card launches exactly their CPU twins' calls (``CallSpy``),
    every one on the tensor-core instances (``instance_launches["scalar"]
    == 0``)."""
    from aphrodite_tpu_torch import LLM, SamplingParams
    from aphrodite_tpu_torch.ops.decode_paged_attention import (
        decode_paged_attention)
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention)
    kernels = {"ragged_paged_attention": ragged_paged_attention,
               "decode_paged_attention": decode_paged_attention}
    rng = np.random.RandomState(36)
    prompts = [rng.randint(1, 500, size=n).tolist()
               for n in (5, 40, 17, 33, 70)]
    params = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)
    for run, (model, kv) in TC23_PARITY.items():
        kw = dict(hf_config=TC23_TINY[model], tokenizer="unused",
                  dtype="float16", kv_cache_dtype=kv, block_size=16,
                  num_kv_blocks=128, max_num_seqs=4,
                  max_num_batched_tokens=16, max_model_len=256,
                  decode_window=8)
        cpu = LLM(f"tiny-{model}-fp16", device="cpu", **kw)
        redraw_flexible(cpu.engine.core.worker.model, 36)
        gpu = LLM(f"tiny-{model}-fp16", device="cuda", **kw)
        gpu.engine.core.worker.load_params(
            cpu.engine.core.worker.model.state_dict())
        with CallSpy() as want:
            a = traced(cpu, prompts, params)
        for fn in kernels.values():
            fn.launches = 0
            fn.instance_launches = dict.fromkeys(fn.instance_launches, 0)
        with CallSpy() as calls:
            b = traced(gpu, prompts, params)
        got = {k: fn.launches for k, fn in kernels.items()}
        by_inst = {k: dict(fn.instance_launches)
                   for k, fn in kernels.items()}
        if any(got[k] != want.calls[k] or got[k] != calls.calls[k]
               or got[k] <= 0 or by_inst[k]["scalar"]
               or by_inst[k]["tensor_cores"] != got[k] for k in got):
            raise AssertionError(
                f"phase 36 {run}: launches {got}, by instance {by_inst}; "
                f"the card's calls {calls.calls}, the CPU's {want.calls}")
        if len({t for x in a[0] for t in x}) <= 10:
            raise AssertionError(f"phase 36 {run}: the tokens hardly vary: "
                                 f"{a[0]}")
        found = same_tokens(f"phase 36 {run}", cpu, gpu, prompts, a, b)
        gaps = [abs(float(la[i][t]) - float(lb[i][t]))
                for ta, tb, la, lb in zip(a[0], b[0], a[1], b[1])
                for i, t in enumerate(ta) if ta[:i + 1] == tb[:i + 1]]
        worst = max(gaps)
        if not worst <= F16_LOGPROB_TOL:
            raise AssertionError(f"phase 36 {run}: chosen logprobs card vs "
                                 f"CPU up to {worst:.4g} > {F16_LOGPROB_TOL}")
        log(f"# phase 36: {run}: cuda == cpu greedy fp16 tokens for "
            f"{len(prompts)} prompts x 24 but at partings (request, step, "
            f"cpu token, card token, gap < {GAP}) {found}; chosen logprobs "
            f"within {worst:.4g} (tol {F16_LOGPROB_TOL}) over {len(gaps)} "
            f"agreeing tokens; launches {got} (= the CPU's calls), all on "
            f"the tensor-core instances")
        del cpu, gpu


def main_path_tc_route(phase: str, name: str, hf: dict,
                       alibi: bool) -> dict:
    """Phase 37 (BLOOM-3b, ``BLOOM_3B``, full width and depth) or 38
    (Falcon-7B, ``FALCON_7B_HALF``) in bf16 with seeded dummy weights,
    phase 6's traffic: one 16384-token wave on the ragged kernel, then one
    63-step window through the non-window multi-step path (the decode
    kernel once a layer a sub-step). In every cold and warm run: ragged
    exactly L and decode exactly L x 63 launches, every one on the
    tensor-core instances (none on the scalar ones), each carrying the
    model's ALiBi slopes (BLOOM) or none (Falcon's rope), and the window
    kernel never."""
    from aphrodite_tpu_torch.ops.decode_paged_attention import (
        decode_paged_attention as dpa)
    from aphrodite_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention as rpa)
    L = hf.get("n_layer") or hf["num_hidden_layers"]
    steps = 63
    with SlopeSpy("ragged_paged_attention") as rs, \
            SlopeSpy("decode_paged_attention") as ds:
        counts = serve_workload(
            phase, name, hf,
            {"decode_paged_attention": dpa, **attention_kernels(),
             "ragged with slopes": rs, "decode with slopes": ds,
             **{f"{k} {i}": InstanceCount(fn, i)
                for k, fn in (("ragged", rpa), ("decode", dpa))
                for i in ("tensor_cores", "scalar")}},
            exact={"ragged_paged_attention": L,
                   "decode_paged_attention": L * steps,
                   "window_decode_attention": 0,
                   "ragged tensor_cores": L, "ragged scalar": 0,
                   "decode tensor_cores": L * steps, "decode scalar": 0,
                   "ragged with slopes": L if alibi else 0,
                   "decode with slopes": L * steps if alibi else 0})[0]
    if alibi and (rs.without or ds.without):
        raise AssertionError(f"{phase}: {rs.without} ragged and "
                             f"{ds.without} decode calls without slopes")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from aphrodite_tpu_torch.ops import cuda_build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"# card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    if sys.argv[1:2] == ["--ab"]:
        return compare_serving(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--variants"]:
        return w4_variants(sys.argv[2:])
    if sys.argv[1:2] == ["--span-builds"]:
        return span_build_times()
    names = KERNEL_SOURCES
    log(f"# phase 1: kernels built in {cuda_build.build_all(names):.1f} s")
    for n in names:
        for line in cuda_build.ptxas_report(n).splitlines():
            if "entry function" in line:  # keep the template arguments
                log(f"# ptxas {n}: ...{line.strip()[-72:]}")
            elif "Function properties" not in line and any(
                    k in line for k in ("registers", "spill", "wgmma",
                                        "setmaxnreg", "arning")):
                log(f"# ptxas {n}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dt in ("float32", "bfloat16"):
        for path, geom in ATTN_GEOMS.items():
            for name, fn in (("ragged_paged_attention", check_ragged),
                             ("window_decode_attention", check_window)):
                r = fn(gen, dt, geom)
                extra = (f" (device {r['device_ms']:.4f} ms" + (
                    f", host {r['host_ms']:.4f} ms a call"
                    if "host_ms" in r else "") + ")")
                log(f"# phase 2: {name} {dt} at {path} shapes: max_abs_err "
                    f"{r['max_abs_err']:.3g} (tol {tol_text(name, dt)}); "
                    f"kernel "
                    f"{r['ms']:.4f} ms{extra}, plain {r['plain_ms']:.4f} ms, "
                    f"sdpa {r['library_ms']:.4f} ms (device "
                    f"{r['library_device_ms']:.4f} ms), bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
                results[(name, path, dt)] = r
        for cases, fn, name in (
                (RAGGED_MASK_CASES, check_ragged, "ragged_paged_attention"),
                (WINDOW_MASK_CASES, check_window,
                 "window_decode_attention")):
            for case, geom in cases.items():
                err = fn(gen, dt, geom, timed=False)
                log(f"# phase 2: {name} {dt} {case}: max_abs_err {err:.3g} "
                    f"(tol {tol_text(name, dt)})")
        for name in QUANT_KERNELS:
            r = check_quant(gen, name, dt)
            log(f"# phase 2: {name} {dt}, a layer's 4 GEMMs: max_abs_err"
                f" {r['max_abs_err']:.3g} (tol {TOL[dt]}); kernel "
                f"{r['ms']:.4f} ms (device {r['device_ms']:.4f} ms, host "
                f"{r['host_ms']:.4f} ms a layer), plain "
                f"{r['plain_ms']:.4f} ms, {r['library']} "
                f"{r['library_ms']:.4f} ms (device "
                f"{r['library_device_ms']:.4f} ms), dense {dt} matmul device "
                f"{r['dense_device_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
            results[(name, dt)] = r
        for case in DECODE_CASES:
            results[("decode_paged_attention", case, dt)] = check_decode(
                gen, dt, case)
        alibi_checks(gen, dt, results)
        span_checks(gen, dt, results)
        r = check_int4(gen, dt)
        log(f"# phase 2: w4a16_int4_matmul {dt}, a Llama-3.1-8B layer's 4 "
            f"GEMMs at M=128: max_abs_err {r['max_abs_err']:.3g} (tol "
            f"{TOL[dt]}, M 65 and 256 too); kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f} ms, host {r['host_ms']:.4f} ms a layer), "
            f"plain {r['plain_ms']:.4f} ms, {r['library']} "
            f"{r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f} "
            f"ms), dense {dt} matmul device {r['dense_device_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        results[("w4a16_int4_matmul", dt)] = r
        if dt == "bfloat16":
            log(f"# phase 2: w4_wgmma (bf16 int4 and packed at "
                f"{len(W4_CASES)} cases, uint4 and w8 at {len(BYTE_CASES)}): "
                f"max_abs_err {check_w4_wgmma(gen):.3g} (tol {TOL[dt]}), two "
                "launches bit-equal")
            for name, (path, shapes) in BYTE_PATHS.items():
                r = check_quant(gen, name, dt, shapes)
                log(f"# phase 2: {name} {dt} at {path}, a layer's 4 GEMMs: "
                    f"max_abs_err {r['max_abs_err']:.3g} (tol {TOL[dt]}); "
                    f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f} "
                    f"ms, host {r['host_ms']:.4f} ms a layer), plain "
                    f"{r['plain_ms']:.4f} ms, {r['library']} "
                    f"{r['library_ms']:.4f} ms (device "
                    f"{r['library_device_ms']:.4f} ms), dense {dt} matmul "
                    f"device {r['dense_device_ms']:.4f} ms, bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
                results[(name, path, dt)] = r
        (results[("shared_prefix_attention", dt)],
         results[("window_decode_attention", "cascade", dt)]) = \
            check_cascade(gen, dt)
        r = check_grouped(gen, dt)
        log(f"# phase 2: grouped_matmul {dt}, a MoE layer's 2 GEMMs over a "
            f"wave (M=65536, balanced): max_abs_err {r['max_abs_err']:.3g} "
            f"(tol {TOL[dt]}, all cases); kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f} ms, host {r['host_ms']:.4f} ms a call), "
            f"plain {r['plain_ms']:.4f} ms, {r['library']} "
            f"{r['library_ms']:.4f} ms, dense matmul of the same operations "
            f"{r['dense_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        results[("grouped_matmul", dt)] = r
        fp8_attention_checks(gen, dt, results)
        shapes = LLAMA8B_GEMMS if dt == "bfloat16" else QWEN_GEMMS
        model = "Llama-3.1-8B" if dt == "bfloat16" else "Qwen2.5-1.5B"
        r = check_fp8(gen, dt, shapes)
        log(f"# phase 2: fp8_matmul {dt} (kFp8 in bf16, qmm_kernel's e4m3 "
            f"case in fp32), a {model} layer's 4 GEMMs at M=32: max_abs_err "
            f"{r['max_abs_err']:.3g} (tol {TOL[dt]}, M 1-200 and the row "
            f"scales too); kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f} ms, host {r['host_ms']:.4f} ms a layer), "
            f"with row scales {r['rs_ms']:.4f} ms (device "
            f"{r['rs_device_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
            f"torch._scaled_mm (row-wise, e4m3 x) "
            + (f"{r['scaled_mm_ms']:.4f} ms (device "
               f"{r['scaled_mm_device_ms']:.4f} ms)"
               if r['scaled_mm_ms'] is not None else "unavailable")
            + f", dense {dt} matmul (library_ms) {r['dense_ms']:.4f} ms "
            f"(device {r['dense_device_ms']:.4f} ms), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        results[("fp8_matmul", dt)] = r
    log(f"# phase 2: w4_wgmma fp8 (kFp8) at {len(FP8_CASES)} cases, with "
        f"and without row scales: max_abs_err {check_fp8_layout(gen):.3g} "
        f"(tol {TOL['bfloat16']}), two launches bit-equal")
    log(f"# phase 2: {check_fp8_bytes()}")
    log(f"# phase 2: {check_int_mm()}")
    r = check_scan(gen)
    log(f"# phase 2: selective_scan fp32 at the Mamba-2.8B wave (T=4096, "
        f"C={SCAN_COLUMNS}): max_abs_err {r['max_abs_err']:.3g} (must be "
        f"0); kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}); no library call")
    results[("selective_scan", "float32")] = r
    stamp("phase 2: the MLA instances")
    mla_checks(gen, results)
    stamp("phase 2: the sampler's kernels")
    results[("gumbel_sample", "float32")] = check_gumbel(gen)
    results[("history_pass", "float32")] = check_history(gen)
    stamp("phase 2: the W4 prefill product")
    check_prefill_w4(gen)
    stamp("phase 2: the fp16 instances")
    fp16_checks(gen, results)
    stamp("phase 2: the fp16 GEMM instances")
    fp16_gemm_checks(gen, results)
    stamp("phase 2: the fp16 grouped GEMM and MLA instances")
    moe_mla_fp16_checks(gen, results)
    stamp("phase 2: the ragged kernel's last options")
    ragged_option_checks(gen, results)
    stamp("phase 2: the tensor-core routes at other geometries")
    tc_route_checks(gen, results)
    tiny_parity()
    qwen_counts = main_path()
    log(f"# phase 4: attention launches per run {qwen_counts}")
    quant_counts = quant_parity()
    stamp("phase 19")
    sample_parity_launches = sample_parity()
    log(f"# phase 19: launches on the card runs {sample_parity_launches}")
    stamp("phase 6")
    llama_counts, sampled_counts, llama_walls = main_path_8b()
    gc.collect()
    torch.cuda.empty_cache()
    stamp("phase 7")
    moe_parity()
    moe_counts = main_path_moe()
    ssm_parity()
    mamba_counts = main_path_mamba()
    gemma_parity()
    gemma_counts = main_path_gemma()
    int4_parity_launches = int4_cascade_parity()
    cascade_counts = main_path_int4_cascade()
    w8_counts = main_path_w8()
    qwen7b_counts = main_path_qwen7b_gptq()
    stamp("phase 17")
    fp8_parity_launches = fp8_parity()
    stamp("phase 18")
    fp8_counts = main_path_fp8()
    stamp("phase 21")
    flex_parity_launches = flexible_parity()
    stamp("phase 22")
    baichuan_counts = main_path_baichuan()
    stamp("phase 23")
    ds_parity_launches = deepseek_parity()
    log(f"# phase 23: launches on the card runs {ds_parity_launches}")
    stamp("phase 24")
    deepseek_counts = main_path_deepseek()
    stamp("phase 27")
    deepseek_fp8_counts = main_path_deepseek("fp8_e4m3")
    stamp("phase 25")
    mm_parity_launches = mm_parity()
    stamp("phase 26")
    gemma3_counts = main_path_gemma3_mm(layers=GEMMA3_HALF_DEPTH)
    stamp("phase 28")
    f16_parity_launches = fp16_parity()
    stamp("phase 29")
    f16_counts, f16_shared_counts = main_path_llama2_fp16()
    stamp("phase 30")
    f16_gemm_parity = fp16_quant_parity()
    stamp("phase 31")
    f16_gemm_counts = main_path_awq_fp16(llama_walls)
    stamp("phase 32")
    f16_moe_parity = moe_mla_fp16_parity()
    stamp("phase 33")
    f16_ds_counts = main_path_deepseek(dtype="float16")
    stamp("phase 34")
    f16_mm_parity = mm_fp16_parity()
    stamp("phase 35")
    f16_g3_counts = main_path_gemma3_mm(dtype="float16",
                                        layers=GEMMA3_HALF_DEPTH)
    stamp("phase 36")
    tc_route_parity()
    stamp("phase 37")
    bloom_counts = main_path_tc_route("phase 37", "bloom-3b-dummy", BLOOM_3B,
                                      alibi=True)
    stamp("phase 38")
    falcon_counts = main_path_tc_route("phase 38", "falcon-7b-dummy",
                                       FALCON_7B_HALF, alibi=False)
    stamp("the kernels' record")

    # One row per kernel and path that runs it: that path's launches, and
    # times and errors at its shapes and activation dtype.
    rows = [(name, path, "bfloat16", counts[name], results[(name, path,
                                                             "bfloat16")])
            for path, counts in (("qwen2.5-1.5b-bf16", qwen_counts),
                                 ("llama-3.1-8b-w4a16", llama_counts),
                                 ("qwen1.5-moe-a2.7b-bf16", moe_counts),
                                 ("qwen2.5-7b-gptq", qwen7b_counts))
            for name in ("ragged_paged_attention", "window_decode_attention")]
    # Phase 15 runs the attention of phase 6's shapes.
    rows += [(name, "llama-3.1-8b-w8a16", "bfloat16", w8_counts[name],
              results[(name, "llama-3.1-8b-w4a16", "bfloat16")])
             for name in ("ragged_paged_attention", "window_decode_attention")]
    rows += [(name, path, "bfloat16", counts[name],
              results[(name, path, "bfloat16")])
             for (name, (path, _)), counts in zip(
                 BYTE_PATHS.items(), (w8_counts, qwen7b_counts))]
    rows.append(("ragged_paged_attention", "gemma-2-9b-bf16", "bfloat16",
                 gemma_counts["ragged_paged_attention"],
                 results[("ragged_paged_attention", "gemma-2-9b-bf16",
                          "bfloat16")]))
    rows.append(("decode_paged_attention", "gemma-2-9b-bf16", "bfloat16",
                 gemma_counts["decode_paged_attention"],
                 results[("decode_paged_attention", "gemma-2-9b",
                          "bfloat16")]))
    rows.append(("w4a16_packed_matmul", "llama-3.1-8b-w4a16", "bfloat16",
                 llama_counts["w4a16_packed_matmul"],
                 results[("w4a16_packed_matmul", "bfloat16")]))
    rows.append(("grouped_matmul", "qwen1.5-moe-a2.7b-bf16", "bfloat16",
                 moe_counts["grouped_matmul"],
                 results[("grouped_matmul", "bfloat16")]))
    rows += [(name, "qwen-2l-quant-parity-fp32", "float32",
              quant_counts[name], results[(name, "float32")])
             for name in ("w4a16_matmul", "w8a16_matmul")]
    rows.append(("selective_scan", "mamba-2.8b-bf16", "float32",
                 mamba_counts["selective_scan"],
                 results[("selective_scan", "float32")]))
    cascade_path = "llama-3.1-8b-int4-cascade"
    rows += [
        ("ragged_paged_attention", cascade_path, "bfloat16",
         cascade_counts["ragged_paged_attention"],
         results[("ragged_paged_attention", cascade_path, "bfloat16")]),
        ("window_decode_attention", cascade_path, "bfloat16",
         cascade_counts["window_decode_attention"],
         results[("window_decode_attention", "cascade", "bfloat16")]),
        ("shared_prefix_attention", cascade_path, "bfloat16",
         cascade_counts["shared_prefix_attention"],
         results[("shared_prefix_attention", "bfloat16")]),
        ("w4a16_int4_matmul", cascade_path, "bfloat16",
         cascade_counts["w4a16_int4_matmul"],
         results[("w4a16_int4_matmul", "bfloat16")]),
        ("w4a16_int4_matmul", "llama-2048-int4-cascade-parity-fp32",
         "float32", int4_parity_launches,
         results[("w4a16_int4_matmul", "float32")])]
    replaces = {"ragged_paged_attention":
                "aphrodite_tpu/ops/ragged_paged_attention.py:247",
                "window_decode_attention":
                "aphrodite_tpu/ops/window_decode_attention.py:198",
                "decode_paged_attention":
                "aphrodite_tpu/ops/decode_paged_attention.py:138",
                # megablox gmm (jax/experimental/pallas/ops/tpu/megablox/
                # gmm.py:314), called here:
                "grouped_matmul": "aphrodite_tpu/models/moe_common.py:208",
                "selective_scan": "aphrodite_tpu/ops/selective_scan.py:64",
                "shared_prefix_attention":
                "aphrodite_tpu/ops/cascade_attention.py:118",
                "w4a16_int4_matmul":
                "aphrodite_tpu/ops/quant_matmul_pallas.py:290",
                **{n: r for n, (r, _) in QUANT_KERNELS.items()}}
    rows = [(*row, "auto") for row in rows]
    # The slice's kernels: kFp8 (phase 18, and qmm_kernel's e4m3 case in
    # phase 17's fp32 runs) and the fp8-cache instances of the attention
    # kernels on the paths that run them.
    fp8_path, e4, e5 = "llama-3.1-8b-fp8", "float8_e4m3fn", "float8_e5m2"
    rows.append(("fp8_matmul", fp8_path, "bfloat16",
                 fp8_counts["fp8_matmul"], results[("fp8_matmul",
                                                    "bfloat16")], "auto"))
    rows += [(name, fp8_path, "bfloat16", fp8_counts[name],
              results[(name, "llama-3.1-8b-w4a16", "bfloat16", e4)], e4)
             for name in ("ragged_paged_attention", "window_decode_attention")]
    rows.append(("fp8_matmul", "qwen-2l-fp8-parity-fp32", "float32",
                 sum(fp8_parity_launches[("fp8_matmul", f"{q}/{k}")]
                     for q, k in FP8_PARITY), results[("fp8_matmul",
                                                       "float32")], "auto"))
    for q, k in FP8_PARITY:
        kv = e4 if k == "fp8_e4m3" else e5
        rows += [(name, f"qwen-2l-{q}-{k}-parity-fp32", "float32",
                  fp8_parity_launches[(name, f"{q}/{k}")],
                  results[(name, "qwen2.5-1.5b-bf16", "float32", kv)], kv)
                 for name in ("ragged_paged_attention",
                              "window_decode_attention")]
    rows.append(("decode_paged_attention", "gemma2-tiny-fp8-parity-fp32",
                 "float32", fp8_parity_launches[("decode_paged_attention",
                                                 "gemma2/fp8_e4m3")],
                 results[("decode_paged_attention", "gemma-2-9b", "float32",
                          e4)], e4))
    rows.append(("shared_prefix_attention", "int4-cascade-fp8-parity-fp32",
                 "float32", fp8_parity_launches[("shared_prefix_attention",
                                                 "int4-cascade/fp8_e4m3")],
                 results[("shared_prefix_attention", "float32", e4)], e4))
    replaces["fp8_matmul"] = "aphrodite_tpu/ops/quant_gemm.py:74"
    # The sampler slice's kernels on phase 20's path (phase 2's shapes).
    rows += [(name, "llama-3.1-8b-w4a16-sampled", dt,
              sampled_counts[name], results[(name, dt)], "auto")
             for name, dt in (("gumbel_sample", "float32"),
                              ("history_pass", "float32"))]
    replaces["gumbel_sample"] = "aphrodite_tpu/sample/sampler.py:494"
    # _suffix_match_lengths, _apply_dry, _apply_no_repeat_ngram and
    # _apply_penalties (sampler.py:38-167), which XLA fuses in JAX.
    replaces["history_pass"] = "aphrodite_tpu/sample/sampler.py:38"
    # The ALiBi slice: both attention kernels with the slopes on phase 22's
    # path, and their fp32 instances on phase 21's (timed at phase 22's
    # shapes, as the other fp32 parity rows are at a full-width path's).
    for path, dt, counts in (
            ("baichuan2-13b-bf16", "bfloat16", baichuan_counts),
            ("flexible-tiny-alibi-parity-fp32", "float32",
             flex_parity_launches)):
        rows += [
            ("ragged_paged_attention", path, dt,
             counts["ragged_paged_attention"],
             results[("ragged_paged_attention", "baichuan2-13b-bf16", dt)],
             "auto"),
            ("decode_paged_attention", path, dt,
             counts["decode_paged_attention"],
             results[("decode_paged_attention", "baichuan2-13b-alibi", dt)],
             "auto")]
    # The MLA slice: both attention kernels' MLA instances and the grouped
    # GEMM on phase 24's path (phase 2's shapes; the V3 geometry's times
    # are in the log).
    ds_path = "deepseek-v2-lite-bf16"
    rows += [(f"{name}_mla", ds_path, "bfloat16",
              deepseek_counts[f"{kind} mla"],
              results[(f"{name}_mla", ds_path, "bfloat16")], "auto")
             for name, kind in (("ragged_paged_attention", "ragged"),
                                ("window_decode_attention", "window"))]
    rows.append(("grouped_matmul", ds_path, "bfloat16",
                 deepseek_counts["grouped_matmul"],
                 results[("grouped_matmul", ds_path, "bfloat16")], "auto"))
    # The fp8 MLA slice: both MLA instances' e4m3 ones on phase 27's path.
    rows += [(f"{name}_mla", "deepseek-v2-lite-bf16-fp8-e4m3", "bfloat16",
              deepseek_fp8_counts[f"{kind} mla"],
              results[(f"{name}_mla", ds_path, "bfloat16", e4)], e4)
             for name, kind in (("ragged_paged_attention", "ragged"),
                                ("window_decode_attention", "window"))]
    for name in ("ragged_paged_attention", "window_decode_attention"):
        replaces[f"{name}_mla"] = replaces[name]
    # The vision slice: the ragged kernel's span instances on phase 26's
    # path (the tensor-core one) and phase 25's (the scalar one in fp32,
    # timed at phase 26's wave), and the decode kernel at phase 26's step.
    g3_path, g3_rpa = "gemma-3-4b-it-bf16", "ragged_paged_attention"
    rows += [(f"{g3_rpa}_spans", path, dt, launches,
              results[(g3_rpa, g3_path, dt)], "auto")
             for path, dt, launches in (
                 (g3_path, "bfloat16", gemma3_counts["ragged spans"]),
                 ("mm-tiny-parity-fp32", "float32",
                  mm_parity_launches["ragged spans"]))]
    rows.append(("decode_paged_attention", g3_path, "bfloat16",
                 gemma3_counts["decode_paged_attention"],
                 results[("decode_paged_attention", "gemma-3-4b",
                          "bfloat16")], "auto"))
    replaces[f"{g3_rpa}_spans"] = replaces[g3_rpa]
    # The fp16 slice: the fp16 tensor-core instances on phase 29's path
    # (phase 2's shapes), on phase 28's fp8-cache runs (phase 2's shapes
    # on those caches) and on its BLOOM run (ALiBi; the decode kernel at 32
    # heads of 128).
    f16, rpa, wda, spa, dpa = ("float16", "ragged_paged_attention",
                               "window_decode_attention",
                               "shared_prefix_attention",
                               "decode_paged_attention")
    rows += [(name, F16_PATH, f16, f16_counts[name],
              results[(name, F16_PATH, f16, None)], "auto")
             for name in (rpa, wda)]
    rows += [(name, F16_SHARED_PATH, f16, f16_shared_counts[name],
              results[(name, F16_SHARED_PATH, f16, None)], "auto")
             for name in (spa, wda)]
    for kv_name, kvd in (("fp8_e4m3", e4), ("fp8_e5m2", e5)):
        run = f"llama/{kv_name}"
        rows += [(name, f"llama-tiny-fp16-{kv_name}-parity", f16,
                  f16_parity_launches[(name, run)],
                  results[(name, path, f16, kvd)], kvd)
                 for name, path in ((rpa, F16_PATH), (wda, F16_PATH),
                                    (spa, F16_SHARED_PATH))]
    rows += [(rpa, "bloom-tiny-fp16-parity", f16,
              f16_parity_launches[(rpa, "bloom/auto")],
              results[(rpa, f"{F16_PATH}-alibi", f16, None)], "auto"),
             (dpa, "bloom-tiny-fp16-parity", f16,
              f16_parity_launches[(dpa, "bloom/auto")],
              results[(dpa, "alibi-32x128", f16, None)], "auto")]
    # The fp16 GEMM slice: each layout's fp16 instance on phase 31's path
    # (packed) and on phase 30's runs (the others), at phase 2's shapes.
    rows.append(("w4a16_packed_matmul", F16_GEMM_PATH, f16,
                 f16_gemm_counts["w4a16_packed_matmul float16"],
                 results[("w4a16_packed_matmul", f16)], "auto"))
    rows += [(name, F16_GEMM_PARITY_PATH, f16, f16_gemm_parity[name],
              results[(name, f16)], "auto")
             for name in ("w4a16_int4_matmul", "w4a16_matmul",
                          "w8a16_matmul", "fp8_matmul")]
    # The fp16 MoE and MLA slice: the grouped GEMM's and both MLA
    # instances' fp16 ones on phase 33's path (phase 2's V2-Lite shapes),
    # the grouped GEMM's on phase 32's runs (phase 8's shapes), and the MLA
    # instances' fp16 ones on phase 32's fp8-cache runs (phase 2's V2-Lite
    # shapes on those caches).
    rows.append(("grouped_matmul", F16_DS_PATH, f16,
                 f16_ds_counts["grouped float16"],
                 results[("grouped_matmul", F16_DS_PATH, f16)], "auto"))
    rows.append(("grouped_matmul", F16_MOE_PARITY_PATH, f16,
                 sum(f16_moe_parity[("grouped_matmul", run)]
                     for run in F16_MOE_PARITY),
                 results[("grouped_matmul", f16)], "auto"))
    rows += [(f"{name}_mla", F16_DS_PATH, f16, f16_ds_counts[f"{kind} mla"],
              results[(f"{name}_mla", ds_path, f16, None)], "auto")
             for name, kind in ((rpa, "ragged"), (wda, "window"))]
    for run, kvd in (("deepseek-v3/fp8_e4m3", e4),
                     ("deepseek-v2/fp8_e5m2", e5)):
        rows += [(f"{name}_mla", f"{F16_MOE_PARITY_PATH}-{run}", f16,
                  f16_moe_parity[(name, run)],
                  results[(f"{name}_mla", ds_path, f16, kvd)], kvd)
                 for name in (rpa, wda)]
    # The slice of the ragged kernel's last options: the fp16 decode
    # instance at head_dim 256 on phase 35's path (phase 2's step), the
    # fp16 span instances on phase 35's path (the tensor-core ones, phase
    # 2's wave)
    # and on phase 34's runs (on e4m3 at the wave; at head_dim 32 in
    # 64-wide tiles, timed at phase 2's hd-32 case); ALiBi beside spans
    # and the MLA option instances, which no model's path reaches: 0
    # launches, phase 2 alone holds them.
    g3_f16 = "gemma-3-4b-it-fp16"
    rows.append((dpa, g3_f16, f16, f16_g3_counts[dpa],
                 results[(dpa, "gemma-3-4b", f16)], "auto"))
    source_of = {}
    for name, path, dt, launches, r, kv, src in (
            (f"{g3_rpa}_spans", g3_f16, f16,
             f16_g3_counts["ragged spans"],
             results[(g3_rpa, g3_path, f16)], "auto", "ragged_spans_f16"),
            (f"{g3_rpa}_spans", "gemma3-tiny-hd64-fp16-fp8_e4m3-parity", f16,
             f16_mm_parity[(g3_rpa, "gemma3-hd64/fp8_e4m3")],
             results[(g3_rpa, g3_path, f16, e4)], e4, "ragged_spans_f16"),
            (f"{g3_rpa}_spans", "gemma3-tiny-hd32-fp16-parity", f16,
             f16_mm_parity[(g3_rpa, "gemma3/auto")],
             results[(g3_rpa, "mm-tiny-hd32", f16)], "auto",
             "ragged_spans_f16"),
            (f"{g3_rpa}_spans_alibi", "none (phase 2 only)", "bfloat16", 0,
             results[(g3_rpa, "gemma-3-4b-it-alibi", "bfloat16")], "auto",
             "ragged_spans"),
            (f"{g3_rpa}_spans_alibi", "none (phase 2 only)", f16, 0,
             results[(g3_rpa, "gemma-3-4b-it-alibi", f16)], "auto",
             "ragged_spans_f16"),
            (f"{g3_rpa}_mla_options", "none (phase 2 only)", "bfloat16", 0,
             results[(f"{g3_rpa}_mla", "deepseek-v2-lite-spans",
                      "bfloat16")], "auto", "mla_opts"),
            (f"{g3_rpa}_mla_options", "none (phase 2 only)", f16, 0,
             results[(f"{g3_rpa}_mla", "deepseek-v2-lite-spans", f16)],
             "auto", "mla_opts_f16")):
        rows.append((name, path, dt, launches, r, kv))
        source_of[(name, path, dt)] = src
    for name in (f"{g3_rpa}_spans_alibi", f"{g3_rpa}_mla_options"):
        replaces[name] = replaces[g3_rpa]
    # The slice of the tensor-core routes at other geometries: the ragged
    # and decode kernels' tensor-core instances on phase 37's path
    # (BLOOM-3b, head_dim 80 in 128-wide tiles, ALiBi), phase 38's
    # (Falcon-7B: group 71, the decode kernel in row slices), and at
    # MPT-30B's geometry (head_dim 112), which no phase serves.
    b16 = "bfloat16"
    for path, counts, shapes in (("bloom-3b-bf16", bloom_counts, "bloom-3b"),
                                 ("falcon-7b-bf16", falcon_counts,
                                  "falcon-7b")):
        rows += [(name, path, b16, counts[name], results[(name, shapes, b16)],
                  "auto") for name in (rpa, dpa)]
    rows += [(name, "mpt-30b-bf16 (phase 2 only)", b16, 0,
              results[(name, "mpt-30b", b16)], "auto") for name in (rpa, dpa)]
    kernels = []
    for name, path, dt, launches, r, kv in rows:
        src = ("quant_matmul" if name in QUANT_KERNELS
               or name in ("w4a16_int4_matmul", "fp8_matmul") else name)
        if name.endswith("_mla"):
            src = "mla_attention" if dt != "float16" else "mla_attention_f16"
        if name == "grouped_matmul" and dt == "float16":
            src = "grouped_matmul_f16"
        if name.endswith("_spans"):  # the tensor-core or scalar instance
            src = ("ragged_spans" if dt == "bfloat16"
                   else "ragged_paged_attention")
        if name == "ragged_paged_attention" and dt == "float16":
            src = "ragged_f16"  # the fp16 tensor-core instances
        if name in ("w4a16_int4_matmul", "w4a16_packed_matmul", "fp8_matmul",
                    *BYTE_PATHS) and dt in ("bfloat16", "float16"):
            src = "w4_wgmma" if dt == "bfloat16" else "w4_wgmma_f16"
        src = source_of.get((name, path, dt), src)
        kernels.append({
            "name": name, "path": path, "dtype": dt, "kv_cache": kv,
            "route": "cuda",
            "source": f"aphrodite_tpu_torch/csrc/{src}.cu",
            "replaces": replaces[name], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
