"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``interactive_vit_tpu_torch`` through its main paths and fails
(non-zero exit, no result line) on the first phase that goes wrong:

1. device  -- a CUDA card must be present; TF32 is turned off; prints the
   card's name and power limit as ``nvidia-smi`` reports them.
2. build   -- builds the twenty-three hand-written kernel sources from
   ``csrc/`` with nvcc, one compiler process each, all at once, and beside
   them the host library with g++ (``runtime/build.py``) (the
   whole-image block is ``fused_attn_block.cu`` (FMA, ``__dp4a``),
   ``fused_attn_block_mma.cu`` (bf16 tensor cores) and
   ``fused_attn_block_tf32.cu`` (f32 on split TF32), its s8 and ToMe modes
   modes of each, the tensor-core routes' s8 attention on int8 mma.sync in
   ``attn_block_s8.cuh``; the two
   trainable attentions share ``flash_attention.cu`` forward and
   ``attention_bwd.cu`` backward on their FMA route,
   ``attention_train_mma.cu`` on their bf16 tensor-core route and
   ``flash_attention_tf32.cu`` forward and ``attention_train_tf32.cu``
   backward on their f32 split-TF32 route; the row-resident flash
   attention is ``flash_attention.cu`` (FMA), ``flash_attention_mma.cu``
   (bf16 tensor cores) and ``flash_attention_tf32.cu`` (f32 on split
   TF32), the online one ``flash_attention_online.cu`` (FMA),
   ``flash_attention_online_mma.cu`` (bf16 tensor cores) and
   ``flash_attention_online_tf32.cu`` (f32 on split TF32); the headwise
   block ``headwise_attn_block.cu`` (FMA), ``headwise_attn_block_mma.cu``
   (bf16 tensor cores) and ``headwise_attn_block_tf32.cu`` (f32 on split
   TF32); the fused MLP ``fused_mlp_block.cu`` (FMA),
   ``fused_mlp_block_mma.cu`` (bf16 tensor cores, chunks of 128 or 96
   columns) and ``fused_mlp_block_tf32.cu`` (f32 on split TF32), the W8A8
   MLP ``fused_mlp_w8a8_block.cu`` (``__dp4a``) and
   ``fused_mlp_w8a8_mma.cu`` (int8 tensor cores, chunks of 128 or 96
   columns; the three tensor-core
   sources on ``mlp_cluster.cuh``: the hidden dimension split over a
   thread-block cluster); the window
   attention ``fused_window_attn.cu`` (FMA), ``fused_window_attn_mma.cu``
   (bf16 tensor cores) and ``fused_window_attn_tf32.cu`` (f32 on split
   TF32; both tensor-core sources take row 1's QKV kernel and its
   projection without the residual from the block headers): thirty-three
   kernels, the W8A8 source's instantiation at chunks of 96 counted as
   one of them).
3. kernel  -- each kernel against its plain PyTorch version on the card,
   with max abs errors against the stated bounds (which must refuse the
   kernel's maps or mean zeroed or halved) and CUDA-event times (turns
   plain, kernel, kernel, plain):
   * the fused attention block (row 1) at the vit_b16 (B=1 and 8),
     vit_t16, vit_t16@256 (N=257) and clip_b32 (N=50) block shapes, maps
     off / maps + head-mean / a subset: bf16 on the tensor cores, f32 on
     split TF32 (the launch counts show the route), and at vit_b16 B=1, on
     a copy of x off the 16-byte grid, the FMA kernel; at clip_b32's N=50
     (no multiple of the kernels' row tiles) also x followed by NaN rows
     and the workspaces' free blocks NaN-filled, the results finite and a
     clean call's bit for bit (``check_row1_padded_rows``); device times alone
     (``time_held``, the wrapper's host time a call beside), the bound (f32
     also at the TF32 peak, the one its entry carries) and, maps off, a
     yardstick of four library
     calls (layer_norm, addmm, scaled_dot_product_attention, addmm; the
     port never calls them);
   * the headwise attention block (row 2) at the vit_l16@384 block shape
     (B=1 and 4; 16 heads 64 wide, N=577) maps off / maps + mean / heads
     (0, 7, 15) + mean, at vit_h14@742's (B=1; 16 heads 80 wide, N=2810)
     maps off / maps + mean and at vit_h14@224's (N=257) maps + mean: bf16
     on the tensor cores, f32 on split TF32 (the launch counts show the
     route); and at vit_l16@384 on a copy of x off the 16-byte grid, on the
     FMA kernel; device times of the wrapper and of row 2's kernels alone
     after QKV, each with its bound (f32 also at the TF32 peak), and
     ``scaled_dot_product_attention`` on the attention part (maps off);
   * the row-resident flash attention at the dinov2_s14_reg@518 shape (6
     heads, N=1374, dh=64) and at N=577, maps on and off, plus keys masked
     beyond n_real=1374 of N=1408 (their probs exactly 0; o and the probs
     zeroed or halved must fail their bounds): bf16 on the
     tensor-core kernel, f32 on the split-TF32 kernel and each, on a copy
     off the 16-byte grid, on the FMA kernel; the same at vit_h14@224's
     heads (16 heads 80 wide, N=257, and keys masked beyond 257 of 320):
     each dtype on its tensor-core kernel's 80-wide instantiation and, off
     the grid, on the FMA kernel (the bf16 pair's times on one line);
     ``scaled_dot_product_attention`` is timed beside it with maps off in
     both dtypes (a yardstick; the port never calls it), and f32 gives its
     bound at the TF32 peak and at the f32 FMA peak; then the plain
     attention's time beside the
     tensor-core kernel's at N = 197, 257 and 577 (the crossover of
     ``dispatch.FLASH_MIN_SEQ``); these times are the device's alone
     (``time_held``: the timed calls queue behind a spinning stream),
     with the wrapper's host time a call beside them;
   * the window attention at swin_t's four stage shapes (maps 56/28/14/7,
     widths 96/192/384/768, 3/6/12/24 heads, window 7; each at B=1 and
     B=8) and one swin_b stage (14x14, 512, 16 heads), unshifted and, where
     the stage has more than one window, shifted by 3 with the seam mask
     (masked pairs must get probs of exactly 0 in bf16), maps off and on,
     fast and exact softmax: bf16 on the tensor cores, f32 on split TF32
     (the launch counts show the route), and each shape on a copy of y off
     the 16-byte grid on the FMA kernel; device times alone beside the
     bound (f32 also at the TF32 peak); ``scaled_dot_product_attention``
     with the additive bias is timed beside the attention part in both
     dtypes (a yardstick the port never calls);
   * the fused MLP at vit_b16 (197 x 768) and at swin_t's four stages
     (3136 x 96, 784 x 192, 196 x 384, 49 x 768), each at B=1 and 8, bf16
     and f32: bf16 on the tensor-core route (chunks of 128 columns, or of
     96 for swin_t's stages 0 and 1), f32 on the split-TF32 route (two
     calls the same bits; the clusters the card holds and each shape's
     row tile and chunk logged), each with the FMA kernel beside it on a
     copy of x off the 16-byte grid; the bound must refuse a kernel that
     returned the residual alone; device times alone (``time_held``)
     beside the bound (f32 at the TF32 peak and at the f32 FMA peak), the
     plain version and five library calls as a yardstick (layer_norm,
     addmm, gelu, addmm, residual, f32 with TF32 off; the port never calls
     them);
   * the online flash attention at the dinov2_s14_reg@742 shape (6 heads,
     N=2814, dh=64; B=1 and 8, and keys masked beyond n_real=2800) on q,
     k, v views of one qkv tensor, against its plain version at JAX's key
     tile (128): bf16 on the tensor-core kernel, f32 on the split-TF32
     kernel, and both, on a copy whose rows sit off the 16-byte grid, on
     the FMA kernel they replace; ``scaled_dot_product_attention`` timed
     beside it; then at vit_h14@742's shape (16 heads 80 wide, N=2810,
     and keys masked beyond 2800): each dtype on its tensor-core kernel's
     80-wide instantiation and, off the grid, on the FMA kernel, each
     beside SDPA in its dtype and the bound (the bf16 pair's times on one
     line);
   * the W8A8 MLP at vit_b16 (197 x 768, B=1 and 8), bf16 and f32, on the
     int8 tensor-core route and, on a copy of x off the 16-byte grid, on
     the ``__dp4a`` kernel: each one's s32 accumulators equal to the exact
     products of its own int8 activations, those activations the plain
     version's but in at most 1% of places (by 1), y within its bound, two
     calls the same bits; device times alone beside ``torch._int_mm`` on
     fc1 and on fc2 (two library calls, a yardstick);
   * the s8 mode of the fused block at vit_b16 (B=1 and 8), bf16 and f32,
     maps off / maps + mean / a subset with s8 scores and PV, and maps +
     mean with s8 scores only: on the tensor-core routes (the s8
     attention on int8 mma.sync), and at B=1 off the grid on the
     ``__dp4a`` kernel; each tensor-core route's s32 sums equal to the
     exact products of its own int8 operands (si = q8 k8^T, oi = p8 v8),
     those operands the plain version's but in at most 1% of places;
   * ToMe's mode of the fused block (``key_bias`` = log of token sizes,
     ``want_metric``) at the ends of the served ladders, N=197 (B=1 and
     8), 109, 21 and 11, bf16 on the tensor cores and f32 on split TF32
     (at N=197 B=1 also the FMA kernel off the grid), maps off and maps +
     mean, and the s8 mode with both operands at N=197; the key metric
     takes y's bound, a zeroed or halved metric must fail, and so must the
     plain version without the bias;
   * the trainable attention, forward and backward (o, dq, dk, dv), in
     both layouts: ``attention_train`` on [B, H, N, dh] at vit_b16's and
     vit_t16's train shapes (B=64, 12 or 3 heads, N=197, dh=64), with keys
     masked beyond n_real=197 of N=208 (their dk, dv exactly 0) and at
     N=577; ``attention_train_packed`` on the head-major [B, N, 3D] at
     vit_b16's, the masked and the N=577 shape; bf16 on the tensor-core
     route, f32 on the split-TF32 route (each forward's saved (m, l)
     against the plain statistics) and each, off the 16-byte grid, on the
     FMA route; and ``attention_train`` at vit_h14's heads (16 heads 80
     wide, N=257): train run (f)'s B=2 and run (g)'s B=8, and keys masked
     beyond 257 of 272, in both dtypes on the 80-wide tensor-core
     instantiations and off the grid on the FMA pair; each bound refusing
     a gradient zeroed or halved;
     ``scaled_dot_product_attention`` forward + backward timed beside.
4. slice   -- fourteen paths through the HTTP server in-process, seeded random
   weights, the saved graphs copied to a temp dir (a missing chain graph
   is generated there). Each path's launch counts are set to 0 just
   before it and read just after:
   * vit_b16 (+ one vit_t16 request), bf16: ``attn`` + ``r`` on blocks
     0, 5, 11 and the logits, 5 requests in sequence and 4 at once; the
     fused block on the tensor cores in every block (12 launches a
     request; by name in the profile 12 each of the LN1 + QKV, attention
     and projection kernels and no FMA GEMM or attention kernel), the f32
     request's 12 on split TF32;
   * vit_l16 @384, bf16: ``attn`` + ``r`` on block 0, ``attn`` of heads
     (0, 7, 15) + ``r`` on block 12, ``r`` on block 23, the logits; 3 in
     sequence and 2 at once; the headwise block on the tensor cores in all
     24 blocks (the profile must show it 24 times and the FMA attention
     core never), the f32 request's 24 on split TF32;
   * dinov2_s14_reg @518, bf16: ``attn`` + ``r`` on block 0, ``r`` on
     blocks 6 and 11, the CLS features; 3 in sequence; the row-resident
     flash kernel on the tensor cores in all 12 blocks (the profile must
     show it 12 times and the FMA kernel never), the f32 request's 12 on
     the split-TF32 kernel (and none on the FMA kernel);
   * swin_t, bf16, a 240 x 300 image through the bicubic transform:
     ``attn`` on stages.0.0, stages.0.1 (shifted), stages.2.5 (window 2
     only) and stages.3.1 (heads 0, 11, 23), the logits; 5 in sequence and
     4 at once; the window kernel on the tensor cores in all 12 blocks,
     12 launches a request (kernel B by name in the profile, the FMA
     kernel never), the f32 request's 12 on split TF32;
   * dinov2_s14_reg@742, bf16: the block outputs ``o`` of blocks 0, 6 and
     11 and the CLS features, 2 in sequence; the tensor-core online kernel
     in all 12 blocks (the profile must show it 12 times and the FMA
     online kernel never), the f32 request's 12 on the split-TF32
     kernel;
   * vit_h14@742 at full depth (32 blocks, 16 heads 80 wide, N=2810), one
     f32 request (the server's default dtype) of a generated chain graph:
     the block outputs ``o`` of blocks 0, 16 and 31 and the logits, each
     within 1e-4 of its scale of the plain path (each one's absolute error
     logged beside its scale); a plain ViT's served blocks run the block
     kernels, here the headwise block on split TF32 in all 32 blocks (32
     times in the profile, the FMA attention core and the split-TF32
     online kernel never), with its device time; then one bf16 request of
     the same, the headwise block on the bf16 tensor cores in all 32
     blocks, with its client p50 and device busy;
   * vit_t16@256 from the repository's saved graph: ``attn`` + ``r`` on
     blocks 0 and 6, ``r`` on block 11, the logits; the fused block on
     the tensor cores (by name in the profile, as vit_b16), the f32
     request's on split TF32;
   * dino_s16 (ViT-S/16: 384 wide, 12 blocks, 6 heads 64 wide, N=197)
     from the repository's feature-view graph ``dino_s16.json``, bf16:
     ``pca_view`` and ``patch_sim`` on the norm output, block 11's
     ``attn`` + ``r`` (wired to ``attn_view`` and ``overlay``), the norm
     output and the CLS features; 3 in sequence and 2 at once; row 1 on
     the tensor cores in all 12 blocks (12 launches a pass, by name in the
     profile, no FMA launch), the f32 request's 12 on split TF32. A bf16
     request's views are held to the same kinds on the host from its own
     norm output (``VIEW_BOUND``; the PCA view is ill-conditioned in its
     input, so their distance from the plain path's views is logged), the
     f32 request's to the plain path at 1e-4. Then (h) patch_sim's row /
     col scrubbed through four queries, each a cache hit with no new
     capture, its heatmap the eager pass's bit for bit and within 1e-5
     of the kind on the host; (i) pca_view alone on the served norm
     output, captured: one replay's launches and device time and their
     share of the path's replay, the eigenvalue spread of its input;
   * vit_b16 ``--dtype int8w8a8 --attn int8-scores``: the vit_b16 taps, 3
     in sequence; the W8A8 MLP on the int8 tensor cores and the s8 block
     on the tensor cores (its attention on int8 mma.sync) in every block
     (12 + 12 launches a request, the ``__dp4a`` kernels none; by name in
     the profile), against the plain path with the two
     kernels' plain versions (whose quantizers round half up, as the
     kernels');
   * vit_b16 ``--dtype int8`` (weight-only): no kernel launches;
   * vit_b16_tome from the repository's saved graph (``o``, ``s`` and
     ``a`` wired along the chain), bf16: ``attn`` + ``r`` + ``merge`` on
     blocks 0, 5 and 11 and the logits, 3 in sequence and 2 at once, and
     one vit_b16_tome16 request (``merge`` etc. on block 11: N 21 -> 11);
     the block on the tensor cores with ``key_bias`` and ``want_metric``
     in all 12 blocks, 12 launches a request (by name in the profile, the
     FMA kernel none; the f32 request's on split TF32), N 197 -> 109.
     Matching decisions are
     discrete, so each request's reference is the kernel path run
     in-process, with every block's one launch held against its plain
     version on that path's own inputs (y and the metric in every block,
     probs and mean where the block's taps ask for them, within their
     bounds; no lut entry may differ in f32, and in bf16 only a near tie
     may); the f32 request must match the plain path from the image at
     1e-4; one more request, through the eager pass (a replay calls no
     Python), logs the host time spent in the matching, the merges and
     the merge map;
   * clip_b32 (CLIP ViT-B/32's image tower, BASELINE config 4) from the
     repository's saved graph, bf16: ``attn`` on blocks 0 and 11 and the
     L2-normalised embedding (its norm 1 within 2^-8 in bf16, 1e-5 in
     f32); 3 in sequence and 2 at once; row 1 on the tensor cores in all
     12 blocks at N=50 (12 launches a request, by name in the profile, no
     FMA launch), the f32 request's 12 on split TF32;
   * vgg16 (the reference's model) from the repository's saved graph,
     bf16, an unbatched image as the reference sent it: features.0,
     features.30, flatten and the logits; 3 in sequence and 2 at once; no
     kernel of the port (none by name in the profile: cuDNN's
     convolutions, ``layers.linear``'s GEMMs);
   each checked for shapes, finiteness, probs rows summing to 1 and
   agreement with the port's plain path on the card (the kernels' plain
   versions in every block) and for the launches of every kernel, then
   one f32 request per path of a float dtype whose output must match the
   plain path at 1e-4. Concurrent requests that the batcher groups run as
   one batched pass (``Executor.run_stacked``: each kernel launches once
   for the group, with a batch of K), and each path also runs one group
   of max(2, its concurrent requests) through ``run_stacked`` directly,
   which must launch each of its kernels exactly once, its K results held
   to the single responses' bounds. The launch counts of the whole path
   must be exactly the kernels' launches a pass times the passes (each
   sequential request, each group the batcher formed, the direct group)
   plus the other model's request. Every request runs the executor's
   compiled path: the first of a signature (a request alone, or a group's
   power-of-two bucket) is one eager pass and its CUDA graph capture,
   every later one a replay; no sequential request may capture again. A
   replay calls no kernel wrapper, so this script counts its launches
   (``count_replays``): the wrapper calls that a capture issued into its
   graph are taken back off the counters and added again for each replay
   of that program. Those replay counts are copied from the capture; the
   profiled replay of every path (int8 weight-only included: none of the
   port's kernels) checks them against the kernels the card ran, by name
   (f). Then, on every path: (a)
   the replay of the image a program was captured with and (b) of a
   second image, each against the eager pass (``use_jit=False``) of the
   same request, bit for bit (an output that is not must lie within the
   path's bound against the eager one, and phase 9 lists it), each
   program's recorded launches the path's kernels a pass; the replay's and the
   eager pass's walls (median of 3) and one profiled run of each (device
   busy share, the kernels that take the most time; the same kernels by
   name in both); each capture's time, ``memory_reserved`` and the
   cache. On the vit_b16 path also: (c) four deferred replays of vit_b16
   and vit_t16 interleaved and two pipelined groups of one program, each
   against its eager pass; (d) a ``cos`` node on the logits whose A is
   edited: a cache hit, no new capture, the new values; (e) a node kind
   that reads back to the host (``.item()``) must raise ``NodeError``
   naming it, cache nothing, and leave the card serving. On every path,
   (g): a program captured from a request of new constants (the image 26
   x 36 pixels larger, the path's head subsets) replays its eager result
   bit for bit after every device-constant cache was emptied and memory
   of those constants' sizes on the capture's stream was filled with NaN
   and zeros (the program holds the constants its graph reads). Each path also
   prints its ``/metrics`` p50s and the sizes of the groups the batcher
   formed. Then vgg16 in f32 (``run_vgg_f32``: one request, no kernel
   of the port, each tap within 1e-4 of a float64 host forward of the
   same weights) and the repository's ``clip_zeroshot.json`` with both
   CLIP towers on one bf16 server (``run_zeroshot``: the image and text
   embeddings and the similarity logits against the plain path, 12 row-1
   launches a pass; a reworded prompt replays with no capture, its text
   embedding the plain path's and the image embedding unchanged bit for
   bit; an added prompt captures once; two requests that differ only in
   wording sent together run as one group, batch=2, each with its own
   embeddings). Then the repository's demo graphs through ``POST /compute`` on
   a server of no model (``run_demo_graphs``): demo_noise.json with its
   noise seed and const value edited (each a cache hit, no new capture;
   every output the CPU's bit for bit; a noise node of the fixture's
   pinned seed 7), demo_slice.json on a 3 x 224 x 224 image with its conv
   matrix edited (a cache hit; slice and shuffle exact, the f32 conv
   within 1e-5 of float64), the fixture's similarity graph with its scale
   edited (a cache hit), one ``run_stacked`` group of three of each (every
   result its own run's bit for bit); and ``tools.run_graph.main`` of
   dino_s16.json in bf16 from a ``.npy`` image (12 row-1 launches, an
   ``.npy`` a tap, PNGs of the two feature maps). Then the gradient kinds
   (``run_saliency_graphs``): the repository's vit_t16_saliency.json
   (saliency gradxinput, dream cut from its saved 32 steps to
   ``SALIENCY_DREAM_STEPS``, occlusion patch 32 stride 16,
   vit_t16:attrib), swin_t_saliency.json and vit_b16_tome_saliency.json
   through ``POST /compute``, each on a bf16 and an f32 server, a 3 x 224
   x 224 image, every gradient node's "o" and raw channel tapped with the
   logits: a replay launches each chain kernel 96 times (row 1, row 1's
   ToMe mode, row 5: the main pass, occlusion's unoccluded pass and its
   169 positions in 6 chunks of 32; saliency, dream and attrib replay the
   plain twins, no kernel; by name in the bf16 profile; no FMA route); the
   replay of the captured image equals the first request's eager (warm)
   pass bit for bit; the replay of a second image against the plain path
   (the same weights, no kernel): saliency, dream and attrib bit for bit
   (the same plain twins on both), the logits at a served path's bound
   (ToMe's in bf16 against ``tome_lockstep``), occlusion's drops within
   bounds scaled to the plain path's largest drop that refuse a zeroed
   or halved grid (f32 the grid against the plain path's; bf16 and ToMe
   position by position against batch-1 forwards through the same
   kernels), its first chunk of 32 masked images run again as one
   ``run_stacked`` group through the kernels (each launched once), its
   logits held to the plain path on the same batch (ToMe:
   ``tome_lockstep``) and its drops equal to the response's bit for bit,
   and the render held to the host's render of the response's own drops
   (HEAT_BOUND); the distances of the bf16 drops and render from the
   plain path's are logged; a scrub of dream's class and lr and
   occlusion's fill is a cache hit with no capture and new values; the
   replay wall (median of 3), the warm pass's wall, one profiled replay,
   the client p50, each capture's time, ``memory_reserved`` and the time
   of each step; on the vit_t16 bf16 server also the device busy of each
   kind (profiled replays of the chain cut with each kind, less the chain
   alone), saliency
   ``mode=smooth`` (its sigma and seed scrubbed: a cache hit, new values),
   ``mode=ig`` and Grad-CAM wrt block 3 once each, and one
   ``run_stacked`` group of two classes, each row its own run's. Then a
   throughput probe of
   micro-batched serving (BASELINE config 5): vit_b16 bf16 with the
   ``attn`` + ``r`` taps on 3 blocks, its programs for a request alone
   and the buckets 2, 4 and 8 captured first (their times and
   ``memory_reserved`` logged), 8 closed-loop
   clients of 8 requests each, on one server whose ``--max-batch`` is 1,
   8, 8 and 1 in turn:
   requests/s, the batch sizes, the client p50, the compute p50 and its
   share a request, and 6 requests in sequence first (the concurrency-1
   p50); then ``POST /profile`` (row 1's kernels by name) and
   ``POST /debug_eval`` (every node timed, no error) on that server.
   Then the monolithic forwards ``vit.forward`` (vit_b16) and
   ``swin.forward`` (swin_t) at B=1 and B=8 in bf16 and at B=1 in f32,
   with the block or window kernel and the fused MLP from
   ``default_mlp_impl("fused")``, against the same forwards with the
   plain versions: 12 MLP launches a call, bf16 all on
   ``fused_mlp_block_mma`` (swin_t's stages 0 and 1 on chunks of 96) and
   none on the FMA kernel, f32 all on ``fused_mlp_block_tf32x3`` beside 12
   of row 1's or row 5's split-TF32 route (logits within 1e-4 of their
   scale), and one profiled swin_t forward in each dtype (the MLP kernels
   by name); and four ``vit.forward`` of vit_h14 (heads 80 wide, depth cut to
   2) through ``--attn auto``, 2 launches each: f32 on the split-TF32
   kernels' 80-wide instantiations, bf16 on the bf16 tensor-core kernels';
   @224 (N=257) the row-resident kernel against its plain version, @742
   (N=2810) the online one against the plain online attention, no FMA
   flash kernel; then vit_h14@742 at full depth (32 blocks) in f32 and in
   bf16: 32 online launches each (split TF32, bf16 tensor cores), each
   forward's wall time and one profiled forward (the attention's device
   time).
5. train   -- ``tools.train.main`` in-process, launch counts zeroed
   before each run and read after it:
   (a) vit_b16 @224, ``--dtype mixed --attn auto --batch 64 --steps 10
       --memorize 64``: ``--remat auto`` must resolve to off; exactly 12
       packed tensor-core forward and 12 backward launches a step, no FMA
       one; a finite loss at every step, the last below the first; ms a
       step and images/s, and one profiled step (device busy / idle, the
       top kernels; by name 12 each of the tensor-core forward, dq and
       dk/dv kernels and no FMA attention kernel) beside one of the plain
       attention;
   (b) vit_t16, ``--dtype bfloat16 --batch 64 --steps 5``: 12 + 12
       tensor-core launches a step of ``attention_train`` ([B, H, N, dh],
       3 heads), no packed or FMA launch; timed and profiled as (a);
   (c) vit_b16 with ``--remat on``, 2 steps: 24 forward launches a step
       (the checkpointed blocks run again in the backward);
   (d) the first step's gradients in f32, vit_b16 at B=8: the packed
       split-TF32 kernels (head-major params, unpermuted; no FMA launch)
       against the plain attention on the same params and batch, every
       parameter within its bound;
   (e) vit_t16 ``--dtype float32``, 2 steps: 12 + 12 split-TF32 launches
       a step of ``attention_train``, no FMA launch;
   (f) the first step's gradients in f32 of vit_h14 (heads 80 wide, depth
       cut to 2) at B=2: ``attention_train``'s split-TF32 kernels at 80
       wide, 2 + 2 launches, no FMA launch, against the plain attention;
   (g) vit_h14 @224 at full width and depth (32 blocks, D=1280, 16 heads
       80 wide), ``--dtype mixed --batch 8 --steps 3``: ``--remat auto``
       resolves to off; exactly 32 + 32 bf16 tensor-core launches a step
       of ``attention_train`` at 80 wide, no FMA or packed launch; a
       finite loss; ms a step and images/s, one profiled step (by name 32
       each of the tensor-core forward, dq and dk/dv kernels beside the
       ``layers.linear`` GEMMs); then the first step's mixed-precision
       gradients of vit_h14 (depth 2, B=2) through the 80-wide bf16
       kernels against the plain attention (bounds below).
   No configuration gives the trainable attentions operands off the
   16-byte grid, so their FMA routes have no main-path launch (phase 3
   holds them against their plain versions).
6. checkpoints -- real weights through the checkpoint paths
   (``phase_checkpoints``): vit_b16's seeded params in a torchvision-
   naming ``.safetensors`` file and, through ``tools.convert.main``, in a
   checkpoint directory, and swin_t's in a native-naming file, served with
   ``--ckpt`` in bf16 and f32 (and vit_b16 as ``--dtype int8w8a8``), each
   request bit for bit a server that draws the same seeded params itself,
   with rows 1, 5 and 7 launching 12 times a request (rows 1 and 5 also by
   name in a profile); the accuracy oracle (vit_t16 trained by
   ``tools.train.main`` through ``attention_train``'s kernels, exported
   with ``--export-safetensors``, served from the file over HTTP; top-1
   over its 32 images above 0.9); vit_b16 mixed saved with ``--output
   --save-every`` and resumed (the state bit for bit, the step and the
   optimizer's count restored, the exported ``params/`` served bit for bit
   the returned params, a resume under the other qkv layout refused); the
   load times, the first request after a load and the async save's stall.
7. families -- the last four families from the repository's saved
   graphs through ``build_app`` at their published widths
   (``phase_families``): row 3 held against its plain version at
   vit_moe_s16's block shape (1, 6, 197, 64) in bf16, maps off and on,
   with its device time; resnet50.json, convnext_t.json, vit_moe_s16.json
   (``--attn auto``: the plain attention at N=197) and mae_t16.json on one
   f32 and one bf16 server, each request's replay bit for bit its eager
   pass and launching no kernel of the port (none by name in a profiled
   replay); the f32 taps within 1e-4 of max(1, the scale) of a float64
   host forward (the convnets, written apart from the port's layer fns)
   or of the same kinds on the host (MoE, MAE), the bf16 taps within
   FAMILY_BF16_REL of the scale of the same kinds run on the host in bf16
   (vit_moe_s16's within the MOE_* bounds: routing can flip);
   MAE's seed edit replayed with a new mask, the host's draw of the seed,
   and a mask_ratio edit captured once; deit_s16.json and dinov2_s14.json
   once each in bf16 (12 launches of row 1 / row 3); vit_moe_s16 in bf16
   under ``--attn flash`` with block 0's and 11's maps and rollout tapped:
   exactly 12 row-3 launches a request, by name in a profiled replay;
   convnext_t_saliency.json and vit_moe_s16_saliency.json in bf16 (the
   capture time, the replay wall, the replay bit for bit its eager pass);
   a table of each request's first wall, capture, replay wall and device
   busy.
8. native  -- the native host tier and the trainer's data path
   (``phase_native_data``): the host library (``wirecodec.cpp`` and
   ``dataloader.cpp``, built with g++ in phase 2 beside the kernels) and
   the codec's native tier asserted in the serving process; the real
   /compute responses of dinov2_s14_reg @518 with one block's map (row 3,
   12 launches a request), vit_l16 @384 with maps (row 2, 24) and vit_b16
   with maps + rollout on 3 blocks and with its head alone (row 1, 12),
   10 sequential requests each: the served (native) bytes, ``native.pack``'s
   and the Python encoder's byte for byte equal, both encoders timed on the
   same outputs (median of 20, turns Python / native / native / Python),
   the server's decode and encode p50; a dataset of 1,024 images [3, 224,
   224] f32 written by ``save_dataset``: the native loader's first 20
   batches of 64 (borrowed; the epoch boundary at 16) the Python
   backend's bit for bit, and its rate alone; ``tools.train.main`` on
   vit_b16 mixed B=64 ``--data`` with all six augmentations for 24 steps
   (12 + 12 packed tensor-core launches a step, finite losses, the step
   time beside phase 5's synthetic one), 12 steps saved and resumed to 24
   (the export params bit for bit the uninterrupted run's), vit_t16 mixed
   ``--data`` for 4 steps (12 + 12 ``attention_train_mma`` a step); each
   augmentation and all six on a [64, 3, 224, 224] batch on the card
   against the same draws on the host (moved values bit for bit, color
   jitter, mixup and the soft labels within 1e-6; zeroed and halved results
   refused);
   ``tools.evaluate.main`` (``ivt-eval``) on the dataset with ``--limit
   200 --batch 64``: n = 200 and the JSON line's keys. The dataset and the
   checkpoints are deleted at the end of the phase.
8b. the rest of training (``phase_rest_of_training``), each run at full
   width, B=64, ``--dtype mixed``, through the ``main`` functions, with
   its ms a step, images/s, peak device memory (above what was allocated
   before the run) and launches beside the card's name and power limit:
   (h) a vit_b16 teacher trained 2 steps by ``tools.train.main`` and
       exported (``--export-safetensors``); deit_b16 distilled from it
       (``--distill-teacher --teacher-variant vit_b16``) 10 steps hard and
       4 soft (``--distill-tau 1``): the loss falls, 12 + 12 packed
       tensor-core launches (row 9) and 12 teacher forwards of
       ``attention_train`` (row 8, canonical qkv) a step; one profiled
       step by the names of ``port_kernel_names()`` (24 forward, 12 dq,
       12 dk/dv kernels, no other kernel of the port); a soft first step
       against the plain attention, mixed at B=64 through the bf16
       kernels (12 + 12 packed, 12 teacher forwards; the loss within
       TRAIN_BF16_LOSS_REL, each gradient within TRAIN_BF16_GRAD_REL of
       its largest value) and f32 through the split-TF32 kernels (within
       TRAIN_GRAD_REL);
   (i) vit_moe_s16, 10 steps: the loss falls, 12 + 12 packed launches a
       step, the loss CE + 0.01 aux; first-step gradients against the
       plain attention in f32 (TRAIN_GRAD_REL) and in mixed precision
       (MOE_BF16_REL: routing can flip under bf16), on the first seeded
       batch whose routing has no near tie (MOE_TIE_GAP);
   (j) swin_t and convnext_t, 4 steps each with ``--remat on`` and with
       ``--no-remat``: no launch of the port's kernels, the two runs'
       losses within ``train_bound``, one profiled step with none of
       ``port_kernel_names()``; ``--attn flash_vjp`` on swin_t refused;
   (k) mae_b16 through ``tools.pretrain.main`` on ``--data`` (the
       pretrainer's 256 pattern images saved by ``save_dataset``): 10
       steps unbroken, then 5 saved (``--save-every 5``) and resumed to
       10 (``--resume --probe --export-encoder``; the loader skips the
       consumed batches): the resumed params bit for bit the
       unbroken run's, both probe accuracies logged, the exported encoder
       served as ``vit_b16 --ckpt`` in bf16: 12 row-1 launches a request,
       its CLS features within SLICE_REL of ``mae.encode``'s.
   The new launches of rows 1, 8 and 9 are added to the kernels line.
8c. tracing and quantized Swin -- each step at full width:
   (l) row 7 at swin_t's four stage shapes (3136 x 96, 784 x 192, 196 x
       384, 49 x 768; hidden 4x), B=1 and 8, bf16 and f32: ``w8a8_route``
       gives "mma" at every stage (stages 0-1 on the instantiation at
       chunks of 96, ``w8a8_mma96_kernel``, counted apart in
       ``fused_mlp_w8a8_block_mma.narrow_launches``); the integer stages
       exact and y within its bound (``check_w8a8_parts``, as at vit_b16
       in phase 3), zeroed and halved outputs refused; device times beside
       the bound, the plain version, the ``__dp4a`` kernel on the same
       values off the grid and ``torch._int_mm`` on both products;
   (m) swin_t served from ``swin_t.json`` in ``--dtype int8w8a8`` (12
       row-7 launches a request on the tensor cores, 4 of them at chunks
       of 96, none on ``__dp4a``, and 12 row-5 launches, by count and by
       name in the profiled replay; the responses within the vit_b16
       ``int8w8a8`` path's bound of the plain path; every replay bit for
       bit its eager pass) and in ``--dtype int8`` (no kernel of the
       port, by count and by name); one ``swin_t_saliency.json`` request
       in ``int8w8a8`` whose replay is its eager pass bit for bit;
   (n) ``utils/tracing``: ``trace(dir)`` around one eager pass
       (``use_jit=False``) and one replay of vit_b16's graph with maps:
       the eager trace holds one ``n<i>_<kind>`` range for each node, and
       each of row 1's 36 kernel launches (12 x qkv, attention,
       projection) lies, through its correlation id, on a launch call
       inside the range of the block that issued it; the replay's trace
       holds row 1's kernels and no node range (``profiled``'s retry rule
       for lost records; a range or a launch call out of place fails at
       once). ``node_timings`` of swin_t.json beside its eager wall;
       ``debug_nans`` on a graph whose node 0 makes a NaN: the warm pass
       and a replay raise ``FloatingPointError`` naming node 0, and with
       the switch off the graph runs. vit_b16's replay and eager walls
       with no profiler, beside phase 4's;
   (o) ``tools/quant_agreement.main`` for vit_b16 and swin_t at 2 rounds x
       16 images: each mode's top-1 agreement with bf16 and logit MAE.
   The new launches of rows 1, 5 and 7 are added to the kernels line, the
   96-column instantiation as a row of its own.
8d. graph export -- the forward kernel routes as ``torch.library`` custom
   ops (``ops/custom_ops.py``) and ``graph/export.py``:
   (p) ``torch.library.opcheck`` (``test_schema``, ``test_faketensor``) of
       each ``ivt`` op at one main-path shape (rows 1-7), and the host time
       of a call through the op against its CUDA body called directly
       (rows 1 and 6 at vit_b16, turns op, direct, direct, op);
   (q) each graph of ``EXPORTS`` built by the server (``build_app``),
       replayed live, exported from the live executor, loaded and run: the
       program's ``ivt`` nodes (vit_b16 bf16 and f32, vit_t16_saliency with
       its gradient cone, vit_b16_tome, vit_b16 int8w8a8 + int8-scores,
       the generated vit_l16@384, dinov2_s14_reg@518 and @742 chain graphs,
       swin_t: every op of rows 1-5 and 7 inside a loaded artifact), the
       loaded replay's launches equal to the live replay's, its outputs
       bit for bit the live replay's (else within the served bound, which
       the log line names), ``selftest`` ok; export seconds, artifact MB,
       load seconds, the first call's eager pass and capture, and the
       loaded and live CUDA-graph replays' device-synchronized walls; the
       gradient graph (dream cut to one step and occlusion to stride 32,
       ``SAL_PARAMS``: 4 passes of the chain, 48 row-1 launches) is
       exported by a child process that runs beside the others' (its
       trace and save are minutes of host-bound Python);
   (r) a ``--from-export`` server (``build_export_app``, selftests on)
       over the vit_b16 bf16 and vit_t16_saliency artifacts beside the
       live server: vit_b16's /compute response bytes equal, a saliency
       class edit over the wire replays the artifact's program (no
       capture) and equals the live server's; the client p50 of 20
       sequential vit_b16 requests on each;
   (s) the vit_b16 artifact loaded and run in a fresh interpreter that
       imports no model code (started once that artifact exists, beside
       the other exports), its outputs bit for bit this process's.
8e. the mesh (``phase_mesh``; ``parallel/mesh.py``, ``parallel/train.py``'s
   ``setup_sharded``, ``parallel/sequence.py``):
   (a) a one-rank NCCL group in this process (``make_mesh({"data": 1,
       "model": 1})``): vit_b16 @224 mixed, B=64, three ``setup_sharded``
       steps against three ``setup`` steps from the same seed, losses and
       every param equal bit for bit; the sharded steps' launches counted
       (every count set to 0 just before: 12 + 12 packed tensor-core
       launches a step, every other kernel 0; added to the kernels line)
       and one sharded step profiled (the three packed kernels 12 times
       each by name); a sharded step through the plain attention launches
       none of them (by count and by name);
   (b) ``python -m torch.distributed.run --standalone --nproc-per-node 1
       -m interactive_vit_tpu_torch.tools.train --mesh data=1`` (vit_t16
       bf16 through row 8, B=64, 3 steps): its logged losses equal the
       same run's in this process without torchrun; then
       ``tools.evaluate --mesh data=1`` under torchrun on its checkpoint
       equals ``evaluate.main`` here (n, top-1, top-5; that forward's
       launches listed: none);
   (c) ring and Ulysses attention on the one-rank mesh at
       dinov2_s14_reg@518's attention shape (B=1, 6 heads, N=1374, dh 64,
       f32) against the plain attention within 1e-5 (Ulysses' maps too);
   (d) the tests' four-rank gloo dry run (``tools/dryrun_multichip``,
       ``--device cpu``) on this machine's CPU, started beside (a)-(c),
       started with 8e, beside (a)-(c) and phase 8f, which prints its case
       lines (the serving cases' among them) at its end.
8f. serving on the mesh (``phase_mesh_serving``; ``graph/executor.py``'s
   mesh mode, ``serving/server.py``'s ``--mesh``):
   (t) ``python -m torch.distributed.run --standalone --nproc-per-node 1
       chip_smoke.py --counted-server COUNTS --models vit_b16 --mesh
       data=1`` in bf16 and in f32 (the server module's ``main`` under
       torchrun on a one-rank NCCL group, ``counted_server``: the compiled
       path's launches counted as phase 4's, the counters written to
       COUNTS after each executor call), each beside the same server
       without ``--mesh`` in a process of its own, all four started at the
       phase's start: 3 requests one after another and a group of 4 (batch
       4) with phase 4's vit_b16 taps, each response's bytes equal to the
       no-mesh server's (the same sequence); a pass (a request or the
       group) launches ``fused_attn_block_mma`` (bf16) or
       ``fused_attn_block_tf32x3`` (f32) 12 times and nothing else, on
       both servers (the mesh's added to the kernels line); ``/health``
       and ``/metrics`` name the mesh;
   (u) a replay's wall and device busy on each server, from ``POST
       /profile`` (20 ``executor.run``s under torch.profiler, the batcher
       bypassed; turns mesh, no-mesh, no-mesh, mesh);
   (v) the wait for the dry run (d), its lines printed.
9. result  -- the profiles taken again, the replayed outputs that were
   not the eager pass's bit for bit, a table of the compiled path (each
   served path's replay and eager walls, profiled walls and device busy,
   capture times, ``memory_reserved``), a JSON line describing the
   kernels, then the final line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX. Phases 3-5, 7, 8, 8b, 8c, 8d, 8e and 8f use random (seeded)
weights, so their logits are meaningless as classifications; what is checked is
that the served path and the plain path agree. Phase 6's oracle classifies with
weights the trainer made.
"""

from __future__ import annotations

import concurrent.futures
import functools
import inspect
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import weakref

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = "interactive_vit_tpu_torch/csrc/"
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "fused_attn_block": (CSRC + "fused_attn_block.cu",
                         "interactive_vit_tpu/ops/fused_block.py:205"),
    "headwise_attn_block": (CSRC + "headwise_attn_block.cu",
                            "interactive_vit_tpu/ops/fused_block.py:501"),
    "flash_attention": (CSRC + "flash_attention.cu",
                        "interactive_vit_tpu/ops/flash_attention.py:87"),
    "fused_window_attn": (CSRC + "fused_window_attn.cu",
                          "interactive_vit_tpu/ops/fused_window.py:128"),
    "fused_mlp_block": (CSRC + "fused_mlp_block.cu",
                        "interactive_vit_tpu/ops/fused_mlp.py:60"),
    "flash_attention_online": (CSRC + "flash_attention_online.cu",
                               "interactive_vit_tpu/ops/flash_attention.py:188"),
    "fused_mlp_w8a8_block": (CSRC + "fused_mlp_w8a8_block.cu",
                             "interactive_vit_tpu/ops/fused_mlp.py:154"),
    # the s8 mode (int8_scores) of the block kernel: the same source
    "fused_attn_block_s8": (CSRC + "fused_attn_block.cu",
                            "interactive_vit_tpu/ops/fused_block.py:205"),
    # ToMe's mode of the block kernel (key_bias + the key metric)
    "fused_attn_block_tome": (CSRC + "fused_attn_block.cu",
                              "interactive_vit_tpu/ops/fused_block.py:205"),
    # forward: flash_attention.cu on strided views; backward: the new source
    "attention_train": (CSRC + "attention_bwd.cu",
                        "interactive_vit_tpu/ops/attention_vjp.py:141"),
    "attention_train_packed": (CSRC + "attention_bwd.cu",
                               "interactive_vit_tpu/ops/attention_vjp.py:293"),
    # the bf16 tensor-core routes of rows 4, 8 and 9 (mma.sync); f32 stays
    # on the FMA kernels above
    "flash_attention_online_mma": (
        CSRC + "flash_attention_online_mma.cu",
        "interactive_vit_tpu/ops/flash_attention.py:188"),
    "attention_train_mma": (CSRC + "attention_train_mma.cu",
                            "interactive_vit_tpu/ops/attention_vjp.py:141"),
    "attention_train_packed_mma": (
        CSRC + "attention_train_mma.cu",
        "interactive_vit_tpu/ops/attention_vjp.py:293"),
    # row 3 in bf16 on the tensor cores; row 4 in f32 on split TF32
    "flash_attention_mma": (CSRC + "flash_attention_mma.cu",
                            "interactive_vit_tpu/ops/flash_attention.py:87"),
    "flash_attention_online_tf32x3": (
        CSRC + "flash_attention_online_tf32.cu",
        "interactive_vit_tpu/ops/flash_attention.py:188"),
    # rows 3, 8 and 9 in f32 on split TF32: the trainable attentions'
    # forward is flash_attention_tf32.cu on strided views, with (m, l)
    "flash_attention_tf32x3": (CSRC + "flash_attention_tf32.cu",
                               "interactive_vit_tpu/ops/flash_attention.py:87"),
    "attention_train_tf32": (CSRC + "attention_train_tf32.cu",
                             "interactive_vit_tpu/ops/attention_vjp.py:141"),
    "attention_train_packed_tf32": (
        CSRC + "attention_train_tf32.cu",
        "interactive_vit_tpu/ops/attention_vjp.py:293"),
    # row 2 on the tensor cores: bf16 on mma.sync, f32 on split TF32, heads
    # 64 and 80 wide; headwise_attn_block above is its FMA route
    "headwise_attn_block_mma": (CSRC + "headwise_attn_block_mma.cu",
                                "interactive_vit_tpu/ops/fused_block.py:501"),
    "headwise_attn_block_tf32x3": (
        CSRC + "headwise_attn_block_tf32.cu",
        "interactive_vit_tpu/ops/fused_block.py:501"),
    # rows 6 and 7 on the tensor cores, the hidden dimension split over a
    # thread-block cluster: bf16 on mma.sync m16n8k16, W8A8 on int8
    # m16n8k32; fused_mlp_block and fused_mlp_w8a8_block above are the
    # routes for other operands
    "fused_mlp_block_mma": (CSRC + "fused_mlp_block_mma.cu",
                            "interactive_vit_tpu/ops/fused_mlp.py:60"),
    "fused_mlp_w8a8_block_mma": (CSRC + "fused_mlp_w8a8_mma.cu",
                                 "interactive_vit_tpu/ops/fused_mlp.py:154"),
    # row 7's tensor-core source at chunks of 96 columns (w8a8_mma96_kernel:
    # swin_t's 96- and 192-wide stages), counted apart
    "fused_mlp_w8a8_block_mma96": (
        CSRC + "fused_mlp_w8a8_mma.cu",
        "interactive_vit_tpu/ops/fused_mlp.py:154"),
    # row 1 on the tensor cores, in its three modes: bf16 on mma.sync, f32
    # on split TF32, the s8 attention on int8 m16n8k32 in both;
    # fused_attn_block, fused_attn_block_s8 and fused_attn_block_tome above
    # are the routes for other operands
    "fused_attn_block_mma": (CSRC + "fused_attn_block_mma.cu",
                             "interactive_vit_tpu/ops/fused_block.py:205"),
    "fused_attn_block_tf32x3": (CSRC + "fused_attn_block_tf32.cu",
                                "interactive_vit_tpu/ops/fused_block.py:205"),
    "fused_attn_block_s8_mma": (CSRC + "fused_attn_block_mma.cu",
                                "interactive_vit_tpu/ops/fused_block.py:205"),
    "fused_attn_block_s8_tf32x3": (
        CSRC + "fused_attn_block_tf32.cu",
        "interactive_vit_tpu/ops/fused_block.py:205"),
    "fused_attn_block_tome_mma": (
        CSRC + "fused_attn_block_mma.cu",
        "interactive_vit_tpu/ops/fused_block.py:205"),
    "fused_attn_block_tome_tf32x3": (
        CSRC + "fused_attn_block_tf32.cu",
        "interactive_vit_tpu/ops/fused_block.py:205"),
    # row 5 on the tensor cores: bf16 on mma.sync, f32 on split TF32, heads
    # 32 wide in windows of up to 64 tokens; fused_window_attn above is the
    # route for other operands
    "fused_window_attn_mma": (CSRC + "fused_window_attn_mma.cu",
                              "interactive_vit_tpu/ops/fused_window.py:128"),
    "fused_window_attn_tf32x3": (
        CSRC + "fused_window_attn_tf32.cu",
        "interactive_vit_tpu/ops/fused_window.py:128"),
    # row 6 in f32 on split TF32 on the same cluster split; with
    # fused_mlp_block_mma (bf16, chunks of 128 or 96) it leaves the FMA
    # kernel fused_mlp_block no main-path launch
    "fused_mlp_block_tf32x3": (CSRC + "fused_mlp_block_tf32.cu",
                               "interactive_vit_tpu/ops/fused_mlp.py:60"),
}

# Bounds of a kernel against its plain version (same inputs, same cast
# points; only the order of f32 sums differs). f32: 1e-4 absolute. bf16
# keeps 8 significant bits: a sum that lands within its f32 rounding error
# of a bf16 rounding boundary rounds to the neighbour, one ulp (2^-8 to
# 2^-7 of the element) in a qkv, head-output or y element. y (and the flash
# output) may move by a few ulps at the top of its range: 2^-6 of its
# scale. A probs or mean element moves in proportion to itself: a one-ulp
# flip in a q or k element (the fused kernel computes its own qkv) shifts
# a score by up to 2^-7 |q_i k_i| dh^-0.5 and the probs by that share,
# before their own rounding. So the bound is per element: 2^-5 of the
# plain value (four ulps), plus 1e-6 for values at or near 0, and never
# above 2^-7. (A bound on the whole tensor would not do: at N=1374 a
# typical probability is 7e-4.)
F32_BOUND = 1e-4
BF16_Y_REL = 2.0 ** -6
BF16_P_REL = 2.0 ** -5
BF16_P_ABS = 1e-6
BF16_P_CAP = 2.0 ** -7
# ToMe's key metric (the head-meaned keys, f32) takes y's bound: in f32
# only the order of the QKV product's f32 sums differs; in bf16 a key
# element that rounds to its neighbour moves the mean by at most one ulp
# of that element over the head count. The matching's decisions on it
# (argmax and a stable argsort of cosine scores) are discrete: on the same
# inputs the kernel's and the plain metric must pick the same lut in f32.
# In bf16 a decision may differ only where the plain scores of the two
# choices lie within 2 d of each other, d being the largest difference
# between the scores from the two metrics, itself at most TOME_SCORE_CAP.
TOME_SCORE_CAP = 2.0 ** -5
# A served bf16 path against the plain path through all its blocks: the
# rare one-ulp flips above enter the residual stream and propagate through
# later blocks, so each output is bound by its own scale: within 2^-4 of
# its largest value (the head output: of max(1, its largest value)).
SLICE_REL = 2.0 ** -4
# A viewer node's map (pca_view, patch_sim) in a bf16 response. Its input,
# the served norm output, is held to the plain path by SLICE_REL, but the
# PCA view is ill-conditioned in it: a rotation of its top-3 eigenvectors
# by ||dC|| / gap, and with seeded random weights dino_s16's eigenvalues
# 2-4 are 0.90, 0.84 and 0.77 of the first (measured on an NVIDIA H100
# 80GB HBM3 at 700 W), so the bf16 flips of the blocks move the view by up
# to 0.08 against the plain path's (1.3 SLICE_REL). So in bf16 a view is held
# to the same kind run on the host from the response's own source tap (the
# bf16 values, exact in f32; only the order of f32 sums differs) within
# VIEW_BOUND, and its distance from the plain path's view is logged
# (VIEW_VS_PLAIN). An f32 request's views are held to the plain path.
VIEW_BOUND = 1e-5
# (path tag, view node) -> the largest distance of a bf16 view from the
# plain path's
VIEW_VS_PLAIN = {}
# bf16 probs rows: each of N probs rounds by <= 2^-9 relative, so a row
# sums to 1 within 2^-9; bound 2^-7.
ROW_SUM_BOUND = 2.0 ** -7
# The int8 kernels (the W8A8 MLP, the s8 block), in both dtypes. Their s32
# products are exact, but each int8 is the rounding of an f32 (or bf16)
# value that the kernel and the plain version compute in another order, so
# a value within that difference of a .5 boundary rounds to the other int8.
# One flipped int8 of q or k moves a score by at most scale * max|q| *
# max|k| / 127 (~0.02 at the shapes below) and its probability by about
# that share of itself; one flipped int8 of p moves o by at most ps *
# max|v|, one of the MLP's activations y by one quantization step through
# a product. So y is held to 2^-6 of its scale (as bf16's y) in f32 too,
# and probs and mean, per element, to 2^-4 of the plain value plus 1e-6,
# never above 2^-5; a tap zeroed or halved still fails. The W8A8 MLP's
# integer stages are checked exactly instead: acc1 = q1 @ fc1_q and acc2 =
# q2 @ fc2_q on the kernel's own int8 activations, which differ from the
# plain version's in at most 1% of places (``check_w8a8_parts``).
S8_P_REL = 2.0 ** -4
S8_P_CAP = 2.0 ** -5
W8A8_Q_SHARE = 0.01
# The trainable attention's o, dq, dk, dv against the plain versions. f32:
# only the order of f32 sums differs (scores over dh, delta and dq over N
# keys, dk and dv over N queries), ~1e-6 of a tensor's largest value; bound
# 1e-5 of it. bf16: both round P (for dv), ds and the outputs at the same
# points; a value within its f32 error of a bf16 boundary rounds to the
# neighbour, one ulp of the element, or one ulp of one term inside a sum of
# N; so each element within 2^-6 of its plain value (two ulps) plus 2^-8 of
# the tensor's largest value. A gradient zeroed or halved fails either way.
TRAIN_F32_REL = 1e-5
TRAIN_BF16_REL = 2.0 ** -6
TRAIN_BF16_SCALE = 2.0 ** -8
# First-step f32 gradients of vit_b16 (12 blocks), the kernels against the
# plain attention: the per-block differences above (~1e-6 of the scale)
# pass through 12 blocks forward and back; each parameter's gradient is
# held to 1e-4 of its largest value, the loss to 1e-5.
TRAIN_GRAD_REL = 1e-4
# First-step gradients in mixed precision (bf16 compute), vit_h14 at depth
# 2, the kernels against the plain attention. The two round at different
# points: the plain attention's autograd rounds dP and the q, k, v
# gradients to bf16 (8 significant bits), the kernels keep dP in f32; and a
# one-ulp flip of a bf16 activation passes through two blocks forward and
# back. Each parameter's gradient is held to 2^-4 of its largest value (a
# few bf16 ulps of the largest element, far above the ~2^-9 of one
# rounding), the loss to 2^-6 of max(1, |loss|); a gradient zeroed or
# halved (off by 1 or 1/2 of its scale) fails.
TRAIN_BF16_GRAD_REL = 2.0 ** -4
TRAIN_BF16_LOSS_REL = 2.0 ** -6
# The tensor-core forward's saved row statistics (m, l) against the plain
# ones: only the order of the f32 sums differs (scores over dh; l a running
# sum over N keys), so m within 1e-5 of 1 + |m| and l within 1e-4 of
# itself; a halved l fails.
STATS_M_REL = 1e-5
STATS_L_REL = 1e-4
# vit_b16's and vit_t16's train attention shapes: (B, heads, N, dh)
TRAIN_B16 = (64, 12, 197, 64)
TRAIN_T16 = (64, 3, 197, 64)
# vit_h14's, heads 80 wide: train run (f) (depth 2, B=2, f32) and run (g)
# (full depth, B=8, mixed)
TRAIN_H14 = (2, 16, 257, 80)
TRAIN_H14_G = (8, 16, 257, 80)

# The least time the card could take (H100 SXM published peaks): bytes over
# the memory rate, operations over the peak rate for the inputs' type (bf16
# tensor cores; f32 outside them; the split-TF32 route's TF32 products on
# the tensor cores).
HBM_BYTES_PER_S = 3.35e12

# The new kernels' main-path shapes: dinov2_s14_reg@742's attention (heads,
# tokens, head width) and vit_b16's MLP (tokens, width, hidden).
ONLINE_SHAPE = (6, 2814, 64)
# vit_h14@742's attention (B, heads, tokens, head width): heads 80 wide,
# the 80-wide instantiations' main-path shape
VIT_H14_742_SHAPE = (1, 16, 2810, 80)
W8A8_SHAPE = (197, 768, 3072)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12,
              "tf32": 495e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card from CUDA events, after a warm-up
    and a synchronize."""
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
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_turns(kernel_fn, plain_fn):
    """(kernel ms, plain ms), each the mean of two turns taken in the
    order plain, kernel, kernel, plain."""
    t_p1 = time_ms(plain_fn)
    t_k1 = time_ms(kernel_fn)
    t_k2 = time_ms(kernel_fn)
    t_p2 = time_ms(plain_fn)
    return (t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2


# Cycles the card spins before a held timing (``time_held``): ~10 ms at
# the H100's clocks, longer than the host takes to issue the timed calls.
HOLD_CYCLES = 20_000_000


def time_held(fn, iters: int = 20, warmup: int = 3):
    """``time_ms`` on the device's time alone: the stream first spins for
    HOLD_CYCLES, so the host has issued every timed call before the card
    starts them, and a kernel that takes less time than its wrapper's host
    code is timed as the kernel. Returns (device ms, host ms to issue one
    call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def time_turns_held(kernel_fn, plain_fn):
    """``time_turns`` on device time alone (``time_held``): (kernel ms,
    plain ms, host ms to issue one kernel call)."""
    t_p1, _ = time_held(plain_fn)
    t_k1, h1 = time_held(kernel_fn)
    t_k2, h2 = time_held(kernel_fn)
    t_p2, _ = time_held(plain_fn)
    return (t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2, (h1 + h2) / 2


def bound(nbytes: float, flops, dtype_name: str):
    """(bound_ms, bound_by) for work that moves ``nbytes`` and does
    ``flops`` multiply-adds x 2 on inputs of ``dtype_name`` (or, as a dict,
    that many on inputs of each type: the times add)."""
    if not isinstance(flops, dict):
        flops = {dtype_name: flops}
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_FLOPS[t] for t, n in flops.items())
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def block_cost(b, n, d, heads, esize, n_maps, mean, tome=False):
    """Bytes and FLOPs of one attention block (LN1 + QKV + attention +
    projection + residual): x, LN, qkv and proj weights read once, y, the
    maps of ``n_maps`` heads and the mean written once. ``tome``: ToMe's
    f32 key bias read and f32 key metric written too, and the metric's
    sums over the heads."""
    nbytes = esize * (2 * b * n * d + 4 * d * d + 6 * d
                      + n_maps * b * n * n + (b * n * n if mean else 0))
    flops = (2 * b * n * d * 3 * d + 4 * b * heads * n * n * (d // heads)
             + 2 * b * n * d * d)
    if tome:
        nbytes += 4 * (b * n + b * n * (d // heads))
        flops += b * n * d
    return nbytes, flops


def headwise_cost(b, n, d, heads, esize, n_maps, mean):
    """Bytes and FLOPs of the headwise block after LN1 + QKV (row 2's own
    kernels): qkv, x and the projection's weights read once, y, the maps of
    ``n_maps`` heads and the mean written once; the attention and the
    projection."""
    nbytes = esize * (3 * b * n * d + 2 * b * n * d + d * d + d
                      + n_maps * b * n * n + (b * n * n if mean else 0))
    return nbytes, 4 * b * heads * n * n * (d // heads) + 2 * b * n * d * d


def off_grid(t):
    """A copy of the contiguous ``t`` that starts one element into its
    storage, so its base address is 2 (bf16) or 4 (f32) bytes off the
    16-byte grid and ``headwise_route`` sends the block to the FMA kernel
    (the same values)."""
    import torch

    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def phase_headwise_kernel(device) -> dict:
    """Row 2, the headwise attention block, against its plain version:
    vit_l16@384 (16 heads 64 wide, N=577; B=1 and 4) maps off, maps + mean
    and heads (0, 7, 15) + mean; vit_h14@742 (16 heads 80 wide, N=2810,
    B=1) maps off and maps + mean; vit_h14@224 (N=257) maps + mean; bf16 on
    the tensor cores, f32 on split TF32 (the launch counts show the route);
    and vit_l16@384 on a copy off the 16-byte grid, on the FMA kernel. y,
    maps and mean within their bounds, which must refuse each zeroed or
    halved; device times (``time_turns_held``: turns plain, kernel, kernel,
    plain) of the whole wrapper (LN1 + QKV included) and of row 2's kernels
    alone after QKV (``headwise_kernels``), with their bounds (f32: at the
    TF32 peak, three products a product, and at the f32 FMA peak), and
    ``scaled_dot_product_attention`` on the attention part alone (maps off,
    the same dtype; a yardstick the port never calls). Returns the numbers
    of each route for the result line: vit_l16@384 B=1 maps + mean (bf16 on
    the tensor cores, and bf16 off the grid on FMA), vit_h14@742 f32 maps
    off (split TF32)."""
    import torch
    import torch.nn.functional as F

    from interactive_vit_tpu_torch.ops import fused_block as fb

    def counts():
        return (fb.headwise_attn_block.launches,
                fb.headwise_attn_block_mma.launches,
                fb.headwise_attn_block_tf32x3.launches)

    all_modes = {
        "maps_off": {},
        "maps_mean": {"want_attn": True, "want_mean": True},
        "subset_mean": {"want_attn": True, "want_mean": True,
                        "attn_heads": (0, 7, 15)}}
    cases = [("vit_l16@384", 1, 577, 1024, ("maps_off", "maps_mean",
                                              "subset_mean"), False),
             ("vit_l16@384", 4, 577, 1024, ("maps_off", "maps_mean",
                                              "subset_mean"), False),
             ("vit_h14@742", 1, 2810, 1280, ("maps_off", "maps_mean"), False),
             ("vit_h14@224", 1, 257, 1280, ("maps_mean",), False),
             ("vit_l16@384", 1, 577, 1024, ("maps_off", "maps_mean"), True)]
    heads = 16
    out = {}
    for sname, b, n, d, modes, fma in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).replace("torch.", "")
            esize = 2 if dtype == torch.bfloat16 else 4
            p = random_block(d, dtype, device, seed=b * 100 + d)
            x = torch.randn((b, n, d), generator=torch.Generator()
                            .manual_seed(d + b)).to(device=device, dtype=dtype)
            route = "fma" if fma else ("mma" if esize == 2 else "tf32")
            if fma:
                x = off_grid(x)
            if fb._route_of(x, p, heads) != route:
                raise AssertionError(f"headwise {sname} {dt}: route "
                                     f"{fb._route_of(x, p, heads)}, "
                                     f"expected {route}")
            qkv = fb._ln_qkv(x, p, 1e-6)
            dh = d // heads
            q, k, v = (qkv.view(b, n, 3, heads, dh)[:, :, i].transpose(1, 2)
                       for i in range(3))
            t_lib = None
            for mode in modes:
                kw = all_modes[mode]
                before = counts()
                got = fb.headwise_attn_block(x, p, heads, 1e-6, **kw)
                torch.cuda.synchronize()
                step = {"fma": (1, 0, 0), "mma": (0, 1, 0),
                        "tf32": (0, 0, 1)}[route]
                if counts() != tuple(c + s for c, s in zip(before, step)):
                    raise AssertionError(f"headwise {sname} {dt} {mode}: "
                                         f"launches {counts()} after "
                                         f"{before}, route {route}")
                ref = fb.headwise_attn_block_reference(x, p, heads, 1e-6,
                                                       **kw)
                tag = (f"headwise_attn_block {sname} B={b} {dt} ({route}"
                       + (", off the 16-byte grid" if fma else "")
                       + f") {mode}")
                labels = ("y", "probs", "mean")
                errs, line = check_outputs(tag, got, ref, dtype, labels)
                check_bounds_refuse(tag, got, ref, dtype, labels, first=0)
                del got, ref
                if mode == "subset_mean":
                    log(line)
                    continue
                maps, mean = kw.get("want_attn", False), "want_mean" in kw
                t_k, t_p, t_host = time_turns_held(
                    lambda: fb.headwise_attn_block(x, p, heads, 1e-6, **kw),
                    lambda: fb.headwise_attn_block_reference(
                        x, p, heads, 1e-6, **kw))
                t_core, _ = time_held(lambda: fb.headwise_kernels(
                    route, x, qkv, p, heads, maps, mean))
                n_maps = heads if maps else 0
                nbytes, flops = block_cost(b, n, d, heads, esize, n_maps,
                                           mean)
                cbytes, cflops = headwise_cost(b, n, d, heads, esize, n_maps,
                                               mean)
                bms, by = bound(nbytes, flops, dt)
                cms, cby = bound(cbytes, cflops, dt)
                line += (f"; device time: wrapper {t_k:.4f} ms, plain "
                         f"{t_p:.4f} ms (the wrapper's host time {t_host:.4f}"
                         f" ms a call), row 2's kernels after QKV "
                         f"{t_core:.4f} ms; bound: wrapper {bms:.5f} ms "
                         f"({by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} "
                         f"GFLOP), after QKV {cms:.5f} ms ({cby}: "
                         f"{cbytes / 1e6:.2f} MB, {cflops / 1e9:.3f} GFLOP)")
                if route == "tf32":
                    # the split's products, three TF32 ones a product; LN1
                    # and QKV stay f32 GEMMs
                    qflops = flops - cflops
                    bms, by = bound(nbytes, {"float32": qflops,
                                             "tf32": 3 * cflops}, dt)
                    cms, cby = bound(cbytes, {"tf32": 3 * cflops}, dt)
                    line += (f"; at the TF32 peak (the split's "
                             f"{3 * cflops / 1e9:.3f} GFLOP): wrapper "
                             f"{bms:.5f} ms ({by}), after QKV {cms:.5f} ms "
                             f"({cby})")
                if not maps:
                    t_lib, _ = time_held(
                        lambda: F.scaled_dot_product_attention(q, k, v))
                    line += (f"; scaled_dot_product_attention ({dt}) on the "
                             f"attention part {t_lib:.4f} ms")
                log(line)
                nums = {"max_abs_err": max(errs), "ms": t_k, "plain_ms": t_p,
                        "bound_ms": bms, "bound_by": by, "library_ms": t_lib}
                key = (sname, b, dt, mode)
                if key == ("vit_l16@384", 1, "bfloat16", "maps_mean"):
                    out["fma" if fma else "mma"] = nums
                if key == ("vit_h14@742", 1, "float32", "maps_off"):
                    out["tf32"] = nums
            del q, k, v, qkv
            torch.cuda.empty_cache()
    return out


def flash_cost(b, h, n, dh, esize, maps):
    """Bytes and FLOPs of attention on q, k, v [b, h, n, dh]."""
    nbytes = esize * (4 * b * h * n * dh + (b * h * n * n if maps else 0))
    return nbytes, 4 * b * h * n * n * dh


def random_block(d: int, dtype, device, seed: int):
    """One block's attention parameters with non-trivial LN and biases."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=g) * std + mean).to(
            device=device, dtype=dtype)

    return {
        "ln1_s": rnd(d, std=0.1, mean=1.0), "ln1_b": rnd(d, std=0.1),
        "qkv_w": rnd(d, 3 * d, std=d ** -0.5), "qkv_b": rnd(3 * d, std=0.1),
        "proj_w": rnd(d, d, std=d ** -0.5), "proj_b": rnd(d, std=0.1),
    }


def output_bound(i, ref, dtype, s8=False):
    """(bound of each element of output ``i`` against the plain ``ref``, a
    tensor or a number; its description). ``s8``: the int8 kernels'."""
    import torch

    if s8 and i > 0:
        return ((S8_P_REL * ref.float().abs() + BF16_P_ABS).clamp(
            max=S8_P_CAP), f"min({S8_P_CAP:g}, {S8_P_REL:g}|ref|+"
                           f"{BF16_P_ABS:g})")
    if dtype == torch.float32 and not s8:
        return F32_BOUND, f"{F32_BOUND:g}"
    if i == 0:
        bound = BF16_Y_REL * max(1.0, ref.abs().max().item())
        return bound, f"{bound:.3g}"
    return ((BF16_P_REL * ref.float().abs() + BF16_P_ABS)
            .clamp(max=BF16_P_CAP),
            f"min({BF16_P_CAP:g}, {BF16_P_REL:g}|ref|+{BF16_P_ABS:g})")


def check_outputs(tag, got, ref, dtype, labels, quiet=False, s8=False):
    """Max abs errors of ``got`` against ``ref`` (same layout, ``None``
    where absent) and their bounds; raises outside a bound. The first
    tensor is y (or the attention output), the rest probs / mean."""
    errs, parts, ok = [], [], True
    for i, (g, r) in enumerate(zip(got, ref)):
        if r is None:
            if g is not None:
                raise AssertionError(f"{tag}: unexpected output {i}")
            continue
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{tag}: output {i} is {tuple(g.shape)} "
                                 f"{g.dtype}, plain {tuple(r.shape)} "
                                 f"{r.dtype}")
        # ToMe's key metric is bound as y is (module note above)
        bound, text = output_bound(0 if labels[i] == "metric" else i, r,
                                   dtype, s8)
        diff = (g.float() - r.float()).abs()
        use = (diff / bound).max().item()
        ok = ok and use <= 1.0
        errs.append(diff.max().item())
        parts.append(f"{labels[i]}={errs[-1]:.3g} (bound {text}, "
                     f"{use:.2f} of it)")
    line = f"  {tag}: max abs err " + ", ".join(parts)
    if not ok:
        if not quiet:
            log(line)
        raise AssertionError(f"{tag} outside its bounds")
    return errs, line


def check_bounds_refuse(tag, got, ref, dtype, labels, s8=False,
                        first=1) -> None:
    """The bounds must refuse a kernel whose outputs from ``first`` on (by
    default the maps and mean; 0 takes y too) are zero or half the plain
    values: each such corruption of ``got`` has to fail."""
    for i in range(first, len(got)):
        if got[i] is None:
            continue
        for factor in (0.0, 0.5):
            bad = list(got)
            bad[i] = got[i] * factor
            try:
                check_outputs(tag, bad, ref, dtype, labels, quiet=True,
                              s8=s8)
            except AssertionError:
                continue
            raise AssertionError(f"{tag}: {labels[i]} x {factor} passed "
                                 f"the bounds")


def row1_counts(s8=False):
    """The launch counts of row 1's routes, fma / mma / tf32 (dense or the
    s8 mode)."""
    from interactive_vit_tpu_torch.ops import fused_block as fb

    names = (("fused_attn_block_s8", "fused_attn_block_s8_mma",
              "fused_attn_block_s8_tf32x3") if s8 else
             ("fused_attn_block", "fused_attn_block_mma",
              "fused_attn_block_tf32x3"))
    return tuple(getattr(fb, n).launches for n in names)


def row1_step(route):
    return {"fma": (1, 0, 0), "mma": (0, 1, 0), "tf32": (0, 0, 1)}[route]


def row1_library_yardstick(x, p, heads, eps):
    """Row 1's function (maps off) in four library calls (a yardstick, not
    one call: ``library_ms`` stays null): ``F.layer_norm``, ``addmm`` (QKV),
    ``scaled_dot_product_attention`` on q, k, v views of its result, and
    ``addmm`` of the head outputs onto x + proj_b (that sum taken before the
    timed calls). The port never calls it."""
    import torch
    import torch.nn.functional as F

    b, n, d = x.shape
    x2 = x.reshape(-1, d)
    xb = x2 + p["proj_b"]

    def run():
        ln = F.layer_norm(x2, (d,), p["ln1_s"], p["ln1_b"], eps)
        qkv = torch.addmm(p["qkv_b"], ln, p["qkv_w"]).view(b, n, 3, heads,
                                                           d // heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o = F.scaled_dot_product_attention(q, k, v)
        return torch.addmm(xb, o.transpose(1, 2).reshape(-1, d),
                           p["proj_w"]).view(b, n, d)
    return run


def phase_block_kernel(device, name, kernel, plain, shapes, modes, s8=False):
    """Row 1 (``kernel``: ``fused_attn_block`` or, ``s8``, its s8 mode)
    against its plain version over ``shapes`` x dtypes x ``modes``: bf16 on
    the tensor cores, f32 on split TF32 (the launch counts show the route),
    and at vit_b16 B=1, on a copy of x off the 16-byte grid, the FMA (or
    ``__dp4a``) kernel they replace; the bounds must refuse every output
    zeroed or halved. Device times alone (``time_turns_held``: turns
    plain, kernel, kernel, plain; the wrapper's host time a call logged
    beside), the bound, and with maps off the four-call library yardstick
    (dense mode). ``s8``: the s8 bounds, the attention's products counted
    as int8 operations, and each tensor-core route's s32 sums checked
    against the exact products of its own int8 operands at vit_b16 B=1.
    Returns the numbers of each route at vit_b16 B=1 with maps + mean
    (bf16 for the tensor cores and the FMA kernel, f32 for split TF32)."""
    import torch

    from interactive_vit_tpu_torch.ops import fused_block as fb

    out = {}
    for sname, b, n, d, heads in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).replace("torch.", "")
            p = random_block(d, dtype, device, seed=b * 100 + d)
            x = torch.randn((b, n, d), generator=torch.Generator()
                            .manual_seed(d + b)).to(device=device, dtype=dtype)
            route = "mma" if dtype == torch.bfloat16 else "tf32"
            runs = [(route, x)]
            if (sname, b) == ("vit_b16", 1):
                runs.append(("fma", off_grid(x)))
            for rt, xr in runs:
                if fb._block_route_of(xr, p, heads) != rt:
                    raise AssertionError(f"{name} {sname} {dt}: route "
                                         f"{fb._block_route_of(xr, p, heads)}"
                                         f", expected {rt}")
                for mode, kw in modes(heads).items():
                    if rt == "fma" and mode not in ("maps_off", "maps_mean"):
                        continue
                    before = row1_counts(s8)
                    got = kernel(xr, p, heads, 1e-6, **kw)
                    torch.cuda.synchronize()
                    if row1_counts(s8) != tuple(
                            c + s for c, s in zip(before, row1_step(rt))):
                        raise AssertionError(f"{name} {sname} {dt} {mode}: "
                                             f"launches {row1_counts(s8)} "
                                             f"after {before}, route {rt}")
                    ref = plain(xr, p, heads, 1e-6, **kw)
                    tag = (f"{name} {sname} B={b} {dt} ({rt}"
                           + (", off the 16-byte grid" if rt == "fma" else "")
                           + f") {mode}")
                    labels = ("y", "probs", "mean")
                    errs, line = check_outputs(tag, got, ref, dtype, labels,
                                               s8=s8)
                    check_bounds_refuse(tag, got, ref, dtype, labels, s8=s8,
                                        first=0)
                    del got, ref
                    if mode == "subset":
                        log(line)
                        continue
                    t_k, t_p, t_host = time_turns_held(
                        lambda: kernel(xr, p, heads, 1e-6, **kw),
                        lambda: plain(xr, p, heads, 1e-6, **kw))
                    sel = kw.get("attn_heads")
                    n_maps = (0 if not kw.get("want_attn") else
                              len(sel) if sel else heads)
                    nbytes, flops = block_cost(b, n, d, heads,
                                               x.element_size(), n_maps,
                                               kw.get("want_mean", False))
                    if s8:  # QK^T and PV in int8, the GEMMs in dt
                        attn = 4 * b * heads * n * n * (d // heads)
                        flops = {dt: flops - attn, "int8": attn}
                    bms, by = bound(nbytes, flops, dt)
                    ops = sum(flops.values()) if s8 else flops
                    line += (f"; device time: kernel {t_k:.4f} ms, plain "
                             f"{t_p:.4f} ms (the wrapper's host time "
                             f"{t_host:.4f} ms a call); bound {bms:.5f} ms "
                             f"({by}: {nbytes / 1e6:.2f} MB, "
                             f"{ops / 1e9:.3f} G operations)")
                    if rt == "tf32":
                        # the split's products, three TF32 ones a product:
                        # the kernels line carries this bound
                        tops = ({"tf32": 3 * (ops - attn), "int8": attn}
                                if s8 else {"tf32": 3 * flops})
                        bms, by = bound(nbytes, tops, dt)
                        line += (f"; at the TF32 peak (the split's "
                                 f"{sum(tops.values()) / 1e9:.3f} G "
                                 f"operations) {bms:.5f} ms ({by})")
                    if not s8 and rt != "fma" and mode == "maps_off":
                        lib = row1_library_yardstick(xr, p, heads, 1e-6)
                        lib_err = (lib().float() - plain(
                            xr, p, heads, 1e-6)[0].float()).abs().max().item()
                        t_lib, _ = time_held(lib)
                        line += (f"; yardstick of four library calls "
                                 f"(layer_norm, addmm, "
                                 f"scaled_dot_product_attention, addmm) "
                                 f"{t_lib:.4f} ms (max abs diff "
                                 f"{lib_err:.3g} from the plain version; the "
                                 f"kernel at {t_k / t_lib:.2f}x it)")
                    log(line)
                    nums = {"max_abs_err": max(errs), "ms": t_k,
                            "plain_ms": t_p, "bound_ms": bms, "bound_by": by,
                            "library_ms": None}
                    if (sname, b, mode) == ("vit_b16", 1, "maps_mean") and (
                            (rt == "tf32") == (dtype == torch.float32)):
                        out[rt] = nums
            if s8 and (sname, b) == ("vit_b16", 1):
                for int8_pv in (True, False):
                    check_s8_parts(f"{name} {sname} B={b} {dt} ({route})",
                                   x, p, heads, int8_pv)
    return out


def check_row1_padded_rows(device) -> None:
    """Row 1 at clip_b32's N=50 (no multiple of the LN1 + QKV kernel's
    32-row tiles or of the attention's query blocks): the rows a tile holds
    past N must never reach y, the maps or the head mean. x is given in a
    buffer whose storage runs on into 64 rows of NaN, and free blocks of
    the sizes of the wrapper's workspaces and outputs are filled with NaN
    first (the caching allocator hands them out again); the results must
    be finite and equal bit for bit to those of a clean call, at B=1 and
    2, in both dtypes (their routes), maps off, maps + mean and a head
    subset."""
    import torch

    from interactive_vit_tpu_torch.ops import fused_block as fb

    n, d, heads, eps = 50, 768, 12, 1e-5
    nan = float("nan")
    checked = []
    for dtype in (torch.bfloat16, torch.float32):
        p = random_block(d, dtype, device, seed=50)
        for b in (1, 2):
            x = torch.randn((b, n, d), generator=torch.Generator()
                            .manual_seed(b)).to(device=device, dtype=dtype)
            buf = torch.full(((b * n + 64) * d,), nan, dtype=dtype,
                             device=device)
            buf[:x.numel()] = x.flatten()
            xn = buf[:x.numel()].view(b, n, d)
            for mode, kw in (("maps_off", {}),
                             ("maps_mean", {"want_attn": True,
                                            "want_mean": True}),
                             ("subset", {"want_attn": True, "want_mean": True,
                                         "attn_heads": (0, 5, 11)})):
                want = fb.fused_attn_block(x, p, heads, eps, **kw)
                sizes = [((b, n, 3 * d), dtype), ((b, n, d), dtype),
                         ((b, heads, n, n), torch.float32),
                         ((b, heads, n, n), dtype), ((b, n, n), dtype)]
                poison = [torch.full(shape, nan, dtype=dt, device=device)
                          for shape, dt in sizes for _ in range(4)]
                del poison
                got = fb.fused_attn_block(xn, p, heads, eps, **kw)
                torch.cuda.synchronize()
                for i, (g, w) in enumerate(zip(got, want)):
                    if w is None:
                        continue
                    if not (torch.isfinite(g).all() and torch.equal(g, w)):
                        raise AssertionError(
                            f"row 1 clip_b32 B={b} {dtype} {mode}: output "
                            f"{i} reads the rows past N=50 (NaN there gives "
                            f"{int((~torch.isfinite(g)).sum())} non-finite "
                            f"values, or other bits than a clean call)")
                checked.append(f"{str(dtype)[6:]} B={b} {mode}")
    log(f"  row 1 at clip_b32's N=50, x followed by NaN rows and the "
        f"workspaces' free blocks NaN-filled: finite and bit for bit a "
        f"clean call's ({len(checked)} cases: {', '.join(checked)})")


def check_s8_parts(tag, x, p, heads, int8_pv) -> None:
    """The s8 tensor-core route's integer stages on its own int8 operands:
    si = q8 k8^T and (int8_pv) oi = p8 v8 exactly; q8 and k8 against the
    plain version's quantization of the plain qkv, which they may differ
    from where an f32 value the two compute in another order lands across
    a .5 boundary (logged, at most 1% of them)."""
    import torch

    from interactive_vit_tpu_torch.ops import fused_block as fb
    from interactive_vit_tpu_torch.ops import quant

    kw = {"want_attn": True, "want_mean": True}
    _, parts = fb.fused_attn_block_s8_parts(x, p, heads, 1e-6,
                                            int8_pv=int8_pv, **kw)
    torch.cuda.synchronize()

    def exact(a, bt):
        return torch.matmul(a.double(), bt.double()).long()

    if not torch.equal(parts["si"].long(),
                       exact(parts["q8"], parts["k8"].transpose(-1, -2))):
        raise AssertionError(f"{tag}: si is not q8 k8^T")
    if int8_pv and not torch.equal(parts["oi"].long(),
                                   exact(parts["p8"], parts["v8"])):
        raise AssertionError(f"{tag}: oi is not p8 v8")
    b, n, d = x.shape
    qkv = fb._ln_qkv(x, p, 1e-6)
    shares = {}
    for i, name in enumerate(("q8", "k8")):
        t = qkv[..., i * d:(i + 1) * d].reshape(b, n, heads, d // heads)
        q8, _ = quant.quant_rows_mosaic(t.transpose(1, 2).float())
        shares[name] = (parts[name] != q8.to(torch.int8)).float().mean().item()
    if max(shares.values()) > W8A8_Q_SHARE:
        raise AssertionError(f"{tag}: int8 operands differ from the plain "
                             f"version's in {shares}")
    log(f"  {tag} int8_pv={int8_pv}: s32 sums equal the exact products of "
        f"the kernel's own int8 operands ("
        + ("si = q8 k8^T, oi = p8 v8" if int8_pv else "si = q8 k8^T")
        + "); q8, k8 differ from the plain version's in "
        + ", ".join(f"{k} {100 * v:.3f}%" for k, v in shares.items()))


def phase_tome_kernel(device) -> dict:
    """ToMe's mode of the block kernel (``key_bias`` + ``want_metric``)
    against its plain version at the ends of the served ladders: vit_b16
    at N=197 (B=1 and 8) and N=109 (vit_b16_tome's last block), N=21
    (vit_b16_tome16's last) and N=11, bf16 on the tensor cores and f32 on
    split TF32, maps off and maps + mean, and the s8 mode with both
    operands; at N=197 B=1 also the FMA kernel on a copy of x off the
    16-byte grid. The bias is the log of token sizes drawn from 1..16; the
    result must also differ beyond the bounds from the plain version
    without the bias (on the maps, or on y in dense f32). Device times
    alone (``time_turns_held``). Returns each route's numbers at N=197,
    B=1, maps + mean (bf16 for the tensor cores and the FMA kernel, f32 for
    split TF32)."""
    import torch
    from interactive_vit_tpu_torch.ops import fused_block as fb

    def tome_counts():
        return tuple(getattr(fb, n).tome_launches for n in (
            "fused_attn_block", "fused_attn_block_mma",
            "fused_attn_block_tf32x3"))

    out = {}
    for n, b in ((197, 1), (197, 8), (109, 1), (21, 1), (11, 1)):
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).replace("torch.", "")
            p = random_block(768, dtype, device, seed=n + b)
            g = torch.Generator().manual_seed(n * 10 + b)
            x = torch.randn((b, n, 768), generator=g).to(device=device,
                                                         dtype=dtype)
            kb = torch.log(torch.randint(1, 17, (b, n), generator=g).float()
                           ).to(device)
            route = "mma" if dtype == torch.bfloat16 else "tf32"
            runs = [(route, x)] + ([("fma", off_grid(x))]
                                   if (n, b) == (197, 1) else [])
            for rt, xr in runs:
                for mode, kw, s8 in (
                        ("maps_off", {}, False),
                        ("maps_mean", {"want_attn": True, "want_mean": True},
                         False),
                        ("s8_maps_mean", {"want_attn": True,
                                          "want_mean": True}, True)):
                    if s8 and ((n, b) != (197, 1) or rt == "fma"):
                        continue
                    kernel = (fb.fused_attn_block_s8 if s8
                              else fb.fused_attn_block)
                    plain = functools.partial(fb.fused_attn_block_reference,
                                              int8_scores=s8)
                    kw = dict(kw, want_metric=True)
                    before = (row1_counts(s8), tome_counts())
                    got = kernel(xr, p, 12, 1e-6, key_bias=kb, **kw)
                    ref = plain(xr, p, 12, 1e-6, key_bias=kb, **kw)
                    torch.cuda.synchronize()
                    step = row1_step(rt)
                    if (row1_counts(s8) != tuple(
                            c + s for c, s in zip(before[0], step))
                            or (not s8 and tome_counts() != tuple(
                                c + s for c, s in zip(before[1], step)))):
                        raise AssertionError(
                            f"ToMe N={n} {dt} {mode}: launches "
                            f"{row1_counts(s8)}, {tome_counts()} after "
                            f"{before}, route {rt}")
                    tag = (f"fused_attn_block_tome N={n} B={b} {dt} ({rt}"
                           + (", off the 16-byte grid" if rt == "fma" else "")
                           + f") {mode}")
                    labels = (("y", "probs", "mean", "metric") if kw.get(
                        "want_mean") else ("y", "probs", "metric"))
                    errs, line = check_outputs(tag, got, ref, dtype, labels,
                                               s8=s8)
                    check_bounds_refuse(tag, got, ref, dtype, labels, s8=s8,
                                        first=0)
                    if kw.get("want_mean") or (dtype == torch.float32
                                               and not s8):
                        try:
                            check_outputs(tag, got, plain(xr, p, 12, 1e-6,
                                                          **kw),
                                          dtype, labels, quiet=True, s8=s8)
                        except AssertionError:
                            pass
                        else:
                            raise AssertionError(f"{tag}: the result "
                                                 f"without the key bias "
                                                 f"passed")
                    if not s8:
                        t_k, t_p, t_host = time_turns_held(
                            lambda: kernel(xr, p, 12, 1e-6, key_bias=kb,
                                           **kw),
                            lambda: plain(xr, p, 12, 1e-6, key_bias=kb,
                                          **kw))
                        maps = bool(kw.get("want_attn"))
                        nbytes, flops = block_cost(b, n, 768, 12,
                                                   x.element_size(),
                                                   12 if maps else 0, maps,
                                                   tome=True)
                        bms, by = bound(nbytes, flops, dt)
                        line += (f"; device time: kernel {t_k:.4f} ms, "
                                 f"plain {t_p:.4f} ms (the wrapper's host "
                                 f"time {t_host:.4f} ms a call); bound "
                                 f"{bms:.5f} ms ({by}: {nbytes / 1e6:.2f} MB,"
                                 f" {flops / 1e9:.3f} G operations)")
                        if rt == "tf32":
                            # three TF32 products a product: the kernels
                            # line carries this bound
                            bms, by = bound(nbytes, {"tf32": 3 * flops}, dt)
                            line += (f"; at the TF32 peak (the split's "
                                     f"{3 * flops / 1e9:.3f} G operations) "
                                     f"{bms:.5f} ms ({by})")
                        if (n, b, mode) == (197, 1, "maps_mean") and (
                                (rt == "tf32") == (dtype == torch.float32)):
                            out[rt] = {"max_abs_err": max(errs), "ms": t_k,
                                       "plain_ms": t_p, "bound_ms": bms,
                                       "bound_by": by, "library_ms": None}
                    log(line)
    return out


def phase_flash_kernel(device) -> dict:
    """The row-resident flash attention against its plain version at every
    case and dtype: bf16 on the tensor-core kernel, f32 on the split-TF32
    kernel, and each, on a copy off the 16-byte grid, on the FMA kernel;
    at vit_h14@224's heads (80 wide) the two kernels' 80-wide
    instantiations, and the FMA kernel off the grid. Returns, maps off,
    the dinov2_s14_reg numbers of the tensor-core kernels (bf16 mma, f32
    tf32), vit_h14@224's of the 80-wide instantiations (mma_dh80,
    tf32_dh80) and of the FMA kernel in bf16 off the grid (fma), SDPA's
    time in the same dtype beside each; the split-TF32 kernel's bound at
    the TF32 peak (three TF32 products a product). Then the crossover of
    ``dispatch.FLASH_MIN_SEQ``: the plain attention's time beside the
    tensor-core kernel's at N = 197, 257 and 577."""
    import torch
    import torch.nn.functional as F

    from interactive_vit_tpu_torch.ops import dispatch
    from interactive_vit_tpu_torch.ops import flash_attention as fa
    from interactive_vit_tpu_torch.ops.attention import attention_reference

    def counts():
        return (fa.flash_attention.launches, fa.flash_attention_mma.launches,
                fa.flash_attention_tf32x3.launches)

    out = {}
    # dinov2_s14_reg@518, vit_l16@384, a padded N; vit_h14@224 (heads 80
    # wide: each dtype on its tensor-core route's 80-wide instantiation)
    # and its padded form
    cases = [("dinov2_s14_reg", (1, 6, 1374, 64), None),
             ("vit_l16", (1, 16, 577, 64), None),
             ("padded", (1, 6, 1408, 64), 1374),
             ("vit_h14", (1, 16, 257, 80), None),
             ("vit_h14 padded", (1, 16, 320, 80), 257)]
    for cname, shape, n_real in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).replace("torch.", "")
            mma = dtype == torch.bfloat16
            g = torch.Generator().manual_seed(shape[2])
            qkv = [(torch.randn(shape, generator=g) * 2).to(device, dtype)
                   for _ in range(3)]
            routes = [("tensor cores" if mma else "split TF32", qkv),
                      ("FMA, off the 16-byte grid",
                       [misaligned(t, 4 if mma else 2) for t in qkv])]
            t_lib = None
            for maps in (False, True):
                if n_real is not None and not maps:
                    continue
                kw = {"want_attn": maps, "n_real": n_real}
                ref = fa.flash_attention_reference(*qkv, **kw)
                nbytes, flops = flash_cost(*shape, qkv[0].element_size(),
                                           maps)
                bms, by = bound(nbytes, flops, dt)
                # the split route's own products: three TF32 ones a product
                tms, tby = bound(nbytes, {"tf32": 3 * flops}, dt)
                for route, (q, k, v) in routes:
                    fma = route.startswith("FMA")
                    before = counts()
                    got = fa.flash_attention(q, k, v, **kw)
                    torch.cuda.synchronize()
                    step = (fma, mma and not fma, not mma and not fma)
                    split = not mma and not fma
                    if counts() != tuple(x + d for x, d in zip(before, step)):
                        raise AssertionError(f"flash {dt} {route}: launches "
                                             f"{counts()} after {before}")
                    tag = (f"flash_attention {cname} {shape} {dt} ({route}) "
                           f"maps {'on' if maps else 'off'}"
                           + (f" n_real={n_real}" if n_real else ""))
                    errs, line = check_outputs(tag, got, ref, dtype,
                                               ("o", "probs"))
                    # the bounds refuse o and the tap zeroed or halved
                    check_bounds_refuse(tag, got, ref, dtype, ("o", "probs"),
                                        first=0)
                    if n_real is not None:
                        if not torch.all(got[1][..., n_real:] == 0):
                            raise AssertionError(f"{tag}: masked keys got "
                                                 f"probs")
                        log(line + "; masked keys' probs exactly 0")
                        continue
                    t_k, t_p, t_host = time_turns_held(
                        lambda: fa.flash_attention(q, k, v, **kw),
                        lambda: fa.flash_attention_reference(q, k, v, **kw))
                    line += (f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms "
                             f"(device time; the wrapper's host time "
                             f"{t_host:.4f} ms a call); bound {bms:.5f} ms "
                             f"({by}: {nbytes / 1e6:.2f} MB, "
                             f"{flops / 1e9:.3f} GFLOP)")
                    if not mma:
                        line += (f", at the TF32 peak (the split's "
                                 f"{3 * flops / 1e9:.3f} GFLOP) {tms:.5f} ms "
                                 f"({tby})")
                    if not maps and t_lib is None:
                        t_lib, _ = time_held(
                            lambda: F.scaled_dot_product_attention(*qkv))
                    if not maps:
                        line += (f"; scaled_dot_product_attention ({dt}) "
                                 f"{t_lib:.4f} ms")
                    nums = {"max_abs_err": max(errs), "ms": t_k,
                            "plain_ms": t_p,
                            "bound_ms": tms if split else bms,
                            "bound_by": tby if split else by,
                            "library_ms": t_lib}
                    # the result line: bf16 on the tensor cores and f32 on
                    # split TF32 at dinov2_s14_reg; the FMA kernel in bf16
                    # at vit_h14@224, off the grid, beside the 80-wide
                    # instantiations
                    if cname == "dinov2_s14_reg" and not maps and not fma:
                        out["mma" if mma else "tf32"] = nums
                    if cname == "vit_h14" and not maps:
                        if split:
                            out["tf32_dh80"] = nums
                        elif mma:
                            out["fma" if fma else "mma_dh80"] = nums
                    log(line)
    log(dh80_summary("flash_attention", "vit_h14@224 (1, 16, 257, 80) maps "
                     "off", out["mma_dh80"], out["fma"]))

    # FLASH_MIN_SEQ: below it auto_attention runs the plain attention
    for n in (197, 257, 577):
        g = torch.Generator().manual_seed(n)
        q, k, v = [(torch.randn((1, 6, n, 64), generator=g) * 2).to(
            device, torch.bfloat16) for _ in range(3)]
        parts = []
        for maps in (False, True):
            t_k, t_p, t_host = time_turns_held(
                lambda: fa.flash_attention(q, k, v, want_attn=maps),
                lambda: attention_reference(q, k, v, want_attn=maps))
            parts.append(f"maps {'on' if maps else 'off'}: tensor-core "
                         f"kernel {t_k:.4f} ms (host {t_host:.4f} ms a "
                         f"call), plain attention {t_p:.4f} ms")
        log(f"  FLASH_MIN_SEQ={dispatch.FLASH_MIN_SEQ} crossover, 6 heads, "
            f"N={n}, bf16, device time: " + "; ".join(parts))
    return out


def dh80_summary(what, shape, mma, fma) -> str:
    """One line for a bf16 80-wide tensor-core instantiation's numbers
    beside the FMA kernel's from the same call."""
    return (f"  {what} {shape} bf16, heads 80 wide: tensor cores "
            f"{mma['ms']:.4f} ms, FMA (off the 16-byte grid, same call) "
            f"{fma['ms']:.4f} ms, scaled_dot_product_attention "
            f"{mma['library_ms']:.4f} ms, plain {mma['plain_ms']:.4f} ms, "
            f"bound {mma['bound_ms']:.5f} ms ({mma['bound_by']}); the "
            f"tensor cores at {mma['ms'] / mma['library_ms']:.2f}x SDPA, "
            f"FMA at {fma['ms'] / mma['library_ms']:.2f}x")


def window_cost(b, res, c, heads, win, esize, maps, masked):
    """Bytes and FLOPs of one window-attention branch (QKV + W-MSA + proj)
    on a [b, res, res, c] map: the map, the weights, the f32 bias (and
    seam mask) read once; the branch output (and the maps) written once."""
    t, nw = win * win, (res // win) ** 2
    rows = b * res * res
    nbytes = (esize * (2 * rows * c + 4 * c * c + 4 * c
                       + (b * nw * heads * t * t if maps else 0))
              + 4 * (heads * t * t + (nw * t * t if masked else 0)))
    flops = (2 * rows * c * 3 * c + 2 * rows * c * c
             + 4 * b * nw * heads * t * t * (c // heads))
    return nbytes, flops


def mlp_cost(rows, d, md, esize):
    """Bytes and FLOPs of one MLP branch on ``rows`` rows of width d: x,
    LN, both weight matrices and biases read once, y written once."""
    return esize * (2 * rows * d + 2 * d * md + md + 3 * d), 4 * rows * d * md


def window_counts():
    """The launch counts of row 5's routes: {"fma", "mma", "tf32": n}."""
    from interactive_vit_tpu_torch.ops import fused_window as fw

    return {rt: w.launches for rt, w in fw._WINDOW_WRAPPERS.items()}


def check_window_case(tag, fw, args, dtype, maps, fast, route):
    """One launch of the window wrapper against its plain version (only
    ``route``'s count may move), the bounds' refusal of a zeroed or halved
    tap, and the seam pairs of a shifted block. Returns (max abs errs, the
    line for the log)."""
    import torch

    mask = args[-1]
    kw = {"want_attn": maps, "fast_softmax": fast}
    before = window_counts()
    got = fw.fused_window_attn(*args, **kw)
    torch.cuda.synchronize()
    if window_counts() != dict(before, **{route: before[route] + 1}):
        raise AssertionError(f"{tag}: launches {window_counts()} after "
                             f"{before}, route {route}")
    ref = fw.fused_window_attn_reference(*args, **kw)
    errs, line = check_outputs(tag, got, ref, dtype, ("a", "probs"))
    check_bounds_refuse(tag, got, ref, dtype, ("a", "probs"))
    if maps and mask is not None:
        seam = got[1].float()[(mask[None, :, None] < 0).expand_as(got[1])]
        # exp(-100): exactly 0 in bf16, a denormal in f32
        clean = (seam == 0 if dtype == torch.bfloat16 else seam < 1e-37)
        if seam.numel() == 0 or not bool(clean.all()):
            raise AssertionError(f"{tag}: masked seam pairs got probs")
    return errs, line


def phase_window_kernel(device) -> dict:
    """Row 5, the window attention, against its plain version at every
    shape a served request or the monolithic forward gives it: bf16 on
    the tensor cores, f32 on split TF32 (the launch counts show the
    route), shift 0 and 3, maps off and on, fast and exact softmax; and
    the FMA kernel on a copy of y off the 16-byte grid (fast softmax).
    Device times alone (``time_turns_held``) beside the bound (f32 also at
    the TF32 peak, the one its entry carries); the FMA kernel timed at B=1
    unshifted with maps off; ``scaled_dot_product_attention`` on the
    attention part alone at B=1 in both dtypes, a yardstick the port never
    calls. Returns the numbers of each route at the shape most of a served
    swin_t request's launches have (stage 2: 6 of 12 blocks; unshifted,
    maps off): "mma" bf16, "tf32" f32, "fma" bf16 off the grid."""
    import itertools

    import torch
    import torch.nn.functional as F

    from interactive_vit_tpu_torch.models import swin
    from interactive_vit_tpu_torch.ops import fused_window as fw

    out, summary = {}, {}
    win = 7
    t = win * win
    # every shape a served request (B=1; concurrent requests batch) or the
    # monolithic forward (B=1 and 8) gives the kernel, and one swin_b stage
    stage_shapes = [("swin_t stage0", 56, 96, 3), ("swin_t stage1", 28, 192, 6),
                    ("swin_t stage2", 14, 384, 12),
                    ("swin_t stage3", 7, 768, 24)]
    shapes = ([(sname, b, res, c, heads)
               for sname, res, c, heads in stage_shapes for b in (1, 8)]
              + [("swin_b stage2", 1, 14, 512, 16)])
    for (sname, b, res, c, heads), dtype in itertools.product(
            shapes, (torch.bfloat16, torch.float32)):
        nw = (res // win) ** 2
        dt = str(dtype).replace("torch.", "")
        g = torch.Generator().manual_seed(res * 1000 + c + b)

        def rnd(*shape, std=1.0):
            return (torch.randn(shape, generator=g) * std).to(
                device=device, dtype=dtype)

        p = {"qkv_w": rnd(c, 3 * c, std=c ** -0.5), "qkv_b": rnd(3 * c, std=0.1),
             "proj_w": rnd(c, c, std=c ** -0.5), "proj_b": rnd(c, std=0.1)}
        y = rnd(b, res, res, c)
        bias = rnd(heads, t, t, std=0.5)
        route = "mma" if dtype == torch.bfloat16 else "tf32"
        for rt, yr in ((route, y), ("fma", off_grid(y))):
            if fw._window_route_of(yr, p, heads, win) != rt:
                raise AssertionError(f"fused_window_attn {sname} {dt}: route "
                                     f"{fw._window_route_of(yr, p, heads, win)}"
                                     f", expected {rt}")
            # a stage of one window has no shifted block (the shift clamps
            # to 0)
            for shift, maps in itertools.product((0, 3) if nw > 1 else (0,),
                                                 (False, True)):
                mask = swin.shift_attn_mask(res, win, shift)
                if mask is not None:
                    mask = torch.from_numpy(mask).to(device)
                args = (yr, p, heads, win, bias, mask)
                tag = (f"fused_window_attn {sname} B={b} {dt} ({rt}"
                       + (", off the 16-byte grid" if rt == "fma" else "")
                       + f") shift={shift} maps {'on' if maps else 'off'}")
                errs, line = check_window_case(tag, fw, args, dtype, maps,
                                               True, rt)
                if rt != "fma":
                    exact_errs, _ = check_window_case(tag + " exact", fw, args,
                                                      dtype, maps, False, rt)
                    line += f"; exact softmax {max(exact_errs):.3g}"
                elif b > 1 or shift or maps:
                    log(line)
                    continue
                kw = {"want_attn": maps}
                t_k, t_p, t_host = time_turns_held(
                    lambda: fw.fused_window_attn(*args, **kw),
                    lambda: fw.fused_window_attn_reference(*args, **kw))
                nbytes, flops = window_cost(b, res, c, heads, win,
                                            y.element_size(), maps,
                                            mask is not None)
                bms, by = bound(nbytes, flops, dt)
                line += (f"; device time: kernel {t_k:.4f} ms, plain "
                         f"{t_p:.4f} ms (the wrapper's host time "
                         f"{t_host:.4f} ms a call); bound {bms:.5f} ms ({by}: "
                         f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
                if rt == "tf32":
                    # three TF32 products a product: the kernels line
                    # carries this bound
                    bms, by = bound(nbytes, {"tf32": 3 * flops}, dt)
                    line += (f"; at the TF32 peak {bms:.5f} ms ({by})")
                log(line)
                if b == 1 and not shift and not maps:
                    summary[sname, dt, rt] = t_k
                if ((sname, b, shift, maps) == ("swin_t stage2", 1, 0, False)
                        and (rt != "fma" or dtype == torch.bfloat16)):
                    out[rt] = {"max_abs_err": max(errs), "ms": t_k,
                               "plain_ms": t_p, "bound_ms": bms,
                               "bound_by": by, "library_ms": None}
        if b == 1:
            # yardstick for the attention part alone (no QKV, no proj): one
            # library call on ready-made q, k, v with the additive bias; the
            # port never calls it
            q, k, v = (rnd(b, nw, heads, t, c // heads) for _ in range(3))
            add = bias[None].expand(nw, heads, t, t)
            t_lib, _ = time_held(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=add))
            summary[sname, dt, "sdpa"] = t_lib
            log(f"  {sname} {dt}: scaled_dot_product_attention on the "
                f"attention part (q, k, v [{b}, {nw}, {heads}, {t}, "
                f"{c // heads}] + bias) {t_lib:.4f} ms (device time)")
    for sname, _, _, _ in stage_shapes + [("swin_b stage2", 0, 0, 0)]:
        log(f"  row 5 {sname} B=1 unshifted maps off, device time: bf16 "
            f"tensor cores {summary[sname, 'bfloat16', 'mma']:.4f} ms, FMA "
            f"(off the grid) {summary[sname, 'bfloat16', 'fma']:.4f}; f32 "
            f"split TF32 {summary[sname, 'float32', 'tf32']:.4f}, FMA "
            f"{summary[sname, 'float32', 'fma']:.4f}; SDPA on the attention "
            f"part bf16 {summary[sname, 'bfloat16', 'sdpa']:.4f}, f32 "
            f"{summary[sname, 'float32', 'sdpa']:.4f}")
    return out


def mlp_library_yardstick(x, p, eps):
    """Row 6's function in five library calls (a yardstick, not one call:
    ``library_ms`` stays null), in the inputs' dtype (f32 with TF32 off):
    ``F.layer_norm``, ``addmm``, the tanh ``gelu``, ``addmm`` and the
    residual. The port never calls it."""
    import torch
    import torch.nn.functional as F

    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    ln = F.layer_norm(x2, (d,), p["ln2_s"], p["ln2_b"], eps)
    h = F.gelu(torch.addmm(p["fc1_b"], ln, p["fc1_w"]), approximate="tanh")
    return (x2 + torch.addmm(p["fc2_b"], h, p["fc2_w"])).view_as(x)


def phase_mlp_kernel(device) -> dict:
    """The fused MLP's kernels against their plain version at every shape
    the monolithic forwards give them (vit_b16 and swin_t's four stages,
    B=1 and 8): bf16 operands on the tensor cores (``fused_mlp_block_mma``:
    rows of whole 128-column chunks, or 96-column ones for swin_t's stages
    0 and 1), f32 on split TF32 (``fused_mlp_block_tf32x3``), each two
    calls the same bits, and the FMA kernel beside each on a copy of x off
    the 16-byte grid (the same values); device times alone (``time_held``:
    the wrappers' host time exceeds the tensor-core kernels') beside the
    bound (f32 at the TF32 peak, the one its entry carries, and at the f32
    FMA peak), the plain version and five library calls as a yardstick (in
    f32 with TF32 off). Returns the numbers of each kernel at vit_b16 (197
    x 768, B=1): the bf16 tensor cores and the FMA kernel in bf16, split
    TF32 in f32."""
    import torch

    from interactive_vit_tpu_torch.ops import fused_mlp as fm

    out = {}
    # every shape the monolithic forwards give the kernels (B=1 and 8):
    # vit_b16's block and swin_t's four stages
    shapes = [(sname, b, n, d, eps)
              for sname, n, d, eps in (("vit_b16", 197, 768, 1e-6),
                                       ("swin_t stage0", 3136, 96, 1e-5),
                                       ("swin_t stage1", 784, 192, 1e-5),
                                       ("swin_t stage2", 196, 384, 1e-5),
                                       ("swin_t stage3", 49, 768, 1e-5))
              for b in (1, 8)]
    for route, (d, md) in (("mma", (768, 3072)), ("mma", (96, 384)),
                           ("tf32", (768, 3072)), ("tf32", (96, 384))):
        dtype = torch.bfloat16 if route == "mma" else torch.float32
        tiles = ([(bm, fm.tf32_smem_bytes(d, md, bm))
                  for bm in fm.tf32_tiles(d)] if route == "tf32"
                 else [(32, None), (64, fm.mma_smem_bytes(d, md))])
        log(f"  fused_mlp_block {route} route at ({d}, {md}), clusters of "
            f"{fm.cluster_of(d, md)} blocks on chunks of {fm.chunk_of(d)}: "
            + "; ".join(
                f"tiles of {bm} rows: "
                + (f"{smem} bytes of shared memory a block, "
                   if smem is not None else "")
                + (f"{fm.max_active_clusters(route, d, md, dtype, bm=bm)} "
                   f"clusters fit the card at once"
                   if smem is None or smem <= fm.SMEM_LIMIT else "over the "
                   f"card's shared memory") for bm, smem in tiles))
    names = {"mma": "fused_mlp_block_mma", "tf32": "fused_mlp_block_tf32x3",
             "fma": "fused_mlp_block"}
    for sname, b, n, d, eps in shapes:
        md = 4 * d
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).replace("torch.", "")
            g = torch.Generator().manual_seed(n + d + b)

            def rnd(*shape, std=1.0, mean=0.0):
                return (torch.randn(shape, generator=g) * std + mean).to(
                    device=device, dtype=dtype)

            p = {"ln2_s": rnd(d, std=0.1, mean=1.0), "ln2_b": rnd(d, std=0.1),
                 "fc1_w": rnd(d, md, std=d ** -0.5),
                 "fc1_b": rnd(md, std=0.1),
                 "fc2_w": rnd(md, d, std=md ** -0.5),
                 "fc2_b": rnd(d, std=0.1)}
            x = rnd(b, n, d)
            ref = fm.fused_mlp_block_reference(x, p, eps)
            tag = f"fused_mlp_block {sname} B={b} {n}x{d} {dt}"
            nbytes, flops = mlp_cost(b * n, d, md, x.element_size())
            f32 = dtype == torch.float32
            # f32: three TF32 products a product on the tensor cores, the
            # bound the split-TF32 entry carries; beside it the f32 FMA peak
            bms, by = bound(nbytes, {"tf32": 3 * flops} if f32 else flops, dt)
            cost = (f"bound {bms:.5f} ms ({by}: {nbytes / 1e6:.2f} MB, "
                    f"{flops / 1e9:.3f} GFLOP"
                    + (f", at the TF32 peak x3; at the f32 FMA peak "
                       f"{bound(nbytes, flops, dt)[0]:.5f} ms" if f32 else "")
                    + ")")
            # each dtype's tensor-core route; the FMA kernel on a copy of x
            # off the 16-byte grid beside it
            route = fm._mlp_route_of(x, p)
            if route != ("tf32" if f32 else "mma"):
                raise AssertionError(f"{tag}: the route is {route}")
            nums = {}
            for rt, xr in ((route, x), ("fma", off_grid(x))):
                name = names[rt]
                counter = getattr(fm, name)
                before = (counter.launches,
                          sum(getattr(fm, k).launches for k in names.values()))
                got = fm.fused_mlp_block(xr, p, eps)
                again = fm.fused_mlp_block(xr, p, eps)
                torch.cuda.synchronize()
                if (counter.launches - before[0] != 2
                        or sum(getattr(fm, k).launches for k in names.values())
                        - before[1] != 2):
                    raise AssertionError(f"{tag}: not on the {rt} route")
                rtag = f"{tag} ({name})"
                errs, line = check_outputs(rtag, (got,), (ref,), dtype,
                                           ("y",))
                try:  # the bound must refuse the residual alone
                    check_outputs(rtag, (xr,), (ref,), dtype, ("y",),
                                  quiet=True)
                except AssertionError:
                    pass
                else:
                    raise AssertionError(f"{rtag}: x alone passed the bound")
                if rt != "fma" and not torch.equal(got, again):
                    raise AssertionError(f"{rtag}: two calls differ")
                t_k, t_p, t_host = time_turns_held(
                    lambda: fm.fused_mlp_block(xr, p, eps),
                    lambda: fm.fused_mlp_block_reference(xr, p, eps))
                nums[rt] = {"max_abs_err": max(errs), "ms": t_k,
                            "plain_ms": t_p, "bound_ms": bms,
                            "bound_by": by, "library_ms": None}
                if rt != "fma":
                    line += (f", two calls the same bits, tiles of "
                             f"{fm.row_tile(rt, b * n, d, md, dtype)} rows "
                             f"in clusters of {fm.cluster_of(d, md)}, "
                             f"chunks of {fm.chunk_of(d)}")
                log(line + f"; kernel {t_k:.4f} ms (device "
                    f"time; the wrapper's host time {t_host:.4f} ms a "
                    f"call), plain {t_p:.4f} ms; {cost}")
            lib_err = (mlp_library_yardstick(x, p, eps).float()
                       - ref.float()).abs().max().item()
            t_lib, _ = time_held(lambda: mlp_library_yardstick(x, p, eps))
            log(f"  {tag}: yardstick of five library calls (layer_norm, "
                f"addmm, gelu, addmm, residual{', TF32 off' if f32 else ''})"
                f" {t_lib:.4f} ms (device time; max abs diff {lib_err:.3g} "
                f"from the plain version); {names[route]} at "
                f"{nums[route]['ms'] / t_lib:.2f}x it, the FMA kernel at "
                f"{nums['fma']['ms'] / t_lib:.2f}x; {names[route]} "
                f"{nums['fma']['ms'] / nums[route]['ms']:.2f}x faster than "
                f"the FMA kernel")
            if (sname, b) == ("vit_b16", 1):
                out.update({route: nums[route]} if f32 else nums)
    return out


def rowfull_plain(q, k, v, want_attn=False, n_real=None):
    """``attn_impl`` of the row-resident kernel's plain version (the
    vit_h14 forward's reference)."""
    from interactive_vit_tpu_torch.ops import flash_attention as fa

    return fa.flash_attention_reference(q, k, v, want_attn, n_real)


def online_plain(q, k, v, want_attn=False, n_real=None):
    """``attn_impl`` of the served dinov2_s14_reg@742 path's plain version:
    the online kernel's plain version (no maps)."""
    from interactive_vit_tpu_torch.ops import flash_attention as fa

    return fa.flash_attention_online_reference(q, k, v, n_real), None


def misaligned(t, pad: int = 4):
    """A copy of ``t`` [..., W] whose row stride is ``pad`` elements
    longer: bf16 rows (pad 4) or f32 rows (pad 2) then start 8 bytes off
    the 16-byte grid, so ``mma_route`` and ``tf32_route`` send them to the
    FMA kernels (the same values)."""
    import torch

    wide = torch.zeros(t.shape[:-1] + (t.shape[-1] + pad,), dtype=t.dtype,
                       device=t.device)
    wide[..., :t.shape[-1]] = t
    return wide[..., :t.shape[-1]]


def phase_online_kernel(device) -> dict:
    """The online flash attention against its plain version at JAX's key
    tile, at the dinov2_s14_reg@742 shape (6 heads, N=2814, dh=64; B=1 and
    8, and keys masked beyond n_real=2800): bf16 on the tensor-core kernel,
    f32 on the split-TF32 kernel, and each dtype, on a copy off the 16-byte
    grid, on the FMA kernel they replace; then at vit_h14@742's shape (16
    heads 80 wide, N=2810, and keys masked beyond 2800): each dtype on its
    tensor-core kernel's 80-wide instantiation and, off the grid, on the
    FMA kernel. Returns the B=1 numbers of the tensor-core kernels (bf16
    for mma, f32 for tf32 at 64; mma_dh80 and tf32_dh80 at 80 wide) and
    the FMA kernel's in bf16 off the grid at vit_h14@742 (fma), SDPA's time
    in the same dtype beside each."""
    import torch
    import torch.nn.functional as F

    from interactive_vit_tpu_torch.ops import flash_attention as fa

    def counts():
        return (fa.flash_attention_online.launches,
                fa.flash_attention_online_mma.launches,
                fa.flash_attention_online_tf32x3.launches)

    out = {}
    heads, n, dh = ONLINE_SHAPE
    for b, n_real in ((1, None), (8, None), (1, n - 14)):
        shape = (b, heads, n, dh)
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).replace("torch.", "")
            mma = dtype == torch.bfloat16
            g = torch.Generator().manual_seed(b)
            # q, k, v as qkv_proj makes them: views of one [B, N, 3D]
            qkv = (torch.randn((b, n, 3 * heads * dh), generator=g) * 2).to(
                device, dtype)
            routes = [("tensor cores" if mma else "split TF32", qkv),
                      ("FMA, off the 16-byte grid",
                       misaligned(qkv, 4 if mma else 2))]
            ref = None
            t_routes = {}
            for route, x in routes:
                q, k, v = (x.reshape(b, n, 3, heads, dh)[:, :, i]
                           .transpose(1, 2) for i in range(3))
                before = counts()
                got = fa.flash_attention_online(q, k, v, n_real)
                torch.cuda.synchronize()
                fma = route.startswith("FMA")
                want = (before[0] + fma, before[1] + (mma and not fma),
                        before[2] + (not mma and not fma))
                if counts() != want:
                    raise AssertionError(f"online {dt} {route}: launches "
                                         f"{counts()} after {before}")
                if ref is None:
                    ref = fa.flash_attention_online_reference(
                        q, k, v, n_real, block_k=fa.ONLINE_BLOCK_K)
                tag = (f"flash_attention_online dinov2_s14_reg@742 {shape} "
                       f"{dt} ({route})"
                       + (f" n_real={n_real}" if n_real else ""))
                errs, line = check_outputs(tag, (got,), (ref,), dtype,
                                           ("o",))
                check_bounds_refuse(tag, (got,), (ref,), dtype, ("o",),
                                    first=0)
                log(line)
                if n_real is None:
                    t_routes[route] = (time_ms(
                        lambda: fa.flash_attention_online(q, k, v)), errs)
            if n_real is not None:
                continue
            q, k, v = (qkv.reshape(b, n, 3, heads, dh)[:, :, i]
                       .transpose(1, 2) for i in range(3))
            t_k, t_p = time_turns(
                lambda: fa.flash_attention_online(q, k, v),
                lambda: fa.flash_attention_online_reference(q, k, v))
            nbytes, flops = flash_cost(*shape, q.element_size(), False)
            bms, by = bound(nbytes, flops, dt)
            # the split route's own products: three TF32 ones a product
            tms, tby = bound(nbytes, {"tf32": 3 * flops}, dt)
            t_lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            log(f"  flash_attention_online {shape} {dt}: "
                + ", ".join(f"{r} {t:.4f} ms" for r, (t, _) in
                            t_routes.items())
                + f"; in turns kernel {t_k:.4f} ms, plain {t_p:.4f} ms; "
                f"bound {bms:.5f} ms ({by}: {nbytes / 1e6:.2f} MB, "
                f"{flops / 1e9:.3f} GFLOP)"
                + ("" if mma else f", the split's {3 * flops / 1e9:.3f} "
                   f"GFLOP of TF32 products {tms:.5f} ms ({tby})")
                + f"; scaled_dot_product_attention {t_lib:.4f} ms")
            if b == 1:
                if mma:
                    out["mma"] = {
                        "max_abs_err": max(t_routes[routes[0][0]][1]),
                        "ms": t_k, "plain_ms": t_p, "bound_ms": bms,
                        "bound_by": by, "library_ms": t_lib}
                    continue
                out["tf32"] = {
                    "max_abs_err": max(t_routes[routes[0][0]][1]),
                    "ms": t_k, "plain_ms": t_p, "bound_ms": tms,
                    "bound_by": tby, "library_ms": t_lib}

    # vit_h14@742's attention, heads 80 wide: f32 on the split-TF32
    # kernel's 80-wide instantiation, bf16 on the tensor-core kernel's, and
    # each, off the 16-byte grid, on the FMA kernel
    b, heads, n, dh = VIT_H14_742_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).replace("torch.", "")
        f32 = dtype == torch.float32
        g = torch.Generator().manual_seed(n)
        qkv = (torch.randn((b, n, 3 * heads * dh), generator=g) * 2).to(
            device, dtype)
        pad = 2 if f32 else 4  # rows 8 bytes off the 16-byte grid
        routes = [("split TF32" if f32 else "tensor cores", qkv),
                  ("FMA, off the 16-byte grid", misaligned(qkv, pad))]
        nbytes, flops = flash_cost(b, heads, n, dh, qkv.element_size(),
                                   False)
        bms, by = bound(nbytes, flops, dt)
        tms, tby = bound(nbytes, {"tf32": 3 * flops}, dt)
        t_lib = None
        for route, x in routes:
            q, k, v = (x.reshape(b, n, 3, heads, dh)[:, :, i].transpose(1, 2)
                       for i in range(3))
            fma = route.startswith("FMA")
            for n_real in (None, n - 10):
                before = counts()
                got = fa.flash_attention_online(q, k, v, n_real)
                torch.cuda.synchronize()
                tc = not fma
                if counts() != (before[0] + fma, before[1] + (tc and not f32),
                                before[2] + (tc and f32)):
                    raise AssertionError(f"online {dt} dh={dh} {route}: "
                                         f"launches {counts()} after "
                                         f"{before}")
                ref = fa.flash_attention_online_reference(
                    q, k, v, n_real, block_k=fa.ONLINE_BLOCK_K)
                tag = (f"flash_attention_online vit_h14@742 "
                       f"{tuple(q.shape)} {dt} ({route})"
                       + (f" n_real={n_real}" if n_real else ""))
                errs, line = check_outputs(tag, (got,), (ref,), dtype,
                                           ("o",))
                check_bounds_refuse(tag, (got,), (ref,), dtype, ("o",),
                                    first=0)
                if n_real is not None:
                    log(line)
                    continue
                t_k, t_p = time_turns(
                    lambda: fa.flash_attention_online(q, k, v),
                    lambda: fa.flash_attention_online_reference(q, k, v))
                if t_lib is None:
                    t_lib = time_ms(
                        lambda: F.scaled_dot_product_attention(q, k, v))
                split = f32 and not fma
                log(line + f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms; "
                    f"bound {bms:.5f} ms ({by}: {nbytes / 1e6:.2f} MB, "
                    f"{flops / 1e9:.3f} GFLOP)"
                    + (f", at the TF32 peak (the split's "
                       f"{3 * flops / 1e9:.3f} GFLOP) {tms:.5f} ms ({tby})"
                       if split else "")
                    + f"; scaled_dot_product_attention ({dt}) "
                    f"{t_lib:.4f} ms")
                nums = {"max_abs_err": max(errs), "ms": t_k, "plain_ms": t_p,
                        "bound_ms": tms if split else bms,
                        "bound_by": tby if split else by, "library_ms": t_lib}
                # the FMA kernel in bf16, off the grid, beside the 80-wide
                # tensor-core instantiation
                if split:
                    out["tf32_dh80"] = nums
                elif not f32:
                    out["fma" if fma else "mma_dh80"] = nums
    log(dh80_summary("flash_attention_online", "vit_h14@742 (1, 16, 2810, "
                     "80)", out["mma_dh80"], out["fma"]))
    return out


def check_w8a8_parts(tag, p, parts, rparts) -> str:
    """The W8A8 kernel's integer stages: its s32 accumulators equal the
    exact products of its own int8 activations (a zeroed or halved
    accumulator fails), and those activations are the plain version's but
    for at most ``W8A8_Q_SHARE`` of them: q1 off by 1 (an LN value one ulp
    away), q2 off by at most 2 in rows whose q1 agrees (an h value and the
    row's scale each one bf16 ulp away); a row whose q1 differs moves its
    h by a whole fc1 quantization step, which only y's bound holds."""
    import torch

    from interactive_vit_tpu_torch.ops import quant

    notes = []
    q1_rows = (parts["q1"] == rparts["q1"]).all(dim=-1, keepdim=True)
    for acc, q, w, most in (("acc1", "q1", "fc1_w", 1),
                            ("acc2", "q2", "fc2_w", 2)):
        exact = quant.int_matmul(parts[q], p[w][quant.AQKEY])
        if not torch.equal(parts[acc], exact):
            raise AssertionError(f"{tag}: {acc} is not the exact product")
        if torch.equal(parts[acc] * 0, exact) or torch.equal(
                parts[acc] // 2, exact):
            raise AssertionError(f"{tag}: a zeroed or halved {acc} passed")
        diff = (parts[q].int() - rparts[q].int()).abs()
        share = (diff > 0).float().mean().item()
        held = (diff * q1_rows).max().item()
        if held > most or share > W8A8_Q_SHARE:
            raise AssertionError(f"{tag}: {q} differs from the plain "
                                 f"version's in {share:.3g} of places, by up "
                                 f"to {held} where q1 agrees")
        notes.append(f"{acc} exact, {q} differs in {share:.3g} (by up to "
                     f"{diff.max().item()})")
    return ", ".join(notes)


def w8a8_case(device, label, b, n, d, md, dtype, seed) -> dict:
    """One W8A8 MLP shape (B=``b``, ``n`` rows of ``d``, ``md`` hidden) in
    ``dtype``, seeded weights and x: the int8 tensor-core route
    (``fused_mlp_w8a8_block_mma``, two calls the same bits) and, on a copy
    of x off the 16-byte grid, the ``__dp4a`` kernel, each with exact
    integer stages and y within its bound; device times alone beside the
    bound, the plain version and ``torch._int_mm`` on both products (a
    yardstick of two library calls, no LayerNorm or quantization). Returns
    {route: the kernels-line numbers}."""
    import torch

    from interactive_vit_tpu_torch.ops import fused_mlp as fm
    from interactive_vit_tpu_torch.ops import quant

    eps = 1e-6
    dt = str(dtype).replace("torch.", "")
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=g) * std + mean).to(
            device=device, dtype=dtype)

    p = {"ln2_s": rnd(d, std=0.1, mean=1.0), "ln2_b": rnd(d, std=0.1),
         "fc1_w": quant.quantize_weight(rnd(d, md, std=d ** -0.5), "w8a8"),
         "fc1_b": rnd(md, std=0.1),
         "fc2_w": quant.quantize_weight(rnd(md, d, std=md ** -0.5), "w8a8"),
         "fc2_b": rnd(d, std=0.1)}
    x = rnd(b, n, d)
    ref, rparts = fm.fused_mlp_w8a8_parts(x, p, eps)
    rows = b * n
    nbytes = (x.element_size() * (2 * rows * d + 3 * d + md)
              + 2 * d * md + 4 * (md + d))
    ops = {"int8": 4 * rows * d * md}
    bms, by = bound(nbytes, ops, dt)
    tag = f"fused_mlp_w8a8_block {label} B={b} {n}x{d} {dt}"
    if fm._w8a8_route_of(x, p) != "mma":
        raise AssertionError(f"{tag}: not on the tensor-core route")
    nums = {}
    for route, xr in (("mma", x), ("dp4a", off_grid(x))):
        name = ("fused_mlp_w8a8_block_mma" if route == "mma"
                else "fused_mlp_w8a8_block")
        counter = getattr(fm, name)
        before = (counter.launches, fm.fused_mlp_w8a8_block.launches
                  + fm.fused_mlp_w8a8_block_mma.launches,
                  fm.fused_mlp_w8a8_block_mma.narrow_launches)
        got, parts = fm.fused_mlp_w8a8_block(xr, p, eps, want_parts=True)
        again = fm.fused_mlp_w8a8_block(xr, p, eps)
        torch.cuda.synchronize()
        # the instantiation at chunks of 96 counts its launches apart too
        narrow = 2 * (route == "mma" and fm.chunk_of(d) == 96)
        if (counter.launches - before[0] != 2
                or fm.fused_mlp_w8a8_block.launches
                + fm.fused_mlp_w8a8_block_mma.launches - before[1] != 2
                or fm.fused_mlp_w8a8_block_mma.narrow_launches - before[2]
                != narrow):
            raise AssertionError(f"{tag}: not on the {route} route")
        rtag = f"{tag} ({name})"
        errs, line = check_outputs(rtag, (got,), (ref,), dtype, ("y",),
                                   s8=True)
        check_bounds_refuse(rtag, (got,), (ref,), dtype, ("y",), s8=True,
                            first=0)
        try:  # the bound must refuse the residual alone
            check_outputs(rtag, (xr,), (ref,), dtype, ("y",), quiet=True,
                          s8=True)
        except AssertionError:
            pass
        else:
            raise AssertionError(f"{rtag}: x alone passed the bound")
        if not torch.equal(got, again):
            raise AssertionError(f"{rtag}: two calls differ")
        line += ("; " + check_w8a8_parts(rtag, p, parts, rparts)
                 + ", two calls the same bits")
        if route == "mma":
            line += (f", tiles of {fm.row_tile('w8a8', rows, d, md, dtype)} "
                     f"rows in clusters of {fm.cluster_of(d, md)} at chunks "
                     f"of {fm.chunk_of(d)}")
        t_k, t_p, t_host = time_turns_held(
            lambda: fm.fused_mlp_w8a8_block(xr, p, eps),
            lambda: fm.fused_mlp_w8a8_reference(xr, p, eps))
        nums[route] = {"max_abs_err": max(errs), "ms": t_k, "plain_ms": t_p,
                       "bound_ms": bms, "bound_by": by, "library_ms": None}
        log(line + f"; kernel {t_k:.4f} ms (device time; the wrapper's host "
            f"time {t_host:.4f} ms a call), plain {t_p:.4f} ms; bound "
            f"{bms:.5f} ms ({by}: {nbytes / 1e6:.2f} MB, "
            f"{ops['int8'] / 1e9:.3f} G int8 operations)")
    # the two products alone, one library call each: a yardstick (no
    # LayerNorm, GELU or quantization); the port never calls it
    q1 = rparts["q1"].reshape(rows, d)
    q2 = rparts["q2"].reshape(rows, md)
    w1, w2 = p["fc1_w"][quant.AQKEY], p["fc2_w"][quant.AQKEY]
    try:
        t_lib, _ = time_held(lambda: (torch._int_mm(q1, w1),
                                      torch._int_mm(q2, w2)))
        t_fc1, _ = time_held(lambda: torch._int_mm(q1, w1))
        log(f"  {tag}: yardstick torch._int_mm on fc1 and fc2 {t_lib:.4f} "
            f"ms (device time; fc1 alone {t_fc1:.4f}); the tensor cores at "
            f"{nums['mma']['ms'] / t_lib:.2f}x it, __dp4a at "
            f"{nums['dp4a']['ms'] / t_lib:.2f}x")
    except RuntimeError as e:
        log(f"  {tag}: torch._int_mm refused: {str(e)[:80]}")
    return nums


def phase_w8a8_kernel(device) -> dict:
    """The W8A8 MLP's kernels against their plain version at vit_b16 (197 x
    768, hidden 3072; B=1 and 8), bf16 and f32 (``w8a8_case``). Returns
    both kernels' B=1 bf16 numbers."""
    import torch

    from interactive_vit_tpu_torch.ops import fused_mlp as fm

    out = {}
    n, d, md = W8A8_SHAPE
    log(f"  fused_mlp_w8a8_block_mma: "
        f"{fm.max_active_clusters('w8a8', d, md, torch.bfloat16)} clusters "
        f"of {fm.cluster_size(md)} blocks fit the card at once in bf16 "
        f"({fm.w8a8_mma_smem_bytes(d, md, 2)} bytes of shared memory a "
        f"block), {fm.max_active_clusters('w8a8', d, md, torch.float32)} "
        f"in f32 ({fm.w8a8_mma_smem_bytes(d, md, 4)} bytes)")
    for b in (1, 8):
        for dtype in (torch.bfloat16, torch.float32):
            nums = w8a8_case(device, "vit_b16", b, n, d, md, dtype, b + 7)
            if (b, dtype) == (1, torch.bfloat16):
                out = nums
    return out


def chain_graph(graph_obj, image, node_params=None):
    """A saved graph with per-node params and ``image`` bound to node 0."""
    from interactive_vit_tpu_torch.wire.schema import graph_from_json

    g = graph_from_json(graph_obj)
    for i, params in (node_params or {}).items():
        g.nodes[i].params.update(params)
    g.add_input(image, g.nodes[0], "o")
    return g


def chain_request(graph_obj, image, taps, node_params=None):
    """Request bytes for ``chain_graph`` with an explicit tap list."""
    return graph_request(chain_graph(graph_obj, image, node_params), taps)


# Every trace that ``profiled`` took again, as "<what>: <seen> of
# <expected>"; phase 9 prints them before the result.
PROFILE_RETRIES = []


def profiled(run, what: str, expect=None, tries: int = 3):
    """``run()`` (which returns its own wall ms, synchronized) under
    ``torch.profiler``, then ``report_profile`` (``expect`` as there).
    CUPTI can drop a kernel's record from a long trace: one trace in each
    of two of four ``chip_smoke.py`` runs on the card, the parent's among
    them, showed one launch fewer than the launch counters had counted
    (64 later traces of one forward, taken to reproduce it, all showed
    every launch). A trace that shows fewer launches of an expected kernel
    than ``expect`` and none of an absent one is taken again, up to
    ``tries`` times, and recorded in PROFILE_RETRIES; the run fails if
    every try falls short. A trace that shows more, or a kernel expected to
    be absent, fails at once (``report_profile``). A lost record has
    also recurred at the same place in every try of one trace (11 of 12
    launches of one kernel, three times running), so a try after the first
    starts its trace with 64 device-to-device copies a try (the 32
    records at the head of a vit_b16 eager pass's trace were lost in each
    of three tries after 8 and 16) and a wait on the host before ``run``:
    the run's records then sit elsewhere in the trace. A trace that holds no kernel at all (one of CUPTI's traces of
    a replay on the card came back empty) is taken again likewise.
    Returns ``report_profile``'s (wall ms, device busy ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    short = []
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if attempt and torch.cuda.is_available():
                pad = torch.zeros(2, device="cuda")
                for _ in range(64 * attempt):
                    pad[1:].copy_(pad[:1])
                torch.cuda.synchronize()
                time.sleep(0.002 * attempt)
            wall_ms = run()
        if expect and not ran_kernels(prof):
            short.append({})
            PROFILE_RETRIES.append(f"{what}: no kernel in the trace")
            log(f"  {what}: the trace holds no kernel (the run launches "
                f"some): its records lost; profiling again")
            continue
        if expect:
            seen = kernels_by_name(prof, expect)
            if (seen != expect and all(seen[k] <= n for k, n in expect.items())
                    and all(seen[k] == 0 for k, n in expect.items() if not n)):
                short.append(seen)
                PROFILE_RETRIES.append(f"{what}: {seen} of {expect}")
                log(f"  {what}: the trace shows {seen} of {expect}: a "
                    f"record lost; profiling again")
                continue
        return report_profile(prof, wall_ms, what, expect)
    raise AssertionError(f"{what}: each of {tries} traces showed fewer "
                         f"launches than {expect} ({{}}: no kernel at "
                         f"all): {short}")


def synchronized_ms(fn) -> float:
    """Host wall ms of ``fn()`` up to the card's synchronize."""
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile_request(executor, graph, taps, tag, expect=None, what="replay"):
    """One ``executor.run`` of a served request under ``torch.profiler``
    (``profiled``, ``expect`` as there); returns (wall ms, busy ms)."""
    return profiled(lambda: synchronized_ms(
        lambda: executor.run(graph, taps)),
        f"{tag} profile of one executor.run ({what})", expect)


def time_host_spans(executor, graph, taps, tag, spans) -> None:
    """One eager ``executor.run`` (``use_jit=False``: a replay calls no
    Python) of a served request without the profiler, each
    (module, name) of ``spans`` wrapped for the run to sum the host time of
    its calls (``time.perf_counter``; nothing inside them waits for the
    device, so this is the time the host takes to issue them). Logs each
    span's calls and host ms beside the run's wall."""
    import torch

    spent = {name: [0, 0.0] for _, name in spans}
    saved = [(mod, name, getattr(mod, name)) for mod, name in spans]
    for mod, name, fn in saved:
        def timed(*args, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                spent[_name][0] += 1
                spent[_name][1] += time.perf_counter() - t0
        setattr(mod, name, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        executor.run(graph, taps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    log(f"  {tag} host time in one eager executor.run (perf_counter, no "
        f"profiler): wall {wall_ms:.2f} ms; " + "; ".join(
            f"{name} x{n} {t * 1e3:.3f} ms" for name, (n, t) in spent.items())
        + f"; together {sum(t for _, t in spent.values()) * 1e3:.3f} ms")


def device_kernels(prof):
    """(device ms, launches, name) of each kernel a profile saw, kept on
    the profile (a saliency graph's replay holds ~40,000 kernels, and each
    ``key_averages`` walks them all). The executor's node ranges, which a
    profile also puts on the device's timeline, are no kernels."""
    from torch.autograd import DeviceType

    if not hasattr(prof, "ivt_kernels"):
        prof.ivt_kernels = [(e.self_device_time_total / 1e3, e.count, e.key)
                            for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA
                            and e.self_device_time_total > 0
                            and not getattr(e, "is_user_annotation", False)]
    return prof.ivt_kernels


def ran_kernels(prof):
    """``device_kernels`` less the copies and fills (``profiled``'s
    padding makes some), so what is left was launched by the run."""
    return [k for k in device_kernels(prof)
            if not k[2].startswith(("Memcpy", "Memset"))]


def kernels_by_name(prof, parts) -> dict:
    """The launches a profile saw of the kernels whose names hold each of
    ``parts``."""
    kernels = device_kernels(prof)
    return {part: sum(n for _, n, name in kernels if part in name)
            for part in parts}


def report_profile(prof, wall_ms: float, what: str, expect=None):
    """Log a profile's host wall time, device busy time (the sum of kernel
    times: the port runs on one stream, so kernels do not overlap) and the
    kernels that take the most device time; returns (wall ms, busy ms), or
    (wall ms, None) when the profiler saw no kernel. ``expect``: {a
    substring of a kernel's name: the launches the profile must show of
    the kernels whose names hold it} (0: none may run)."""
    kernels = device_kernels(prof)
    busy = sum(t for t, _, _ in kernels)
    if not ran_kernels(prof):
        if expect:
            raise AssertionError(f"{what}: the profiler saw no kernel, so "
                                 f"{sorted(expect)} cannot be checked")
        log(f"  {what}: wall {wall_ms:.2f} ms; device time not measured "
            f"(the profiler saw no kernel)")
        return wall_ms, None
    if expect:
        seen = kernels_by_name(prof, expect)
        if seen != expect:
            raise AssertionError(f"{what}: kernels by name {seen}, expected "
                                 f"{expect}")
        spent = {part: sum(t for t, _, name in kernels if part in name)
                 for part, n in expect.items() if n}
        absent = sum(1 for n in expect.values() if not n)
        log(f"  {what}: kernels by name { {k: n for k, n in seen.items() if n} }"
            f" and none of {absent} others (as expected)"
            + "".join(f"; {part} {t:.3f} ms" for part, t in spent.items()))
    top = sorted(kernels, reverse=True)[:6]
    log(f"  {what}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall_ms:.1f}%, idle "
        f"{100 - 100 * busy / wall_ms:.1f}%); top: " + "; ".join(
            f"{name[:48]} x{n} {t:.3f} ms" for t, n, name in top))
    return wall_ms, busy


def post(url: str, body: bytes) -> bytes:
    return post_timed(url, body)[0]


def post_timed(url: str, body: bytes):
    """(response bytes, the ``X-IVT-Timing`` fields as floats)."""
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        raw = r.read()
        header = r.headers.get("X-IVT-Timing") or ""
    return raw, {k: float(v) for k, v in
                 (kv.split("=", 1) for kv in header.split(";") if kv)}


def serve(models, dtype_name, device, graphs_dir, attn="auto", max_batch=8,
          ckpts=None, seed=0):
    from interactive_vit_tpu_torch.serving.server import build_app

    app = build_app(models=models, graphs_dir=graphs_dir,
                    dtype_name=dtype_name, device=device, seed=seed,
                    attn_impl_name=attn, max_batch=max_batch, ckpts=ckpts)
    httpd = app.serve("127.0.0.1", 0, background=True)
    return app, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def stop(app, httpd) -> None:
    httpd.shutdown()
    httpd.server_close()
    app.close()


class Path:
    """One served path: a model of ``family`` (the ``models`` module with
    its ``layer_fns``), its taps (graph node -> channels; a generated chain
    graph's node i is the model's layer i) and the launches of each kernel
    that one request makes (``kernels``: name -> count; every other kernel
    must launch no time). ``plain`` holds the ``layer_fns`` arguments that
    put the kernels' plain versions into every block. ``tap_shape(path,
    node, ch)`` gives a tap's expected shape and ``check_tap(path, node,
    arr, tag, bf16)`` holds what else the family asks of a tapped array.
    ``other``: a second Path served beside this one and asked once.
    ``dtype`` and ``attn``: the server's ``--dtype`` and ``--attn``;
    ``f32``: whether one float32 request follows. ``chain``: the channels
    besides ``o`` that the saved graph wires from block to block.
    ``lockstep(path, model, image, device)``: where given, the reference of
    the requests in ``dtype`` instead of the plain path (and a check that
    runs before the f32 request's comparison with it); it returns what
    ``plain_taps`` returns. ``host_spans``: (module, function name) pairs
    whose host time in one request ``time_host_spans`` logs.
    ``f32_kernels``: the launches of the f32 request where they differ from
    ``kernels`` (a bf16 tensor-core route whose f32 twin is an FMA
    kernel). ``profile_kernels``: ``report_profile``'s ``expect`` for the
    profiled request (and for ``other``'s, its own). ``f32_rel``: a
    ``dtype="float32"`` path's requests
    are held to F32_BOUND of each output's scale (``check_response``'s
    ``rel``) where F32_BOUND alone would not hold through its depth.
    ``extras(app, eager, path, graph, images, captured, replay_busy)``:
    further checks of the compiled path that the path runs after its own
    (``compiled_path_extras``, ``feature_view_extras``; ``replay_busy``: the
    profiled replay's device busy ms). ``offset``: the saved graph's node
    index of the model's first layer (1 where an ``img_src`` node comes
    first). ``views``: {graph node: (the layer whose "o" it takes, node
    kind, params)} of the viewer kinds on the model's outputs, which the
    plain path runs on its own layer outputs. ``head``: the layer whose
    output every request taps (a classifier's head; CLIP's embedding,
    VGG's last linear) and ``head_shape`` its shape in a response (by
    default [1, the classes or the width]). ``check_head(path, head, tag,
    bf16)`` holds what else the family asks of it."""

    def __init__(self, model, family, cfg, img, taps, kernels, plain,
                 tap_shape, seq, conc, check_tap=None, node_params=None,
                 other=None, dtype="bfloat16", attn="auto", f32=True,
                 chain=(), lockstep=None, host_spans=(), f32_kernels=None,
                 profile_kernels=None, f32_rel=False, extras=None, offset=0,
                 views=None, head="head", head_shape=None, check_head=None):
        self.model, self.family, self.cfg = model, family, cfg
        self.extras = extras
        self.offset, self.views = offset, views or {}
        self.f32_rel = f32_rel
        self.f32_kernels = kernels if f32_kernels is None else f32_kernels
        self.profile_kernels = profile_kernels
        self.chain, self.lockstep = tuple(chain), lockstep
        self.host_spans = tuple(host_spans)
        self.img, self.tap_nodes = img, taps
        self.kernels, self.plain = kernels, plain
        self.dtype, self.attn, self.f32 = dtype, attn, f32
        self.tap_shape, self.check_tap = tap_shape, check_tap
        self.seq, self.conc = seq, conc
        self.node_params = node_params or {}
        self.other = other
        layers = family.layer_fns(cfg)
        self.names = [name for name, _, _ in layers]
        self.head_node = self.names.index(head) + offset
        # the blocks are the layers with extra (tap) channels
        self.depth = sum(1 for _, extra, _ in layers if extra)
        self.head_shape = head_shape or (1, cfg.num_classes or cfg.width)
        self.check_head = check_head

    def taps(self):
        return ([(i, ch) for i, chs in self.tap_nodes.items() for ch in chs]
                + [(self.head_node, "o")])

    def params_of(self, node):
        return dict(self.node_params.get(node, {}))


def vit_tap_shape(path, node, ch):
    """Plain ViT: ``attn`` [1, heads or the selected ones, N, N], the
    head-mean ``r`` [1, N, N], a block's output ``o`` [1, N, D]."""
    from interactive_vit_tpu_torch.models.vit import parse_attn_heads

    sel = parse_attn_heads(path.params_of(node))
    n = path.cfg.tokens
    return {"attn": (1, len(sel) if sel else path.cfg.heads, n, n),
            "r": (1, n, n), "o": (1, n, path.cfg.width)}[ch]


def swin_stage_block(path, node):
    _, s, b = path.names[node].split(".")
    return int(s), int(b)


def swin_tap_shape(path, node, ch):
    """Swin: ``attn`` [1, nW, heads or the selected ones, T, T]; with
    ``attn_win`` the one window's [1, heads, T, T]."""
    from interactive_vit_tpu_torch.models.vit import parse_attn_heads

    cfg = path.cfg
    s, _ = swin_stage_block(path, node)
    params = path.params_of(node)
    sel = parse_attn_heads(params)
    t = cfg.window ** 2
    shape = (1, (cfg.stage_res(s) // cfg.window) ** 2,
             len(sel) if sel else cfg.heads[s], t, t)
    return shape[:1] + shape[2:] if params.get("attn_win") else shape


def swin_check_tap(path, node, arr, tag, bf16) -> None:
    """A shifted block's seam pairs get no attention: exactly 0 in bf16
    (exp(-100) rounds to 0), a denormal in f32."""
    cfg = path.cfg
    s, b = swin_stage_block(path, node)
    shift = cfg.stage_shift(s, b)
    if not shift or path.params_of(node):
        return
    mask = path.family.shift_attn_mask(cfg.stage_res(s), cfg.window, shift)
    seam = arr[np.broadcast_to(mask[None, :, None] < 0, arr.shape)]
    if seam.size == 0 or not (seam == 0 if bf16 else seam < 1e-37).all():
        raise AssertionError(f"{tag}: node {node} masked seam pairs got "
                             f"probs (max {seam.max()})")


def run_view(kind_name, params, x):
    """Node kind ``kind_name`` of the port's built-ins (a viewer such as
    ``pca_view``) on ``x``, its captures on ``x``'s device."""
    from interactive_vit_tpu_torch.ops import node_ops

    kind = next(k for k in node_ops.instances() if k.name == kind_name)
    caps = kind.captures(params)
    if caps is None:
        return kind.fn(params)({"o": x})["o"]
    return kind.fn(params)({"o": x}, {k: v.to(x.device)
                                      for k, v in caps.items()})["o"]


def plain_taps(path, model, image, device):
    """The port's plain path on ``device`` with the served model's weights:
    the same layer chain with the kernels' plain versions in every block,
    and the path's viewer kinds on its layer outputs (``path.views``).
    ``image``: [3, H, W], or a group's [K, 3, H, W] run as one batch.
    Returns (head output, {graph node: {channel: tensor}})."""
    import torch

    fam, cfg = path.family, path.cfg
    x = torch.from_numpy(image).to(device)
    maps, carry, layer_out = {}, {}, {}
    with torch.inference_mode():
        for layer, (name, extra, fn) in enumerate(
                fam.layer_fns(cfg, **path.plain)):
            node = layer + path.offset
            p = fam.layer_params(model.params, name)
            if extra:
                taps = path.tap_nodes.get(node, ())
                kw = ({"node_params": path.params_of(node)} if "node_params"
                      in inspect.signature(fn).parameters else {})
                out = fn(p, {"o": x, **carry},
                         want=frozenset(taps) | frozenset(path.chain), **kw)
                if taps:
                    maps[node] = {ch: out[ch] for ch in taps}
                carry = {ch: out[ch] for ch in path.chain}
            else:
                out = fn(p, {"o": x})
            x = layer_out[name] = out["o"]
            if node in path.tap_nodes and not extra:
                maps[node] = {"o": x}
        for node, (src, kind_name, params) in path.views.items():
            maps[node] = {"o": run_view(kind_name, {
                **params, **path.params_of(node)}, layer_out[src])}
    return x, maps


def tome_tap_shape(path, node, ch):
    """ToMe: block i (node i + 2) runs attention on the ladder's N_i tokens
    and leaves N_{i+1}: ``attn`` [1, heads, N_i, N_i], the unwired rollout
    ``r`` [1, N_{i+1}, N_i], ``merge`` [1, 3, g, g], ``a`` [1, N_0], ``s``
    [1, N_{i+1}], ``o`` [1, N_{i+1}, D]."""
    cfg = path.cfg
    n_in, n_out = cfg.n_tokens(node - 2), cfg.n_tokens(node - 1)
    g = cfg.img_size // cfg.patch
    return {"attn": (1, cfg.heads, n_in, n_in), "r": (1, n_out, n_in),
            "merge": (1, 3, g, g), "a": (1, cfg.tokens), "s": (1, n_out),
            "o": (1, n_out, cfg.width)}[ch]


def tome_decisions(scored, r, b):
    """The matching's data for image ``b`` from ``tome_ops.match_scores``
    (``scored``), as ``bipartite_matching`` reads it: (cosine scores [Na,
    Nb] with CLS's row -inf, each a-token's best score and partner, the
    merged a-tokens)."""
    scores, best, idx, order = scored
    return scores[b], best[b], idx[b], set(order[b, :r].tolist())


def tome_lut_check(tag, metric_k, metric_p, r, f32) -> dict:
    """The lut that the kernel's metric gives against the plain metric's,
    on the same block inputs (every image of the batch): no entry may
    differ in f32; in bf16 each decision that differs must be a near tie
    (``TOME_SCORE_CAP`` note)."""
    from interactive_vit_tpu_torch.ops import tome_ops

    lut_k, _ = tome_ops.bipartite_matching(metric_k, r)
    lut_p, _ = tome_ops.bipartite_matching(metric_p, r)
    n_lut = int((lut_k != lut_p).sum())
    r = tome_ops.merge_counts(metric_k.shape[1], r)
    scored_k = tome_ops.match_scores(metric_k)
    scored_p = tome_ops.match_scores(metric_p)
    d, gaps = 0.0, []
    for b in range(metric_k.shape[0]):
        sk, _, idx_k, merged_k = tome_decisions(scored_k, r, b)
        sp, best_p, idx_p, merged_p = tome_decisions(scored_p, r, b)
        d = max(d, float((sk[1:] - sp[1:]).abs().max()))
        for i in merged_k ^ merged_p:  # swapped into or out of the set
            other = (merged_p - merged_k if i in merged_k
                     else merged_k - merged_p)
            gaps.append(min(abs(float(best_p[i] - best_p[j]))
                            for j in other))
        for i in merged_k & merged_p:  # merged into another partner
            if idx_k[i] != idx_p[i]:
                gaps.append(abs(float(sp[i, idx_k[i]] - sp[i, idx_p[i]])))
    if f32 and n_lut:
        raise AssertionError(f"{tag}: {n_lut} lut entries differ in f32")
    if d > TOME_SCORE_CAP or any(gap > 2 * d for gap in gaps):
        raise AssertionError(f"{tag}: scores differ by {d:.3g}; decisions "
                             f"that differ have plain gaps {gaps}")
    return {"lut": n_lut, "decisions": len(gaps), "score_diff": d}


def tome_lockstep(path, model, image, device):
    """The served ToMe model's kernel path run in-process, and every block
    against its plain version on the kernel path's own inputs: a
    ``block_impl`` handed to ``tome.layer_fns`` launches the block kernel
    once, with the served block's operands and maps flags, holds its
    result against ``fused_attn_block_reference`` on the same x and key
    bias (y, the key metric and the maps the block's taps ask for, within
    their bounds; the lut by ``tome_lut_check``) and passes it on.
    ``image``: [3, H, W], or [K, 3, H, W] for a group run as one pass (the
    same shapes through the same ops as the served group, so the same
    bits and the same matching decisions). Returns the kernel path's head
    output and taps."""
    import torch
    from interactive_vit_tpu_torch.models import tome
    from interactive_vit_tpu_torch.ops import fused_block as fb

    cfg = path.cfg
    worst, stats, tag = {}, {"lut": 0, "decisions": 0, "score_diff": 0.0}, []

    def checked_block(x, p, heads, eps, **kw):
        got = fb.fused_attn_block(x, p, heads, eps, **kw)
        ref = fb.fused_attn_block_reference(x, p, heads, eps, **kw)
        labels = (("y", "probs") + (("mean",) if kw["want_mean"] else ())
                  + ("metric",))
        errs, _ = check_outputs(tag[-1], got, ref, x.dtype, labels)
        for label, err in zip([lb for lb, r in zip(labels, ref)
                               if r is not None], errs):
            worst[label] = max(worst.get(label, 0.0), err)
        res = tome_lut_check(tag[-1], got[-1], ref[-1], cfg.r,
                             x.dtype == torch.float32)
        stats["lut"] += res["lut"]
        stats["decisions"] += res["decisions"]
        stats["score_diff"] = max(stats["score_diff"], res["score_diff"])
        return got

    layers = tome.layer_fns(cfg, block_impl=checked_block)
    x = torch.from_numpy(image).to(device)
    maps, carry = {}, {}
    with torch.inference_mode():
        for node, (name, extra, fn) in enumerate(layers):
            p = model.layer_params(name)
            if not extra:
                x = fn(p, {"o": x})["o"]
                continue
            tag.append(f"{path.model} block {node - 2} (B={x.shape[0]}, "
                       f"N={x.shape[1]})")
            taps = path.tap_nodes.get(node, ())
            out = fn(p, {"o": x, **carry},
                     want=frozenset(taps) | frozenset(path.chain),
                     node_params=path.params_of(node))
            if taps:
                maps[node] = {ch: out[ch] for ch in taps}
            carry = {ch: out[ch] for ch in path.chain}
            x = out["o"]
    log(f"  {path.model} {x.dtype} B={x.shape[0]}: {cfg.depth} blocks vs "
        f"plain on the kernel path's inputs: max abs err " + ", ".join(
            f"{k}={v:.3g}" for k, v in worst.items())
        + f"; lut entries differing {stats['lut']}, decisions "
          f"{stats['decisions']}, scores within {stats['score_diff']:.3g}")
    return x, maps


def check_response(raw, path, plain, tag, bf16=True, rel=False):
    """Shapes, finiteness, row sums and agreement with the plain path of
    a response (its bytes, or an executor's decoded result) (``rel``: an
    f32 bound of F32_BOUND times max(1, the output's largest value) instead
    of F32_BOUND; a bf16 response's viewer maps: VIEW_BOUND against the
    kind on the host from the response's own source tap). Returns
    ({output: max abs err}, {output: the share of its bound that err
    uses}, {output: its largest reference value})."""
    import torch
    from interactive_vit_tpu_torch.wire.codec import Response

    out = raw if isinstance(raw, dict) else Response.decode(raw)
    head = out[path.head_node]["o"]
    if head.shape != path.head_shape:
        raise AssertionError(f"{tag}: head output shape {head.shape}")
    if not np.isfinite(head).all():
        raise AssertionError(f"{tag}: non-finite head output")
    if path.check_head is not None:
        path.check_head(path, head, tag, bf16)
    p_head, p_maps = plain
    pairs = {"head": (head, p_head.float().cpu().numpy())}
    for i, chs in path.tap_nodes.items():
        for ch in chs:
            arr = out[i][ch]
            if arr.shape != path.tap_shape(path, i, ch):
                raise AssertionError(f"{tag}: node {i} {ch} {arr.shape}")
            if not np.isfinite(arr).all():
                raise AssertionError(f"{tag}: non-finite node {i} {ch}")
            if ch == "attn":
                row_err = float(np.abs(arr.sum(-1) - 1.0).max())
                if row_err > ROW_SUM_BOUND:
                    raise AssertionError(
                        f"{tag}: node {i} probs rows sum to 1 within "
                        f"{row_err} > {ROW_SUM_BOUND}")
            if path.check_tap is not None:
                path.check_tap(path, i, arr, tag, bf16)
            ref = p_maps[i][ch].float().cpu().numpy()
            if bf16 and i in path.views:
                src, kind_name, params = path.views[i]
                key = (f"{path.model} {path.dtype}", i)
                VIEW_VS_PLAIN[key] = max(VIEW_VS_PLAIN.get(key, 0.0), float(
                    np.abs(arr - ref).max()))
                ref = run_view(kind_name, {**params, **path.params_of(i)},
                               torch.from_numpy(np.array(out[
                                   path.names.index(src) + path.offset]["o"])))
                pairs[f"{ch}{i}"] = (arr, ref.numpy(), VIEW_BOUND)
                continue
            pairs[f"{ch}{i}"] = (arr, ref)
    errs, uses, scales = {}, {}, {}
    for key, (got, ref, *fixed) in pairs.items():
        scale = scales[key] = float(np.abs(ref).max())
        if fixed:
            bound = fixed[0]
        elif not bf16:
            bound = F32_BOUND * (max(1.0, scale) if rel else 1.0)
        else:
            bound = SLICE_REL * (max(1.0, scale) if key == "head" else scale)
        errs[key] = float(np.abs(got - ref).max())
        uses[key] = errs[key] / bound
    bad = {k: f"{errs[k]:.3g} ({uses[k]:.2f} of its bound)"
           for k in errs if uses[k] > 1.0}
    if bad:
        raise AssertionError(f"{tag}: served vs plain path outside bounds: "
                             f"{bad}")
    return errs, uses, scales


# Every replayed output that was not the eager pass's bit for bit (each
# then held to its path's bound against the eager result), as "<what>:
# {output: max abs difference}"; phase 9 prints them before the result.
REPLAY_DIFFS = []
# One row a served path for phase 9's table of the compiled path: (tag,
# replay and eager walls, their profiled walls and device busy, the
# captures' seconds, memory_reserved).
COMPILED = []


def launch_counters():
    """(wrapper, attribute) of every kernel launch counter in the port's
    loaded modules: an int attribute of a function whose name ends in
    ``launches`` (``fused_attn_block.launches``, ``.tome_launches``,
    ``attention_train.mma_fwd_launches``, ...)."""
    out, seen = [], set()
    for name, mod in list(sys.modules.items()):
        if not name.startswith("interactive_vit_tpu_torch.") or mod is None:
            continue
        for fn in list(vars(mod).values()):
            attrs = getattr(fn, "__dict__", None)
            if not callable(fn) or not attrs or id(fn) in seen:
                continue
            seen.add(id(fn))
            out += [(fn, a) for a, v in attrs.items()
                    if a.endswith("launches") and type(v) is int]
    return out


# each captured program's launches: the wrapper calls its capture issued
# into its graph, as [(wrapper, attribute, count)]
RECORDED = weakref.WeakKeyDictionary()


def count_replays() -> None:
    """Count the compiled path's launches in the wrappers' counters as an
    eager pass counts them. A capture calls each wrapper, which counts the
    launch that it records into the graph, though nothing runs on the card
    then: those counts are taken back off the counters and recorded for
    the program. A replay runs the recorded kernels without calling a
    wrapper: each replay adds its program's record. These counts are thus
    copied from the capture; the profiled replay of every served path
    (``run_path``) checks them by name against the kernels the card
    ran."""
    from interactive_vit_tpu_torch.graph.executor import Executor

    capture, replay = Executor._capture, Executor._replay

    def counted_capture(self, prog, dyn):
        counters = launch_counters()
        before = [getattr(fn, a) for fn, a in counters]
        try:
            capture(self, prog, dyn)
        finally:
            after = [getattr(fn, a) for fn, a in counters]
            for (fn, a), n in zip(counters, before):
                setattr(fn, a, n)
        RECORDED[prog] = [(fn, a, y - x) for (fn, a), x, y
                          in zip(counters, before, after) if y != x]

    def counted_replay(self, prog, inputs, values):
        handle = replay(self, prog, inputs, values)
        for fn, a, n in RECORDED[prog]:
            setattr(fn, a, getattr(fn, a) + n)
        return handle

    Executor._capture, Executor._replay = counted_capture, counted_replay


def port_kernel_names():
    """The name of every ``__global__`` kernel in the port's sources: a
    profile of a path that runs none of them expects each 0 times."""
    import re

    names = set()
    for root, _, files in os.walk(os.path.join(
            HERE, "interactive_vit_tpu_torch", "csrc")):
        for fname in files:
            with open(os.path.join(root, fname)) as fh:
                # a declaration runs from __global__ to its body or ";"
                for decl in re.findall(r"__global__[^{;]*", fh.read()):
                    names |= set(re.findall(r"\b(\w+_kernel)\s*\(", decl))
    if not names:
        raise AssertionError("no __global__ kernel found in the sources")
    return sorted(names)


def watch_captures(executor):
    """Record each CUDA graph capture of ``executor`` as (its bucket, or
    None for a ``run``'s program; seconds)."""
    seen, real = [], executor._capture

    def timed(prog, dyn):
        t0 = time.perf_counter()
        real(prog, dyn)
        seen.append((prog.k, time.perf_counter() - t0))

    executor._capture = timed
    return seen


def median_ms(fn, n: int = 3) -> float:
    """The median of ``n`` synchronized host walls of ``fn()`` (one call
    first, untimed)."""
    fn()
    return float(np.median([synchronized_ms(fn) for _ in range(n)]))


def compare_replay(tag, path, got, want, what) -> str:
    """A replayed result against the eager pass (``use_jit=False``) of the
    same request: equal bit for bit (the same kernels on the same shapes
    and routes). Where an output is not, it must lie within the path's
    bound against the eager result, and the difference is recorded in
    REPLAY_DIFFS for phase 9."""
    import torch

    g = {f"{i}/{ch}": v for i, sub in got.items() for ch, v in sub.items()}
    w = {f"{i}/{ch}": v for i, sub in want.items() for ch, v in sub.items()}
    if sorted(g) != sorted(w):
        raise AssertionError(f"{tag} {what}: replayed outputs {sorted(g)}, "
                             f"eager {sorted(w)}")
    diff = {k: float(np.abs(g[k] - w[k]).max()) for k in w
            if not np.array_equal(g[k], w[k])}
    if not diff:
        return "bit for bit"
    eager = (torch.from_numpy(want[path.head_node]["o"]),
             {i: {ch: torch.from_numpy(want[i][ch]) for ch in chs}
              for i, chs in path.tap_nodes.items()})
    check_response(got, path, eager, f"{tag} {what}, replay vs eager",
                   bf16=path.dtype != "float32", rel=path.f32_rel)
    REPLAY_DIFFS.append(f"{tag} {what}: {diff}")
    return f"within its bounds, differing in {diff}"


def compiled_path_check(app, eager, path, graph, images, tag, captured,
                        counters):
    """The compiled path of one served path, after its requests: (a) the
    replay of the image the program was captured with and (b) of another
    image, each against the eager pass (``use_jit=False``) of the same
    request; (f) the launches that a replay of the program adds
    (``count_replays``: those its capture recorded) are each of the path's
    kernels its count a pass, as the profiled replay in ``run_path`` shows
    by name; neither captures again; then ``evicted_constants_check``
    (g). Returns the notes and the replay and eager walls
    (``median_ms``)."""
    taps = path.taps()

    def graph_of(j):
        return chain_graph(graph, images[j], path.node_params)

    n_cap = len(captured)
    notes = []
    for j, what in ((0, "the captured image"), (1, "a second image")):
        before = {k: fn.launches for k, fn in counters.items()}
        got = app.executor.run(graph_of(j), taps)
        launched = {k: fn.launches - before[k] for k, fn in counters.items()}
        if not app.executor.last_stats.cache_hit:
            raise AssertionError(f"{tag} {what}: not a cache hit")
        want = {k: path.kernels.get(k, 0) for k in counters}
        if launched != want:
            raise AssertionError(f"{tag} {what}: one replay added the "
                                 f"launches {launched} that its capture "
                                 f"recorded; expected {want}")
        same = compare_replay(tag, path, got, eager.run(graph_of(j), taps),
                              what)
        notes.append(f"{what} {same}")
    if len(captured) != n_cap:
        raise AssertionError(f"{tag}: a replay captured again")
    walls = {name: median_ms(lambda ex=ex: ex.run(graph_of(1), taps))
             for name, ex in (("replay", app.executor), ("eager", eager))}
    notes.append(evicted_constants_check(app.executor, eager, path, graph,
                                         tag, captured))
    return notes, walls


def reads_back_kind():
    """A node kind that reads a value back to the host inside its pass
    (``.item()``): it cannot be captured into a CUDA graph."""
    from interactive_vit_tpu_torch.graph.registry import NodeKind

    class ReadsBack(NodeKind):
        def io(self, params):
            return {"ins": ["o"], "outs": ["o"]}

        def fn(self, params):
            return lambda ins: {"o": ins["o"] * float(ins["o"].sum().item())}

    return ReadsBack("chip_smoke_reads_back")


def compiled_path_extras(app, eager, path, graph, images, captured,
                         replay_busy=None):
    """The vit_b16 path's further checks of the compiled path: (c) four
    deferred replays of two signatures interleaved (vit_b16, vit_t16,
    vit_b16, vit_t16; one shared capture pool) and two pipelined groups of
    2 of one program, each against its eager pass; (d) a ``cos`` node on
    the logits: an edit of its A replays the cached program (a cache hit,
    no new capture) with the new value; (e) a node kind that cannot be
    captured raises ``NodeError`` naming it, caches nothing, and the card
    serves on."""
    import torch
    from interactive_vit_tpu_torch.graph.executor import NodeError
    from interactive_vit_tpu_torch.graph.ir import Graph

    ex, taps, opath = app.executor, path.taps(), path.other
    ograph = app.graphs.load(opath.model + ".json")

    def b16(j):
        return chain_graph(graph, images[j], path.node_params)

    def t16(j):
        return chain_graph(ograph, images[j][:, :opath.img, :opath.img])

    # (c) interleaved signatures, every result on its way before any is read
    order = [(b16(2), path), (t16(3), opath), (b16(3), path), (t16(2), opath)]
    for g, p in order[:2]:  # capture the two programs first
        ex.run(g, p.taps())
    handles = [ex.run(g, p.taps(), defer=True) for g, p in order]
    notes = []
    for n, ((g, p), h) in enumerate(zip(order, handles)):
        notes.append(compare_replay(p.model, p, h.materialize(),
                                    eager.run(g, p.taps()),
                                    f"interleaved replay {n}"))
    # (c) two groups of one program in flight at once
    groups = [[b16(0), b16(1)], [b16(2), b16(3)]]
    ex.run_stacked(groups[0], taps)
    handles = [ex.run_stacked(gs, taps, defer=True) for gs in groups]
    for n, (gs, h) in enumerate(zip(groups, handles)):
        for j, (got, want) in enumerate(zip(h.materialize(),
                                            eager.run_stacked(gs, taps))):
            notes.append(compare_replay(path.model, path, got, want,
                                        f"pipelined group {n} result {j}"))
    log(f"  (c) 4 interleaved deferred replays of vit_b16 and vit_t16 and 2 "
        f"pipelined groups of 2 (4 results) against their eager passes: "
        f"{notes.count('bit for bit')} of {len(notes)} bit for bit")

    # (d) a cos edit reuses the captured program
    def with_cos(a):
        g = b16(1)
        c = g.add_node("cos", {"A": str(a), "b": "0.25"})
        g.connect(g.nodes[path.head_node], "o", c, "o")
        return g, taps + [(c.index, "o")], c.index

    g, ctaps, ci = with_cos(1.0)
    first = ex.run(g, ctaps)
    n_cap = len(captured)
    g, ctaps, ci = with_cos(2.5)
    t0 = time.perf_counter()
    edited = ex.run(g, ctaps)
    edit_ms = (time.perf_counter() - t0) * 1e3
    if not ex.last_stats.cache_hit or len(captured) != n_cap:
        raise AssertionError(f"(d) the cos edit: cache hit "
                             f"{ex.last_stats.cache_hit}, captures "
                             f"{len(captured) - n_cap}")
    head = torch.from_numpy(edited[path.head_node]["o"]).bfloat16()
    want = torch.cos(torch.tensor(2.5).bfloat16() * head
                     + torch.tensor(0.25).bfloat16()).float().numpy()
    err = float(np.abs(edited[ci]["o"] - want).max())
    # one bf16 ulp of a value in [-1, 1]: the card's cos and the host's
    # may round to either side
    if err > 2 ** -8 or np.array_equal(edited[ci]["o"], first[ci]["o"]):
        raise AssertionError(f"(d) the cos edit: max abs err {err} against "
                             f"cos(2.5 x + 0.25) in bf16, or unchanged")
    eq = np.array_equal(edited[ci]["o"], eager.run(g, ctaps)[ci]["o"])
    log(f"  (d) cos(A x + 0.25) on the logits, A 1.0 -> 2.5: a cache hit "
        f"and no new capture ({edit_ms:.2f} ms, the request's wall); max "
        f"abs err against cos(2.5 x + 0.25) in bf16 on the host {err:.3g} "
        f"(bound 2^-8); the replay's cos {'equals' if eq else 'differs from'}"
        f" the eager pass's bit for bit")
    if not eq:
        raise AssertionError("(d) the cos edit's replay differs from its "
                             "eager pass")

    # (e) an uncapturable kind fails the request, attributed, no fallback
    reads_back_kind().register(app.reg)
    g = Graph()
    a = g.add_node("cos")
    b = g.add_node("chip_smoke_reads_back")
    g.connect(a, "o", b, "o")
    g.add_input(np.ones(64, np.float32), a, "o")
    try:
        ex.run(g, "all")
    except NodeError as err:
        if err.node_index != 1 or ex.is_compiled(g, "all"):
            raise AssertionError(f"(e) attributed to node {err.node_index}, "
                                 f"cached {ex.is_compiled(g, 'all')}") from err
        message = str(err)
    else:
        raise AssertionError("(e) a kind that reads back to the host was "
                             "captured")
    ex.run(b16(1), taps)
    if not ex.last_stats.cache_hit:
        raise AssertionError("(e) the request after the failed capture "
                             "missed the cache")
    log(f"  (e) an uncapturable kind (.item() in its pass) raised "
        f"NodeError: {message[:120]!r}; nothing cached; the next vit_b16 "
        f"request replayed")


def evicted_constants_check(ex, eager, path, graph, tag, captured) -> str:
    """(g) The device constants that a program's graph reads, evicted from
    their caches: a request of new constants (the path's image 26 x 36
    pixels larger, its node params) is captured, every device-constant
    cache emptied, and tensors of the evicted constants' sizes, 64 of each,
    allocated on the stream the warm pass built them on and filled with
    NaN (an index with 0). The replay must still equal the eager pass bit
    for bit: the program holds the constants. Returns a note."""
    import torch
    from interactive_vit_tpu_torch.runtime import constants

    h, w = path.img if isinstance(path.img, tuple) else (path.img, path.img)
    image = np.random.default_rng(7).random((3, h + 26, w + 36),
                                            dtype=np.float32)
    taps = path.taps()

    def request():
        return chain_graph(graph, image, path.node_params)

    constants.clear_all()
    n_cap = len(captured)
    ex.run(request(), taps)
    with constants.retained() as seen:
        want = eager.run(request(), taps)
    fill = [(t.shape, t.dtype) for t in flatten_tensors(seen)]
    constants.clear_all()
    del seen
    with torch.cuda.stream(ex._stream):
        filler = [torch.full(shape, float("nan") if dtype.is_floating_point
                             else 0, dtype=dtype, device=ex.device)
                  for shape, dtype in fill for _ in range(64)]
    got = ex.run(request(), taps)
    same = (ex.last_stats.cache_hit and len(captured) == n_cap + 1
            and sorted(got) == sorted(want)
            and all(np.array_equal(got[i][ch], want[i][ch])
                    for i in want for ch in want[i]))
    del filler
    if not fill or not same:
        raise AssertionError(f"{tag} (g): {len(fill)} constants; the replay "
                             f"after their eviction "
                             f"{'equals' if same else 'differs from'} its "
                             f"eager pass (or was not a replay)")
    return (f"(g) {h + 26} x {w + 36}: {len(fill)} constants evicted and "
            f"their sizes refilled, the replay bit for bit")


def dino_tap_shape(path, node, ch):
    """A viewer node's [1, 3, g, g] map (g: the patch grid's side), else a
    plain ViT's tap (``vit_tap_shape``)."""
    if node in path.views:
        g = path.cfg.img_size // path.cfg.patch
        return (1, 3, g, g)
    return vit_tap_shape(path, node, ch)


# The queries that (h) scrubs patch_sim through: patches in the grid's
# corners and middle, then a negative row (token 0, the CLS token)
SCRUB = ((0, 0), (3, 11), (13, 13), (-1, 5))


def feature_view_extras(app, eager, path, graph, images, captured,
                        replay_busy):
    """The dino_s16 feature-view path's further checks: (h) patch_sim's
    row / col scrubbed through four queries (``SCRUB``), each a cache hit
    with no new capture, its heatmap the eager pass's bit for bit and
    within 1e-5 of the same kind on the host from the served norm output
    (bf16 values, exact in f32: only the order of f32 sums differs), each
    heatmap another than the last; (i) pca_view alone, captured from the
    served norm output: its replay's launches and device time, and their
    share of the path's replay (``replay_busy``); the eigenvalue spread of
    that output's token covariance (float64 on the host) and the largest
    difference between the card's view and the same kind on the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from interactive_vit_tpu_torch.graph.executor import Executor
    from interactive_vit_tpu_torch.graph.ir import Graph

    ex, taps = app.executor, path.taps()
    tag = f"{path.model} {path.dtype}"
    sim = next(n for n, v in path.views.items() if v[1] == "patch_sim")
    pca = next(n for n, v in path.views.items() if v[1] == "pca_view")
    norm = path.names.index("norm") + path.offset
    n_cap = len(captured)
    heat, notes = [], []
    for row, col in SCRUB:
        params = {**path.node_params, sim: {"row": str(row), "col": str(col)}}
        g = chain_graph(graph, images[1], params)
        t0 = time.perf_counter()
        got = ex.run(g, taps)
        ms = (time.perf_counter() - t0) * 1e3
        if not ex.last_stats.cache_hit or len(captured) != n_cap:
            raise AssertionError(f"(h) patch_sim query ({row}, {col}): cache "
                                 f"hit {ex.last_stats.cache_hit}, captures "
                                 f"{len(captured) - n_cap}")
        want = eager.run(g, taps)
        if not np.array_equal(got[sim]["o"], want[sim]["o"]):
            raise AssertionError(f"(h) patch_sim query ({row}, {col}): the "
                                 f"replayed heatmap is not the eager pass's")
        notes.append(compare_replay(tag, path, got, want,
                                    f"query ({row}, {col})"))
        host = run_view("patch_sim", {"row": str(row), "col": str(col),
                                      "skip": "1"},
                        torch.from_numpy(got[norm]["o"])).numpy()
        err = float(np.abs(host - got[sim]["o"]).max())
        if err > 1e-5:
            raise AssertionError(f"(h) patch_sim query ({row}, {col}): "
                                 f"{err} from the kind on the host")
        heat.append((got[sim]["o"], ms, err))
    if any(np.array_equal(a[0], b[0]) for a, b in zip(heat, heat[1:])):
        raise AssertionError("(h) a scrubbed query left the heatmap as it "
                             "was")
    log(f"  (h) patch_sim scrubbed through {list(SCRUB)}: each a cache hit "
        f"and no new capture (request walls "
        f"{', '.join(f'{ms:.2f}' for _, ms, _ in heat)} ms), each heatmap "
        f"the eager pass's bit for bit and within "
        f"{max(e for _, _, e in heat):.3g} of the kind on the host (bound "
        f"1e-5); the whole replays against their eager passes: "
        f"{notes.count('bit for bit')} of {len(notes)} bit for bit")

    # (i) pca_view alone on the served norm output
    tokens = got[norm]["o"]
    solo = Executor(app.reg, device=ex.device)
    g = Graph()
    node = g.add_node("pca_view", {"skip": "1"})
    g.add_input(tokens, node, "o")
    view = solo.run(g)[0]["o"]
    view_err = float(np.abs(view - got[pca]["o"]).max())
    if view_err > 1e-6:
        raise AssertionError(f"(i) pca_view alone on the served norm output "
                             f"is {view_err} from the served view")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = synchronized_ms(lambda: solo.run(g))
    if not solo.last_stats.cache_hit:
        raise AssertionError("(i) pca_view's second run was not a replay")
    kernels = [k for k in device_kernels(prof)
               if not k[2].startswith(("Memcpy", "Memset"))]
    launches = sum(n for _, n, _ in kernels)
    busy = sum(t for t, _, _ in kernels)
    t = tokens[0, 1:].astype(np.float64)
    t -= t.mean(0)
    lam = np.linalg.eigvalsh(t.T @ t / t.shape[0])[::-1][:7]
    host = run_view("pca_view", {"skip": "1"},
                    torch.from_numpy(tokens)).numpy()
    share = ("not measured" if replay_busy is None
             else f"{100 * busy / replay_busy:.1f}% of the path's replay "
                  f"({replay_busy:.3f} ms busy)")
    log(f"  (i) pca_view alone, captured from the served norm output (its "
        f"view {'equals' if view_err == 0 else f'within {view_err:.3g} of'} "
        f"the served one): one replay launches {launches} kernels, device "
        f"busy {busy:.3f} ms (wall {wall:.2f} ms), {share}; eigenvalues "
        f"1-7 over the first {', '.join(f'{v / lam[0]:.4f}' for v in lam)}; "
        f"the card's view against the kind on the host: max abs "
        f"{float(np.abs(host - view).max()):.3g}")


def graph_request(g, taps):
    """Request bytes for graph ``g`` (its inputs bound) with an explicit
    tap list."""
    from interactive_vit_tpu_torch.wire.codec import (
        REQUEST_MAGIC, Request, decode_message, encode_message,
    )

    obj, tensors = decode_message(Request.encode(g),
                                  expect_magic=REQUEST_MAGIC)
    obj["taps"] = [{"node": i, "channel": ch} for i, ch in taps]
    return encode_message(REQUEST_MAGIC, obj, tensors)


def conv_f64(image, m):
    """The valid cross-correlation of each channel of ``image`` with ``m``,
    in float64 on the host."""
    kh, kw = m.shape
    oh, ow = image.shape[-2] - kh + 1, image.shape[-1] - kw + 1
    out = np.zeros((*image.shape[:-2], oh, ow))
    for i in range(kh):
        for j in range(kw):
            out += (float(m[i, j])
                    * image[..., i:i + oh, j:j + ow].astype(np.float64))
    return out


# CLIP's embedding against 1: its f32 norm within 1e-5; stored in bf16 each
# element rounds by up to 2^-9 of itself, so the norm of the response's
# bf16 vector lies within 2^-9 of 1 (bound 2^-8)
NORM_F32 = 1e-5
NORM_BF16 = 2.0 ** -8


def unit_norm(path, head, tag, bf16) -> None:
    """A CLIP embedding's rows have norm 1 (NORM_F32, NORM_BF16)."""
    err = float(np.abs(np.linalg.norm(head.astype(np.float64), axis=-1)
                       - 1.0).max())
    bound = NORM_BF16 if bf16 else NORM_F32
    if err > bound:
        raise AssertionError(f"{tag}: embedding norm off 1 by {err:.3g} "
                             f"> {bound:g}")


class VggFamily:
    """``models/vgg`` behind the ``layer_fns(cfg, **plain)`` signature of
    the families with a config (VGG16 has one size and no kernel of the
    port, so its plain path is its served path's layers)."""

    @staticmethod
    def layer_fns(cfg=None, **_):
        from interactive_vit_tpu_torch.models import vgg

        return vgg.layer_fns()

    @staticmethod
    def layer_params(params, name):
        from interactive_vit_tpu_torch.models import vgg

        return vgg.layer_params(params, name)


# the saved vgg16.json's nodes: 1 features.0, 31 features.30, 33 flatten,
# 40 classifier.6; the reference's unbatched request keeps no batch axis
VGG_TAPS = {1: (64, 224, 224), 31: (512, 7, 7), 33: (25088,)}


def vgg_tap_shape(path, node, ch):
    return VGG_TAPS[node]


def vgg_f64_forward(params, x):
    """VGG16 on the host in float64, written apart from the port's layer
    fns (torch's own conv2d, max_pool2d, adaptive_avg_pool2d, linear), from
    the transform's output ``x`` [3, 224, 224]: {saved-graph node: f64
    output} for the features, the flatten and the logits."""
    import torch
    import torch.nn.functional as F

    from interactive_vit_tpu_torch.models import vgg

    out = {}
    h = x.double()[None]
    for idx, (kind, _) in enumerate(vgg._FEATURES):
        if kind == "conv":
            p = params["features"][str(idx)]
            h = F.conv2d(h, p["w"].cpu().double(), p["b"].cpu().double(),
                         padding=1)
        elif kind == "relu":
            h = torch.relu(h)
        else:
            h = F.max_pool2d(h, 2, 2)
        out[1 + idx] = h[0]
    h = F.adaptive_avg_pool2d(h, (7, 7)).flatten(1)
    out[33] = h[0]
    for idx, kind in enumerate(vgg._CLASSIFIER):
        if kind == "linear":
            p = params["classifier"][str(idx)]
            h = F.linear(h, p["w"].cpu().double().t(), p["b"].cpu().double())
        elif kind == "relu":
            h = torch.relu(h)
    out[40] = h[0]
    return out


def run_vgg_f32(device, graphs_dir, counters) -> None:
    """vgg16 in f32 from the saved graph: one request of a 240 x 200 image
    with the transform, features.0, features.30, flatten and the logits
    tapped; no launch of the port's kernels; the transform within 1e-5 of
    the same kind on the host and every other tap within F32_BOUND of a
    float64 host forward (``vgg_f64_forward``) of the same seeded weights
    from the response's own transform output. TF32 is off (the server's
    ``exact_f32_matmuls``): cuDNN's f32 convolutions are exact products."""
    import torch

    from interactive_vit_tpu_torch.ops.preprocess_mm import preprocess_mm
    from interactive_vit_tpu_torch.wire.codec import Response

    image = np.random.default_rng(5).random((3, 240, 200), dtype=np.float32)
    app, httpd, url = serve(["vgg16"], "float32", device, graphs_dir)
    try:
        graph = app.graphs.load("vgg16.json")
        model = app.reg.get_node("vgg16:transform").model
        before = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        raw = post(url + "/compute", chain_request(
            graph, image, [(0, "o"), *((i, "o") for i in VGG_TAPS),
                           (40, "o")]))
        wall = (time.perf_counter() - t0) * 1e3
        launched = {k: fn.launches - before[k] for k, fn in counters.items()
                    if fn.launches != before[k]}
        if launched:
            raise AssertionError(f"vgg16 f32: launched {launched}; the "
                                 f"path runs no kernel of the port")
        t0 = time.perf_counter()
        want = vgg_f64_forward(model.params, torch.from_numpy(
            np.array(Response.decode(raw)[0]["o"])))
        host_s = time.perf_counter() - t0
    finally:
        stop(app, httpd)
    out = Response.decode(raw)
    pre = preprocess_mm(torch.from_numpy(image), 224).numpy()
    errs = {"transform": float(np.abs(out[0]["o"] - pre).max())}
    if errs["transform"] > 1e-5:
        raise AssertionError(f"vgg16 f32 transform off the host's by "
                             f"{errs['transform']:.3g}")
    for i in (*VGG_TAPS, 40):
        ref = want[i].numpy()
        if out[i]["o"].shape != ref.shape:
            raise AssertionError(f"vgg16 f32 node {i}: {out[i]['o'].shape}")
        errs[i] = float(np.abs(out[i]["o"] - ref).max())
    bad = {k: v for k, v in errs.items() if v > F32_BOUND}
    if bad:
        raise AssertionError(f"vgg16 f32 vs the float64 host forward: {bad}")
    log(f"  vgg16 float32: 1 request (client wall {wall:.2f} ms, the "
        f"first of its signature: an eager pass and its capture), no kernel "
        f"of the port; max abs err vs the float64 host forward of the same "
        f"weights (node: err, bound {F32_BOUND:g}): "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; the host forward took {host_s:.1f} s")


# The zero-shot graph's prompts (the saved graph's) and their edits: one
# reworded, one added
ZS_REWORD = (2, "a sketch of a tree")
ZS_ADDED = "a photo of a bird"


def zeroshot_plain(vision, text, image, prompts, device):
    """The zero-shot graph on its plain path: the image tower's layers with
    row 1's plain version in every block, the text tower's forward on the
    prompts' tokens, the similarity kind (scale 100) on the two. Returns
    (image embedding, text embeddings, logits); ``image`` [3, H, W]."""
    import torch

    from interactive_vit_tpu_torch.models import clip, clip_text
    from interactive_vit_tpu_torch.models.clip_bpe import default_tokenizer
    from interactive_vit_tpu_torch.ops import fused_block as fb
    from interactive_vit_tpu_torch.ops import node_ops

    vcfg, tcfg = clip.CLIPVisionConfig(), clip_text.CLIPTextConfig()
    x = torch.from_numpy(image).to(device)
    with torch.inference_mode():
        for name, extra, fn in clip.layer_fns(
                vcfg, block_impl=fb.fused_attn_block_reference):
            p = clip.layer_params(vision.params, name)
            x = (fn(p, {"o": x}, want=frozenset()) if extra
                 else fn(p, {"o": x}))["o"]
        tokens = torch.from_numpy(default_tokenizer().batch(
            prompts, tcfg.context)).to(device)
        t = clip_text.forward(text.params, tokens, tcfg)["embedding"]
        sim = next(k for k in node_ops.instances() if k.name == "similarity")
        caps = {k: v.to(device) for k, v in sim.captures({}).items()}
        logits = sim.fn({})({"a": x, "b": t}, caps)["o"]
    return x, t, logits


def run_zeroshot(device, graphs_dir, counters) -> None:
    """The repository's ``clip_zeroshot.json`` with both CLIP towers on one
    bf16 server (``max_wait_ms`` 100, so that two requests sent together
    form one group): the image embedding (node 15), the text embeddings
    (29) and the similarity logits (30) of each response held to the plain
    path (``zeroshot_plain``) within SLICE_REL of max(1, their scale), the
    embeddings' norms within NORM_BF16; each pass 12 launches of row 1's
    bf16 route (the image tower; the text tower runs no kernel), no other.
    The first request captures its program, the second (another image)
    replays it; one prompt reworded: a replay (no capture), the new text
    embeddings the plain path's and the image embedding the first
    request's bit for bit; a prompt added: exactly one capture; two
    requests that differ only in wording sent at once: one group
    (``X-IVT-Timing`` batch=2, one pass), each with its own prompts'
    embeddings; one profiled replay (row 1's kernels by name)."""
    import gc

    import torch

    from interactive_vit_tpu_torch.serving.server import build_app
    from interactive_vit_tpu_torch.wire.codec import Response

    rng = np.random.default_rng(3)
    images = [rng.random((3, 224, 224), dtype=np.float32) for _ in range(2)]
    gc.collect()
    torch.cuda.empty_cache()
    app = build_app(models=["clip_b32", "clip_text_b32"],
                    graphs_dir=graphs_dir, dtype_name="bfloat16",
                    device=device, seed=0, max_batch=8, max_wait_ms=100.0)
    httpd = app.serve("127.0.0.1", 0, background=True)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        obj = app.graphs.load("clip_zeroshot.json")
        base = json.loads(obj["nodes"][16]["instance"]["params"]["prompts"])
        vision = app.reg.get_node("clip_b32:embed").model
        text = app.reg.get_node("clip_text_b32:embed").model
        captured = watch_captures(app.executor)
        taps = [(15, "o"), (29, "o"), (30, "o")]

        def body(image, prompts):
            return chain_request(obj, image, taps, {16: {
                "prompts": json.dumps(prompts)}})

        def check_launches(tag, before, passes):
            launched = {k: fn.launches - before[k]
                        for k, fn in counters.items()}
            want = {k: 12 * passes if k == "fused_attn_block_mma" else 0
                    for k in counters}
            if launched != want:
                raise AssertionError(
                    f"zero-shot {tag}: launched "
                    f"{ {k: v for k, v in launched.items() if v} }, "
                    f"expected 12 of fused_attn_block_mma a pass")

        def check_values(tag, out, image, prompts):
            ref = zeroshot_plain(vision, text, image, prompts, device)
            for node, r in zip((15, 29, 30), ref):
                got, r = out[node]["o"], r.float().cpu().numpy()
                if got.shape != r.shape or not np.isfinite(got).all():
                    raise AssertionError(f"zero-shot {tag}: node {node} "
                                         f"{got.shape}, plain {r.shape}")
                bound = SLICE_REL * max(1.0, float(np.abs(r).max()))
                err = float(np.abs(got - r).max())
                worst[node] = max(worst.get(node, 0.0), err)
                if err > bound:
                    raise AssertionError(f"zero-shot {tag}: node {node} "
                                         f"{err:.3g} from the plain path "
                                         f"(bound {bound:g})")
                if node != 30:
                    unit_norm(None, got, f"zero-shot {tag} node {node}", True)

        def send(tag, image, prompts, caps):
            n_cap = len(captured)
            before = {k: fn.launches for k, fn in counters.items()}
            t0 = time.perf_counter()
            raw = post(url + "/compute", body(image, prompts))
            walls[tag] = (time.perf_counter() - t0) * 1e3
            check_launches(tag, before, 1)
            if len(captured) - n_cap != caps:
                raise AssertionError(f"zero-shot {tag}: "
                                     f"{len(captured) - n_cap} captures, "
                                     f"expected {caps}")
            out = Response.decode(raw)
            check_values(tag, out, image, prompts)
            return out

        worst, walls = {}, {}
        first = send("first request", images[0], base, 1)
        send("another image", images[1], base, 0)
        reworded = list(base)
        reworded[ZS_REWORD[0]] = ZS_REWORD[1]
        edited = send("reworded", images[0], reworded, 0)
        if not np.array_equal(edited[15]["o"], first[15]["o"]):
            raise AssertionError("zero-shot: rewording a prompt moved the "
                                 "image embedding")
        k = ZS_REWORD[0]
        if np.array_equal(edited[29]["o"][k], first[29]["o"][k]):
            raise AssertionError("zero-shot: the reworded prompt's "
                                 "embedding did not change")
        added = send("a prompt added", images[0], base + [ZS_ADDED], 1)
        if added[30]["o"].shape != (1, len(base) + 1):
            raise AssertionError(f"zero-shot: {added[30]['o'].shape} logits "
                                 f"for {len(base) + 1} prompts")
        # two requests that differ only in wording, sent together
        pair = [(images[0], base), (images[0], reworded)]
        before = {k: fn.launches for k, fn in counters.items()}
        results = [None, None]

        def worker(j):
            results[j] = post_timed(url + "/compute", body(*pair[j]))

        threads = [threading.Thread(target=worker, args=(j,))
                   for j in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if None in results:
            raise AssertionError("zero-shot: a request of the pair did not "
                                 "complete")
        batches = [timing.get("batch") for _, timing in results]
        if batches != [2.0, 2.0]:
            raise AssertionError(f"zero-shot: the reworded pair ran in "
                                 f"batches {batches}, not one group of 2")
        check_launches("the reworded pair", before, 1)
        for j, (raw, _) in enumerate(results):
            check_values(f"the pair's request {j}", Response.decode(raw),
                         *pair[j])
        rows = [Response.decode(raw)[29]["o"][k] for raw, _ in results]
        if np.array_equal(*rows):
            raise AssertionError("zero-shot: the pair's reworded prompt got "
                                 "the other request's embedding")
        prof = profile_request(
            app.executor, chain_graph(obj, images[1], {16: {
                "prompts": json.dumps(base)}}), taps,
            "clip_zeroshot bfloat16", {"row1_qkv_mma_kernel": 12,
                                       "row1_attn_mma_kernel": 12,
                                       "proj_mma_kernel": 12,
                                       "::attention_kernel": 0})
        reserved = torch.cuda.memory_reserved() / 2 ** 30
    finally:
        stop(app, httpd)
    log(f"  clip_zeroshot bfloat16 (clip_b32 + clip_text_b32, "
        f"{len(base)} prompts): client walls (ms) "
        + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
        + f"; captures (bucket, ms) "
        f"{[(k, round(t * 1e3, 1)) for k, t in captured]} (the first "
        f"request, the added prompt, the pair's bucket 2); the reworded "
        f"pair in one group (batch=2 in both X-IVT-Timing headers); worst "
        f"max abs err vs the plain path: image embedding {worst[15]:.3g}, "
        f"text embeddings {worst[29]:.3g}, logits {worst[30]:.3g} (bound "
        f"{SLICE_REL:g} of max(1, scale)); profiled replay wall "
        f"{prof[0]:.2f} ms, device busy {prof[1]:.2f} ms; memory_reserved "
        f"{reserved:.2f} GiB")


def run_demo_graphs(device, graphs_dir, counters) -> None:
    """The repository's demo graphs through ``POST /compute`` on a server of
    no model: demo_noise.json (noise, const, binop) with its seed edited
    three times and its const value once, each a cache hit and no new
    capture, every output the same kinds' on the CPU bit for bit; one noise
    node of the fixture's pinned entry (seed 7, [2, 5, 5]), its values the
    pinned ones (6 decimals) and the CPU's bits; demo_slice.json (slice,
    shuffle, conv2d) on a 3 x 224 x 224 image, then its conv matrix edited
    and then a second image, each a cache hit and no new capture: the
    slice and shuffle exact, the f32 conv within 1e-5 of a float64 conv on
    the host; the fixture's similarity graph (two noise nodes) with its
    scale edited, a cache hit and no new capture, within 1e-5 of the scale
    of the kind on the host. Then one group of each through
    ``executor.run_stacked`` (three graphs that differ in their dynamic
    values, or images): each result its own run's bit for bit. None of the
    port's kernels launches."""
    import base64

    import torch
    from interactive_vit_tpu_torch.graph.ir import Graph
    from interactive_vit_tpu_torch.ops import node_ops
    from interactive_vit_tpu_torch.wire.codec import Response
    from interactive_vit_tpu_torch.wire.schema import graph_from_json

    def kind(name):
        return next(k for k in node_ops.instances() if k.name == name)

    def noise_on_cpu(dims, seed):
        k = kind("noise")
        params = {"dims": dims, "seed": str(seed)}
        return k.fn(params)({}, k.captures(params))["o"].numpy()

    before = {k: fn.launches for k, fn in counters.items()}
    app, httpd, url = serve([], "float32", device, graphs_dir)
    try:
        ex = app.executor
        captured = watch_captures(ex)

        def ask(g, taps):
            t0 = time.perf_counter()
            out = Response.decode(post(url + "/compute",
                                       graph_request(g, taps)))
            return out, ex.last_stats.cache_hit, (time.perf_counter()
                                                  - t0) * 1e3

        noise_obj = app.graphs.load("demo_noise.json")
        noise_taps = [(0, "o"), (1, "o"), (2, "c"), (3, "c")]

        def noise_graph(seed, value):
            g = graph_from_json(noise_obj)
            g.nodes[0].params["seed"] = str(seed)
            g.nodes[1].params["value"] = str(value)
            return g

        walls = []
        for n, (seed, value) in enumerate(((0, 0.5), (7, 0.5), (-1, 0.5),
                                           (12345, 0.5), (12345, 2.0))):
            out, hit, ms = ask(noise_graph(seed, value), noise_taps)
            walls.append(ms)
            if n and (not hit or len(captured) != 1):
                raise AssertionError(f"demo_noise seed {seed} value {value}: "
                                     f"cache hit {hit}, captures "
                                     f"{len(captured)}")
            noise = noise_on_cpu("[128, 128]", seed)
            const = np.full((128, 128), value, np.float32)
            for key, want in (((0, "o"), noise), ((1, "o"), const),
                              ((2, "c"), noise * const),
                              ((3, "c"), noise * const + const)):
                if not np.array_equal(out[key[0]][key[1]], want):
                    raise AssertionError(f"demo_noise seed {seed}: node "
                                         f"{key} is not the CPU's bit for bit")
        with open(os.path.join(HERE, "tests", "fixtures",
                               "node_fixtures.json")) as f:
            pinned = json.load(f)["noise"]["expected"]["0/o"]
        g = Graph()
        g.add_node("noise", {"dims": "[2,5,5]", "seed": "7"})
        out, _, _ = ask(g, [(0, "o")])
        seven = out[0]["o"]
        pin_err = float(np.abs(seven.ravel() - pinned["values"]).max())
        if (list(seven.shape) != pinned["dims"] or pin_err > 6e-7
                or not np.array_equal(seven, noise_on_cpu("[2,5,5]", 7))):
            raise AssertionError(f"the pinned noise entry: {pin_err} from "
                                 f"its 6 decimals, or not the CPU's bits")
        log(f"  demo_noise.json: seeds 0, 7, -1, 12345 and const 0.5 -> 2.0, "
            f"every request after the first a cache hit and no new capture "
            f"(walls {', '.join(f'{w:.2f}' for w in walls)} ms); noise, "
            f"const and both binops the CPU's bit for bit; noise seed 7 "
            f"[2, 5, 5] the CPU's bits and within {pin_err:.3g} of the "
            f"fixture's pinned 6 decimals (bound 6e-7: half a unit of the "
            f"6th decimal and an f32 rounding)")

        slice_obj = app.graphs.load("demo_slice.json")
        slice_taps = [(1, "o"), (2, "o"), (3, "o")]
        rng = np.random.default_rng(3)
        images = [rng.random((3, 224, 224), dtype=np.float32)
                  for _ in range(2)]
        edited = rng.standard_normal((3, 3)).astype(np.float32)
        saved = np.frombuffer(base64.b64decode(
            slice_obj["nodes"][3]["instance"]["matrix"]), "<f4").reshape(3, 3)

        def slice_graph(image, m):
            g = graph_from_json(slice_obj)
            g.nodes[3].params["matrix"] = base64.b64encode(
                m.astype("<f4").tobytes()).decode()
            g.add_input(image, g.nodes[0], "o")
            return g

        n_cap, walls, errs = len(captured), [], []
        for n, (image, m) in enumerate(((images[0], saved),
                                        (images[0], edited),
                                        (images[1], edited))):
            out, hit, ms = ask(slice_graph(image, m), slice_taps)
            walls.append(ms)
            if n and (not hit or len(captured) != n_cap + 1):
                raise AssertionError(f"demo_slice request {n}: cache hit "
                                     f"{hit}, captures "
                                     f"{len(captured) - n_cap}")
            if not (np.array_equal(out[1]["o"], image[1])
                    and np.array_equal(out[2]["o"], image[1].T)):
                raise AssertionError(f"demo_slice request {n}: slice or "
                                     f"shuffle not exact")
            errs.append(float(np.abs(out[3]["o"] - conv_f64(image, m)).max()))
            if errs[-1] > 1e-5:
                raise AssertionError(f"demo_slice request {n}: the f32 conv "
                                     f"is {errs[-1]} from float64")
        log(f"  demo_slice.json on 3 x 224 x 224: the saved matrix, an "
            f"edited matrix (a cache hit, no new capture), a second image "
            f"(a cache hit) (walls {', '.join(f'{w:.2f}' for w in walls)} "
            f"ms); slice and shuffle exact, the conv within "
            f"{max(errs):.3g} of float64 (bound 1e-5)")

        def sim_graph(scale):
            g = Graph()
            a = g.add_node("noise", {"dims": "[2,8]", "seed": "5"})
            b = g.add_node("noise", {"dims": "[3,8]", "seed": "6"})
            c = g.add_node("similarity", {"scale": str(scale)})
            g.connect(a, "o", c, "a")
            g.connect(b, "o", c, "b")
            return g

        n_cap, sim_errs = len(captured), []
        sim = kind("similarity")
        for n, scale in enumerate((10.0, 3.0)):
            out, hit, _ = ask(sim_graph(scale), [(2, "o")])
            if n and (not hit or len(captured) != n_cap + 1):
                raise AssertionError(f"similarity scale {scale}: cache hit "
                                     f"{hit}, captures "
                                     f"{len(captured) - n_cap}")
            ab = {"a": torch.from_numpy(noise_on_cpu("[2,8]", 5)),
                  "b": torch.from_numpy(noise_on_cpu("[3,8]", 6))}
            host = sim.fn({})(ab, sim.captures({"scale": str(scale)}))["o"]
            sim_errs.append(float(np.abs(out[2]["o"] - host.numpy()).max()))
            if sim_errs[-1] > 1e-5 * scale:
                raise AssertionError(f"similarity scale {scale}: "
                                     f"{sim_errs[-1]} from the host's")
        groups = {
            "demo_noise": ([noise_graph(s, v) for s, v in
                            ((1, 0.5), (2, -1.0), (-1, 3.0))], noise_taps),
            "demo_slice": ([slice_graph(im, m) for im, m in
                            ((images[0], saved), (images[1], edited),
                             (images[1], saved))], slice_taps),
            "similarity": ([sim_graph(s) for s in (1.0, 10.0, 100.0)],
                           [(2, "o")])}
        for name, (graphs, taps) in groups.items():
            results = ex.run_stacked(graphs, taps)
            for j, (g, res) in enumerate(zip(graphs, results)):
                single = ex.run(g, taps)
                if not all(np.array_equal(res[i][ch], single[i][ch])
                           for i, ch in taps):
                    raise AssertionError(f"{name}: result {j} of a stacked "
                                         f"group is not its own run's")
        log(f"  similarity (two noise nodes) scale 10 -> 3: a cache hit and "
            f"no new capture, within {max(sim_errs):.3g} of the kind on the "
            f"host (bound 1e-5 of the scale); a group of 3 of demo_noise "
            f"(seeds and values), demo_slice (images and matrices) and "
            f"similarity (scales) through run_stacked: every result its own "
            f"run's bit for bit")
    finally:
        stop(app, httpd)
    launched = {k: fn.launches - before[k] for k, fn in counters.items()
                if fn.launches != before[k]}
    if launched:
        raise AssertionError(f"the demo graphs launched {launched}")


def run_graph_on_card(counters) -> None:
    """``tools.run_graph.main`` of the repository's dino_s16.json in bf16
    on the card from a ``.npy`` image: 12 launches of row 1's bf16
    tensor-core route (its one warm pass; the capture's record is not
    counted), none of another kernel; an ``.npy`` per tap and PNGs of the
    two feature maps, [1, 3, 14, 14] in [0, 1]."""
    from interactive_vit_tpu_torch.tools import run_graph

    tmp = tempfile.mkdtemp(prefix="ivt_run_graph_")
    try:
        image = os.path.join(tmp, "image.npy")
        np.save(image, np.random.default_rng(5).random((3, 224, 224),
                                                       dtype=np.float32))
        out = os.path.join(tmp, "taps")
        before = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        rc = run_graph.main(["dino_s16", "--image", image, "--out", out,
                             "--dtype", "bfloat16"])
        secs = time.perf_counter() - t0
        launched = {k: fn.launches - before[k] for k, fn in counters.items()}
        want = {k: 12 if k == "fused_attn_block_mma" else 0 for k in counters}
        if rc != 0 or launched != want:
            raise AssertionError(
                f"run_graph: rc {rc}, launches "
                f"{ {k: n for k, n in launched.items() if n} }")
        with open(os.path.join(out, "manifest.json")) as f:
            man = json.load(f)
        for stem in man:
            if not np.isfinite(np.load(os.path.join(out,
                                                    stem + ".npy"))).all():
                raise AssertionError(f"run_graph: {stem}.npy not finite")
        pngs = []
        for kind in ("pca_view", "patch_sim"):
            stem, meta = next((s, m) for s, m in man.items()
                              if m["name"] == kind)
            a = np.load(os.path.join(out, stem + ".npy"))
            with open(os.path.join(out, stem + ".png"), "rb") as f:
                head = f.read(8)
            if (not meta["png"] or meta["shape"] != [1, 3, 14, 14]
                    or head != b"\x89PNG\r\n\x1a\n"
                    or a.min() < 0 or a.max() > 1):
                raise AssertionError(f"run_graph: {kind} {meta}")
            pngs.append(stem + ".png")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  run_graph.main dino_s16.json --dtype bfloat16 on the card: rc 0 "
        f"in {secs:.1f} s (model, capture), 12 fused_attn_block_mma "
        f"launches, {len(man)} .npy taps, PNGs {pngs}")


# The gradient kinds' bounds. saliency, dream and attrib differentiate
# through the plain twins, which replay the same plain ops from the same
# image on the served path and on the plain path: their outputs must be
# the plain path's bit for bit, in both dtypes. The logits, of the main
# pass and of occlusion's chunked forwards (OCCLUSION_CHUNK masked images
# in one batched pass through the kernels), are held as a served path's
# are (``check_logits``): against the plain path on the same batch (ToMe
# in bf16: ``tome_lockstep``, whose merges may differ from the kernel
# path's only on near ties), bf16 within SLICE_REL of max(1, |logit|),
# f32 within F32_BOUND. Occlusion's drops are differences of close scores,
# each bound scaled to the plain path's largest drop ``scale`` and
# refusing a zeroed or halved grid (bound < scale / 2): in f32 the whole
# grid against the plain path's within F32_BOUND of max(1, scale), but
# ToMe's (its merges flip on near ties between the kernel and the plain
# path); those and the bf16 drops position by position against batch-1
# forwards through the same kernels, within OCC_DROP_REL of the scale
# (f32: F32_BOUND of max(1, scale)). Occlusion's render against the
# host's render of the response's own drops (HEAT_BOUND).
# OCC_DROP_REL: a bf16 score in [2, 4) (the served logits' largest, with
# seeded random weights) has ulps of 2^-6; a forward of another batch moves
# it by an ulp, a drop by up to two, and swin_t's largest drop is 0.125, 8
# such ulps (measured on an NVIDIA H100 80GB HBM3 at 700 W: every drop
# within 0.0156 of its batch-1 forward); 2^-2 of the scale is 2 ulps there
# and still refuses a halved grid.
OCC_DROP_REL = 2.0 ** -2
HEAT_BOUND = 1e-4
# the saved graphs served from the repository (occlusion patch 32 stride 16
# on a 224 image: 169 positions in chunks of 32, 6 batched passes beside
# the unoccluded one and the main pass: each kernel of the chain 8 times a
# request)
SALIENCY_PATHS = (
    ("vit_t16", {"fused_attn_block_mma": 96},
     {"fused_attn_block_tf32x3": 96},
     {"row1_attn_mma_kernel": 96, "::attention_kernel": 0}),
    ("swin_t", {"fused_window_attn_mma": 96},
     {"fused_window_attn_tf32x3": 96},
     {"window_attn_mma_kernel": 96, "window_attention_kernel": 0}),
    ("vit_b16_tome", {"fused_attn_block_mma": 96,
                      "fused_attn_block_tome_mma": 96},
     {"fused_attn_block_tf32x3": 96, "fused_attn_block_tome_tf32x3": 96},
     {"row1_attn_mma_kernel": 96, "key_mean_kernel": 96,
      "::attention_kernel": 0}),
)
# run_saliency_graphs' dream steps (the saved graphs' 32 cut: a step is a
# forward and a backward through the plain twins, no kernel, so the cut
# moves no launch count, only the busy and the capture time)
SALIENCY_DREAM_STEPS = "8"
# (kind, its raw channel) of the gradient nodes a saliency graph taps
GRAD_TAPS = {"saliency": "g", "dream": "delta", "occlusion": "g",
             "attrib": "rel"}


def grad_kind(name):
    return name.rsplit(":", 1)[-1]


def busy_str(ms):
    return "not measured" if ms is None else f"{ms:.2f}"


def saliency_path(variant):
    """A served saliency variant as a ``Path`` with no taps, for
    ``plain_taps`` (its blocks on their plain versions) and, for ToMe,
    ``tome_lockstep``."""
    from interactive_vit_tpu_torch.models import swin, tome, vit
    from interactive_vit_tpu_torch.ops import fused_block as fb
    from interactive_vit_tpu_torch.ops import fused_window as fw

    if variant.startswith("swin_"):
        return Path(variant, swin, swin.VARIANTS[variant], 224, {}, {},
                    {"window_impl": fw.fused_window_attn_reference},
                    swin_tap_shape, 0, 0)
    plain = {"block_impl": fb.fused_attn_block_reference}
    if "_tome" in variant:
        return Path(variant, tome, tome.VARIANTS[variant], 224, {}, {},
                    plain, tome_tap_shape, 0, 0, chain=("s", "a"),
                    lockstep=tome_lockstep)
    return Path(variant, vit, vit.resolve_variant(variant), 224, {}, {},
                plain, vit_tap_shape, 0, 0)


def plain_model_of(variant, model, dtype, device):
    """The served model's weights on the plain path (no kernel: the
    reference's layers in every block)."""
    from interactive_vit_tpu_torch.models.swin_plugin import make_swin_model
    from interactive_vit_tpu_torch.models.tome_plugin import make_tome_model
    from interactive_vit_tpu_torch.models.vit_plugin import make_vit_model

    if variant.startswith("swin_"):
        return make_swin_model(variant, params=model.params, dtype=dtype,
                               device=device, kernels=False)
    if "_tome" in variant:
        return make_tome_model(variant, params=model.params, dtype=dtype,
                               device=device, kernels=False)
    return make_vit_model(variant, params=model.params, dtype=dtype,
                          device=device, block_kernel="reference")


def occlusion_render(g, h, w, patch, stride):
    """Occlusion's "o" plane on the host in float64 from its drop grid
    ``g`` [gh, gw] (the kind's coverage-normalized, min-max render)."""
    ph, pw = min(patch, h), min(patch, w)
    gh, gw = g.shape
    canvas, count = np.zeros((h, w)), np.zeros((h, w))
    for p in range(gh * gw):
        py = min((p // gw) * stride, h - ph)
        px = min((p % gw) * stride, w - pw)
        canvas[py:py + ph, px:px + pw] += float(g.flat[p])
        count[py:py + ph, px:px + pw] += 1.0
    heat = canvas / np.maximum(count, 1.0)
    return (heat - heat.min()) / max(heat.max() - heat.min(), 1e-12)


def occluded(image, positions, gw, patch, stride):
    """``image`` [3, H, W] with occlusion's window at each of
    ``positions`` filled with 0 (the saved graphs' fill), [P, 3, H, W]."""
    _, h, w = image.shape
    ph, pw = min(patch, h), min(patch, w)
    out = np.repeat(image[None], len(positions), axis=0)
    for j, p in enumerate(positions):
        py = min((p // gw) * stride, h - ph)
        px = min((p % gw) * stride, w - pw)
        out[j, :, py:py + ph, px:px + pw] = 0.0
    return out


def check_logits(tag, key, got, ref, f32):
    """Logits against their reference at a served path's bound: f32
    within F32_BOUND, bf16 within SLICE_REL of max(1, their largest
    magnitude). Returns the difference and the bound."""
    bound = (F32_BOUND if f32
             else SLICE_REL * max(1.0, float(np.abs(ref).max())))
    err = float(np.abs(got - ref).max())
    if got.shape != ref.shape or not np.isfinite(got).all() or err > bound:
        raise AssertionError(f"{tag} {key}: {got.shape} {err} from its "
                             f"reference {ref.shape} (bound {bound})")
    return err, bound


def drop_bound(tag, scale, f32):
    """The bound of occlusion's drops: F32_BOUND of max(1, ``scale``) in
    f32, OCC_DROP_REL of it in bf16, ``scale`` the plain path's largest
    drop; it must refuse a zeroed or halved grid."""
    bound = F32_BOUND * max(1.0, scale) if f32 else OCC_DROP_REL * scale
    if not bound < scale / 2:
        raise AssertionError(f"{tag}: the drops' bound {bound} would not "
                             f"refuse a halved grid (largest drop {scale})")
    return bound


def occlusion_positions_check(ex, chain_obj, image, g, patch, stride, tag,
                              bound):
    """Six positions of occlusion's drop grid (the first and last of a
    chunk among them) against batch-1 forwards of the chain through the
    same kernels (``ex``, eager): base minus the occluded max logit, each
    within ``bound``. Returns the largest difference."""
    from interactive_vit_tpu_torch.ops.node_ops import OCCLUSION_CHUNK

    head = next(i for i, n in enumerate(chain_obj["nodes"])
                if n["instance"].get("endpoint", "").endswith(":head"))

    def score(img):
        out = ex.run(chain_graph(chain_obj, img), [(head, "o")])
        return float(out[head]["o"].max())

    base = score(image)
    worst = 0.0
    n_pos = g.size
    for p in sorted({0, OCCLUSION_CHUNK - 1, OCCLUSION_CHUNK, n_pos // 2,
                     n_pos - 2, n_pos - 1}):
        masked = occluded(image, [p], g.shape[-1], patch, stride)[0]
        diff = abs((base - score(masked)) - float(g.flat[p]))
        worst = max(worst, diff)
        if diff > bound:
            raise AssertionError(f"{tag}: occlusion position {p}'s drop is "
                                 f"{diff} from its batch-1 forward (bound "
                                 f"{bound})")
    return worst


def occlusion_chunk_check(ex, path, model, chain_obj, image, g, patch,
                          stride, tag, f32, counters, kernels, device):
    """Occlusion's first chunk at its own shape: its OCCLUSION_CHUNK masked
    images as one ``run_stacked`` group of the chain through the served
    kinds (``ex``, eager: every layer's ``stacked_fn`` at the chunked
    replay's batch), which launches each kernel of the chain once (a
    request's ``kernels`` over its passes); the group's logits against the
    reference path on the same batch (``check_logits``): ``plain_taps``,
    or for ToMe ``tome_lockstep``, every block against its plain version
    on the kernel path's inputs, a merge that differs excused only as a
    near tie (``tome_lut_check``); and the response's drops ``g`` of those
    positions, base minus each row's max logit, bit for bit. Returns the
    logits' difference and bound."""
    from interactive_vit_tpu_torch.ops.node_ops import OCCLUSION_CHUNK

    head = next(i for i, n in enumerate(chain_obj["nodes"])
                if n["instance"].get("endpoint", "").endswith(":head"))
    masked = occluded(image, range(OCCLUSION_CHUNK), g.shape[-1], patch,
                      stride)
    passes = 2 + -(-g.size // OCCLUSION_CHUNK)
    before = {k: fn.launches for k, fn in counters.items()}
    rows = ex.run_stacked([chain_graph(chain_obj, m) for m in masked],
                          [(head, "o")])
    launched = {k: fn.launches - before[k] for k, fn in counters.items()}
    if launched != {k: kernels.get(k, 0) // passes for k in counters}:
        raise AssertionError(f"{tag}: a chunk of {OCCLUSION_CHUNK} launched "
                             f"{ {k: n for k, n in launched.items() if n} }")
    logits = np.concatenate([r[head]["o"] for r in rows])
    ref = (path.lockstep or plain_taps)(path, model, masked, device)[0]
    err, bound = check_logits(f"{tag} occlusion's chunk", "logits", logits,
                              ref.float().cpu().numpy(), f32)
    base = np.float32(ex.run(chain_graph(chain_obj, image),
                             [(head, "o")])[head]["o"].max())
    drops = base - logits.max(axis=-1)
    if not np.array_equal(drops, g.reshape(-1)[:OCCLUSION_CHUNK]):
        raise AssertionError(f"{tag}: occlusion's first {OCCLUSION_CHUNK} "
                             f"drops are not the chunk's bit for bit "
                             f"({float(np.abs(drops - g.reshape(-1)[:OCCLUSION_CHUNK]).max())})")
    return err, bound



def run_saliency_graphs(device, graphs_dir, counters) -> None:
    """The repository's saliency graphs through ``POST /compute`` (see the
    module docstring, phase 4, "the gradient kinds")."""
    import gc

    import torch
    from interactive_vit_tpu_torch.graph.executor import Executor
    from interactive_vit_tpu_torch.graph.registry import Registry
    from interactive_vit_tpu_torch.ops.node_ops import register_builtin
    from interactive_vit_tpu_torch.serving.server import DTYPES
    from interactive_vit_tpu_torch.wire.codec import Response
    from interactive_vit_tpu_torch.wire.schema import graph_from_json

    rng = np.random.default_rng(21)
    images = [rng.random((3, 224, 224), dtype=np.float32) for _ in range(2)]
    t_phase = time.perf_counter()
    for variant, bf16_kernels, f32_kernels, profile_names in SALIENCY_PATHS:
        path = saliency_path(variant)
        for dtype_name in ("bfloat16", "float32"):
            f32 = dtype_name == "float32"
            kernels = f32_kernels if f32 else bf16_kernels
            tag = f"{variant}_saliency {dtype_name}"
            t_path = t0 = time.perf_counter()
            split = {}

            def lap(what):
                nonlocal t0
                split[what] = time.perf_counter() - t0
                t0 = time.perf_counter()

            gc.collect()
            torch.cuda.empty_cache()
            reserved0 = torch.cuda.memory_reserved() / 2 ** 30
            app, httpd, url = serve([variant], dtype_name, device,
                                    graphs_dir)
            try:
                ex = app.executor
                captured = watch_captures(ex)
                obj = app.graphs.load(f"{variant}_saliency.json")
                chain_obj = app.graphs.load(variant + ".json")
                names = [n["instance"].get("endpoint")
                         or n["instance"]["kind"] for n in obj["nodes"]]
                grads = {i: grad_kind(nm) for i, nm in enumerate(names)
                         if grad_kind(nm) in GRAD_TAPS}
                for i, k in grads.items():
                    if k == "dream":
                        obj["nodes"][i]["instance"]["params"]["steps"] = \
                            SALIENCY_DREAM_STEPS
                head = next(i for i, nm in enumerate(names)
                            if nm.endswith(":head"))
                taps = sorted({(head, "o")} | {
                    (i, ch) for i, k in grads.items()
                    for ch in ("o", GRAD_TAPS[k])})
                occ = next(i for i, k in grads.items() if k == "occlusion")
                dream = next(i for i, k in grads.items() if k == "dream")
                occ_p = obj["nodes"][occ]["instance"]["params"]
                patch, stride = int(occ_p["patch"]), int(occ_p["stride"])
                lap("server")

                def graph_of(image, edits=None):
                    g = graph_from_json(obj)
                    for i, params in (edits or {}).items():
                        g.nodes[i].params.update(params)
                    g.add_input(image, g.nodes[0], "o")
                    return g

                lat = []

                def ask(g):
                    t = time.perf_counter()
                    out = Response.decode(post(url + "/compute",
                                               graph_request(g, taps)))
                    lat.append((time.perf_counter() - t) * 1e3)
                    return out

                # the first request: its eager pass (the warm pass, whose
                # outputs are the response) and the capture
                first = ask(graph_of(images[0]))
                stats = ex.last_stats
                eager_ms = (stats.execute_s - stats.compile_s) * 1e3
                if len(captured) != 1:
                    raise AssertionError(f"{tag}: {len(captured)} captures "
                                         f"for the first request")
                lap("warm pass and capture")
                lat.clear()
                for fn in counters.values():
                    fn.launches = 0
                got = ask(graph_of(images[1]))
                launched = {k: fn.launches for k, fn in counters.items()}
                want = {k: kernels.get(k, 0) for k in counters}
                if not ex.last_stats.cache_hit or launched != want:
                    raise AssertionError(
                        f"{tag}: a replay (cache hit "
                        f"{ex.last_stats.cache_hit}) launched "
                        f"{ {k: n for k, n in launched.items() if n} }, "
                        f"expected {kernels}")
                # the replay of the captured image against that request's
                # eager pass; the second image's replay against the plain
                # path below
                again = ask(graph_of(images[0]))
                same = [f"{i}/{ch}" for i, ch in taps
                        if not np.array_equal(again[i][ch], first[i][ch])]
                if same:
                    raise AssertionError(f"{tag}: the replay differs from "
                                         f"its eager pass in {same}")
                lap("replays")
                # the plain path (no kernel), eager, from the same image
                plain_reg = Registry()
                register_builtin(plain_reg)
                model = app.reg.get_node(variant + ":head").model
                plain_model_of(variant, model, DTYPES[dtype_name][0],
                               device).register(plain_reg)
                before = {k: fn.launches for k, fn in counters.items()}
                plain = Executor(plain_reg, use_jit=False,
                                 device=device).run(graph_of(images[1]), taps)
                if any(fn.launches != before[k]
                       for k, fn in counters.items()):
                    raise AssertionError(f"{tag}: the plain path launched "
                                         f"a kernel")
                lap("plain path")
                eager = Executor(app.reg, use_jit=False, device=device)
                g_scale = float(np.abs(plain[occ]["g"]).max())
                occ_bound = drop_bound(tag, g_scale, f32)
                errs = {}
                for i, ch in taps:
                    if i in grads and grads[i] != "occlusion":
                        if not np.array_equal(got[i][ch], plain[i][ch]):
                            raise AssertionError(
                                f"{tag} {names[i]} {ch}: "
                                f"{float(np.abs(got[i][ch] - plain[i][ch]).max())} "
                                f"from the plain path (its twins must give "
                                f"the same bits)")
                        errs[f"{grads[i]} {ch}"] = 0.0
                    elif i == head:
                        ref = plain[i][ch]
                        if path.lockstep and not f32:
                            # ToMe's merges may flip on near ties between
                            # the kernels and the plain path
                            ref = path.lockstep(path, model, images[1],
                                                device)[0].float().cpu(
                                                ).numpy()
                        errs["head o"] = check_logits(tag, "head o",
                                                      got[i][ch], ref,
                                                      f32)[0]
                    elif ch == "o":
                        heat = occlusion_render(got[i]["g"], 224, 224,
                                                patch, stride)
                        errs["occlusion o vs its g"] = float(np.abs(
                            got[i]["o"] - heat[None]).max())
                        if errs["occlusion o vs its g"] > HEAT_BOUND:
                            raise AssertionError(
                                f"{tag}: occlusion's render is "
                                f"{errs['occlusion o vs its g']} from the "
                                f"host's render of its drops")
                        errs["occlusion o vs plain (logged)"] = float(
                            np.abs(got[i]["o"] - plain[i]["o"]).max())
                    elif f32 and not path.lockstep:
                        errs["occlusion g"] = float(np.abs(
                            got[i][ch] - plain[i][ch]).max())
                        if errs["occlusion g"] > occ_bound:
                            raise AssertionError(
                                f"{tag}: occlusion's drops are "
                                f"{errs['occlusion g']} from the plain "
                                f"path's (bound {occ_bound})")
                    else:
                        errs["occlusion g vs plain (logged)"] = float(
                            np.abs(got[i]["g"] - plain[i]["g"]).max())
                        errs["occlusion g vs batch-1"] = \
                            occlusion_positions_check(
                                eager, chain_obj, images[1], got[i]["g"],
                                patch, stride, tag, occ_bound)
                errs["occlusion's chunk logits"], chunk_bound = \
                    occlusion_chunk_check(eager, path, model, chain_obj,
                                          images[1], got[occ]["g"], patch,
                                          stride, tag, f32, counters,
                                          kernels, device)
                lap("checks")
                # dynamic params: dream's class and lr, occlusion's fill
                n_cap = len(captured)
                scrubbed = ask(graph_of(images[1], {
                    dream: {"class": "5", "lr": "0.1"},
                    occ: {"fill": "0.5"}}))
                if not ex.last_stats.cache_hit or len(captured) != n_cap:
                    raise AssertionError(f"{tag}: a dynamic scrub was not "
                                         f"a cache hit without a capture")
                for i in (dream, occ):
                    ch = GRAD_TAPS[grads[i]]
                    if np.array_equal(scrubbed[i][ch], got[i][ch]):
                        raise AssertionError(f"{tag}: node {i}'s scrub did "
                                             f"not change {ch}")
                g1 = graph_of(images[1])
                replay_ms = median_ms(lambda: ex.run(g1, taps))
                lap("scrub and replay walls")
                rw = rb = None
                if not f32:
                    # the kernels by name and the device busy (~40,000
                    # kernels: 5-16 s a trace), in bf16 only
                    rw, rb = profiled(
                        lambda: synchronized_ms(lambda: ex.run(g1, taps)),
                        f"{tag} profile of one executor.run (replay)",
                        profile_names)
                    lap("profiled replay")
                reserved = (torch.cuda.memory_reserved() / 2 ** 30
                            - reserved0)
                kinds_ms = {}
                if variant == "vit_t16" and not f32:
                    kinds_ms = busy_by_kind(ex, obj, grads, images[1], rb,
                                            tag)
                    lap("busy by kind")
                    saliency_modes_check(app, url, obj, images, tag,
                                         captured)
                    lap("modes and a group")
                COMPILED.append((tag, replay_ms, eager_ms, rw, rb, eager_ms,
                                 None, [t for _, t in captured], reserved))
            finally:
                stop(app, httpd)
            log(f"  {tag} (the saved graph: "
                f"{', '.join(sorted(set(grads.values())))}; dream "
                f"{SALIENCY_DREAM_STEPS} steps, "
                f"occlusion patch {patch} stride {stride}): launches a "
                f"request {kernels} (the main pass and occlusion's "
                f"unoccluded and 6 chunked forwards; the FMA routes none); "
                f"the captured image's replay equals its eager pass bit "
                f"for bit; against the plain path "
                + "; ".join(f"{k} {v:.3g}" for k, v in errs.items())
                + f" (the chunk's logits bound {chunk_bound:.3g}; the "
                f"drops' bound {occ_bound:.3g}, their largest plain "
                f"{g_scale:.3g}); dynamic scrub (dream class + lr, "
                f"occlusion fill) a cache hit, no capture, new values; "
                f"walls replay {replay_ms:.2f} (median of 3) / eager "
                f"{eager_ms:.2f} ms (the first request's warm pass), "
                f"profiled replay busy {busy_str(rb)} ms; client p50 "
                f"{float(np.median(lat)):.2f} ms ({len(lat)} replays); "
                f"captures {', '.join(f'{t:.2f}' for _, t in captured)} s"
                + ("; device busy by kind (profiled replays of the chain "
                   "and of the chain with each kind, less the chain; dream "
                   "the whole graph's less the rest) "
                   + ", ".join(f"{k} {busy_str(v)}"
                               for k, v in kinds_ms.items()) + " ms"
                   if kinds_ms else "")
                + f"; memory_reserved {reserved:.2f} GiB above the path's "
                f"start; {time.perf_counter() - t_path:.1f} s ("
                + ", ".join(f"{k} {v:.1f}" for k, v in split.items()) + ")")
    log(f"  the saliency graphs: {time.perf_counter() - t_phase:.1f} s")


def busy_by_kind(ex, obj, grads, image, whole_ms, tag):
    """Device busy ms of each gradient kind: one profiled replay of the
    saved graph cut to the model's chain, and one of the chain with each
    kind but dream, less the chain; dream's the whole graph's replay
    (``whole_ms``) less the rest (a replay runs no Python that could name
    its kernels, and dream's own program would take a second capture of
    its 32 steps). The cut graphs are programs of their own, captured
    first."""
    keep = [i for i, n in enumerate(obj["nodes"]) if i not in grads
            and n["instance"].get("kind") == "net_node"]

    def cut(extra):
        nodes = keep + extra
        where = {old: new for new, old in enumerate(nodes)}
        edges = [{"in_port": {**e["in_port"],
                              "node": where[e["in_port"]["node"]]},
                  "out_port": {**e["out_port"],
                               "node": where[e["out_port"]["node"]]}}
                 for e in obj["edges"] if e["in_port"]["node"] in where
                 and e["out_port"]["node"] in where]
        return {"nodes": [obj["nodes"][i] for i in nodes], "edges": edges}

    head = next(k for k, i in enumerate(keep) if obj["nodes"][i][
        "instance"]["endpoint"].endswith(":head"))
    busy = {}
    for what, extra in [("chain", [])] + [(k, [i]) for i, k in
                                          sorted(grads.items())
                                          if k != "dream"]:
        g = chain_graph(cut(extra), image)
        taps = [(len(keep), "o")] if extra else [(head, "o")]
        ex.run(g, taps)  # its capture
        busy[what] = profiled(lambda: synchronized_ms(lambda: ex.run(
            g, taps)), f"{tag} profile of one replay, the chain"
            + (f" and {what}" if extra else ""))[1]
    if whole_ms is None or None in busy.values():
        return {k: None for k in list(busy) + ["dream"]}
    out = {k: (v if k == "chain" else v - busy["chain"])
           for k, v in busy.items()}
    out["dream"] = whole_ms - sum(out.values())
    return out


def saliency_modes_check(app, url, obj, images, tag, captured):
    """On the vit_t16 bf16 server: saliency in ``mode=smooth`` (its sigma
    and seed scrubbed: a cache hit, no capture, new values), ``mode=ig``
    and Grad-CAM wrt block 3 (token-shaped g, the patch-grid render) once
    each, on the chain and one saliency node; then one ``run_stacked``
    group of two requests on distinct classes, each row its own run's bit
    for bit."""
    from interactive_vit_tpu_torch.graph.ir import Graph
    from interactive_vit_tpu_torch.wire.codec import Response

    ex = app.executor
    names = [n["instance"].get("endpoint") for n in obj["nodes"]]
    chain = [i for i, nm in enumerate(names)
             if nm and nm.startswith("vit_t16:") and not nm.endswith(
                 ":attrib")]

    def graph(params, image):
        g = Graph()
        nodes = [g.add_node(names[i]) for i in chain]
        for a, b in zip(nodes, nodes[1:]):
            g.connect(a, "o", b, "o")
        s = g.add_node("saliency", params)
        g.connect(nodes[-1], "o", s, "o")
        g.add_input(image, nodes[0], "o")
        return g, s.index

    def ask(params, image=images[0]):
        g, s = graph(params, image)
        out = Response.decode(post(url + "/compute",
                                   graph_request(g, [(s, "o"), (s, "g")])))
        return out[s], ex.last_stats.cache_hit

    smooth = {"target": "max", "mode": "smooth", "steps": "4",
              "sigma": "0.15", "seed": "0"}
    a, _ = ask(smooth)
    n_cap = len(captured)
    b, hit = ask({**smooth, "sigma": "0.3", "seed": "7"})
    if not hit or len(captured) != n_cap or np.array_equal(a["g"], b["g"]):
        raise AssertionError(f"{tag}: smooth's sigma / seed scrub: cache "
                             f"hit {hit}, captures {len(captured) - n_cap}")
    ig, _ = ask({"target": "class", "class": "3", "mode": "ig",
                 "steps": "4"})
    cam, _ = ask({"target": "max", "mode": "gradxinput", "wrt": "node:5"})
    for what, out, shape in (("smooth", a, (3, 224, 224)),
                             ("ig", ig, (3, 224, 224)),
                             ("Grad-CAM", cam, (1, 197, 192))):
        if (out["g"].shape != shape or not np.isfinite(out["g"]).all()
                or not np.abs(out["g"]).max() > 0):
            raise AssertionError(f"{tag} {what}: g {out['g'].shape}")
    if cam["o"].shape != (1, 3, 14, 14):
        raise AssertionError(f"{tag} Grad-CAM: o {cam['o'].shape}")
    pair = [graph({"target": "class", "class": c, "mode": "grad"}, im)
            for c, im in (("1", images[0]), ("7", images[1]))]
    s = pair[0][1]
    group = ex.run_stacked([g for g, _ in pair], [(s, "g")])
    for j, ((g, _), row) in enumerate(zip(pair, group)):
        single = ex.run(g, [(s, "g")])[s]["g"]
        if not np.array_equal(row[s]["g"], single):
            raise AssertionError(
                f"{tag} stacked: row {j} is "
                f"{float(np.abs(row[s]['g'] - single).max())} from its own "
                f"run")
    if np.array_equal(group[0][s]["g"], group[1][s]["g"]):
        raise AssertionError(f"{tag}: the stacked rows are equal")
    log(f"  {tag} extras: saliency smooth (4 samples; sigma and seed "
        f"scrubbed: a cache hit, no capture, new values), ig (4 steps), "
        f"Grad-CAM wrt block 3 (g [1, 197, 192], o [1, 3, 14, 14]); one "
        f"run_stacked group of classes 1 and 7 on two images: each row "
        f"its own run bit for bit")


def flatten_tensors(tree):
    """The tensors of a nest of lists and tuples."""
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in flatten_tensors(v)]
    return []


def run_path(path, device, graphs_dir, counters) -> dict:
    """One path: warm-up, then with every launch count at 0, ``seq``
    requests in sequence, ``conc`` at once, one group of max(2, ``conc``)
    requests through ``executor.run_stacked`` (one batched pass), and one
    request to ``path.other``; then (``path.f32``) one f32 request on a
    fresh f32 server; the counts are read after it. Returns the counts and
    the p50."""
    rng = np.random.default_rng(0)
    shape = path.img if isinstance(path.img, tuple) else (path.img, path.img)
    k_group = max(2, path.conc)
    images = [rng.random((3, *shape), dtype=np.float32)
              for _ in range(max(path.seq + path.conc, k_group))]
    import gc

    import torch

    opath = path.other
    variants = [path.model] + ([opath.model] if opath else [])
    tag = f"{path.model} {path.dtype}"
    # the earlier paths' servers and their capture pools go first, so that
    # memory_reserved below is this path's
    gc.collect()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved() / 2 ** 30
    app, httpd, url = serve(variants, path.dtype, device, graphs_dir,
                            path.attn)
    try:
        from interactive_vit_tpu_torch.graph.executor import Executor

        # the path's requests replay captured programs; the same requests
        # through the eager pass are their reference (compiled_path_check)
        eager = Executor(app.reg, use_jit=False, device=device)
        captured = watch_captures(app.executor)
        graph = app.graphs.load(path.model + ".json")
        model = app.reg.get_node(path.model + ":"
                                 + path.names[path.head_node - path.offset]
                                 ).model
        bodies = [chain_request(graph, im, path.taps(), path.node_params)
                  for im in images[:path.seq + path.conc]]
        other_raw = None
        if opath:
            other_image = images[0][:, :opath.img, :opath.img]
            other_body = chain_request(app.graphs.load(opath.model + ".json"),
                                       other_image, opath.taps())
            other_model = app.reg.get_node(opath.model + ":head").model
        post(url + "/compute", bodies[0])  # the capture of its program
        sizes = []  # the sizes of the groups the batcher dispatches
        app.batcher.on_dispatch = lambda g, taps, b, n: sizes.append(n)
        # the images of each group the batcher runs as one pass
        grouped, run_stacked = [], app.executor.run_stacked

        def recorded(graphs, *args, **kw):
            grouped.append([next(iter(g.input_edges()))[2].tensor
                            for g in graphs])
            return run_stacked(graphs, *args, **kw)

        app.executor.run_stacked = recorded

        for fn in counters.values():  # the path starts here
            fn.launches = 0
        batches0 = app.metrics.counters.get("batches", 0)
        lat, raws = [], []
        n_cap = len(captured)
        for body in bodies[:path.seq]:
            t0 = time.perf_counter()
            raws.append(post(url + "/compute", body))
            lat.append(time.perf_counter() - t0)
        if len(captured) != n_cap:
            raise AssertionError(f"{tag}: a sequential request captured "
                                 f"again: every one must replay")
        per_request = {k: fn.launches / path.seq for k, fn in counters.items()}
        conc = [None] * path.conc

        def worker(k):
            conc[k] = post(url + "/compute", bodies[path.seq + k])

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(path.conc)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads) or None in conc:
            raise AssertionError("concurrent requests did not complete")
        # concurrent requests may share a batch, and a batch runs each
        # block once for all its requests
        batches = app.metrics.counters.get("batches", 0) - batches0
        app.executor.run_stacked = run_stacked
        # one group through run_stacked: each kernel launches once for it
        before = {k: fn.launches for k, fn in counters.items()}
        group = app.executor.run_stacked(
            [chain_graph(graph, im, path.node_params)
             for im in images[:k_group]], path.taps())
        group_launches = {k: fn.launches - before[k]
                          for k, fn in counters.items()}
        if opath:
            other_raw = post(url + "/compute", other_body)
        counts = {k: fn.launches for k, fn in counters.items()}
        metrics = json.loads(urllib.request.urlopen(
            url + "/metrics", timeout=30).read())
        prof_graph = chain_graph(graph, images[0], path.node_params)
        prof = {what: profile_request(ex, prof_graph, path.taps(), tag,
                                      path.profile_kernels, what)
                for what, ex in (("replay", app.executor),
                                 ("eager, use_jit=False", eager))}
        if opath and opath.profile_kernels:
            profile_request(app.executor, chain_graph(app.graphs.load(
                opath.model + ".json"), other_image), opath.taps(),
                f"{opath.model} {path.dtype}", opath.profile_kernels)
        if path.host_spans:
            time_host_spans(eager, chain_graph(graph, images[0],
                                               path.node_params),
                            path.taps(), tag, path.host_spans)
        notes, walls = compiled_path_check(app, eager, path, graph, images,
                                           tag, captured, counters)
        if path.extras:
            path.extras(app, eager, path, graph, images, captured,
                        prof["replay"][1])
        reserved = torch.cuda.memory_reserved() / 2 ** 30 - reserved0
        (rw, rb), (ew, eb) = prof.values()
        COMPILED.append((tag, walls["replay"], walls["eager"], rw, rb, ew,
                         eb, [s for _, s in captured], reserved))
        log(f"  {tag} compiled path: replay vs eager pass: "
            + "; ".join(notes) + f"; wall (median of 3, synchronized) "
            f"replay {walls['replay']:.2f} ms, eager {walls['eager']:.2f} "
            f"ms; captures (bucket, ms) "
            f"{[(k, round(t * 1e3, 1)) for k, t in captured]}; "
            f"memory_reserved {reserved:.2f} GiB above the path's start "
            f"(the models, the allocator's cache, the capture pool), "
            f"{app.executor.cache_info()}")
    finally:
        stop(app, httpd)

    served = path.seq + path.conc
    expected = {k: path.kernels.get(k, 0) for k in counters}
    if per_request != expected:
        raise AssertionError(f"a sequential {tag} request launched "
                             f"{per_request}; expected {expected}")
    if group_launches != expected:
        raise AssertionError(f"a group of {k_group} {tag} requests through "
                             f"run_stacked launched {group_launches}; "
                             f"expected one pass, {expected}")
    # each pass (a request alone, a group) launches each kernel once
    want = {k: n * (batches + 1) + (opath.kernels.get(k, 0) if opath else 0)
            for k, n in expected.items()}
    if batches < path.seq or counts != want:
        raise AssertionError(f"{counts} launches for {served} {tag} requests "
                             f"in {batches} batches and a group of "
                             f"{k_group}; expected {want}")
    # each response's reference is the reference path run on the pass
    # that produced it: the image alone, or its group as one batch (the
    # batch changes the library GEMMs' bits, and ToMe's matching decisions
    # are discrete)
    passes = {k: (k,) for k in range(served)}
    for arrays in grouped:
        ks = tuple(next(k for k in range(served)
                        if np.array_equal(a, images[k])) for a in arrays)
        passes.update({k: ks for k in ks})
    reference = path.lockstep or plain_taps
    refs = {}

    def ref(ks, j):
        # a group ran padded to its power-of-two bucket with copies of its
        # first image: the reference runs the same batch
        padded = ks + ks[:1] * ((1 << (len(ks) - 1).bit_length()) - len(ks))
        if ks not in refs:
            head, maps = reference(path, model, np.stack(
                [images[k] for k in padded]) if len(ks) > 1
                else images[ks[0]], device)
            # a group's reference is one batch: each result is its row,
            # with a batch axis of 1 where the responses keep one (an
            # unbatched request to VGG16 keeps none)
            batched = len(ks) == 1 or head.ndim == len(path.head_shape)
            refs[ks] = [(head, maps)] if len(ks) == 1 else [
                (head[i:i + 1] if batched else head[i],
                 {n: {ch: t[i:i + 1] if batched else t[i]
                      for ch, t in chs.items()} for n, chs in maps.items()})
                for i in range(len(ks))]
        return refs[ks][j]

    worst, worst_use, scales = {}, {}, {}
    labelled = ([(f"request {k} (a pass of {len(passes[k])})", raw,
                  passes[k], passes[k].index(k))
                 for k, raw in enumerate(raws + conc)]
                + [(f"group of {k_group}, result {k}", res,
                    tuple(range(k_group)), k)
                   for k, res in enumerate(group)])
    for label, raw, ks, j in labelled:
        errs, uses, scales = check_response(raw, path, ref(ks, j),
                                            f"{tag} {label}",
                                            bf16=path.dtype != "float32",
                                            rel=path.f32_rel)
        for key, v in errs.items():
            worst[key] = max(worst.get(key, 0.0), v)
            worst_use[key] = max(worst_use.get(key, 0.0), uses[key])
    p50 = float(np.median(lat)) * 1e3
    log(f"  {tag}: {path.seq} sequential + {path.conc} concurrent "
        f"requests{' + 1 ' + opath.model if opath else ''} in {batches} "
        f"{path.model} batches (sizes {sizes}) and a group of {k_group} "
        f"through run_stacked; launches a sequential request "
        f"{ {k: v for k, v in per_request.items() if v} }, the group "
        f"{ {k: v for k, v in group_launches.items() if v} }, all "
        f"{ {k: v for k, v in counts.items() if v} } (= "
        f"{ {k: v for k, v in want.items() if v} }); p50 latency per "
        f"request {p50:.2f} ms (client wall, sequential)")
    log("  server p50s (ms, all requests): " + ", ".join(
        f"{k.removesuffix('_p50_ms')} {metrics[k]:.2f}" for k in (
            "wire_p50_ms", "decode_p50_ms", "queue_p50_ms",
            "compute_p50_ms", "encode_p50_ms", "request_p50_ms"))
        + f"; mean batch {metrics['mean_batch_size']:.2f}")
    log(f"  {tag} vs plain path, worst max abs err over the responses and "
        f"the group's results (share of its bound): "
        + ", ".join(f"{k}={v:.3g} ({worst_use[k]:.2f})"
                    for k, v in sorted(worst.items())))
    for (vtag, node), err in VIEW_VS_PLAIN.items():
        if vtag == tag:
            log(f"  {tag} node {node} ({path.views[node][1]}): held to the "
                f"kind on the host from the response's "
                f"{path.views[node][0]} output (bound {VIEW_BOUND:g}); its "
                f"largest distance from the plain path's view {err:.3g}")
    if path.f32_rel:
        # against the North star's 1e-4 absolute: each output's error
        # beside its scale
        log(f"  {tag}: max abs err against 1e-4 absolute, and each "
            f"output's largest plain value: " + ", ".join(
                f"{k} {worst[k]:.3g} ("
                f"{'within' if worst[k] <= F32_BOUND else 'above'} 1e-4; "
                f"scale {scales[k]:.4g})" for k in sorted(worst)))
    if opath:
        errs, _, _ = check_response(other_raw, opath,
                                 (opath.lockstep or plain_taps)(
                                     opath, other_model, other_image, device),
                                 f"{opath.model} request")
        log(f"  {opath.model} head output vs plain {errs['head']:.3g}")
    if not path.f32:
        return {"launches": counts, "p50_ms": p50}

    # one f32 request: the output must match the plain path at 1e-4
    app, httpd, url = serve([path.model], "float32", device, graphs_dir,
                            path.attn)
    try:
        before = {k: fn.launches for k, fn in counters.items()}
        raw = post(url + "/compute", bodies[0])
        launches_f32 = {k: fn.launches - before[k]
                        for k, fn in counters.items()}
        counts = {k: counts[k] + launches_f32[k] for k in counters}
        model = app.reg.get_node(path.model + ":"
                                 + path.names[path.head_node - path.offset]
                                 ).model
    finally:
        stop(app, httpd)
    want32 = {k: path.f32_kernels.get(k, 0)
              for k in set(path.kernels) | set(path.f32_kernels)}
    if {k: launches_f32[k] for k in want32} != want32:
        raise AssertionError(f"f32 {path.model} request launched "
                             f"{launches_f32}; expected {want32}")
    if path.lockstep:
        path.lockstep(path, model, images[0], device)
    errs32, _, _ = check_response(raw, path,
                               plain_taps(path, model, images[0], device),
                               f"{path.model} f32 request", bf16=False)
    log(f"  {path.model} f32: 1 request, launches {path.f32_kernels}; head output "
        f"max abs err vs plain {errs32['head']:.3g} (bound {F32_BOUND:g}), "
        f"taps {max(v for k, v in errs32.items() if k != 'head'):.3g}; path "
        f"launch counts { {k: v for k, v in counts.items() if v} }")
    return {"launches": counts, "p50_ms": p50}


def check_debug_routes(url, body, n_nodes) -> None:
    """The app's debug routes on the card, with a vit_b16 bf16 request:
    ``POST /profile`` must report device time with row 1's three
    tensor-core kernels among the top kernels, 12 launches each a run;
    ``POST /debug_eval`` a time and output shapes for every node, and no
    error."""
    rep = json.loads(post(url + "/profile?iters=2&top=40", body))
    seen = {part: [name for name in rep["top_ops_us"] if part in name]
            for part in ("row1_qkv_mma_kernel", "row1_attn_mma_kernel",
                         "proj_mma_kernel")}
    if rep["iters"] != 2 or not rep["total_device_us"] > 0 or not all(
            seen.values()):
        raise AssertionError(f"POST /profile: {rep}")
    dbg = json.loads(post(url + "/debug_eval", body))
    if dbg["errors"] or len(dbg["timings_ms"]) != n_nodes:
        raise AssertionError(f"POST /debug_eval: {dbg}")
    log(f"  POST /profile (2 runs): wall {rep['wall_ms']:.2f} ms, device "
        f"{rep['total_device_us'] / 1e3:.3f} ms, row 1's kernels "
        + ", ".join(f"{names[0][:40]} {rep['top_ops_us'][names[0]]:.1f} us"
                    for names in seen.values())
        + f"; POST /debug_eval: {n_nodes} nodes, "
        f"{sum(dbg['timings_ms'].values()):.2f} ms in all, the slowest "
        f"node {max(dbg['timings_ms'], key=dbg['timings_ms'].get)} "
        f"{max(dbg['timings_ms'].values()):.3f} ms")


def throughput_probe(device, graphs_dir, taps, clients=8, per_client=8,
                     sequential=6) -> dict:
    """Micro-batched serving (BASELINE config 5): vit_b16 bf16 with
    ``taps``, ``clients`` closed-loop clients (each posts its next request
    when its last one returns) of ``per_client`` requests, on one server
    whose batcher's ``max_batch`` (``--max-batch``) is 1, 8, 8 and 1 in
    turn (two turns of each, within one run, so that the card's clocks
    treat both alike). Each turn first posts ``sequential`` requests one
    at a time (the concurrency-1 p50), then one request per client at once
    (warming the group's sizes), then the timed load. Logs requests/s, the
    batch sizes the responses report, the client p50 and the server's
    compute p50, whole and a request's share (compute over batch), and
    returns them by max batch. Then ``check_debug_routes`` on that
    server."""
    rng = np.random.default_rng(1)
    images = [rng.random((3, 224, 224), dtype=np.float32)
              for _ in range(clients)]
    out = {}
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved() / 2 ** 30
    app, httpd, url = serve(["vit_b16"], "bfloat16", device, graphs_dir)
    try:
        graph = app.graphs.load("vit_b16.json")
        bodies = [chain_request(graph, im, taps) for im in images]
        # the programs of a request alone and of the buckets 2, 4 and 8,
        # captured before the load, as the server's --warmup does for 1
        # and --max-batch
        captured = watch_captures(app.executor)
        for batch in (None, 2, 4, 8):
            app.executor.precompile(chain_graph(graph, images[0]), taps,
                                    batch=batch)
        log(f"  throughput probe: programs captured before the load "
            f"(bucket, ms) {[(k, round(t * 1e3, 1)) for k, t in captured]};"
            f" memory_reserved {torch.cuda.memory_reserved() / 2 ** 30:.2f} "
            f"GiB ({torch.cuda.memory_reserved() / 2 ** 30 - reserved0:.2f} "
            f"above the probe's start)")
        for max_batch in (1, 8, 8, 1):
            app.batcher.max_batch = max_batch
            seq = []
            for k in range(sequential):
                t0 = time.perf_counter()
                post(url + "/compute", bodies[k % clients])
                seq.append(time.perf_counter() - t0)
            walls, timings = [], []

            def client(c, n, record):
                for _ in range(n):
                    t0 = time.perf_counter()
                    _, timing = post_timed(url + "/compute", bodies[c])
                    if record:
                        walls.append(time.perf_counter() - t0)
                        timings.append(timing)

            for n, record in ((1, False), (per_client, True)):
                threads = [threading.Thread(target=client,
                                            args=(c, n, record))
                           for c in range(clients)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                elapsed = time.perf_counter() - t0
                if any(t.is_alive() for t in threads):
                    raise AssertionError("throughput clients did not finish")
            if len(walls) != clients * per_client:
                raise AssertionError(f"{len(walls)} of {clients * per_client}"
                                     f" throughput requests answered")
            batch = [int(t["batch"]) for t in timings]
            res = {
                "requests_per_s": len(walls) / elapsed,
                "client_p50_ms": float(np.median(walls)) * 1e3,
                "compute_p50_ms": float(np.median([t["compute"]
                                                   for t in timings])),
                "compute_share_p50_ms": float(np.median(
                    [t["compute"] / t["batch"] for t in timings])),
                "sequential_p50_ms": float(np.median(seq)) * 1e3,
                "batches": {b: batch.count(b) for b in sorted(set(batch))},
            }
            out.setdefault(max_batch, []).append(res)
            log(f"  throughput vit_b16 bf16, --max-batch {max_batch}, "
                f"{clients} closed-loop clients x {per_client}: "
                f"{res['requests_per_s']:.2f} requests/s; client p50 "
                f"{res['client_p50_ms']:.2f} ms; compute p50 "
                f"{res['compute_p50_ms']:.2f} ms, a request's share "
                f"{res['compute_share_p50_ms']:.2f} ms; requests by the "
                f"batch they ran in {res['batches']}; sequential p50 "
                f"{res['sequential_p50_ms']:.2f} ms")
        check_debug_routes(url, bodies[0], len(graph["nodes"]))
    finally:
        stop(app, httpd)
    r1 = [r["requests_per_s"] for r in out[1]]
    r8 = [r["requests_per_s"] for r in out[8]]
    log(f"  throughput vit_b16 bf16: --max-batch 8 {r8} requests/s against "
        f"--max-batch 1 {r1}: {np.mean(r8) / np.mean(r1):.2f}x")
    return out


def run_forwards(device, counters) -> dict:
    """The monolithic forwards with the fused MLP kernel: ``vit.forward``
    at vit_b16 width (block kernel + MLP kernel) and ``swin.forward`` at
    swin_t width (window kernel + one MLP kernel per stage), bf16, B=1 and
    B=8, and f32 at B=1, seeded random weights, against the same forwards
    with the kernels' plain versions: bf16 12 ``fused_mlp_block_mma``
    launches a forward (swin_t's stages 0 and 1 on its chunks of 96) and
    no FMA one, f32 12 ``fused_mlp_block_tf32x3`` beside row 1's or row
    5's split-TF32 route, the f32 logits within 1e-4 of their scale of the
    plain forward's. Then four ``vit.forward`` of vit_h14 (heads
    80 wide, depth cut to 2) with ``--attn auto``, one launch a block: f32
    on the split-TF32 kernels' 80-wide instantiations, bf16 on the bf16
    tensor-core kernels'; the row-resident kernel at 224 (N=257) against
    its plain version, the online one at 742 (N=2810) against the plain
    online attention, the logits within 1e-4 (f32) or 2^-4 (bf16) of their
    scale; no FMA flash kernel runs. Last, vit_h14@742 at full depth (32
    blocks) in f32 and in bf16: 32 launches of the online kernel's
    80-wide split-TF32 or bf16 tensor-core instantiation, the logits
    within 1e-4 or 2^-4 of their scale. Every launch count is set to 0
    before the checked forwards, and the MLP kernels' counts (12 a call,
    all on the tensor cores) and the FMA flash kernels' (none) are read
    and returned straight after them; the forwards timed afterwards do not
    enter them: each full-depth forward's wall time and one profiled
    forward (the attention's device time), and one profiled swin_t forward
    at B=1 in each dtype (the MLP kernels by name)."""
    import dataclasses

    import torch

    from interactive_vit_tpu_torch.models import swin, vit
    from interactive_vit_tpu_torch.ops import dispatch
    from interactive_vit_tpu_torch.ops import fused_block as fb
    from interactive_vit_tpu_torch.ops import fused_mlp as fm
    from interactive_vit_tpu_torch.ops import fused_window as fw

    vcfg, scfg = vit.resolve_variant("vit_b16"), swin.VARIANTS["swin_t"]
    stages = range(len(scfg.depths))
    params = {(name, dtype): init(cfg, torch.Generator().manual_seed(0),
                                  dtype, device)
              for name, init, cfg in (("vit_b16", vit.init_params, vcfg),
                                      ("swin_t", swin.init_params, scfg))
              for dtype in (torch.bfloat16, torch.float32)}

    def kernel_kwargs(dtype):
        return {
            "vit_b16": {
                "block_impl": dispatch.default_block_impl(
                    "auto", dtype, vcfg.tokens, vcfg.width, vcfg.heads,
                    device),
                "mlp_impl": dispatch.default_mlp_impl(
                    "fused", dtype, vcfg.width, vcfg.mlp_dim,
                    device=device)},
            "swin_t": {
                "window_impl": dispatch.default_window_impl(
                    "auto", dtype, scfg, device),
                "mlp_impls": [dispatch.default_mlp_impl(
                    "fused", dtype, scfg.stage_dim(s),
                    scfg.stage_dim(s) * scfg.mlp_ratio, device=device)
                    for s in stages]},
        }

    kernel_kw = {dtype: kernel_kwargs(dtype)
                 for dtype in (torch.bfloat16, torch.float32)}
    plain_kw = {
        "vit_b16": {"block_impl": fb.fused_attn_block_reference,
                    "mlp_impl": fm.fused_mlp_block_reference},
        "swin_t": {"window_impl": fw.fused_window_attn_reference,
                   "mlp_impls": [fm.fused_mlp_block_reference for _ in stages]},
    }
    if any(kw["vit_b16"]["block_impl"] is not fb.fused_attn_block
           or kw["swin_t"]["window_impl"] is not fw.fused_window_attn
           for kw in kernel_kw.values()):
        raise AssertionError("dispatch did not pick the kernels on the card")
    forwards = {"vit_b16": (vit.forward, vcfg), "swin_t": (swin.forward, scfg)}
    # every forward's launches: the block or window kernel's tensor-core
    # route in each of 12 blocks, and the MLP's (bf16: all of swin_t's
    # stages too, 0 and 1 on chunks of 96; never the FMA kernel)
    expected = {
        ("vit_b16", torch.bfloat16): {"fused_attn_block_mma": 12,
                                      "fused_mlp_block_mma": 12},
        ("swin_t", torch.bfloat16): {"fused_window_attn_mma": 12,
                                     "fused_mlp_block_mma": 12},
        ("vit_b16", torch.float32): {"fused_attn_block_tf32x3": 12,
                                     "fused_mlp_block_tf32x3": 12},
        ("swin_t", torch.float32): {"fused_window_attn_tf32x3": 12,
                                    "fused_mlp_block_tf32x3": 12},
    }
    mlp_names = ("fused_mlp_block", "fused_mlp_block_mma",
                 "fused_mlp_block_tf32x3")

    def wall_ms(fn, iters=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    images = {b: torch.rand((b, 3, vcfg.img_size, vcfg.img_size),
                            generator=torch.Generator().manual_seed(b)
                            ).to(device) for b in (1, 8)}
    if scfg.img_size != vcfg.img_size:
        raise AssertionError("vit_b16 and swin_t take one image size here")
    # bf16 at B=1 and 8 (logits and maps within 2^-4 of their scale), f32
    # at B=1 (logits within 1e-4 of their scale)
    cases = [(name, b, dtype) for dtype, batches in
             ((torch.bfloat16, (1, 8)), (torch.float32, (1,)))
             for name in forwards for b in batches]
    for fn in counters.values():  # the path starts here
        fn.launches = 0
    lines = {}
    with torch.inference_mode():
        for name, b, dtype in cases:
            forward, cfg = forwards[name]
            dt = str(dtype).replace("torch.", "")
            f32 = dtype == torch.float32
            want = expected[name, dtype]
            before = {k: f.launches for k, f in counters.items()}
            got = forward(params[name, dtype], images[b], cfg,
                          want_attn=not f32, **kernel_kw[dtype][name])
            torch.cuda.synchronize()
            delta = {k: f.launches - before[k]
                     for k, f in counters.items() if f.launches > before[k]}
            if delta.get("fused_mlp_block", 0):
                raise AssertionError(f"{name} forward B={b} {dt} launched "
                                     f"the FMA MLP kernel "
                                     f"{delta['fused_mlp_block']} times")
            if delta != want:
                raise AssertionError(f"{name} forward B={b} {dt} launched "
                                     f"{delta}; expected {want}")
            ref = forward(params[name, dtype], images[b], cfg,
                          want_attn=not f32, **plain_kw[name])
            logits, rlogits = got["logits"].float(), ref["logits"].float()
            if (logits.shape != (b, cfg.num_classes)
                    or not torch.isfinite(logits).all()):
                raise AssertionError(f"{name} forward B={b} {dt}: logits "
                                     f"{tuple(logits.shape)} or non-finite")
            rel = F32_BOUND if f32 else SLICE_REL
            bound = rel * max(1.0, rlogits.abs().max().item())
            err = (logits - rlogits).abs().max().item()
            map_use = 0.0 if f32 else max(
                ((g.float() - r.float()).abs().max()
                 / (SLICE_REL * r.float().abs().max())).item()
                for g, r in zip(got["attn"], ref["attn"]))
            if err > bound or map_use > 1.0:
                raise AssertionError(
                    f"{name} forward B={b} {dt}: logits {err:.3g} (bound "
                    f"{bound:.3g}), maps {map_use:.2f} of their bound")
            lines[name, b, dtype] = (
                f"  {name} forward B={b} {dt}, the block or window kernel + "
                f"the MLP kernels: launches {delta} (the FMA MLP kernel "
                f"none); logits max abs err vs the plain versions "
                f"{err:.3g} (bound {bound:.3g})"
                + ("" if f32 else f", maps {map_use:.2f} of their bound"))
        # heads 80 wide: f32 on the split-TF32 kernels' 80-wide
        # instantiations, bf16 on the tensor-core kernels'; row-resident
        # at 224 (N=257), online above ROWFULL_MAX_N at 742
        for variant, dtype_h, kernel, plain, what in (
                ("vit_h14", torch.float32, "flash_attention_tf32x3",
                 rowfull_plain, "the plain row-resident attention"),
                ("vit_h14@742", torch.float32,
                 "flash_attention_online_tf32x3", online_plain,
                 "the plain online attention"),
                ("vit_h14", torch.bfloat16, "flash_attention_mma",
                 rowfull_plain, "the plain row-resident attention"),
                ("vit_h14@742", torch.bfloat16, "flash_attention_online_mma",
                 online_plain, "the plain online attention")):
            dt = str(dtype_h).replace("torch.", "")
            hcfg = dataclasses.replace(vit.resolve_variant(variant), depth=2)
            hparams = vit.init_params(hcfg, torch.Generator().manual_seed(0),
                                      dtype_h, device)
            himg = torch.rand((1, 3, hcfg.img_size, hcfg.img_size),
                              generator=torch.Generator().manual_seed(1)
                              ).to(device)
            before = {k: f.launches for k, f in counters.items()}
            got = vit.forward(hparams, himg, hcfg,
                              attn_impl=dispatch.default_attn_impl("auto"))
            torch.cuda.synchronize()
            delta = {k: f.launches - before[k]
                     for k, f in counters.items() if f.launches > before[k]}
            if delta != {kernel: hcfg.depth}:
                raise AssertionError(f"{variant} {dt} forward launched "
                                     f"{delta}; expected {hcfg.depth} "
                                     f"{kernel}")
            ref = vit.forward(hparams, himg, hcfg, attn_impl=plain)
            logits, rlogits = got["logits"].float(), ref["logits"].float()
            rel = F32_BOUND if dtype_h == torch.float32 else SLICE_REL
            bound = rel * max(1.0, rlogits.abs().max().item())
            err = (logits - rlogits).abs().max().item()
            if (logits.shape != (1, hcfg.num_classes)
                    or not torch.isfinite(logits).all() or err > bound):
                raise AssertionError(f"{variant} {dt} forward: logits "
                                     f"{tuple(logits.shape)}, max abs err "
                                     f"{err:.3g} (bound {bound:.3g})")
            log(f"  {variant} (depth 2) forward B=1 {dt}, N={hcfg.tokens}, "
                f"dh={hcfg.width // hcfg.heads}: launches {delta}; logits "
                f"max abs err vs {what} {err:.3g} (bound {bound:.3g})")
        # vit_h14@742 at full depth (32 blocks), f32 and bf16: the online
        # kernel's 80-wide split-TF32 or bf16 tensor-core instantiation in
        # every block, the logits within 1e-4 or 2^-4 of their scale of the
        # plain online attention's
        hcfg = vit.resolve_variant("vit_h14@742")
        himg = torch.rand((1, 3, hcfg.img_size, hcfg.img_size),
                          generator=torch.Generator().manual_seed(1)
                          ).to(device)
        auto = dispatch.default_attn_impl("auto")
        full = {}
        for dtype_h, kernel, kernel_name, rel in (
                (torch.float32, "flash_attention_online_tf32x3",
                 "online_tf32_kernel", F32_BOUND),
                (torch.bfloat16, "flash_attention_online_mma",
                 "online_mma_kernel", SLICE_REL)):
            dt = str(dtype_h).replace("torch.", "")
            hparams = vit.init_params(hcfg, torch.Generator().manual_seed(0),
                                      dtype_h, device)
            before = {k: f.launches for k, f in counters.items()}
            got = vit.forward(hparams, himg, hcfg, attn_impl=auto)
            torch.cuda.synchronize()
            delta = {k: f.launches - before[k]
                     for k, f in counters.items() if f.launches > before[k]}
            if delta != {kernel: hcfg.depth}:
                raise AssertionError(f"vit_h14@742 {dt} forward launched "
                                     f"{delta}; expected {hcfg.depth} "
                                     f"{kernel}")
            rlogits = vit.forward(hparams, himg, hcfg,
                                  attn_impl=online_plain)["logits"].float()
            logits = got["logits"].float()
            bound = rel * max(1.0, rlogits.abs().max().item())
            err = (logits - rlogits).abs().max().item()
            if (logits.shape != (1, hcfg.num_classes)
                    or not torch.isfinite(logits).all() or err > bound):
                raise AssertionError(f"vit_h14@742 {dt} forward (depth "
                                     f"{hcfg.depth}): logits "
                                     f"{tuple(logits.shape)}, max abs err "
                                     f"{err:.3g} (bound {bound:.3g})")
            full[dt] = (hparams, kernel_name, (
                f"  vit_h14@742 (full depth, {hcfg.depth} blocks) forward "
                f"B=1 {dt}: launches {delta}; logits max abs err vs the "
                f"plain online attention {err:.3g} (bound {bound:.3g})"))
        # the path ends here: the counts are read before the timed forwards
        mlp_counts = {k: counters[k].launches for k in mlp_names}
        rowfull = counters["flash_attention"].launches
        online = counters["flash_attention_online"].launches
        for dt, (hparams, kernel_name, full_line) in full.items():
            t_full = wall_ms(lambda: vit.forward(hparams, himg, hcfg,
                                                 attn_impl=auto), iters=2)
            log(full_line + f"; {t_full:.2f} ms a forward (host wall, "
                f"synchronized)")
            profiled(lambda: synchronized_ms(lambda: vit.forward(
                hparams, himg, hcfg, attn_impl=auto)),
                f"vit_h14@742 {dt} full-depth forward profile",
                {kernel_name: hcfg.depth, "online_attention_kernel": 0})
        del full, hparams
        want = {k: sum(expected[name, dtype].get(k, 0)
                       for name, _, dtype in cases) for k in mlp_names}
        if mlp_counts != want:
            raise AssertionError(f"the MLP kernels launched {mlp_counts} "
                                 f"times in {len(cases)} forwards; expected "
                                 f"{want}")
        if rowfull or online:
            raise AssertionError(f"the FMA flash kernels launched {rowfull} "
                                 f"and {online} times on the path")
        for name, b, dtype in cases:
            forward, cfg = forwards[name]
            p = params[name, dtype]
            t_k = wall_ms(lambda: forward(p, images[b], cfg,
                                          **kernel_kw[dtype][name]))
            t_p = wall_ms(lambda: forward(p, images[b], cfg,
                                          **plain_kw[name]))
            log(lines[name, b, dtype] + f"; maps off: kernels {t_k:.2f} ms, "
                f"plain versions {t_p:.2f} ms (host wall, synchronized)")
        # one swin_t forward at B=1 in each dtype under the profiler: the
        # MLP kernels by name (bf16: 4 blocks of stages 0-1 on chunks of
        # 96, 8 on 128; f32: 12 split-TF32) and the FMA one never
        for dtype, mlp_profile in (
                (torch.bfloat16, {"mlp_mma96_kernel": 4,
                                  "mlp_mma_kernel": 8,
                                  "window_attn_mma_kernel": 12}),
                (torch.float32, {"mlp_tf32_kernel": 12,
                                 "window_attn_tf32_kernel": 12})):
            p = params["swin_t", dtype]
            profiled(lambda: synchronized_ms(lambda: swin.forward(
                p, images[1], scfg, **kernel_kw[dtype]["swin_t"])),
                f"swin_t {str(dtype)[6:]} B=1 forward profile",
                {**mlp_profile, "::mlp_kernel": 0})
    return {**mlp_counts, "flash_attention": rowfull,
            "flash_attention_online": online}


class ToMeCount:
    """The block kernel's launches in ToMe's mode (with ``key_bias`` or
    ``want_metric``) as one ``launches`` counter."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self) -> int:
        return self.fn.tome_launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.fn.tome_launches = value


class NarrowCount:
    """The W8A8 tensor-core kernel's launches at chunks of 96 columns
    (``w8a8_mma96_kernel``) as one ``launches`` counter."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self) -> int:
        return self.fn.narrow_launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.fn.narrow_launches = value


class FwdBwdCount:
    """The forward and backward launch counts of a trainable attention's
    route (``prefix`` "" for FMA, "mma_" for the bf16 tensor cores, "tf32_"
    for split TF32) as one ``launches`` counter: reading sums them, setting
    sets both."""

    def __init__(self, fn, prefix=""):
        self.fn, self.prefix = fn, prefix

    @property
    def pair(self):
        return (getattr(self.fn, self.prefix + "fwd_launches"),
                getattr(self.fn, self.prefix + "bwd_launches"))

    @property
    def launches(self) -> int:
        return sum(self.pair)

    @launches.setter
    def launches(self, value: int) -> None:
        setattr(self.fn, self.prefix + "fwd_launches", value)
        setattr(self.fn, self.prefix + "bwd_launches", value)


def train_bound(ref, dtype):
    """(bound of each element of a trainable-attention output or gradient
    against the plain ``ref``; its description)."""
    import torch

    scale = ref.float().abs().max().item()
    if dtype == torch.float32:
        return TRAIN_F32_REL * scale, f"{TRAIN_F32_REL * scale:.3g}"
    return (TRAIN_BF16_REL * ref.float().abs() + TRAIN_BF16_SCALE * scale,
            f"2^-6|ref|+{TRAIN_BF16_SCALE * scale:.3g}")


def check_train(tag, got, ref, dtype, labels, quiet=False):
    """Max abs errors of o, dq, dk, dv (or o, dqkv) against the plain
    versions' and their bounds; raises outside a bound."""
    errs, parts, ok = [], [], True
    for g, r, label in zip(got, ref, labels):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{tag}: {label} is {tuple(g.shape)} "
                                 f"{g.dtype}, plain {tuple(r.shape)} "
                                 f"{r.dtype}")
        bound, text = train_bound(r, dtype)
        diff = (g.float() - r.float()).abs()
        use = (diff / bound).max().item()
        ok = ok and use <= 1.0
        errs.append(diff.max().item())
        parts.append(f"{label}={errs[-1]:.3g} (bound {text}, {use:.2f} of "
                     f"it)")
    line = f"  {tag}: max abs err " + ", ".join(parts)
    if not ok:
        if not quiet:
            log(line)
        raise AssertionError(f"{tag} outside its bounds")
    return errs, line


def check_train_refuse(tag, got, ref, dtype, labels) -> None:
    """Each bound must refuse its output or gradient zeroed or halved."""
    for i in range(len(got)):
        for factor in (0.0, 0.5):
            bad = list(got)
            bad[i] = got[i] * factor
            try:
                check_train(tag, bad, ref, dtype, labels, quiet=True)
            except AssertionError:
                continue
            raise AssertionError(f"{tag}: {labels[i]} x {factor} passed "
                                 f"the bounds")


def train_attn_cost(b, h, n, dh, esize):
    """Bytes and FLOPs of attention's forward and backward on [b, h, n, dh]:
    the forward reads q, k, v and writes o; the backward reads q, k, v, do
    and writes dq, dk, dv; per head 4 n^2 dh FLOPs forward (S, PV) and
    10 n^2 dh backward (S, dv, dP, dq, dk)."""
    return 11 * b * h * n * dh * esize, 14 * b * h * n * n * dh


def check_stats(tag, got, ref) -> str:
    """The tensor-core forward's saved (m, l) [2, B, H, N] against the plain
    statistics within STATS_M_REL / STATS_L_REL; the bound must refuse l
    halved."""
    def use(m, l):
        return max(((m - ref[0]).abs()
                    / (STATS_M_REL * (1 + ref[0].abs()))).max().item(),
                   ((l - ref[1]).abs() / (STATS_L_REL * ref[1])).max().item())

    u = use(got[0], got[1])
    if not u <= 1.0:
        raise AssertionError(f"{tag}: saved (m, l) at {u:.2f} of the bound")
    if use(got[0], got[1] * 0.5) <= 1.0:
        raise AssertionError(f"{tag}: a halved l passed the stats bound")
    return f"(m, l) at {u:.3f} of their bound"


def phase_train_kernel(device, packed: bool) -> dict:
    """``attention_train`` (or, ``packed``, ``attention_train_packed``)
    forward and backward against the plain versions: bf16 on the
    tensor-core route, f32 on the split-TF32 route (each forward's (m, l)
    against the plain statistics), and each, on a copy off the 16-byte
    grid, on the FMA route they replace; [B, H, N, dh] also at vit_h14's
    heads 80 wide (train runs (f) and (g)). Returns the main path's
    numbers (vit_b16 packed, vit_t16 [B, H, N, dh]) of the three routes
    (bf16 for the tensor cores, f32 for split TF32 and for FMA, its time
    from the copy off the grid: at train run (f)'s shape for
    [B, H, N, dh], where the FMA pair ran until the 80-wide tensor-core
    kernels), SDPA forward + backward beside each; the split route's bound
    at the TF32 peak (three TF32 products a product)."""
    import torch
    import torch.nn.functional as F

    from interactive_vit_tpu_torch.ops import attention_vjp as av

    name = "attention_train_packed" if packed else "attention_train"
    fn_counts = av.attention_train_packed if packed else av.attention_train
    served = TRAIN_B16 if packed else TRAIN_T16
    cases = ([(c, None) for c in [TRAIN_B16] + ([] if packed else [TRAIN_T16])]
             + [((8, 2, 208, 64), 197), ((8, 6, 577, 64), None)]
             + ([] if packed else [(TRAIN_H14, None), (TRAIN_H14_G, None),
                                   ((2, 4, 272, 80), 257)]))
    timed = (served, TRAIN_H14, TRAIN_H14_G)

    def counts():
        return (fn_counts.fwd_launches, fn_counts.bwd_launches,
                fn_counts.mma_fwd_launches, fn_counts.mma_bwd_launches,
                fn_counts.tf32_fwd_launches, fn_counts.tf32_bwd_launches)

    out = {}
    for shape, n_real in cases:
        b, h, n, dh = shape
        nr = n if n_real is None else n_real
        # every shape's heads (64, or vit_h14's 80) take the tensor cores
        if dh not in av.TRAIN_MMA_DHS or dh not in av.TRAIN_TF32_DHS:
            raise AssertionError(f"{name}: no tensor-core route at dh={dh}")
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).replace("torch.", "")
            mma = dtype == torch.bfloat16
            g = torch.Generator().manual_seed(n + h)
            qkv0 = torch.randn((b, n, 3 * h * dh), generator=g).to(device,
                                                                   dtype)
            do = torch.randn((b, n, h * dh), generator=g).to(device, dtype)
            routes = [("tensor cores" if mma else "split TF32", qkv0),
                      ("FMA, off the 16-byte grid",
                       misaligned(qkv0, 4 if mma else 2))]
            ref = None
            t_routes = {}
            for route, qkv in routes:
                if packed:
                    inputs = [qkv.detach().requires_grad_(True)]
                    fn = functools.partial(av.attention_train_packed,
                                           n_real=n_real)
                    dout, labels = do, ("o", "dqkv")

                    def plain(qkv=qkv):
                        return (av.attention_train_packed_reference(qkv,
                                                                    n_real),
                                av.packed_head_grads_reference(qkv, do,
                                                               n_real))
                else:
                    # q, k, v as qkv_proj makes them: views of one [B, N, 3D]
                    views = [qkv.reshape(b, n, 3, h, dh)[:, :, i]
                             .transpose(1, 2) for i in range(3)]
                    inputs = [t.detach().requires_grad_(True) for t in views]
                    fn = functools.partial(av.attention_train, n_real=n_real)
                    dout = do.reshape(b, n, h, dh).transpose(1, 2)
                    labels = ("o", "dq", "dk", "dv")

                    def plain(views=views, dout=dout):
                        return (av.attention_train_reference(*views, n_real),
                                *av.head_grads_reference(*views, dout,
                                                         n_real))

                def kernel(fn=fn, inputs=inputs, dout=dout):
                    o = fn(*inputs)
                    return (o.detach(), *torch.autograd.grad(o, inputs, dout))

                before = counts()
                got = kernel()
                torch.cuda.synchronize()
                fma = route.startswith("FMA")
                step = ((1, 1, 0, 0, 0, 0) if fma else (0, 0, 1, 1, 0, 0)
                        if mma else (0, 0, 0, 0, 1, 1))
                if counts() != tuple(x + d for x, d in zip(before, step)):
                    raise AssertionError(f"{name} {dt} {route}: launches "
                                         f"{counts()} after {before}")
                if ref is None:
                    ref = plain()
                tag = (f"{name} {(b, n, 3 * h * dh) if packed else shape} "
                       f"{dt} ({route})"
                       + (f" n_real={n_real}" if n_real else ""))
                errs, line = check_train(tag, got, ref, dtype, labels)
                check_train_refuse(tag, got, ref, dtype, labels)
                if not fma:
                    if packed:
                        _, stats = av._packed_fwd(qkv, nr)
                        sq, sk = av._split_packed(qkv)[:2]
                    else:
                        _, stats = av._fwd(*views, nr)
                        sq, sk = views[:2]
                    line += "; " + check_stats(
                        tag, stats, av.row_stats_reference(sq, sk, n_real))
                if n_real is not None:
                    dk_dv = (got[1][:, n_real:].reshape(b, n - n_real, h, 3,
                                                        dh)[:, :, :, 1:]
                             if packed else torch.stack(got[2:])[:, :, :,
                                                                 n_real:])
                    if not torch.all(dk_dv == 0):
                        raise AssertionError(f"{tag}: masked keys got dk or "
                                             f"dv")
                    line += "; masked keys' dk, dv exactly 0"
                log(line)
                if shape in timed:
                    if packed:
                        t_f = time_ms(lambda: av._packed_fwd(qkv, n))
                        _, st = av._packed_fwd(qkv, n)
                        t_b = time_ms(lambda: av._packed_bwd(qkv, do, n, st))
                    else:
                        t_f = time_ms(lambda: av._fwd(*views, n))
                        _, st = av._fwd(*views, n)
                        t_b = time_ms(lambda: av._bwd(*views, dout, n, st))
                    t_routes[route] = (time_ms(kernel), t_f, t_b, errs,
                                       kernel, plain)
            if shape not in timed:
                continue
            # SDPA on the [B, H, N, dh] views, forward + backward
            sv = [t.detach().requires_grad_(True) for t in
                  (qkv0.reshape(b, n, h, 3, dh)[:, :, :, i].transpose(1, 2)
                   if packed else
                   qkv0.reshape(b, n, 3, h, dh)[:, :, i].transpose(1, 2)
                   for i in range(3))]
            sdo = do.reshape(b, n, h, dh).transpose(1, 2)

            def sdpa():
                o = F.scaled_dot_product_attention(*sv)
                return torch.autograd.grad(o, sv, sdo)

            first, off_grid = routes[0][0], routes[-1][0]
            t_k, t_p = time_turns(t_routes[first][4], t_routes[first][5])
            t_lib = time_ms(sdpa)
            nbytes, flops = train_attn_cost(b, h, n, dh, qkv0.element_size())
            bms, by = bound(nbytes, flops, dt)
            # the split route's own products: three TF32 ones a product
            tms, tby = bound(nbytes, {"tf32": 3 * flops}, dt)
            log(f"  {name} {shape} {dt}: " + ", ".join(
                f"{r} fwd+bwd {t:.4f} ms (fwd {tf:.4f}, bwd {tb:.4f})"
                for r, (t, tf, tb, _, _, _) in t_routes.items())
                + f"; in turns kernel {t_k:.4f} ms, plain {t_p:.4f} ms; bound "
                f"{bms:.5f} ms ({by}: {nbytes / 1e6:.2f} MB, "
                f"{flops / 1e9:.3f} GFLOP)"
                + ("" if mma else f", at the TF32 peak (the "
                   f"split's {3 * flops / 1e9:.3f} GFLOP) {tms:.5f} ms "
                   f"({tby})")
                + f"; scaled_dot_product_attention fwd+bwd {t_lib:.4f} ms")
            if shape == served:
                out["mma" if mma else "tf32"] = {
                    "max_abs_err": max(t_routes[first][3]), "ms": t_k,
                    "plain_ms": t_p, "bound_ms": bms if mma else tms,
                    "bound_by": by if mma else tby, "library_ms": t_lib}
            if not mma and shape == (served if packed else TRAIN_H14):
                # no configuration gives either layout FMA operands: the
                # FMA pair's numbers come from the copy off the grid, for
                # [B, H, N, dh] at train run (f)'s shape (its main-path use
                # until heads 80 wide took the tensor cores)
                out["fma"] = {
                    "max_abs_err": max(t_routes[off_grid][3]),
                    "ms": t_routes[off_grid][0], "plain_ms": t_p,
                    "bound_ms": bms, "bound_by": by, "library_ms": t_lib}
    return out


def profile_train_step(cfg, device, attn, compute_dtype, dtype, tag,
                       expect=None, batch=64):
    """One train step of ``parallel.train.setup``'s at ``batch`` under
    torch.profiler after two warm-up steps (``profiled``, ``expect`` as
    there)."""
    import torch

    from interactive_vit_tpu_torch.parallel import train as train_lib

    params, state, step, _ = train_lib.setup(
        cfg, device=device, seed=1, attn_impl=attn, remat=False,
        dtype=dtype, compute_dtype=compute_dtype)
    g = torch.Generator().manual_seed(2)
    images = torch.randn((batch, 3, cfg.img_size, cfg.img_size),
                         generator=g).to(device)
    labels = torch.randint(0, cfg.num_classes, (batch,),
                           generator=g).to(device)
    for _ in range(2):
        params, state, loss = step(params, state, images, labels)
    def one_step():
        nonlocal params, state
        params, state, loss = step(params, state, images, labels)
        float(loss)

    profiled(lambda: synchronized_ms(one_step), f"{tag} profile of one step",
             expect)


def run_train(tag, argv, counters, expect, main=None) -> dict:
    """``main(argv)`` (default ``tools.train.main``) with every count set
    to 0 just before and read just after; ``expect``: {kernel: (forward,
    backward) launches} (every other kernel 0). Checks a finite loss at
    every logged step; returns main's result with ``counts``, the run's
    own ``peak_gib`` (``max_memory_allocated`` less what was allocated
    before it began: earlier phases' tensors are not the run's), the
    ``base_gib`` it stood on, and steady ``ms_per_step`` (the steps after
    the first two, when every step is logged)."""
    import math

    import torch

    from interactive_vit_tpu_torch.tools import train as train_tool

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():  # the run starts here
        fn.launches = 0
    res = (main or train_tool.main)(argv)
    torch.cuda.synchronize()
    res["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    res["base_gib"] = base / 2 ** 30
    counts = {k: (fn.pair if isinstance(fn, FwdBwdCount) else fn.launches)
              for k, fn in counters.items()}
    want = {k: expect.get(k, (0, 0) if isinstance(fn, FwdBwdCount) else 0)
            for k, fn in counters.items()}
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, expected {want}")
    losses = [loss for _, loss, _ in res["history"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: loss not finite: {losses}")
    t = [s for _, _, s in res["history"]]
    res["counts"] = counts
    if len(t) > 2:
        res["ms_per_step"] = (t[-1] - t[1]) / (len(t) - 2) * 1e3
    return res


# A train step's attention kernels by name in the profile: 12 launches
# each of the tensor-core forward, dq and dk/dv kernels, no FMA attention
TRAIN_MMA_PROFILE = {"train_fwd_mma_kernel": 12, "train_dq_mma_kernel": 12,
                     "train_dkdv_mma_kernel": 12, "tiled_attention_kernel": 0,
                     "attn_bwd_dq_kernel": 0, "attn_bwd_dkdv_kernel": 0}
# vit_h14's step: 32 blocks, every one on the 80-wide instantiations
TRAIN_MMA_PROFILE_H14 = {k: 32 if v else 0
                         for k, v in TRAIN_MMA_PROFILE.items()}


def phase_train(device, counters) -> dict:
    """Phase 5: the trainer's runs (a)-(g); returns the launches (forward +
    backward) of each trainable-attention route in its main-path run."""
    import dataclasses

    import torch

    from interactive_vit_tpu_torch.models import vit
    from interactive_vit_tpu_torch.ops import attention_vjp as av
    from interactive_vit_tpu_torch.parallel import mesh
    from interactive_vit_tpu_torch.parallel import train as train_lib
    from interactive_vit_tpu_torch.tools.train import pattern_set

    launches = {}
    # (a) vit_b16, mixed precision, the packed kernels
    steps, batch = 10, 64
    res = run_train(
        "train vit_b16", ["--variant", "vit_b16", "--dtype", "mixed",
                          "--attn", "auto", "--batch", str(batch),
                          "--steps", str(steps), "--memorize", "64",
                          "--log-every", "1"],
        counters, {"attention_train_packed_mma": (12 * steps, 12 * steps)})
    if res["remat"] is not False:
        raise AssertionError(f"--remat auto resolved to {res['remat']} for "
                             f"vit_b16 at B=64 on this card")
    losses = [loss for _, loss, _ in res["history"]]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train vit_b16: loss did not fall: {losses}")
    launches["attention_train_packed_mma"] = sum(res["counts"][
        "attention_train_packed_mma"])
    SYNTH_STEP_MS["vit_b16"] = res["ms_per_step"]
    log(f"  train vit_b16 @224 mixed, B={batch}, {steps} steps: remat auto "
        f"-> off, head-major {res['head_major']}, packed tensor-core "
        f"launches {res['counts']['attention_train_packed_mma']} (12 + 12 a "
        f"step), FMA 0; loss "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; {res['ms_per_step']:.2f} ms a step, "
        f"{batch * 1e3 / res['ms_per_step']:.1f} images/s (steps 3-{steps})")
    cfg = vit.VARIANTS["vit_b16"]
    profile_train_step(cfg, device, "auto", torch.bfloat16, None,
                       "train vit_b16 mixed, kernels", TRAIN_MMA_PROFILE)
    profile_train_step(cfg, device, "reference", torch.bfloat16, None,
                       "train vit_b16 mixed, plain attention")

    # (b) vit_t16, bf16, 3 heads: the [B, H, N, dh] kernels
    steps = 5
    res = run_train(
        "train vit_t16", ["--variant", "vit_t16", "--dtype", "bfloat16",
                          "--batch", str(batch), "--steps", str(steps),
                          "--log-every", "1"],
        counters, {"attention_train_mma": (12 * steps, 12 * steps)})
    launches["attention_train_mma"] = sum(res["counts"]["attention_train_mma"])
    log(f"  train vit_t16 @224 bf16, B={batch}, {steps} steps: head-major "
        f"{res['head_major']}, tensor-core launches "
        f"{res['counts']['attention_train_mma']} (12 + 12 a step), FMA and "
        f"packed 0; loss "
        + " ".join(f"{x:.4f}" for _, x, _ in res["history"])
        + f"; {res['ms_per_step']:.2f} ms a step, "
        f"{batch * 1e3 / res['ms_per_step']:.1f} images/s (steps 3-{steps})")
    profile_train_step(vit.VARIANTS["vit_t16"], device, "auto", None,
                       torch.bfloat16, "train vit_t16 bf16, kernels",
                       TRAIN_MMA_PROFILE)

    # (c) remat on: the blocks' forwards run again in the backward
    steps = 2
    res = run_train(
        "train vit_b16 remat", ["--variant", "vit_b16", "--dtype", "mixed",
                                "--batch", str(batch), "--steps",
                                str(steps), "--remat", "on",
                                "--log-every", "1"],
        counters, {"attention_train_packed_mma": (24 * steps, 12 * steps)})
    log(f"  train vit_b16 --remat on, {steps} steps: packed tensor-core "
        f"launches {res['counts']['attention_train_packed_mma']} (24 + 12 a "
        f"step); loss "
        + " ".join(f"{x:.4f}" for _, x, _ in res["history"]))

    # (d) first-step f32 gradients: the packed split-TF32 kernels against
    # the plain attention
    def first_step_gradients(tag, cfg, batch, packed, expect,
                             compute_dtype=None):
        """The first step's gradients (f32 params; ``compute_dtype``
        bf16: mixed precision, else f32 throughout) through the kernels
        (every count set to 0 just before, read just after: ``expect``,
        every other kernel 0) against the plain attention on the same
        params and batch, each within its bound (f32: TRAIN_GRAD_REL;
        mixed: TRAIN_BF16_GRAD_REL, which must refuse each gradient
        zeroed or halved); returns the counts."""
        params = vit.init_params(cfg, torch.Generator().manual_seed(3),
                                 device=device)
        images, labels = pattern_set(3, batch, cfg.img_size,
                                     cfg.num_classes)
        images = torch.from_numpy(images).to(device)
        labels = torch.from_numpy(labels).to(device)

        def value_and_grads(p, **kw):
            leaves = [x.detach().requires_grad_(True)
                      for x in train_lib.tree_leaves(p)]
            loss = train_lib.loss_fn(train_lib.cast_params(
                train_lib.tree_unflatten(p, leaves), compute_dtype),
                images, labels, cfg, **kw)
            return loss.item(), torch.autograd.grad(loss, leaves)

        for fn in counters.values():
            fn.launches = 0
        kw = {"attn_impl": av.trainable_flash_mhsa}
        if packed:
            kw["qkv_head_major"] = True
            loss_k, g_k = value_and_grads(
                mesh.permute_qkv_head_major(params, cfg.heads), **kw)
        else:
            loss_k, g_k = value_and_grads(params, **kw)
        torch.cuda.synchronize()
        counts = {k: fn.pair for k, fn in counters.items()
                  if isinstance(fn, FwdBwdCount)}
        want = {k: expect.get(k, (0, 0)) for k in counts}
        if counts != want:
            raise AssertionError(f"{tag}: launches {counts}, expected {want}")
        if packed:
            g_k = train_lib.tree_leaves(mesh.unpermute_qkv_head_major(
                train_lib.tree_unflatten(params, g_k), cfg.heads))
        loss_r, g_r = value_and_grads(params)
        rel, loss_rel = ((TRAIN_GRAD_REL, 1e-5) if compute_dtype is None
                         else (TRAIN_BF16_GRAD_REL, TRAIN_BF16_LOSS_REL))
        if abs(loss_k - loss_r) > loss_rel * max(1.0, abs(loss_r)):
            raise AssertionError(f"{tag}: loss {loss_k} vs plain {loss_r}")

        def use(a, b):
            return ((a - b).abs().max() / (rel * b.abs().max())).item()

        worst = (0.0, "")
        for (path, _), a, b in zip(train_lib.tree_leaves_with_path(params),
                                   g_k, g_r):
            u = use(a, b)
            if not u <= 1.0:
                raise AssertionError(f"{tag}: {path} at {u:.2f} of its "
                                     f"bound")
            if compute_dtype is not None and not (
                    use(a * 0.5, b) > 1.0 and use(a * 0.0, b) > 1.0):
                raise AssertionError(f"{tag}: {path} halved or zeroed "
                                     f"passed its bound")
            worst = max(worst, (u, path))
        ran = {k: v for k, v in counts.items() if v != (0, 0)}
        log(f"  {tag}, B={batch}: kernels ({ran}) vs plain attention: loss "
            f"{loss_k:.6f} vs {loss_r:.6f}; every parameter's gradient "
            f"within {rel:g} of its largest value, the nearest {worst[1]} at "
            f"{worst[0]:.3f} of its bound")
        return counts

    counts = first_step_gradients(
        "train vit_b16 f32 first-step gradients", cfg, 8, True,
        {"attention_train_packed_tf32": (12, 12)})
    launches["attention_train_packed_tf32"] = sum(
        counts["attention_train_packed_tf32"])
    # no configuration gives the packed layout operands off the 16-byte
    # grid: its FMA route has no main-path launch
    launches["attention_train_packed"] = 0

    # (e) vit_t16 in f32: attention_train's split-TF32 kernels
    steps = 2
    res = run_train(
        "train vit_t16 f32", ["--variant", "vit_t16", "--dtype", "float32",
                              "--batch", str(batch), "--steps", str(steps),
                              "--log-every", "1"],
        counters, {"attention_train_tf32": (12 * steps, 12 * steps)})
    launches["attention_train_tf32"] = sum(
        res["counts"]["attention_train_tf32"])
    log(f"  train vit_t16 @224 f32, B={batch}, {steps} steps: split-TF32 "
        f"launches {res['counts']['attention_train_tf32']} (12 + 12 a step), "
        f"FMA and bf16 tensor-core 0; loss "
        + " ".join(f"{x:.4f}" for _, x, _ in res["history"]))

    # (f) heads 80 wide: attention_train's split-TF32 kernels
    h14 = vit.VARIANTS["vit_h14"]
    hcfg = dataclasses.replace(h14, depth=2)
    first_step_gradients(
        "train vit_h14 (depth 2) f32 first-step gradients", hcfg, 2, False,
        {"attention_train_tf32": (2, 2)})
    # no configuration gives attention_train operands off the 16-byte grid
    # since heads 80 wide take the tensor cores: the FMA pair has no
    # main-path launch
    launches["attention_train"] = 0

    # (g) vit_h14 at full width and depth, mixed precision: the 80-wide
    # bf16 tensor-core kernels in all 32 blocks
    steps, batch = 3, 8
    torch.cuda.reset_peak_memory_stats()
    res = run_train(
        "train vit_h14", ["--variant", "vit_h14", "--dtype", "mixed",
                          "--batch", str(batch), "--steps", str(steps),
                          "--log-every", "1"],
        counters, {"attention_train_mma": (32 * steps, 32 * steps)})
    if res["remat"] is not False:
        raise AssertionError(f"--remat auto resolved to {res['remat']} for "
                             f"vit_h14 at B={batch} on this card")
    log(f"  train vit_h14 @224 mixed, B={batch}, {steps} steps: remat auto "
        f"-> off, head-major {res['head_major']}, tensor-core launches "
        f"{res['counts']['attention_train_mma']} (32 + 32 a step), FMA and "
        f"packed 0; loss "
        + " ".join(f"{x:.4f}" for _, x, _ in res["history"])
        + f"; {res['ms_per_step']:.2f} ms a step, "
        f"{batch * 1e3 / res['ms_per_step']:.2f} images/s (step 3), peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_train_step(h14, device, "auto", torch.bfloat16, None,
                       "train vit_h14 mixed, kernels",
                       TRAIN_MMA_PROFILE_H14, batch=batch)
    first_step_gradients(
        "train vit_h14 (depth 2) mixed first-step gradients", hcfg, 2,
        False, {"attention_train_mma": (2, 2)}, compute_dtype=torch.bfloat16)
    return launches

# -- phase 6: real weights through the checkpoint paths ---------------------

# row 1's kernels by name in one vit_b16 bf16 pass: 12 each on the tensor
# cores, the FMA block kernel never
ROW1_PROFILE = {"row1_qkv_mma_kernel": 12, "row1_attn_mma_kernel": 12,
                "proj_mma_kernel": 12, "gemm_kernel": 0,
                "::attention_kernel": 0}
# row 5's in one swin_t bf16 pass
ROW5_PROFILE = {"window_attn_mma_kernel": 12, "row1_qkv_mma_kernel": 12,
                "proj_mma_kernel": 12, "window_attention_kernel": 0}
# The accuracy oracle at full width: vit_t16 trained by tools.train on a
# memorised set of 32 patterned images of 10 classes (the JAX package's
# tests/test_accuracy_oracle.py at vit_t16's width and depth), then served
# from its exported file; JAX's threshold
ORACLE_ARGS = ["--variant", "vit_t16", "--dtype", "mixed", "--memorize",
               "32", "--distinct-classes", "10", "--batch", "32",
               "--steps", "60", "--lr", "5e-4", "--warmup", "10",
               "--clip-norm", "1.0"]
ORACLE_STEPS = 60
ORACLE_TOP1 = 0.9


def decoded(url, body):
    """POST ``body`` to /compute; the decoded response."""
    from interactive_vit_tpu_torch.wire.codec import Response

    return Response.decode(post(url + "/compute", body))


def same_bits(tag, got, want) -> int:
    """Two results ({node: {channel: array}}) equal bit for bit, every
    output finite; returns the outputs compared."""
    keys = sorted((i, ch) for i in want for ch in want[i])
    if keys != sorted((i, ch) for i in got for ch in got[i]):
        raise AssertionError(f"{tag}: outputs {sorted(got)} vs {keys}")
    for i, ch in keys:
        a, b = np.asarray(got[i][ch]), np.asarray(want[i][ch])
        if not np.isfinite(b).all():
            raise AssertionError(f"{tag}: node {i} {ch} not finite")
        if a.shape != b.shape or a.dtype != b.dtype or \
                a.tobytes() != b.tobytes():
            diff = (float(np.abs(a - b).max()) if a.shape == b.shape
                    else f"shape {a.shape} vs {b.shape}")
            raise AssertionError(f"{tag}: node {i} {ch} differs from the "
                                 f"direct weights' (max abs {diff})")
    return len(keys)


def same_tree(tag, got, want) -> int:
    """Two trees of tensors (and Python scalars) equal bit for bit: the
    same structure, dtypes and bytes; returns the leaves compared."""
    import torch

    from interactive_vit_tpu_torch.parallel.train import (
        tree_leaves_with_path,
    )

    ga, wa = tree_leaves_with_path(got), tree_leaves_with_path(want)
    if [p for p, _ in ga] != [p for p, _ in wa]:
        raise AssertionError(f"{tag}: tree paths differ")
    for (path, a), (_, b) in zip(ga, wa):
        if isinstance(b, torch.Tensor):
            if not (isinstance(a, torch.Tensor) and a.dtype == b.dtype
                    and a.shape == b.shape and a.device == b.device
                    and torch.equal(a.reshape(-1).view(torch.uint8),
                                    b.reshape(-1).view(torch.uint8))):
                raise AssertionError(f"{tag}: {path} differs")
        elif a != b or type(a) is not type(b):
            raise AssertionError(f"{tag}: {path} {a!r} vs {b!r}")
    return len(wa)


def one_request_counts(url, body, counters, tag, expect):
    """One request (its program captured already) with every count set to
    0 just before and read just after: the kernels that launched must be
    ``expect`` ({name: launches}), exactly."""
    import torch

    for fn in counters.values():
        fn.launches = 0
    out = decoded(url, body)
    torch.cuda.synchronize()
    seen = {k: fn.launches for k, fn in counters.items() if fn.launches}
    if seen != expect:
        raise AssertionError(f"{tag}: launches {seen}, expected {expect}")
    return out


def oracle_chain(variant, depth):
    """The model chain from embed on (the trainer fed raw tensors, so the
    served requests do too)."""
    return ([f"{variant}:embed"]
            + [f"{variant}:blocks.{i}" for i in range(depth)]
            + [f"{variant}:norm", f"{variant}:head"])


def oracle_request(chain, image):
    from interactive_vit_tpu_torch.graph.ir import Graph
    from interactive_vit_tpu_torch.wire.codec import Request

    g = Graph()
    nodes = [g.add_node(name) for name in chain]
    for a, b in zip(nodes, nodes[1:]):
        g.connect(a, "o", b, "o")
    g.add_input(image, nodes[0], "o")
    return Request.encode(g)


def phase_checkpoints(device, counters) -> None:
    """Phase 6: real weights through the checkpoint paths, at full width.

    (a) vit_b16's seeded params written in torchvision naming (the port's
    ``to_torchvision`` and ``save_file``) and served with ``--ckpt`` in
    bf16 and f32: each request's taps (maps and rollout of 3 blocks, the
    logits) bit for bit those of a server that draws the same seeded params
    itself (the loading servers use another seed, so their weights can only
    come from the file); 12 row-1 launches a request, by counter and, in
    bf16, by name in the profile. (b) the same file through
    ``tools.convert.main`` into a checkpoint directory, served from it. (c)
    swin_t from a ``to_native_flat`` file (layout sniffed): row 5, 12 a
    request. (d) ``--dtype int8w8a8`` from the vit_b16 file: equal to the
    seeded int8w8a8 server (quantization after the load). (e) the accuracy
    oracle: vit_t16 trained by ``tools.train.main`` (attention_train's
    tensor-core kernels in every step), exported with
    ``--export-safetensors``, served from the file over HTTP through the
    batcher; top-1 over its 32 images must exceed ORACLE_TOP1. (f) vit_b16
    mixed (head-major, the packed kernels) with ``--output --save-every 2``
    for 4 steps, then ``--resume`` to 6: the saved state is the first run's
    final state bit for bit, ``load_state`` restores it bit for bit, the
    resumed run starts at step 4 with the optimizer's count restored, its
    exported ``params/`` served with ``--ckpt`` give the returned params'
    logits bit for bit, and a resume under the other layout raises. (g)
    the load times, the first request after a load and the async save's
    stall, logged."""
    import torch

    from interactive_vit_tpu_torch.graph.executor import Executor
    from interactive_vit_tpu_torch.graph.registry import Registry
    from interactive_vit_tpu_torch.models import swin, vit
    from interactive_vit_tpu_torch.models.autoregister import make_model
    from interactive_vit_tpu_torch.models.weights import (
        to_native_flat, to_torchvision,
    )
    from interactive_vit_tpu_torch.ops.node_ops import register_builtin
    from interactive_vit_tpu_torch.serving.server import load_model_params
    from interactive_vit_tpu_torch.tools import convert as convert_tool
    from interactive_vit_tpu_torch.tools import train as train_tool
    from interactive_vit_tpu_torch.utils import checkpoint as ckpt_lib
    from interactive_vit_tpu_torch.utils.safetensors_io import save_file

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ivt_chip_ckpt_")
    try:
        graphs_dir = os.path.join(tmp, "graphs")
        shutil.copytree(os.path.join(HERE, "static", "graphs"), graphs_dir)
        seed = 5
        b16, scfg = vit.VARIANTS["vit_b16"], swin.VARIANTS["swin_t"]
        t0 = time.perf_counter()
        tv_file = os.path.join(tmp, "vit_b16_tv.safetensors")
        save_file(to_torchvision(vit.init_params(
            b16, torch.Generator().manual_seed(seed)), b16), tv_file)
        swin_file = os.path.join(tmp, "swin_t_native.safetensors")
        save_file(to_native_flat(swin.init_params(
            scfg, torch.Generator().manual_seed(seed))), swin_file)
        port_dir = os.path.join(tmp, "vit_b16_dir")
        convert_tool.main(["--model", "vit_b16", "--input", tv_file,
                           "--output", port_dir])
        log(f"  checkpoints: vit_b16 in torchvision naming "
            f"({os.path.getsize(tv_file) / 2**20:.1f} MiB), swin_t in the "
            f"native naming, vit_b16 through tools.convert.main into a "
            f"checkpoint directory: {time.perf_counter() - t0:.2f} s")
        loads = {}
        for what, path in (("torchvision .safetensors", tv_file),
                           ("checkpoint directory", port_dir)):
            times = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params = load_model_params("vit_b16", path, device=device)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                if params["blocks"][0]["qkv_w"].device != device:
                    raise AssertionError(f"{what}: loaded onto "
                                         f"{params['blocks'][0]['qkv_w'].device}")
                del params
            loads[what] = times
        log("  vit_b16 load_model_params onto the card (file cache warm "
            "after the write; two loads each): " + "; ".join(
                f"{k} {', '.join(f'{t:.3f}' for t in v)} s"
                for k, v in loads.items()))

        rng = np.random.default_rng(23)
        image = rng.random((3, 224, 224), dtype=np.float32)
        b16_path = Path("vit_b16", vit, b16, 224,
                        {2: ("attn", "r"), 7: ("attn", "r"),
                         13: ("attn", "r")}, {}, {}, vit_tap_shape, 0, 0)
        swin_path = Path("swin_t", swin, scfg, 224,
                         {2: ("attn",), 13: ("attn",)}, {}, {},
                         swin_tap_shape, 0, 0)

        def bodies(app):
            return {p.model: (chain_graph(app.graphs.load(p.model + ".json"),
                                          image), p.taps())
                    for p in (b16_path, swin_path)}

        def served(models, dtype_name, ckpts, s):
            t0 = time.perf_counter()
            app, httpd, url = serve(models, dtype_name, device, graphs_dir,
                                    ckpts=ckpts, seed=s)
            return app, httpd, url, time.perf_counter() - t0

        kernels = {"bfloat16": {"vit_b16": {"fused_attn_block_mma": 12},
                                "swin_t": {"fused_window_attn_mma": 12}},
                   "float32": {"vit_b16": {"fused_attn_block_tf32x3": 12},
                               "swin_t": {"fused_window_attn_tf32x3": 12}}}
        for dtype_name in ("bfloat16", "float32"):
            models = ["vit_b16", "swin_t"]
            d_app, d_httpd, d_url, _ = served(models, dtype_name, None, seed)
            c_app, c_httpd, c_url, build_s = served(
                models, dtype_name, {"vit_b16": tv_file, "swin_t": swin_file},
                seed + 1)
            try:
                reqs = bodies(c_app)
                for model in models:
                    g, taps = reqs[model]
                    body = graph_request(g, taps)
                    t0 = time.perf_counter()
                    first = decoded(c_url, body)
                    first_s = time.perf_counter() - t0
                    want = decoded(d_url, body)
                    n = same_bits(f"{model} {dtype_name} --ckpt", first, want)
                    tag = f"{model} {dtype_name} from its file"
                    again = one_request_counts(c_url, body, counters, tag,
                                               kernels[dtype_name][model])
                    same_bits(f"{tag} (a replay)", again, want)
                    log(f"  {tag}: {n} outputs bit for bit the seeded "
                        f"server's; launches {kernels[dtype_name][model]} a "
                        f"request; server built in {build_s:.2f} s, first "
                        f"request after the load (its capture) "
                        f"{first_s * 1e3:.1f} ms")
                    if dtype_name == "bfloat16":
                        profile_request(c_app.executor, g, taps, tag,
                                        ROW1_PROFILE if model == "vit_b16"
                                        else ROW5_PROFILE)
                if dtype_name == "bfloat16":
                    # (b) the checkpoint directory of tools.convert
                    stop(c_app, c_httpd)
                    c_app, c_httpd, c_url, build_s = served(
                        ["vit_b16"], dtype_name, {"vit_b16": port_dir},
                        seed + 1)
                    g, taps = reqs["vit_b16"]
                    body = graph_request(g, taps)
                    t0 = time.perf_counter()
                    got = decoded(c_url, body)
                    first_s = time.perf_counter() - t0
                    n = same_bits("vit_b16 bf16 from the directory", got,
                                  decoded(d_url, body))
                    one_request_counts(c_url, body, counters,
                                       "vit_b16 bf16 from the directory",
                                       kernels[dtype_name]["vit_b16"])
                    log(f"  vit_b16 bfloat16 from the checkpoint directory: "
                        f"{n} outputs bit for bit the seeded server's; "
                        f"server built in {build_s:.2f} s, first request "
                        f"{first_s * 1e3:.1f} ms")
            finally:
                stop(c_app, c_httpd)
                stop(d_app, d_httpd)

        # (d) W8A8 serving of the file: the quantization follows the load
        w8a8 = {"fused_attn_block_mma": 12, "fused_mlp_w8a8_block_mma": 12}
        d_app, d_httpd, d_url, _ = served(["vit_b16"], "int8w8a8", None, seed)
        c_app, c_httpd, c_url, _ = served(["vit_b16"], "int8w8a8",
                                          {"vit_b16": tv_file}, seed + 1)
        try:
            g, taps = bodies(c_app)["vit_b16"]
            body = graph_request(g, taps)
            n = same_bits("vit_b16 int8w8a8 --ckpt", decoded(c_url, body),
                          decoded(d_url, body))
            one_request_counts(c_url, body, counters, "vit_b16 int8w8a8",
                               w8a8)
            log(f"  vit_b16 int8w8a8 from its file: {n} outputs bit for bit "
                f"the seeded int8w8a8 server's; launches {w8a8} a request")
        finally:
            stop(c_app, c_httpd)
            stop(d_app, d_httpd)

        # (e) the accuracy oracle
        oracle_file = os.path.join(tmp, "vit_t16_oracle.safetensors")
        t0 = time.perf_counter()
        res = run_train(
            "oracle vit_t16", ORACLE_ARGS + [
                "--log-every", str(ORACLE_STEPS // 3),
                "--export-safetensors", oracle_file],
            counters, {"attention_train_mma": (12 * ORACLE_STEPS,
                                               12 * ORACLE_STEPS)})
        train_s = time.perf_counter() - t0
        t16 = vit.VARIANTS["vit_t16"]
        images, labels = train_tool.pattern_set(0, 32, t16.img_size,
                                                t16.num_classes, 10)
        app, httpd, url = serve(["vit_t16"], "float32", device, graphs_dir,
                                ckpts={"vit_t16": oracle_file})
        try:
            chain = oracle_chain("vit_t16", t16.depth)
            preds = [None] * len(labels)

            def worker(i):
                out = decoded(url, oracle_request(chain, images[i]))
                preds[i] = int(np.asarray(out[len(chain) - 1]["o"]).argmax())

            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            for lo in range(0, len(labels), 8):  # 8 clients at once
                threads = [threading.Thread(target=worker, args=(i,))
                           for i in range(lo, min(lo + 8, len(labels)))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=300)
            serve_s = time.perf_counter() - t0
            seen = {k: fn.launches for k, fn in counters.items()
                    if fn.launches}
            if (set(seen) != {"fused_attn_block_tf32x3"}
                    or seen["fused_attn_block_tf32x3"] % 12):
                raise AssertionError(f"oracle serving: launches {seen}")
        finally:
            stop(app, httpd)
        if None in preds:
            raise AssertionError("oracle: a request did not complete")
        top1 = float(np.mean([p == int(y) for p, y in zip(preds, labels)]))
        losses = [f"{loss:.4f}" for _, loss, _ in res["history"]]
        log(f"  oracle: vit_t16 mixed, {ORACLE_STEPS} steps at B=32 "
            f"({' '.join(ORACLE_ARGS[8:])}), attention_train tensor-core "
            f"launches {res['counts']['attention_train_mma']}, loss "
            f"{' '.join(losses)}, {train_s:.1f} s with the export; served "
            f"float32 from the file over HTTP (32 requests, 8 clients, "
            f"{seen['fused_attn_block_tf32x3']} row-1 launches, "
            f"{serve_s:.2f} s): top-1 {top1:.4f}")
        if not top1 > ORACLE_TOP1:
            raise AssertionError(f"oracle: served top-1 {top1} <= "
                                 f"{ORACLE_TOP1}")

        # (f) save, resume, export, serve
        out_dir = os.path.join(tmp, "resume_b16")
        state_dir = os.path.join(out_dir, "state")
        base = ["--variant", "vit_b16", "--dtype", "mixed", "--batch", "8",
                "--memorize", "16", "--log-every", "1", "--output", out_dir]
        r1 = run_train("save vit_b16", base + ["--steps", "4",
                                               "--save-every", "2"],
                       counters, {"attention_train_packed_mma": (48, 48)})
        if not r1["head_major"]:
            raise AssertionError("vit_b16 mixed did not train head-major")
        saved = ckpt_lib.load_params(state_dir, device=device)
        if int(saved.pop("step")) != 4 or int(saved.pop(
                "qkv_head_major")) != 1:
            raise AssertionError("the saved state's step or layout marker")
        n_saved = same_tree("the saved state", saved, {
            "params": r1["state"]["params"],
            "opt_state": r1["state"]["opt_state"]})
        del saved
        lp, lo, lstep = train_tool.load_state(
            state_dir, r1["state"]["params"], r1["state"]["opt_state"],
            expect_head_major=True)
        n_loaded = same_tree("load_state", {"params": lp, "opt_state": lo},
                             {"params": r1["state"]["params"],
                              "opt_state": r1["state"]["opt_state"]})
        del lp, lo
        if lstep != 4:
            raise AssertionError(f"load_state: step {lstep}")
        r2 = run_train("resume vit_b16", base + ["--steps", "6", "--resume"],
                       counters, {"attention_train_packed_mma": (24, 24)})
        count = r2["state"]["opt_state"]["count"]
        if r2["start_step"] != 4 or count != 6:
            raise AssertionError(f"resume: started at {r2['start_step']}, "
                                 f"optimizer count {count}")
        app, httpd, url = serve(["vit_b16"], "float32", device, graphs_dir,
                                ckpts={"vit_b16": os.path.join(out_dir,
                                                               "params")})
        try:
            reg = Registry()
            register_builtin(reg)
            make_model("vit_b16", params=r2["params"], device=device
                       ).register(reg)
            direct = Executor(reg=reg, device=device)
            g, _ = bodies(app)["vit_b16"]
            taps = [(b16_path.head_node, "o")]
            n = same_bits("the exported params/ served",
                          decoded(url, graph_request(g, taps)),
                          direct.run(g, taps))
        finally:
            stop(app, httpd)
        try:
            train_tool.main(base + ["--steps", "6", "--resume", "--attn",
                                    "reference"])
        except ValueError as err:
            if "layout mismatch" not in str(err):
                raise
        else:
            raise AssertionError("a resume under the other qkv layout "
                                 "did not raise")
        steps = [t for _, _, t in r1["history"]]
        step_ms = [1e3 * (b - a) for a, b in zip(steps, steps[1:])]
        log(f"  vit_b16 mixed B=8 --save-every 2, 4 steps then --resume to "
            f"6: the saved state ({n_saved} leaves) and load_state's "
            f"({n_loaded}) bit for bit the first run's final state; resumed "
            f"at step {r2['start_step']}, optimizer count {count}; the "
            f"exported params/ served f32 give the returned params' logits "
            f"bit for bit ({n} output); the other layout's --resume raised. "
            f"Step walls (ms, from step 0's end) "
            f"{', '.join(f'{t:.1f}' for t in step_ms)}; the --save-every "
            f"saves held the loop "
            + ", ".join(f"{t * 1e3:.1f} ms at step {s}"
                        for s, t in r1["saves"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  phase 6 took {time.perf_counter() - t_phase:.1f} s")


# -- phase 7: the last four families from their saved graphs ---------------

# bf16 taps against the same kinds run on the host in bf16 (the same seeded
# weights and code on the CPU): max abs error within FAMILY_BF16_REL of the
# tap's largest magnitude. The two sum their f32 products in different
# orders, so a value can round to the next bf16 step on one side; such
# steps carry through up to 50 layers (measured on the card: 0.5-1.2% of
# the scale for resnet50, convnext_t and mae_t16).
FAMILY_BF16_REL = 2.0 ** -4
# vit_moe_s16 in bf16: a token whose two best gates lie within those steps
# takes the other expert on one side (measured on the card: 7 of 196 patch
# tokens in some routed block), and its MLP branch is then another
# expert's output, of the order of the tap's scale, which attention passes
# on to the other tokens; so the block outputs and logits within
# MOE_BF16_REL of the scale (measured 6.2% on block 6), the gates
# ("experts", in [0, 1]) within MOE_GATE_ABS, the maps and the rollout (in
# [0, 1]) within MOE_MAP_ABS, absolute.
MOE_BF16_REL = 2.0 ** -2
MOE_GATE_ABS = 2.0 ** -3
MOE_MAP_ABS = 2.0 ** -5


def f32_bound(ch, scale):
    # the gates tap is bf16 at every dtype (the JAX contract): f32 gates a
    # hair apart can round to neighbouring bf16 steps, 2^-8 at most in [0, 1]
    return 2.0 ** -8 if ch == "experts" else F32_BOUND * max(1.0, scale)


def bf16_bound(ch, scale):
    return FAMILY_BF16_REL * scale


def moe_bf16_bound(ch, scale):
    return {"experts": MOE_GATE_ABS, "attn": MOE_MAP_ABS,
            "r": MOE_MAP_ABS}.get(ch, MOE_BF16_REL * scale)


# the taps of each saved graph: node -> channels (resnet50: transform,
# conv1, layer3.0, layer4.2, fc; convnext_t: transform, stem,
# downsample.2, stages.2.8, stages.3.2, head; vit_moe_s16: transform,
# the experts of every routed block, block 6, head; mae_t16: transform
# and the four views)
FAMILY_TAPS = {
    "resnet50": {0: ("o",), 1: ("o",), 10: ("o",), 18: ("o",), 20: ("o",)},
    "convnext_t": {0: ("o",), 1: ("o",), 9: ("o",), 18: ("o",),
                   22: ("o",), 24: ("o",)},
    "vit_moe_s16": {0: ("o",), 3: ("experts",), 5: ("experts",),
                    7: ("experts",), 8: ("o",), 9: ("experts",),
                    11: ("experts",), 13: ("experts",), 15: ("o",)},
    "mae_t16": {0: ("o",), 1: ("o", "masked", "err", "mask")},
}
# vit_moe_s16 under --attn flash: block 0's and 11's maps and rollout too
MOE_FLASH_TAPS = {**FAMILY_TAPS["vit_moe_s16"], 2: ("attn", "r"),
                  13: ("attn", "r", "experts")}
# the other saved graphs of the ViT family served once: (variant, head
# shape, kernel launches a bf16 request)
VIT_ONCE = (("deit_s16", (1, 1000), {"fused_attn_block_mma": 12}),
            ("dinov2_s14", (1, 384), {"flash_attention_mma": 12}))
MAE_SEEDS = (17, 18)


def tap_list(taps):
    return sorted((i, ch) for i, chs in taps.items() for ch in chs)


def host_chain(app, obj, transform_out, taps, node_params=None):
    """The saved chain's kinds from node 1 on, on the host (each kind's
    ``fn`` with its captures copied to the CPU, where a kernel wrapper
    runs its plain version), from the served transform output: {node: {ch:
    f32 array}} of ``taps``. The served dtype is kept."""
    import torch

    def cpu(tree):
        if isinstance(tree, torch.Tensor):
            return tree.cpu()
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cpu(v) for v in tree)
        return tree

    out = {}
    x = torch.from_numpy(np.array(transform_out))
    env = {"o": x}
    with torch.inference_mode():
        for i, node in enumerate(obj["nodes"][1:], 1):
            name = node["instance"].get("endpoint", "")
            if ":" not in name:
                continue
            kind = app.reg.get_node(name)
            params = {**node["instance"].get("params", {}),
                      **(node_params or {}).get(i, {}),
                      "__taps__": ",".join(taps.get(i, ()))}
            caps = kind.captures(params)
            fn = kind.fn(params)
            res = fn(env) if caps is None else fn(env, cpu(caps))
            out[i] = {ch: res[ch].float().numpy() for ch in taps.get(i, ())}
            env = {"o": res["o"]}
    return out


def resnet_f64(params, x):
    """ResNet-50 on the host in float64, written apart from the port's
    layer fns (torch's conv2d, max_pool2d, matmul; each batch norm as its
    folded affine), from the transform's output ``x`` [3, 224, 224]:
    {saved-graph node: output}."""
    import torch
    import torch.nn.functional as F

    from interactive_vit_tpu_torch.models import resnet

    def d(t):
        return t.cpu().double()

    def bn(h, p):
        return h * d(p["s"])[None, :, None, None] + d(p["b"])[None, :,
                                                              None, None]

    out = {}
    h = torch.relu(bn(F.conv2d(x.double()[None], d(params["conv1_w"]),
                               stride=2, padding=3), params["bn1"]))
    out[1] = h
    h = F.max_pool2d(h, 3, 2, 1)
    out[2] = h
    node = 3
    for si, (blocks, _) in enumerate(resnet.STAGES):
        for bi in range(blocks):
            p = params["layers"][si][bi]
            s = 2 if (si > 0 and bi == 0) else 1
            y = torch.relu(bn(F.conv2d(h, d(p["conv1_w"])), p["bn1"]))
            y = torch.relu(bn(F.conv2d(y, d(p["conv2_w"]), stride=s,
                                       padding=1), p["bn2"]))
            y = bn(F.conv2d(y, d(p["conv3_w"])), p["bn3"])
            idn = (bn(F.conv2d(h, d(p["down_w"]), stride=s), p["down_bn"])
                   if "down_w" in p else h)
            h = torch.relu(y + idn)
            out[node] = h
            node += 1
    h = h.mean(dim=(2, 3))
    out[19] = h
    out[20] = h @ d(params["fc"]["w"]) + d(params["fc"]["b"])
    return {i: v[0].numpy() for i, v in out.items()}


def convnext_f64(params, x, cfg):
    """ConvNeXt on the host in float64, written apart from the port's layer
    fns (torch's conv2d on NCHW with OIHW kernels, a LayerNorm of its own,
    erf GELU), from the transform's output ``x``: {saved-graph node:
    output}, NHWC as the served taps."""
    import torch
    import torch.nn.functional as F

    def d(t):
        return t.cpu().double()

    def ln(h, p):
        mu = h.mean(-1, keepdim=True)
        var = (h - mu).square().mean(-1, keepdim=True)
        return (h - mu) / torch.sqrt(var + cfg.ln_eps) * d(p["g"]) + d(p["b"])

    def conv(h, w, b, stride, pad, groups=1):
        y = F.conv2d(h.permute(0, 3, 1, 2), d(w).permute(3, 2, 0, 1), d(b),
                     stride=stride, padding=pad, groups=groups)
        return y.permute(0, 2, 3, 1)

    out = {}
    st = params["stem"]
    h = ln(conv(x.double()[None].permute(0, 2, 3, 1), st["w"], st["b"], 4,
                0), st["ln"])
    out[1] = h
    node = 2
    for s in range(len(cfg.depths)):
        for blk in params["stages"][s]:
            y = conv(h, blk["dw_w"], blk["dw_b"], 1, 3, groups=h.shape[-1])
            y = ln(y, blk["ln"]) @ d(blk["fc1"]["w"]) + d(blk["fc1"]["b"])
            y = F.gelu(y) @ d(blk["fc2"]["w"]) + d(blk["fc2"]["b"])
            h = h + d(blk["gamma"]) * y
            out[node] = h
            node += 1
        if s < len(params["downs"]):
            dp = params["downs"][s]
            h = conv(ln(h, dp["ln"]), dp["w"], dp["b"], 2, 0)
            out[node] = h
            node += 1
    h = h.mean(dim=(1, 2))
    out[node] = h
    hp = params["head"]
    out[node + 1] = ln(h, hp["ln"]) @ d(hp["fc"]["w"]) + d(hp["fc"]["b"])
    return {i: v[0].numpy() for i, v in out.items()}


def family_errors(tag, got, want, taps, bound=None):
    """Max abs errors of ``got`` (a response) against ``want`` ({node: {ch:
    array}}) over ``taps`` (the transform, node 0, aside), each within
    ``bound(ch, the tap's largest magnitude)``; ``bound`` None: reported
    only. The "mask" tap exactly. Returns {"node ch": (err, scale)}."""
    errs = {}
    for i, chs in taps.items():
        for ch in chs:
            if i == 0:
                continue
            a = np.asarray(got[i][ch], np.float64)
            b = np.asarray(want[i][ch], np.float64)
            if a.shape != b.shape or not np.isfinite(a).all():
                raise AssertionError(f"{tag} {i} {ch}: shape {a.shape} vs "
                                     f"{b.shape} or not finite")
            err = float(np.abs(a - b).max())
            scale = float(np.abs(b).max())
            if ch == "mask" and err:
                raise AssertionError(f"{tag}: the mask differs")
            if bound is not None and err > bound(ch, scale):
                raise AssertionError(f"{tag} node {i} {ch}: max abs err "
                                     f"{err:.3g} at scale {scale:.3g}, "
                                     f"bound {bound(ch, scale):.3g}")
            errs[f"{i} {ch}"] = (err, scale)
    return errs


def moe_routing_report(got, want, taps) -> str:
    """vit_moe_s16 in bf16 against the same kinds on the host: the patch
    tokens whose expert (the argmax of a routed block's "experts" tap)
    differs on the two sides in any routed block, and the largest error
    of the other patch tokens' rows of each block output, as a share of
    the tap's scale. Reported, not bounded: a token that kept its experts
    still attends to those that changed theirs (measured on the card: 7
    of 196 changed, the others' rows 6.2% off the scale at block 6)."""
    flipped = np.zeros(0, dtype=bool)
    for i, chs in taps.items():
        if "experts" in chs:
            a = np.asarray(got[i]["experts"])[0].reshape(
                got[i]["experts"].shape[1], -1).argmax(0)
            b = np.asarray(want[i]["experts"])[0].reshape(
                want[i]["experts"].shape[1], -1).argmax(0)
            flipped = (a != b) | (flipped if flipped.size else False)
    worst = {}
    for i, chs in taps.items():
        if "o" in chs and i and np.asarray(got[i]["o"]).ndim == 3:
            a = np.asarray(got[i]["o"], np.float64)[0, 1:][~flipped]
            b = np.asarray(want[i]["o"], np.float64)[0, 1:][~flipped]
            scale = float(np.abs(np.asarray(want[i]["o"])).max())
            worst[i] = float(np.abs(a - b).max()) / scale
    return (f"{int(flipped.sum())} of {flipped.size} patch tokens took "
            f"another expert in some routed block; the others' rows within "
            + ", ".join(f"{r:.3g}" for r in worst.values())
            + " of the scale")


def err_str(errs):
    return ", ".join(f"{k} {e:.3g}/{s:.3g}" for k, (e, s) in errs.items())


def row3_at_moe_shape(device) -> None:
    """Row 3 (``flash_attention``, the tensor-core route) against its plain
    version at vit_moe_s16's block shape (1, 6, 197, 64) in bf16, maps off
    and on; its device time beside the plain version's and the bound."""
    import torch

    from interactive_vit_tpu_torch.ops import flash_attention as fa

    shape = (1, 6, 197, 64)
    g = torch.Generator().manual_seed(197)
    qkv = [(torch.randn(shape, generator=g) * 2).to(device, torch.bfloat16)
           for _ in range(3)]
    for maps in (False, True):
        before = fa.flash_attention_mma.launches
        got = fa.flash_attention(*qkv, want_attn=maps)
        torch.cuda.synchronize()
        if fa.flash_attention_mma.launches != before + 1:
            raise AssertionError("row 3 at the MoE shape: not on the "
                                 "tensor-core route")
        ref = fa.flash_attention_reference(*qkv, want_attn=maps)
        tag = (f"flash_attention vit_moe_s16 {shape} bfloat16 (tensor "
               f"cores) maps {'on' if maps else 'off'}")
        _, line = check_outputs(tag, got, ref, torch.bfloat16,
                                ("o", "probs"))
        nbytes, flops = flash_cost(*shape, 2, maps)
        bms, by = bound(nbytes, flops, "bfloat16")
        t_k, t_p, t_host = time_turns_held(
            lambda: fa.flash_attention(*qkv, want_attn=maps),
            lambda: fa.flash_attention_reference(*qkv, want_attn=maps))
        log(line + f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms (device "
            f"time; the wrapper's host time {t_host:.4f} ms a call); bound "
            f"{bms:.5f} ms ({by})")


def phase_families(device, counters) -> None:
    """Phase 7: resnet50, convnext_t, vit_moe_s16 and mae_t16 from the
    repository's saved graphs through ``build_app`` (see the module
    docstring)."""
    import gc

    import torch

    from interactive_vit_tpu_torch.models import convnext

    t_phase = time.perf_counter()
    image = np.random.default_rng(24).random((3, 240, 260), np.float32)
    none_of_ours = {name: 0 for name in port_kernel_names()}
    walls = []
    row3_at_moe_shape(device)
    resp = {}
    for dtype_name in ("float32", "bfloat16"):
        f32 = dtype_name == "float32"
        gc.collect()
        torch.cuda.empty_cache()
        models = ["resnet50", "convnext_t", "vit_moe_s16", "mae_t16"]
        if not f32:
            models += [v for v, _, _ in VIT_ONCE]
        t0 = time.perf_counter()
        app, httpd, url = serve(models, dtype_name, device, None)
        log(f"  {dtype_name} server with {', '.join(models)}: built in "
            f"{time.perf_counter() - t0:.1f} s")
        try:
            ex = app.executor
            captured = watch_captures(ex)
            for variant, taps in FAMILY_TAPS.items():
                tag = f"{variant} {dtype_name}"
                obj = app.graphs.load(variant + ".json")
                npar = ({1: {"seed": str(MAE_SEEDS[0])}}
                        if variant == "mae_t16" else None)
                body = chain_request(obj, image, tap_list(taps), npar)
                t0 = time.perf_counter()
                eager = decoded(url, body)
                first_ms = (time.perf_counter() - t0) * 1e3
                cap_s = captured[-1][1]
                replay = one_request_counts(url, body, counters, tag, {})
                same_bits(f"{tag} replay vs its eager pass", replay, eager)
                resp[tag] = replay
                x = torch.from_numpy(np.array(replay[0]["o"]))
                if f32 and variant in ("resnet50", "convnext_t"):
                    model = app.reg.get_node(variant + ":head" if variant
                                             == "convnext_t" else
                                             variant + ":fc").model
                    t1 = time.perf_counter()
                    f64 = (resnet_f64(model.params, x) if variant ==
                           "resnet50" else convnext_f64(
                               model.params, x, convnext.VARIANTS[variant]))
                    want = {i: {"o": f64[i]} for i in taps if i}
                    what = (f"the float64 host forward "
                            f"({time.perf_counter() - t1:.1f} s)")
                else:
                    want = host_chain(app, obj, replay[0]["o"], taps, npar)
                    what = f"the same kinds on the host in {dtype_name}"
                errs = family_errors(tag, replay, want, taps, (
                    f32_bound if f32 else moe_bf16_bound
                    if variant == "vit_moe_s16" else bf16_bound))
                if variant == "vit_moe_s16" and not f32:
                    what += "; " + moe_routing_report(replay, want, taps)
                g = chain_graph(obj, image, npar)
                wall, busy = profile_request(ex, g, tap_list(taps), tag,
                                             none_of_ours)
                rw = median_ms(lambda: ex.run(g, tap_list(taps)))
                walls.append((tag, first_ms, cap_s, rw, wall, busy))
                log(f"  {tag}: replay bit for bit its eager pass, no kernel "
                    f"of the port; max abs err / scale vs {what}: "
                    + err_str(errs))
                if variant == "mae_t16":
                    mae_edits(app, url, obj, image, taps, captured, tag)
            if not f32:
                for variant, head_shape, expect in VIT_ONCE:
                    obj = app.graphs.load(variant + ".json")
                    head = next(i for i, n in enumerate(obj["nodes"]) if n[
                        "instance"].get("endpoint", "").endswith(":head"))
                    body = chain_request(obj, image, [(head, "o")])
                    decoded(url, body)
                    out = one_request_counts(url, body, counters,
                                             f"{variant} bf16", expect)
                    o = out[head]["o"]
                    if o.shape != head_shape or not np.isfinite(o).all():
                        raise AssertionError(f"{variant}: head {o.shape}")
                    log(f"  {variant}.json bfloat16: one request, "
                        f"{expect} a request, the head {o.shape} finite")
        finally:
            stop(app, httpd)
    for variant, taps in FAMILY_TAPS.items():
        errs = family_errors(f"{variant} bf16 vs f32", resp[
            f"{variant} bfloat16"], resp[f"{variant} float32"], taps)
        log(f"  {variant} bf16 vs the f32 server (its weights unrounded; "
            f"reported, not bounded; the MAE mask equal), max abs err / "
            f"scale: " + err_str(errs))
    moe_flash(device, image, counters, resp["vit_moe_s16 bfloat16"], walls)
    saliency_families(device, image, walls)
    log("  the four families (ms; the first request: its eager pass and "
        "capture, client wall; capture s; replay: median of 3 executor.run "
        "walls, synchronized; profiled replay wall / device busy):")
    for tag, first_ms, cap_s, rw, wall, busy in walls:
        log(f"    {tag}: first {first_ms:.1f}, capture {cap_s:.2f} s, "
            f"replay {rw:.2f}, profiled {wall:.2f} / {busy_str(busy)}")
    log(f"  phase 7 took {time.perf_counter() - t_phase:.1f} s")


def mae_edits(app, url, obj, image, taps, captured, tag) -> None:
    """A seed edit replays the captured program with a new mask, the draw
    of ``jax.random.uniform(key(seed))`` as the host makes it; a
    mask_ratio edit captures once."""
    import torch

    from interactive_vit_tpu_torch.models import mae

    cfg = app.reg.get_node("mae_t16:reconstruct").model.cfg
    n_caps = len(captured)
    masks = []
    for seed in MAE_SEEDS:
        out = decoded(url, chain_request(obj, image, tap_list(taps),
                                         {1: {"seed": str(seed)}}))
        masks.append(out[1]["mask"])
        _, want, _ = mae.random_masking(torch.tensor(seed), 1,
                                        cfg.num_patches, cfg.len_keep())
        if not np.array_equal(out[1]["mask"].reshape(1, -1), want.numpy()):
            raise AssertionError(f"{tag} seed {seed}: the mask is not the "
                                 f"host's draw")
    if len(captured) != n_caps:
        raise AssertionError(f"{tag}: a seed edit captured anew")
    if np.array_equal(masks[0], masks[1]):
        raise AssertionError(f"{tag}: a seed edit kept the mask")
    out = decoded(url, chain_request(obj, image, tap_list(taps), {
        1: {"seed": "5", "mask_ratio": "0.5"}}))
    if len(captured) != n_caps + 1 or out[1]["mask"].sum() != 98:
        raise AssertionError(f"{tag}: a mask_ratio edit made "
                             f"{len(captured) - n_caps} captures, masked "
                             f"{out[1]['mask'].sum()}")
    log(f"  {tag}: seed {MAE_SEEDS[0]} -> {MAE_SEEDS[1]} replayed (no "
        f"capture), each mask the host's draw; mask_ratio 0.5 captured "
        f"once ({captured[-1][1]:.2f} s), 98 of 196 patches masked")


def moe_flash(device, image, counters, auto_bf16, walls) -> None:
    """vit_moe_s16 in bf16 under ``--attn flash``: row 3 in all 12 blocks
    (exactly 12 launches a request, by name in one profiled replay), the
    maps and rollout of blocks 0 and 11 tapped; held to the same kinds on
    the host (the wrapper's plain version there) and to the auto server."""
    import torch

    taps = MOE_FLASH_TAPS
    tag = "vit_moe_s16 bfloat16 --attn flash"
    app, httpd, url = serve(["vit_moe_s16"], "bfloat16", device, None,
                            attn="flash")
    try:
        ex = app.executor
        captured = watch_captures(ex)
        obj = app.graphs.load("vit_moe_s16.json")
        body = chain_request(obj, image, tap_list(taps))
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        eager = decoded(url, body)
        first_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        seen = {k: fn.launches for k, fn in counters.items() if fn.launches}
        if seen != {"flash_attention_mma": 12}:
            raise AssertionError(f"{tag} eager pass: launches {seen}")
        replay = one_request_counts(url, body, counters, tag,
                                    {"flash_attention_mma": 12})
        same_bits(f"{tag} replay vs its eager pass", replay, eager)
        want = host_chain(app, obj, replay[0]["o"], taps)
        errs = family_errors(tag, replay, want, taps, moe_bf16_bound)
        routing = moe_routing_report(replay, want, taps)
        g = chain_graph(obj, image)
        row3 = {"rowfull_mma_kernel": 12, "tiled_attention_kernel": 0}
        wall, busy = profile_request(ex, g, tap_list(taps), tag, row3)
        rw = median_ms(lambda: ex.run(g, tap_list(taps)))
        walls.append((tag, first_ms, captured[-1][1], rw, wall, busy))
        # the auto server's taps (maps off): row 3 against the plain
        # attention on the same request
        auto_taps = tap_list(FAMILY_TAPS["vit_moe_s16"])
        decoded(url, chain_request(obj, image, auto_taps))
        wall, busy = profile_request(ex, g, auto_taps, tag + ", maps off",
                                     row3)
        rw = median_ms(lambda: ex.run(g, auto_taps))
        walls.append((tag + ", maps off", float("nan"), captured[-1][1], rw,
                      wall, busy))
        auto = {i: {ch: auto_bf16[i][ch] for ch in chs}
                for i, chs in FAMILY_TAPS["vit_moe_s16"].items()}
        same = {i: {ch: replay[i][ch] for ch in chs}
                for i, chs in FAMILY_TAPS["vit_moe_s16"].items()}
        aerrs = family_errors(f"{tag} vs auto", same, auto,
                              FAMILY_TAPS["vit_moe_s16"])
        log(f"  {tag}: 12 row-3 launches a request (eager and replay), the "
            f"replay bit for bit its eager pass; max abs err / scale vs the "
            f"kinds on the host (row 3's plain version): {err_str(errs)}; "
            f"{routing}; "
            f"vs the --attn auto server (plain attention; reported): "
            f"{err_str(aerrs)}")
    finally:
        stop(app, httpd)


def saliency_families(device, image, walls) -> None:
    """convnext_t_saliency.json and vit_moe_s16_saliency.json in bf16, one
    server each: the first request (eager pass and capture: dream's 32
    steps, occlusion's chunks), its capture time, a replay of another
    image and the replay of the first image bit for bit its eager pass."""
    import gc

    import torch

    image2 = np.random.default_rng(25).random(image.shape, np.float32)
    for variant in ("convnext_t", "vit_moe_s16"):
        gc.collect()
        torch.cuda.empty_cache()
        tag = f"{variant}_saliency bfloat16"
        app, httpd, url = serve([variant], "bfloat16", device, None)
        try:
            ex = app.executor
            captured = watch_captures(ex)
            obj = app.graphs.load(f"{variant}_saliency.json")
            names = [n["instance"].get("endpoint") or n["instance"]["kind"]
                     for n in obj["nodes"]]
            grads = {i: grad_kind(nm) for i, nm in enumerate(names)
                     if grad_kind(nm) in GRAD_TAPS}
            head = next(i for i, nm in enumerate(names)
                        if nm.endswith(":head"))
            taps = sorted({(head, "o")} | {(i, "o") for i in grads})
            t0 = time.perf_counter()
            eager = decoded(url, chain_request(obj, image, taps))
            first_ms = (time.perf_counter() - t0) * 1e3
            if len(captured) != 1:
                raise AssertionError(f"{tag}: {len(captured)} captures")
            t0 = time.perf_counter()
            other = decoded(url, chain_request(obj, image2, taps))
            other_ms = (time.perf_counter() - t0) * 1e3
            replay = decoded(url, chain_request(obj, image, taps))
            same_bits(f"{tag} replay vs its eager pass", replay, eager)
            for i in grads:
                for out in (replay, other):
                    o = out[i]["o"]
                    if not np.isfinite(o).all() or not np.abs(o).max() > 0:
                        raise AssertionError(f"{tag} node {i}: {o.shape}")
            g = chain_graph(obj, image)
            wall, busy = profile_request(ex, g, taps, tag)
            rw = median_ms(lambda: ex.run(g, taps))
            walls.append((tag, first_ms, captured[0][1], rw, wall, busy))
            log(f"  {tag}: first request {first_ms:.0f} ms (capture "
                f"{captured[0][1]:.2f} s), a replay of another image "
                f"{other_ms:.1f} ms (client wall), the replay of the first "
                f"bit for bit "
                f"its eager pass; " + ", ".join(
                    f"{grads[i]} {replay[i]['o'].shape}" for i in grads))
        finally:
            stop(app, httpd)


# -- phase 8: the native host tier and the trainer's data path --------------

# The host library's path and build seconds (phase 2 builds it).
HOST_BUILD = {}
# Phase 5's synthetic vit_b16 mixed B=64 step (ms), the --data run's
# yardstick.
SYNTH_STEP_MS = {}
# The served responses whose encode phase 8 times: (tag, model, image side,
# taps by node, node params, launches of one request).
ENCODE_PATHS = (
    ("dinov2_s14_reg @518 map", "dinov2_s14_reg", 518,
     {2: ("attn", "r"), 8: ("r",), 13: ("r",)}, {},
     {"flash_attention_mma": 12}),
    ("vit_l16 @384 maps", "vit_l16", 384,
     {2: ("attn", "r"), 14: ("attn", "r"), 25: ("r",)},
     {14: {"attn_heads": "[0,7,15]"}}, {"headwise_attn_block_mma": 24}),
    ("vit_b16 maps + rollout", "vit_b16", 224,
     {2: ("attn", "r"), 7: ("attn", "r"), 13: ("attn", "r")}, {},
     {"fused_attn_block_mma": 12}),
    ("vit_b16 head only", "vit_b16", 224, {}, {},
     {"fused_attn_block_mma": 12}),
)
# The loader check's dataset: 1,024 images [3, 224, 224] f32 (617 MB),
# labels over 1,000 classes; B=64 puts the epoch boundary at batch 16.
DATA_N, DATA_BATCH = 1024, 64
# The augmentations on the card against the host: (recipe, bound of the
# images, bound of the labels). Values moved only (flip, crop, cutout,
# cutmix's pixels) bit for bit; color jitter's means and mixup's and
# cutmix's soft labels are f32 arithmetic, within 1e-6.
AUG_CASES = {"hflip": (dict(hflip=True), 0.0, 0.0),
             "crop": (dict(crop_pad=4), 0.0, 0.0),
             "color": (dict(color_jitter=0.4), 1e-6, 0.0),
             "cutout": (dict(cutout=16), 0.0, 0.0),
             "mixup": (dict(mixup_alpha=0.8), 1e-6, 1e-6),
             "cutmix": (dict(cutmix_alpha=1.0), 0.0, 1e-6),
             "all": (dict(hflip=True, crop_pad=4, color_jitter=0.4,
                          cutout=16, mixup_alpha=0.8, cutmix_alpha=1.0),
                     1e-6, 1e-6)}


def zero_counts(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters) -> dict:
    import torch

    torch.cuda.synchronize()
    return {k: fn.launches for k, fn in counters.items() if fn.launches}


def encode_turns(outs, n: int = 20) -> dict:
    """Median ms of ``n`` encodes of ``outs`` on each tier, in turns
    Python, native, native, Python."""
    from interactive_vit_tpu_torch.wire import codec

    turns = {"python": [], "native": []}
    try:
        for tier in ("python", "native", "native", "python"):
            codec._tier = tier
            ts = []
            for _ in range(n):
                t0 = time.perf_counter()
                codec.Response(outs).encode()
                ts.append((time.perf_counter() - t0) * 1e3)
            turns[tier].append(float(np.median(ts)))
    finally:
        codec._tier = "native"
    return turns


def served_encode(device, counters) -> None:
    """The real /compute responses of ENCODE_PATHS on one bf16 server:
    each request's launches exactly its path's, the server's (native)
    bytes the Python encoder's byte for byte and ``native.pack``'s, both
    encoders timed on the same outputs, the server's decode and encode
    p50 over 10 sequential requests a path."""
    from interactive_vit_tpu_torch.models import vit
    from interactive_vit_tpu_torch.wire import codec

    tmp = tempfile.mkdtemp(prefix="ivt_chip_smoke_native_")
    try:
        graphs_dir = os.path.join(tmp, "graphs")
        shutil.copytree(os.path.join(HERE, "static", "graphs"), graphs_dir)
        app, httpd, url = serve(
            sorted({p[1] for p in ENCODE_PATHS}), "bfloat16", device,
            graphs_dir)
        try:
            if codec.native_tier() != "native":
                raise AssertionError(f"the serving process runs the "
                                     f"{codec.native_tier()} tier")
            rng = np.random.default_rng(8)
            for tag, model, side, taps, node_params, per_req in ENCODE_PATHS:
                path = Path(model, vit, vit.resolve_variant(model), side,
                            taps, {}, {}, vit_tap_shape, 0, 0)
                image = rng.random((3, side, side), dtype=np.float32)
                body = chain_request(app.graphs.load(model + ".json"), image,
                                     path.taps(), node_params)
                post(url + "/compute", body)  # its capture
                zero_counts(counters)
                raws, timing = [], []
                for _ in range(10):
                    raw, t = post_timed(url + "/compute", body)
                    raws.append(raw)
                    timing.append(t)
                seen = read_counts(counters)
                want = {k: 10 * n for k, n in per_req.items()}
                if seen != want:
                    raise AssertionError(f"encode {tag}: launches {seen}, "
                                         f"expected {want}")
                outs = codec.Response.decode(raws[-1])
                if sorted((i, ch) for i in outs for ch in outs[i]) != sorted(
                        path.taps()):
                    raise AssertionError(f"encode {tag}: taps {outs}")
                for i in outs:
                    for ch, arr in outs[i].items():
                        if not np.isfinite(arr).all():
                            raise AssertionError(f"encode {tag}: node {i} "
                                                 f"{ch} not finite")
                codec._tier = "python"
                want_bytes = codec.Response(outs).encode()
                codec._tier = "native"
                packed = codec.Response(outs).encode()
                if not (bytes(packed) == want_bytes == raws[-1]):
                    raise AssertionError(f"encode {tag}: native pack and "
                                         f"the served bytes differ from "
                                         f"the Python encoder's")
                turns = encode_turns(outs)
                py, nat = turns["python"], turns["native"]
                dec = float(np.median([t["decode"] for t in timing]))
                enc = float(np.median([t["encode"] for t in timing]))
                log(f"  encode {tag}: {len(raws[-1]) / 2 ** 20:.2f} MiB, "
                    f"{len(want_bytes)} bytes equal on both tiers and the "
                    f"served ones; Python {py[0]:.3f} / {py[1]:.3f} ms, "
                    f"native {nat[0]:.3f} / {nat[1]:.3f} ms (median of 20, "
                    f"turns P/N/N/P; native at "
                    f"{min(nat) / min(py):.2f} of Python); served p50 over "
                    f"10: decode {dec:.2f} ms, encode {enc:.2f} ms; "
                    f"launches {seen} (10 requests)")
            with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
                snap = json.loads(r.read())
            n_req = snap["counters"].get("compute_requests", 0)
            log(f"  /metrics over the phase's {n_req} requests (native "
                f"tier): decode p50 "
                f"{snap['decode_p50_ms']:.3f} ms, encode p50 "
                f"{snap['encode_p50_ms']:.3f} ms")
        finally:
            stop(app, httpd)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_loader(prefix) -> None:
    """The native loader's first 20 batches (borrowed) against the Python
    backend's, bit for bit (the epoch boundary at batch 16), then the
    native loader's rate alone."""
    from interactive_vit_tpu_torch.data.loader import Loader

    files = (prefix + "_images.npy", prefix + "_labels.npy")
    nat = Loader(*files, DATA_BATCH, seed=0, flip=True, borrow=True)
    py = Loader(*files, DATA_BATCH, seed=0, flip=True, borrow=True,
                backend="python")
    if not nat.native or py.native:
        raise AssertionError("loader backends: native "
                             f"{nat.native}, python {not py.native}")
    try:
        epochs = []
        for b in range(20):
            ai, al, ae = next(nat)
            bi, bl, be = next(py)
            if ae != be or not (np.array_equal(al, bl)
                                and ai.tobytes() == bi.tobytes()):
                raise AssertionError(f"loader batch {b}: native differs "
                                     f"from the Python backend")
            epochs.append(ae)
        if epochs != [0] * 16 + [1] * 4:
            raise AssertionError(f"loader epochs {epochs}")
    finally:
        nat.close()
    rate = Loader(*files, DATA_BATCH, seed=1, flip=True, borrow=True)
    try:
        next(rate)
        t0 = time.perf_counter()
        for _ in range(48):
            next(rate)
        dt = time.perf_counter() - t0
    finally:
        rate.close()
    mb = DATA_BATCH * 3 * 224 * 224 * 4 / 1e6
    log(f"  loader: 20 batches of {DATA_BATCH} (epoch boundary at 16) "
        f"native = Python bit for bit, borrowed; native alone "
        f"{48 / dt:.1f} batches/s ({48 * mb / dt / 1e3:.2f} GB/s, "
        f"{mb:.1f} MB a batch, 2 threads, depth 4)")


def check_augment(device) -> None:
    """Each augmentation and all six on a [64, 3, 224, 224] batch on the
    card against the same draws applied on the host; each bound refuses a
    result zeroed or halved."""
    import torch

    from interactive_vit_tpu_torch.data import augment as aug
    from interactive_vit_tpu_torch.ops import node_ops

    g = torch.Generator().manual_seed(5)
    x = torch.rand((64, 3, 224, 224), generator=g)
    y = torch.randint(0, 1000, (64,), generator=g)
    xd, yd = x.to(device), y.to(device)
    worst = {}
    for name, (kw, image_bound, label_bound) in AUG_CASES.items():
        cfg = aug.AugmentConfig(**kw)
        for step in (3, 4):  # "all": one mixup step, one cutmix step
            key = node_ops.fold_in(node_ops.prng_key(7 + 0x5EED), step)
            want = aug.augment(key, x, y, 1000, cfg)
            got = aug.augment(key, xd, yd, 1000, cfg)
            for part, a, b, bound in (
                    ("images", got[0], want[0], image_bound),
                    ("labels", got[1], want[1], label_bound)):
                a = a.cpu()
                if a.shape != b.shape or a.dtype != b.dtype:
                    raise AssertionError(f"augment {name} {part}: "
                                         f"{a.shape} {a.dtype}")
                err = float((a.double() - b.double()).abs().max())
                if not err <= bound:
                    raise AssertionError(f"augment {name} step {step} "
                                         f"{part}: {err} > {bound}")
                for bad in (a * 0.5, a * 0.0):
                    if float((bad.double() - b.double()).abs().max()
                             ) <= bound and b.abs().max() > 0:
                        raise AssertionError(f"augment {name} {part}: a "
                                             f"mutated result passed")
                worst[f"{name} {part}"] = max(
                    worst.get(f"{name} {part}", 0.0), err)
    cfg = aug.AugmentConfig(**AUG_CASES["all"][0])
    fn = aug.make_augment_fn(cfg, 1000, seed=7)
    ms = median_ms(lambda: fn(9, xd, yd), n=5)
    log(f"  augment on the card vs the host at [64, 3, 224, 224]: "
        + ", ".join(f"{k} {v:.1e}" for k, v in worst.items())
        + f" (max abs; AUG_CASES' bounds; zeroed and halved refused); all "
        f"six {ms:.2f} ms a batch (median of 5, synchronized)")


def phase_native_data(device, counters) -> None:
    """Phase 8: the native host tier and the trainer's data path (the
    module docstring, phase 8)."""
    import torch

    from interactive_vit_tpu_torch.data.loader import save_dataset
    from interactive_vit_tpu_torch.tools import evaluate
    from interactive_vit_tpu_torch.wire import codec

    t_phase = time.perf_counter()
    # 1. the build and the tier
    if codec.native_tier() != "native":
        raise AssertionError(f"codec tier {codec.native_tier()}")
    log(f"  host library {HOST_BUILD['path']}: built from the checkout's "
        f"wirecodec.cpp and dataloader.cpp in {HOST_BUILD['s']:.2f} s "
        f"(phase 2); codec tier native")
    # 2. the served encode
    served_encode(device, counters)
    tmp = tempfile.mkdtemp(prefix="ivt_chip_smoke_data_")
    try:
        # 3. the loader
        t0 = time.perf_counter()
        prefix = os.path.join(tmp, "ds")
        rng = np.random.default_rng(0)
        save_dataset(prefix, rng.random((DATA_N, 3, 224, 224),
                                        dtype=np.float32),
                     rng.integers(0, 1000, DATA_N))
        log(f"  dataset: {DATA_N} images [3, 224, 224] f32, 1000 classes, "
            f"written in {time.perf_counter() - t0:.1f} s")
        check_loader(prefix)
        # 4. the trainer through the loader
        data = ["--data", prefix, "--hflip", "--crop-pad", "4",
                "--color-jitter", "0.4", "--cutout", "16", "--mixup", "0.8",
                "--cutmix", "1.0"]
        base = ["--variant", "vit_b16", "--dtype", "mixed", "--attn", "auto",
                "--batch", str(DATA_BATCH), "--log-every", "1", *data]
        steps = 24
        res = run_train("train vit_b16 --data", base + ["--steps",
                                                        str(steps)],
                        counters, {"attention_train_packed_mma":
                                   (12 * steps, 12 * steps)})
        if res["backend"] != "native":
            raise AssertionError(f"--data loader backend {res['backend']}")
        ms = res["ms_per_step"]
        synth = SYNTH_STEP_MS.get("vit_b16")
        log(f"  train vit_b16 mixed B={DATA_BATCH} --data + all six "
            f"augmentations, {steps} steps (the epoch boundary after step "
            f"14): packed tensor-core launches "
            f"{res['counts']['attention_train_packed_mma']} (12 + 12 a "
            f"step); loss " + " ".join(f"{x:.4f}" for _, x, _ in
                                     res["history"])
            + f"; {ms:.2f} ms a step, {DATA_BATCH * 1e3 / ms:.1f} images/s "
            f"(steps 3-{steps})" + (
                f"; the synthetic run's {synth:.2f} ms (phase 5): "
                f"{ms / synth:.3f}x" if synth else ""))
        out = os.path.join(tmp, "resume")
        run_train("--data 12 steps saved", base + [
            "--steps", "12", "--output", out, "--save-every", "12"],
            counters, {"attention_train_packed_mma": (144, 144)})
        resumed = run_train("--data resumed to 24", base + [
            "--steps", str(steps), "--output", out, "--resume"], counters,
            {"attention_train_packed_mma": (144, 144)})
        if resumed["start_step"] != 12:
            raise AssertionError(f"resumed at {resumed['start_step']}")
        n = same_tree("--data resume", resumed["params"], res["params"])
        log(f"  --data resume: 12 steps saved, resumed to {steps}: the "
            f"export params bit for bit the uninterrupted run's ({n} "
            f"leaves)")
        t16 = run_train("train vit_t16 --data", [
            "--variant", "vit_t16", "--dtype", "mixed", "--batch",
            str(DATA_BATCH), "--steps", "4", "--log-every", "1", *data],
            counters, {"attention_train_mma": (48, 48)})
        log(f"  train vit_t16 mixed --data + augmentations, 4 steps: "
            f"tensor-core launches {t16['counts']['attention_train_mma']} "
            f"(12 + 12 a step); loss "
            + " ".join(f"{x:.4f}" for _, x, _ in t16["history"]))
        # 5. the augmentations on the card
        check_augment(device)
        # 6. ivt-eval
        zero_counts(counters)
        line = evaluate.main(["--variant", "vit_b16", "--data", prefix,
                              "--limit", "200", "--batch", "64"])
        keys = ["imgs_per_s", "n", "top1", "top5", "variant", "wall_s"]
        if line["n"] != 200 or sorted(line) != keys:
            raise AssertionError(f"ivt-eval: {line}")
        log(f"  ivt-eval vit_b16 --data --limit 200 --batch 64 (random "
            f"init: a smoke run): n {line['n']} (three chunks of 64 and a "
            f"tail of 8), {line['imgs_per_s']} images/s; launches "
            f"{read_counts(counters)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"  phase 8 took {time.perf_counter() - t_phase:.1f} s")


# -- phase 8b: the rest of training ----------------------------------------

# The card's name and power limit as nvidia-smi gives them (phase 1), beside
# every number a run of phase 8b logs.
CARD = {}
# The teacher, the distilled student (and its mixed first-step check), the
# MoE and the MAE encoder at B=TRAIN_BATCH; the f32 first-step gradient
# checks at B=GRAD_BATCH, the MoE's
# at B=MOE_GRAD_BATCH: its top-1 routing is discrete, so its check takes
# the first seed whose plain routing has no near tie (every routed token's
# two best gates more than MOE_TIE_GAP apart, a hundred times the ~1e-7 by
# which the kernels move a gate in f32); the patterned images have gaps of
# ~1e-5 at B=8 (measured on the CPU), fewer tokens make a tie rarer.
TRAIN_BATCH, GRAD_BATCH, MOE_GRAD_BATCH = 64, 8, 2
MOE_TIE_GAP = 1e-5


def run_line(tag, res, batch, steps, what) -> str:
    """One run's numbers on one line: its launches ``what``, the losses,
    ms a step and images/s (steps 3 on), the peak device memory, the
    card."""
    ms = res.get("ms_per_step")
    rate = (f"{ms:.2f} ms a step, {batch * 1e3 / ms:.1f} images/s (steps "
            f"{res['history'][2][0] + 1}-{steps})" if ms
            else "ms a step not measured")
    return (f"  {tag}, B={batch}, {steps} steps: {what}; loss "
            + " ".join(f"{x:.4f}" for _, x, _ in res["history"])
            + f"; {rate}; peak device memory {res['peak_gib']:.2f} GiB "
            f"above the {res['base_gib']:.2f} GiB allocated before the run "
            f"[{CARD['smi']}]")


def falls(tag, res) -> None:
    losses = [x for _, x, _ in res["history"]]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: the loss did not fall: {losses}")


def grads_of(loss_of, params):
    """(loss, the gradient of each leaf of ``params``) of
    ``loss_of(params)``; zeros where the loss does not reach a leaf."""
    import torch

    from interactive_vit_tpu_torch.parallel import train as train_lib

    leaves = [x.detach().requires_grad_(True)
              for x in train_lib.tree_leaves(params)]
    loss = loss_of(train_lib.tree_unflatten(params, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.item(), [torch.zeros_like(x) if g is None else g
                         for x, g in zip(leaves, grads)]


def kernels_vs_plain(tag, params, kernel_loss, plain_loss, heads, counters,
                     expect, rel, loss_rel) -> None:
    """One step's loss and gradients through the kernels (``kernel_loss``
    on the head-major ``params``, every count 0 just before and read just
    after: ``expect``, every other trainable-attention count 0) against
    the plain attention (``plain_loss`` on the canonical ones): the loss
    within ``loss_rel`` of max(1, |loss|), each parameter's gradient
    within ``rel`` of its largest value, a zeroed or halved gradient
    refused."""
    import torch

    from interactive_vit_tpu_torch.parallel import mesh
    from interactive_vit_tpu_torch.parallel import train as train_lib

    zero_counts(counters)
    loss_k, g_k = grads_of(kernel_loss,
                           mesh.permute_qkv_head_major(params, heads))
    torch.cuda.synchronize()
    counts = {k: fn.pair for k, fn in counters.items()
              if isinstance(fn, FwdBwdCount)}
    want = {k: expect.get(k, (0, 0)) for k in counts}
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, expected {want}")
    g_k = train_lib.tree_leaves(mesh.unpermute_qkv_head_major(
        train_lib.tree_unflatten(params, g_k), heads))
    loss_r, g_r = grads_of(plain_loss, params)
    if abs(loss_k - loss_r) > loss_rel * max(1.0, abs(loss_r)):
        raise AssertionError(f"{tag}: loss {loss_k} vs plain {loss_r}")

    def use(a, b):
        return ((a - b).abs().max() / (rel * b.abs().max())).item()

    worst = (0.0, "")
    for (path, _), a, b in zip(train_lib.tree_leaves_with_path(params), g_k,
                               g_r):
        if not b.abs().max() > 0:
            # 0 on the plain path (an expert no token reached): so on both
            if a.abs().max() > 0:
                raise AssertionError(f"{tag}: {path} is 0 on the plain path "
                                     f"only")
            continue
        u = use(a, b)
        if not u <= 1.0:
            raise AssertionError(f"{tag}: {path} at {u:.2f} of its bound")
        if not (use(a * 0.5, b) > 1.0 and use(a * 0.0, b) > 1.0):
            raise AssertionError(f"{tag}: {path} halved or zeroed passed "
                                 f"its bound")
        worst = max(worst, (u, path))
    ran = {k: v for k, v in counts.items() if v != (0, 0)}
    log(f"  {tag}: kernels ({ran}) vs plain attention: loss {loss_k:.6f} "
        f"vs {loss_r:.6f}; every parameter's gradient within {rel:g} of its "
        f"largest value, the nearest {worst[1]} at {worst[0]:.3f} of its "
        f"bound")


def phase_distill(device, counters, tmp) -> dict:
    """(h): a vit_b16 teacher exported by ``tools.train.main``, deit_b16
    distilled from it (10 steps hard, 4 soft), one profiled step, a mixed
    and an f32 soft step against the plain attention. Returns the
    main-path launches."""
    import torch

    from interactive_vit_tpu_torch.models import vit
    from interactive_vit_tpu_torch.ops import attention_vjp as av
    from interactive_vit_tpu_torch.parallel import train as train_lib
    from interactive_vit_tpu_torch.tools.convert import (
        convert, load_state_dict,
    )
    from interactive_vit_tpu_torch.tools.train import pattern_set

    b = TRAIN_BATCH
    teacher = os.path.join(tmp, "teacher.safetensors")
    common = ["--dtype", "mixed", "--batch", str(b), "--memorize", "64",
              "--log-every", "1"]
    res = run_train("train the vit_b16 teacher", [
        "--variant", "vit_b16", "--steps", "2", "--export-safetensors",
        teacher, *common], counters,
        {"attention_train_packed_mma": (24, 24)})
    log(run_line("train the vit_b16 teacher", res, b, 2,
                 f"packed tensor-core launches "
                 f"{res['counts']['attention_train_packed_mma']}, exported "
                 f"to {os.path.basename(teacher)}"))
    launches = {"attention_train_packed_mma": 0, "attention_train_mma": 0}
    distill = ["--variant", "deit_b16", "--distill-teacher", teacher,
               "--teacher-variant", "vit_b16", *common]
    for tag, steps, extra in (("hard", 10, []),
                              ("soft tau 1", 4, ["--distill-tau", "1"])):
        # the student's 12 + 12 packed launches and the teacher's 12
        # forwards of attention_train a step
        res = run_train(f"distil deit_b16 {tag}", distill + [
            "--steps", str(steps), *extra], counters,
            {"attention_train_packed_mma": (12 * steps, 12 * steps),
             "attention_train_mma": (12 * steps, 0)})
        if res["remat"] is not False or not res["head_major"]:
            raise AssertionError(f"distil {tag}: remat {res['remat']}, "
                                 f"head-major {res['head_major']}")
        falls(f"distil deit_b16 {tag}", res)
        for k in launches:
            launches[k] += sum(res["counts"][k])
        log(run_line(f"distil deit_b16 {tag} from vit_b16", res, b, steps,
                     f"student packed tensor-core launches "
                     f"{res['counts']['attention_train_packed_mma']} (12 + "
                     f"12 a step), teacher forward launches "
                     f"{res['counts']['attention_train_mma']} (12 + 0 a "
                     f"step)"))
    # one step by name: the student's forward, dq and dk/dv kernels 12
    # times each, the teacher's forward 12 more; no other kernel of the port
    cfg, tcfg = vit.VARIANTS["deit_b16"], vit.VARIANTS["vit_b16"]
    tparams = convert("vit_b16", "auto", load_state_dict(teacher),
                      device=device)
    params, state, step, _ = train_lib.setup_distill(
        cfg, tcfg, tparams, device=device, seed=1, attn_impl="auto",
        compute_dtype=torch.bfloat16)
    images, labels = pattern_set(1, b, cfg.img_size, cfg.num_classes)
    images = torch.from_numpy(images).to(device)
    labels = torch.from_numpy(labels).to(device)
    for _ in range(2):
        params, state, loss = step(params, state, images, labels)

    def one_step():
        nonlocal params, state
        params, state, loss = step(params, state, images, labels)
        float(loss)

    expect = {name: 0 for name in port_kernel_names()}
    expect.update(train_fwd_mma_kernel=24, train_dq_mma_kernel=12,
                  train_dkdv_mma_kernel=12)
    profiled(lambda: synchronized_ms(one_step),
             "distil deit_b16 mixed profile of one step", expect)
    del params, state, step

    # one soft first step (a hard target is the teacher's argmax,
    # discrete) against the plain attention on the same params and batch:
    # mixed at the main path's B=64 (the student's packed bf16 kernels at
    # N=198, the teacher's bf16 forward) within phase 5's mixed bounds;
    # f32 at B=GRAD_BATCH (the split-TF32 student and teacher forward)
    # within TRAIN_GRAD_REL
    student = vit.init_params(cfg, torch.Generator().manual_seed(3),
                              device=device)

    def distill_loss(attn, head_major, images, labels, dtype=None):
        teach = train_lib.make_teacher_fn(
            tcfg, train_lib.cast_params(tparams, dtype), attn)

        def loss_of(p):
            cls_l, dist_l = train_lib._student_logits(
                train_lib.cast_params(p, dtype), images, cfg,
                attn_impl=attn, qkv_head_major=head_major)
            return train_lib.distill_loss(cls_l, dist_l, teach(images),
                                          labels, 0.5, 1.0)

        return loss_of

    kernels_vs_plain(
        f"distil deit_b16 mixed soft first-step gradients, B={b}", student,
        distill_loss(av.trainable_flash_mhsa, True, images, labels,
                     torch.bfloat16),
        distill_loss(None, False, images, labels, torch.bfloat16),
        cfg.heads, counters,
        {"attention_train_packed_mma": (12, 12),
         "attention_train_mma": (12, 0)}, TRAIN_BF16_GRAD_REL,
        TRAIN_BF16_LOSS_REL)
    images, labels = images[:GRAD_BATCH], labels[:GRAD_BATCH]
    kernels_vs_plain(
        f"distil deit_b16 f32 soft first-step gradients, B={GRAD_BATCH}",
        student, distill_loss(av.trainable_flash_mhsa, True, images, labels),
        distill_loss(None, False, images, labels), cfg.heads, counters,
        {"attention_train_packed_tf32": (12, 12),
         "attention_train_tf32": (12, 0)}, TRAIN_GRAD_REL, 1e-5)
    return launches


def routing_margin(params, images, cfg) -> float:
    """The least gap between a token's two best gates over the MoE blocks
    of the plain forward (a gap within the kernels' rounding of the plain
    path's would let the two paths route that token apart)."""
    import torch

    from interactive_vit_tpu_torch.models import moe, vit
    from interactive_vit_tpu_torch.ops import layers as L

    margin = float("inf")
    with torch.no_grad():
        x = vit.embed(params, images, cfg)
        for i, p in enumerate(params["blocks"]):
            if cfg.is_moe(i):
                h, _ = moe.attn_ops.mhsa(L.layer_norm(
                    x, p["ln1_s"], p["ln1_b"], cfg.ln_eps), p, cfg.heads)
                h = L.layer_norm(x + h, p["ln2_s"], p["ln2_b"], cfg.ln_eps)
                top2 = moe.route(h, p["router_w"], cfg)[2].topk(2).values
                margin = min(margin, (top2[..., 0] - top2[..., 1]).min()
                             .item())
            x = moe.block(p, x, cfg, i)[0]
    return margin


def phase_moe_train(device, counters) -> dict:
    """(i): vit_moe_s16 mixed through the packed kernels, the aux term in
    the loss, an f32 step and a mixed one against the plain attention."""
    import torch

    from interactive_vit_tpu_torch.models import moe
    from interactive_vit_tpu_torch.ops import attention_vjp as av
    from interactive_vit_tpu_torch.parallel import train as train_lib
    from interactive_vit_tpu_torch.tools.train import pattern_set

    b, steps = TRAIN_BATCH, 10
    res = run_train("train vit_moe_s16", [
        "--variant", "vit_moe_s16", "--dtype", "mixed", "--batch", str(b),
        "--steps", str(steps), "--memorize", "64", "--log-every", "1"],
        counters, {"attention_train_packed_mma": (12 * steps, 12 * steps)})
    if res["remat"] is not False or not res["head_major"]:
        raise AssertionError(f"vit_moe_s16: remat {res['remat']}, "
                             f"head-major {res['head_major']}")
    falls("train vit_moe_s16", res)
    log(run_line("train vit_moe_s16 mixed", res, b, steps,
                 f"packed tensor-core (row 9) launches "
                 f"{res['counts']['attention_train_packed_mma']} (12 + 12 a "
                 f"step)"))
    cfg = moe.VARIANTS["vit_moe_s16"]
    # the seeded batch whose plain routing has no near tie (the gap
    # logged): the kernels' f32 rounding cannot move a token's expert
    for seed in range(16):
        images, labels = pattern_set(seed, MOE_GRAD_BATCH, cfg.img_size,
                                     cfg.num_classes)
        images = torch.from_numpy(images).to(device)
        labels = torch.from_numpy(labels).to(device)
        params = moe.init_params(cfg, torch.Generator().manual_seed(seed),
                                 device=device)
        margin = routing_margin(params, images, cfg)
        if margin > MOE_TIE_GAP:
            break
    else:
        raise AssertionError("vit_moe_s16: no seed of 16 routes without a "
                             "near tie")
    # the loss holds the aux term: CE + MOE_AUX_WEIGHT aux
    with torch.no_grad():
        out = moe.forward(params, images, cfg, want_aux=True)
        ce = train_lib.cross_entropy(out["logits"], labels)
        loss = train_lib.loss_fn(params, images, labels, cfg)
    aux = out["aux"].item()
    if not (aux > 0 and abs(loss.item() - ce.item()
                            - train_lib.MOE_AUX_WEIGHT * aux) < 1e-5):
        raise AssertionError(f"vit_moe_s16 loss {loss.item()} is not CE "
                             f"{ce.item()} + 0.01 aux {aux}")
    log(f"  vit_moe_s16 loss = CE {ce.item():.6f} + "
        f"{train_lib.MOE_AUX_WEIGHT} x aux {aux:.6f} (f32, seed {seed}, "
        f"least top-2 gate gap {margin:.2e})")

    def moe_loss(attn, head_major, dtype=None):
        return lambda p: train_lib.loss_fn(
            train_lib.cast_params(p, dtype), images, labels, cfg,
            attn_impl=attn, qkv_head_major=head_major)

    kernels_vs_plain(
        f"vit_moe_s16 f32 first-step gradients, B={MOE_GRAD_BATCH}", params,
        moe_loss(av.trainable_flash_mhsa, True), moe_loss(None, False),
        cfg.heads, counters, {"attention_train_packed_tf32": (12, 12)},
        TRAIN_GRAD_REL, 1e-5)
    # bf16 rounding can route a near-tied token apart: the documented MoE
    # bound (ROADMAP.md section 3), not a tighter one
    kernels_vs_plain(
        f"vit_moe_s16 mixed first-step gradients, B={MOE_GRAD_BATCH}",
        params,
        moe_loss(av.trainable_flash_mhsa, True, torch.bfloat16),
        moe_loss(None, False, torch.bfloat16), cfg.heads, counters,
        {"attention_train_packed_mma": (12, 12)}, MOE_BF16_REL,
        MOE_BF16_REL)
    return {"attention_train_packed_mma": sum(
        res["counts"]["attention_train_packed_mma"])}


def phase_plain_families(device, counters) -> None:
    """(j): swin_t and convnext_t mixed, --remat on and --no-remat, no
    kernel of the port (by count and by name), the losses of the two runs
    within train_bound; --attn flash_vjp on swin_t refused."""
    import torch

    from interactive_vit_tpu_torch.models import convnext, swin
    from interactive_vit_tpu_torch.tools import train as train_tool

    b, steps = TRAIN_BATCH, 4
    for name, cfg in (("swin_t", swin.VARIANTS["swin_t"]),
                      ("convnext_t", convnext.VARIANTS["convnext_t"])):
        runs = {}
        for flag in (["--remat", "on"], ["--no-remat"]):
            tag = f"train {name} mixed {' '.join(flag)}"
            # --memorize: the batches gathered on the card (a synthetic
            # batch is drawn by numpy on the host each step, which the
            # step time would include)
            res = run_train(tag, ["--variant", name, "--dtype", "mixed",
                                  "--batch", str(b), "--steps", str(steps),
                                  "--memorize", "64", "--log-every", "1",
                                  *flag], counters, {})
            if res["remat"] is not (flag[0] == "--remat"):
                raise AssertionError(f"{tag}: remat {res['remat']}")
            runs[flag[0]] = res
            log(run_line(tag, res, b, steps, "no kernel of the port"))
        on, off = ([x for _, x, _ in runs[k]["history"]]
                   for k in ("--remat", "--no-remat"))
        ref = torch.tensor(off)
        bound, text = train_bound(ref, torch.bfloat16)
        use = ((torch.tensor(on) - ref).abs() / bound).max().item()
        if not use <= 1.0:
            raise AssertionError(f"{name}: remat on {on} vs off {off}")
        log(f"  {name}: the losses of --remat on and --no-remat within "
            f"train_bound ({text}; {use:.3f} of it)")
        profile_train_step(cfg, device, "auto", torch.bfloat16, None,
                           f"train {name} mixed, no kernel of the port",
                           {n: 0 for n in port_kernel_names()}, batch=b)
    try:
        train_tool.main(["--variant", "swin_t", "--attn", "flash_vjp",
                         "--steps", "1", "--batch", "2"])
    except ValueError as e:
        log(f"  swin_t --attn flash_vjp refused: {e}")
    else:
        raise AssertionError("swin_t --attn flash_vjp was not refused")


# (k)'s dataset: the pretrainer's --memorize set (its default 256 images
# of 64 pattern classes) saved for --data
MAE_DATA_N, MAE_DATA_CLASSES = 256, 64


def phase_mae(device, counters, tmp) -> dict:
    """(k): mae_b16 pretrained by ``tools.pretrain.main`` through
    ``--data`` in two runs of 5 steps (saved, resumed: the loader skips
    the consumed batches) bit for bit an unbroken 10-step run, the probe,
    the exported encoder served as vit_b16 through row 1."""
    import torch

    from interactive_vit_tpu_torch.data.loader import save_dataset
    from interactive_vit_tpu_torch.models import mae
    from interactive_vit_tpu_torch.parallel import train as train_lib
    from interactive_vit_tpu_torch.tools import pretrain
    from interactive_vit_tpu_torch.tools.train import pattern_set

    b = TRAIN_BATCH
    out, enc = os.path.join(tmp, "mae"), os.path.join(tmp, "enc.safetensors")
    prefix = os.path.join(tmp, "mae_ds")
    images, labels = pattern_set(0, MAE_DATA_N, 224, 1000, MAE_DATA_CLASSES)
    save_dataset(prefix, images, labels.astype(np.int64))
    del images, labels
    base = ["--variant", "mae_b16", "--dtype", "mixed", "--batch", str(b),
            "--data", prefix, "--log-every", "1"]
    # the encoder and decoder through the plain attention: no kernel
    whole = run_train("pretrain mae_b16 10 steps", base + ["--steps", "10"],
                      counters, {}, main=pretrain.main)
    falls("pretrain mae_b16", whole)
    log(run_line("pretrain mae_b16 mixed --data", whole, b, 10,
                 "no kernel of the port (the plain attention, as in JAX)"))
    first = run_train("pretrain mae_b16 5 steps saved", base + [
        "--steps", "5", "--output", out, "--save-every", "5"], counters, {},
        main=pretrain.main)
    resumed = run_train("pretrain mae_b16 resumed to 10", base + [
        "--steps", "10", "--output", out, "--resume", "--probe",
        "--export-encoder", enc], counters, {}, main=pretrain.main)
    if first["start_step"] != 0 or resumed["start_step"] != 5:
        raise AssertionError(f"mae resume at {resumed['start_step']}")
    n = same_tree("mae_b16 resume", resumed["params"], whole["params"])
    log(run_line("pretrain mae_b16 resumed at step 5", resumed, b, 10,
                 f"the params bit for bit the unbroken run's ({n} leaves)"))
    acc, acc0 = resumed["probe"]
    log(f"  mae_b16 linear probe top-1: pretrained {acc:.3f} vs random-init "
        f"{acc0:.3f} (the dataset's {MAE_DATA_N} images of "
        f"{MAE_DATA_CLASSES} classes, 20% held out)")
    # the exported encoder as vit_b16's weights (a headless tree: its
    # head emits the CLS features), served in bf16 through row 1
    graphs_dir = os.path.join(tmp, "graphs")
    shutil.copytree(os.path.join(HERE, "static", "graphs"), graphs_dir)
    app, httpd, url = serve(["vit_b16"], "bfloat16", device, graphs_dir,
                            ckpts={"vit_b16": enc})
    ecfg = mae.resolve_variant("mae_b16").enc_cfg
    try:
        chain = oracle_chain("vit_b16", ecfg.depth)
        image = np.random.default_rng(31).random(
            (3, ecfg.img_size, ecfg.img_size), dtype=np.float32)
        body = oracle_request(chain, image)
        decoded(url, body)  # its capture
        got = one_request_counts(url, body, counters,
                                 "the MAE encoder served as vit_b16",
                                 {"fused_attn_block_mma": 12})
    finally:
        stop(app, httpd)
    feats = np.asarray(got[len(chain) - 1]["o"], np.float32).reshape(-1)
    with torch.no_grad():
        want = mae.encode(train_lib.cast_params(resumed["params"],
                                                torch.bfloat16),
                          torch.from_numpy(image)[None].to(device),
                          mae.resolve_variant("mae_b16"))[0, 0].float()
    want = want.cpu().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(feats - want).max())
    if feats.shape != (ecfg.width,) or not (
            err <= SLICE_REL * scale):
        raise AssertionError(f"served encoder: {feats.shape}, max abs err "
                             f"{err} against the encoder's CLS features")
    log(f"  the exported encoder served as vit_b16 --ckpt (bf16): 12 "
        f"fused_attn_block_mma launches a request, its CLS features within "
        f"{err:.3g} of mae.encode's on the card (bound {SLICE_REL * scale:.3g}"
        f"; SLICE_REL of max(1, scale))")
    return {"fused_attn_block_mma": 12}


def phase_rest_of_training(device, counters) -> dict:
    """Phase 8b: runs (h)-(k) (the module docstring); returns the main-path
    launches of each kernel to add to the kernels line."""
    import torch

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ivt_chip_smoke_train_")
    launches = {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    try:
        t0 = time.perf_counter()
        add(phase_distill(device, counters, tmp))
        log(f"  (h) distillation took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        add(phase_moe_train(device, counters))
        log(f"  (i) vit_moe_s16 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_plain_families(device, counters)
        log(f"  (j) swin_t and convnext_t took "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        add(phase_mae(device, counters, tmp))
        log(f"  (k) mae_b16 took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"  phase 8b took {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 8c: tracing and quantized Swin -----------------------------------

# swin_t's MLP branch by stage at 224 px: (tokens, width, hidden)
SWIN_T_MLP = ((3136, 96, 384), (784, 192, 768), (196, 384, 1536),
              (49, 768, 3072))
# the served swin_t graph's taps and node params (phase 4's swin_t path's):
# nodes 2, 3 stages.0.0 / .0.1 (shifted), 13 stages.2.5 (one window), 16
# stages.3.1 (three heads)
SWIN_TAPS = {2: ("attn",), 3: ("attn",), 13: ("attn",), 16: ("attn",)}
SWIN_NODE_PARAMS = {13: {"attn_win": "2"}, 16: {"attn_heads": "[0,11,23]"}}
# vit_b16's taps in (n): maps + rollout on 3 blocks (phase 4's)
VIT_B16_TAPS = {2: ("attn", "r"), 7: ("attn", "r"), 13: ("attn", "r")}
# row 1's kernels by name: each once a block of a vit_b16 pass
ROW1_PARTS = ("row1_qkv_mma_kernel", "row1_attn_mma_kernel",
              "proj_mma_kernel")


def row7_swin_stages(device) -> dict:
    """(l): row 7 at swin_t's four stage shapes, B=1 and 8, bf16 and f32
    (``w8a8_case``); the route takes the tensor cores at each, stages 0-1
    at chunks of 96. Returns stage 0's B=1 bf16 numbers on the tensor
    cores (the kernels line's row for the instantiation at 96)."""
    import torch

    from interactive_vit_tpu_torch.models import swin
    from interactive_vit_tpu_torch.ops import fused_mlp as fm

    cfg = swin.VARIANTS["swin_t"]
    out = None
    for s, (n, d, md) in enumerate(SWIN_T_MLP):
        if (n, d, md) != (cfg.stage_res(s) ** 2, cfg.stage_dim(s),
                          cfg.stage_dim(s) * cfg.mlp_ratio):
            raise AssertionError(f"swin_t stage {s} is not {(n, d, md)}")
        log(f"  row 7 at swin_t stage {s} ({n} x {d}, hidden {md}): chunks "
            f"of {fm.chunk_of(d)}, clusters of {fm.cluster_of(d, md)} blocks "
            f"({md // fm.cluster_of(d, md)} hidden columns each; "
            f"{fm.w8a8_mma_smem_bytes(d, md, 2)} / "
            f"{fm.w8a8_mma_smem_bytes(d, md, 4)} bytes of shared memory a "
            f"block in bf16 / f32, "
            f"{fm.max_active_clusters('w8a8', d, md, torch.bfloat16)} "
            f"clusters at once in bf16)")
        for b in (1, 8):
            for dtype in (torch.bfloat16, torch.float32):
                nums = w8a8_case(device, f"swin_t stage {s}", b, n, d, md,
                                 dtype, 31 + 8 * s + b)
                if (s, b, dtype) == (0, 1, torch.bfloat16):
                    out = nums["mma"]
    return out


def served_quant_swin(device, graphs_dir, counters) -> dict:
    """(m): swin_t served in ``--dtype int8w8a8`` and ``int8``
    (``run_path``: exact launches a request and a group, by name in the
    profiled replay, the responses against the plain path, the compiled
    path), every replay its eager pass bit for bit; then one
    ``swin_t_saliency.json`` request in int8w8a8. Returns the paths'
    launches."""
    from interactive_vit_tpu_torch.models import swin
    from interactive_vit_tpu_torch.ops import fused_mlp as fm
    from interactive_vit_tpu_torch.ops import fused_window as fw

    cfg = swin.VARIANTS["swin_t"]
    w8a8 = Path(
        "swin_t", swin, cfg, (240, 300), SWIN_TAPS,
        {"fused_mlp_w8a8_block_mma": 12, "fused_mlp_w8a8_block_mma96": 4,
         "fused_window_attn_mma": 12, "fused_mlp_w8a8_block": 0,
         "fused_window_attn": 0},
        {"window_impl": fw.fused_window_attn_reference,
         "mlp_impls": [fm.fused_mlp_w8a8_reference] * len(cfg.depths)},
        swin_tap_shape, seq=3, conc=2, check_tap=swin_check_tap,
        node_params=SWIN_NODE_PARAMS, dtype="int8w8a8", f32=False,
        profile_kernels={"w8a8_mma_kernel": 8, "w8a8_mma96_kernel": 4,
                         "w8a8_mlp_kernel": 0, "window_attn_mma_kernel": 12,
                         "row1_qkv_mma_kernel": 12, "proj_mma_kernel": 12,
                         "window_attention_kernel": 0})
    w8 = Path("swin_t", swin, cfg, (240, 300), SWIN_TAPS, {}, {},
              swin_tap_shape, seq=2, conc=0, check_tap=swin_check_tap,
              node_params=SWIN_NODE_PARAMS, dtype="int8", f32=False,
              profile_kernels={name: 0 for name in port_kernel_names()})
    launches = {}
    for path in (w8a8, w8):
        t0 = time.perf_counter()
        n_diffs = len(REPLAY_DIFFS)
        res = run_path(path, device, graphs_dir, counters)
        if len(REPLAY_DIFFS) != n_diffs:
            raise AssertionError(f"swin_t {path.dtype}: a replay is not its "
                                 f"eager pass bit for bit: "
                                 f"{REPLAY_DIFFS[n_diffs:]}")
        for k, n in res["launches"].items():
            launches[k] = launches.get(k, 0) + n
        log(f"  swin_t {path.dtype}: the path took "
            f"{time.perf_counter() - t0:.1f} s")
    quant_saliency(device, graphs_dir)
    return launches


def quant_saliency(device, graphs_dir) -> None:
    """One ``swin_t_saliency.json`` request in int8w8a8 (the W8A8 kernel
    in the main pass, the dequantized plain twins in the gradient kinds'
    replays): its first run captures, a second image's replays, and that
    replay equals the eager pass (``use_jit=False``) of the same request
    bit for bit in every tapped output."""
    import torch

    from interactive_vit_tpu_torch.graph.executor import Executor
    from interactive_vit_tpu_torch.wire.schema import graph_from_json

    rng = np.random.default_rng(27)
    images = [rng.random((3, 224, 224), dtype=np.float32) for _ in range(2)]
    app, httpd, _ = serve(["swin_t"], "int8w8a8", device, graphs_dir)
    try:
        ex = app.executor
        eager = Executor(app.reg, use_jit=False, device=device)
        obj = app.graphs.load("swin_t_saliency.json")
        names = [node_name(obj, i) for i in range(len(obj["nodes"]))]
        head = next(i for i, nm in enumerate(names) if nm.endswith(":head"))
        taps = sorted({(head, "o")} | {
            (i, GRAD_TAPS[grad_kind(nm)]) for i, nm in enumerate(names)
            if grad_kind(nm) in GRAD_TAPS})

        def graph_of(image):
            g = graph_from_json(obj)
            g.add_input(image, g.nodes[0], "o")
            return g

        t0 = time.perf_counter()
        ex.run(graph_of(images[0]), taps)
        first_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ex.run(graph_of(images[1]), taps)
        replay_ms = (time.perf_counter() - t0) * 1e3
        if not ex.last_stats.cache_hit:
            raise AssertionError("swin_t_saliency int8w8a8: the second "
                                 "request was not a replay")
        t0 = time.perf_counter()
        want = eager.run(graph_of(images[1]), taps)
        eager_ms = (time.perf_counter() - t0) * 1e3
    finally:
        stop(app, httpd)
    diff = {f"{i}/{ch}": float(np.abs(got[i][ch] - want[i][ch]).max())
            for i, ch in taps if not np.array_equal(got[i][ch], want[i][ch])}
    if diff:
        raise AssertionError(f"swin_t_saliency int8w8a8: the replay differs "
                             f"from its eager pass: {diff}")
    if not all(np.isfinite(got[i][ch]).all() for i, ch in taps):
        raise AssertionError("swin_t_saliency int8w8a8: non-finite output")
    log(f"  swin_t_saliency.json int8w8a8: {len(taps)} tapped outputs (the "
        f"head, {', '.join(names[i] for i, _ in taps if i != head)}), the "
        f"replay equal to its eager pass bit for bit; first request "
        f"(warm pass and capture) {first_s:.2f} s, replay {replay_ms:.2f} ms, "
        f"eager {eager_ms:.2f} ms (host walls)")


def node_name(obj, i) -> str:
    """Node ``i``'s kind in a saved graph's JSON."""
    inst = obj["nodes"][i]["instance"]
    return inst.get("endpoint") or inst["kind"]


def traced(run, check, what: str, tries: int = 5):
    """``run()`` under ``utils/tracing.trace`` into a fresh directory, its
    Chrome trace's events handed to ``check``, which raises on a record
    out of place and returns None when every expected record is there,
    else what is short. A short trace (CUPTI can drop a record:
    ``profiled``; one block's three row-1 records went missing from three
    traces running, in one run on the card) is taken again, up to
    ``tries`` times, after 64 device-to-device copies a try and a wait,
    and recorded in PROFILE_RETRIES.
    Returns ``check``'s result on the trace that passed."""
    import glob

    import torch

    from interactive_vit_tpu_torch.utils import tracing

    short = []
    for attempt in range(tries):
        tmp = tempfile.mkdtemp(prefix="ivt_chip_smoke_trace_")
        try:
            torch.cuda.synchronize()
            with tracing.trace(tmp):
                if attempt:
                    pad = torch.zeros(2, device="cuda")
                    for _ in range(64 * attempt):
                        pad[1:].copy_(pad[:1])
                    torch.cuda.synchronize()
                    time.sleep(0.005 * attempt)
                run()
                torch.cuda.synchronize()
            (name,) = glob.glob(os.path.join(tmp, "*.json"))
            with open(name) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        lost = check(events)
        if lost is None:
            return
        short.append(lost)
        PROFILE_RETRIES.append(f"{what}: {lost}")
        log(f"  {what}: the trace is short ({lost}): a record lost; "
            f"tracing again")
    raise AssertionError(f"{what}: each of {tries} traces was short: "
                         f"{short}")


def node_ranges(events):
    """The executor's node ranges (``n<i>_<kind>``) of a Chrome trace."""
    import re

    return [e for e in events if e.get("cat") == "user_annotation"
            and re.fullmatch(r"n\d+_\S+", e.get("name", ""))]


def row1_kernels(events):
    """(part, kernel event) of each of row 1's kernels in a trace."""
    return [(part, e) for e in events if e.get("cat") == "kernel"
            for part in ROW1_PARTS if part in e.get("name", "")]


def short_trace(events, counts) -> str:
    """What a trace short of row 1's kernels lacks, for the log: the
    kernel records against the launch calls, and where in the pass's
    kernel order (by start time) row 1's QKV kernels fall, so a missing
    block shows as a wider gap."""
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    calls = sum(1 for e in events if e.get("cat") in ("cuda_runtime",
                                                      "cuda_driver")
                and "correlation" in e.get("args", {})
                and "aunch" in e.get("name", ""))
    qkv = [i for i, e in enumerate(kernels) if ROW1_PARTS[0] in e["name"]]
    return (f"row 1's kernels {counts} of 12 each; {len(kernels)} kernel "
            f"records, {calls} launch calls; the QKV kernels at positions "
            f"{qkv}")


def check_eager_trace(events, scopes, report):
    """The eager pass's trace: one range a node, named ``scopes``; each of
    row 1's 36 launches on a launch call (runtime or driver, matched by
    correlation id) whose host interval lies inside one range, the range
    of a ``blocks.*`` node, one launch of each kernel in each block's
    range. ``report`` collects what the log prints."""
    ranges = node_ranges(events)
    names = sorted(e["name"] for e in ranges)
    if names != sorted(scopes):
        raise AssertionError(f"(n) eager trace: node ranges {names}, "
                             f"expected {sorted(scopes)}")
    kernels = row1_kernels(events)
    counts = {part: sum(1 for p, _ in kernels if p == part)
              for part in ROW1_PARTS}
    if any(n > 12 for n in counts.values()):
        raise AssertionError(f"(n) eager trace: row 1's kernels {counts}")
    if any(n < 12 for n in counts.values()):
        return short_trace(events, counts)
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    blocks = {e["name"]: [] for e in ranges if ".blocks." in e["name"]}
    apis, slack = set(), float("inf")
    for part, k in kernels:
        call = calls.get(k.get("args", {}).get("correlation"))
        if call is None:
            return f"no launch call recorded for a {part}"
        t0, t1 = call["ts"], call["ts"] + call.get("dur", 0)
        inside = [r for r in ranges
                  if r["ts"] <= t0 and t1 <= r["ts"] + r["dur"]]
        if len(inside) != 1 or inside[0]["name"] not in blocks:
            raise AssertionError(
                f"(n) eager trace: the launch call {call['name']} of a "
                f"{part} at {t0} us lies in the ranges "
                f"{[r['name'] for r in inside]}, not in one block's")
        r = inside[0]
        slack = min(slack, t0 - r["ts"], r["ts"] + r["dur"] - t1)
        blocks[r["name"]].append(part)
        apis.add(f"{call['cat']}:{call['name']}")
    if len(blocks) != 12 or any(sorted(v) != sorted(ROW1_PARTS)
                                for v in blocks.values()):
        raise AssertionError(f"(n) eager trace: row 1's launches by block "
                             f"range {blocks}")
    report.update(ranges=len(ranges), apis=sorted(apis), slack=slack,
                  kernels=sum(1 for e in events if e.get("cat") == "kernel"))
    return None


def check_replay_trace(events, report):
    """A replay's trace: row 1's kernels, 12 each, and no node range."""
    ranges = node_ranges(events)
    if ranges:
        raise AssertionError(f"(n) replay trace: node ranges "
                             f"{[e['name'] for e in ranges][:4]}...: a "
                             f"replay has no host step to range")
    kernels = row1_kernels(events)
    counts = {part: sum(1 for p, _ in kernels if p == part)
              for part in ROW1_PARTS}
    if any(n > 12 for n in counts.values()):
        raise AssertionError(f"(n) replay trace: row 1's kernels {counts}")
    if any(n < 12 for n in counts.values()):
        return short_trace(events, counts)
    report.update(kernels=sum(1 for e in events if e.get("cat") == "kernel"))
    return None


def nan_graph(zero: bool):
    """binop "/" of two equal vectors into cos: node 0 makes 0 / 0 = NaN
    when ``zero``, ones otherwise; node 1 carries it."""
    from interactive_vit_tpu_torch.graph.ir import Graph

    g = Graph()
    d = g.add_node("binop", {"op": "/"})
    c = g.add_node("cos")
    g.connect(d, "c", c, "o")
    x = np.zeros(4096, np.float32) if zero else np.ones(4096, np.float32)
    g.add_input(x, d, "a")
    g.add_input(x.copy(), d, "b")
    return g


def check_debug_nans(device) -> None:
    """``debug_nans`` on the card: on, a replay whose tap holds a NaN and a
    fresh signature's warm pass raise ``FloatingPointError`` naming node 0,
    and ``run_eager`` gives node 0 the NaN error and node 1 "eval error
    upstream"; off, the same program replays and returns the NaNs."""
    from interactive_vit_tpu_torch.graph.executor import Executor
    from interactive_vit_tpu_torch.graph.registry import Registry
    from interactive_vit_tpu_torch.ops.node_ops import register_builtin
    from interactive_vit_tpu_torch.utils import tracing

    reg = Registry()
    register_builtin(reg)
    ex = Executor(reg, device=device)
    taps = [(1, "o")]
    ex.run(nan_graph(False), taps)  # the capture, finite
    said = {}
    tracing.debug_nans(True)
    try:
        if not (ex.run(nan_graph(False), taps)[1]["o"] > 0).all():
            raise AssertionError("(n) debug_nans: a finite replay failed")
        for what, run in (
                ("a replay", lambda: ex.run(nan_graph(True), taps)),
                ("a warm pass", lambda: Executor(reg, device=device).run(
                    nan_graph(True), taps))):
            try:
                run()
            except FloatingPointError as err:
                if "node 0 (binop)" not in str(err):
                    raise AssertionError(f"(n) debug_nans, {what}: {err}")
                said[what] = str(err)
            else:
                raise AssertionError(f"(n) debug_nans, {what}: no raise")
        _, errs = Executor(reg, use_jit=False, device=device).run_eager(
            nan_graph(True))
        if (set(errs) != {0, 1} or "nan" not in errs[0]
                or errs[1] != "eval error upstream"):
            raise AssertionError(f"(n) debug_nans, run_eager: {errs}")
    finally:
        tracing.debug_nans(False)
    out = ex.run(nan_graph(True), taps)
    if not ex.last_stats.cache_hit or not np.isnan(out[1]["o"]).all():
        raise AssertionError("(n) debug_nans off: the NaN graph did not "
                             "replay its NaNs")
    log(f"  (n) debug_nans: {said['a replay']!r} on a replay, the same on a "
        f"warm pass; run_eager {errs}; off, the graph replays its NaNs")


def phase_tracing(device, graphs_dir, counters) -> dict:
    """(n): the node ranges in an eager pass's trace and none in a
    replay's, node_timings, debug_nans, vit_b16's walls with no profiler.
    Returns the traced passes' launches."""
    import torch

    from interactive_vit_tpu_torch.graph.executor import Executor, node_scope
    from interactive_vit_tpu_torch.utils import tracing

    rng = np.random.default_rng(33)
    image = rng.random((3, 224, 224), dtype=np.float32)
    app, httpd, _ = serve(["vit_b16", "swin_t"], "bfloat16", device,
                          graphs_dir)
    try:
        eager = Executor(app.reg, use_jit=False, device=device)
        obj = app.graphs.load("vit_b16.json")
        nodes = chain_graph(obj, image).nodes
        head = next(n.index for n in nodes if n.name == "vit_b16:head")
        taps = sorted({(head, "o")} | {(i, ch) for i, chs in
                                       VIT_B16_TAPS.items() for ch in chs})
        scopes = [node_scope(n.index, n.name) for n in nodes]

        def run_eager_pass():
            eager.run(chain_graph(obj, image), taps)

        def run_replay():
            app.executor.run(chain_graph(obj, image), taps)
            if not app.executor.last_stats.cache_hit:
                raise AssertionError("(n) the traced replay was a capture")

        app.executor.run(chain_graph(obj, image), taps)  # the capture
        run_eager_pass()  # warm
        for fn in counters.values():
            fn.launches = 0
        eager_rep, replay_rep = {}, {}
        traced(run_eager_pass,
               lambda ev: check_eager_trace(ev, scopes, eager_rep),
               "(n) vit_b16 eager pass trace")
        traced(run_replay, lambda ev: check_replay_trace(ev, replay_rep),
               "(n) vit_b16 replay trace")
        launches = {k: fn.launches for k, fn in counters.items()
                    if fn.launches}
        # a profiled eager pass's kernels (busy, by name) hold no node
        # range, though the ranges sit on the device's timeline too
        profiled(lambda: synchronized_ms(run_eager_pass),
                 "(n) vit_b16 profile of one eager pass",
                 {**dict.fromkeys(ROW1_PARTS, 12), scopes[2]: 0})
        log(f"  (n) tracing.trace: the eager pass's trace holds "
            f"{eager_rep['ranges']} node ranges (one a node, JAX's scope "
            f"names) and {eager_rep['kernels']} kernels; row 1's 36 launches "
            f"each inside its block's range through its launch call "
            f"({', '.join(eager_rep['apis'])}; the nearest call "
            f"{eager_rep['slack']:.1f} us from its range's edge); the "
            f"replay's trace {replay_rep['kernels']} kernels (row 1's 36 "
            f"among them) and no node range; the traced passes' launches "
            f"{launches}")
        walls = {what: median_ms(fn) for what, fn in
                 (("replay", run_replay), ("eager", run_eager_pass))}
        phase4 = next((row for row in COMPILED
                       if row[0] == "vit_b16 bfloat16"), None)
        log(f"  (n) vit_b16 with no profiler (median of 3, synchronized): "
            f"replay {walls['replay']:.2f} ms, eager {walls['eager']:.2f} ms"
            + (f"; phase 4's: replay {phase4[1]:.2f}, eager {phase4[2]:.2f}"
               if phase4 else ""))
        sobj = app.graphs.load("swin_t.json")
        timings = tracing.node_timings(eager, chain_graph(sobj, image))
        swin_wall = median_ms(lambda: eager.run(chain_graph(sobj, image),
                                                "all"))
        if sorted(timings) != list(range(len(sobj["nodes"]))):
            raise AssertionError(f"(n) node_timings: keys {sorted(timings)}")
        slow = sorted(timings, key=timings.get, reverse=True)[:3]
        log(f"  (n) node_timings of swin_t.json (bf16, eager, each node "
            f"between syncs): {len(timings)} nodes, "
            f"{sum(timings.values()) * 1e3:.2f} ms in all beside the eager "
            f"pass's wall {swin_wall:.2f} ms (median of 3, every output); "
            f"the slowest " + ", ".join(
                f"{i} ({node_name(sobj, i)}) {timings[i] * 1e3:.3f} ms"
                for i in slow))
    finally:
        stop(app, httpd)
    check_debug_nans(device)
    torch.cuda.empty_cache()
    return launches


def quant_agreement_runs() -> None:
    """(o): ``tools/quant_agreement.main`` for vit_b16 and swin_t at 2
    rounds x 16 images on the card."""
    from interactive_vit_tpu_torch.tools import quant_agreement

    for variant in quant_agreement.VARIANTS:
        rows = {r["mode"]: r for r in quant_agreement.main(
            ["--variant", variant, "--rounds", "2", "--batch", "16"])}
        if (rows["bf16"]["top1_agreement"] != 1.0
                or rows["bf16"]["logit_mae"] != 0.0):
            raise AssertionError(f"(o) {variant}: bf16 against itself "
                                 f"{rows['bf16']}")
        log(f"  (o) {variant}, 32 images: " + "; ".join(
            f"{m} top-1 agreement {r['top1_agreement']:.4f}, logit MAE "
            f"{r['logit_mae']:.5f} ({r['logit_mae_over_spread']:.4f} of the "
            f"spread)" for m, r in rows.items() if m != "bf16"))


def phase_tracing_quant_swin(device, counters):
    """Phase 8c: runs (l)-(o) (the module docstring); returns the
    main-path launches of each kernel to add to the kernels line, and the
    numbers of row 7's instantiation at chunks of 96."""
    import torch

    t_phase = time.perf_counter()
    launches = {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    t0 = time.perf_counter()
    narrow = row7_swin_stages(device)
    log(f"  (l) row 7 at swin_t's stages took "
        f"{time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="ivt_chip_smoke_8c_")
    try:
        graphs_dir = os.path.join(tmp, "graphs")
        shutil.copytree(os.path.join(HERE, "static", "graphs"), graphs_dir)
        t0 = time.perf_counter()
        add(served_quant_swin(device, graphs_dir, counters))
        log(f"  (m) quantized swin_t took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        add(phase_tracing(device, graphs_dir, counters))
        log(f"  (n) tracing took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    quant_agreement_runs()
    log(f"  (o) quant_agreement took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    log(f"  phase 8c took {time.perf_counter() - t_phase:.1f} s")
    return launches, narrow


# -- phase 8d: graph export -------------------------------------------------------

# ivt op -> the launch counters of its routes (the ToMe and chunk-of-96
# views count launches that these already count)
OP_COUNTERS = {
    "fused_attn_block": ("fused_attn_block", "fused_attn_block_mma",
                         "fused_attn_block_tf32x3", "fused_attn_block_s8",
                         "fused_attn_block_s8_mma",
                         "fused_attn_block_s8_tf32x3"),
    "headwise_attn_block": ("headwise_attn_block", "headwise_attn_block_mma",
                            "headwise_attn_block_tf32x3"),
    "flash_attention": ("flash_attention", "flash_attention_mma",
                        "flash_attention_tf32x3"),
    "flash_attention_online": ("flash_attention_online",
                               "flash_attention_online_mma",
                               "flash_attention_online_tf32x3"),
    "fused_window_attn": ("fused_window_attn", "fused_window_attn_mma",
                          "fused_window_attn_tf32x3"),
    "fused_mlp_block": ("fused_mlp_block", "fused_mlp_block_mma",
                        "fused_mlp_block_tf32x3"),
    "fused_mlp_w8a8_block": ("fused_mlp_w8a8_block",
                             "fused_mlp_w8a8_block_mma"),
}
# vit_t16_saliency.json's edits in phase 8d: saliency (node 17) on a class,
# whose index a request edits over the wire; dream (node 19) cut to one
# step: its 32 steps unroll into the program, which multiplies the program's
# nodes, and with them its export and load times, about nine-fold;
# occlusion (node 21) at stride 32: 49 positions in 2 chunks of 32, so the
# program holds 4 passes of the chain (the main pass, the unoccluded one,
# the chunks) instead of 8, 48 row-1 launches a request
SAL_PARAMS = {17: {"target": "class", "class": "3"}, 19: {"steps": "1"},
              21: {"stride": "32"}}
SAL_LAUNCHES = 48
# The graphs of phase 8d: (tag, model, --dtype, --attn, saved graph,
# node params, the program's ivt nodes, a request's launches). The three
# chain graphs are the ones the server generates into --graphs-dir.
EXPORTS = (
    ("vit_b16 bf16", "vit_b16", "bfloat16", "auto", "vit_b16", {},
     {"fused_attn_block": 12}, {"fused_attn_block_mma": 12}),
    ("vit_b16 f32", "vit_b16", "float32", "auto", "vit_b16", {},
     {"fused_attn_block": 12}, {"fused_attn_block_tf32x3": 12}),
    ("vit_b16_tome bf16", "vit_b16_tome", "bfloat16", "auto",
     "vit_b16_tome", {}, {"fused_attn_block": 12},
     {"fused_attn_block_mma": 12, "fused_attn_block_tome_mma": 12}),
    ("vit_b16 int8w8a8 int8-scores", "vit_b16", "int8w8a8", "int8-scores",
     "vit_b16", {}, {"fused_attn_block": 12, "fused_mlp_w8a8_block": 12},
     {"fused_attn_block_s8_mma": 12, "fused_mlp_w8a8_block_mma": 12}),
    ("vit_l16@384 bf16", "vit_l16", "bfloat16", "auto", "vit_l16", {},
     {"headwise_attn_block": 24}, {"headwise_attn_block_mma": 24}),
    ("dinov2_s14_reg@518 bf16", "dinov2_s14_reg", "bfloat16", "auto",
     "dinov2_s14_reg", {}, {"flash_attention": 12},
     {"flash_attention_mma": 12}),
    ("dinov2_s14_reg@742 bf16", "dinov2_s14_reg@742", "bfloat16", "auto",
     "dinov2_s14_reg@742", {}, {"flash_attention_online": 12},
     {"flash_attention_online_mma": 12}),
    ("swin_t bf16", "swin_t", "bfloat16", "auto", "swin_t", {},
     {"fused_window_attn": 12}, {"fused_window_attn_mma": 12}),
    # last: exported by a child process that starts with the phase
    ("vit_t16_saliency bf16", "vit_t16", "bfloat16", "auto",
     "vit_t16_saliency", SAL_PARAMS, {"fused_attn_block": SAL_LAUNCHES},
     {"fused_attn_block_mma": SAL_LAUNCHES}),
)
# A loaded artifact's outputs against the live replay's where the two
# programs differ in a plain op (an ATen op that torch.export records in
# another form): the served bf16 bound, within 2^-4 of each output's
# scale; f32: 1e-4 of it.
EXPORT_BF16_REL = 2.0 ** -4
EXPORT_F32_REL = 1e-4
# each exported program's captures (the count_exported_replays record)
EXPORT_CAPTURES = weakref.WeakKeyDictionary()


def count_exported_replays() -> None:
    """``count_replays`` for loaded artifacts: an ``ExportedGraph``'s
    capture records the launches its CUDA graph holds (and takes them back
    off the counters), each replay adds them, and each capture is counted
    in ``EXPORT_CAPTURES``."""
    from interactive_vit_tpu_torch.graph.export import ExportedGraph

    capture, replay = ExportedGraph._capture, ExportedGraph._replay

    def counted_capture(self):
        counters = launch_counters()
        before = [getattr(fn, a) for fn, a in counters]
        try:
            capture(self)
        finally:
            after = [getattr(fn, a) for fn, a in counters]
            for (fn, a), n in zip(counters, before):
                setattr(fn, a, n)
        RECORDED[self] = [(fn, a, y - x) for (fn, a), x, y
                          in zip(counters, before, after) if y != x]
        EXPORT_CAPTURES[self] = EXPORT_CAPTURES.get(self, 0) + 1

    def counted_replay(self):
        replay(self)
        for fn, a, n in RECORDED[self]:
            setattr(fn, a, getattr(fn, a) + n)

    ExportedGraph._capture, ExportedGraph._replay = (counted_capture,
                                                     counted_replay)


def replay_ms(replay, n: int = 20) -> float:
    """Median device-synchronized wall of one CUDA graph replay."""
    import torch

    for _ in range(3):
        replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        replay()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def live_program(ex):
    """The executor's most recently used captured program."""
    with ex._cache_lock:
        return next(reversed(ex._cache.values()))


def export_vs_live(tag, got, want, dtype_name) -> str:
    """The loaded artifact's outputs against the live replay's: bit for
    bit, or (a plain op recorded in another form) within the served
    bound of each output's scale; returns what held."""
    keys = sorted((i, ch) for i in want for ch in want[i])
    if keys != sorted((i, ch) for i in got for ch in got[i]):
        raise AssertionError(f"{tag}: outputs {sorted(got)} vs "
                             f"{sorted(want)}")
    worst, bits = 0.0, True
    rel = EXPORT_F32_REL if dtype_name == "float32" else EXPORT_BF16_REL
    for i, ch in keys:
        a, b = np.asarray(got[i][ch]), np.asarray(want[i][ch])
        if not np.isfinite(a).all() or a.shape != b.shape:
            raise AssertionError(f"{tag}: node {i} {ch} not finite or "
                                 f"shaped {a.shape} vs {b.shape}")
        if a.tobytes() == b.tobytes():
            continue
        bits = False
        scale = max(float(np.abs(b).max()), 1e-6)
        err = float(np.abs(a - b).max()) / scale
        worst = max(worst, err)
        if err > rel:
            raise AssertionError(f"{tag}: node {i} {ch} differs from the "
                                 f"live replay by {err:.3e} of its scale "
                                 f"(bound {rel:.3e})")
    return ("bit for bit" if bits else
            f"within {worst:.2e} of scale (bound {rel:.2e})")


def opcheck_cases(device):
    """{op: its arguments} at one main-path shape each, bf16: vit_b16's
    block (rows 1, 6, 7), vit_l16@384's (row 2), dinov2@518's and @742's
    attention (rows 3, 4), swin_t's stage 0 (row 5); and vit_b16's block
    parameters."""
    import torch

    from interactive_vit_tpu_torch.ops import custom_ops, quant

    gen = torch.Generator(device=device).manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16, scale=0.05, mean=0.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale
                + mean).to(dtype)

    p = random_block(768, torch.bfloat16, device, 0)
    p.update(ln2_s=rand(768, mean=1.0), ln2_b=rand(768),
             fc1_w=rand(768, 3072), fc1_b=rand(3072), fc2_w=rand(3072, 768),
             fc2_b=rand(768))
    x = rand(1, 197, 768, scale=1.0)
    hw = random_block(1024, torch.bfloat16, device, 1)
    q1 = quant.quantize_weight(p["fc1_w"], "w8a8")
    q2 = quant.quantize_weight(p["fc2_w"], "w8a8")
    cases = {
        "fused_attn_block": (x, *(p[k] for k in custom_ops.ROW1_KEYS), 12,
                             1e-6, True, True, True, [0, 6, 11], None, False,
                             0),
        "headwise_attn_block": (rand(1, 577, 1024, scale=1.0),
                                *(hw[k] for k in custom_ops.ROW1_KEYS), 16,
                                1e-6, False, True, True, None),
        "flash_attention": (*(rand(1, 6, 1374, 64, scale=1.0)
                              for _ in range(3)), True, 1374),
        "flash_attention_online": (*(rand(1, 6, 2814, 64, scale=1.0)
                                     for _ in range(3)), 2814),
        "fused_window_attn": (rand(1, 56, 56, 96, scale=1.0),
                              rand(96, 288), rand(288), rand(96, 96),
                              rand(96), 3, 7,
                              rand(3, 49, 49, dtype=torch.float32), None,
                              False, True),
        "fused_mlp_block": (x, *(p[k] for k in custom_ops.MLP_KEYS), 1e-6),
        "fused_mlp_w8a8_block": (
            x, p["ln2_s"], p["ln2_b"], q1[quant.AQKEY], q1[quant.ASKEY],
            p["fc1_b"], q2[quant.AQKEY], q2[quant.ASKEY], p["fc2_b"], 1e-6),
    }
    return cases, p


def export_opcheck(device) -> None:
    """(p) ``torch.library.opcheck`` of every ivt op at one main-path shape
    (its schema and its fake implementation against the card's kernel),
    and the dispatcher's cost: the op's wrapper against its CUDA body
    called directly, host time a call."""
    import torch

    from interactive_vit_tpu_torch.ops import (
        custom_ops, fused_block as fb, fused_mlp as fm,
    )

    cases, p = opcheck_cases(device)
    x = cases["fused_attn_block"][0]
    for name, args in cases.items():
        torch.library.opcheck(getattr(torch.ops.ivt, name).default, args,
                              test_utils=("test_schema", "test_faketensor"))
    torch.cuda.synchronize()
    log(f"  (p) opcheck (test_schema, test_faketensor) of "
        f"{len(cases)} ops passed: ivt::{', ivt::'.join(custom_ops.ROWS)}")

    # the dispatcher's cost: the same launch through the op and direct
    route = fb._block_route_of(x, p, 12)
    kw = dict(want_attn=False, want_mean=False, fast_softmax=True,
              attn_heads=None, key_bias=None, want_metric=False)

    def host_us(fn, n=200):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return host

    with torch.inference_mode():
        turns = [host_us(lambda: fb.fused_attn_block(x, p, 12, 1e-6)),
                 host_us(lambda: fb._launch_counted(route, False, x, p, 12,
                                                    1e-6, True, kw)),
                 host_us(lambda: fb._launch_counted(route, False, x, p, 12,
                                                    1e-6, True, kw)),
                 host_us(lambda: fb.fused_attn_block(x, p, 12, 1e-6))]
        mturns = [host_us(lambda: fm.fused_mlp_block(x, p, 1e-6)),
                  host_us(lambda: fm.mlp_launch(x, p, 1e-6)),
                  host_us(lambda: fm.mlp_launch(x, p, 1e-6)),
                  host_us(lambda: fm.fused_mlp_block(x, p, 1e-6))]
    via, direct = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    mvia, mdirect = (mturns[0] + mturns[3]) / 2, (mturns[1] + mturns[2]) / 2
    EXPORT_NUMS["dispatch"] = (via, direct, mvia, mdirect)
    log(f"  (p) host time a call at vit_b16 B=1 bf16, through the op vs "
        f"its CUDA body direct (turns op, direct, direct, op; 200 calls "
        f"each): row 1 {via:.1f} vs {direct:.1f} us ({via - direct:+.1f}), "
        f"row 6 {mvia:.1f} vs {mdirect:.1f} us ({mvia - mdirect:+.1f}) "
        f"[{CARD['smi']}]")


# phase 8d's numbers for the summary line
EXPORT_NUMS = {}


def artifact_dir(tmp, spec) -> str:
    return os.path.join(tmp, spec[4].replace("@", "_") + "_" + spec[2])


# A child process that exports a graph on the card beside the parent's
# work: (q)'s gradient graph, whose trace and save are host-bound Python
# that takes minutes, is exported while the parent takes the other graphs.
EXPORT_CHILD = """
import json, sys, time
import numpy as np
from interactive_vit_tpu_torch.graph.export import export_graph
from interactive_vit_tpu_torch.serving.server import build_app
from interactive_vit_tpu_torch.wire.schema import graph_from_json
(device, model, dtype_name, attn, graph, params, graphs_dir, image,
 out) = sys.argv[1:]
app = build_app(models=[model], graphs_dir=graphs_dir, dtype_name=dtype_name,
                device=device, attn_impl_name=attn)
obj = app.graphs.load(graph + ".json")
g = graph_from_json(obj)
for i, p in json.loads(params).items():
    g.nodes[int(i)].params.update(p)
g.add_input(np.load(image), g.nodes[0], "o")
t0 = time.perf_counter()
export_graph(g, out, taps="primary", executor=app.executor, client_graph=obj,
             provenance={"graph": graph + ".json", "dtype": dtype_name})
print(json.dumps({"export_s": time.perf_counter() - t0}))
app.close()
"""


def export_in_child(spec, device, graphs_dir, tmp, image):
    """Start ``EXPORT_CHILD`` for one graph of ``EXPORTS`` (its own app,
    the same seeded weights as the parent's), its output in files under
    ``tmp``; ``export_one`` waits for it."""
    path = os.path.join(tmp, "child_image.npy")
    np.save(path, image)
    _, model, dtype_name, attn, graph, params = spec[:6]
    with open(os.path.join(tmp, "child.out"), "w") as out, \
            open(os.path.join(tmp, "child.err"), "w") as err:
        return subprocess.Popen(
            [sys.executable, "-c", EXPORT_CHILD, str(device), model,
             dtype_name, attn, graph, json.dumps(params), graphs_dir, path,
             artifact_dir(tmp, spec)], cwd=HERE, stdout=out, stderr=err)


def export_one(spec, device, graphs_dir, counters, tmp, image, child=None):
    """(q) one graph of ``EXPORTS``: the live app's replay (launches,
    outputs, device replay wall), the export (seconds, MB; by ``child``, a
    process of ``export_in_child``, where given), the load, the loaded
    artifact's first call (eager pass and capture) and replay (launches
    equal to the live replay's, outputs against the live replay's,
    selftest, device replay wall). Returns (app, artifact dir, the graph
    JSON, the artifact) for the server step."""
    import torch

    from interactive_vit_tpu_torch.graph.export import (
        export_graph, load_artifact,
    )
    from interactive_vit_tpu_torch.ops import custom_ops
    from interactive_vit_tpu_torch.serving.server import build_app

    tag, model, dtype_name, attn, graph, params, want_ops, want_launch = spec
    app = build_app(models=[model], graphs_dir=graphs_dir,
                    dtype_name=dtype_name, device=device,
                    attn_impl_name=attn)
    obj = app.graphs.load(graph + ".json")
    g = chain_graph(obj, image, params)
    ex = app.executor
    ex.run(g, taps="primary")  # the capture
    zero_counts(counters)
    live = ex.run(chain_graph(obj, image, params), taps="primary")
    live_counts = read_counts(counters)
    if live_counts != want_launch:
        raise AssertionError(f"{tag}: the live replay launched "
                             f"{live_counts}, expected {want_launch}")
    live_ms = replay_ms(live_program(ex).graph.replay)

    d = artifact_dir(tmp, spec)
    if child is None:
        t0 = time.perf_counter()
        export_graph(chain_graph(obj, image, params), d, taps="primary",
                     executor=ex, client_graph=obj,
                     provenance={"graph": graph + ".json",
                                 "dtype": dtype_name})
        export_s = time.perf_counter() - t0
    else:
        child.wait(timeout=900)
        with open(os.path.join(tmp, "child.out")) as f:
            out = f.read()
        if child.returncode != 0:
            with open(os.path.join(tmp, "child.err")) as f:
                raise AssertionError(f"{tag}: the exporting process failed: "
                                     f"{f.read()[-4000:]}")
        export_s = json.loads(out.strip().splitlines()[-1])["export_s"]
    mb = sum(os.path.getsize(os.path.join(d, f))
             for f in os.listdir(d)) / 1e6
    t0 = time.perf_counter()
    art = load_artifact(d)
    load_s = time.perf_counter() - t0
    if art.manifest["platforms"] != [torch.device(device).type]:
        raise AssertionError(f"{tag}: platforms {art.manifest['platforms']}")
    ops = custom_ops.count_ivt_nodes(art._module.graph)
    if ops != want_ops:
        raise AssertionError(f"{tag}: the program holds {ops}, expected "
                             f"{want_ops}")
    t0 = time.perf_counter()
    first = art(image)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    zero_counts(counters)
    got = art(image)
    art_counts = read_counts(counters)
    if art_counts != live_counts:
        raise AssertionError(f"{tag}: the loaded replay launched "
                             f"{art_counts}, the live replay {live_counts}")
    held = export_vs_live(tag, got, live, dtype_name)
    export_vs_live(tag + " (first call)", first, live, dtype_name)
    st = art.selftest()
    if not st["ok"]:
        raise AssertionError(f"{tag}: selftest failed: {st['worst']}")
    art_ms = replay_ms(art._replay)
    EXPORT_NUMS.setdefault("rows", []).append(
        (tag, export_s, mb, load_s, first_s, art_ms, live_ms))
    log(f"  (q) {tag}: program {ops}; export {export_s:.2f} s, "
        f"{mb:.1f} MB, load {load_s:.2f} s, first call (eager pass + "
        f"capture) {first_s:.2f} s; replay {art_ms:.3f} ms vs live "
        f"{live_ms:.3f} ms ({art_ms / live_ms:.3f}x); launches a replay "
        f"{art_counts} = live; outputs {held}; selftest worst rel "
        f"{st['worst']['rel']:.1e}")
    return app, d, obj, art


def export_servers(device, arts, counters, image) -> None:
    """(r) a --from-export server (``build_export_app``) over the vit_b16
    bf16 and vit_t16_saliency artifacts that (q) loaded, beside the live
    server: a vit_b16
    /compute's response bytes equal the live server's, a saliency class
    edit over the wire is served by the artifact's captured program (no
    capture) and equals the live server's, and 20 sequential vit_b16
    requests a server give the client p50s."""
    import torch

    from interactive_vit_tpu_torch.serving.server import (
        build_app, build_export_app,
    )

    from interactive_vit_tpu_torch.serving import export_app

    b16, sal = arts["vit_b16 bf16"], arts["vit_t16_saliency bf16"]
    # the server's app over the artifacts (q) loaded already: a load of
    # the saliency program takes as long as its export's save
    loaded = {d: art for art, d, _ in arts.values()}
    load = export_app.ExportedGraph
    export_app.ExportedGraph = lambda path: loaded.get(path) or load(path)
    try:
        xapp = build_export_app([b16[1], sal[1]], selftest=True)
    finally:
        export_app.ExportedGraph = load
    live = build_app(models=["vit_b16", "vit_t16"], dtype_name="bfloat16",
                     device=device, graphs_dir=None)
    servers = [xapp.serve("127.0.0.1", 0, background=True),
               live.serve("127.0.0.1", 0, background=True)]
    try:
        xurl, lurl = (f"http://127.0.0.1:{s.server_address[1]}"
                      for s in servers)

        def taps_of(art_dir):
            unit = next(u for u in xapp.units if u.artifact_dir == art_dir)
            return unit, sorted(unit.art.out_keys,
                                key=lambda k: f"{k[0]}/{k[1]}")

        unit, taps = taps_of(b16[1])
        body = chain_request(b16[2], image, taps)
        for _ in range(2):  # the live capture, then a replay each
            xraw, lraw = post(xurl + "/compute", body), post(
                lurl + "/compute", body)
        if xraw != lraw:
            raise AssertionError("vit_b16 bf16: the --from-export response "
                                 "bytes differ from the live server's")
        sunit, staps = taps_of(sal[1])
        s_idx = 17
        for cls in ("3", "5"):
            sbody = chain_request(sal[2], image, staps, {
                **SAL_PARAMS, s_idx: {"target": "class", "class": cls}})
            graph_before = sunit.art._graph
            caps_before = EXPORT_CAPTURES.get(sunit.art, 0)
            zero_counts(counters)
            xs = decoded(xurl, sbody)
            xcounts = read_counts(counters)
            post(lurl + "/compute", sbody)  # the live capture of a class
            ls = decoded(lurl, sbody)
            if cls == "5" and (sunit.art._graph is not graph_before
                               or EXPORT_CAPTURES.get(sunit.art, 0)
                               != caps_before):
                raise AssertionError("saliency class edit: the artifact "
                                     "captured again")
            export_vs_live(f"vit_t16_saliency class {cls} over the wire",
                           xs, ls, "bfloat16")
            if cls == "5" and xcounts != {"fused_attn_block_mma":
                                          SAL_LAUNCHES}:
                raise AssertionError(f"saliency class edit launched "
                                     f"{xcounts}")

        def p50(url, n=20):
            times = []
            for _ in range(n):
                t0 = time.perf_counter()
                post(url + "/compute", body)
                times.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(times))

        x50, l50, x50b, l50b = p50(xurl), p50(lurl), p50(lurl), p50(xurl)
        EXPORT_NUMS["p50"] = ((x50 + x50b) / 2, (l50 + l50b) / 2)
        log(f"  (r) --from-export vit_b16 bf16 + vit_t16_saliency (selftests "
            f"ok): /compute bytes equal to the live server's; a saliency "
            f"class edit 3 -> 5 replayed the artifact's program "
            f"({SAL_LAUNCHES} row-1 launches, no capture) and equals the "
            f"live server's; client "
            f"p50 of 20 sequential vit_b16 requests (turns export, live, "
            f"live, export): --from-export {EXPORT_NUMS['p50'][0]:.2f} ms, "
            f"live {EXPORT_NUMS['p50'][1]:.2f} ms [{CARD['smi']}]")
    finally:
        for s in servers:
            s.shutdown()
        live.close()
        del xapp
        torch.cuda.empty_cache()


def export_subprocess(art_dir, image):
    """(s) the vit_b16 artifact loaded and run in a fresh interpreter that
    imports no model code, started (a ``Popen``, with its start time) to
    run beside the other exports; ``export_subprocess_check`` waits for
    it."""
    code = f"""
import sys, numpy as np
from interactive_vit_tpu_torch.graph.export import load_artifact
art = load_artifact({art_dir!r})
out = art(np.load({art_dir + '/image.npy'!r}))
np.savez({art_dir + '/sub.npz'!r}, **{{f"{{i}}/{{ch}}": v for i, c in out.items() for ch, v in c.items()}})
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("interactive_vit_tpu_torch.models")
             or m in ("interactive_vit_tpu_torch.graph.registry",
                      "interactive_vit_tpu_torch.ops.node_ops"))
assert not bad, bad
print("clean")
"""
    np.save(os.path.join(art_dir, "image.npy"), image)
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=HERE), time.perf_counter()


def export_subprocess_check(started, art_dir, want) -> None:
    """(s)'s end: the fresh interpreter's outputs equal this process's
    artifact's."""
    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0 or stdout.strip() != "clean":
        raise AssertionError(f"the subprocess load failed: {stderr}")
    with np.load(os.path.join(art_dir, "sub.npz")) as sub:
        got = {}
        for key in sub.files:
            i, ch = key.split("/", 1)
            got.setdefault(int(i), {})[ch] = sub[key]
    held = export_vs_live("the subprocess's vit_b16 bf16", got, want,
                          "bfloat16")
    log(f"  (s) a fresh interpreter loaded and ran the vit_b16 bf16 "
        f"artifact with no model module imported in "
        f"{time.perf_counter() - t0:.1f} s (beside the other exports): its "
        f"{sum(len(c) for c in got.values())} outputs "
        f"{held} this process's")


def phase_export(device, counters) -> None:
    """Phase 8d: runs (p)-(s) (the module docstring)."""
    import torch

    t_phase = time.perf_counter()
    count_exported_replays()
    export_opcheck(device)
    image = np.random.default_rng(28).random((3, 224, 224),
                                             dtype=np.float32)
    tmp = tempfile.mkdtemp(prefix="ivt_chip_smoke_8d_")
    child = sub = None
    try:
        graphs_dir = os.path.join(tmp, "graphs")
        shutil.copytree(os.path.join(HERE, "static", "graphs"), graphs_dir)
        keep = {}
        # the gradient graph's export runs in a child process from the
        # start; its row of EXPORTS comes last
        grad = EXPORTS[-1]
        child = export_in_child(grad, device, graphs_dir, tmp, image)
        for spec in EXPORTS:
            t0 = time.perf_counter()
            app, d, obj, art = export_one(
                spec, device, graphs_dir, counters, tmp, image,
                child if spec is grad else None)
            if spec[0] in ("vit_b16 bf16", "vit_t16_saliency bf16"):
                keep[spec[0]] = (art, d, obj)
            if spec[0] == "vit_b16 bf16":
                b16_want = art(image)
                # (s) starts now, beside the other exports
                sub = export_subprocess(d, image)
            app.close()
            del app, art
            torch.cuda.empty_cache()
            log(f"      ({time.perf_counter() - t0:.1f} s)")
        export_servers(device, keep, counters, image)
        export_subprocess_check(sub, keep["vit_b16 bf16"][1], b16_want)
        keep.clear()
    finally:
        for proc in (child, sub and sub[0]):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    rows = EXPORT_NUMS["rows"]
    log("  export summary (s, MB, s, s, ms, ms): graph, export, artifact, "
        "load, first call, loaded replay, live replay [" + CARD["smi"] + "]")
    for tag, es, mb, ls, fs, am, lm in rows:
        log(f"    {tag}: {es:.2f}, {mb:.1f}, {ls:.2f}, {fs:.2f}, {am:.3f}, "
            f"{lm:.3f}")
    log(f"  phase 8d took {time.perf_counter() - t_phase:.1f} s")



# -- phase 8e: the mesh ------------------------------------------------------------

# (a)'s run: vit_b16 @224 mixed at phase 8b's batch, three steps
MESH_STEPS = 3
# (c)'s attention shape: dinov2_s14_reg@518's (B, heads, N, dh), f32
SP_SHAPE = (1, 6, 1374, 64)
SP_BOUND = 1e-5


def _torchrun_start(nproc, module, argv, env=None):
    """``python -m torch.distributed.run --standalone --nproc-per-node
    nproc -m module argv`` from the checkout, started (a ``Popen``)."""
    run_env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
                   + os.environ.get("PYTHONPATH", ""), **(env or {}))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", module, *argv],
        cwd=HERE, env=run_env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _torchrun_wait(tag, proc, timeout=600):
    """(stdout, stderr) of a ``_torchrun_start`` launch; raises on a
    non-zero exit (the tail of its output in the message), and kills it
    past ``timeout``."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: exit {proc.returncode}: "
                             f"{(out + err)[-3000:]}")
    return out, err


def _torchrun(tag, nproc, module, argv, env=None, timeout=600):
    """``_torchrun_start`` and ``_torchrun_wait``."""
    return _torchrun_wait(tag, _torchrun_start(nproc, module, argv, env),
                          timeout)


def mesh_steps(device, counters, tmp) -> dict:
    """(a) and (c) on a one-rank NCCL group; returns the main-path
    launches of (a)'s sharded steps."""
    import torch
    import torch.distributed as dist

    from interactive_vit_tpu_torch.models import vit
    from interactive_vit_tpu_torch.ops.attention import attention_reference
    from interactive_vit_tpu_torch.parallel import mesh as mesh_lib
    from interactive_vit_tpu_torch.parallel import train as train_lib
    from interactive_vit_tpu_torch.parallel.sequence import (
        ring_attention, ulysses_attention,
    )

    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(tmp, 'rdzv')}", rank=0,
        world_size=1, device_id=device)
    try:
        mesh = mesh_lib.make_mesh({"data": 1, "model": 1})
        if mesh_lib.mesh_shape(mesh) != {"data": 1, "model": 1}:
            raise AssertionError(f"mesh {mesh_lib.mesh_shape(mesh)}")
        cfg = vit.VARIANTS["vit_b16"]
        b = TRAIN_BATCH
        g = torch.Generator().manual_seed(5)
        batches = [(torch.randn((b, 3, 224, 224), generator=g).to(device),
                    torch.randint(0, cfg.num_classes, (b,),
                                  generator=g).to(device))
                   for _ in range(MESH_STEPS)]
        kw = dict(seed=1, attn_impl="auto", remat=False,
                  compute_dtype=torch.bfloat16)
        rows = mesh_lib.batch_sharding(mesh)

        def run(setup_fn, *args, **extra):
            params, state, step, _ = setup_fn(cfg, *args, **kw, **extra)
            losses = []
            for images, labels in batches:
                params, state, loss = step(params, state, rows(images),
                                           rows(labels))
                losses.append(loss)
            torch.cuda.synchronize()
            return params, losses

        ref_params, ref_losses = run(train_lib.setup, device=device)
        for fn in counters.values():  # the mesh path starts here
            fn.launches = 0
        params, losses = run(train_lib.setup_sharded, mesh)
        counts = {k: (fn.pair if isinstance(fn, FwdBwdCount)
                      else fn.launches) for k, fn in counters.items()}
        want = {k: (0, 0) if isinstance(fn, FwdBwdCount) else 0
                for k, fn in counters.items()}
        want["attention_train_packed_mma"] = (12 * MESH_STEPS,
                                              12 * MESH_STEPS)
        if counts != want:
            raise AssertionError(f"mesh steps: launches {counts}, expected "
                                 f"{want}")
        same_loss = all(torch.equal(a, b) for a, b in zip(losses,
                                                          ref_losses))
        diff = [path for (path, a), c in zip(
            train_lib.tree_leaves_with_path(params),
            train_lib.tree_leaves(ref_params)) if not torch.equal(a, c)]
        if not same_loss or diff:
            raise AssertionError(
                f"mesh steps: losses {[x.item() for x in losses]} vs "
                f"{[x.item() for x in ref_losses]}; params not bit-equal: "
                f"{diff[:5]}")
        log(f"  (a) vit_b16 @224 mixed, B={b}, one-rank NCCL mesh "
            f"data=1,model=1: {MESH_STEPS} setup_sharded steps equal "
            f"{MESH_STEPS} setup steps bit for bit (losses "
            + " ".join(f"{x.item():.6f}" for x in losses)
            + f", every param); packed tensor-core launches "
            f"{counts['attention_train_packed_mma']} (12 + 12 a step), "
            f"every other kernel 0")

        def profile_step(attn, tag, expect):
            p, st, step, _ = train_lib.setup_sharded(
                cfg, mesh, seed=1, attn_impl=attn, remat=False,
                compute_dtype=torch.bfloat16)
            images, labels = batches[0]
            for _ in range(2):
                p, st, _ = step(p, st, images, labels)

            def one():
                nonlocal p, st
                p, st, loss = step(p, st, images, labels)
                float(loss)

            return profiled(lambda: synchronized_ms(one), tag, expect)

        profile_step("auto", "mesh vit_b16 mixed, kernels: one sharded step",
                     TRAIN_MMA_PROFILE)
        for fn in counters.values():
            fn.launches = 0
        profile_step("reference", "mesh vit_b16 mixed, plain attention: one "
                     "sharded step", {k: 0 for k in TRAIN_MMA_PROFILE})
        plain = {k: fn.launches for k, fn in counters.items()
                 if fn.launches}
        if plain:
            raise AssertionError(f"mesh plain-attention steps launched "
                                 f"{plain}")
        log("  (a) the sharded step through the plain attention launched no "
            "kernel of the port (by count and by name)")
        mesh_launches = {"attention_train_packed_mma": sum(
            counts["attention_train_packed_mma"])}

        # (c) ring and Ulysses against the plain attention
        gq = torch.Generator().manual_seed(9)
        q, k, v = (torch.randn(SP_SHAPE, generator=gq).to(device)
                   for _ in range(3))
        ref = attention_reference(q, k, v, True)
        for tag, fn in (("ring", lambda: (ring_attention(
                q, k, v, mesh, axis="data"), None)),
                        ("ulysses", lambda: ulysses_attention(
                            q, k, v, mesh, axis="data", want_attn=True))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, probs = fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            err = (out - ref[0]).abs().max().item()
            perr = 0.0 if probs is None else (
                probs - ref[1]).abs().max().item()
            if not (err <= SP_BOUND and perr <= SP_BOUND):
                raise AssertionError(f"(c) {tag}: max abs err {err}, probs "
                                     f"{perr} (bound {SP_BOUND})")
            log(f"  (c) {tag} attention on the one-rank mesh at "
                f"dinov2_s14_reg@518's shape {SP_SHAPE} f32: max abs err "
                f"{err:.3g}" + ("" if probs is None else
                                f", probs {perr:.3g}")
                + f" (bound {SP_BOUND:g}); first call {ms:.1f} ms "
                f"(synchronized wall, {CARD['smi']})")
        return mesh_launches
    finally:
        dist.destroy_process_group()


def mesh_cli(device, counters, tmp) -> None:
    """(b): the trainer under torchrun with --mesh data=1 against the same
    run in this process without torchrun (the logged losses equal), then
    ivt-eval --mesh data=1 on the mesh run's checkpoint against
    ``evaluate.main`` in this process (the metrics equal; its launches
    counted here)."""
    import re

    from interactive_vit_tpu_torch.tools import evaluate
    from interactive_vit_tpu_torch.tools import train as train_tool

    argv = ["--variant", "vit_t16", "--dtype", "bfloat16", "--batch",
            str(TRAIN_BATCH), "--steps", "3", "--memorize", "64",
            "--log-every", "1"]
    out_dir = os.path.join(tmp, "mesh_ckpt")
    t0 = time.perf_counter()
    _, err = _torchrun("(b) torchrun train", 1,
                       "interactive_vit_tpu_torch.tools.train",
                       [*argv, "--mesh", "data=1", "--output", out_dir])
    t_run = time.perf_counter() - t0
    logged = re.findall(r"step\s+\d+\s+loss\s+([-\d.]+)", err)
    res = train_tool.main(argv)
    local = [f"{x:.6f}" for _, x, _ in res["history"]]
    if logged != local:
        raise AssertionError(f"(b) torchrun --mesh data=1 losses {logged} "
                             f"vs one process {local}")
    log(f"  (b) torchrun --nproc-per-node 1 tools.train --mesh data=1 "
        f"(vit_t16 bf16 through row 8, B={TRAIN_BATCH}, 3 steps): logged "
        f"losses "
        f"{' '.join(logged)} equal the run without torchrun; "
        f"{t_run:.1f} s with the launch and the checkpoint")
    ev = ["--variant", "vit_t16", "--ckpt", os.path.join(out_dir, "params"),
          "--memorize", "64", "--batch", "32", "--dtype", "bfloat16"]
    stdout, _ = _torchrun("(b) torchrun ivt-eval", 1,
                          "interactive_vit_tpu_torch.tools.evaluate",
                          [*ev, "--mesh", "data=1"])
    got = [json.loads(x) for x in stdout.splitlines() if x.startswith("{")]
    for fn in counters.values():
        fn.launches = 0
    want = evaluate.main(ev)
    ran = {k: fn.launches for k, fn in counters.items() if fn.launches}
    if len(got) != 1 or any(got[0][k] != want[k]
                            for k in ("n", "top1", "top5")):
        raise AssertionError(f"(b) ivt-eval --mesh data=1 {got} vs {want}")
    log(f"  (b) ivt-eval --mesh data=1 on that checkpoint: n {want['n']}, "
        f"top-1 {want['top1']}, top-5 {want['top5']}, equal to the run "
        f"without torchrun; its forward is the plain vit.forward: "
        f"launches of the port's kernels {ran or 'none'}")


def mesh_dryrun(proc, t0) -> None:
    """(d): the four-rank gloo dry run on this machine's CPU (``proc``,
    started at ``t0`` beside phases 8e and 8f); its case lines printed,
    the serving cases' among them."""
    stdout, _ = _torchrun_wait("(d) gloo dry run", proc)
    lines = [x for x in stdout.splitlines() if x.startswith("dryrun")]
    if not lines or not lines[-1].startswith("dryrun_multichip ok") \
            or not any(x.startswith("dryrun serving: ok") for x in lines):
        raise AssertionError(f"(d) dry run: {stdout[-2000:]}")
    for line in lines:
        log(f"  (d) {line}")
    log(f"  (d) the four-rank gloo dry run took "
        f"{time.perf_counter() - t0:.1f} s, beside phases 8e and 8f")


def start_dryrun():
    """(d): the four-rank gloo dry run (``tools/dryrun_multichip``, its
    training and serving cases) on this machine's CPU, started (a
    ``Popen``) to run beside phases 8e and 8f."""
    return _torchrun_start(4, "interactive_vit_tpu_torch.tools."
                           "dryrun_multichip", ["--device", "cpu"],
                           env={"OMP_NUM_THREADS": "1"})


def phase_mesh(device, counters) -> dict:
    """Phase 8e: runs (a)-(c) (the module docstring; (d), the dry run, runs
    beside it and phase 8f, which waits for it); returns the main-path
    launches of (a) to add to the kernels line."""
    import torch

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ivt_chip_smoke_mesh_")
    try:
        t0 = time.perf_counter()
        launches = mesh_steps(device, counters, tmp)
        log(f"  (a) and (c) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mesh_cli(device, counters, tmp)
        log(f"  (b) took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"  phase 8e took {time.perf_counter() - t_phase:.1f} s "
        f"({CARD['smi']})")
    return launches


# -- phase 8f: serving on the mesh ------------------------------------------------

# the served path: vit_b16 from the repository's saved graph with phase 4's
# taps (maps and rollout of blocks 0, 5, 11 and the head)
MESH_SERVE_TAPS = [(2, "attn"), (2, "r"), (7, "attn"), (7, "r"),
                   (13, "attn"), (13, "r"), (15, "o")]
# sequential requests, then one group of MESH_SERVE_GROUP at once (the
# group collects in a 200 ms window); each is one pass of the path
MESH_SERVE_REQUESTS = 3
MESH_SERVE_GROUP = 4
# each dtype's route of row 1: its launches a pass (a request alone or a
# group), every other kernel none
MESH_SERVE_KERNELS = {"bfloat16": "fused_attn_block_mma",
                      "float32": "fused_attn_block_tf32x3"}
MESH_SERVE_ARGV = ["--models", "vit_b16", "--max-batch",
                   str(MESH_SERVE_GROUP), "--max-wait-ms", "200"]


def counter_key(fn, attr: str = "launches") -> str:
    """A launch counter's name across processes: its wrapper's module and
    name, and the attribute."""
    return f"{fn.__module__}:{fn.__qualname__}.{attr}"


def counted_server(counts_path: str, argv) -> int:
    """Phase 8f's server process, ``chip_smoke.py --counted-server COUNTS
    ARGV``: ``serving/server.main(argv)`` (under ``torchrun`` where ARGV
    has ``--mesh``) with the compiled path's launches counted as phase 4
    counts them (``count_replays``) and, after each executor call, every
    launch counter of the port written to COUNTS (a JSON object, replaced
    whole)."""
    from interactive_vit_tpu_torch.graph.executor import Executor
    from interactive_vit_tpu_torch.serving import server

    count_replays()
    found = {"modules": -1, "counters": []}

    def dump():
        # the counters are looked up again only when a module was loaded
        # since (a scan of every module is a millisecond a call)
        loaded = len(sys.modules)
        if loaded != found["modules"]:
            found.update(modules=loaded, counters=launch_counters())
        counts = {counter_key(fn, a): getattr(fn, a)
                  for fn, a in found["counters"]}
        with open(counts_path + ".tmp", "w") as f:
            json.dump(counts, f)
        os.replace(counts_path + ".tmp", counts_path)

    for entry in ("run", "run_stacked"):
        def counted(self, *args, _call=getattr(Executor, entry), **kw):
            try:
                return _call(self, *args, **kw)
            finally:
                dump()

        setattr(Executor, entry, counted)
    server.main(argv)
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_counted_server(dtype_name, mesh, tmp):
    """A ``counted_server`` of vit_b16 in ``dtype_name``: with ``mesh``
    under ``python -m torch.distributed.run --standalone --nproc-per-node
    1`` with ``--mesh data=1``, else a plain process with no mesh; its
    output to a log file. Returns (process, url, counts path, log
    path)."""
    port = free_port()
    tag = f"{dtype_name}_{'mesh' if mesh else 'one'}"
    counts = os.path.join(tmp, f"counts_{tag}.json")
    log_path = os.path.join(tmp, f"server_{tag}.log")
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    launch = ([sys.executable, "-m", "torch.distributed.run",
               "--standalone", "--nproc-per-node", "1"] if mesh
              else [sys.executable])
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            [*launch, os.path.join(HERE, "chip_smoke.py"),
             "--counted-server", counts, *MESH_SERVE_ARGV, "--dtype",
             dtype_name, "--port", str(port),
             *(["--mesh", "data=1"] if mesh else [])],
            cwd=HERE, env=env, stdout=out, stderr=subprocess.STDOUT)
    return proc, f"http://127.0.0.1:{port}", counts, log_path


def get_json(url: str):
    """(status, the JSON body) of a GET; an HTTP error's too."""
    import urllib.error

    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def wait_healthy(url, proc, log_path, timeout: float = 300.0) -> float:
    """Seconds until ``url``'s /health answers ok; raises if the process
    ends first or the time runs out (the tail of its log in the
    message)."""
    import urllib.error

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if proc.poll() is not None:
            break
        try:
            status, body = get_json(url + "/health")
            if status == 200 and body.get("ok"):
                return time.perf_counter() - t0
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        time.sleep(0.5)
    with open(log_path) as f:
        tail = f.read()[-3000:]
    raise AssertionError(f"the server at {url} did not come up (exit "
                         f"{proc.poll()}): {tail}")


def serve_sequence(url, bodies, group, counts):
    """``bodies`` one after another, then ``group`` at once (each posted
    30 ms after the one before, within the 200 ms window: the group's
    rows in the same order on every server); returns [(response bytes,
    X-IVT-Timing)] in that order and each pass's counter deltas from the
    server's ``counts`` file (the group's one)."""
    def read():
        if not os.path.exists(counts):
            return {}
        with open(counts) as f:
            return json.load(f)

    def delta(a, b):
        return {k: b[k] - a.get(k, 0) for k in b if b[k] != a.get(k, 0)}

    out, deltas = [], []
    prev = read()
    for body in bodies:
        out.append(post_timed(url + "/compute", body))
        now = read()
        deltas.append(delta(prev, now))
        prev = now
    with concurrent.futures.ThreadPoolExecutor(len(group)) as pool:
        futures = []
        for body in group:
            futures.append(pool.submit(post_timed, url + "/compute", body))
            time.sleep(0.03)
        out += [f.result() for f in futures]
    deltas.append(delta(prev, read()))
    return out, deltas


def profiled_replay(url, body, iters: int = 20):
    """(wall ms, device busy ms) a replay of ``body``'s program, from the
    server's ``POST /profile`` (``iters`` ``executor.run``s under
    torch.profiler, the batcher and its window bypassed)."""
    res = json.loads(post(url + f"/profile?iters={iters}&top=5", body))
    return res["wall_ms"] / iters, res["total_device_us"] / iters / 1e3


def stop_process(proc, timeout: float = 60.0) -> None:
    """End a launched server (SIGTERM; torchrun ends its worker); kill
    it past ``timeout``."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def check_mesh_served(tag, kernel, got, want, deltas, wdeltas):
    """(t)'s checks of one dtype: every response's bytes the no-mesh
    server's, the group in batches of ``MESH_SERVE_GROUP`` on both, and
    12 launches of ``kernel`` a pass, nothing else, on both."""
    from interactive_vit_tpu_torch.ops import fused_block as fb
    from interactive_vit_tpu_torch.wire.codec import Response

    for j, ((raw, timing), (wraw, wtiming)) in enumerate(zip(got, want)):
        if raw != wraw:
            a, w = Response.decode(raw), Response.decode(wraw)
            diff = {f"{i}/{ch}": float(np.abs(a[i][ch] - w[i][ch]).max())
                    for i in w for ch in w[i]}
            raise AssertionError(
                f"{tag}: response {j} differs from the no-mesh server's "
                f"(batches {timing.get('batch')} / {wtiming.get('batch')}; "
                f"max abs {diff})")
        if j >= MESH_SERVE_REQUESTS and not (
                timing.get("batch") == wtiming.get("batch")
                == MESH_SERVE_GROUP):
            raise AssertionError(
                f"{tag}: the group ran in batches {timing.get('batch')} / "
                f"{wtiming.get('batch')}, not {MESH_SERVE_GROUP}")
    key = counter_key(getattr(fb, kernel))
    for who, ds in (("--mesh", deltas), ("no-mesh", wdeltas)):
        for j, d in enumerate(ds):
            if d != {key: 12}:
                raise AssertionError(
                    f"{tag}: the {who} server's pass {j} launched {d}, "
                    f"expected 12 of {kernel} and nothing else")


def phase_mesh_serving(dry, t_dry) -> dict:
    """Phase 8f: runs (t)-(v) (the module docstring), then waits for the
    gloo dry run (``dry``, started at ``t_dry`` with phase 8e) and prints
    its case lines; returns the main path's launches to add to the
    kernels line."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ivt_chip_smoke_8f_")
    # every server starts now; they come up side by side
    servers = {(d, mesh): start_counted_server(d, mesh, tmp)
               for d in MESH_SERVE_KERNELS for mesh in (True, False)}
    launches = {}
    try:
        with open(os.path.join(HERE, "static", "graphs", "vit_b16.json")) \
                as f:
            obj = json.load(f)
        rng = np.random.default_rng(31)
        images = [rng.random((3, 224, 224), dtype=np.float32)
                  for _ in range(MESH_SERVE_REQUESTS + MESH_SERVE_GROUP)]
        bodies = [chain_request(obj, im, MESH_SERVE_TAPS)
                  for im in images[:MESH_SERVE_REQUESTS]]
        group = [chain_request(obj, im, MESH_SERVE_TAPS)
                 for im in images[MESH_SERVE_REQUESTS:]]
        for dtype_name, kernel in MESH_SERVE_KERNELS.items():
            t0 = time.perf_counter()
            (mproc, url, mcounts, mlog), (oproc, ourl, ocounts, olog) = (
                servers[dtype_name, True], servers[dtype_name, False])
            up = wait_healthy(url, mproc, mlog)
            wait_healthy(ourl, oproc, olog)
            tag = f"--mesh data=1 vit_b16 {dtype_name}"
            want, wdeltas = serve_sequence(ourl, bodies, group, ocounts)
            got, deltas = serve_sequence(url, bodies, group, mcounts)
            check_mesh_served(tag, kernel, got, want, deltas, wdeltas)
            launches[kernel] = 12 * len(deltas)
            shape = {"data": 1, "model": 1}
            status, health = get_json(url + "/health")
            _, metrics = get_json(url + "/metrics")
            _, ohealth = get_json(ourl + "/health")
            if not (status == 200 and health.get("mesh") == shape
                    and metrics.get("mesh") == shape
                    and ohealth.get("mesh") is None):
                raise AssertionError(f"{tag}: /health {health}, /metrics "
                                     f"mesh {metrics.get('mesh')}, the "
                                     f"no-mesh /health {ohealth}")
            walls = [profiled_replay(u, bodies[0])
                     for u in (url, ourl, ourl, url)]
            for proc in (mproc, oproc):
                stop_process(proc)
            log(f"  (t) {tag} under torchrun --nproc-per-node 1 (the server "
                f"module's main, a one-rank NCCL group; up in {up:.1f} s) "
                f"beside the same server with no mesh, each in a process of "
                f"its own: {MESH_SERVE_REQUESTS} requests and a group of "
                f"{MESH_SERVE_GROUP} (batch {MESH_SERVE_GROUP} on both) "
                f"answered bit for bit as the no-mesh server (response "
                f"bytes equal); launches a pass {kernel} 12, every other "
                f"kernel 0, on both ({len(deltas)} passes: "
                f"{launches[kernel]} on the mesh); /health and /metrics "
                f"name the mesh {shape} (the no-mesh server's None)")
            (mw, mb), (ow, ob), (ow2, ob2), (mw2, mb2) = walls
            log(f"  (u) {tag}: a replay under /profile (20 executor.runs, "
                f"profiled; turns mesh, no-mesh, no-mesh, mesh): wall "
                f"--mesh {mw:.3f} / {mw2:.3f} ms, no-mesh {ow:.3f} / "
                f"{ow2:.3f} ms; device busy --mesh {mb:.3f} / {mb2:.3f}, "
                f"no-mesh {ob:.3f} / {ob2:.3f} ms [{CARD['smi']}]; "
                f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mesh_dryrun(dry, t_dry)
        log(f"  (v) the dry run's end waited {time.perf_counter() - t0:.1f} "
            f"s")
    finally:
        for proc, *_ in servers.values():
            stop_process(proc)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  phase 8f took {time.perf_counter() - t_phase:.1f} s "
        f"({CARD['smi']})")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "interactive_vit_tpu_torch")):
        raise SystemExit("chip_smoke.py: run it from a checkout of the "
                         "repository (interactive_vit_tpu_torch/ missing)")
    t_start = time.perf_counter()
    import torch

    from interactive_vit_tpu_torch.ops import attention_vjp as av
    from interactive_vit_tpu_torch.ops import flash_attention as fa
    from interactive_vit_tpu_torch.ops import fused_block as fb
    from interactive_vit_tpu_torch.ops import fused_mlp as fm
    from interactive_vit_tpu_torch.ops import fused_window as fw
    from interactive_vit_tpu_torch.runtime import cuda_build

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; this script runs "
                         "the port on the card and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    log(f"phase 1 device: {kind}, {torch.cuda.device_count()} visible, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi[0])
    CARD["smi"] = smi[0]

    # 2. build: one nvcc per source, all at once, and beside them the host
    # library (the wire codec and the data loader) with g++
    t0 = time.perf_counter()
    sources = sorted({os.path.basename(src)[:-3]
                      for src, _ in KERNELS.values()})
    from interactive_vit_tpu_torch.runtime import build as host_build
    from interactive_vit_tpu_torch.runtime import native

    def build_host():
        t = time.perf_counter()
        native.get_lib()
        HOST_BUILD.update(path=host_build.library_path(),
                          s=time.perf_counter() - t)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(build_host)
        cuda_build.build_all(sources)
        host.result()
    fb.load_kernel()
    fb.load_mma_kernel()
    fb.load_tf32_kernel()
    fb.load_headwise_kernel()
    fb.load_headwise_mma_kernel()
    fb.load_headwise_tf32_kernel()
    fa.load_kernel()
    fa.load_online_kernel()
    fa.load_online_mma_kernel()
    fa.load_mma_kernel()
    fa.load_online_tf32_kernel()
    av.load_tf32_kernel()
    fw.load_kernel()
    fw.load_mma_kernel()
    fw.load_tf32_kernel()
    fm.load_kernel()
    fm.load_w8a8_kernel()
    fm.load_mma_kernel()
    fm.load_w8a8_mma_kernel()
    fm.load_tf32_kernel()
    av.load_kernel()
    av.load_mma_kernel()
    log(f"phase 2 build: {', '.join(sources)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s; the host library "
        f"{os.path.basename(HOST_BUILD['path'])} (g++ "
        f"{' '.join(host_build.FLAGS)}) in {HOST_BUILD['s']:.2f} s beside "
        f"them")
    counters = {"fused_attn_block": fb.fused_attn_block,
                "headwise_attn_block": fb.headwise_attn_block,
                "flash_attention": fa.flash_attention,
                "fused_window_attn": fw.fused_window_attn,
                "fused_mlp_block": fm.fused_mlp_block,
                "flash_attention_online": fa.flash_attention_online,
                "fused_mlp_w8a8_block": fm.fused_mlp_w8a8_block,
                "fused_attn_block_s8": fb.fused_attn_block_s8,
                "fused_attn_block_tome": ToMeCount(fb.fused_attn_block),
                "attention_train": FwdBwdCount(av.attention_train),
                "attention_train_packed": FwdBwdCount(
                    av.attention_train_packed),
                "flash_attention_online_mma": fa.flash_attention_online_mma,
                "attention_train_mma": FwdBwdCount(av.attention_train, "mma_"),
                "attention_train_packed_mma": FwdBwdCount(
                    av.attention_train_packed, "mma_"),
                "flash_attention_mma": fa.flash_attention_mma,
                "flash_attention_online_tf32x3":
                    fa.flash_attention_online_tf32x3,
                "flash_attention_tf32x3": fa.flash_attention_tf32x3,
                "attention_train_tf32": FwdBwdCount(av.attention_train,
                                                    "tf32_"),
                "attention_train_packed_tf32": FwdBwdCount(
                    av.attention_train_packed, "tf32_"),
                "headwise_attn_block_mma": fb.headwise_attn_block_mma,
                "headwise_attn_block_tf32x3": fb.headwise_attn_block_tf32x3,
                "fused_mlp_block_mma": fm.fused_mlp_block_mma,
                "fused_mlp_w8a8_block_mma": fm.fused_mlp_w8a8_block_mma,
                "fused_mlp_w8a8_block_mma96": NarrowCount(
                    fm.fused_mlp_w8a8_block_mma),
                "fused_attn_block_mma": fb.fused_attn_block_mma,
                "fused_attn_block_tf32x3": fb.fused_attn_block_tf32x3,
                "fused_attn_block_s8_mma": fb.fused_attn_block_s8_mma,
                "fused_attn_block_s8_tf32x3": fb.fused_attn_block_s8_tf32x3,
                "fused_attn_block_tome_mma": ToMeCount(
                    fb.fused_attn_block_mma),
                "fused_attn_block_tome_tf32x3": ToMeCount(
                    fb.fused_attn_block_tf32x3),
                "fused_window_attn_mma": fw.fused_window_attn_mma,
                "fused_window_attn_tf32x3": fw.fused_window_attn_tf32x3,
                "fused_mlp_block_tf32x3": fm.fused_mlp_block_tf32x3}
    if set(counters) != set(KERNELS):
        raise AssertionError("every kernel needs its launch count")

    # 3. kernels against their plain versions
    log(f"phase 3 kernels vs plain versions on the card (at {time.perf_counter() - t_start:.1f} s):")
    online = phase_online_kernel(device)
    flash = phase_flash_kernel(device)
    train = phase_train_kernel(device, packed=False)
    train_packed = phase_train_kernel(device, packed=True)
    headwise = phase_headwise_kernel(device)
    mlp = phase_mlp_kernel(device)
    w8a8 = phase_w8a8_kernel(device)
    block = phase_block_kernel(
        device, "fused_attn_block", fb.fused_attn_block,
        fb.fused_attn_block_reference,
        (("vit_b16", 1, 197, 768, 12), ("vit_b16", 8, 197, 768, 12),
         ("vit_t16", 1, 197, 192, 3), ("vit_t16@256", 1, 257, 192, 3),
         ("clip_b32", 1, 50, 768, 12)),
        lambda heads: {
            "maps_off": {},
            "maps_mean": {"want_attn": True, "want_mean": True},
            "subset": {"want_attn": True,
                       "attn_heads": tuple(sorted({0, heads // 2,
                                                   heads - 1}))}})
    block_s8 = phase_block_kernel(
        device, "fused_attn_block_s8", fb.fused_attn_block_s8,
        functools.partial(fb.fused_attn_block_reference, int8_scores=True),
        (("vit_b16", 1, 197, 768, 12), ("vit_b16", 8, 197, 768, 12)),
        lambda heads: {
            "maps_off": {},
            "maps_mean": {"want_attn": True, "want_mean": True},
            "subset": {"want_attn": True, "attn_heads": (0, 6, 11)},
            "qk_maps_mean": {"want_attn": True, "want_mean": True,
                             "int8_pv": False}},
        s8=True)
    check_row1_padded_rows(device)
    tome_nums = phase_tome_kernel(device)
    window = phase_window_kernel(device)
    numbers = {
        "fused_attn_block": block["fma"],
        "fused_attn_block_mma": block["mma"],
        "fused_attn_block_tf32x3": block["tf32"],
        "headwise_attn_block": headwise["fma"],
        "flash_attention": flash["fma"],
        "fused_window_attn": window["fma"],
        "fused_window_attn_mma": window["mma"],
        "fused_window_attn_tf32x3": window["tf32"],
        "fused_mlp_block": mlp["fma"],
        "fused_mlp_block_mma": mlp["mma"],
        "fused_mlp_block_tf32x3": mlp["tf32"],
        "flash_attention_online": online["fma"],
        "fused_mlp_w8a8_block": w8a8["dp4a"],
        "fused_mlp_w8a8_block_mma": w8a8["mma"],
        "fused_attn_block_s8": block_s8["fma"],
        "fused_attn_block_s8_mma": block_s8["mma"],
        "fused_attn_block_s8_tf32x3": block_s8["tf32"],
        "fused_attn_block_tome": tome_nums["fma"],
        "fused_attn_block_tome_mma": tome_nums["mma"],
        "fused_attn_block_tome_tf32x3": tome_nums["tf32"],
        "attention_train": train["fma"],
        "attention_train_packed": train_packed["fma"],
        "flash_attention_online_mma": online["mma"],
        "attention_train_mma": train["mma"],
        "attention_train_packed_mma": train_packed["mma"],
        "flash_attention_mma": flash["mma"],
        "flash_attention_online_tf32x3": online["tf32"],
        "flash_attention_tf32x3": flash["tf32"],
        "attention_train_tf32": train["tf32"],
        "attention_train_packed_tf32": train_packed["tf32"],
        "headwise_attn_block_mma": headwise["mma"],
        "headwise_attn_block_tf32x3": headwise["tf32"],
    }

    # 4. the paths through the server
    log(f"phase 4 slice through the HTTP server (at {time.perf_counter() - t_start:.1f} s):")
    count_replays()
    from interactive_vit_tpu_torch.models import clip, swin, tome, vit
    from interactive_vit_tpu_torch.ops import tome_ops

    def vit_path(name, img, taps, kernels, plain, seq, conc, **kw):
        return Path(name, vit, vit.resolve_variant(name), img, taps, kernels,
                    plain, vit_tap_shape, seq, conc, **kw)

    b16_taps = {2: ("attn", "r"), 7: ("attn", "r"), 13: ("attn", "r")}
    b16_plain = {"block_impl": fb.fused_attn_block_reference}
    tome_taps = ("attn", "r", "merge")

    # row 1 on the tensor cores in all 12 blocks (the FMA kernels, a route
    # for operands off the 16-byte grid, never: their counts come from
    # here), the f32 requests' 12 on split TF32; by name in the profile
    row1_bf16 = {"fused_attn_block_mma": 12, "fused_attn_block": 0}
    row1_f32 = {"fused_attn_block_tf32x3": 12, "fused_attn_block": 0}
    row1_profile = {"row1_qkv_mma_kernel": 12, "row1_attn_mma_kernel": 12,
                    "proj_mma_kernel": 12, "gemm_kernel": 0,
                    "::attention_kernel": 0}

    tome_profile = {"row1_attn_mma_kernel": 12, "key_mean_kernel": 12,
                    "::attention_kernel": 0, "gemm_kernel": 0}

    def tome_path(name, taps, seq, conc, **kw):
        return Path(name, tome, tome.VARIANTS[name], 224, taps,
                    {"fused_attn_block_mma": 12,
                     "fused_attn_block_tome_mma": 12,
                     "fused_attn_block": 0, "fused_attn_block_tome": 0},
                    b16_plain, tome_tap_shape, seq, conc, chain=("s", "a"),
                    lockstep=tome_lockstep,
                    f32_kernels={"fused_attn_block_tf32x3": 12,
                                 "fused_attn_block_tome_tf32x3": 12,
                                 "fused_attn_block": 0,
                                 "fused_attn_block_tome": 0},
                    **kw)
    tome_spans = [(tome_ops, name) for name in (
        "bipartite_matching", "apply_merge", "merge_map_render")]
    paths = [
        vit_path("vit_b16", 224, b16_taps, row1_bf16, b16_plain, seq=5,
                 conc=4, f32_kernels=row1_f32, profile_kernels=row1_profile,
                 extras=compiled_path_extras,
                 other=vit_path("vit_t16", 224, b16_taps, row1_bf16,
                                b16_plain, seq=1, conc=0,
                                profile_kernels=row1_profile)),
        # row 2 on the tensor cores in all 24 blocks (the FMA kernel, a
        # route for operands off the 16-byte grid, never; its count comes
        # from here), the f32 request's 24 on split TF32
        vit_path("vit_l16", 384, {2: ("attn", "r"), 14: ("attn", "r"),
                                  25: ("r",)},
                 {"headwise_attn_block_mma": 24, "headwise_attn_block": 0},
                 {"block_impl": fb.headwise_attn_block_reference}, seq=3,
                 conc=2, node_params={14: {"attn_heads": "[0,7,15]"}},
                 f32_kernels={"headwise_attn_block_tf32x3": 24,
                              "headwise_attn_block": 0},
                 profile_kernels={"headwise_mma_kernel": 24,
                                  "tiled_attention_kernel": 0}),
        # the row-resident kernel on the tensor cores in all 12 blocks (the
        # profile must show it 12 times and the FMA kernel never); the f32
        # request's 12 on split TF32, none on the FMA kernel
        vit_path("dinov2_s14_reg", 518, {2: ("attn", "r"), 8: ("r",),
                                         13: ("r",)},
                 {"flash_attention_mma": 12},
                 {"attn_impl": fa.flash_attention_reference}, seq=3, conc=0,
                 f32_kernels={"flash_attention_tf32x3": 12,
                              "flash_attention": 0},
                 profile_kernels={"rowfull_mma_kernel": 12,
                                  "tiled_attention_kernel": 0}),
        # nodes 2, 3: stages.0.0 and stages.0.1 (shifted); 13: stages.2.5;
        # 16: stages.3.1; a non-square image exercises the bicubic resize.
        # Row 5 on the tensor cores in all 12 blocks (the FMA kernel, a
        # route for operands off the 16-byte grid, never), the f32
        # request's 12 on split TF32; kernel B by name in the profile
        Path("swin_t", swin, swin.VARIANTS["swin_t"], (240, 300),
             {2: ("attn",), 3: ("attn",), 13: ("attn",), 16: ("attn",)},
             {"fused_window_attn_mma": 12, "fused_window_attn": 0},
             {"window_impl": fw.fused_window_attn_reference},
             swin_tap_shape, seq=5, conc=4, check_tap=swin_check_tap,
             node_params={13: {"attn_win": "2"},
                          16: {"attn_heads": "[0,11,23]"}},
             f32_kernels={"fused_window_attn_tf32x3": 12,
                          "fused_window_attn": 0},
             profile_kernels={"window_attn_mma_kernel": 12,
                              "row1_qkv_mma_kernel": 12,
                              "proj_mma_kernel": 12,
                              "window_attention_kernel": 0}),
        # a 53 x 53 grid: N=2814, the online kernel in all 12 blocks (bf16 on
        # the tensor cores, the f32 request on split TF32); the block
        # outputs o of blocks 0, 6, 11 and the CLS features
        vit_path("dinov2_s14_reg@742", 742, {2: ("o",), 8: ("o",),
                                             13: ("o",)},
                 {"flash_attention_online_mma": 12},
                 {"attn_impl": online_plain}, seq=2, conc=0,
                 f32_kernels={"flash_attention_online_tf32x3": 12},
                 profile_kernels={"online_mma_kernel": 12,
                                  "online_attention_kernel": 0}),
        # vit_h14@742 at full depth (32 blocks, N=2810, heads 80 wide), one
        # f32 request (the server's default dtype): a plain ViT's blocks
        # run the block kernels, here the headwise one on split TF32 (by
        # name in the profile; the FMA attention core never), not rows 3-4
        # (vit.forward's attention: run_forwards); the block outputs o of
        # blocks 0, 16, 31 and the logits, each within 1e-4 of its scale
        # (32 blocks carry the kernel's ~1e-6 relative differences through
        # the residual stream), each one's absolute error logged beside
        # its scale
        vit_path("vit_h14@742", 742, {2: ("o",), 18: ("o",), 33: ("o",)},
                 {"headwise_attn_block_tf32x3": 32},
                 {"block_impl": fb.headwise_attn_block_reference}, seq=1,
                 conc=0, dtype="float32", f32=False, f32_rel=True,
                 profile_kernels={"headwise_tf32_kernel": 32,
                                  "tiled_attention_kernel": 0,
                                  "online_tf32_kernel": 0}),
        # the same in bf16: row 2 on the bf16 tensor cores in all 32 blocks
        vit_path("vit_h14@742", 742, {2: ("o",), 18: ("o",), 33: ("o",)},
                 {"headwise_attn_block_mma": 32},
                 {"block_impl": fb.headwise_attn_block_reference}, seq=1,
                 conc=0, f32=False,
                 profile_kernels={"headwise_mma_kernel": 32,
                                  "tiled_attention_kernel": 0}),
        # the repository's saved graph for an @ geometry (N=257)
        vit_path("vit_t16@256", 256, {2: ("attn", "r"), 8: ("attn", "r"),
                                      13: ("r",)}, row1_bf16,
                 b16_plain, seq=2, conc=0, f32_kernels=row1_f32,
                 profile_kernels=row1_profile),
        # the repository's dino_s16 feature-view graph (img_src at node 0):
        # pca_view (17) and patch_sim (19) on the norm output (15), block
        # 11's maps and rollout (14) wired to attn_view and overlay; row 1
        # on the tensor cores in all 12 blocks (6 heads 64 wide, N=197),
        # the f32 request's 12 on split TF32; the views run in f32
        Path("dino_s16", vit, vit.resolve_variant("dino_s16"), 224,
             {14: ("attn", "r"), 15: ("o",), 17: ("o",), 19: ("o",)},
             row1_bf16, b16_plain, dino_tap_shape, seq=3, conc=2,
             f32_kernels=row1_f32, profile_kernels=row1_profile, offset=1,
             views={17: ("norm", "pca_view", {"skip": "1"}),
                    19: ("norm", "patch_sim", {"row": "-1", "col": "-1",
                                               "skip": "1"})},
             extras=feature_view_extras),
        # W8A8 fc1/fc2 and the s8 block in every block: the MLP and the
        # s8 attention on the int8 tensor cores (the __dp4a kernels, routes
        # for operands off the grid, never; their counts come from here),
        # by name in the profile
        vit_path("vit_b16", 224, b16_taps,
                 {"fused_mlp_w8a8_block_mma": 12,
                  "fused_attn_block_s8_mma": 12, "fused_attn_block_s8": 0,
                  "fused_attn_block_s8_tf32x3": 0,
                  "fused_mlp_w8a8_block": 0},
                 {"block_impl": functools.partial(
                     fb.fused_attn_block_reference, int8_scores=True),
                  "mlp_impl": fm.fused_mlp_w8a8_reference},
                 seq=3, conc=0, dtype="int8w8a8", attn="int8-scores",
                 f32=False, profile_kernels={
                     "w8a8_mma_kernel": 12, "w8a8_mlp_kernel": 0,
                     "row1_qkv_mma_kernel": 12, "row1_s8_mma_kernel": 12,
                     "proj_mma_kernel": 12, "gemm_kernel": 0,
                     "::attention_kernel": 0}),
        # weight-only int8: the unfused path, none of the port's kernels
        # (none by name in the profile)
        vit_path("vit_b16", 224, b16_taps, {}, {}, seq=2, conc=0,
                 dtype="int8", f32=False, profile_kernels={
                     name: 0 for name in port_kernel_names()}),
        # ToMe from the repository's saved graph (s and a wired along the
        # chain): the block kernel with key_bias + the key metric in every
        # block, N 197 -> 109; one vit_b16_tome16 request reaches N=11
        tome_path("vit_b16_tome", {2: tome_taps, 7: tome_taps,
                                   13: tome_taps}, seq=3, conc=2,
                  other=tome_path("vit_b16_tome16", {13: tome_taps}, seq=1,
                                  conc=0, profile_kernels=tome_profile),
                  host_spans=tome_spans, profile_kernels=tome_profile),
        # CLIP ViT-B/32's image tower (BASELINE config 4) from the
        # repository's saved graph: row 1 on the tensor cores in all 12
        # blocks at N=50 (by name in the profile; the FMA route never), the
        # f32 request's 12 on split TF32; attn of blocks 0 and 11 and the
        # L2-normalised embedding (its norm held to 1)
        Path("clip_b32", clip, clip.CLIPVisionConfig(), 224,
             {2: ("attn",), 13: ("attn",)}, row1_bf16, b16_plain,
             vit_tap_shape, seq=3, conc=2, f32_kernels=row1_f32,
             profile_kernels=row1_profile, head="embedding",
             head_shape=(1, 512), check_head=unit_norm),
        # the reference's VGG16 from its saved graph, unbatched as the
        # reference sent it: cuDNN's convolutions and layers.linear's
        # GEMMs, no kernel of the port (none by name in the profile); its
        # f32 request is run_vgg_f32's, against a float64 host forward
        Path("vgg16", VggFamily, None, 224, {i: ("o",) for i in VGG_TAPS},
             {}, {}, vgg_tap_shape, seq=3, conc=2, f32=False,
             head="classifier.6", head_shape=(1000,),
             profile_kernels={name: 0 for name in port_kernel_names()}),
    ]
    tmp = tempfile.mkdtemp(prefix="ivt_chip_smoke_")
    try:
        graphs_dir = os.path.join(tmp, "graphs")
        shutil.copytree(os.path.join(HERE, "static", "graphs"), graphs_dir)
        for path in paths:
            t0 = time.perf_counter()
            res = run_path(path, device, graphs_dir, counters)
            log(f"  {path.model} {path.dtype}: the path took "
                f"{time.perf_counter() - t0:.1f} s")
            # a kernel's first path gives its count
            for k in {**path.kernels, **path.f32_kernels}:
                numbers[k].setdefault("launches", res["launches"][k])
        t0 = time.perf_counter()
        run_vgg_f32(device, graphs_dir, counters)
        run_zeroshot(device, graphs_dir, counters)
        log(f"  vgg16 f32 and clip_zeroshot: "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        run_demo_graphs(device, graphs_dir, counters)
        run_graph_on_card(counters)
        log(f"  the demo graphs and run_graph: "
            f"{time.perf_counter() - t0:.1f} s")
        run_saliency_graphs(device, graphs_dir, counters)
        t0 = time.perf_counter()
        throughput_probe(device, graphs_dir, vit_path(
            "vit_b16", 224, b16_taps, {}, {}, 0, 0).taps())
        log(f"  throughput probe: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  the monolithic forwards (at {time.perf_counter() - t_start:.1f} "
        f"s):")
    for k, n in run_forwards(device, counters).items():
        numbers[k]["launches"] = n

    # 5. the trainer
    log(f"phase 5 train through tools.train.main (at {time.perf_counter() - t_start:.1f} s):")
    for k, n in phase_train(device, counters).items():
        numbers[k]["launches"] = n

    # 6. real weights: the checkpoint paths
    log(f"phase 6 checkpoints (at {time.perf_counter() - t_start:.1f} s):")
    phase_checkpoints(device, counters)

    # 7. the last four families from their saved graphs
    log(f"phase 7 families (at {time.perf_counter() - t_start:.1f} s):")
    phase_families(device, counters)

    # 8. the native host tier and the trainer's data path
    log(f"phase 8 native tier and data (at "
        f"{time.perf_counter() - t_start:.1f} s):")
    phase_native_data(device, counters)

    # 8b. the rest of training: distillation, MoE, Swin / ConvNeXt, MAE
    log(f"phase 8b the rest of training (at "
        f"{time.perf_counter() - t_start:.1f} s):")
    for k, n in phase_rest_of_training(device, counters).items():
        numbers[k]["launches"] += n

    # 8c. tracing and quantized Swin: row 7 at chunks of 96, swin_t int8,
    # utils/tracing, tools/quant_agreement
    log(f"phase 8c tracing and quantized Swin (at "
        f"{time.perf_counter() - t_start:.1f} s):")
    launches, narrow = phase_tracing_quant_swin(device, counters)
    numbers["fused_mlp_w8a8_block_mma96"] = {**narrow, "launches": 0}
    for k, n in launches.items():
        numbers[k]["launches"] += n

    # 8d. graph export: the ivt custom ops, export / load / replay of a
    # graph for each forward row, serving from an artifact
    log(f"phase 8d graph export (at {time.perf_counter() - t_start:.1f} s):")
    phase_export(device, counters)

    # 8e. the mesh: sharded steps on a one-rank NCCL group, the trainer
    # and ivt-eval under torchrun, ring / Ulysses; the gloo dry run starts
    # here and runs beside 8e and 8f
    log(f"phase 8e the mesh (at {time.perf_counter() - t_start:.1f} s):")
    t_dry = time.perf_counter()
    dry = start_dryrun()
    try:
        for k, n in phase_mesh(device, counters).items():
            numbers[k]["launches"] += n

        # 8f. serving on the mesh: the server under torchrun with --mesh
        # data=1 (bf16 and f32) against the no-mesh server; the dry run's
        # end, its serving cases among its lines
        log(f"phase 8f serving on the mesh (at "
            f"{time.perf_counter() - t_start:.1f} s):")
        for k, n in phase_mesh_serving(dry, t_dry).items():
            numbers[k]["launches"] += n
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.communicate()

    # 9. result
    log(f"phase 9 result: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(f"profiles taken again (a trace short of the launch counters): "
        f"{len(PROFILE_RETRIES)}" + "".join(f"; {r}" for r in PROFILE_RETRIES))
    log(f"replayed outputs not equal to the eager pass bit for bit (each "
        f"within its path's bound): {len(REPLAY_DIFFS)}"
        + "".join(f"; {r}" for r in REPLAY_DIFFS))
    log("the compiled path, each served path (ms; walls: median of 3, "
        "synchronized; profiled: one run under torch.profiler, wall / "
        "device busy; memory_reserved above the path's start):")
    def busy(ms):
        return "not measured" if ms is None else f"{ms:.2f}"

    for tag, rw, ew, prw, prb, pew, peb, caps, gib in COMPILED:
        log(f"  {tag}: replay {rw:.2f}, eager {ew:.2f} ({ew / rw:.2f}x); "
            f"profiled replay {busy(prw)} / {busy(prb)}, eager {pew:.2f} / "
            f"{busy(peb)}; captures "
            f"{', '.join(f'{t * 1e3:.1f}' for t in caps)}; memory_reserved "
            f"{gib:.2f} GiB")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        nums = numbers[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": nums["launches"],
            "max_abs_err": nums["max_abs_err"], "ms": nums["ms"],
            "plain_ms": nums["plain_ms"], "bound_ms": nums["bound_ms"],
            "bound_by": nums["bound_by"], "library_ms": nums["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--counted-server"]:
        sys.exit(counted_server(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
