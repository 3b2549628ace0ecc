"""Drive the PyTorch port's paths once on one CUDA card: uPIT, DPRNN-TasNet,
SepFormer-TasNet, Conv-TasNet and OR-PIT separation, the mask estimator
with beamforming and STOI, the deep-clustering model, the WaveNet vocoder,
the speaker classifier with its on-device log-mel front end and the
speech-recognition recipe's three heads (CTC, transducer, attention
encoder-decoder), each served and trained; the transformer decoder's
int8 KV-cache decoding and continuous batching, served; and real audio:
the recipes trained and served from WAV files and JSON databases (uPIT,
the speaker classifier, the audio tagger, the distance estimator, the
vocoder); the rest of the Trainer: its hooks, optimizers, back-off,
asynchronous checkpoints and adversarial mode, with the GAN vocoder; and
serving from exported artifacts, LoRA fine-tuning and online enhancement
with the streaming STFT.

    python3 chip_smoke.py [--profile]

Phases, one line each:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is off for matmuls and convolutions (the package turns
   it off where it is imported).
2. build: the hand-written kernels built from ``padertorch_tpu_torch/csrc``
   (one nvcc per source, started together).
3. lstm_cell_scan kernel vs its plain version at the flagship shape
   (T=500, D*B=32 with ragged lengths in [250, 500], H=600, f32), and a
   control: the plain version with TF32 matmuls must fail the limit.  Also
   the yardsticks: one bidirectional ``torch.nn.LSTM`` layer (cuDNN) and
   the input projection alone at that shape.
4. masked_istft vs its plain version at (K=2, T=127, F=257) and (B*K=32,
   T=500, F=257) on both routes (``fft``, the planner's, and ``dft``,
   forced by a plan): times from CUDA-graph replays and eager calls beside
   plain and the cuFFT composition (mask multiply, ``torch.fft.irfft``,
   window, ``F.fold``; a yardstick the port never calls), the FFT's bound
   and the DFT's; each version's largest difference from float64, and the
   fft route with twiddles from ``__sincosf`` as a control; one signal of
   the batch alone, in the batch and under two more plans, bit for bit;
   then sizes 4096 (shifts 1024 and 2048), windows shorter than the size,
   size 400 (the dft route, timed) and 70,000 signal rows on both routes,
   each against plain with the route it took.
5. slice: the full-width uPIT model (F=257, 3x600 BLSTM, K=2) from seed 0
   on the card against the same model on the CPU; then the recipe's
   ``evaluate_example`` on the 8 mixtures of
   ``synthetic_database(num_examples=8, seed=2)`` as 8 requests, with the
   kernels' launch counts read around them (every masked_istft launch on
   the fft route, ``masked_istft.routes``); then one batched forward at
   B=16, T=500.
6. training kernels vs plain at the flagship shape: outputs and residuals
   of the training forward, ``dgates_x``/``dh0``/``dc0`` of the backward
   on the same residuals and random cotangents, and the whole
   ``autograd.Function`` (with ``dW_hh``) against autograd through the
   plain forward; a TF32 control must fail each limit.
7. the training path: the recipe's ``get_trainer_config`` at full width
   into a temporary storage dir, ``test_run``, then ``Trainer.train`` for
   3 epochs of 8 batches of 4 synthetic mixtures with a validation hook
   and checkpoints, the kernels' launch counts read around it; the first
   step's loss and gradient norm against the same step on the CPU; the
   storage dir loaded back and one request served from it; then one timed
   training step at the recipe's shape and at B=16, T=500, by stage.

8. gru_cell_scan kernels (lean forward, training forward, backward, and
   the ``autograd.Function``) vs their plain versions at the DPRNN's two
   shapes (T=100, D*B=520, H=128 without mask; T=65, D*B=800, H=128 with
   the chunk-length mask of a ragged batch) and at (T=500, D*B=32, H=600,
   ragged), and at the speaker classifier's two (one direction under a
   ragged frame mask: T=66, 8 rows, H=64 in the recipe's run; T=503, 16
   rows, H=256 at the class defaults), each with the TF32 control that must
   fail the limit, and one ``torch.nn.GRU`` layer (cuDNN) of the same sizes
   and directions as a yardstick; each shape's forward route (``resident``
   where ``resident_plan`` gives a plan, printed with it: the DPRNN's and
   the classifier recipe's shapes; ``cooperative`` otherwise), read from
   ``gru_cell_scan.routes`` (by kernel and route), and a second lean run's
   bits; the backward's route the same way (``resident_bwd_plan``;
   resident at H <= 137), and a second backward run's bits.  Phases 10, 11
   and 19 check that every GRU forward and backward of the ``bgru`` paths
   and of the classifier recipe took the resident route and the
   classifier defaults' the cooperative one.
9. the three LSTM kernels vs plain at the DPRNN's two shapes, timed, each
   with its TF32 control, the backward with the grid it took (unit slice,
   row ranges, rows per range, rows staged at once, K slices, blocks),
   beside one bidirectional ``torch.nn.LSTM`` layer (cuDNN) of the same
   sizes.
10. TasNet serving, for ``bgru`` and ``blstm`` chunk RNNs: the full-width
    model (256 filters of length 20, 64 -> 6 blocks of 128 units, K=100,
    hop 50, 2 speakers) on the card against the same model on the CPU;
    then the tasnet recipe's ``evaluate_example`` on the 8 mixtures as 8
    requests, with launch counts.
11. TasNet training, for ``bgru`` and ``blstm``: the tasnet recipe's
    ``get_trainer_config`` at full width, ``test_run``, a short
    ``Trainer.train`` with validation and checkpoints, launch counts; the
    first step against the CPU; every trained parameter's gradient finite
    and nonzero; the storage dir loaded back and one request served; then
    a timed step at B=4 x 32000 samples and at B=4 x 16000, by stage.

12. flash attention kernels (forward with and without the log-sum-exp,
    backward through the ``autograd.Function``) vs the plain masked-softmax
    version at the SepFormer's two shapes ((B*S, H, K, D) = (264, 8, 100,
    16) without padding and (B*K, H, S, D) = (400, 8, 66, 16) with ragged
    key lengths, one of 1 and one of 0), at (8, 12, 2048, 64) full, causal,
    windowed and causal with key padding, grouped-query (4, 8 over 2,
    1024, 64), Tq != Tk and a head size outside the template set; each
    timed beside the plain version, ``F.scaled_dot_product_attention``
    (float32, TF32 off) and its bound, with the kernel's share of it (the
    backward as the median of five windows after a warm-up, with the
    allocator's cache emptied); both kernels' products run on the tensor
    cores as 3xTF32, and each gives the same bits on two runs; at each
    timed shape the plain forward and autograd through the plain version
    with TF32 products (on operands rounded to TF32) must fail the
    forward's and the gradients' limits, which the kernels meet.  Then the
    dispatch table: one ``MultiheadAttention``
    forward and forward + backward on the fused and on the dense backend
    at (8, T, 12 x 64) for T = 512 ... 4096, full, causal and windowed,
    at the SepFormer's two shapes, and at heads of 256 (T = 1024 and 2048,
    full and causal) and 192, in float32 and in bf16 (the module cast with
    ``.to``); the table is printed beside what ``should_use_flash`` picks
    (``AUTO_MAX_HEAD`` follows it); ``use_flash='auto'`` in bf16 launches
    the bf16 forward and equals the forced fused backend bit for bit.
    Last, ``use_flash='auto'`` at heads of 256: the backend
    ``should_use_flash`` picks, bit for bit; the kernels forced agree with
    the dense path on the valid rows; heads of 320 forced on the kernels
    raise.
13. SepFormer-TasNet serving: the tasnet recipe's ``sepformer`` variant at
    full width (256 filters of length 20, 128 features, 4 blocks of 2 + 2
    transformer layers, 8 heads, K=100, hop 50) trained for 4 iterations
    into a storage dir, loaded back, the fused backend forced as the
    recipe's ``--flash`` does; the model on the card against the CPU; the
    8 mixtures as 8 requests with launch counts.
14. SepFormer-TasNet training: ``get_trainer_config(variant='sepformer')``
    at full width, the fused backend forced, ``test_run``, 16 iterations
    with validation and checkpoints, launch counts; the first step against
    the CPU; timed steps at B=4 x 32000 and B=4 x 16000 samples on the
    fused and on the dense backend.

15. wavenet_sample kernel vs its plain step loop at full width (16 layers,
    dilations 1 ... 128 twice, R=64, S=256, O=256; weights of the recipe's
    model from seed 0) at the shape of a parallel request of 1 s (5 chunks
    of 4200 steps as 5 rows): teacher-forced logits within the limit, with
    the TF32 control failing it; greedy and Gumbel-max indices under
    teacher forcing equal to the choice from the kernel's own logits and
    the plain version's draws, and equal to the plain version's but where
    its two best scores are closer than twice the limit; the free-running
    greedy loop equal to the plain one over 1000 steps of 2 rows; the
    sampled indices' log-likelihood against the softmax's entropy; one
    sampling row of 16000 steps (a sequential request) against the plain
    loop's sampling on its first 500; each row of a batch of 132 (one
    block per row) equal bit for bit to the same row run alone (a cluster
    of CTAs), teacher-forced logits and indices and the free-running
    greedy loop; timed per step at 1, 5, 8, 15, 16, 30, 33, 66, 132 and
    264 rows, each with its route (``wavenet_kernels.device_plan``: on an
    H100 a cluster of 16 CTAs with its weights in shared memory for 1 and
    5 rows, of 8, 4 and 2 CTAs reading them through L2 for 8 and 15, 16
    and 30, 33 and 66 rows, one block per row for 132 and 264), which the
    launches' ``wavenet_sample.routes`` must confirm; the 8 to 66 rows
    also on one block per row, timed beside the cluster and equal to it
    bit for bit (teacher-forced logits and indices, sampled indices); and
    the card's count of clusters of each size that run at once.
16. fused_logmel kernel vs its plain version at (16, 64000) 512/128/64,
    at the classifier recipe's (8, 8000) 512/128/64, at the wavenet
    recipe's (2, 16000) 1024/200 with window 800 and at
    (3, 12345) 512/160 with window 400 (a hop that does not divide the
    window), with the TF32 control; one launch per call, the same bits on
    a second call and for a signal alone; the plan (``logmel_plan``:
    CTAs a cluster, CTAs in all); timed from CUDA-graph
    replays (the kernel's own time) and eager, beside the plain version
    and the composed module path (``STFT`` -> power -> filterbank -> log).
17. WaveNet serving: the recipe's full-width vocoder trained 4 iterations
    into a storage dir on the card, loaded back; teacher-forced logits of
    the card against the CPU, and the kernel's teacher-forced logits
    against the training graph's; greedy synthesis of 1000 samples on the
    card against the CPU's step loop; then the recipe's
    ``synthesize_example`` on utterances of 1 s as requests: 2 as one
    chunk, 1 in 5 sequential chunks, 4 with ``parallel`` chunks, launch
    counts and routes read around them (every request's sampler on the
    cluster route).
18. WaveNet training: the recipe's ``get_trainer_config`` at full width,
    ``test_run``, 8 iterations at 2 x 16000 samples with validation and
    checkpoints, the first step against the CPU, a timed step by stage.
19. speaker classifier with ``--on_device_features``: the recipe's own run
    (8 synthetic speakers, (16, 32) CNN channels, 64 GRU units, batches of
    8 x 8000 samples) with launch counts of fused_logmel and the GRU
    kernels, the first step against the CPU, the accuracy above chance;
    the storage dir loaded back and its dev batches served through
    ``evaluate_batch``, card against CPU; then a timed forward and
    training step at the class defaults (251 speakers, (32, 64) channels,
    256 GRU units) on 16 x 4 s of audio.

20. int8_matmul kernel vs its plain version (float32 within 1e-5 of the
    largest output, bf16 within one unit in the last place plus that)
    with and without bias, at M = 1, 8, 16, 32, 64, 128, 256 and the
    decoder's weights (1024, 1024), (1024, 4096), (4096, 1024), and at a
    ragged (1000, 1030); the composed route (``x @ (w_q * scale)`` in bf16)
    must fail the bf16 limit and plain with TF32 products the float32 one;
    timed beside plain, the composed route, ``torch.addmm`` on the weight
    dequantized to the activations' type and the bound (bf16 against the
    tensor cores' bf16 peak, float32 against the float32 peak), with the
    host's microseconds to enqueue one call; the contract's raises; in bf16
    every row of a batch of up to 256 equal to the row alone, bit for bit,
    and repeated calls and CUDA-graph replays equal; split launches on two
    streams at once, 200 each, equal to one stream's bit for bit, with
    every per-tile counter back at zero; then the kernel and
    the composed route of ``QuantizedLinear`` by rows of x from 1 to 256
    (``INT8_KERNEL_MAX_ROWS`` comes from this table).
21. decoding at full width: bench.py's int8 decode model (TransformerDecoder
    d_model 1024, 12 layers, 16 heads, RoPE, pre-norm; a Linear(1024, 1024)
    head; weights from seed 0, the embedding table x 0.05 and 128 frames
    of memory from numpy seed 0): teacher-forced decode_step logits
    against one forward in float32 (which launches flash_attention); the
    int8 kernel route against the composed route on bf16 forward logits;
    ``autoregressive_generate`` of 128 greedy tokens at B=1 with the
    kernel's launches counted (12,440: 97 per token and 24 for the cross
    K/V), then us per token for float32, bf16, bf16 int8 composed and
    bf16 int8 kernel (best of 3 after a warm-up, host clock), and the
    kernel route again with every kernel call through the ``ptt``
    operators' dispatcher (``ops/kernels/_ops.py`` ``EAGER_DIRECT``
    False, as an exported graph calls them) instead of the operators'
    CUDA implementations called directly: the same logits and tokens bit
    for bit.
22. serving: a ``ContinuousBatcher`` of 8 slots on the bf16 int8 kernel
    decoder takes 16 requests (memory of 32 to 128 frames, 16 to 64 new
    tokens); requests per second, tokens per second, us per step, the
    kernel's launches; each request's tokens equal that request decoded
    alone, but at near ties of its logits.

23. the three bf16 LSTM kernels (bf16 streams, bf16 products summed in
    float32) vs their plain bf16 versions at the flagship layer (T=500,
    D*B=32 ragged, H=600), the DPRNN's intra and inter shapes and an odd
    H=75 (the kernels' row copies without 16-byte copies): the float32
    states within 3e-4 (forward) and 1e-3 (backward), every stream element
    within one bf16 unit in the last place plus 1e-3 (2e-3), and at most
    5% of them other than plain's; the plain version with float32 products
    must exceed the share; each timed beside the float32 kernel at the same
    shape, plain, a bidirectional bf16 ``torch.nn.LSTM`` layer (cuDNN) and
    the bound
    (bytes at 2 B a stream element over 3.35 TB/s, or operations over the
    bf16 tensor cores' 989 TFLOP/s); all three on their ``mma`` routes
    (counted by ``lstm_cell_scan.routes`` per kernel, the card's grids
    those of the mirror ``lstm.mma_plan``), each the same bits twice; the
    bf16 backward's digests on fixed inputs (``lstm_bf16_bwd_digests``
    takes a checkout's root).
24. the JAX package's benchmarked flagship step: F=257, 3 x 600 BLSTM,
    K=2, ``compute_dtype='bfloat16'`` under ``precision='bfloat16'``, Adam
    with clip 10, both PIT losses, B=16, T=500: 20 steps beside the float32
    step from the same start (every bf16 forward and backward launch on
    the ``mma`` route) (losses within 5% relative, decreasing; the
    bf16 kernels launched), then a timed step by stage and on the host
    clock; masters and Adam moments float32; the trained bf16 model serves
    4 requests (the lean bf16 kernel, on the ``mma`` route) and agrees
    with itself on the CPU.
25. the DPRNN-TasNet step under ``precision='bfloat16'`` at B=4 x 16000
    samples beside float32 from the same start: 3 steps' losses, 36
    training launches of the float32 LSTM kernels each, a timed step,
    masters float32.
26. the bf16 attention kernels (forward with and without the log-sum-exp,
    ``wgmma`` with TMA; the dk/dv and dq kernels, and the
    ``autograd.Function`` through them)
    vs their plain bf16 versions at the SepFormer's two shapes, (8, 12,
    2048, 64) full, bench.py's three (B=8, H=12, D=64: T=4096 causal,
    T=1024 full, T=4096 window (255, 256)), grouped-query (4, 8 over 2,
    1024, 64) causal and ragged, (4, 8, 2048, 128) and (4, 8, 2048, 256),
    D=32 and 128, and a fully masked row: O
    within one bf16 unit in the last place plus 2e-3 and at most 1% of its
    elements other than plain's (plain taking the keys in the kernel's
    tiles of 64, ``key_tile``: P rounded to bf16 against the running
    maximum, as the JAX kernel against its blocks); dq, dk, dv within one
    unit plus 1e-5 of each one's largest entry, at most 1% of them other
    by more than that; LSE within 1e-5 of max(|lse|, 1);
    two runs the same bits.  The
    control, plain with logits rounded to bf16 in the forward and P and dS
    rounded to bf16 in the backward, must exceed both shares.  Each timed
    shape beside the float32 kernels at the same shape, plain,
    ``F.scaled_dot_product_attention`` on the same bf16 tensors and the
    bound (bytes over 3.35 TB/s, or the bf16 products at 989 TFLOP/s plus
    the backward's products of P and dS at 2xTF32's 495 / 2, the
    definition kept from the 2xTF32 design); the D = 128 and 256 shapes at
    (4, 8, 2048, D) timed
    too; then the counterpart of
    bench.py's ``flash_attention_causal_train_ms``: forward + backward at
    (8, 12, 4096, 64) causal bf16 beside the port's dense bf16 path and
    the library; the bf16 backward kernels' digests on fixed inputs
    (``attention_bf16_bwd_digests`` takes a checkout's root).
27. the SepFormer-TasNet step under ``precision='bfloat16'`` with the
    fused backend (the recipe's ``--variant sepformer --flash --precision
    bfloat16``) beside the dense bf16 backend and the float32 fused step,
    each from the same start: 20 steps' losses at B=4 x 16000 samples, the
    bf16 kernels' launches (16 forward and 16 backward a step, no float32
    launch), and a timed step at 4 x 16000 and 4 x 32000 by stage and on
    the host clock; masters float32.
28. the three bf16 GRU kernels (bf16 streams, bf16 products summed in
    float32; all three on their ``mma`` route, ``W_hh`` in registers as
    ``mma.sync`` operands, where the bf16 resident plan exists and H <=
    128, the lean forward's ``out`` and ``h_T`` there bit for bit the
    training forward's; above, the lean forward on its ``cluster`` route
    to the planner's reach, a cluster's CTAs sharing bf16(h) through
    distributed shared memory, the card's plan the mirror
    ``gru.cluster_plan``'s, also at H = 160, the reach and one above) vs
    their plain bf16 versions at phase 23's limits at every shape a recipe
    launches (the DPRNN's intra and inter, (500, 32, 600) ragged, the
    classifier's (66, 8, 64) and (503, 16, 256) one direction), at H = 12
    under prefix padding and H = 100 in one direction, at a served
    request's (2 x 33 and 2 x 100 rows, H = 128), and at the bf16
    resident routes' widest H on this card and one above and the ``mma``
    route's (forwards and backward: every route, read from
    ``gru_cell_scan.routes``, as ``gru.kernel_route`` picks them; on
    ``mma`` the card's plan the mirror ``gru.mma_plan``'s), each kernel
    the same bits twice; the plain version with float32 products must
    exceed the share; the first five timed beside the float32 kernels,
    plain, a bf16 ``torch.nn.GRU`` layer (cuDNN) and the bound; the widest
    ``mma`` and ``cluster`` H printed; then the float32 GRU kernels', the
    lean bf16 forward's and the bf16 training forward's and backward's
    digests on fixed inputs at phase 8's shapes and phase 31's 2 x 2048
    layer (``gru_f32_digests`` takes a checkout's root, so parent and
    change compare in one call).
29. the recipe's ``dprnn`` with ``bgru`` chunk RNNs at full width under
    ``precision='bfloat16'`` after ``set_rnn_backend(trainer.model,
    'pallas', compute_dtype='bfloat16')``, beside the policy alone and
    float32 from the same start: 20 steps' losses at B=4 x 16000, 36
    ``fwd_train_bf16`` and 36 ``bwd_bf16`` launches in the first 3 steps,
    all on the ``mma`` route, and no float32 GRU launch, timed steps at 4
    x 16000 and 4 x 32000 by stage and on the host clock, the card's busy
    time a step (``torch.profiler``), masters float32; then 4 requests
    through the tasnet recipe's ``evaluate_example`` on the lean bf16
    forward (the ``mma`` route).
30. the speaker classifier under ``precision='bfloat16'`` with a bf16 GRU
    (``set_rnn_backend``) and the float32 ``fused_logmel`` in front: the
    recipe's classifier (64 units: all three bf16 kernels on the ``mma``
    route) on its 8 x 8000 batches and the class defaults (256 units: the
    training forward and backward on the cooperative route, the served
    lean forward on ``cluster``) on 16 x 64000, each 20 steps beside
    float32 from the same start, launch counts, a timed step, and requests
    through ``evaluate_batch``.
31. the geometries of the reference's kernels that the card refused
    before, each against its plain version: LSTM layers of 2 x 1024
    (float32) and 2 x 1536 (bf16), GRU layers of 2 x 1024 and 2 x 2048
    (float32) and 2 x 2048 (bf16), whose W_hh no co-resident grid holds
    (the streamed route; the card's planner and its mirror
    ``lstm.scan_grid`` agree), timed beside plain, a cuDNN layer and the
    bound (W_hh read once a step in the product's type); the streamed
    LSTM forward with and without an L2 access-policy window over its
    packed weights; the float32 LSTM kernels' digests on
    fixed inputs at phase 3's and 9's shapes (``lstm_f32_digests`` takes
    a checkout's root); ``wavenet_sample`` at 30 layers to dilation 512
    (a 785,664-byte ring) on 1, 8 and 132 rows, 24 layers to 128 at R =
    128, R = 60 / S = 250 / O = 254, 80 layers and rings in device memory
    (R = 512), and at weights of 0.2 whatever the width on rings in
    device memory: 30 layers against a float64 step loop beside plain
    float32, 4 layers to dilation 1024 against plain; ``fused_logmel`` at
    1600/800 and 1024/1024 (the sliced
    route), and the sliced route forced at 512/128 equal to the span
    route bit for bit; attention at heads of 192 and 256, float32 and
    bf16, forward and backward.
32. the bf16 attention backward (``wgmma`` from TMA tiles, P and dS in
    three bf16 pieces) at phase 26's timed shapes: its time, its share of
    its bound (every product at the bf16 rate) and of the 2xTF32 design's,
    SDPA's and the float32 kernels' times, the control's share.

33. Conv-TasNet: the tasnet recipe's ``--variant convnet`` at full width
    (256 filters of length 20; ``ConvNet`` 256/512, 8 blocks x 4 repeats,
    gLN; the parameter count printed): ``test_run``, 4 iterations with
    validation and checkpoints into a storage dir that loads back, the
    first step against the CPU (``CONVNET_STEP_RTOL``), three requests
    through ``evaluate_example`` (the first against the CPU), timed steps
    by stage at ragged 4 x 32000 and 4 x 16000.  No kernel runs on it:
    the convolutions are cuDNN's.
34. OR-PIT: the or_pit recipe at its defaults (a ``blstm`` DPRNN TasNet
    with 2 outputs, ``max_iterations=2``): ``test_run``, 4 iterations with
    the LSTM kernels' launches (12 of each a step), the first step against
    the CPU, ``separate`` on three requests with the launches by kernel and
    route, a timed step at 4 x 32000.
35. the mask estimator (``num_units=1024``: a BLSTM of 2 x 256 units on
    257 bins): the three float32 LSTM kernels and the Function against
    plain at its shape (T=128, 4 rows a direction: a training batch of 4 x
    16000 samples or a request's 4 channels; and a ragged batch), each
    with its TF32 control (plain with ``W_hh`` rounded to TF32: cuBLAS
    keeps these small products on its float32 path even with TF32
    allowed) and the route beside the mirror
    ``lstm.scan_grid``'s, timed beside plain, a cuDNN layer and the bound;
    ``masked_istft`` at a request's (one signal of 128 frames, size 512,
    shift 128), graph replays and eager; the recipe's ``test_run``, 4
    iterations, the first step against the CPU with dropout off on both,
    ``evaluate_example`` on the synthetic 4-channel database with MVDR
    (Souden) and with GEV + BAN (finite metric triples; the first
    request's masks against the CPU, and its metrics but GEV's beamformed
    ones, ``MASK_ESTIMATOR_METRIC_TOL``), a timed step.
36. the deep-clustering model (F=257, 2 x 600 BLSTM, E=20) on 4 of the pit
    recipe's synthetic mixtures with their ideal binary masks: the served
    embeddings and the first Adam step against the CPU, timed steps.
37. speech recognition (the ``speech_recognition/ctc`` recipe). 37a: the
    float32 attention kernels (forward, forward keeping the LSE, backward)
    against plain at heads of 24 (padded to 32 in the wrapper): the
    conformer's self-attention at the recipe's widest batch (8, 4, 32, 24)
    with ragged key padding, causal and ``attn_window=(16, 16)``, at a 10 s
    request's (1, 4, 165, 24) full and causal, the attention decoder's
    causal self-attention (8, 4, 9, 24) and cross-attention (9 queries
    over 32 ragged keys), each with its TF32 controls, timed beside plain,
    SDPA and the bound; the three LSTM kernels of one direction (the
    transducer's prediction network, H=96) at 8 rows and T=9 and at the
    greedy decode's one row, with their controls and the card's grid equal
    to the mirror ``lstm.scan_grid``'s, timed beside a cuDNN layer.  37b:
    the recipe's ``train.py`` at its defaults (d_model 96, 2 layers, 4
    heads, kernel 15, batches of 8, 10 tokens; 48 utterances, one epoch:
    ``test_run``, 5 iterations, validation, checkpoints) for ``ctc``,
    ``transducer``, ``aed`` and the ``--causal`` CTC variant, each run's
    attention and LSTM launches checked against its head; the first step
    of each against the CPU on the same batch and weights (1e-4); a timed
    step by stage.  37c: ``evaluate.py`` on 8 requests (CTC greedy and
    beam 4 with ``--lm_order 2``, transducer and attention head greedy and
    beam 4), then each head's requests one at a time, the latency on the
    host clock beside the encoder forward (CUDA events); the attention
    head's ``serve_decode`` equal to its greedy ``decode``; a causal
    transducer's ``stream_decode`` (its trained weights and its initial
    ones) equal to its offline greedy transcript; a request of 50 to 60
    tokens (about 10 s) through each head against the CPU.  Transcripts
    compared between two runs may part only where the two best scores of
    the first differing choice are closer than ``ASR_TIE``.
38. real audio.  38a: WAV trees written from a seed with
    ``contrib/examples/_wav_databases.py`` (int16 mono files of lengths up
    to two times apart, a stereo file, an int32 file and an 8 kHz file in
    each) and their JSON databases in the reference's schemas (wsj0-2mix's
    ``mix_2_spk_min_tr/cv/tt``, LibriSpeech's ``train_clean_100``,
    ``dev_clean``, ``test_clean``, AudioSet's ``balanced_train``,
    ``validate``, ``eval``, and ``create_jsons.py``'s output on its own
    tree); ``NATIVE_AVAILABLE`` must be true; ``AudioReader``'s time per
    file by kind on the host, one thread and four.  38b: the three GRU
    kernels against plain at the distance estimator's shape (one direction,
    8 rows, H=64, the 128 frames of 8000 samples at shift 64 pooled to 32
    steps, ragged; and 128 steps), with phase 8's TF32 controls.  38c:
    ``pit/train.py --database`` at the recipe's width (3 x 600 BLSTM) for
    an epoch of 2 steps, then ``evaluate.py --database --dataset
    mix_2_spk_min_tt`` on 3 requests.  38d: the speaker classifier's
    ``train.py`` and ``evaluate.py`` with ``--database
    --on_device_features``.  38e: the audio tagger's ``train.py`` and
    ``evaluate.py`` on the AudioSet tree (its CNN is cuDNN's: no kernel of
    the port).  38f: the distance estimator's ``train.py`` and
    ``evaluate.py`` (its GRU on the ``gru_cell_scan`` kernels).  38g: the
    vocoder's ``train.py --database`` for an epoch and ``evaluate.py
    --database`` on one file (the ``wavenet_sample`` kernel).  The
    kernels' launch counts are read around each run, each storage dir
    must hold its ``config.json``, checkpoints and ``Makefile``, and the
    evaluations' numbers must be finite.
39. the rest of the Trainer.  39a: the uPIT flagship at full width (3 x
    600 BLSTM, float32, the recipe's trainer, 2 batches of 4 an epoch, 3
    epochs) with ``LRSchedulerHook`` (an exponential decay a step),
    ``EMAHook`` (0.9), ``TorchProfilerHook`` over its first two steps and
    the validation after them, ``track_emissions`` and validation: the
    learning rate each step the schedule's, the average within 1e-6 of a
    host recomputation from the parameters recorded after each step, the
    trace naming the lean and training ``lstm_fwd_kernel`` and
    ``lstm_bwd_kernel``, the energy hook's ``chip_watts`` the
    ``nvidia-smi`` power limit, all three LSTM kernels launched; the time
    ``save_checkpoint`` blocks, synchronous and with
    ``async_checkpointing``; then the flagship with ``LRAnnealingHook``
    and ``register_validation_hook(maximize=True, n_back_off=1,
    back_off_patience=0, lr_update_factor=0.5)`` on the training batches:
    the back-off after the first two steps, the parameters then those of
    the best checkpoint bit for bit with ``ckpt_latest`` pointing at it,
    the learning rate each step the annealed one, halved until the next
    epoch.  39b: one batch's gradients of the flagship on the card;
    ``Adadelta``, ``Adafactor`` (``lr=1e-3`` and ``lr=None``), ``Lion``
    and ``Muon`` step three times on the card and on the CPU from the same
    parameters and gradients (1e-6 of a tensor's largest entry, Muon 1e-5:
    its Newton-Schulz products are summed in another order); two Trainer
    steps with each (finite losses) and its flagship step timed.  39c: the
    GAN vocoder recipe at its defaults (``base_channels=128``, upsampling
    (5, 5, 4, 2)): ``train.py --synthetic --async_checkpointing``, a
    resume from its asynchronous checkpoint, ``evaluate.py`` (finite
    metrics, 4 WAVs); one adversarial SGD step on the card against the CPU
    from the same weights and batch (1e-5), every parameter moved, a
    discriminator loss weight of 0 leaving the generator's update and the
    discriminator as they were; the adversarial step timed.  39d:
    ``InteractiveTrainer`` takes two steps and prints its scalars.
40. serving from exported artifacts (``serve.py`` over ``torch.export``;
    the six inference kernels are the ``ptt`` custom operators), LoRA and
    streaming, each part's kernel launches read around it, every number
    beside the card's name and power limit.  40a: the uPIT flagship (3 x
    600 BLSTM, F=257, K=2, float32) through ``dump_exported`` with
    symbolic batch and frames; ``forward.pt2`` loaded in a fresh process
    that imports torch and the operator registrations only, one request
    against the eager model; ``load_exported`` here and three requests of
    other batch sizes and lengths against the eager model on the card
    (3 lean LSTM launches each), a request's latency from the artifact
    beside eager; the same under the bf16 policy (the bf16 lean kernel);
    ``export_fn`` of a request's tensor part (the masks, then
    ``STFT.masked_inverse``: ``masked_istft`` from the artifact).  40b:
    bench.py's int8 decoder (d_model 1024, 12 layers, 16 heads, vocabulary
    1024, 128 frames of memory) with ``apply_lora`` on ``q_proj`` and
    ``v_proj``, ``mark_only_lora_trainable``, three float32 Adam steps on
    the card (only the factors move; the attention kernels' training
    pair), ``merge_lora`` against the adapted logits, bf16,
    ``quantize_module``, ``export_generate`` of 16 greedy steps through
    the first 2 of its layers (a depth cut: the unrolled trace grows with
    steps times layers; its seconds, nodes and size printed), served at
    B=1 and B=4 against eager ``autoregressive_generate`` of the same cut
    (equal tokens but at near ties; 8 ``int8_matmul`` launches a layer
    and one for the head a token, the cross K/V's 128 rows a request
    composed inside the operator), and a teacher-forced scoring forward
    of all 12 layers exported (the bf16 attention forward and
    ``int8_matmul`` from one artifact).  40c: the speaker classifier at
    the recipe's defaults with ``--on_device_features``, exported with
    symbolic batch and samples,
    three requests (``fused_logmel`` and the lean GRU forward).  40d: the
    online enhancer at the flagship's widths with one direction:
    ``StreamingSTFT`` (512/128), a 3 x 600 ``StatefulLSTM`` mask and
    ``StreamingISTFT`` on 4 s of 16 kHz audio in chunks of 4 frames,
    against the offline pipeline; ms a chunk, the real-time factor, and
    chunks x 3 lean LSTM launches.

The line before the last is a JSON object with each kernel's launches on
the main paths, the shape its numbers were taken at (``shape``; the other
shapes' are in the phases' own lines, the float32 LSTM kernels' and
``masked_istft``'s at phase 35's shapes also in ``other_shapes``, the
float32 LSTM and attention kernels' at phase 37a's in ``asr_shapes``, the
float32 GRU kernels' at phase 38b's in ``distance_shapes``), its
largest difference from the plain version, its time,
the plain version's, the library call's where there is one, and the
least time the card could take (``bound_ms``: the larger of bytes over
3.35 TB/s and float32 operations over 67 TFLOP/s, or for the bf16
products of int8_matmul and the bf16 LSTM and GRU kernels 989 TFLOP/s, for the
attention kernels' 3xTF32 products 495 / 3 TFLOP/s, for their bf16
variants 989 for the bf16 products, and for the bf16 backward's three
products of P and dS 989 taken three times, as the kernel computes them
in three bf16 pieces (its row also carries ``bound_2xtf32_ms``, those
three at 495 / 2, the definition of PR 14's 2xTF32 design), for
fused_logmel's
DFT products 495 / 3 and its mel product 67, NVIDIA's H100 SXM data
sheet), and the route a kernel with several
took there (``attention_route``, ``wavenet_route`` with the sampler's
launches by route, ``gru_route``, the GRU backward's and the bf16 GRU
kernels' launches by route, ``logmel_plan``, masked_istft's launches by route and ``fft_plan``;
fused_logmel's and masked_istft's ``ms`` from CUDA-graph replays, their
eager calls as ``eager_ms``; masked_istft's ``bound_ms`` is the FFT's,
``dft_bound_ms`` the direct synthesis product's); the last line
is ``{"ok": true, "device": {...}}``.  Any failed
check raises, so the script exits non-zero and prints no result; without
a CUDA card it fails at phase 1.  ``--profile`` adds a ``torch.profiler``
table of three training steps per shape with their busy time and casts
(phases 7, 11, 25), and the card's busy time per token of the B=1 decode
(phase 21).
"""
import contextlib
import copy
import ctypes
import functools
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from padertorch_tpu_torch.contrib.examples.audio_synthesis.wavenet import (
    data as wn_data, evaluate as wn_evaluate, train as wn_train)
from padertorch_tpu_torch.contrib.examples.audio_synthesis.wavenet.model \
    import WaveNetVocoder
from padertorch_tpu_torch.contrib.examples.source_separation.pit import (
    data as pit_data, train as pit_train)
from padertorch_tpu_torch.contrib.examples.source_separation.pit.evaluate \
    import evaluate_example
from padertorch_tpu_torch.contrib.examples.source_separation.tasnet import (
    data as tas_data, evaluate as tas_evaluate, train as tas_train)
from padertorch_tpu_torch.contrib.examples.source_separation.or_pit import (
    evaluate as orpit_evaluate, train as orpit_train)
from padertorch_tpu_torch.contrib.examples.speech_enhancement \
    .mask_estimator import evaluate as me_evaluate, train as me_train
from padertorch_tpu_torch.contrib.examples.speaker_classification \
    .supervised import (
        data as spk_data, evaluate as spk_evaluate, train as spk_train)
from padertorch_tpu_torch.contrib.examples.speaker_classification \
    .supervised.model import SpeakerClf
from padertorch_tpu_torch.contrib.examples.speech_recognition.ctc import (
    data as asr_data, evaluate as asr_evaluate, model as asr_model,
    train as asr_train)
from padertorch_tpu_torch.contrib.examples import _wav_databases as wav_dbs
from padertorch_tpu_torch.contrib.examples.sound_recognition.audio_tagging \
    import evaluate as tag_evaluate, train as tag_train
from padertorch_tpu_torch.contrib.examples.source_localization \
    .distance_estimator import (
        create_jsons as de_create_jsons, evaluate as de_evaluate,
        train as de_train)
from padertorch_tpu_torch.contrib.examples.source_separation.pit import (
    evaluate as pit_evaluate)
from padertorch_tpu_torch.contrib.je.data.transforms import AudioReader
from padertorch_tpu_torch.data.database import JsonDatabase
from padertorch_tpu_torch import native
from padertorch_tpu_torch.evaluation import NGramLM
from padertorch_tpu_torch.contrib.je.modules.features import (
    FusedAudioLogMelExtractor)
from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    MultiheadAttention, dense_attention, set_attention_backend)
from padertorch_tpu_torch.models.tasnet import TasNet
from padertorch_tpu_torch.modules.dual_path_transformer import (
    DualPathTransformer)
from padertorch_tpu_torch.modules.recurrent import set_rnn_backend
from padertorch_tpu_torch.models.bss import (
    DeepClusteringModel, PermutationInvariantTrainingModel)
from padertorch_tpu_torch.models.mask_estimator import SimpleMaskEstimator
from padertorch_tpu_torch.models.or_pit import OneAndRestPIT
from padertorch_tpu_torch.ops._stft import HostSTFT, STFT
from padertorch_tpu_torch.io import dump_config
from padertorch_tpu_torch.ops.kernels import _build
from padertorch_tpu_torch.ops.kernels import attention as attention_kernels
from padertorch_tpu_torch.ops.kernels import gru as gru_kernels
from padertorch_tpu_torch.ops.kernels import lstm as lstm_kernels
from padertorch_tpu_torch.ops.kernels.attention import (
    flash_attention, flash_attention_bwd_plain, flash_attention_fwd_plain,
    flash_attention_plain, should_use_flash, tf32_round, visible_mask)
from padertorch_tpu_torch.ops.kernels.gru import (
    gru_cell_scan, gru_cell_scan_plain, gru_cell_scan_train_plain,
    gru_cell_scan_bwd_plain)
from padertorch_tpu_torch.ops.kernels.lstm import (
    lstm_cell_scan, lstm_cell_scan_plain, lstm_cell_scan_train_plain,
    lstm_cell_scan_bwd_plain, recurrent_weight_grad)
from padertorch_tpu_torch.utils.nested import nested_merge
from padertorch_tpu_torch.ops.kernels.logmel import (
    LogMelFrontend, fused_logmel, logmel_plan, logmel_smem)
from padertorch_tpu_torch.ops.kernels import masked_istft as istft_kernels
from padertorch_tpu_torch.ops.kernels.masked_istft import (
    masked_istft, masked_istft_plain)
from padertorch_tpu_torch.ops.kernels import wavenet as wavenet_kernels
from padertorch_tpu_torch.ops.kernels.wavenet import (
    _gumbel, wavenet_sample, wavenet_sample_plain, wavenet_uniform)
from padertorch_tpu_torch.migrate import to_jax_state_dict
from padertorch_tpu_torch.serialize import load_state
from padertorch_tpu_torch.train import optimizer as train_optim
from padertorch_tpu_torch.train.hooks import (
    BackOffValidationHook, EMAHook, EnergyEstimateHook, Hook,
    LRAnnealingHook, LRSchedulerHook, TorchProfilerHook, ValidationHook)
from padertorch_tpu_torch.train.optimizer import Adam
from padertorch_tpu_torch.train.trainer import InteractiveTrainer, Trainer
from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    TransformerDecoder, autoregressive_generate)
from padertorch_tpu_torch.ops.kernels import int8_matmul as int8_kernels
from padertorch_tpu_torch.ops.kernels.int8_matmul import (
    int8_matmul, int8_matmul_plain)
from padertorch_tpu_torch.quantize import QuantizedLinear, quantize_module
from padertorch_tpu_torch.serve import (
    ContinuousBatcher, dump_exported, export_fn, export_generate,
    export_model, load_exported)
from padertorch_tpu_torch.lora import (
    apply_lora, mark_only_lora_trainable, merge_lora)
from padertorch_tpu_torch.modules.recurrent import StatefulLSTM
from padertorch_tpu_torch.ops.kernels import _ops
from padertorch_tpu_torch.ops.streaming import StreamingISTFT, StreamingSTFT

# f32 sums in another order over 500 recurrent steps; about 20x the
# difference the card shows, and far below what a TF32 recurrent product
# gives (phase 3 measures that control and requires it to fail the limit)
LSTM_TOL = 1e-5
ISTFT_TOL = 1e-4   # f32 sums of 2 * 257 * 4 products per sample
MODEL_TOL = 1e-6   # masks after 3 BLSTM layers of 500 steps, card vs CPU
SI_SDR_TOL = 1e-2  # dB, card vs CPU on the same request
# backward kernel vs its plain version on the same residuals: the same f32
# arithmetic, the 4H-long sum in another order, carried over 500 steps;
# about 20x what the card shows, and a TF32 product fails it (phase 6)
LSTM_BWD_TOL = 1e-5
# the whole Function vs autograd through the plain forward, relative to
# each gradient's largest entry (dW_hh sums 16,000 products per entry):
# about 20x what the card shows; autograd through a TF32 forward fails it
LSTM_GRAD_RTOL = 5e-5
# first step's loss and gradient norm, card vs CPU, relative: f32 sums in
# another order (the card shows the same float32 values as the CPU)
STEP_RTOL = 1e-5

# GRU kernels: the LSTM kernels' limits (the same arithmetic with three
# gates), each with its TF32 control (phase 8)
GRU_TOL = 1e-5
GRU_BWD_TOL = 1e-5
GRU_GRAD_RTOL = 5e-5
# full-width TasNet `out` (separated signals of amplitude about 1 after
# twelve recurrences, layer norms and the decoder), card vs CPU
TASNET_TOL = 1e-4
# first TasNet step, card vs CPU: the loss is a mean of log10 ratios, the
# norm sums 2.6 M gradients through twelve recurrences' adjoints
TASNET_STEP_RTOL = 1e-4

# attention kernels vs the plain masked softmax: the same f32 arithmetic,
# the sum over keys in tiles of 64 with a running maximum (about 10x what
# the card shows); gradients relative to each gradient's largest entry, as
# the recurrences' Functions
ATTENTION_TOL = 1e-5
ATTENTION_GRAD_RTOL = 5e-5
# the bf16 attention kernels vs their plain bf16 versions (phase 26), the
# forward's plain taking keys in the kernel's tiles of 64 (P rounded to
# bf16 against the running maximum, as the JAX kernel against its
# blocks).  O: one bf16 unit in the last place of the larger value plus
# 2e-3 (a probability whose float32 value lies at a rounding boundary
# rounds the other way after exp2 in place of exp and the tensor cores'
# sums, moving an output near 0 by more than its own unit), at most 1% of
# the elements other: a CPU emulation of the kernel's arithmetic read up
# to 6.1e-4 beyond one unit and 0.11% differing; the control, logits
# rounded to bf16, 19.5% to 64% differing and 3.5e-3 to 1.2e-2 beyond.
# Gradients: float32 sums in another order, rounded once: one unit plus
# 1e-5 of the gradient's largest entry, and at most 1% of the elements
# differing by more than that (a query row that sees one key has dS =
# p (dP - delta) = 0 in exact arithmetic, so its dq, and its key's dk
# summed over every query of the group, are rounding noise that differs
# wherever the sums' order does: on an H100 80GB HBM3 at 700 W, 1.2e-5
# beyond one unit at (4, 8 over 2, 1024, 64), 3.8% of the elements at a
# card test's shape by more than 0);
# the control, P and dS rounded to bf16, 13.7% to 42% in the emulation.
# LSE float32: 1e-5 of max(|lse|, 1) (a row of one key has lse = its one
# logit, which may be near 0).
ATTENTION_BF16_FWD_ATOL = 2e-3
ATTENTION_BF16_FWD_SHARE = 0.01
ATTENTION_BF16_GRAD_RTOL = 1e-5
ATTENTION_BF16_GRAD_SHARE = 0.01
ATTENTION_BF16_LSE_TOL = 1e-5
# first SepFormer step, card vs CPU, relative
SEPFORMER_LOSS_RTOL = 1e-5
SEPFORMER_NORM_RTOL = 1e-4

# wavenet_sample vs its plain step loop, teacher-forced logits (of size
# about 7): the same f32 arithmetic, each product's sum in another order,
# through 16 gated layers; the JAX package's own limit for its kernel, about
# 6x what the card shows; the plain loop with TF32 products fails it
WAVENET_TOL = 2e-5
# full-width vocoder logits, card vs CPU, and sampler vs training graph
WAVENET_MODEL_TOL = 1e-4
# fused_logmel vs its plain version, on log-mel values between about -10
# and 10: f32 sums of 2 * 512 * 257 products in another order, about 10x
# what the card shows; the plain version with TF32 products fails it
LOGMEL_TOL = 1e-5
# the composed module path frames and multiplies in other code
LOGMEL_COMPOSED_TOL = 1e-4
# first training steps, card vs CPU, relative (loss, gradient norm)
WAVENET_STEP_RTOL = (1e-5, 1e-4)
SPEAKER_STEP_RTOL = (1e-5, 1e-4)
# speaker classifier logits, card vs CPU
SPEAKER_TOL = 1e-4
# int8_matmul vs its plain version: float32 sums of K products in another
# order, relative to the output's largest value; in bf16 both round one
# float32 sum, so one bf16 unit in the last place plus that float32 limit
# (the composed route, which rounds every scaled weight to bf16 first,
# must fail it)
INT8_TOL = 1e-5
INT8_BF16_ULPS = 1.0
# the B=1 decode of phase 21: teacher-forced decode_step logits against
# TransformerDecoder.forward (float32, relative to the largest logit), and
# the int8 kernel route against the composed route on bf16 forward logits
# (|diff| / (1 + |composed|), bench.py's limit: the two round differently)
DECODE_RTOL = 1e-4
INT8_ROUTES_RTOL = 0.05
# phase 22: batched against single decoding of a request, bf16 logits
# relative to the largest logit (attention sums over caches of another
# length); tokens may differ only where the two best logits are closer
SERVE_LOGIT_RTOL = 0.02

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM, HBM3
PEAK_F32_FLOPS = 67e12       # H100 SXM, float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # H100 SXM, bf16 on the tensor cores, dense
PEAK_TF32_FLOPS = 495e12     # H100 SXM, TF32 on the tensor cores, dense
# float32 products as three TF32 products each (hi*hi + hi*lo + lo*hi)
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
# a float32 operand times a bf16 one: two TF32 products (hi*b + lo*b)
PEAK_2XTF32_FLOPS = PEAK_TF32_FLOPS / 2
PEAK_NAMES = {PEAK_F32_FLOPS: 'float32', PEAK_BF16_FLOPS: 'bf16 tensor cores',
              PEAK_3XTF32_FLOPS: '3xTF32 tensor cores',
              PEAK_2XTF32_FLOPS: '2xTF32 tensor cores'}


def fail(msg):
    raise RuntimeError(msg)


def cuda_ms(fn, iters, warmup=1):
    """Mean milliseconds of ``fn`` on the card, by CUDA events."""
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


def cuda_ms_median(fn, iters, windows=5, warmup=3):
    """Median of ``windows`` runs of :func:`cuda_ms` after a warm-up, and
    the window means themselves."""
    for _ in range(warmup):
        fn()
    means = sorted(cuda_ms(fn, iters, warmup=0) for _ in range(windows))
    return means[len(means) // 2], means


def graph_ms(fn, iters=50):
    """Mean milliseconds of ``fn`` on the card with no host work between
    calls: ``iters`` calls captured in one CUDA graph, replayed and timed
    by CUDA events.  For calls whose eager time is the host's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = cuda_ms(graph.replay, iters=5, warmup=1) / iters
    del graph
    return ms


def max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def max_rel_err(a, b):
    """Largest difference relative to each reference's largest entry."""
    return max(float((x - y).abs().max() / y.abs().max())
               for x, y in zip(a, b))


def with_zeros(launches, want):
    """``want`` with every other kernel that ``launches`` counts at zero
    (the LSTM and GRU wrappers also count their bf16 variants)."""
    return {**dict.fromkeys(launches, 0), **want}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes, flops, peak=PEAK_F32_FLOPS):
    """The least time the card could take for the work: each input read
    and each output written once at the memory's peak rate, or the
    operations at ``peak`` (the float32 peak unless the products run on
    the tensor cores), whichever is larger; ``peak`` names that rate."""
    return bound_mixed(n_bytes, [(flops, peak)])


def bound_mixed(n_bytes, parts):
    """:func:`bound` for work whose operations run at several rates:
    ``parts`` is [(operations, peak), ...], their times added."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = sum(flops / peak for flops, peak in parts) * 1e3
    return {'bound_ms': max(by_bytes, by_ops),
            'bound_by': 'bytes' if by_bytes >= by_ops else 'operations',
            'peak': ' and '.join(PEAK_NAMES[peak] for _, peak in parts)}


def lstm_flops(mask, hdim):
    """Operations the recurrence needs on these inputs: per valid (step,
    row) one (1, H) x (H, 4H) product (2 per multiply-add) and about 30
    for the cell; masked steps need none."""
    return float(mask.sum()) * (2 * hdim * 4 * hdim + 30 * hdim)


def gru_flops(valid_steps, hdim):
    """As ``lstm_flops`` with three gates: per valid (step, row) one
    (1, H) x (H, 3H) product and about 25 for the cell.  The backward
    kernel holds one product of the same size (``dgh @ W_hh^T``; ``dW_hh``
    is a product outside it)."""
    return float(valid_steps) * (2 * hdim * 3 * hdim + 25 * hdim)


def phase_device():
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this script needs a card')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    global CARD
    CARD = smi
    # float32 is the package's decision, made where it is imported
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        fail('importing padertorch_tpu_torch left TF32 on')
    print(f'phase 1 device: {torch.cuda.get_device_name(0)} x'
          f'{torch.cuda.device_count()}, torch {torch.__version__}, '
          f'CUDA {torch.version.cuda}, python {sys.version.split()[0]}')


def phase_build():
    start = time.perf_counter()
    _build.load_library()
    print(f'phase 2 build: kernels loaded in '
          f'{time.perf_counter() - start:.2f} s')


# the DPRNN's two recurrence shapes at B=4 x 32000 samples (3199 encoder
# frames, 65 chunks of 100 with hop 50), and the uPIT flagship's:
# (label, T, rows per direction, H, mask kind)
RECURRENCE_SHAPES = [
    ('intra T=100 D*B=520 H=128', 100, 260, 128, None),
    ('inter T=65 D*B=800 H=128', 65, 400, 128, 'chunks'),
    ('T=500 D*B=32 H=600', 500, 16, 600, 'ragged'),
]


# the speaker classifier's GRU: one direction, under the frame mask of a
# ragged batch; the recipe's run (8 x 8000 samples: 66 frames, 32 channels x
# 16 mel bands into 64 units) and the class defaults on 16 x 4 s (503
# frames, 64 x 16 into 256 units):
# (label, T, rows, H, mask kind, width of the layer's input)
CLASSIFIER_GRU_SHAPES = [
    ('classifier recipe T=66 D*B=8 H=64 one direction', 66, 8, 64, 'ragged',
     512),
    ('classifier defaults T=503 D*B=16 H=256 one direction', 503, 16, 256,
     'ragged', 1024),
]


def recurrence_mask(t_len, batch, kind, rng, directions=2):
    """(T, directions * batch) mask, the second direction's reversed in
    time, or None.  'chunks': the
    inter-chunk RNN's, every one of the K=100 positions of an example
    sharing its chunk count (4 examples of 2 to 4 s); 'full': every row
    valid at every step (the mask a batch of equal lengths gives); 'ragged':
    lengths in [T/2, T]; 'prefix': the same lengths with the padding before
    the valid steps."""
    if kind is None:
        return None
    if kind == 'chunks':
        lens = np.repeat([t_len, t_len - 11, t_len - 20, t_len - 30],
                         batch // 4)
    elif kind == 'full':
        lens = np.full(batch, t_len)
    else:
        lens = rng.randint(t_len // 2, t_len + 1, size=batch)
        lens[0] = t_len
    fwd = np.arange(t_len)[:, None] < lens[None, :]
    if kind == 'prefix':
        fwd = fwd[::-1]
    return np.concatenate([fwd, fwd[::-1]][:directions], axis=1).astype(
        'float32')


def recurrence_inputs(t_len, batch, hdim, kind, gates, seed=0, directions=2):
    """Kernel inputs and cotangents of a layer of ``directions`` directions
    with ``gates`` gate blocks (3: GRU, 4: LSTM)."""
    rng = np.random.RandomState(seed)
    bound = 1 / np.sqrt(hdim)
    mask = recurrence_mask(t_len, batch, kind, rng, directions)
    rows = directions * batch
    arrays = [rng.uniform(-1, 1, (t_len, rows, gates * hdim)),
              rng.uniform(-bound, bound, (directions, hdim, gates * hdim)),
              mask]
    arrays += [rng.uniform(-0.1, 0.1, (rows, hdim))
               for _ in range(gates - 2)]                  # h0 (, c0)
    cot = [rng.uniform(-1, 1, (t_len, rows, hdim))]
    cot += [rng.uniform(-1, 1, (rows, hdim)) for _ in range(gates - 2)]

    def put(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a, 'float32')).cuda()

    return [put(a) for a in arrays], [put(a) for a in cot]


def phase_lstm():
    args, _ = recurrence_inputs(500, 16, 600, 'ragged', gates=4)
    got = lstm_cell_scan(*args)
    want = lstm_cell_scan_plain(*args)
    torch.cuda.synchronize()
    err = max_err(got, want)
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32_err = max_err(lstm_cell_scan_plain(*args), want)
    torch.backends.cuda.matmul.allow_tf32 = False
    ms = cuda_ms(lambda: lstm_cell_scan(*args), iters=20)
    plain_ms = cuda_ms(lambda: lstm_cell_scan_plain(*args), iters=3)
    library = cudnn_lstm_ms()
    gx, w, mask, h0, c0 = args
    limit = bound(nbytes(*args, *got), lstm_flops(mask, 600))
    print(f'phase 3 lstm_cell_scan T=500 D*B=32 H=600: max |kernel - plain| '
          f'{err:.3e} (tol {LSTM_TOL}), plain with TF32 vs f32 '
          f'{tf32_err:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, '
          f'bound {limit["bound_ms"]:.3f} ms by {limit["bound_by"]}')
    print(f'phase 3 yardsticks at T=500 B=16 in=1200 H=600 f32: one '
          f'bidirectional torch.nn.LSTM layer (cuDNN; includes the input '
          f'projection, takes no mask) forward {library["fwd"]:.3f} ms '
          f'(no grad), {library["fwd_train"]:.3f} ms (grad mode), backward '
          f'{library["bwd"]:.3f} ms; the einsum input projection alone '
          f'{library["projection"]:.3f} ms')
    if not err <= LSTM_TOL:
        fail(f'lstm_cell_scan kernel disagrees with plain: {err}')
    if not tf32_err > LSTM_TOL:
        fail(f'the limit {LSTM_TOL} does not tell a TF32 recurrence from '
             f'f32: {tf32_err}')
    return {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms, **limit,
            'library_ms': library['fwd']}, library


def cudnn_layer_ms(layer_cls, t_len, batch, in_size, hdim, directions=2,
                   dtype=torch.float32):
    """Yardstick, timed here and used nowhere in the port: one
    ``torch.nn.LSTM`` or ``torch.nn.GRU`` layer of ``directions`` directions
    (cuDNN; it includes the input projection and takes no mask), forward
    without and with grad mode, and backward, in ``dtype``."""
    torch.manual_seed(0)
    layer = layer_cls(in_size, hdim, bidirectional=directions == 2).to(
        'cuda', dtype)
    x = torch.randn(t_len, batch, in_size, device='cuda', dtype=dtype)
    with torch.no_grad():
        fwd = cuda_ms(lambda: layer(x), iters=10, warmup=2)
    fwd_train = cuda_ms(lambda: layer(x), iters=10, warmup=2)
    out, _ = layer(x)
    d_out = torch.randn_like(out)
    bwd = cuda_ms(
        lambda: torch.autograd.grad(out, list(layer.parameters()), d_out,
                                    retain_graph=True), iters=10, warmup=2)
    return {'fwd': fwd, 'fwd_train': fwd_train, 'bwd': bwd}


def cudnn_lstm_ms(t_len=500, batch=16, in_size=1200, hdim=600):
    """The cuDNN yardstick at the flagship layer's shape, and the port's
    input projection (one einsum) alone."""
    times = cudnn_layer_ms(torch.nn.LSTM, t_len, batch, in_size, hdim)
    x = torch.randn(t_len, batch, in_size, device='cuda')
    x_pair = torch.stack([x, x.flip(0)])
    w_ih = torch.randn(2, 4 * hdim, in_size, device='cuda')
    times['projection'] = cuda_ms(
        lambda: torch.einsum('dtbf,dgf->tdbg', x_pair, w_ih), iters=10,
        warmup=2)
    return times


def istft_inputs(n_rows, frames, seed=0, n_bins=257):
    rng = np.random.RandomState(seed)
    spec = rng.randn(frames, n_bins, 2).astype('float32') * 10
    mask = rng.uniform(0, 1, (n_rows, frames, n_bins)).astype('float32')
    return (torch.from_numpy(spec).cuda(), torch.from_numpy(mask).cuda())


def overlap_add(seg, shift):
    """(N, frames, L) segments -> (N, (frames - 1) * shift + L) signals."""
    frames, length = seg.shape[-2:]
    total = (frames - 1) * shift + length
    out = torch.nn.functional.fold(
        seg.transpose(-1, -2), output_size=(1, total),
        kernel_size=(1, length), stride=(1, shift))
    return out.reshape(seg.shape[0], total)


def istft_float64(spec, mask, stft):
    """``stft.inverse(spec * mask)`` in float64 on the card, from the
    float64 synthesis kernels: the accuracy yardstick of phase 4."""
    k_real, k_imag = (torch.from_numpy(k).cuda()
                      for k in stft._istft_kernel_np)
    re = spec[..., 0].double() * mask.double()
    im = spec[..., 1].double() * mask.double()
    re_full = torch.cat([re, re[..., 1:-1].flip(-1)], dim=-1)
    im_full = torch.cat([im, -im[..., 1:-1].flip(-1)], dim=-1)
    return stft.crop_fading(
        overlap_add(re_full @ k_real + im_full @ k_imag, stft.shift))


def istft_cufft(spec, mask, stft, window):
    """The same function composed from library calls, a yardstick the port
    never calls: the mask multiply, ``torch.fft.irfft`` (cuFFT), the
    window (``window``: the synthesis window times size) and the
    overlap-add by ``F.fold``."""
    x = torch.complex(spec[..., 0], spec[..., 1]) * mask
    seg = torch.fft.irfft(x, n=stft.size)[..., :stft.window_length] * window
    return stft.crop_fading(overlap_add(seg, stft.shift))


def fft_flops(n_rows, frames, size, length):
    """Operations of the fft route per these inputs: per (row, frame) a
    complex FFT of size / 2 points (5 M log2 M), the packing of the real
    transform with the mask multiplied in (about 16 M) and the window and
    overlap-add (2 L)."""
    m = size // 2
    per_frame = 5 * m * np.log2(m) + 16 * m + 2 * length
    return float(n_rows * frames * per_frame)


def masked_istft_rows(spec, mask, stft, **launch):
    """The kernel through its launch with ``launch``'s options (a plan,
    the twiddle control), cropped as ``masked_istft`` does."""
    re, im, rows_mask, lead = istft_kernels._split(spec, mask, stft)
    rows = istft_kernels._launch(re, im, rows_mask, stft, **launch)
    return stft.crop_fading(rows.reshape(*lead, rows.shape[-1]))


# geometries beyond the recipe's, each against plain on the card with the
# route it takes: size 4096 at both shifts (2049 bins; the parent kernel
# refused them), size 8192 (the fft route's largest, 16 values a thread),
# windows shorter than the size, a size that is no power of two (timed),
# and 70,000 signal rows on both routes:
# (size, shift, window_length, signal rows, frames, route, timed)
ISTFT_GEOMETRIES = [
    (4096, 1024, None, 2, 40, 'fft', False),
    (4096, 2048, None, 2, 40, 'fft', False),
    (8192, 2048, None, 2, 40, 'fft', False),
    (512, 100, 400, 2, 127, 'fft', False),
    (512, 20, 40, 2, 127, 'fft', False),
    (400, 100, None, 2, 127, 'dft', True),
    (64, 16, None, 70000, 12, 'fft', False),
    (48, 12, None, 70000, 12, 'dft', False),
]


def phase_istft():
    """Phase 4: masked_istft on both routes at the recipe's geometry, its
    accuracy against float64 beside the twiddle control, the cuFFT
    composition, bits alone and in a batch, and the other geometries."""
    stft = STFT(pit_data.STFT_SIZE, pit_data.STFT_SHIFT, fading='full',
                complex_representation='stacked')
    size, n_bins = pit_data.STFT_SIZE, pit_data.STFT_SIZE // 2 + 1
    window = torch.from_numpy(
        stft._istft_kernel_np[0][0] * size).float().cuda()
    n_sm, max_smem = gru_kernels.device_limits(0)
    results = {}
    for n_rows, frames in ((2, 127), (32, 500)):
        spec, mask = istft_inputs(n_rows, frames)
        before = dict(masked_istft.routes)
        got = masked_istft(spec, mask, stft=stft)
        dft = istft_kernels.dft_plan(n_rows, frames, n_bins, stft.shift,
                                     4, max_smem)
        got_dft = masked_istft_rows(spec, mask, stft, plan=dft)
        if (masked_istft.routes['fft'] != before['fft'] + 1
                or masked_istft.routes['dft'] != before['dft'] + 1):
            fail(f'masked_istft routes {masked_istft.routes}, before '
                 f'{before}: expected one fft and one dft launch')
        fast = masked_istft_rows(spec, mask, stft, fast_twiddles=True)
        want = masked_istft_plain(spec, mask, stft=stft)
        composed = istft_cufft(spec, mask, stft, window)
        want64 = istft_float64(spec, mask, stft)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f'masked_istft shape {tuple(got.shape)} != '
                 f'{tuple(want.shape)}')
        err = max_err([got], [want])
        err_dft = max_err([got_dft], [want])
        err_cufft = max_err([composed], [want])
        to64 = {name: float((x.double() - want64).abs().max())
                for name, x in (('fft', got), ('dft', got_dft),
                                ('plain', want), ('fast_twiddles', fast),
                                ('cufft', composed))}
        plan = istft_kernels.fft_plan(n_rows, frames, size, stft.shift, 4,
                                      n_sm, max_smem)
        timed = {
            'fft': lambda: masked_istft(spec, mask, stft=stft),
            'dft': lambda: masked_istft_rows(spec, mask, stft, plan=dft),
            'cufft': lambda: istft_cufft(spec, mask, stft, window)}
        eager = {name: cuda_ms(fn, iters=20, warmup=3)
                 for name, fn in timed.items()}
        graph = {name: graph_ms(fn, iters=20) for name, fn in timed.items()}
        plain_ms = cuda_ms(
            lambda: masked_istft_plain(spec, mask, stft=stft), iters=20)
        io_bytes = nbytes(spec, mask, got)
        limit = bound(io_bytes + size * 8 + stft.window_length * 4,
                      fft_flops(n_rows, frames, size, stft.window_length))
        # per row and frame 2 * F * size multiply-adds (two synthesis
        # matrices of (F, size), themselves an input of F * size * 2)
        dft_limit = bound(io_bytes + n_bins * size * 2 * 4,
                          n_rows * frames * 2 * 2 * n_bins * size)
        print(f'phase 4 masked_istft ({n_rows}, {frames}, {n_bins}): fft '
              f'route, plan {plan._asdict()}: max |kernel - plain| '
              f'{err:.3e} (tol {ISTFT_TOL}); from CUDA-graph replays fft '
              f'{graph["fft"]:.4f} ms, dft {graph["dft"]:.4f}, cuFFT '
              f'composition {graph["cufft"]:.4f}; eager fft '
              f'{eager["fft"]:.4f}, dft {eager["dft"]:.4f}, cuFFT '
              f'composition {eager["cufft"]:.4f}, plain {plain_ms:.4f}; '
              f'bound {limit["bound_ms"]:.4f} ms by {limit["bound_by"]} '
              f'(the FFT\'s), {dft_limit["bound_ms"]:.4f} by '
              f'{dft_limit["bound_by"]} (the DFT\'s); max |dft - plain| '
              f'{err_dft:.3e}, |cuFFT composition - plain| {err_cufft:.3e}; '
              f'max |x - float64|: ' + ', '.join(
                  f'{name} {value:.3e}' for name, value in to64.items()),
              flush=True)
        for name, value in (('kernel', err), ('dft route', err_dft)):
            if not value <= ISTFT_TOL:
                fail(f'masked_istft {name} disagrees with plain: {value}')
        results[(n_rows, frames)] = {
            'max_abs_err': err, 'ms': graph['fft'],
            'eager_ms': eager['fft'], 'plain_ms': plain_ms, **limit,
            'dft_bound_ms': dft_limit['bound_ms'],
            'dft_route_ms': graph['dft'], 'dft_route_eager_ms': eager['dft'],
            'library_ms': None,
            'library': 'none: torch.istft centres frames and divides by the '
                       'window envelope; the cuFFT composition is timed '
                       'beside it',
            'cufft_composition_ms': graph['cufft'],
            'cufft_composition_eager_ms': eager['cufft'],
            'max_abs_err_to_float64': to64['fft'],
            'twiddle_control_err_to_float64': to64['fast_twiddles'],
            'fft_plan': plan._asdict()}

    # one signal alone, in the batch of 32 and under two more plans
    spec, mask = istft_inputs(32, 500)
    batch = masked_istft(spec, mask, stft=stft)
    alone = masked_istft(spec, mask[5:6], stft=stft)
    plans = [istft_kernels.FftPlan(
        rows, at_once, 4, at_once * size // 8, 32 * -(-503 // rows),
        istft_kernels.fft_smem(size, stft.shift, rows, at_once))
        for rows, at_once in ((1, 4), (4, 2))]
    planned = [masked_istft_rows(spec, mask, stft, plan=plan)
               for plan in plans]
    same = (torch.equal(batch[5:6], alone)
            and all(torch.equal(x, batch) for x in planned))
    batch_plan = istft_kernels.fft_plan(32, 500, size, stft.shift, 4, n_sm,
                                        max_smem)
    print(f'phase 4 signal 5 of (32, 500) alone, in the batch (plan rows '
          f'{batch_plan.rows}, frames {batch_plan.frames}) and under plans '
          f'(1, 4) and (4, 2): the same bits {same}', flush=True)
    if not same:
        fail('masked_istft gives other bits alone, in a batch or under '
             'another plan')

    for (g_size, shift, length, n_rows, frames, route,
         timed) in ISTFT_GEOMETRIES:
        g_stft = STFT(g_size, shift, window_length=length, fading='full',
                      complex_representation='stacked')
        spec, mask = istft_inputs(n_rows, frames, seed=g_size + shift,
                                  n_bins=g_size // 2 + 1)
        before = dict(masked_istft.routes)
        got = masked_istft(spec, mask, stft=g_stft)
        want = masked_istft_plain(spec, mask, stft=g_stft)
        torch.cuda.synchronize()
        err = max_err([got], [want])
        took = [name for name in before
                if masked_istft.routes[name] != before[name]]
        line = (f'phase 4 masked_istft size {g_size}, shift {shift}, '
                f'window_length {g_stft.window_length}, ({n_rows}, {frames}): '
                f'route {took}, max |kernel - plain| {err:.3e}')
        if timed:
            def kernel():
                return masked_istft(spec, mask, stft=g_stft)

            def plain():
                return masked_istft_plain(spec, mask, stft=g_stft)

            line += (f'; from CUDA-graph replays '
                     f'{graph_ms(kernel, iters=20):.4f} ms, eager '
                     f'{cuda_ms(kernel, iters=20, warmup=3):.4f}, plain '
                     f'{cuda_ms(plain, iters=20):.4f}')
        print(line, flush=True)
        if took != [route] or not err <= ISTFT_TOL:
            fail(f'masked_istft at size {g_size}, shift {shift}: route '
                 f'{took} (expected {route}), error {err}')
        del spec, mask, got, want
    torch.cuda.empty_cache()
    return results


def ragged_batch(batch, frames, seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(frames // 2, frames + 1, size=batch)
    lens[0] = frames
    y = np.abs(rng.randn(batch, frames, 257)).astype('float32')
    y *= (np.arange(frames)[None, :, None] < lens[:, None, None])
    return {'Y_abs': torch.from_numpy(y),
            'num_frames': torch.from_numpy(lens.astype('int64'))}


def reset_launches():
    for wrapper in (lstm_cell_scan, gru_cell_scan, flash_attention):
        for name in wrapper.launches:
            wrapper.launches[name] = 0
    for counts in (*lstm_cell_scan.routes.values(),
                   *gru_cell_scan.routes.values()):
        for name in counts:
            counts[name] = 0
    masked_istft.launches = 0
    for name in masked_istft.routes:
        masked_istft.routes[name] = 0
    wavenet_sample.launches = 0
    for name in wavenet_sample.routes:
        wavenet_sample.routes[name] = 0
    fused_logmel.launches = 0
    int8_matmul.launches = 0


def check_gru_routes(label, route, **by_kernel):
    """Every GRU launch since the counts were last reset took its kernel's
    route: ``by_kernel`` names it for a kernel (``fwd_train_bf16='mma'``:
    the bf16 training forward and backward of the DPRNN's chunk RNNs and of
    the classifier recipe's GRU), ``route`` for the others (the DPRNN's
    and the classifier recipe's the resident one, the classifier
    defaults' the cooperative one).  Returns the launches by kernel and
    route of the kernels launched."""
    taken = {kernel: {r: n for r, n in routes.items() if n}
             for kernel, routes in gru_cell_scan.routes.items()
             if gru_cell_scan.launches[kernel]}
    want = {kernel: {by_kernel.get(kernel, route):
                     gru_cell_scan.launches[kernel]} for kernel in taken}
    if not taken or taken != want:
        fail(f'{label}: GRU launches {gru_cell_scan.launches}, by kernel '
             f'and route {taken}; expected {want}')
    return taken


def gru_routes_of(*kernels):
    """The launches of the GRU ``kernels`` by route, added up."""
    return {route: sum(gru_cell_scan.routes[k][route] for k in kernels)
            for route in gru_cell_scan.routes['fwd']}


# the GRU backward's launches on the main paths by route (the kernels
# line's launches_by_route): added up where the main paths' counts are read
GRU_BWD_MAIN_ROUTES = dict.fromkeys(gru_cell_scan.routes['bwd'], 0)


def add_main_bwd_routes():
    for name, n in gru_cell_scan.routes['bwd'].items():
        GRU_BWD_MAIN_ROUTES[name] += n


def phase_slice():
    torch.manual_seed(0)
    model_cpu = PermutationInvariantTrainingModel(
        F=257, recurrent_layers=3, units=600, K=2).eval()
    model = copy.deepcopy(model_cpu).to('cuda')

    batch = ragged_batch(4, 500)
    with torch.no_grad():
        want = model_cpu(batch)
        got = model({k: v.cuda() for k, v in batch.items()}).cpu()
    err = float((got - want).abs().max())
    print(f'phase 5a full-width model B=4 T=500, card vs CPU: max |diff| '
          f'{err:.3e} (tol {MODEL_TOL})')
    if not err <= MODEL_TOL:
        fail(f'model masks on the card disagree with the CPU: {err}')

    stft = HostSTFT(pit_data.STFT_SIZE, pit_data.STFT_SHIFT, fading='full',
                    complex_representation='complex')
    examples = list(pit_data.synthetic_database(num_examples=8, seed=2))
    reset_launches()
    latencies, results = [], {}
    for example in examples:
        start = time.perf_counter()
        example_id, metrics = evaluate_example(model, stft, example)
        latencies.append((time.perf_counter() - start) * 1e3)
        results[example_id] = metrics
    launches = {'lstm_cell_scan': lstm_cell_scan.launches['fwd'],
                'masked_istft': masked_istft.launches}
    print(f'phase 5b served {len(results)} requests, latency ms '
          f'{[round(x, 3) for x in latencies]} (median '
          f'{np.median(latencies):.3f}), launches {launches}')
    if len(results) != 8:
        fail(f'{len(results)} of 8 requests served')
    for name, n in launches.items():
        if n == 0:
            fail(f'the main path never launched the {name} kernel')
    launches['masked_istft_routes'] = dict(masked_istft.routes)
    print(f'phase 5b masked_istft launches by route '
          f'{launches["masked_istft_routes"]}')
    if masked_istft.routes != {'fft': launches['masked_istft'], 'dft': 0}:
        fail(f'the requests\' masked_istft launches did not all take the '
             f'fft route: {masked_istft.routes}')
    for example_id, metrics in results.items():
        values = np.asarray(metrics['output_si_sdr']
                            + metrics['output_mir_eval_sxr_sdr'])
        if values.shape != (4,) or not np.isfinite(values).all():
            fail(f'{example_id}: bad output metrics {metrics}')
    for example in examples[:2]:
        _, ref = evaluate_example(model_cpu, stft, example)
        diff = np.abs(np.subtract(
            ref['output_si_sdr'],
            results[example['example_id']]['output_si_sdr'])).max()
        print(f'phase 5c {example["example_id"]} SI-SDR card vs CPU: max '
              f'|diff| {diff:.3e} dB (tol {SI_SDR_TOL})')
        if not diff <= SI_SDR_TOL:
            fail(f'SI-SDR on the card disagrees with the CPU: {diff}')

    big = {k: v.cuda() for k, v in ragged_batch(16, 500, seed=1).items()}
    with torch.no_grad():
        ms = cuda_ms(lambda: model(big), iters=10, warmup=2)
    print(f'phase 5d batched forward B=16 T=500: {ms:.3f} ms')
    return launches


def phase_train_kernels(library):
    """Phase 6: the two training kernels and the Function around them."""
    args, _ = recurrence_inputs(500, 16, 600, 'ragged', gates=4)
    gx, w, mask, h0, c0 = args
    rng = np.random.RandomState(1)
    cot = [torch.from_numpy(rng.uniform(-1, 1, shape).astype('float32'))
           .cuda() for shape in ((500, 32, 600), (32, 600), (32, 600))]

    def fwd_train():
        return lstm_kernels._launch(gx, w, 2, mask, h0, c0, train=True)

    got = fwd_train()
    want = lstm_cell_scan_train_plain(*args)
    torch.cuda.synchronize()
    err_fwd = max_err(got, want)           # out, c_seq, gates, h_T, c_T
    out, c_seq, gates, _, _ = want

    def bwd():
        return lstm_kernels._launch_bwd(gates, c_seq, w, 2, mask, *cot)

    got_bwd = bwd()
    want_bwd = lstm_cell_scan_bwd_plain(gates, c_seq, w, mask, *cot)
    torch.cuda.synchronize()
    err_bwd = max_err(got_bwd, want_bwd)   # dgates_x, dh0, dc0
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32_fwd = max_err(lstm_cell_scan_train_plain(*args), want)
    tf32_bwd = max_err(
        lstm_cell_scan_bwd_plain(gates, c_seq, w, mask, *cot), want_bwd)
    torch.backends.cuda.matmul.allow_tf32 = False

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (gx, w, h0, c0)]
        outs = fn(leaves[0], leaves[1], mask, leaves[2], leaves[3])
        if any(o.grad_fn is None for o in outs):
            fail('lstm_cell_scan under grad mode returned a tensor '
                 'without grad_fn')
        return torch.autograd.grad(outs, leaves, cot)

    got_grads = grads(lstm_cell_scan)      # dgates_x, dW_hh, dh0, dc0
    want_grads = grads(lstm_cell_scan_plain)
    torch.cuda.synchronize()
    err_fn = max_rel_err(got_grads, want_grads)
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32_fn = max_rel_err(grads(lstm_cell_scan_plain), want_grads)
    torch.backends.cuda.matmul.allow_tf32 = False

    times = {
        'fwd_train': cuda_ms(fwd_train, iters=20),
        'fwd_train_plain': cuda_ms(
            lambda: lstm_cell_scan_train_plain(*args), iters=3),
        'bwd': cuda_ms(bwd, iters=20),
        'bwd_plain': cuda_ms(
            lambda: lstm_cell_scan_bwd_plain(gates, c_seq, w, mask, *cot),
            iters=3),
        'dw': cuda_ms(
            lambda: recurrent_weight_grad(got_bwd[0], out, h0, mask, 2),
            iters=20),
    }
    flops = lstm_flops(mask, 600)
    limit_fwd = bound(nbytes(*args, *got), flops)
    limit_bwd = bound(nbytes(gates, c_seq, w, mask, *cot, *got_bwd), flops)
    print(f'phase 6 training forward T=500 D*B=32 H=600: max |kernel - '
          f'plain| {err_fwd:.3e} over out, c_seq, gates, h_T, c_T (tol '
          f'{LSTM_TOL}), plain with TF32 vs f32 {tf32_fwd:.3e}, kernel '
          f'{times["fwd_train"]:.3f} ms, plain '
          f'{times["fwd_train_plain"]:.3f} ms, bound '
          f'{limit_fwd["bound_ms"]:.3f} ms by {limit_fwd["bound_by"]}')
    print(f'phase 6 backward: max |kernel - plain| {err_bwd:.3e} over '
          f'dgates_x, dh0, dc0 (tol {LSTM_BWD_TOL}), plain with TF32 vs '
          f'f32 {tf32_bwd:.3e}, kernel {times["bwd"]:.3f} ms, plain '
          f'{times["bwd_plain"]:.3f} ms, bound '
          f'{limit_bwd["bound_ms"]:.3f} ms by {limit_bwd["bound_by"]}; '
          f'dW_hh product {times["dw"]:.3f} ms')
    print(f'phase 6 Function vs autograd through plain: max relative '
          f'difference {err_fn:.3e} over dgates_x, dW_hh, dh0, dc0 (tol '
          f'{LSTM_GRAD_RTOL}), autograd through plain with TF32 vs f32 '
          f'{tf32_fn:.3e}')
    if not err_fwd <= LSTM_TOL:
        fail(f'training forward kernel disagrees with plain: {err_fwd}')
    if not err_bwd <= LSTM_BWD_TOL:
        fail(f'backward kernel disagrees with plain: {err_bwd}')
    if not err_fn <= LSTM_GRAD_RTOL:
        fail(f'LSTMCellScan disagrees with autograd through the plain '
             f'forward: {err_fn}')
    if not (tf32_fwd > LSTM_TOL and tf32_bwd > LSTM_BWD_TOL
            and tf32_fn > LSTM_GRAD_RTOL):
        fail(f'the limits do not tell a TF32 product from f32: forward '
             f'{tf32_fwd}, backward {tf32_bwd}, Function {tf32_fn}')
    return {
        'fwd_train': {'max_abs_err': err_fwd, 'ms': times['fwd_train'],
                      'plain_ms': times['fwd_train_plain'], **limit_fwd,
                      'library_ms': library['fwd_train']},
        'bwd': {'max_abs_err': err_bwd, 'ms': times['bwd'],
                'plain_ms': times['bwd_plain'], **limit_bwd,
                'library_ms': library['bwd']},
    }, times


class Recorder(Hook):
    """Per iteration: the loss and the pre-clip gradient norm (kept on the
    card); at the first step, that every trained parameter got a finite
    gradient."""

    def __init__(self, nonzero=False):
        self.losses, self.norms = [], []
        self.nonzero = nonzero

    def post_step(self, trainer, example, model_output, review):
        self.losses.append(review['scalars']['loss'].detach())
        if len(self.losses) > 1:
            return
        for name, p in trainer.model.named_parameters():
            if not p.requires_grad:
                continue
            if p.grad is None or not bool(torch.isfinite(p.grad).all()):
                fail(f'{name} got no finite gradient on the card')
            if self.nonzero and not float(p.grad.abs().max()) > 0:
                fail(f'{name} got a zero gradient on the card')
            if p.device.type != 'cuda':
                fail(f'{name} is on {p.device}')

    def post_optimize(self, trainer, summary):
        self.norms.append(summary['scalars']['grad_norm'].detach())


def check_storage_dir(storage_dir, iterations, best):
    names = sorted(p.name for p in (storage_dir / 'checkpoints').iterdir())
    for ckpt in (f'ckpt_{iterations}.ptt', 'ckpt_latest.ptt', best,
                 'ckpt_ranking.json'):
        if ckpt not in names:
            fail(f'{ckpt} missing from {names}')
    if not any('tfevents' in p.name for p in storage_dir.iterdir()):
        fail('no event file in the storage dir')
    return names


def first_step(model, batch, tmp, clipping, device, loss_weights=None):
    """Loss and pre-clip gradient norm of one training step of ``model``
    on ``device``."""
    trainer = Trainer(model.train(), Path(tmp) / f'first_{device}',
                      Adam(gradient_clipping=clipping),
                      loss_weights=loss_weights).to(device)
    loss, _, _, _ = trainer.train_step(trainer.model, batch)
    loss.backward()
    return float(loss.detach()), float(trainer.optimizer.clip_grad())


def compare_first_step(label, losses, norms, loss_cpu, norm_cpu, rtol):
    rel_loss = abs(losses[0] - loss_cpu) / abs(loss_cpu)
    rel_norm = abs(norms[0] - norm_cpu) / norm_cpu
    print(f'phase {label} first step card vs CPU: loss {losses[0]:.9g} vs '
          f'{loss_cpu:.9g} (relative {rel_loss:.3e}, tol {rtol[0]}), '
          f'gradient norm {norms[0]:.9g} vs {norm_cpu:.9g} (relative '
          f'{rel_norm:.3e}, tol {rtol[1]})')
    if not (rel_loss <= rtol[0] and rel_norm <= rtol[1]):
        fail(f'phase {label}: the first training step on the card '
             f'disagrees with the CPU')


def train_batch(batch, frames, seed=0):
    """A ragged training batch at a chosen size (magnitudes as the
    recipe's features have them, random)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(frames // 2, frames + 1, size=batch)
    lens[0] = frames
    valid = np.arange(frames)[None, :, None, None] < lens[:, None, None, None]
    x = np.abs(rng.randn(batch, frames, 2, 257)).astype('float32') * valid
    return {
        'Y_abs': x.sum(2).astype('float32'),
        'X_abs': x.astype('float32'),
        'cos_phase_difference': rng.uniform(
            -1, 1, (batch, frames, 2, 257)).astype('float32'),
        'num_frames': lens.astype('int32'),
    }


def timed_step(trainer, batch, iters=5, loss_key='pit_mse_loss',
               wrapper=lstm_cell_scan, per_step=3, variant=''):
    """One training step by stage (CUDA events; ms), and the whole step on
    the host clock ended by a synchronize.  ``wrapper`` is the recurrence
    the model runs, ``per_step`` its launches per step and kind of the
    kernels of ``variant`` ('' or '_bf16'; ``wrapper`` None: no count is
    checked); ``loss_key`` None takes the review's ``loss``, 'trainer' runs
    forward and review as one stage through ``trainer.train_step`` (its
    precision policy and loss weights apply)."""
    model, optimizer = trainer.model, trainer.optimizer
    example = model.example_to_device(batch, 'cuda')
    stages = {}

    def stage(name, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        stages.setdefault(name, []).append((start, end))
        return out

    def step():
        if loss_key == 'trainer':
            loss = stage('forward and review', lambda: trainer.train_step(
                model, example)[0])
        else:
            out = stage('forward', lambda: model(example))
            review = stage('review', lambda: model.review(example, out))
            loss = review['loss'] if loss_key is None \
                else review['losses'][loss_key]
        stage('backward', loss.backward)
        stage('clip', optimizer.clip_grad)
        stage('adam', optimizer.optimizer.step)
        optimizer.zero_grad()

    model.train()
    optimizer.zero_grad()
    step()  # warm-up
    torch.cuda.synchronize()
    stages.clear()
    reset_launches()
    host = []
    for _ in range(iters):
        start = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - start) * 1e3)
    launches = dict(wrapper.launches) if wrapper is not None else None
    if wrapper is not None and launches != with_zeros(launches, {
            'fwd_train' + variant: per_step * iters,
            'bwd' + variant: per_step * iters}):
        fail(f'a training step launches {per_step} fwd_train{variant} and '
             f'{per_step} bwd{variant} kernels, got {launches} in {iters} '
             f'steps')
    out = {name: float(np.mean([a.elapsed_time(b) for a, b in events]))
           for name, events in stages.items()}
    out['device_sum'] = sum(out.values())
    out['host_step'] = float(np.median(host))
    return out


def profile_step(trainer, batch, label, steps=3, table=True):
    """``--profile``: torch.profiler's kernel table for ``steps`` steps
    through ``trainer.train_step`` (its precision policy applies; without
    ``table`` none), and per step the card's busy time (the kernels' device
    time) beside the host clock, and the dtype casts (``aten::_to_copy``):
    calls, host time and the device time of their kernels.  Returns the
    busy ms a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    example = trainer.model.example_to_device(batch, 'cuda')
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            loss = trainer.train_step(trainer.model, example)[0]
            loss.backward()
            trainer.optimizer.step()
            trainer.optimizer.zero_grad()
        torch.cuda.synchronize()
        host = (time.perf_counter() - start) * 1e3 / steps
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3 / steps
    casts = [e for e in events if e.key == 'aten::_to_copy']
    cast_calls = sum(e.count for e in casts) / steps
    cast_host = sum(e.cpu_time_total for e in casts) / 1e3 / steps
    cast_busy = sum(e.device_time_total for e in casts) / 1e3 / steps
    print(f'profile {label} ({steps} steps), per step: busy {busy:.3f} ms '
          f'of {host:.3f} ms host clock under the profiler; casts '
          f'(aten::_to_copy) {cast_calls:.0f} calls, {cast_host:.3f} ms '
          f'host, {cast_busy:.3f} ms busy ({cast_busy / busy:.1%} of busy)')
    if table:
        print(events.table(sort_by='cuda_time_total', row_limit=25))
    return busy


def phase_training(kernel_times, profile=False):
    """Phase 7: the recipe's trainer at full width on the card."""
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        storage_dir = Path(tmp) / 'pit' / '1'
        config = pit_train.get_trainer_config(storage_dir, {
            'stop_trigger': (3, 'epoch'),
            'summary_trigger': (8, 'iteration')})
        dump_config({'trainer': config}, storage_dir / 'config.json')
        trainer = Trainer.from_config(config)
        model_cpu = copy.deepcopy(trainer.model)
        trainer.to('cuda')

        train_ds = pit_data.synthetic_database(num_examples=32)
        dev_ds = pit_data.synthetic_database(num_examples=8, seed=1)
        train = pit_data.prepare_dataset(
            train_ds, batch_size=4, shuffle=False, prefetch=False)
        dev = pit_data.prepare_dataset(
            dev_ds, batch_size=4, shuffle=False, prefetch=False)

        start = time.perf_counter()
        trainer.test_run(train, dev)
        print(f'phase 7a test_run passed on the card in '
              f'{time.perf_counter() - start:.2f} s')

        recorder = Recorder()
        trainer.register_hook(recorder)
        trainer.register_validation_hook(dev)
        reset_launches()
        start = time.perf_counter()
        trainer.train(train)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = dict(lstm_cell_scan.launches)
        iterations = trainer.iteration
        losses = [float(x) for x in recorder.losses]
        norms = [float(x) for x in recorder.norms]
        hook, = [h for h in trainer.hooks if isinstance(h, ValidationHook)]
        validations = 4  # iterations 0, 8, 16, 24; 2 batches each
        print(f'phase 7b trained {iterations} iterations in {seconds:.2f} s '
              f'(validations and checkpoints included), launches '
              f'{launches}; training loss first 8 mean '
              f'{np.mean(losses[:8]):.4f}, last 8 mean '
              f'{np.mean(losses[-8:]):.4f}; ranking {hook.ckpt_ranking}')
        if iterations != 24 or len(losses) != 24 or len(norms) != 24:
            fail(f'expected 24 iterations, got {iterations}')
        if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
            fail(f'non-finite loss or gradient norm: {losses} {norms}')
        want = with_zeros(launches, {
            'fwd': 3 * 2 * validations, 'fwd_train': 3 * iterations,
            'bwd': 3 * iterations})
        if launches != want:
            fail(f'launches {launches}, expected {want}: 3 fwd_train and 3 '
                 f'bwd per step, 3 fwd per validation batch')
        if not np.mean(losses[-8:]) < np.mean(losses[:8]):
            fail('the training loss did not fall')

        # the first step once more on the CPU, from the same weights
        batch = next(iter(train))
        compare_first_step(
            '7c', losses, norms,
            *first_step(model_cpu, batch, tmp, 10.0, 'cpu',
                        config['loss_weights']),
            (STEP_RTOL, STEP_RTOL))
        names = check_storage_dir(storage_dir, 24, 'ckpt_best_loss.ptt')
        loaded = PermutationInvariantTrainingModel.from_storage_dir(
            storage_dir).to('cuda').eval()
        stft = HostSTFT(pit_data.STFT_SIZE, pit_data.STFT_SHIFT,
                        fading='full', complex_representation='complex')
        example = next(iter(pit_data.synthetic_database(
            num_examples=1, seed=2)))
        _, metrics = evaluate_example(loaded, stft, example)
        if not np.isfinite(metrics['output_si_sdr']).all():
            fail(f'bad metrics from the trained model: {metrics}')
        print(f'phase 7d storage dir {names} loads; one request served '
              f'from it: SI-SDR {metrics["output_si_sdr"]}')

        for label, batch in (
                ('B=4 (recipe)', next(iter(train))),
                ('B=16 T=500', train_batch(16, 500))):
            t = timed_step(trainer, batch)
            n_frames = batch['Y_abs'].shape[1]
            print(f'phase 7e training step {label}, frames {n_frames}: '
                  + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items()))
            if profile:
                profile_step(trainer, batch, label)
        print(f'phase 7e kernels alone at T=500 D*B=32 (phase 6): 3 x '
              f'fwd_train {kernel_times["fwd_train"]:.3f} ms, 3 x bwd '
              f'{kernel_times["bwd"]:.3f} ms, 3 x dW_hh '
              f'{kernel_times["dw"]:.3f} ms')
    return launches


def with_tf32(fn):
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def gru_kernels_case(phase, label, t_len, batch, hdim, kind, n_dir,
                     in_size):
    """The three GRU kernels and the Function around them at one shape
    (``n_dir`` directions of ``batch`` rows, ``hdim`` units, T = ``t_len``
    under the mask ``kind``; ``in_size`` the layer's input width, for the
    cuDNN yardstick) against plain, with the TF32 controls, the routes and
    a second run's bits, timed beside plain, cuDNN and the bound.  Returns
    {kernel: row}."""
    args, cot = recurrence_inputs(t_len, batch, hdim, kind, gates=3,
                                  directions=n_dir)
    gx, w, mask, h0 = args
    valid = t_len * n_dir * batch if mask is None else float(mask.sum())

    def fwd_train():
        return gru_kernels._launch(gx, w, n_dir, mask, h0, train=True)

    # the kernels' routes, chosen from the shape before the launch
    limits = gru_kernels.device_limits(torch.cuda.current_device())
    plan = gru_kernels.resident_plan(n_dir, batch, hdim, *limits)
    route = 'cooperative' if plan is None else 'resident'
    plan_bwd = gru_kernels.resident_bwd_plan(n_dir, batch, hdim, *limits)
    route_bwd = 'cooperative' if plan_bwd is None else 'resident'
    routes_before = gru_routes_of('fwd', 'fwd_train')
    got = gru_cell_scan(*args)
    want = gru_cell_scan_plain(*args)
    got_train = fwd_train()
    want_train = gru_cell_scan_train_plain(*args)
    again = gru_cell_scan(*args)
    torch.cuda.synchronize()
    routed = {k: v - routes_before[k]
              for k, v in gru_routes_of('fwd', 'fwd_train').items()}
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    shown = ('' if plan is None else ' ' + ', '.join(
        f'{k} {v}' for k, v in plan._asdict().items()))
    print(f'phase {phase} gru {label}: route {route}{shown}; launches by '
          f'route {routed}; a second lean run gives the same bits: '
          f'{same_bits}')
    if routed != {**dict.fromkeys(routed, 0), route: 3}:
        fail(f'the gru forwards at {label} did not all take the '
             f'{route} route: {routed}')
    if not same_bits:
        fail(f'two lean gru runs at {label} differ')
    err = {'fwd': max_err(got, want),               # out, h_T
           # out, acts, gh_n, h_prev, h_T
           'fwd_train': max_err(got_train, want_train)}
    _, acts, gh_n, h_prev, _ = want_train

    def bwd():
        return gru_kernels._launch_bwd(acts, gh_n, h_prev, w, n_dir,
                                       mask, *cot)

    def bwd_plain():
        return gru_cell_scan_bwd_plain(acts, gh_n, h_prev, w, mask,
                                       *cot)

    bwd_before = dict(gru_cell_scan.routes['bwd'])
    got_bwd = bwd()
    again_bwd = bwd()
    want_bwd = bwd_plain()
    torch.cuda.synchronize()
    err['bwd'] = max_err(got_bwd, want_bwd)          # dgx, dgh, dh0
    routed_bwd = {k: v - bwd_before[k]
                  for k, v in gru_cell_scan.routes['bwd'].items()}
    same_bwd = all(torch.equal(a, b) for a, b in zip(got_bwd, again_bwd))
    shown = ('' if plan_bwd is None else ' ' + ', '.join(
        f'{k} {v}' for k, v in plan_bwd._asdict().items()))
    print(f'phase {phase} gru bwd {label}: route {route_bwd}{shown}; launches '
          f'by route {routed_bwd}; a second run gives the same bits: '
          f'{same_bwd}')
    if routed_bwd != {**dict.fromkeys(routed_bwd, 0), route_bwd: 2}:
        fail(f'the gru backward at {label} did not take the '
             f'{route_bwd} route: {routed_bwd}')
    if not same_bwd:
        fail(f'two gru backward runs at {label} differ')

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (gx, w, h0)]
        outs = fn(leaves[0], leaves[1], mask, leaves[2])
        if any(o.grad_fn is None for o in outs):
            fail('gru_cell_scan under grad mode returned a tensor '
                 'without grad_fn')
        return torch.autograd.grad(outs, leaves, cot)

    want_grads = grads(gru_cell_scan_plain)
    err_fn = max_rel_err(grads(gru_cell_scan), want_grads)
    tf32 = {
        'fwd': with_tf32(lambda: max_err(
            gru_cell_scan_plain(*args), want)),
        'fwd_train': with_tf32(lambda: max_err(
            gru_cell_scan_train_plain(*args), want_train)),
        'bwd': with_tf32(lambda: max_err(bwd_plain(), want_bwd)),
        'fn': with_tf32(lambda: max_rel_err(
            grads(gru_cell_scan_plain), want_grads)),
    }
    plain_iters = 2 if t_len > 100 else 3
    times = {
        'fwd': cuda_ms(lambda: gru_cell_scan(*args), iters=20),
        'fwd_train': cuda_ms(fwd_train, iters=20),
        'bwd': cuda_ms(bwd, iters=20),
        'fwd_plain': cuda_ms(lambda: gru_cell_scan_plain(*args),
                             iters=plain_iters),
        'fwd_train_plain': cuda_ms(
            lambda: gru_cell_scan_train_plain(*args),
            iters=plain_iters),
        'bwd_plain': cuda_ms(bwd_plain, iters=plain_iters),
        'dw': cuda_ms(lambda: gru_kernels.recurrent_weight_grad(
            got_bwd[1], h_prev, n_dir), iters=20),
    }
    library = cudnn_layer_ms(torch.nn.GRU, t_len, batch, in_size, hdim,
                             n_dir)
    flops = gru_flops(valid, hdim)
    limits = {
        'fwd': bound(nbytes(*args, *got), flops),
        'fwd_train': bound(nbytes(*args, *got_train), flops),
        'bwd': bound(nbytes(acts, gh_n, h_prev, w, mask, *cot,
                            *got_bwd), flops),
    }
    tols = {'fwd': GRU_TOL, 'fwd_train': GRU_TOL, 'bwd': GRU_BWD_TOL}
    for name in ('fwd', 'fwd_train', 'bwd'):
        print(f'phase {phase} gru {name} {label}: max |kernel - plain| '
              f'{err[name]:.3e} (tol {tols[name]}), plain with TF32 vs '
              f'f32 {tf32[name]:.3e}, kernel {times[name]:.3f} ms, '
              f'plain {times[name + "_plain"]:.3f} ms, bound '
              f'{limits[name]["bound_ms"]:.4f} ms by '
              f'{limits[name]["bound_by"]}, cuDNN nn.GRU layer '
              f'{library[name]:.3f} ms')
        if not err[name] <= tols[name]:
            fail(f'gru {name} kernel disagrees with plain at {label}: '
                 f'{err[name]}')
        if not tf32[name] > tols[name]:
            fail(f'the limit {tols[name]} does not tell a TF32 product '
                 f'from f32 for gru {name} at {label}: {tf32[name]}')
    print(f'phase {phase} GRUCellScan vs autograd through plain {label}: max '
          f'relative difference {err_fn:.3e} over dgates_x, dW_hh, dh0 '
          f'(tol {GRU_GRAD_RTOL}), with TF32 {tf32["fn"]:.3e}; dW_hh '
          f'product {times["dw"]:.3f} ms')
    if not err_fn <= GRU_GRAD_RTOL:
        fail(f'GRUCellScan disagrees with autograd through the plain '
             f'forward at {label}: {err_fn}')
    if not tf32['fn'] > GRU_GRAD_RTOL:
        fail(f'the limit {GRU_GRAD_RTOL} does not tell TF32 from f32 '
             f'for GRUCellScan at {label}: {tf32["fn"]}')
    rows = {
        name: {'shape': label, 'max_abs_err': err[name],
               'ms': times[name], 'plain_ms': times[name + '_plain'],
               **limits[name], 'library_ms': library[name],
               'gru_route': route if name != 'bwd' else route_bwd}
        for name in ('fwd', 'fwd_train', 'bwd')}
    rows['fwd']['plan'] = None if plan is None else plan._asdict()
    rows['fwd_train']['plan'] = rows['fwd']['plan']
    rows['bwd']['plan'] = (None if plan_bwd is None
                                     else plan_bwd._asdict())
    rows['dw_ms'] = times['dw']
    return rows


def phase_gru_kernels():
    """Phase 8: the three GRU kernels and the Function around them, at
    each of RECURRENCE_SHAPES (two directions) and of
    CLASSIFIER_GRU_SHAPES (one).  Returns {label: {kernel: row}}."""
    results = {}
    # (shape, directions, width of the layer's input: a DPRNN chunk RNN's
    # is 64, a uPIT layer's 1200)
    cases = [(shape, 2, 64 if shape[3] == 128 else 1200)
             for shape in RECURRENCE_SHAPES]
    cases += [(shape[:5], 1, shape[5]) for shape in CLASSIFIER_GRU_SHAPES]
    for (label, t_len, batch, hdim, kind), n_dir, in_size in cases:
        results[label] = gru_kernels_case('8', label, t_len, batch, hdim,
                                          kind, n_dir, in_size)
    return results


def phase_lstm_at_dprnn_shapes():
    """Phase 9: the three LSTM kernels at the DPRNN's two shapes, timed
    beside one bidirectional ``torch.nn.LSTM`` layer (cuDNN) of the same
    sizes (the chunk RNN's input of 64 features), each with its TF32
    control, the backward with the grid it took."""
    results = {}
    for label, t_len, batch, hdim, kind in RECURRENCE_SHAPES[:2]:
        args, cot = recurrence_inputs(t_len, batch, hdim, kind, gates=4)
        gx, w, mask, h0, c0 = args
        valid = t_len * 2 * batch if mask is None else float(mask.sum())

        def fwd_train():
            return lstm_kernels._launch(gx, w, 2, mask, h0, c0, train=True)

        got = lstm_cell_scan(*args)
        want = lstm_cell_scan_plain(*args)
        got_train = fwd_train()
        want_train = lstm_cell_scan_train_plain(*args)
        _, c_seq, gates, _, _ = want_train

        def bwd():
            return lstm_kernels._launch_bwd(gates, c_seq, w, 2, mask, *cot)

        got_bwd = bwd()
        want_bwd = lstm_cell_scan_bwd_plain(gates, c_seq, w, mask, *cot)
        torch.cuda.synchronize()
        err = {'fwd': max_err(got, want),
               'fwd_train': max_err(got_train, want_train),
               'bwd': max_err(got_bwd, want_bwd)}
        tf32 = {'fwd': with_tf32(lambda: max_err(
                    lstm_cell_scan_plain(*args), want)),
                'fwd_train': with_tf32(lambda: max_err(
                    lstm_cell_scan_train_plain(*args), want_train)),
                'bwd': with_tf32(lambda: max_err(
                    lstm_cell_scan_bwd_plain(gates, c_seq, w, mask, *cot),
                    want_bwd))}
        grid = lstm_kernels.bwd_grid(2, batch, hdim)
        times = {'fwd': cuda_ms(lambda: lstm_cell_scan(*args), iters=10),
                 'fwd_train': cuda_ms(fwd_train, iters=10),
                 'bwd': cuda_ms(bwd, iters=10)}
        library = cudnn_layer_ms(torch.nn.LSTM, t_len, batch, 64, hdim)
        flops = valid * (2 * hdim * 4 * hdim + 30 * hdim)
        limits = {
            'fwd': bound(nbytes(*args, *got), flops),
            'fwd_train': bound(nbytes(*args, *got_train), flops),
            'bwd': bound(nbytes(gates, c_seq, w, mask, *cot, *got_bwd),
                         flops)}
        for name, tol in (('fwd', LSTM_TOL), ('fwd_train', LSTM_TOL),
                          ('bwd', LSTM_BWD_TOL)):
            shown = (' on the grid ' + ', '.join(
                f'{k} {v}' for k, v in grid.items()) if name == 'bwd' else '')
            print(f'phase 9 lstm {name} {label}: max |kernel - plain| '
                  f'{err[name]:.3e} (tol {tol}), plain with TF32 '
                  f'{tf32[name]:.3e}, kernel {times[name]:.3f} ms{shown}, '
                  f'bound {limits[name]["bound_ms"]:.4f} ms by '
                  f'{limits[name]["bound_by"]}')
            if not err[name] <= tol:
                fail(f'lstm {name} kernel disagrees with plain at {label}: '
                     f'{err[name]}')
            if not tf32[name] > tol:
                fail(f'the limit {tol} does not tell a TF32 recurrence from '
                     f'f32 at {label}: {tf32[name]}')
        print(f'phase 9 yardstick {label}: one bidirectional torch.nn.LSTM '
              f'layer (cuDNN; input 64, includes the input projection, '
              f'takes no mask) forward {library["fwd"]:.3f} ms (no grad), '
              f'{library["fwd_train"]:.3f} ms (grad mode), backward '
              f'{library["bwd"]:.3f} ms')
        results[label] = {**times,
                          'library': {k: round(v, 4)
                                      for k, v in library.items()},
                          'bwd_grid': grid}
    return results


# the inter-chunk attention's key lengths at B=4 x 32000 samples: the four
# examples' chunk counts, each repeated over the K=100 positions, and two
# rows cut to one key and to none
INTER_LENS = np.repeat([66, 55, 46, 36], 100)
INTER_LENS[-2:] = (1, 0)
# (label, B, H, Hkv, Tq, Tk, D, masks, timed); the first is the shape of
# the rows in the kernels' line, the third the table's (96, 2048, 64)
ATTENTION_CASES = [
    ('intra (264, 8, 100, 16)', 264, 8, 8, 100, 100, 16, {}, True),
    ('inter (400, 8, 66, 16) ragged', 400, 8, 8, 66, 66, 16,
     {'key_padding_lens': INTER_LENS}, True),
    ('(8, 12, 2048, 64) full', 8, 12, 12, 2048, 2048, 64, {}, True),
    ('(8, 12, 2048, 64) causal', 8, 12, 12, 2048, 2048, 64,
     {'causal': True}, True),
    ('(8, 12, 2048, 64) window (256, 256)', 8, 12, 12, 2048, 2048, 64,
     {'window': (256, 256)}, True),
    ('(8, 12, 2048, 64) causal, ragged', 8, 12, 12, 2048, 2048, 64,
     {'causal': True,
      'key_padding_lens': [2048, 1500, 1000, 777, 1, 0, 2000, 64]}, True),
    ('gqa (4, 8 over 2, 1024, 64)', 4, 8, 2, 1024, 1024, 64, {}, True),
    ('Tq 300, Tk 517 (2, 4, ., 64)', 2, 4, 4, 300, 517, 64, {}, False),
    ('D=24 (2, 4, 50, 24) window (7, 3)', 2, 4, 4, 50, 50, 24,
     {'window': (7, 3)}, False),
    ('D=128 gqa (2, 8 over 2, 130 x 77) ragged', 2, 8, 2, 130, 77, 128,
     {'key_padding_lens': [77, 50]}, False),
    # long sums at the widest head: dk, dv over 4096 queries (16384 with
    # the group's heads), on the tensor cores
    ('D=128 (2, 8, 4096, 128) full', 2, 8, 8, 4096, 4096, 128, {}, False),
    ('D=128 (2, 8, 4096, 128) causal', 2, 8, 8, 4096, 4096, 128,
     {'causal': True}, False),
    ('D=128 gqa (1, 8 over 2, 4096, 128)', 1, 8, 2, 4096, 4096, 128, {},
     False),
    # the widest head (the output's columns split over two blocks)
    ('D=256 (4, 8, 2048, 256) full', 4, 8, 8, 2048, 2048, 256, {}, True),
]


def attention_library(q, k, v, d_o, masks):
    """Yardstick, timed here and used nowhere in the port:
    ``F.scaled_dot_product_attention`` in float32 (TF32 is off) on the same
    inputs, forward and backward (ms).  It takes no key lengths, window or
    shared KV heads: those become a boolean mask and repeated heads, made
    outside the timed call."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k, v = (x.repeat_interleave(group, dim=1) for x in (k, v))
    causal_only = set(masks) == {'causal'}
    mask = None
    if masks and not causal_only:
        lens = attention_kernels._lens_tensor(
            masks.get('key_padding_lens'), q.shape[0], q.device)
        mask = visible_mask(q.shape[2], k.shape[2], lens,
                            masks.get('causal', False), masks.get('window'),
                            q.device)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def forward():
        return sdpa(*leaves, attn_mask=mask, is_causal=causal_only)

    with torch.no_grad():
        fwd = cuda_ms(forward, iters=5)
    out = forward()
    bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, d_o,
                                              retain_graph=True), iters=5)
    return fwd, bwd


def attention_case(label, b, h, h_kv, tq, tk, d, masks, timed, phase=12):
    """One shape of phase 12 (or of ``phase``): both kernels against the
    plain version, and (``timed``) their times, the plain version's, the
    library's and the bounds.  A head size outside ``HEAD_SIZES`` is
    zero-padded for the direct launches of the training forward and the
    backward, as the wrapper pads it.  Returns {'fwd': row, 'bwd': row}."""
    rng = np.random.RandomState(0)
    q, k, v, d_o = (
        torch.tensor(rng.randn(*shape), dtype=torch.float32, device='cuda')
        for shape in ((b, h, tq, d), (b, h_kv, tk, d), (b, h_kv, tk, d),
                      (b, h, tq, d)))
    lens = attention_kernels._lens_tensor(
        masks.get('key_padding_lens'), b, q.device)
    with torch.no_grad():
        got = flash_attention(q, k, v, **masks)
        want, want_lse = flash_attention_fwd_plain(q, k, v, **masks)
        fwd_same = torch.equal(got, flash_attention(q, k, v, **masks))
    err = {'o': max_err([got], [want])}
    d_p = next(size for size in attention_kernels.HEAD_SIZES if size >= d)

    def padded(x):
        return torch.nn.functional.pad(x, (0, d_p - d)) if d_p != d else x

    train_args = (padded(q), padded(k), padded(v), lens,
                  masks.get('causal', False),
                  *attention_kernels._norm_window(masks.get('window')),
                  1.0 / np.sqrt(d))

    def train_fwd():
        o, lse = attention_kernels._launch_fwd(*train_args, train=True)
        return o[..., :d], lse

    got_train = train_fwd()
    err['o, lse (training forward)'] = max_err(got_train, (want, want_lse))
    fwd_same = fwd_same and all(
        torch.equal(x, y) for x, y in zip(got_train, train_fwd()))
    # the forward's control: plain with TF32 products (on operands rounded
    # to TF32, as a TF32 product reads them) must fail the limit that the
    # kernel's 3xTF32 products meet
    fwd_tf32 = with_tf32(lambda: max_err(flash_attention_fwd_plain(
        *(tf32_round(x) for x in (q, k, v)), **masks), (want, want_lse))) \
        if timed else None

    def graph(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, **masks)
        if out.grad_fn is None:
            fail('flash_attention under grad mode returned a tensor '
                 'without grad_fn')
        return out, leaves

    def grads(fn):
        out, leaves = graph(fn)
        return torch.autograd.grad(out, leaves, d_o)

    got_grads, want_grads = grads(flash_attention), grads(
        flash_attention_plain)
    torch.cuda.synchronize()
    err['dq, dk, dv'] = max_err(got_grads, want_grads)
    rel = max_rel_err(got_grads, want_grads)
    # the control: autograd through plain with TF32 products must fail the
    # limit the kernels' 3xTF32 products meet.  cuBLAS keeps the small
    # batched products of the SepFormer shapes on its float32 path even
    # with TF32 allowed (the control read 0.0 at (400, 8, 66, 16)), so the
    # operands are rounded to TF32 as a TF32 product reads them, too
    def tf32_grads():
        leaves = [tf32_round(x).requires_grad_() for x in (q, k, v)]
        out = flash_attention_plain(*leaves, **masks)
        return torch.autograd.grad(out, leaves, tf32_round(d_o))

    tf32_rel = (with_tf32(lambda: max_rel_err(tf32_grads(), want_grads))
                if timed else None)
    same = all(torch.equal(x, y)
               for x, y in zip(got_grads, grads(flash_attention)))
    print(f'phase {phase} attention {label}: max |kernel - plain| '
          + ', '.join(f'{k} {v:.3e}' for k, v in err.items())
          + f' (tol {ATTENTION_TOL} on o and lse; forward on the tensor '
          f'cores, 3xTF32)'
          + ('' if fwd_tf32 is None else
             f', plain forward with TF32 (operands rounded to TF32) '
             f'{fwd_tf32:.3e}')
          + f'; two forward runs the same bits: {fwd_same}; gradients '
          f'relative {rel:.3e} (tol {ATTENTION_GRAD_RTOL})'
          + ('' if tf32_rel is None else
             f', autograd through plain with TF32 (operands rounded to '
             f'TF32) {tf32_rel:.3e}')
          + f'; two backward runs the same bits: {same}')
    if not max(err['o'], err.get('o, lse (training forward)', 0.0)) \
            <= ATTENTION_TOL:
        fail(f'attention forward kernel disagrees with plain at {label}: '
             f'{err}')
    if fwd_tf32 is not None and not fwd_tf32 > ATTENTION_TOL:
        fail(f'the limit {ATTENTION_TOL} does not tell a TF32 attention '
             f'forward from f32 at {label}: {fwd_tf32}')
    if not fwd_same:
        fail(f'two attention forward runs differ at {label}')
    if not rel <= ATTENTION_GRAD_RTOL:
        fail(f'attention backward kernels disagree with autograd through '
             f'plain at {label}: {rel}')
    if tf32_rel is not None and not tf32_rel > ATTENTION_GRAD_RTOL:
        fail(f'the limit {ATTENTION_GRAD_RTOL} does not tell TF32 attention '
             f'gradients from f32 at {label}: {tf32_rel}')
    if not same:
        fail(f'two attention backward runs differ at {label}')
    if lens is not None:
        for row in torch.nonzero(lens == 0)[:, 0].tolist():
            if any(float(x[row].abs().max()) != 0.0
                   for x in (got, *got_grads)):
                fail(f'{label}: row {row} has no key but a nonzero output '
                     f'or gradient')
    if not timed:
        return None

    out, leaves = graph(flash_attention)
    out_plain, leaves_plain = graph(flash_attention_plain)
    with torch.no_grad():
        times = {
            'fwd': cuda_ms(lambda: flash_attention(q, k, v, **masks),
                           iters=10),
            'fwd_plain': cuda_ms(
                lambda: flash_attention_plain(q, k, v, **masks), iters=5),
        }
    times['fwd_train'] = cuda_ms(lambda: graph(flash_attention), iters=10)
    # the backward of small shapes read 0.31 to 0.94 ms in single windows
    # of 10 after the large allocations of the earlier phases: the median
    # of 5 windows after a warm-up, with the allocator's cache emptied
    torch.cuda.empty_cache()
    times['bwd'], bwd_windows = cuda_ms_median(
        lambda: torch.autograd.grad(out, leaves, d_o, retain_graph=True),
        iters=10)
    # the two backward kernels alone, on the card's clock: whether the
    # spread of the eager windows is the kernels' or the host's
    bwd_args = (*train_args[:4], padded(d_o), got_train[1],
                (d_o * want).sum(-1), masks.get('causal', False),
                *attention_kernels._norm_window(masks.get('window')),
                1.0 / np.sqrt(d))
    bwd_kernels = graph_ms(lambda: attention_kernels._launch_bwd(*bwd_args),
                           iters=10)
    times['bwd_plain'] = cuda_ms(lambda: torch.autograd.grad(
        out_plain, leaves_plain, d_o, retain_graph=True), iters=5)
    del out_plain, leaves_plain
    times['fwd_library'], times['bwd_library'] = attention_library(
        q, k, v, d_o, masks)
    # the work these inputs need: the visible (query, key) pairs, each two
    # products of D in the forward (q k^T, p v) and five in the backward,
    # all on the tensor cores as 3xTF32
    visible = visible_mask(tq, tk, lens, masks.get('causal', False),
                           masks.get('window'), q.device)
    pairs = float(visible.sum()) * h * (b // visible.shape[0])
    limits = {
        'fwd': bound(nbytes(q, k, v, lens, got), 4 * pairs * d,
                     PEAK_3XTF32_FLOPS),
        'bwd': bound(nbytes(q, k, v, lens, got, want_lse, d_o, *got_grads),
                     10 * pairs * d, PEAK_3XTF32_FLOPS)}
    for name in ('fwd', 'bwd'):
        print(f'phase {phase} attention {name} {label}: kernel '
              f'{times[name]:.3f} ms'
              + (f' (keeping lse: {times["fwd_train"]:.3f} ms)'
                 if name == 'fwd' else ' (delta included; median of the '
                 'windows ' + ', '.join(f'{w:.3f}' for w in bwd_windows)
                 + f'; the two kernels alone {bwd_kernels:.3f} ms from a '
                 'CUDA graph)')
              + f', plain {times[name + "_plain"]:.3f} ms, '
              f'scaled_dot_product_attention '
              f'{times[name + "_library"]:.3f} ms, bound '
              f'{limits[name]["bound_ms"]:.4f} ms by '
              f'{limits[name]["bound_by"]} at the {limits[name]["peak"]} '
              f'peak (the kernel at '
              f'{limits[name]["bound_ms"] / times[name]:.1%} of it)')
    return {
        'fwd': {'max_abs_err': max(
            err['o'], err.get('o, lse (training forward)', 0.0)),
            'ms': times['fwd'], 'plain_ms': times['fwd_plain'],
            **limits['fwd'], 'library_ms': times['fwd_library'],
            'tf32_control_err': fwd_tf32},
        'bwd': {'max_abs_err': err['dq, dk, dv'], 'ms': times['bwd'],
                'plain_ms': times['bwd_plain'], **limits['bwd'],
                'library_ms': times['bwd_library']}}


def attention_dispatch_table(dtypes=(torch.float32, torch.bfloat16)):
    """One ``MultiheadAttention`` (RoPE) in float32 and in bf16 on the fused
    and on the dense backend, forward alone and forward + backward, beside
    what ``should_use_flash`` picks there."""
    shapes = [(8, t, 768, 12, masks, None)
              for t in (512, 1024, 2048, 4096)
              for masks in ({}, {'causal': True},
                            {'attn_window': (256, 256)})]
    shapes += [(264, 100, 128, 8, {}, None),
               (400, 66, 128, 8, {}, INTER_LENS)]
    # heads of 256 (and 192, padded to 256 by the wrapper): 'auto' takes
    # the kernels there only where they win (AUTO_MAX_HEAD)
    shapes += [(8, t, 1024, 4, masks, None) for t in (1024, 2048)
               for masks in ({}, {'causal': True})]
    shapes += [(8, 1024, 768, 4, {}, None)]
    for dtype in dtypes:
        for batch, t_len, d_model, heads, masks, lens in shapes:
            torch.manual_seed(0)
            mha = MultiheadAttention(d_model, heads, use_rope=True).to(
                'cuda', dtype)
            x = torch.randn((batch, t_len, d_model), device='cuda',
                            dtype=dtype, requires_grad=True)
            d_out = torch.randn_like(x)
            kwargs = dict(masks)
            if lens is not None:
                kwargs['key_padding_lens'] = torch.from_numpy(lens).cuda()
            leaves = [x, *mha.parameters()]
            iters = 3 if t_len >= 2048 else 10
            ms = {}
            for use_flash in (True, False):
                set_attention_backend(mha, use_flash)
                with torch.no_grad():
                    ms[use_flash, 'forward'] = cuda_ms(
                        lambda: mha(x, **kwargs), iters=iters)
                ms[use_flash, 'training'] = cuda_ms(
                    lambda: torch.autograd.grad(mha(x, **kwargs), leaves,
                                                d_out),
                    iters=iters)
            del mha, x, d_out, leaves
            pick = should_use_flash('cuda', dtype, d_model // heads)
            print(f'phase 12 dispatch {str(dtype)[6:]} (B, T, H x D) = '
                  f'({batch}, {t_len}, {heads} x {d_model // heads}) '
                  f'{masks or "full"}{"" if lens is None else " ragged"}: '
                  + '; '.join(
                      f'{mode} fused {ms[True, mode]:.3f} ms, dense '
                      f'{ms[False, mode]:.3f} ms, auto picks '
                      f'{"fused" if pick else "dense"}'
                      for mode in ('forward', 'training')))
        torch.cuda.empty_cache()
    attention_auto_bf16()


def attention_auto_bf16():
    """``use_flash='auto'`` on a bf16 module on the card: the bf16 forward
    kernel as the table decides, equal to the forced fused backend bit for
    bit."""
    torch.manual_seed(0)
    mha = MultiheadAttention(768, 12, use_rope=True).to('cuda',
                                                        torch.bfloat16)
    x = torch.randn((8, 1024, 768), device='cuda', dtype=torch.bfloat16)
    reset_launches()
    with torch.no_grad():
        auto = mha(x, causal=True)
        launched = dict(flash_attention.launches)
        fused = set_attention_backend(mha, True)(x, causal=True)
    torch.cuda.synchronize()
    same = torch.equal(auto, fused)
    print(f'phase 12 use_flash=\'auto\' bf16 at (8, 1024, 12 x 64) causal: '
          f'should_use_flash {should_use_flash(x.device, x.dtype, 64)}, '
          f'kernel launches {launched}, equal to the fused backend bit for '
          f'bit {same}')
    if launched != with_zeros(launched, {'fwd_bf16': 1}) or not same:
        fail('use_flash=\'auto\' in bf16 did not take the bf16 kernel')


def phase_attention_kernels():
    """Phase 12: the two attention kernels at ATTENTION_CASES, then the
    dispatch table.  Returns {label: {'fwd': row, 'bwd': row}}."""
    results = {}
    for label, *shape, masks, timed in ATTENTION_CASES:
        rows = attention_case(label, *shape, masks, timed)
        torch.cuda.empty_cache()
        if rows is not None:
            results[label] = rows
    attention_dispatch_table()
    attention_auto_wide_heads()
    torch.cuda.empty_cache()
    return results


def attention_auto_wide_heads():
    """``use_flash='auto'`` at a head size of 256: the backend
    ``should_use_flash`` picks from the table (AUTO_MAX_HEAD), bit for bit
    that backend; the fused backend forced equals the dense one on the
    valid rows within 1e-4; a head of 320 forced on the kernels raises
    their stated message."""
    torch.manual_seed(0)
    mha = MultiheadAttention(512, 2, use_rope=True).cuda()
    x = torch.randn((4, 300, 512), device='cuda')
    lens = torch.tensor([300, 211, 77, 1], device='cuda')
    pick = should_use_flash(x.device, x.dtype, head_size=256)
    reset_launches()
    with torch.no_grad():
        auto = mha(x, key_padding_lens=lens, causal=True)
        launched = dict(flash_attention.launches)
        fused = set_attention_backend(mha, True)(
            x, key_padding_lens=lens, causal=True)
        dense = set_attention_backend(mha, False)(
            x, key_padding_lens=lens, causal=True)
        wide = MultiheadAttention(640, 2, use_rope=True).cuda()
        set_attention_backend(wide, True)
        try:
            wide(torch.randn((1, 8, 640), device='cuda'))
            raised = None
        except ValueError as e:
            raised = str(e)
    torch.cuda.synchronize()
    same = torch.equal(auto, fused if pick else dense)
    valid = torch.arange(300, device='cuda')[None, :] < lens[:, None]
    diff = float((fused - dense)[valid].abs().max())
    print(f'phase 12 use_flash=\'auto\' at (4, 300, 2 x 256) causal, '
          f'ragged: should_use_flash {pick}, kernel launches '
          f'{ {k: v for k, v in launched.items() if v} }, equal to that '
          f'backend bit for bit {same}; fused against dense on the valid '
          f'rows {diff:.3e}; heads of 320 forced on the kernels raise: '
          f'{raised}')
    if not same or any(launched.values()) != pick or not diff <= 1e-4:
        fail('use_flash=\'auto\' at heads of 256 did not take the backend '
             'should_use_flash picks, or the backends disagree')
    if raised is None or 'at most 256' not in raised:
        fail('use_flash=True at heads of 320 did not raise its stated '
             'message')


def tasnet_updates(rnn_type, extra=None):
    """The config update that chooses the chunk RNNs, as the recipe's
    users write it."""
    return nested_merge({'model': {'separator': {
        'inter_chunk_type': rnn_type, 'intra_chunk_type': rnn_type}}},
        extra or {})


def tasnet_batch(batch, samples, seed=0):
    """A ragged batch of random two-speaker mixtures."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(samples // 2, samples + 1, size=batch)
    lens[0] = samples
    valid = np.arange(samples)[None, :] < lens[:, None]
    s = (rng.randn(batch, 2, samples) * 0.3 * valid[:, None]).astype(
        'float32')
    return {'y': s.sum(1), 's': s, 'num_samples': lens.astype('int32')}


def recurrence_of(rnn_type):
    return gru_cell_scan if rnn_type == 'bgru' else lstm_cell_scan


def serve_tasnet_requests(label, model, model_cpu, wrapper, per_request):
    """The tasnet recipe's ``evaluate_example`` on the 8 synthetic mixtures
    as 8 requests; ``wrapper`` is the kernel wrapper the model runs,
    ``per_request`` its lean forward launches per request.  Returns the
    count of those launches."""
    examples = list(tas_data.synthetic_database(num_examples=8, seed=2))
    reset_launches()
    latencies, results = [], {}
    for example in examples:
        start = time.perf_counter()
        example_id, metrics = tas_evaluate.evaluate_example(model, example)
        latencies.append((time.perf_counter() - start) * 1e3)
        results[example_id] = metrics
    launches = dict(wrapper.launches)
    routes = ('' if wrapper is not gru_cell_scan else
              f' by route {check_gru_routes(f"phase {label}", "resident")}')
    with torch.no_grad():
        request = model.example_to_device(tas_data.post_batch_transform(
            [examples[0]]))
        forward_ms = cuda_ms(lambda: model(request), iters=5, warmup=2)
    print(f'phase {label} served {len(results)} requests, latency ms '
          f'{[round(x, 3) for x in latencies]} (median '
          f'{np.median(latencies):.3f}), launches {launches}{routes}; model '
          f'forward of one request ({examples[0]["observation"].shape[-1]} '
          f'samples) {forward_ms:.3f} ms')
    if launches != with_zeros(launches, {'fwd': per_request * 8}):
        fail(f'8 requests launch {per_request} lean forward kernels each, '
             f'got {launches}')
    for example_id, metrics in results.items():
        values = np.asarray(metrics['output_si_sdr']
                            + metrics['output_mir_eval_sxr_sdr'])
        if values.shape != (4,) or not np.isfinite(values).all():
            fail(f'{example_id}: bad output metrics {metrics}')
    _, ref = tas_evaluate.evaluate_example(model_cpu, examples[0])
    diff = np.abs(np.subtract(
        ref['output_si_sdr'],
        results[examples[0]['example_id']]['output_si_sdr'])).max()
    print(f'phase {label} {examples[0]["example_id"]} SI-SDR card vs CPU: '
          f'max |diff| {diff:.3e} dB (tol {SI_SDR_TOL})')
    if not diff <= SI_SDR_TOL:
        fail(f'TasNet SI-SDR on the card disagrees with the CPU: {diff}')
    return launches['fwd']


def compare_tasnet_with_cpu(label, model, model_cpu):
    """``out`` of a ragged batch of 4 x 16000 samples, card against CPU."""
    batch = tasnet_batch(4, 16000)
    with torch.no_grad():
        want = model_cpu(model_cpu.example_to_device(batch))['out']
        got = model(model.example_to_device(batch))['out'].cpu()
    err = float((got - want).abs().max())
    print(f'phase {label} full-width TasNet B=4 x 16000 samples, card vs '
          f'CPU: max |diff| of out {err:.3e} (tol {TASNET_TOL}, peak '
          f'{float(want.abs().max()):.3f})')
    if got.shape != (4, 2, 16000) or not err <= TASNET_TOL:
        fail(f'TasNet on the card disagrees with the CPU: {err}')


def phase_tasnet_serving(rnn_type):
    """Phase 10: the full-width DPRNN-TasNet serving path."""
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        config = tas_train.get_trainer_config(
            tmp, updates=tasnet_updates(rnn_type))
        model_cpu = Trainer.from_config(config).model.eval()
    width = (model_cpu.encoder.feature_size,
             model_cpu.separator.input_size,
             len(model_cpu.separator.dprnn_blocks),
             model_cpu.separator.dprnn_blocks[0].intra_chunk_rnn.rnn
             .hidden_size)
    if width != (256, 64, 6, 128):
        fail(f'not the full-width DPRNN-TasNet: {width}')
    model = copy.deepcopy(model_cpu).to('cuda')
    compare_tasnet_with_cpu(f'10a {rnn_type}', model, model_cpu)
    return serve_tasnet_requests(f'10b {rnn_type}', model, model_cpu,
                                 recurrence_of(rnn_type), 12)


def sepformer_width(model):
    separator = model.separator
    block = separator.dpt_blocks[0]
    layer = block.intra_chunk.layers[0]
    return (model.encoder.feature_size, separator.input_size,
            separator.window_size, separator.hop_size,
            len(separator.dpt_blocks), len(block.intra_chunk.layers),
            len(block.inter_chunk.layers), layer.self_attn.num_heads,
            layer.self_attn.d_head, layer.ffn.lin1.out_features)


SEPFORMER_WIDTH = (256, 128, 100, 50, 4, 2, 2, 8, 16, 512)


def phase_sepformer_serving():
    """Phase 13: the full-width SepFormer-TasNet serving path, from a
    storage dir the recipe's trainer wrote on the card."""
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        storage_dir = Path(tmp) / 'tasnet' / '1'
        config = tas_train.get_trainer_config(
            storage_dir, variant='sepformer', updates={
                'stop_trigger': (1, 'epoch'),
                'summary_trigger': (4, 'iteration')})
        dump_config({'trainer': config}, storage_dir / 'config.json')
        trainer = Trainer.from_config(config)
        set_attention_backend(trainer.model, True)   # the recipe's --flash
        trainer.to('cuda')
        train, dev = (tas_data.prepare_dataset(
            tas_data.synthetic_database(num_examples=n, seed=seed),
            batch_size=4, segment_length=8000, shuffle=False, prefetch=False)
            for n, seed in ((16, 0), (8, 1)))
        trainer.register_validation_hook(dev, metric='si-sdr')
        trainer.train(train)
        model_cpu = TasNet.from_storage_dir(
            storage_dir, checkpoint_name='ckpt_best_si-sdr.ptt').eval()
        print(f'phase 13a storage dir written by {trainer.iteration} '
              f'iterations of the sepformer recipe on the card and loaded '
              f'back')
    if not isinstance(model_cpu.separator, DualPathTransformer) \
            or sepformer_width(model_cpu) != SEPFORMER_WIDTH:
        fail(f'not the full-width SepFormer-TasNet: '
             f'{sepformer_width(model_cpu)}')
    model = set_attention_backend(copy.deepcopy(model_cpu), True).to('cuda')
    # on the CPU 'auto' is the dense backend: the card's kernels are held
    # against other code, not against their own plain version
    compare_tasnet_with_cpu('13b sepformer', model, model_cpu)
    return serve_tasnet_requests('13c sepformer', model, model_cpu,
                                 flash_attention, 16)


# the TasNet training paths of phases 11 and 14: the recipe's variant and
# config update, what the model is switched to after it is built, the
# kernel wrapper it runs and its launches per step, the limits of the first
# step against the CPU (loss, gradient norm; relative), and whether every
# gradient must be nonzero (a key bias has a zero gradient in exact
# arithmetic: a softmax does not see a shift of all its logits)
TASNET_TRAINING = {
    'bgru': dict(phase=11, variant='dprnn', wrapper=gru_cell_scan,
                 per_step=12, rtol=(TASNET_STEP_RTOL, TASNET_STEP_RTOL),
                 nonzero=True),
    'blstm': dict(phase=11, variant='dprnn', wrapper=lstm_cell_scan,
                  per_step=12, rtol=(TASNET_STEP_RTOL, TASNET_STEP_RTOL),
                  nonzero=True),
    'sepformer': dict(phase=14, variant='sepformer', wrapper=flash_attention,
                      per_step=16,
                      rtol=(SEPFORMER_LOSS_RTOL, SEPFORMER_NORM_RTOL),
                      nonzero=False),
}


def phase_tasnet_training(name, profile=False):
    """Phases 11 and 14: the tasnet recipe's trainer at full width on the
    card, for one of TASNET_TRAINING."""
    path = TASNET_TRAINING[name]
    phase, wrapper, per_step = path['phase'], path['wrapper'], path['per_step']
    sepformer = path['variant'] == 'sepformer'
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        storage_dir = Path(tmp) / 'tasnet' / '1'
        updates = {'stop_trigger': (2, 'epoch'),
                   'summary_trigger': (8, 'iteration')}
        config = tas_train.get_trainer_config(
            storage_dir, variant=path['variant'],
            updates=updates if sepformer else tasnet_updates(name, updates))
        dump_config({'trainer': config}, storage_dir / 'config.json')
        trainer = Trainer.from_config(config)
        if sepformer:
            if sepformer_width(trainer.model) != SEPFORMER_WIDTH:
                fail(f'not the full-width SepFormer-TasNet: '
                     f'{sepformer_width(trainer.model)}')
            set_attention_backend(trainer.model, True)  # the recipe's --flash
        model_cpu = copy.deepcopy(trainer.model)
        trainer.to('cuda')

        # the recipe's --synthetic data: segments of 8000 samples
        train_ds = tas_data.synthetic_database(num_examples=32)
        dev_ds = tas_data.synthetic_database(num_examples=8, seed=1)
        train = tas_data.prepare_dataset(
            train_ds, batch_size=4, segment_length=8000, shuffle=False,
            prefetch=False)
        dev = tas_data.prepare_dataset(
            dev_ds, batch_size=4, segment_length=8000, shuffle=False,
            prefetch=False)
        n_dev = len(list(dev))

        start = time.perf_counter()
        trainer.test_run(train, dev)
        print(f'phase {phase}a {name} test_run passed on the card in '
              f'{time.perf_counter() - start:.2f} s')

        recorder = Recorder(nonzero=path['nonzero'])
        trainer.register_hook(recorder)
        trainer.register_validation_hook(dev, metric='si-sdr')
        reset_launches()
        start = time.perf_counter()
        trainer.train(train)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = dict(wrapper.launches)
        routes = ('' if wrapper is not gru_cell_scan else f' by route '
                  f'{check_gru_routes(f"phase {phase}b {name}", "resident")}')
        if wrapper is gru_cell_scan:
            add_main_bwd_routes()
        iterations = trainer.iteration
        losses = [float(x) for x in recorder.losses]
        norms = [float(x) for x in recorder.norms]
        hook, = [h for h in trainer.hooks if isinstance(h, ValidationHook)]
        half = iterations // 2
        print(f'phase {phase}b {name} trained {iterations} iterations in '
              f'{seconds:.2f} s (validations and checkpoints included), '
              f'launches {launches}{routes}; training loss first half mean '
              f'{np.mean(losses[:half]):.4f}, second half mean '
              f'{np.mean(losses[half:]):.4f}; ranking {hook.ckpt_ranking}')
        if iterations < 8 or len(losses) != iterations:
            fail(f'expected at least 8 iterations, got {iterations}')
        if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
            fail(f'non-finite loss or gradient norm: {losses} {norms}')
        validations = trainer.epoch + 1  # at iteration 0 and every epoch
        want = with_zeros(launches, {
            'fwd': per_step * n_dev * validations,
            'fwd_train': per_step * iterations,
            'bwd': per_step * iterations})
        if launches != want or validations != 3:
            fail(f'launches {launches}, expected {want}: {per_step} '
                 f'fwd_train and {per_step} bwd per step, {per_step} fwd '
                 f'per validation batch ({n_dev} batches, {validations} '
                 f'validations)')
        if not np.mean(losses[half:]) < np.mean(losses[:half]):
            fail('the training loss did not fall')

        # the first step once more on the CPU, from the same weights (the
        # SepFormer's forced backend is there the kernels' plain version)
        batch = next(iter(train))
        compare_first_step(
            f'{phase}c {name}', losses, norms,
            *first_step(model_cpu, batch, tmp, 5.0, 'cpu',
                        config['loss_weights']),
            path['rtol'])
        names = check_storage_dir(storage_dir, iterations,
                                  'ckpt_best_si-sdr.ptt')
        loaded = TasNet.from_storage_dir(
            storage_dir, checkpoint_name='ckpt_best_si-sdr.ptt').to(
                'cuda').eval()
        example = next(iter(tas_data.synthetic_database(
            num_examples=1, seed=2)))
        _, metrics = tas_evaluate.evaluate_example(loaded, example)
        if not np.isfinite(metrics['output_si_sdr']).all():
            fail(f'bad metrics from the trained model: {metrics}')
        print(f'phase {phase}d {name} storage dir {names} loads; one request '
              f'served from it: SI-SDR {metrics["output_si_sdr"]}')

        for samples in (32000, 16000):
            batch = tasnet_batch(4, samples, seed=1)
            t = timed_step(trainer, batch, loss_key='si-sdr',
                           wrapper=wrapper, per_step=per_step)
            if wrapper is gru_cell_scan:
                check_gru_routes(f'phase {phase}e {name}', 'resident')
            print(f'phase {phase}e {name} training step B=4 x {samples} '
                  f'samples: '
                  + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items()))
            if profile:
                profile_step(trainer, batch, f'{name} B=4 x {samples}')
            if not sepformer:
                continue
            set_attention_backend(trainer.model, False)
            t = timed_step(trainer, batch, loss_key='si-sdr',
                           wrapper=wrapper, per_step=0)
            set_attention_backend(trainer.model, True)
            print(f'phase {phase}e {name} the same step on the dense '
                  f'attention backend: '
                  + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items()))
    return launches


def wavenet_flops(t_len, batch, n_layers, r, s_dim, o_dim):
    """Operations of the sample loop: per row and step the two products of
    each dilated layer (R x 2R each), its skip product (R x S), the
    residual products (R x R, all layers but the last) and the two output
    products, 2 per multiply-add."""
    per_step = 2 * (n_layers * (2 * r * 2 * r + r * s_dim)
                    + (n_layers - 1) * r * r + s_dim * o_dim + o_dim * o_dim)
    return t_len * batch * per_step


def full_width_wavenet():
    """The wavenet recipe's model from seed 0 (its config's defaults)."""
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        model = Trainer.from_config(wn_train.get_trainer_config(tmp)).model
    check_wavenet_width(model)
    return model


def check_wavenet_width(model):
    net = model.wavenet
    width = (net.upsample.in_channels, net.upsamp_window, net.upsamp_stride,
             net.n_layers, tuple(net.dilations), net.n_residual_channels,
             net.skip_layers[0].conv.out_channels, net.n_out_channels,
             net.embed.num_embeddings)
    want = (80, 800, 200, 16, (1, 2, 4, 8, 16, 32, 64, 128) * 2, 64, 256,
            256, 256)
    if width != want:
        fail(f'not the full-width WaveNet: {width}')


def near_ties(scores, limit):
    """Where the two best of ``scores`` (..., O) are closer than ``limit``:
    there a difference within the kernels' limit may change the choice."""
    top = scores.topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]) < limit


@contextlib.contextmanager
def planned_route(planned=True):
    """``wavenet_sample``'s launches on the planner's route, or (False) on
    one block per row whatever the planner says: to hold a cluster plan
    against the route it replaces."""
    device_plan = wavenet_kernels.device_plan
    if not planned:
        wavenet_kernels.device_plan = (
            lambda batch, n_layers, r, s, o, slots, device:
            wavenet_kernels.ClusterPlan(1, False, wavenet_kernels.sample_smem(
                n_layers, r, s, o, slots, 1, False)))
    try:
        yield
    finally:
        wavenet_kernels.device_plan = device_plan


def phase_wavenet_kernel():
    """Phase 15: wavenet_sample against its plain step loop at full width.
    Returns the kernel's row."""
    net = full_width_wavenet().wavenet.to('cuda')
    w = net.sampler_weights()
    dil = tuple(net.dilations)
    n_layers, r = net.n_layers, net.n_residual_channels
    s_dim, o_dim = w['w_skip'].shape[-1], net.n_out_channels
    rng = np.random.RandomState(0)

    def conditioning(t_len, batch):
        # of the size the cond layer gives log-mel features (about 1)
        return torch.from_numpy(rng.randn(
            t_len, batch, n_layers, 2 * r).astype('float32')).cuda()

    def plan(rows):
        return wavenet_kernels.device_plan(rows, n_layers, r, s_dim, o_dim,
                                           sum(dil), 0)

    def route_of(fn, want):
        """fn's result, after checking that its launches took the route
        ``want`` (a cluster where the plan gives one, else one block)."""
        before = dict(wavenet_sample.routes)
        out = fn()
        taken = {k: wavenet_sample.routes[k] - before[k] for k in before}
        if taken[want] == 0 or sum(taken.values()) != taken[want]:
            fail(f'wavenet_sample launches by route {taken}, expected '
                 f'{want}')
        return out

    # a parallel request of 1 s: 5 chunks of 4200 steps as 5 rows
    t_len, batch = 4200, 5
    cond = conditioning(t_len, batch)
    forced = torch.from_numpy(rng.randint(
        0, o_dim, (t_len, batch)).astype('int32')).cuda()
    got_i, got_l = route_of(lambda: wavenet_sample(
        cond, w, dil, forced_input=forced, return_logits=True), 'cluster')
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want_i, want_l = wavenet_sample_plain(cond, w, dil, forced_input=forced,
                                          return_logits=True)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = float((got_l - want_l).abs().max())
    _, tf32_l = with_tf32(lambda: wavenet_sample_plain(
        cond[:500], w, dil, forced_input=forced[:500], return_logits=True))
    tf32_err = float((tf32_l - want_l[:500]).abs().max())
    print(f'phase 15a wavenet_sample T={t_len} B={batch} L={n_layers} R={r} '
          f'S={s_dim} O={o_dim}, teacher-forced: max |diff| of logits vs '
          f'plain {err:.3e} (tol {WAVENET_TOL}, largest logit '
          f'{float(want_l.abs().max()):.2f}); control, plain with TF32 '
          f'products over 500 steps: {tf32_err:.3e}')
    if not err <= WAVENET_TOL:
        fail(f'wavenet_sample disagrees with its plain version: {err}')
    if not tf32_err > WAVENET_TOL:
        fail('the TF32 control passes the limit: the limit is too loose')
    # the greedy choice: the lowest index of the kernel's own best logit,
    # and the plain version's but at near ties
    if not bool((got_i.long() == got_l.argmax(-1)).all()):
        fail('greedy indices are not the argmax of the kernel\'s logits')
    differ = (got_i != want_i) & ~near_ties(want_l, 2 * WAVENET_TOL)
    # Gumbel-max on the same counters
    seed = 7
    sam_i, sam_l = wavenet_sample(cond, w, dil, forced_input=forced,
                                  return_logits=True, sample=True, seed=seed)
    noise = _gumbel(wavenet_uniform(seed, torch.arange(t_len), batch, o_dim,
                                    device='cuda'))
    own = (sam_l + noise).argmax(-1)
    # what the plain loop draws under teacher forcing (phase 15d holds the
    # plain loop's own sampling against the kernel's)
    plain_sam = (want_l + noise).argmax(-1)
    sam_differ = (sam_i != plain_sam) & ~near_ties(want_l + noise,
                                                   2 * WAVENET_TOL)
    print(f'phase 15b teacher-forced choices over {t_len * batch} steps: '
          f'greedy differs from plain at {int((got_i != want_i).sum())} '
          f'(none away from a near tie: {not bool(differ.any())}); '
          f'Gumbel-max from the kernel\'s own logits and the plain '
          f'generator\'s draws: equal {bool((sam_i.long() == own).all())}, '
          f'differs from plain at {int((sam_i != plain_sam).sum())}')
    if bool(differ.any()) or bool(sam_differ.any()):
        fail('wavenet_sample chooses another index than its plain version')
    if not bool((sam_i.long() == own).all()) \
            or not torch.equal(sam_l, got_l):
        fail('the kernel\'s draws are not the plain generator\'s')
    # sampled indices follow the softmax: the log-likelihood of the choices
    # against its expectation, minus the entropy, in standard deviations
    logp = torch.log_softmax(sam_l.double(), -1)
    p = logp.exp()
    chosen = logp.gather(-1, sam_i.long()[..., None])[..., 0]
    mean = (p * logp).sum(-1)
    var = (p * logp ** 2).sum(-1) - mean ** 2
    z = float((chosen - mean).sum() / var.sum().sqrt())
    print(f'phase 15c {t_len * batch} sampled indices against their '
          f'softmax: log-likelihood {float(chosen.sum()):.1f}, expected '
          f'{float(mean.sum()):.1f}, z = {z:.2f} (limit 5), '
          f'{len(torch.unique(sam_i))} distinct indices')
    if not abs(z) < 5:
        fail(f'sampled indices do not follow the softmax: z = {z}')

    # the free-running greedy loop, 1000 steps of 2 rows
    free_cond = conditioning(1000, 2)
    free_i = wavenet_sample(free_cond, w, dil)
    plain_i, plain_l = wavenet_sample_plain(free_cond, w, dil,
                                            return_logits=True)
    mismatch = (free_i != plain_i).any(1).nonzero()
    first = int(mismatch[0]) if len(mismatch) else None
    print(f'phase 15d free-running greedy, T=1000 B=2: equal to plain '
          f'{first is None}'
          + ('' if first is None else f' (first difference at step {first})'))
    if first is not None and not bool(near_ties(
            plain_l[first], 2 * WAVENET_TOL).any()):
        fail(f'the greedy loop leaves its plain version at step {first}')
    # a sequential request: one row of 16000 steps; its first 500 steps
    # against the plain loop
    one_cond = conditioning(16000, 1)
    one_i = wavenet_sample(one_cond, w, dil, sample=True, seed=3)
    head = wavenet_sample_plain(one_cond[:500], w, dil, sample=True, seed=3)
    if not torch.equal(one_i[:500], head):
        fail('one row of 16000 steps leaves the plain loop in its first 500')

    # each row of a throughput batch (one block per row) equals the same
    # row run alone (a cluster), bit for bit: teacher-forced logits and
    # indices, and the free-running greedy loop
    rows, steps = 132, 300
    many = conditioning(steps, rows)
    many_forced = torch.from_numpy(rng.randint(
        0, o_dim, (steps, rows)).astype('int32')).cuda()
    batch_i, batch_l = route_of(lambda: wavenet_sample(
        many, w, dil, forced_input=many_forced, return_logits=True),
        'one_block')
    batch_free = route_of(lambda: wavenet_sample(many, w, dil), 'one_block')
    unequal = []
    for row in range(rows):
        alone = many[:, row:row + 1].contiguous()
        one_i, one_l = route_of(lambda: wavenet_sample(
            alone, w, dil, forced_input=many_forced[:, row:row + 1]
            .contiguous(), return_logits=True), 'cluster')
        one_free = route_of(lambda: wavenet_sample(alone, w, dil),
                            'cluster')
        if not (torch.equal(one_i, batch_i[:, row:row + 1])
                and torch.equal(one_l, batch_l[:, row:row + 1])
                and torch.equal(one_free, batch_free[:, row:row + 1])):
            unequal.append(row)
    print(f'phase 15f a batch of {rows} rows x {steps} steps '
          f'({plan(rows)}) against each row alone ({plan(1)}): '
          f'teacher-forced logits and indices and free-running greedy '
          f'indices equal bit for bit in {rows - len(unequal)} of {rows} '
          f'rows')
    if unequal:
        fail(f'rows {unequal[:10]} of a {rows}-row batch differ from the '
             f'row run alone')
    del many, many_forced

    ms = cuda_ms(lambda: wavenet_sample(cond, w, dil, sample=True),
                 iters=2)
    one_ms = cuda_ms(lambda: wavenet_sample(one_cond, w, dil, sample=True),
                     iters=1)
    print(f'phase 15e wavenet_sample T={t_len} B={batch} ({plan(batch)}): '
          f'{ms:.1f} ms ({ms / t_len * 1e3:.2f} us per step, '
          f'{t_len * batch / ms / 16:.2f} x real time at 16 kHz), plain '
          f'{plain_ms:.0f} ms ({plain_ms / t_len * 1e3:.0f} us per step); '
          f'T=16000 B=1 ({plan(1)}): {one_ms:.1f} ms ({one_ms / 16:.2f} us '
          f'per sample, {16000 / one_ms / 16:.2f} x real time)')
    # 8 to 66 rows: the planner's smaller clusters, which read their
    # weights through L2 (on an H100 8 and 15 rows take clusters of 8, 16
    # and 30 of 4, 33 and 66 of 2: each size at both ends of its range);
    # each held bit for bit against the same rows on one block per row
    # (the route the plan replaces), then both timed
    for rows in (8, 15, 16, 30, 33, 66):
        many = conditioning(1000, rows)
        many_forced = torch.from_numpy(rng.randint(
            0, o_dim, (300, rows)).astype('int32')).cuda()
        runs = {}
        for route in ('cluster', 'one_block'):
            with planned_route(route == 'cluster'):
                runs[route] = route_of(lambda: (
                    *wavenet_sample(many[:300], w, dil,
                                    forced_input=many_forced,
                                    return_logits=True),
                    wavenet_sample(many, w, dil, sample=True, seed=5)),
                    route)
                runs[route] += (cuda_ms(lambda: wavenet_sample(
                    many, w, dil, sample=True), iters=1),)
        same = all(torch.equal(a, b) for a, b in zip(
            runs['cluster'][:3], runs['one_block'][:3]))
        t, t_one = runs['cluster'][3], runs['one_block'][3]
        print(f'phase 15e wavenet_sample T=1000 B={rows} ({plan(rows)}): '
              f'{t:.1f} ms ({t:.2f} us per step, {rows * 1e3 / t / 16:.1f} '
              f'x real time over the rows); on one block per row '
              f'{t_one:.1f} ms ({t_one / t:.2f} x); teacher-forced logits '
              f'and indices over 300 steps and sampled indices over 1000 '
              f'equal to one block per row bit for bit: {same}')
        if not same:
            fail(f'{rows} rows on {plan(rows)} differ from one block per '
                 f'row')
        del many, many_forced, runs
    for rows in (132, 264):
        many = conditioning(1000, rows)
        t = cuda_ms(lambda: wavenet_sample(many, w, dil, sample=True),
                    iters=1)
        print(f'phase 15e wavenet_sample T=1000 B={rows} ({plan(rows)}): '
              f'{t:.1f} ms ({t:.2f} us per step, {rows * 1e3 / t / 16:.1f} '
              f'x real time over the rows)')
        del many
    # the card's limit on the cluster route: clusters of n CTAs that run
    # at once (cudaOccupancyMaxActiveClusters) at the CTA's shared memory
    max_smem = torch.cuda.get_device_properties(
        0).shared_memory_per_block_optin
    counts = {n: wavenet_kernels._max_clusters(0, n, smem)
              for n in wavenet_kernels.CLUSTER_SIZES
              for _, smem in [wavenet_kernels.cluster_smem(
                  n_layers, r, s_dim, o_dim, sum(dil), n, max_smem)]}
    print(f'phase 15e clusters of n CTAs this card runs at once, by n: '
          f'{counts} ({torch.cuda.get_device_properties(0).multi_processor_count} '
          f'SMs, {max_smem} bytes of shared memory a block)')
    # each input read once (weights once for the whole call), the indices
    # written; the floor of a sequential chain is the latency of a step,
    # which this bound does not see
    return {'shape': f'T={t_len} B={batch} L={n_layers} R={r} S={s_dim} '
                     f'O={o_dim}',
            'wavenet_route': plan(batch)._asdict(),
            'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'library_ms': None,
            **bound(nbytes(cond, *w.values()) + 4 * t_len * batch,
                    wavenet_flops(t_len, batch, n_layers, r, s_dim, o_dim))}


# (label, batch, samples, size, shift, window_length, n_mels)
LOGMEL_SHAPES = [
    ('16 x 4 s 512/128/64', 16, 64000, 512, 128, None, 64),
    ('classifier recipe 8 x 8000 512/128/64', 8, 8000, 512, 128, None, 64),
    ('wavenet recipe 1024/200/800/80', 2, 16000, 1024, 200, 800, 80),
    ('hop 160, window 400', 3, 12345, 512, 160, 400, 40),
]


def phase_logmel_kernel():
    """Phase 16: fused_logmel against its plain version and the composed
    module path.  Returns the kernel's row at the first of LOGMEL_SHAPES."""
    rows = []
    rng = np.random.RandomState(0)
    for label, batch, samples, size, shift, window_length, n_mels in \
            LOGMEL_SHAPES:
        frontend = LogMelFrontend(size=size, shift=shift,
                                  window_length=window_length, n_mels=n_mels)
        x = torch.from_numpy(
            rng.randn(batch, samples).astype('float32') * 0.1).cuda()
        before = fused_logmel.launches
        got = frontend(x)
        launched = fused_logmel.launches - before
        again = frontend(x)
        alone = frontend(x[-1])
        want = frontend.plain(x)
        same = torch.equal(got, again) and torch.equal(alone, got[-1:])
        err = float((got - want).abs().max())
        tf32_err = float((with_tf32(lambda: frontend.plain(x))
                          - want).abs().max())
        stft = STFT(size, shift, window_length=window_length,
                    window='blackman', fading='full',
                    complex_representation='stacked', dtype='float32')
        fbanks = frontend.bases_on('cuda')[2]

        def composed():
            spec = stft(x)
            power = spec[..., 0] ** 2 + spec[..., 1] ** 2
            return torch.log(power @ fbanks + 1e-12)

        composed_err = float((got - composed()).abs().max())
        # the kernel's own time from CUDA-graph replays (an eager call of
        # the recipes' small inputs is the host's as much as the card's),
        # and the eager call beside it
        ms = graph_ms(lambda: frontend(x), iters=20)
        eager_ms = cuda_ms(lambda: frontend(x), iters=20, warmup=3)
        plain_ms = cuda_ms(lambda: frontend.plain(x), iters=20, warmup=3)
        composed_ms = cuda_ms(composed, iters=20, warmup=3)
        frames = got.shape[1]
        f_bins = size // 2 + 1
        length = window_length or size
        plan = logmel_plan(batch, frames, length, shift, f_bins,
                           frontend.n_partials, *gru_kernels.device_limits(
                               torch.cuda.current_device()))
        # the mel product needs the filterbank's nonzero band ranges only
        # (frontend.bands_on: each band's bins [lo, hi) first)
        bands = frontend.bands_on('cpu')[:3 * n_mels].reshape(n_mels, 3)
        mel_terms = int((bands[:, 1] - bands[:, 0]).sum())
        flops = batch * frames * 2 * (2 * length * f_bins + mel_terms)
        n_bytes = nbytes(x, got, *frontend.bases_on('cuda')[:3])
        # the DFT products run as 3xTF32 on the tensor cores, the mel
        # product in float32: the bound at each one's peak, and at float32
        by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        by_ops = (batch * frames * 2 * 2 * length * f_bins / PEAK_3XTF32_FLOPS
                  + batch * frames * 2 * mel_terms / PEAK_F32_FLOPS) * 1e3
        by_parts = max(by_bytes, by_ops)
        f32 = bound(n_bytes, flops)
        row = {'shape': label, 'max_abs_err': err, 'ms': ms,
               'eager_ms': eager_ms, 'plain_ms': plain_ms, 'library_ms': None,
               'logmel_plan': plan._asdict(), 'bound_ms': by_parts,
               'bound_by': 'bytes' if by_bytes >= by_ops else 'operations',
               'peak': '3xTF32 tensor cores (DFT), float32 (mel)',
               'bound_f32_ms': f32['bound_ms']}
        rows.append(row)
        print(f'phase 16 fused_logmel {label}: ({batch}, {samples}) -> '
              f'{tuple(got.shape)}, {launched} launch, plan '
              f'{plan._asdict()}, max |diff| vs plain {err:.3e} (tol '
              f'{LOGMEL_TOL}; values {float(want.min()):.1f} ... '
              f'{float(want.max()):.1f}), control plain with TF32 '
              f'{tf32_err:.3e}, vs the composed module path '
              f'{composed_err:.3e} (tol {LOGMEL_COMPOSED_TOL}); the same '
              f'bits again and for the last signal alone {same}; kernel '
              f'{ms:.4f} ms from CUDA-graph replays, {eager_ms:.4f} ms '
              f'eager; plain {plain_ms:.3f} ms, composed '
              f'{composed_ms:.3f} ms, bound {by_parts:.4f} ms by '
              f'{row["bound_by"]} (DFT at 3xTF32, mel at float32; all at '
              f'float32 {f32["bound_ms"]:.4f} ms)')
        if got.shape != want.shape or not err <= LOGMEL_TOL:
            fail(f'fused_logmel disagrees with its plain version: {err}')
        if launched != 1 or not same:
            fail(f'fused_logmel: {launched} launches for one call, or a '
                 f'second call or a signal alone gave other bits')
        if not tf32_err > LOGMEL_TOL:
            fail('the TF32 control passes the limit: the limit is too loose')
        if not composed_err <= LOGMEL_COMPOSED_TOL:
            fail(f'fused_logmel disagrees with the composed path: '
                 f'{composed_err}')
    return rows[0]


def wavenet_datasets(n_train, n_dev):
    """The wavenet recipe's --synthetic data: 1 s segments, batches of 2."""
    return (wn_data.prepare_dataset(
        wn_data.synthetic_database(num_examples=n, seed=seed), batch_size=2,
        segment_length=16000, shuffle=False, prefetch=False)
        for n, seed in ((n_train, 0), (n_dev, 1)))


def phase_wavenet_serving():
    """Phase 17: the full-width vocoder served from a storage dir the
    recipe's trainer wrote on the card.  Returns wavenet_sample's launches
    over the requests."""
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        storage_dir = Path(tmp) / 'wavenet' / '1'
        config = wn_train.get_trainer_config(storage_dir, {
            'stop_trigger': (2, 'epoch'),
            'summary_trigger': (2, 'iteration')})
        dump_config({'trainer': config}, storage_dir / 'config.json')
        trainer = Trainer.from_config(config)
        trainer.to('cuda')
        train, dev = wavenet_datasets(4, 4)
        trainer.register_validation_hook(dev)
        trainer.train(train)
        model_cpu = WaveNetVocoder.from_storage_dir(
            storage_dir, checkpoint_name='ckpt_best_loss.ptt').eval()
        print(f'phase 17a storage dir written by {trainer.iteration} '
              f'iterations of the wavenet recipe on the card and loaded '
              f'back')
        batch = next(iter(dev))
    check_wavenet_width(model_cpu)
    model = copy.deepcopy(model_cpu).to('cuda')
    net = model.wavenet

    with torch.no_grad():
        want = model_cpu(model_cpu.example_to_device(batch))
        example = model.example_to_device(batch)
        got = model(example)
        err = float((got['logits'].cpu() - want['logits']).abs().max())
        # the sampler under teacher forcing gives the training graph's
        # logits: position t of the graph is step t of the loop
        crop = 2000
        cond = net.get_cond_input(example['features'])
        cond = cond.reshape(cond.shape[0], net.n_layers, -1,
                            cond.shape[-1])[..., :crop]
        quantized = got['quantized'][:, :crop]
        forced = torch.cat([torch.full_like(quantized[:, :1], 128),
                            quantized[:, :-1]], dim=1)
        reset_launches()
        _, loop_logits = net.sample_kernel(
            cond, sample=False, forced_input=forced, return_logits=True)
        loop_err = float((loop_logits[..., 1:]
                          - got['logits'][..., 1:crop]).abs().max())
    print(f'phase 17b full-width vocoder on {tuple(batch["audio_data"].shape)}'
          f' audio, card vs CPU: max |diff| of logits {err:.3e}, equal '
          f'targets {torch.equal(got["quantized"].cpu(), want["quantized"])}; '
          f'the kernel under teacher forcing vs the training graph over '
          f'{crop} steps: {loop_err:.3e} (tol {WAVENET_MODEL_TOL}, largest '
          f'logit {float(want["logits"].abs().max()):.2f})')
    if got['logits'].shape != (2, 256, 16000) \
            or not torch.equal(got['quantized'].cpu(), want['quantized']) \
            or not err <= WAVENET_MODEL_TOL \
            or not loop_err <= WAVENET_MODEL_TOL \
            or wavenet_sample.launches != 1:
        fail('the vocoder on the card disagrees with the CPU or with its '
             'own training graph')

    # greedy synthesis of 1000 samples: the kernel against the CPU's loop
    features = torch.from_numpy(batch['features'][:1, :, :8])
    start = time.perf_counter()
    want_audio = model_cpu.wavenet.infer(features, sample=False)
    cpu_s = time.perf_counter() - start
    got_audio = net.infer(features.cuda(), sample=False).cpu()
    # neighbouring mu-law levels are at least 1.7e-4 apart
    same = float(((got_audio - want_audio).abs() <= 1e-5).float().mean())
    print(f'phase 17c greedy synthesis of {want_audio.shape[-1]} samples: '
          f'the card\'s kernel gives the CPU step loop\'s audio at '
          f'{same * 100:.1f} % of the samples (the CPU loop took '
          f'{cpu_s:.2f} s)')
    if got_audio.shape != (1, 1000) or same != 1.0:
        fail('greedy synthesis on the card leaves the CPU\'s')

    # requests of 1 s through the recipe's synthesize_example
    examples = [wn_data.extract_features(e) for e in wn_data.
                synthetic_database(num_examples=4, num_samples=16000, seed=2)]
    generator = torch.Generator().manual_seed(0)
    modes = (('one chunk', dict(chunk_length=48000, chunk_overlap=16000),
              examples[:2], 1),
             ('5 sequential chunks of 4200',
              dict(chunk_length=4000, chunk_overlap=1000), examples[:1], 5),
             ('5 parallel chunks of 4200',
              dict(chunk_length=4000, chunk_overlap=1000, parallel=True),
              examples, 1))
    total, routes = 0, dict.fromkeys(wavenet_sample.routes, 0)
    for label, kwargs, requests, per_request in modes:
        reset_launches()
        latencies = []
        for example in requests:
            start = time.perf_counter()
            example_id, metrics, audio = wn_evaluate.synthesize_example(
                model, example, generator=generator, **kwargs)
            latencies.append(time.perf_counter() - start)
            if audio.shape != (16000,) or not np.isfinite(audio).all() \
                    or np.abs(audio).max() > 1 or len(np.unique(audio)) < 16 \
                    or not 0 < metrics['rmse'] < 2 \
                    or metrics['num_samples'] != 16000:
                fail(f'{example_id}: bad synthesis {metrics}')
        launches = wavenet_sample.launches
        total += launches
        for route, n in wavenet_sample.routes.items():
            routes[route] += n
        median = float(np.median(latencies))
        print(f'phase 17d {len(requests)} requests of 1 s, {label}: latency '
              f's {[round(x, 4) for x in latencies]} (median {median:.4f}: '
              f'{median / 16000 * 1e6:.1f} us per sample, '
              f'{1 / median:.2f} x real time), launches {launches} by route '
              f'{wavenet_sample.routes}, rmse {metrics["rmse"]:.3f}')
        if launches != per_request * len(requests):
            fail(f'{label}: {per_request} launches per request expected, '
                 f'got {launches} for {len(requests)} requests')
        if wavenet_sample.routes['cluster'] != launches:
            fail(f'{label}: the requests\' sampler took the routes '
                 f'{wavenet_sample.routes}, expected a cluster per row')
    return total, routes


def phase_wavenet_training():
    """Phase 18: the wavenet recipe's trainer at full width on the card."""
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        storage_dir = Path(tmp) / 'wavenet' / '1'
        config = wn_train.get_trainer_config(storage_dir, {
            'stop_trigger': (2, 'epoch'),
            'summary_trigger': (4, 'iteration')})
        dump_config({'trainer': config}, storage_dir / 'config.json')
        trainer = Trainer.from_config(config)
        check_wavenet_width(trainer.model)
        model_cpu = copy.deepcopy(trainer.model)
        trainer.to('cuda')
        train, dev = wavenet_datasets(8, 4)

        start = time.perf_counter()
        trainer.test_run(train, dev)
        print(f'phase 18a wavenet test_run passed on the card in '
              f'{time.perf_counter() - start:.2f} s')
        recorder = Recorder(nonzero=True)
        trainer.register_hook(recorder)
        trainer.register_validation_hook(dev)
        start = time.perf_counter()
        trainer.train(train)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        iterations = trainer.iteration
        losses = [float(x) for x in recorder.losses]
        norms = [float(x) for x in recorder.norms]
        hook, = [h for h in trainer.hooks if isinstance(h, ValidationHook)]
        half = iterations // 2
        print(f'phase 18b wavenet trained {iterations} iterations of 2 x '
              f'16000 samples in {seconds:.2f} s (validations and '
              f'checkpoints included); training loss first half mean '
              f'{np.mean(losses[:half]):.4f}, second half mean '
              f'{np.mean(losses[half:]):.4f}; ranking {hook.ckpt_ranking}')
        if iterations != 8 or len(losses) != 8 or len(norms) != 8:
            fail(f'expected 8 iterations, got {iterations}')
        if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
            fail(f'non-finite loss or gradient norm: {losses} {norms}')
        if not np.mean(losses[half:]) < np.mean(losses[:half]):
            fail('the wavenet training loss did not fall')
        batch = next(iter(train))
        compare_first_step(
            '18c wavenet', losses, norms,
            *first_step(model_cpu, batch, tmp, 10.0, 'cpu'),
            WAVENET_STEP_RTOL)
        names = check_storage_dir(storage_dir, iterations,
                                  'ckpt_best_loss.ptt')
        loaded = WaveNetVocoder.from_storage_dir(storage_dir).to('cuda').eval()
        example = wn_data.extract_features(next(iter(
            wn_data.synthetic_database(num_examples=1, num_samples=4000,
                                       seed=2))))
        _, metrics, _ = wn_evaluate.synthesize_example(
            loaded, example, chunk_length=48000, chunk_overlap=16000)
        if not np.isfinite(metrics['rmse']):
            fail(f'bad metrics from the trained vocoder: {metrics}')
        print(f'phase 18d storage dir {names} loads; one request of 0.25 s '
              f'served from it: rmse {metrics["rmse"]:.3f}')
        t = timed_step(trainer, batch, loss_key=None, wrapper=None)
        print('phase 18e wavenet training step B=2 x 16000 samples: '
              + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items()))


def speaker_batch(batch, samples, num_speakers, seed=0):
    """A ragged batch of raw audio with random labels."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(samples // 2, samples + 1, size=batch)
    lens[0] = samples
    valid = np.arange(samples)[None, :] < lens[:, None]
    return {'audio_data': (rng.randn(batch, samples) * 0.1 * valid).astype(
                'float32'),
            'seq_len': lens.astype('int32'),
            'speaker_id': rng.randint(0, num_speakers, batch).astype('int32')}


def phase_speaker_clf():
    """Phase 19: the speaker-classification recipe with the on-device front
    end, trained and served on the card.  Returns the launches of
    fused_logmel and of the GRU kernels over the run, the requests and the
    full-width forwards and steps."""
    torch.manual_seed(0)
    epochs = 10
    with tempfile.TemporaryDirectory() as tmp:
        storage_dir = Path(tmp) / 'speaker_clf' / '1'
        storage_dir.mkdir(parents=True)
        train_ds, dev_ds = spk_train.synthetic_split(8)
        # the recipe shuffles its training set; here in a fixed order
        train_ds = train_ds[[int(i) for i in np.random.RandomState(
            0).permutation(len(train_ds))]]
        encoder = spk_data.get_label_encoder(storage_dir, train_ds)
        config = spk_train.get_trainer_config(
            storage_dir, len(encoder.label_mapping), on_device_features=True,
            updates={'stop_trigger': (epochs, 'epoch')})
        dump_config({'trainer': config}, storage_dir / 'config.json')
        trainer = Trainer.from_config(config)
        model_cpu = copy.deepcopy(trainer.model)
        trainer.to('cuda')
        train, dev = (spk_data.prepare_dataset_audio(
            ds, encoder, batch_size=8, shuffle=False, prefetch=False)
            for ds in (train_ds, dev_ds))
        n_train, n_dev = len(list(train)), len(list(dev))

        start = time.perf_counter()
        trainer.test_run(train, dev)
        print(f'phase 19a speaker classifier test_run passed on the card in '
              f'{time.perf_counter() - start:.2f} s')
        recorder = Recorder(nonzero=True)
        trainer.register_hook(recorder)
        trainer.register_validation_hook(dev, metric='accuracy',
                                         maximize=True)
        reset_launches()
        start = time.perf_counter()
        trainer.train(train)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = {'fused_logmel': fused_logmel.launches,
                    **gru_cell_scan.launches}
        trained_routes = check_gru_routes('phase 19b', 'resident')
        add_main_bwd_routes()
        iterations = trainer.iteration
        losses = [float(x) for x in recorder.losses]
        norms = [float(x) for x in recorder.norms]
        hook, = [h for h in trainer.hooks if isinstance(h, ValidationHook)]
        best = max(value for _, value in hook.ckpt_ranking)
        half = iterations // 2
        print(f'phase 19b speaker classifier trained {iterations} iterations '
              f'of 8 x 8000 samples in {seconds:.2f} s (validations and '
              f'checkpoints included), launches {launches}, GRU kernels by '
              f'route {trained_routes}; training loss '
              f'first half mean {np.mean(losses[:half]):.4f}, second half '
              f'mean {np.mean(losses[half:]):.4f}; best validation accuracy '
              f'{best:.3f} (chance 0.125)')
        validations = epochs + 1
        want = with_zeros(launches, {
            'fused_logmel': iterations + n_dev * validations,
            'fwd': n_dev * validations, 'fwd_train': iterations,
            'bwd': iterations})
        if iterations != epochs * n_train or launches != want:
            fail(f'launches {launches}, expected {want}: per step one '
                 f'fused_logmel, one GRU fwd_train and one bwd; per '
                 f'validation batch one fused_logmel and one GRU fwd')
        if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
            fail(f'non-finite loss or gradient norm: {losses} {norms}')
        if not np.mean(losses[half:]) < np.mean(losses[:half]):
            fail('the speaker classifier\'s training loss did not fall')
        # between two readings of this run on an H100: 0.583 as it stands,
        # and exactly 0.25 when the training set was left unshuffled (one
        # speaker per batch), where the classifier learns nothing that
        # carries over to the dev set although its loss falls
        if not best >= 0.4:
            fail(f'validation accuracy {best} is no better than a '
                 f'classifier that learned nothing (0.25)')
        batch = next(iter(train))
        compare_first_step(
            '19c speaker classifier', losses, norms,
            *first_step(model_cpu, batch, tmp, 10.0, 'cpu'),
            SPEAKER_STEP_RTOL)
        names = check_storage_dir(storage_dir, iterations,
                                  'ckpt_best_accuracy.ptt')

        # serving: the storage dir loaded back, its dev batches as requests
        loaded_cpu = SpeakerClf.from_storage_dir(
            storage_dir, checkpoint_name='ckpt_best_accuracy.ptt').eval()
        loaded = copy.deepcopy(loaded_cpu).to('cuda')
        reset_launches()
        results, latencies = {}, []
        for request in dev:
            start = time.perf_counter()
            results.update(spk_evaluate.evaluate_batch(loaded, request))
            latencies.append((time.perf_counter() - start) * 1e3)
        served = {'fused_logmel': fused_logmel.launches,
                  **gru_cell_scan.launches}
        served_routes = check_gru_routes('phase 19d', 'resident')
        reference = spk_evaluate.evaluate_batch(loaded_cpu, next(iter(dev)))
        diff = max(abs(results[k]['confidence'] - v['confidence'])
                   for k, v in reference.items())
        same = all(results[k]['predicted_label'] == v['predicted_label']
                   for k, v in reference.items())
        accuracy = float(np.mean([v['hit'] for v in results.values()]))
        print(f'phase 19d storage dir {names} loads; {n_dev} requests of up '
              f'to 8 x 8000 samples: latency ms '
              f'{[round(x, 3) for x in latencies]}, launches {served} '
              f'(GRU by route {served_routes}), '
              f'accuracy {accuracy:.3f} over {len(results)} utterances; card '
              f'vs CPU on the first request: same labels {same}, max |diff| '
              f'of confidence {diff:.3e} (tol {SPEAKER_TOL})')
        if served != with_zeros(served, {'fused_logmel': n_dev,
                                         'fwd': n_dev}) \
                or len(results) != len(dev_ds):
            fail(f'{n_dev} requests launch one fused_logmel and one GRU '
                 f'forward each, got {served}')
        if not same or not diff <= SPEAKER_TOL:
            fail('the speaker classifier on the card disagrees with the CPU')

        # the class defaults on 16 x 4 s of audio
        torch.manual_seed(0)
        full = Trainer(
            SpeakerClf(FusedAudioLogMelExtractor(16000, 512, 128, 64)),
            Path(tmp) / 'full', Adam(gradient_clipping=10.0, lr=3e-4))
        model = full.model
        width = (model.head.out_features, model.cnn[0].out_channels,
                 model.cnn[2].out_channels, model.gru.hidden_size,
                 model.gru.input_size)
        if width != (251, 32, 64, 256, 1024):
            fail(f'not the full-width speaker classifier: {width}')
        full_cpu = copy.deepcopy(model).eval()
        full.to('cuda')
        batch = speaker_batch(16, 64000, 251)

        def counts():
            return {'fused_logmel': fused_logmel.launches,
                    **gru_cell_scan.launches}

        reset_launches()
        with torch.no_grad():
            model.eval()
            example = model.example_to_device(batch)
            got = model(example).cpu()
            want = full_cpu(full_cpu.example_to_device(batch))
            err = float((got - want).abs().max())
            forward_ms = cuda_ms(lambda: model(example), iters=5, warmup=2)
            front_ms = cuda_ms(lambda: model.feature_extractor(
                example['audio_data'], seq_len=example['seq_len']),
                iters=5, warmup=2)
        full_forward = counts()
        forward_routes = check_gru_routes('phase 19e forward', 'cooperative')
        print(f'phase 19e full-width speaker classifier (251 speakers, '
              f'(32, 64) channels, 256 GRU units) on 16 x 64000 samples: '
              f'logits {tuple(got.shape)}, card vs CPU max |diff| {err:.3e} '
              f'(tol {SPEAKER_TOL}); forward {forward_ms:.3f} ms, of it the '
              f'front end with its normalization {front_ms:.3f} ms; '
              f'launches {full_forward}, GRU by route {forward_routes}')
        if full_forward != with_zeros(full_forward, {'fused_logmel': 15,
                                                     'fwd': 8}):
            fail(f'8 forwards and 7 front ends alone launch 15 fused_logmel '
                 f'and 8 GRU forwards, got {full_forward}')
        if got.shape != (16, 251) or not err <= SPEAKER_TOL:
            fail(f'the full-width speaker classifier on the card disagrees '
                 f'with the CPU: {err}')
        t = timed_step(full, batch, loss_key=None, wrapper=gru_cell_scan,
                       per_step=1)
        full_step = counts()     # of the 5 timed steps
        step_routes = check_gru_routes('phase 19e step', 'cooperative')
        add_main_bwd_routes()
        print('phase 19e full-width training step 16 x 64000 samples: '
              + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items())
              + f'; launches {full_step}, GRU by route {step_routes}')
    # the float32 kernels this path runs (phase 30 runs the bf16 ones)
    return {name: launches[name] + served[name] + full_forward[name]
            + full_step[name]
            for name in ('fused_logmel', 'fwd', 'fwd_train', 'bwd')}


# the decoder of bench.py's int8 decode benchmark (its bench_int8_decode)
DECODER = dict(d_model=1024, num_layers=12, num_heads=16)
VOCAB, MEMORY_FRAMES, NEW_TOKENS = 1024, 128, 128
INT8_WEIGHTS = [(1024, 1024), (1024, 4096), (4096, 1024)]
INT8_ROWS = (1, 8, 16, 32, 64, 128, 256)
INT8_ROW_SHAPE = (1, 1024, 4096, torch.bfloat16)   # the kernels line's row


def int8_inputs(m, k, n, dtype, seed=0):
    """Activations, int8 weights and scales of a Linear(k, n) (outputs of
    about 1), and a bias."""
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(m, k), dtype=dtype, device='cuda')
    w_q = torch.tensor(rng.randint(-127, 128, (k, n)), dtype=torch.int8,
                       device='cuda')
    scale = torch.tensor((rng.rand(n) * 0.5 + 0.75) / (127 * np.sqrt(k)),
                         dtype=torch.float32, device='cuda')
    bias = torch.tensor(rng.randn(n), dtype=torch.float32, device='cuda')
    return x, w_q, scale, bias


def bf16_ulps(got, want):
    """Largest |got - want| in units of one bf16 unit in the last place of
    want plus the float32 limit of the sums' order (INT8_TOL of the largest
    output: an output near zero is a float32 sum with cancellation)."""
    mag = want.float().abs()
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=1e-30))) - 7)
    limit = ulp + INT8_TOL * float(mag.max())
    return float(((got.float() - want.float()).abs() / limit).max())


def composed_route(x, w_q, scale, bias):
    """QuantizedLinear's composed route: the weight scaled in x's type."""
    y = x @ (w_q.to(x.dtype) * scale.to(x.dtype))
    return y if bias is None else y + bias.to(x.dtype)


def int8_case(m, k, n, dtype):
    """Kernel against plain (with and without bias) at one shape; the
    composed route as the control.  Returns the row of numbers."""
    x, w_q, scale, bias = int8_inputs(m, k, n, dtype)
    err = {}
    for b in (bias, None):
        got = int8_matmul(x, w_q, scale, b)
        want = int8_matmul_plain(x, w_q, scale, b)
        control = composed_route(x, w_q, scale, b)
        torch.cuda.synchronize()
        key = 'bias' if b is not None else 'no bias'
        if dtype == torch.float32:
            err[key] = (max_rel_err([got], [want]),
                        float((got - want).abs().max()))
        else:
            err[key] = (bf16_ulps(got, want),
                        float((got.float() - want.float()).abs().max()))
            err[key + ', composed route'] = (bf16_ulps(control, want), None)
    limit = INT8_TOL if dtype == torch.float32 else INT8_BF16_ULPS
    for key, (e, _) in err.items():
        if 'composed' in key:
            if not e > limit:
                fail(f'int8_matmul at ({m}, {k}, {n}) bf16: the composed '
                     f'route passes the limit ({e} ulps): the limit does not '
                     f'tell the two rounding routes apart')
        elif not e <= limit:
            fail(f'int8_matmul kernel disagrees with plain at ({m}, {k}, {n}) '
                 f'{dtype}, {key}: {e}')
    w_deq = w_q.to(dtype) * scale.to(dtype)
    bias_x = bias.to(dtype)
    routes = {
        '': lambda: int8_matmul(x, w_q, scale, bias),
        'plain_': lambda: int8_matmul_plain(x, w_q, scale, bias),
        'composed_': lambda: composed_route(x, w_q, scale, bias),
        'library_': lambda: torch.addmm(bias_x, x, w_deq),
    }
    # a call's device time from CUDA-graph replays (the kernels line), its
    # eager time, which at these sizes is the host's, and the host's own
    # time to enqueue one call
    times = {}
    for key, fn in routes.items():
        times[key + 'ms'] = graph_ms(fn)
        times[key + 'eager_ms'] = cuda_ms(fn, iters=50, warmup=2)
        times[key + 'host_us'] = host_us(fn)
    out_bytes = m * n * x.element_size()
    # bf16 products are exact on the tensor cores (int8 weights widen to
    # bf16 exactly, sums in float32): their peak bounds the operations
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    limits = bound(nbytes(x, w_q, scale, bias) + out_bytes, 2.0 * m * k * n,
                   peak)
    return {'err': err, 'max_abs_err': err['bias'][1], **times, **limits}


def host_us(fn, calls=100):
    """Microseconds of host time to enqueue one call (the card is left to
    catch up afterwards)."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def int8_batch_bits():
    """bf16: every row of a batch of 1 ... 256 equals the row alone, bit
    for bit, at the decoder's shapes; two calls in a row and calls replayed
    from a CUDA graph give the same bits (the per-tile counters are back at
    0 after every launch)."""
    checked = 0
    for k, n in INT8_WEIGHTS:
        x, w_q, scale, bias = int8_inputs(256, k, n, torch.bfloat16)
        full = int8_matmul(x, w_q, scale, bias)
        for m in (1, 2, 3, 8, 16, 31, 32, 64, 100, 128, 255):
            if not torch.equal(int8_matmul(x[:m], w_q, scale, bias),
                               full[:m]):
                fail(f'int8_matmul ({k}, {n}) bf16: the first {m} rows of '
                     f'a batch of 256 differ from the same rows alone')
            checked += 1
        for i in (0, 97, 255):
            if not torch.equal(int8_matmul(x[i:i + 1], w_q, scale, bias)[0],
                               full[i]):
                fail(f'int8_matmul ({k}, {n}) bf16: row {i} of a batch of '
                     f'256 differs from the row alone')
            checked += 1
        if not torch.equal(int8_matmul(x, w_q, scale, bias), full):
            fail(f'int8_matmul ({k}, {n}) bf16: two calls differ')
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            int8_matmul(x[:8], w_q, scale, bias)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = [int8_matmul(x[:m], w_q, scale, bias)
                        for m in (8, 128, 8)]
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(out, full[:out.shape[0]]) for out in replayed):
            fail(f'int8_matmul ({k}, {n}) bf16: calls replayed from a CUDA '
                 f'graph differ from eager ones')
        if not torch.equal(int8_matmul(x, w_q, scale, bias), full):
            fail(f'int8_matmul ({k}, {n}) bf16: a call after the graph '
                 f'differs')
        del graph
    print(f'phase 20 int8_matmul bf16: {checked} batches and rows equal to '
          f'the same rows of a batch of 256 bit for bit at the three '
          f'decoder shapes; repeated calls and CUDA-graph replays equal')


def int8_dispatch_rows():
    """The kernel route against the composed route of QuantizedLinear
    (bf16) by rows of x: where the kernel stops winning sets
    INT8_KERNEL_MAX_ROWS."""
    wins = {}
    for k, n in INT8_WEIGHTS:
        torch.manual_seed(0)
        layer = QuantizedLinear.from_linear(
            torch.nn.Linear(k, n).to('cuda', torch.bfloat16))
        cells = []
        for m in (1, 2, 4, 8, 16, 32, 64, 128, 256):
            x = torch.randn((m, k), device='cuda', dtype=torch.bfloat16)
            ms = {}
            for route in (True, False):
                layer.use_kernel = route
                with torch.no_grad():
                    ms[route] = graph_ms(lambda: layer(x))
            wins.setdefault(m, []).append(ms[True] <= ms[False])
            cells.append(f'{m}: {ms[True]:.4f} / {ms[False]:.4f}')
        print(f'phase 20 dispatch ({k}, {n}) bf16, device ms (CUDA graph) '
              f'kernel / composed by rows: ' + ', '.join(cells))
    measured = 0
    for m in sorted(wins):
        if not all(wins[m]):
            break
        measured = m
    print(f'phase 20 dispatch: the kernel wins at every shape up to '
          f'{measured} rows; INT8_KERNEL_MAX_ROWS is '
          f'{int8_kernels.INT8_KERNEL_MAX_ROWS}')


def phase_int8_kernel():
    """Phase 20: int8_matmul against its plain version at the decoder's
    shapes, timed beside plain, the composed route, cuBLAS on the
    dequantized weight and the bound; the TF32 control; the dispatch rows.
    Returns the kernel's row at INT8_ROW_SHAPE."""
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        for k, n in INT8_WEIGHTS + [(1000, 1030)]:
            for m in INT8_ROWS if (k, n) != (1000, 1030) else (1, 8, 37, 70):
                r = int8_case(m, k, n, dtype)
                name = 'f32' if dtype == torch.float32 else 'bf16'
                print(f'phase 20 int8_matmul M={m} K={k} N={n} {name}: '
                      + ', '.join(f'{key} {e:.3g}' for key, (e, _) in
                                  r['err'].items())
                      + (' (relative, tol 1e-5)' if name == 'f32' else
                         ' (ulps, tol 1)')
                      + f'; device ms (CUDA graph; eager in brackets) '
                      f'kernel {r["ms"]:.4f} ({r["eager_ms"]:.4f}), plain '
                      f'{r["plain_ms"]:.4f} ({r["plain_eager_ms"]:.4f}), '
                      f'composed {r["composed_ms"]:.4f} '
                      f'({r["composed_eager_ms"]:.4f}), addmm on the '
                      f'dequantized {name} weight {r["library_ms"]:.4f} '
                      f'({r["library_eager_ms"]:.4f}), bound '
                      f'{r["bound_ms"]:.5f} ms by {r["bound_by"]} '
                      f'({r["peak"]} peak); host us per eager call kernel '
                      f'{r["host_us"]:.1f}, addmm {r["library_host_us"]:.1f}')
                if (m, k, n, dtype) == INT8_ROW_SHAPE:
                    row = {key: r[key] for key in (
                        'max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                        'bound_by', 'peak', 'library_ms')}
                torch.cuda.empty_cache()
    x, w_q, scale, bias = int8_inputs(32, 1024, 1024, torch.float32)
    want = int8_matmul_plain(x, w_q, scale, bias)
    tf32 = max_rel_err([with_tf32(lambda: int8_matmul_plain(
        x, w_q, scale, bias))], [want])
    print(f'phase 20 control, plain with TF32 products at M=32 K=N=1024: '
          f'{tf32:.3e} relative')
    if not tf32 > INT8_TOL:
        fail('the TF32 control passes the int8_matmul limit')
    for bad, what in (
            (lambda: int8_matmul(x.half(), w_q, scale), 'a float16 x'),
            (lambda: int8_matmul(x.clone().requires_grad_(), w_q, scale),
             'an x that requires a gradient'),
            (lambda: int8_matmul(x, w_q.cpu(), scale), 'a weight on the CPU'),
            (lambda: int8_matmul(x[:, :1000], w_q, scale), 'a K mismatch')):
        try:
            bad()
        except (TypeError, ValueError):
            continue
        fail(f'int8_matmul took {what}')
    int8_batch_bits()
    int8_two_streams()
    int8_dispatch_rows()
    return row


def int8_two_streams(iters=200):
    """bf16 launches with several K splits, (8, 4096, 1024), on two
    streams at once, ``iters`` times each: every output equal to its
    one-stream result bit for bit, and every per-tile counter back at zero
    (each stream counts into counters of its own)."""
    if not -(-4096 // int8_kernels.bf16_split_rows(4096, 1024)) > 1:
        fail('(8, 4096, 1024) bf16 has no K splits: not the test it was')
    inputs = [int8_inputs(8, 4096, 1024, torch.bfloat16, seed=s)
              for s in (1, 2)]
    want = [int8_matmul(*args) for args in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for stream in streams:
        stream.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(iters):
        for i, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                outs[i].append(int8_matmul(*inputs[i]))
    torch.cuda.synchronize()
    equal = [sum(torch.equal(o, want[i]) for o in outs[i]) for i in range(2)]
    left = {key: int(c.count_nonzero())
            for key, c in int8_kernels._counters.items()}
    print(f'phase 20 int8_matmul bf16 (8, 4096, 1024) on two streams at '
          f'once, {iters} launches each: {equal} equal to the one-stream '
          f'result bit for bit; non-zero counters left, by (device, '
          f'stream): {left}')
    if equal != [iters, iters] or any(left.values()):
        fail('int8_matmul launches on two streams at once disagree with '
             'one stream, or left counters non-zero')


def full_width_decoder():
    """bench.py's int8 decode model from seed 0: the decoder, its head,
    and (numpy seed 0) the embedding table x 0.05 and 128 frames of
    memory, all float32 on the card."""
    torch.manual_seed(0)
    dec = TransformerDecoder(**DECODER).eval()
    head = torch.nn.Linear(DECODER['d_model'], VOCAB).eval()
    n_params = sum(p.numel() for p in (*dec.parameters(), *head.parameters()))
    rng = np.random.RandomState(0)
    emb = torch.tensor(rng.randn(VOCAB, DECODER['d_model']) * 0.05,
                       dtype=torch.float32)
    memory = torch.tensor(
        rng.randn(1, MEMORY_FRAMES, DECODER['d_model']), dtype=torch.float32)
    return dec.cuda(), head.cuda(), emb.cuda(), memory.cuda(), n_params


def set_int8_route(modules, use_kernel):
    for module in modules:
        for m in module.modules():
            if isinstance(m, QuantizedLinear):
                m.use_kernel = use_kernel


def generate(dec, head, emb, memory, max_len=NEW_TOKENS, **kwargs):
    return autoregressive_generate(
        dec, memory, embed=lambda t: emb[t], logits_head=head, bos_id=0,
        max_len=max_len, **kwargs)


def us_per_token(dec, head, emb, memory):
    """Best of 3 generations of NEW_TOKENS after a warm-up, host clock
    ended by a synchronize; and the last generation's tokens."""
    generate(dec, head, emb, memory)
    torch.cuda.synchronize()
    best = float('inf')
    for _ in range(3):
        start = time.perf_counter()
        tokens, _ = generate(dec, head, emb, memory)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - start)
    return best / NEW_TOKENS * 1e6, tokens


def profile_decode(settings, n_tokens=32):
    """``--profile``: the card's busy time per token of the B=1 decode
    (torch.profiler, the device's kernel events) against the host clock of
    the same generation under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for name, (d, h, e, mem) in settings.items():
        generate(d, h, e, mem, max_len=n_tokens)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            generate(d, h, e, mem, max_len=n_tokens)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3
        kernels = [ev for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA]
        busy = sum(ev.self_device_time_total for ev in kernels) / 1e3
        int8 = sum(ev.self_device_time_total for ev in kernels
                   if 'int8_matmul' in ev.key) / 1e3
        launches = sum(ev.count for ev in kernels)
        print(f'phase 21 profile {name}, {n_tokens} tokens: '
              f'{wall_ms / n_tokens:.1f} ms per token under the profiler, '
              f'card busy {busy / n_tokens * 1e3:.1f} us per token '
              f'({busy / wall_ms:.1%}), {launches / n_tokens:.0f} kernels '
              f'per token, int8_matmul {int8 / n_tokens * 1e3:.1f} us')
        print(prof.key_averages().table(sort_by='self_device_time_total',
                                        row_limit=8))


def phase_decode(profile=False):
    """Phase 21: bench.py's int8 decode at full width, B=1, 128 greedy
    tokens, in four settings; decode against forward in float32; the int8
    kernel route against the composed route on bf16 forward logits; the
    kernel's launches in one generation; with ``profile`` the card's busy
    time per token.  Returns (launches, modules)."""
    dec, head, emb, memory, n_params = full_width_decoder()
    d_model = DECODER['d_model']
    # float32: teacher-forced decode_step logits against one forward (its
    # causal self-attention on the flash_attention kernel)
    with torch.no_grad():
        tokens, _ = generate(dec, head, emb, memory)
        inputs = torch.cat([torch.zeros_like(tokens[:, :1]),
                            tokens[:, :-1]], 1).long()
        x = emb[inputs]
        before = flash_attention.launches['fwd']
        want = head(dec(x, memory))
        fwd_launches = flash_attention.launches['fwd'] - before
        cache = dec.init_cache(memory, NEW_TOKENS)
        got = torch.cat([head(dec.decode_step(x[:, t:t + 1], cache, t)[0])
                         for t in range(NEW_TOKENS)], 1)
    err = max_rel_err([got], [want])
    print(f'phase 21 full-width decoder ({n_params} parameters, d_model '
          f'{d_model}, 12 layers, 16 heads, vocabulary {VOCAB}, memory '
          f'{MEMORY_FRAMES} frames), float32: teacher-forced decode_step '
          f'logits vs forward over {NEW_TOKENS} positions {err:.3e} relative '
          f'(tol {DECODE_RTOL}); the forward launched flash_attention '
          f'{fwd_launches} times')
    if not err <= DECODE_RTOL:
        fail(f'decode_step disagrees with the forward: {err}')
    if fwd_launches < DECODER['num_layers']:
        fail(f'the float32 forward launched flash_attention {fwd_launches} '
             f'times, less than once per layer')
    del got, want, cache
    settings = {'f32 plain': (dec, head, emb, memory)}
    dec16 = copy.deepcopy(dec).to(torch.bfloat16)
    head16 = copy.deepcopy(head).to(torch.bfloat16)
    emb16, memory16 = emb.to(torch.bfloat16), memory.to(torch.bfloat16)
    settings['bf16 plain'] = (dec16, head16, emb16, memory16)
    q_dec = copy.deepcopy(dec16)
    quantize_module(q_dec)
    q_head = QuantizedLinear.from_linear(head16)
    settings['bf16 int8 composed'] = settings['bf16 int8 kernel'] = (
        q_dec, q_head, emb16, memory16)
    # the kernel route against the composed route on forward logits
    xs = torch.tensor(np.random.RandomState(0).randn(1, 4, d_model) * 0.05,
                      dtype=torch.bfloat16, device='cuda')
    logits = {}
    with torch.no_grad():
        for route in (True, False):
            set_int8_route((q_dec, q_head), route)
            logits[route] = q_head(q_dec(xs, memory16)).float()
    parity = float(((logits[True] - logits[False]).abs()
                    / (1 + logits[False].abs())).max())
    print(f'phase 21 int8 kernel vs composed route, bf16 forward logits: '
          f'{parity:.3e} (tol {INT8_ROUTES_RTOL})')
    if not parity < INT8_ROUTES_RTOL:
        fail(f'the int8 kernel route disagrees with the composed route: '
             f'{parity}')
    # the main path: one generation on the kernel, its launches counted
    set_int8_route((q_dec, q_head), True)
    reset_launches()
    with torch.no_grad():
        kernel_tokens, _ = generate(q_dec, q_head, emb16, memory16)
        torch.cuda.synchronize()
    launches = int8_matmul.launches
    want_launches = (2 * DECODER['num_layers']
                     + NEW_TOKENS * (8 * DECODER['num_layers'] + 1))
    print(f'phase 21 int8 kernel decode: {launches} int8_matmul launches '
          f'(expected {want_launches}: 24 cross K/V projections of 128 rows, '
          f'then 97 per token)')
    if launches != want_launches:
        fail(f'the kernel decode launched int8_matmul {launches} times')
    results, tokens = {}, {}
    for name, (d, h, e, mem) in settings.items():
        if name.startswith('bf16 int8'):
            set_int8_route((d, h), name.endswith('kernel'))
        results[name], tokens[name] = us_per_token(d, h, e, mem)
        if not bool(torch.isfinite(tokens[name].float()).all()):
            fail(f'{name}: generation is not finite')
        torch.cuda.empty_cache()
    if not torch.equal(tokens['bf16 int8 kernel'], kernel_tokens):
        fail('two kernel generations of the same request differ')
    # the same generation with every kernel call through the ptt
    # operators' dispatcher, as a traced graph makes it, instead of the
    # operators' CUDA implementations called directly (the eager route):
    # the same function, so the same bits
    set_int8_route((q_dec, q_head), True)
    with torch.no_grad():
        direct = q_head(q_dec(xs, memory16))
    _ops.EAGER_DIRECT = False
    try:
        with torch.no_grad():
            dispatched = q_head(q_dec(xs, memory16))
        name = 'bf16 int8 kernel, operator dispatch'
        results[name], tokens[name] = us_per_token(q_dec, q_head, emb16,
                                                   memory16)
    finally:
        _ops.EAGER_DIRECT = True
    if not (torch.equal(direct, dispatched)
            and torch.equal(tokens[name], kernel_tokens)):
        fail('the kernels through the operators\' dispatcher give other '
             'bits than their CUDA implementations called directly')
    same = float((tokens['bf16 int8 kernel']
                  == tokens['bf16 int8 composed']).float().mean())
    print('phase 21 B=1 greedy decode of 128 tokens, us per token (best of '
          '3, host clock): ' + ', '.join(
              f'{name} {us:.1f}' for name, us in results.items())
          + f'; kernel and composed routes pick the same token at '
          f'{same:.0%} of the positions (not a parity target)')
    set_int8_route((q_dec, q_head), True)
    if profile:
        profile_decode({name: settings[name]
                        for name in ('bf16 plain', 'bf16 int8 kernel')})
    del settings, dec, dec16, head16, tokens
    torch.cuda.empty_cache()
    return launches, (q_dec, q_head, emb16)


def phase_serving(models):
    """Phase 22: ContinuousBatcher at full width, bf16, int8 kernel, 8
    slots; 16 requests (memory of 32 to 128 frames, 16 to 64 new tokens)
    against each decoded alone.  Returns the kernel's launches."""
    q_dec, q_head, emb16 = models
    d_model = DECODER['d_model']
    rng = np.random.RandomState(1)
    requests = [(torch.tensor(rng.randn(int(s), d_model),
                              dtype=torch.bfloat16, device='cuda'), int(c))
                for s, c in zip(rng.randint(32, 129, 16),
                                rng.randint(16, 65, 16))]
    seen = {}
    batcher = None

    def recording_head(x):
        out = q_head(x)
        for slot, rid in enumerate(batcher._request):
            if rid is not None:
                seen.setdefault(rid, []).append(out[slot].float().cpu())
        return out

    def serve(head):
        nonlocal batcher
        batcher = ContinuousBatcher(
            q_dec, embed=lambda t: emb16[t], logits_head=head, num_slots=8,
            max_len=64, max_memory_len=MEMORY_FRAMES, d_memory=d_model,
            bos_id=0, eos_id=1, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        start = time.perf_counter()
        ids = [batcher.submit(mem, max_new_tokens=cap)
               for mem, cap in requests]
        steps = 0
        while batcher.pending or batcher.active.any():
            batcher.step()
            steps += 1
        torch.cuda.synchronize()
        return ids, dict(batcher.finished), steps, time.perf_counter() - start

    reset_launches()
    ids, outputs, steps, _ = serve(recording_head)
    launches = int8_matmul.launches
    _, _, steps2, seconds = serve(q_head)
    n_tokens = sum(len(outputs[rid]) for rid in ids)
    print(f'phase 22 served 16 requests in {steps2} steps of 8 slots: '
          f'{seconds:.3f} s, {16 / seconds:.2f} requests/s, '
          f'{n_tokens / seconds:.1f} tokens/s, '
          f'{seconds / steps2 * 1e6:.1f} us per step; int8_matmul launches '
          f'{launches} in the recorded run ({steps} steps)')
    if launches == 0:
        fail('the batcher never launched int8_matmul')
    worst, ties = 0.0, 0
    for rid, (mem, cap) in zip(ids, requests):
        alone = []

        def head_alone(x, alone=alone):
            out = q_head(x)
            alone.append(out[0].float().cpu())
            return out

        with torch.no_grad():
            tokens, lengths = generate(q_dec, head_alone, emb16, mem[None],
                                       max_len=cap, eos_id=1)
        want = tokens[0, :int(lengths[0])].tolist()
        got = outputs[rid]
        n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        scale = max(float(a.abs().max()) for a in alone)
        for a, b in zip(seen[rid][:n + 1], alone[:n + 1]):
            worst = max(worst, float((a - b).abs().max()) / scale)
        if got == want:
            continue
        if n >= len(alone) or not bool(near_ties(
                alone[n], 2 * SERVE_LOGIT_RTOL * scale)):
            fail(f'request {rid}: the batcher gives {got}, alone {want}, '
                 f'not at a near tie')
        ties += 1
    print(f'phase 22 each request against itself decoded alone: logits '
          f'{worst:.3e} relative (tol {SERVE_LOGIT_RTOL}), tokens equal but '
          f'at {ties} near ties')
    if not worst <= SERVE_LOGIT_RTOL:
        fail(f'batched logits disagree with single decoding: {worst}')
    return launches


# phase 23: the bf16 LSTM kernels against their plain bf16 versions on the
# same inputs.  The float32 states within 3e-4 (forward: h_T, c_T) and 1e-3
# (backward: dh0, dc0), about twice what the card shows: the same bf16
# products summed in float32 in another order, where a value near a
# rounding boundary rounds the other way and the recurrence carries that
# on.  The streams (out, c_seq, gates, dgates_x) are bf16: every element
# within one bf16 unit in the last place (of the larger of the two values)
# plus 1e-3 (forward) or 2e-3 (backward), since the float32 carries inside
# the sequence move further apart than at its end, and at most 5% of the
# elements other than plain's.  The control, the plain version with
# float32 products on the same bf16 streams, differs from the bf16 plain
# in about 6% of the stream elements or more and must fail the share
# limit: the limit tells bf16 products from float32.
LSTM_BF16_SHARE = 0.05
LSTM_BF16_STATE_TOL = {'fwd': 3e-4, 'fwd_train': 3e-4, 'bwd': 1e-3}
LSTM_BF16_STREAM_TOL = {'fwd': 1e-3, 'fwd_train': 1e-3, 'bwd': 2e-3}
# (label, T, rows per direction, H, mask kind, the layer's input width for
# the cuDNN yardstick); the first is the flagship layer (the kernels line's
# shape), then the DPRNN's two, then an odd H, where both kernels copy rows
# of h and of dz without 16-byte copies
LSTM_BF16_SHAPES = [
    ('T=500 D*B=32 H=600 ragged', 500, 16, 600, 'ragged', 1200),
    ('intra T=100 D*B=520 H=128', 100, 260, 128, None, 64),
    ('inter T=65 D*B=800 H=128', 65, 400, 128, 'chunks', 64),
    ('T=64 D*B=10 H=75 ragged', 64, 5, 75, 'ragged', 150),
]
# the flagship bf16 step of phase 24 against the float32 step from the same
# start: the JAX package saw its losses about 0.5% apart over 50 steps
FLAGSHIP_BF16_LOSS_RTOL = 0.05
# the bf16 flagship model's masks on the card against the same model on
# the CPU (plain bf16 versions), one request: the JAX package's limit for
# its bf16 module against its other backend
BF16_MODEL_TOL = 5e-2


def bf16_distance(got, want, atol, floor=0.0):
    """Over pairs of tensors: (largest difference beyond one bf16 unit in
    the last place of the larger of the two values plus ``atol``, share of
    elements that differ by more than ``floor``)."""
    worst, differ, total = -float('inf'), 0, 0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        big = torch.maximum(g.abs(), w.abs())
        ulp = torch.where(big > 0, torch.exp2(torch.floor(torch.log2(
            torch.where(big > 0, big, torch.ones_like(big)))) - 7),
            torch.zeros_like(big))
        worst = max(worst, float((diff - ulp - atol).max()))
        differ += int((diff > floor).sum())
        total += diff.numel()
    return worst, differ / total


def bf16_grad_distance(got, want, rtol=None):
    """:func:`bf16_distance` over gradients, each with ``rtol`` times its
    own largest entry as the limit beyond one unit and as the floor of the
    share."""
    rtol = ATTENTION_BF16_GRAD_RTOL if rtol is None else rtol
    worst, differ, total = -float('inf'), 0.0, 0
    for g, w in zip(got, want):
        tol = rtol * float(w.float().abs().max())
        excess, share = bf16_distance([g], [w], tol, tol)
        worst = max(worst, excess)
        differ += share * w.numel()
        total += w.numel()
    return worst, differ / total


def lse_distance(got, want):
    """Largest |got - want| / max(|want|, 1) of two log-sum-exps."""
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


def lstm_bf16_case(label, t_len, batch, hdim, kind, in_size):
    """The three bf16 kernels at one shape: agreement with plain, the
    control, times beside the float32 kernels, plain, cuDNN in bf16 and
    the bound."""
    args, cot = recurrence_inputs(t_len, batch, hdim, kind, gates=4)
    gx, w, mask, h0, c0 = args
    gx16 = gx.to(torch.bfloat16)
    d_out16 = cot[0].to(torch.bfloat16)
    args16 = (gx16, w, mask, h0, c0)
    valid = t_len * 2 * batch if mask is None else float(mask.sum())
    flops = valid * (2 * hdim * 4 * hdim + 30 * hdim)

    def fwd():
        return lstm_cell_scan(*args16, compute_dtype='bfloat16')

    def fwd_train():
        return lstm_kernels._launch(gx16, w, 2, mask, h0, c0, train=True)

    want_train = lstm_cell_scan_train_plain(*args16, 'bfloat16')
    _, c_seq, gates, _, _ = want_train
    bwd_in = (gates, c_seq, w, mask, d_out16, cot[1], cot[2])

    def bwd():
        return lstm_kernels._launch_bwd(gates, c_seq, w, 2, mask,
                                        *bwd_in[4:])

    # the kernels' routes by the launch counters: the `mma` route here
    before = lstm_routes()
    got = {'fwd': fwd(), 'fwd_train': fwd_train(), 'bwd': bwd()}
    taken = routes_since(before)
    if taken != {'fwd_bf16': {'mma': 1}, 'fwd_train_bf16': {'mma': 1},
                 'bwd_bf16': {'mma': 1}}:
        fail(f'the bf16 LSTM kernels at {label} did not all take the mma '
             f'route: {taken}')
    again = {'fwd': fwd(), 'fwd_train': fwd_train(), 'bwd': bwd()}
    same = {name: all(torch.equal(x, y) for x, y in zip(got[name],
                                                        again[name]))
            for name in got}
    del again
    want = {'fwd': lstm_cell_scan_plain(*args16, 'bfloat16'),
            'fwd_train': want_train,
            'bwd': lstm_cell_scan_bwd_plain(*bwd_in, 'bfloat16')}
    control = {'fwd': lstm_cell_scan_plain(*args16),
               'fwd_train': lstm_cell_scan_train_plain(*args16),
               'bwd': lstm_cell_scan_bwd_plain(*bwd_in)}
    torch.cuda.synchronize()
    streams = {'fwd': 1, 'fwd_train': 3, 'bwd': 1}
    # the float32 kernels at the same shape, on float32 inputs
    f32_train = lstm_kernels._launch(gx, w, 2, mask, h0, c0, train=True)
    f32 = {'fwd': lambda: lstm_cell_scan(*args),
           'fwd_train': lambda: lstm_kernels._launch(
               gx, w, 2, mask, h0, c0, train=True),
           'bwd': lambda: lstm_kernels._launch_bwd(
               f32_train[2], f32_train[1], w, 2, mask, *cot)}
    plain = {'fwd': lambda: lstm_cell_scan_plain(*args16, 'bfloat16'),
             'fwd_train': lambda: lstm_cell_scan_train_plain(
                 *args16, 'bfloat16'),
             'bwd': lambda: lstm_cell_scan_bwd_plain(*bwd_in, 'bfloat16')}
    kernel = {'fwd': fwd, 'fwd_train': fwd_train, 'bwd': bwd}
    library = cudnn_layer_ms(torch.nn.LSTM, t_len, batch, in_size, hdim,
                             dtype=torch.bfloat16)
    inputs = {'fwd': args16, 'fwd_train': args16, 'bwd': bwd_in}
    # the card's mma plans and their mirror (ops/kernels/lstm.py mma_plan)
    device = torch.cuda.current_device()
    grids = {'fwd': lstm_kernels.device_grid('lstm_fwd', 2, batch, hdim,
                                             True, device),
             'fwd_train': lstm_kernels.device_grid('lstm_fwd', 2, batch,
                                                   hdim, True, device, True),
             'bwd': lstm_kernels.bwd_grid(2, batch, hdim, bf16=True)}
    for name, grid in grids.items():
        plan = lstm_kernels.mma_plan(
            2, batch, hdim, *gru_kernels.device_limits(device),
            'lstm_bwd' if name == 'bwd' else 'lstm_fwd')
        if not grid['mma'] or plan is None or (
                grid['U'], grid['n_rb'], grid['RB'], grid['RS'], grid['KS'],
                grid['blocks']) != (lstm_kernels.MMA_UNITS, plan.n_rb,
                                    plan.RB, plan.RS, plan.KCH, plan.blocks):
            fail(f'the bf16 {name} kernel\'s grid at {label} is not the '
                 f'mirror\'s mma plan: {grid}, {plan}')
    rows = {}
    for name in ('fwd', 'fwd_train', 'bwd'):
        n = streams[name]
        tol, stream_tol = (LSTM_BF16_STATE_TOL[name],
                           LSTM_BF16_STREAM_TOL[name])
        excess, share = bf16_distance(got[name][:n], want[name][:n],
                                      stream_tol)
        stream_err = max_err(got[name][:n], want[name][:n])
        state_err = max_err(got[name][n:], want[name][n:])
        _, control_share = bf16_distance(control[name][:n], want[name][:n],
                                         stream_tol)
        control_state = max_err(control[name][n:], want[name][n:])
        ms = cuda_ms(kernel[name], iters=10)
        f32_ms = cuda_ms(f32[name], iters=10)
        plain_ms = cuda_ms(plain[name], iters=2)
        limit = bound(nbytes(*inputs[name], *got[name]), flops,
                      peak=PEAK_BF16_FLOPS)
        shown = (' on the mma route, grid ' + ', '.join(
            f'{k} {v}' for k, v in grids[name].items())
            + f', two runs the same bits {same[name]}')
        print(f'phase 23 lstm bf16 {name} {label}: states max |kernel - '
              f'plain| {state_err:.3e} (tol {tol}; plain with float32 '
              f'products {control_state:.3e}); streams max |diff| '
              f'{stream_err:.3e}, {excess + stream_tol:.3e} beyond one bf16 '
              f'ulp (tol {stream_tol}), {share:.3%} of them differ (tol '
              f'{LSTM_BF16_SHARE:.0%}; plain with float32 products '
              f'{control_share:.3%}); kernel {ms:.3f} ms, the float32 '
              f'kernel {f32_ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN bf16 '
              f'{library[name]:.3f} ms, bound {limit["bound_ms"]:.4f} ms by '
              f'{limit["bound_by"]}{shown}')
        if not (excess <= 0 and share <= LSTM_BF16_SHARE
                and state_err <= tol):
            fail(f'lstm bf16 {name} kernel disagrees with plain at {label}: '
                 f'streams {excess} beyond the limit, {share} of them '
                 f'differ, states {state_err}')
        if not control_share > LSTM_BF16_SHARE:
            fail(f'the limit does not tell bf16 products from float32 at '
                 f'{label} ({name}): {control_share}')
        if not same[name]:
            fail(f'two bf16 {name} runs at {label} differ')
        rows[name] = {
            'max_abs_err': max_err(got[name], want[name]),
            'share_differing': share, 'state_err': state_err,
            'control_share': control_share, 'control_state': control_state,
            'ms': ms, 'f32_kernel_ms': f32_ms,
            'plain_ms': plain_ms, **limit, 'library_ms': library[name]}
    return rows


def phase_lstm_bf16_kernels():
    """Phase 23: the three bf16 LSTM kernels at the flagship layer, the
    DPRNN's two shapes and an odd H (see LSTM_BF16_SHAPES); the bf16
    backward's digests."""
    rows = {}
    for shape in LSTM_BF16_SHAPES:
        rows[shape[0]] = lstm_bf16_case(*shape)
        torch.cuda.empty_cache()
    digests = lstm_bf16_bwd_digests(Path(__file__).resolve().parent)
    print(f'phase 23 bf16 LSTM backward\'s digests on fixed inputs '
          f'(unmasked and ragged): {json.dumps(digests)}')
    return rows


def lstm_routes():
    """A copy of ``lstm_cell_scan.routes``: {kernel: {route: launches}}."""
    return {name: dict(counts)
            for name, counts in lstm_cell_scan.routes.items()}


def routes_since(before):
    """The LSTM launches by kernel and route since ``before``
    (:func:`lstm_routes`), the kernels and routes that took some."""
    taken = {}
    for name, counts in lstm_cell_scan.routes.items():
        moved = {route: n - before[name][route]
                 for route, n in counts.items() if n != before[name][route]}
        if moved:
            taken[name] = moved
    return taken


def losses_over(trainer, batch, steps):
    """The loss of each of ``steps`` optimizer steps on one batch."""
    losses = []
    for _ in range(steps):
        loss = trainer.train_step(trainer.model, batch)[0]
        loss.backward()
        trainer.optimizer.step()
        trainer.optimizer.zero_grad()
        losses.append(loss.detach())
    return [float(x) for x in losses]


def masters_are_float32(trainer, label):
    dtypes = {p.dtype for p in trainer.model.parameters()}
    dtypes |= {v.dtype for state in trainer.optimizer.optimizer.state.values()
               for v in state.values()
               if torch.is_tensor(v) and v.is_floating_point()}
    if dtypes != {torch.float32}:
        fail(f'{label}: master parameters or Adam moments are {dtypes}')


def phase_flagship_bf16():
    """Phase 24: the JAX package's benchmarked flagship step (bench.py
    ``_time_pit_step``: F=257, 3 x 600 BLSTM, K=2, B=16, T=500,
    ``compute_dtype='bfloat16'`` under the bf16 policy, Adam with clip 10,
    both PIT losses) beside the float32 step from the same start; then the
    bf16 model served (the lean bf16 forward)."""
    rng = np.random.RandomState(0)
    b, t_len, f = 16, 500, 257
    batch = {
        'Y_abs': np.abs(rng.randn(b, t_len, f)).astype('float32'),
        'X_abs': np.abs(rng.randn(b, t_len, 2, f)).astype('float32'),
        'cos_phase_difference': np.cos(rng.randn(b, t_len, 2, f)).astype(
            'float32'),
        'num_frames': np.full(b, t_len, 'int32'),
    }
    steps = 20
    results, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, compute_dtype, precision in (
                ('bf16', 'bfloat16', 'bfloat16'), ('f32', None, None)):
            torch.manual_seed(0)
            model = PermutationInvariantTrainingModel(
                F=f, recurrent_layers=3, units=600, K=2,
                compute_dtype=compute_dtype)
            trainer = Trainer(
                model, Path(tmp) / label,
                Adam(gradient_clipping=10.0, lr=1e-3),
                loss_weights={'pit_mse_loss': 1.0, 'pit_ips_loss': 1.0},
                precision=precision).to('cuda')
            example = model.example_to_device(batch, 'cuda')
            reset_launches()
            losses = losses_over(trainer, example, steps)
            launches[label] = dict(lstm_cell_scan.launches)
            routes = lstm_routes()
            if compute_dtype and any(
                    routes[name]['mma'] != launches[label][name]
                    for name in ('fwd_bf16', 'fwd_train_bf16', 'bwd_bf16')):
                fail(f'the bf16 flagship step\'s launches did not all take '
                     f'the mma route: {routes}, {launches[label]}')
            times = timed_step(trainer, example, loss_key='trainer',
                               variant='_bf16' if compute_dtype else '')
            masters_are_float32(trainer, f'phase 24 {label}')
            results[label] = {'losses': losses, 'times': times,
                              'trainer': trainer}
            print(f'phase 24 flagship step {label} B=16 T=500: '
                  + ', '.join(f'{k} {v:.3f} ms' for k, v in times.items())
                  + f'; launches in {steps} steps {launches[label]}')
        bf16, f32 = results['bf16']['losses'], results['f32']['losses']
        rel = [abs(x - y) / abs(y) for x, y in zip(bf16, f32)]
        print(f'phase 24 losses over {steps} steps, bf16: '
              f'{[round(x, 5) for x in bf16]}; f32: '
              f'{[round(x, 5) for x in f32]}; largest relative difference '
              f'{max(rel):.3%} (tol {FLAGSHIP_BF16_LOSS_RTOL:.0%})')
        if not (np.isfinite(bf16).all()
                and max(rel) <= FLAGSHIP_BF16_LOSS_RTOL):
            fail(f'the bf16 flagship step leaves the f32 trajectory: {rel}')
        if bf16[-1] >= bf16[0]:
            fail(f'the bf16 flagship step does not train: {bf16}')
        for name in ('fwd_train_bf16', 'bwd_bf16'):
            if launches['bf16'][name] == 0:
                fail(f'the bf16 flagship step never launched {name}')
        if launches['bf16']['fwd_train'] or launches['f32']['fwd_train_bf16']:
            fail(f'a step ran the other precision\'s kernels: {launches}')

        # the trained bf16 model serves requests: the lean bf16 forward
        model = results['bf16']['trainer'].model.eval()
        stft = HostSTFT(pit_data.STFT_SIZE, pit_data.STFT_SHIFT,
                        fading='full', complex_representation='complex')
        examples = list(pit_data.synthetic_database(num_examples=4, seed=2))
        reset_launches()
        latencies = []
        for example in examples:
            start = time.perf_counter()
            _, metrics = evaluate_example(model, stft, example)
            latencies.append((time.perf_counter() - start) * 1e3)
            if not np.isfinite(metrics['output_si_sdr']).all():
                fail(f'bad metrics from the bf16 model: {metrics}')
        served = dict(lstm_cell_scan.launches)
        served_routes = lstm_routes()
        print(f'phase 24 bf16 model served {len(examples)} requests, latency '
              f'ms {[round(x, 3) for x in latencies]}, launches {served}, '
              f'lean bf16 forwards by route {served_routes["fwd_bf16"]}')
        if served['fwd_bf16'] == 0:
            fail('the bf16 requests never launched the lean bf16 kernel')
        if served_routes['fwd_bf16']['mma'] != served['fwd_bf16']:
            fail(f'the bf16 requests\' lean forwards did not all take the '
                 f'mma route: {served_routes}')
        small = ragged_batch(2, 120)
        model_cpu = copy.deepcopy(model).cpu()
        with torch.no_grad():
            got = model({k: v.cuda() for k, v in small.items()}).cpu()
            want = model_cpu(small)
        err = float((got - want).abs().max())
        print(f'phase 24 bf16 model B=2 T=120, card vs CPU (plain bf16): max '
              f'|diff| {err:.3e} (tol {BF16_MODEL_TOL}), masks up to '
              f'{float(want.abs().max()):.3f}')
        if not err <= BF16_MODEL_TOL:
            fail(f'the bf16 model on the card disagrees with the CPU: {err}')
        del results, model, model_cpu
    torch.cuda.empty_cache()
    return {name: launches['bf16'][name] + served[name]
            for name in ('fwd_bf16', 'fwd_train_bf16', 'bwd_bf16')}


def phase_dprnn_bf16(profile=False):
    """Phase 25: the DPRNN-TasNet step under ``precision='bfloat16'`` (the
    recipe's full-width ``dprnn`` with BLSTM chunk RNNs, B=4 x 16000 samples
    as bench.py's ``bench_dprnn``) beside the float32 step from the same
    start.  Without ``compute_dtype`` the chunk LSTMs take bf16 inputs and
    run the float32 kernels, as the JAX package's route does."""
    batch = tasnet_batch(4, 16000, seed=1)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, precision in (('bf16', 'bfloat16'), ('f32', None)):
            torch.manual_seed(0)
            trainer = Trainer.from_config(tas_train.get_trainer_config(
                Path(tmp) / label, variant='dprnn',
                updates={'precision': precision})).to('cuda')
            example = trainer.model.example_to_device(batch, 'cuda')
            reset_launches()
            losses = losses_over(trainer, example, 3)
            launches = dict(lstm_cell_scan.launches)
            times = timed_step(trainer, example, loss_key='trainer',
                               per_step=12)
            masters_are_float32(trainer, f'phase 25 {label}')
            if profile:
                profile_step(trainer, example, f'phase 25 DPRNN {label}')
            results[label] = losses
            print(f'phase 25 DPRNN step {label} B=4 x 16000: '
                  + ', '.join(f'{k} {v:.3f} ms' for k, v in times.items())
                  + f'; losses {[round(x, 4) for x in losses]}; launches in '
                  f'3 steps {launches}')
            if launches['fwd_train'] != 36 or launches['bwd'] != 36 or any(
                    launches[k] for k in ('fwd_bf16', 'fwd_train_bf16',
                                          'bwd_bf16')):
                fail(f'the DPRNN {label} step launched {launches}')
            del trainer
        if not np.isfinite(results['bf16']).all():
            fail(f'the bf16 DPRNN step is not finite: {results}')
    torch.cuda.empty_cache()


# (label, B, H, Hkv, Tq, Tk, D, masks, timed); the first is the shape of
# the rows in the kernels' line, the fourth bench.py's headline
ATTENTION_BF16_CASES = [
    ('intra (264, 8, 100, 16)', 264, 8, 8, 100, 100, 16, {}, True),
    ('inter (400, 8, 66, 16) ragged', 400, 8, 8, 66, 66, 16,
     {'key_padding_lens': INTER_LENS}, True),
    ('(8, 12, 2048, 64) full', 8, 12, 12, 2048, 2048, 64, {}, True),
    ('bench (8, 12, 4096, 64) causal', 8, 12, 12, 4096, 4096, 64,
     {'causal': True}, True),
    ('bench (8, 12, 1024, 64) full', 8, 12, 12, 1024, 1024, 64, {}, True),
    ('bench (8, 12, 4096, 64) window (255, 256)', 8, 12, 12, 4096, 4096, 64,
     {'window': (255, 256)}, True),
    ('gqa (4, 8 over 2, 1024, 64) causal, ragged', 4, 8, 2, 1024, 1024, 64,
     {'causal': True, 'key_padding_lens': [1024, 777, 300, 1]}, True),
    ('D=128 (4, 8, 2048, 128) full', 4, 8, 8, 2048, 2048, 128, {}, True),
    ('D=256 (4, 8, 2048, 256) full', 4, 8, 8, 2048, 2048, 256, {}, True),
    ('D=32 (4, 8, 1000, 32) causal', 4, 8, 8, 1000, 1000, 32,
     {'causal': True}, True),
    ('D=128 (2, 8, 2048, 128) full', 2, 8, 8, 2048, 2048, 128, {}, False),
    ('D=128 gqa (2, 8 over 2, 130 x 77) ragged', 2, 8, 2, 130, 77, 128,
     {'key_padding_lens': [77, 50]}, False),
    ('a fully masked row (3, 4, 70, 64)', 3, 4, 4, 70, 70, 64,
     {'key_padding_lens': [70, 1, 0]}, False),
]


def by_batch(fn, tensors, masks):
    """``fn(*tensors, **masks)`` on slices of the batch, concatenated: the
    plain versions hold (B, H, Tq, Tk) float32 tensors, a few GB each at
    bench.py's shapes, so rows go a few at a time (about 2^28 logits)."""
    b, h, tq = tensors[0].shape[:3]
    tk = tensors[1].shape[2]
    rows = max(1, (1 << 28) // (h * tq * tk))
    lens = masks.get('key_padding_lens')
    lens = None if lens is None else np.asarray(lens)
    outs = []
    for i in range(0, b, rows):
        part = dict(masks)
        if lens is not None:
            part['key_padding_lens'] = lens[i:i + rows]
        outs.append(fn(*(x[i:i + rows] for x in tensors), **part))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def attention_bf16_fwd_plain(q, k, v, **masks):
    """The bf16 forward kernel's yardstick: plain in the kernel's tiles."""
    return flash_attention_fwd_plain(
        q, k, v, key_tile=attention_kernels.BF16_KEY_TILE, **masks)


def attention_bf16_control_fwd(q, k, v, *, causal=False,
                               key_padding_lens=None, window=None):
    """The forward's control: plain in the kernel's tiles, but with the
    logits rounded to bf16 (as a bf16 ``matmul`` returns them)."""
    b, h, tq, d = q.shape
    tk, group = k.shape[2], h // k.shape[1]
    k, v = (x.repeat_interleave(group, dim=1) for x in (k, v))
    lens = attention_kernels._lens_tensor(key_padding_lens, b, q.device)
    valid = visible_mask(tq, tk, lens, causal, window, q.device)
    s = torch.matmul(q, k.transpose(-1, -2)).float() / np.sqrt(d)
    s = torch.where(valid, s, s.new_tensor(-1e30))
    tile = attention_kernels.BF16_KEY_TILE
    m = s.new_full((b, h, tq, 1), -1e30)
    l = s.new_zeros((b, h, tq, 1))
    acc = s.new_zeros((b, h, tq, d))
    for j in range(0, tk, tile):
        m_new = torch.maximum(m, s[..., j:j + tile].max(-1, keepdim=True)
                              .values)
        p = torch.where(valid[..., j:j + tile],
                        torch.exp(s[..., j:j + tile] - m_new),
                        s.new_zeros(()))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.bfloat16().float(),
                                         v[..., j:j + tile, :].float())
        m = m_new
    return ((acc / l.clamp(min=1e-30)).bfloat16(),)


def attention_bf16_control_bwd(q, k, v, o, lse, d_o, *, causal=False,
                               key_padding_lens=None, window=None):
    """The backward's control: plain with P and dS rounded to bf16 as the
    operands of their products (another function than the JAX kernel's,
    which keeps both float32)."""
    b, h, tq, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    scale = 1.0 / np.sqrt(d)
    kf, vf = (x.float().repeat_interleave(h // h_kv, dim=1) for x in (k, v))
    lens = attention_kernels._lens_tensor(key_padding_lens, b, q.device)
    valid = visible_mask(tq, tk, lens, causal, window, q.device)
    dof = d_o.float()
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    p = torch.where(valid, torch.exp(torch.where(valid, s, s.new_tensor(
        -1e30)) - lse[..., None]), s.new_zeros(()))
    ds = (p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)).bfloat16()
    p = p.bfloat16().float()
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = torch.matmul(ds.float().transpose(-1, -2), q.float()) * scale
    dq = torch.matmul(ds.float(), kf) * scale
    if h_kv != h:
        dk = dk.reshape(b, h_kv, h // h_kv, tk, d).sum(dim=2)
        dv = dv.reshape(b, h_kv, h // h_kv, tk, d).sum(dim=2)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


# the bf16 backward kernels' digest on fixed inputs (dq, dk, dv from the
# plain forward's output and log-sum-exp, so the forward kernel does not
# enter), at phase 26's shapes; run in a checkout's root, so parent and
# change compare in one call (``python3 -c "import chip_smoke as c;
# print(c.attention_bf16_bwd_digests('<checkout>'))"``)
ATTENTION_BF16_DIGEST_CODE = r"""
import hashlib, json, sys
import numpy as np
import torch
from padertorch_tpu_torch.ops.kernels import attention as ak
out = {}
for label, b, h, h_kv, tq, tk, d, masks in json.loads(sys.argv[1]):
    rng = np.random.RandomState(d + tq)
    q, k, v, d_o = (torch.tensor(rng.randn(*shape), dtype=torch.float32,
                                 device='cuda').bfloat16()
                    for shape in ((b, h, tq, d), (b, h_kv, tk, d),
                                  (b, h_kv, tk, d), (b, h, tq, d)))
    window = masks.pop('window', None)
    lens = ak._lens_tensor(masks.get('key_padding_lens'), b, q.device)
    digest = hashlib.sha256()
    for i in range(b):
        part = dict(masks, window=window)
        if lens is not None:
            part['key_padding_lens'] = masks['key_padding_lens'][i:i + 1]
        with torch.no_grad():
            o, lse = ak.flash_attention_fwd_plain(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], **part)
            grads = ak._launch_bwd(
                q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
                v[i:i + 1].contiguous(),
                None if lens is None else lens[i:i + 1], d_o[i:i + 1].contiguous(),
                lse.contiguous(), (d_o[i:i + 1].float() * o.float()).sum(-1),
                masks.get('causal', False),
                *ak._norm_window(window), 1.0 / np.sqrt(d))
        for t in grads:
            digest.update(t.float().cpu().numpy().tobytes())
    out[label] = digest.hexdigest()[:16]
print(json.dumps(out))
"""
# (label, B, H, Hkv, Tq, Tk, D, masks) of the digests
ATTENTION_BF16_DIGEST_SHAPES = [
    ('intra (24, 8, 100, 16)', 24, 8, 8, 100, 100, 16, {}),
    ('inter (40, 8, 66, 16) ragged', 40, 8, 8, 66, 66, 16,
     {'key_padding_lens': [66, 55, 46, 36, 1, 0] * 6 + [66] * 4}),
    ('(2, 12, 2048, 64) causal', 2, 12, 12, 2048, 2048, 64,
     {'causal': True}),
    ('(1, 12, 2048, 64) window (255, 256)', 1, 12, 12, 2048, 2048, 64,
     {'window': [255, 256]}),
    ('gqa (4, 8 over 2, 1024, 64) causal, ragged', 4, 8, 2, 1024, 1024, 64,
     {'causal': True, 'key_padding_lens': [1024, 777, 300, 1]}),
    ('D=32 (2, 8, 1000, 32) causal', 2, 8, 8, 1000, 1000, 32,
     {'causal': True}),
    ('D=128 (2, 8, 2048, 128)', 2, 8, 8, 2048, 2048, 128, {}),
    ('D=256 (1, 8, 2048, 256)', 1, 8, 8, 2048, 2048, 256, {}),
]


def attention_bf16_bwd_digests(root):
    """{shape: digest} of the bf16 attention backward kernels of the
    checkout at ``root`` (see ATTENTION_BF16_DIGEST_CODE)."""
    proc = subprocess.run(
        [sys.executable, '-c', ATTENTION_BF16_DIGEST_CODE,
         json.dumps(ATTENTION_BF16_DIGEST_SHAPES)],
        cwd=root, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f'the bf16 attention backward digests of {root} failed:\n'
             f'{proc.stderr}')
    return json.loads(proc.stdout.strip().splitlines()[-1])


def attention_bf16_case(label, b, h, h_kv, tq, tk, d, masks, timed):
    """One shape of phase 26: the bf16 kernels against their plain bf16
    versions and the control, and (``timed``) their times beside the
    float32 kernels', plain's, the library's and the bounds.  Returns
    {'fwd': row, 'bwd': row} or None."""
    rng = np.random.RandomState(0)
    f32 = [torch.tensor(rng.randn(*shape), dtype=torch.float32,
                        device='cuda')
           for shape in ((b, h, tq, d), (b, h_kv, tk, d), (b, h_kv, tk, d),
                         (b, h, tq, d))]
    q, k, v, d_o = (x.bfloat16() for x in f32)
    lens = attention_kernels._lens_tensor(
        masks.get('key_padding_lens'), b, q.device)
    config = (masks.get('causal', False),
              *attention_kernels._norm_window(masks.get('window')),
              1.0 / np.sqrt(d))

    def kernel_bwd(o, lse):
        delta = (d_o.float() * o.float()).sum(-1)
        return attention_kernels._launch_bwd(q, k, v, lens, d_o, lse, delta,
                                             *config)

    with torch.no_grad():
        lean = flash_attention(q, k, v, **masks)
        o, lse = attention_kernels._launch_fwd(q, k, v, lens, *config,
                                               train=True)
        grads = kernel_bwd(o, lse)
        same = (torch.equal(lean, o) and all(
            torch.equal(x, y) for x, y in zip(grads, kernel_bwd(o, lse))))
        want, want_lse = by_batch(attention_bf16_fwd_plain, (q, k, v),
                                  masks)
        want_grads = by_batch(flash_attention_bwd_plain,
                              (q, k, v, o, lse, d_o), masks)
        control, = by_batch(attention_bf16_control_fwd, (q, k, v), masks)
        control_grads = by_batch(attention_bf16_control_bwd,
                                 (q, k, v, o, lse, d_o), masks)
    # the autograd Function: the same kernels, the same bits
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, **masks)
    auto = torch.autograd.grad(out, leaves, d_o, retain_graph=timed)
    torch.cuda.synchronize()
    same = same and torch.equal(out, o) and all(
        torch.equal(x, y) for x, y in zip(auto, grads))
    excess, share = bf16_distance([o], [want], ATTENTION_BF16_FWD_ATOL)
    lse_err = lse_distance(lse, want_lse)
    grad_excess, grad_share = bf16_grad_distance(grads, want_grads)
    _, control_share = bf16_distance([control], [want],
                                     ATTENTION_BF16_FWD_ATOL)
    _, control_grad_share = bf16_grad_distance(control_grads, want_grads)
    print(f'phase 26 attention bf16 {label}: O '
          f'{excess + ATTENTION_BF16_FWD_ATOL:.3e} beyond one bf16 ulp (tol {ATTENTION_BF16_FWD_ATOL}), {share:.3%} '
          f'differ (tol {ATTENTION_BF16_FWD_SHARE:.0%}; control, logits '
          f'rounded to bf16, {control_share:.3%}); LSE {lse_err:.3e} of '
          f'max(|lse|, 1) (tol {ATTENTION_BF16_LSE_TOL}); dq, dk, dv '
          f'beyond one ulp plus {ATTENTION_BF16_GRAD_RTOL} of each one\'s '
          f'largest entry by {grad_excess:.3e} (passes at <= 0), '
          f'{grad_share:.3%} differ by more (tol {ATTENTION_BF16_GRAD_SHARE:.0%}; control, P and dS rounded '
          f'to bf16, {control_grad_share:.3%}); lean = training forward, '
          f'autograd = kernels, two runs: the same bits {same}')
    if not (excess <= 0 and share <= ATTENTION_BF16_FWD_SHARE
            and lse_err <= ATTENTION_BF16_LSE_TOL):
        fail(f'bf16 attention forward kernel disagrees with plain at '
             f'{label}: {excess}, {share}, {lse_err}')
    if not (grad_excess <= 0 and grad_share <= ATTENTION_BF16_GRAD_SHARE):
        fail(f'bf16 attention backward kernels disagree with plain at '
             f'{label}: {grad_excess}, {grad_share}')
    if not (control_share > ATTENTION_BF16_FWD_SHARE
            and control_grad_share > ATTENTION_BF16_GRAD_SHARE):
        fail(f'the limits do not tell bf16-rounded logits, P or dS from the '
             f'kernels\' arithmetic at {label}: {control_share}, '
             f'{control_grad_share}')
    if not same:
        fail(f'two bf16 attention runs, or the lean and training forwards, '
             f'or the Function and the kernels, differ at {label}')
    if lens is not None:
        for row in torch.nonzero(lens == 0)[:, 0].tolist():
            if any(float(x[row].abs().max()) != 0.0 for x in (o, *grads)):
                fail(f'{label}: row {row} has no key but a nonzero output '
                     f'or gradient')
    if not timed:
        return None

    q32, k32, v32, d_o32 = f32
    leaves32 = [x.clone().requires_grad_() for x in (q32, k32, v32)]
    out32 = flash_attention(*leaves32, **masks)
    with torch.no_grad():
        times = {
            'fwd': cuda_ms(lambda: flash_attention(q, k, v, **masks),
                           iters=10),
            'fwd_f32': cuda_ms(lambda: flash_attention(q32, k32, v32,
                                                       **masks), iters=10),
            'fwd_plain': cuda_ms(lambda: by_batch(
                attention_bf16_fwd_plain, (q, k, v), masks), iters=2)}
        times['bwd_plain'] = cuda_ms(lambda: by_batch(
            flash_attention_bwd_plain, (q, k, v, o, lse, d_o), masks),
            iters=2)
    torch.cuda.empty_cache()
    times['bwd'], _ = cuda_ms_median(
        lambda: torch.autograd.grad(out, leaves, d_o, retain_graph=True),
        iters=10)
    times['bwd_f32'], _ = cuda_ms_median(
        lambda: torch.autograd.grad(out32, leaves32, d_o32,
                                    retain_graph=True), iters=10)
    del out32, leaves32
    times['fwd_library'], times['bwd_library'] = attention_library(
        q, k, v, d_o, masks)
    # the work these inputs need: per visible (query, key) pair two bf16
    # products of D in the forward; in the backward two bf16 (S, dP) and
    # dV, dK, dQ on float32 P and dS, which the kernel takes as three bf16
    # products each (its bound, every product at the bf16 rate); beside it
    # the bound of the 2xTF32 design of PR 14's kernel, kept so the two
    # can be compared (``bound_2xtf32_ms``)
    visible = visible_mask(tq, tk, lens, masks.get('causal', False),
                           masks.get('window'), q.device)
    pairs = float(visible.sum()) * h * (b // visible.shape[0])
    bwd_bytes = nbytes(q, k, v, lens, o, lse, d_o, *grads)
    limits = {
        'fwd': bound_mixed(nbytes(q, k, v, lens, o),
                           [(4 * pairs * d, PEAK_BF16_FLOPS)]),
        'bwd': bound_mixed(bwd_bytes, [(22 * pairs * d, PEAK_BF16_FLOPS)])}
    limits['bwd']['bound_2xtf32_ms'] = bound_mixed(
        bwd_bytes, [(4 * pairs * d, PEAK_BF16_FLOPS),
                    (6 * pairs * d, PEAK_2XTF32_FLOPS)])['bound_ms']
    for name in ('fwd', 'bwd'):
        print(f'phase 26 attention bf16 {name} {label}: kernel '
              f'{times[name]:.3f} ms (the float32 kernel'
              f'{"s" if name == "bwd" else ""} {times[name + "_f32"]:.3f} '
              f'ms{", delta included" if name == "bwd" else ""}), plain '
              f'{times[name + "_plain"]:.3f} ms, scaled_dot_product_attention'
              f' bf16 {times[name + "_library"]:.3f} ms, bound '
              f'{limits[name]["bound_ms"]:.4f} ms by '
              f'{limits[name]["bound_by"]} at the {limits[name]["peak"]} '
              f'peak (the kernel at '
              f'{limits[name]["bound_ms"] / times[name]:.1%} of it)')
    return {
        'fwd': {'max_abs_err': max_err([o.float()], [want.float()]),
                'share_differing': share,
                'control_share': control_share, 'ms': times['fwd'],
                'f32_kernel_ms': times['fwd_f32'],
                'plain_ms': times['fwd_plain'], **limits['fwd'],
                'library_ms': times['fwd_library']},
        'bwd': {'max_abs_err': max_err([x.float() for x in grads],
                                       [x.float() for x in want_grads]),
                'share_differing': grad_share,
                'control_share': control_grad_share, 'ms': times['bwd'],
                'f32_kernel_ms': times['bwd_f32'],
                'plain_ms': times['bwd_plain'], **limits['bwd'],
                'library_ms': times['bwd_library']}}


def attention_bf16_train_headline():
    """bench.py's ``flash_attention_causal_train_ms`` on the port: forward
    + backward at (8, 12, 4096, 64) causal bf16 (the gradient of the
    output's sum, as bench.py takes it), beside the port's dense bf16 path
    (``dense_attention``, float32 logits) and the library."""
    rng = np.random.RandomState(0)
    leaves = [torch.tensor(rng.randn(8, 12, 4096, 64), device='cuda').to(
        torch.bfloat16).requires_grad_() for _ in range(3)]

    def train(fn):
        out = fn(*leaves)
        return torch.autograd.grad(out.float().sum(), leaves)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = {}
    for name, fn in (
            ('kernels', lambda q, k, v: flash_attention(q, k, v,
                                                        causal=True)),
            ('dense', lambda q, k, v: dense_attention(q, k, v, causal=True)),
            ('scaled_dot_product_attention',
             lambda q, k, v: sdpa(q, k, v, is_causal=True))):
        ms[name] = cuda_ms(lambda: train(fn), iters=3)
        torch.cuda.empty_cache()
    print('phase 26 flash_attention_causal_train_ms (bench.py) at (8, 12, '
          '4096, 64) causal bf16, forward + backward: '
          + ', '.join(f'{k} {v:.3f} ms' for k, v in ms.items()))
    return ms


def phase_attention_bf16():
    """Phase 26: the bf16 attention kernels at ATTENTION_BF16_CASES, then
    bench.py's headline.  Returns ({label: rows}, headline ms)."""
    start = time.perf_counter()
    results = {}
    for label, *shape, masks, timed in ATTENTION_BF16_CASES:
        rows = attention_bf16_case(label, *shape, masks, timed)
        torch.cuda.empty_cache()
        if rows is not None:
            results[label] = rows
    headline = attention_bf16_train_headline()
    digests = attention_bf16_bwd_digests(Path(__file__).resolve().parent)
    print(f'phase 26 bf16 attention backward kernels\' digests (dq, dk, dv '
          f'on fixed inputs): {json.dumps(digests)}')
    print(f'phase 26 took {time.perf_counter() - start:.1f} s')
    return results, headline


def phase_attention_bf16_bwd(results):
    """Phase 32: the bf16 backward (``csrc/flash_attention_bwd_bf16.cu``,
    `wgmma` from TMA tiles, P and dS in three bf16 pieces) at phase 26's
    timed shapes: its time (``delta`` included), its share of its bound
    (every product at the bf16 rate, dV, dK and dQ as three bf16 products
    each, as the kernel computes them) and of the 2xTF32 design's (S and
    dP at the bf16 rate, dV, dK, dQ at 2xTF32's), SDPA's backward in
    bf16, the control's share (P and dS
    rounded to bf16) and two runs' bits, which phase 26 checked."""
    for label, rows in results.items():
        row = rows['bwd']
        print(f'phase 32 bf16 attention backward {label}: '
              f'{row["ms"]:.3f} ms, {row["bound_ms"] / row["ms"]:.1%} of '
              f'the bound {row["bound_ms"]:.4f} ms (every product at the '
              f'bf16 rate, dV, dK, dQ three pieces each), '
              f'{row["bound_2xtf32_ms"] / row["ms"]:.1%} of the 2xTF32 '
              f'design\'s bound {row["bound_2xtf32_ms"]:.4f} ms (S, dP '
              f'bf16; dV, dK, dQ 2xTF32); '
              f'scaled_dot_product_attention bf16 {row["library_ms"]:.3f} '
              f'ms ({row["ms"] / row["library_ms"]:.2f} times); control '
              f'(P, dS rounded to bf16) {row["control_share"]:.3%} differ; '
              f'the float32 kernels {row["f32_kernel_ms"]:.3f} ms')


def phase_sepformer_bf16(profile=False):
    """Phase 27: the SepFormer-TasNet step under ``precision='bfloat16'``
    with the fused backend (``--flash``), beside the dense bf16 backend and
    the float32 fused step from the same start.  Returns the bf16 kernels'
    launches of the 20 steps of the fused bf16 run."""
    start = time.perf_counter()
    steps = 20
    batch = tasnet_batch(4, 16000, seed=1)
    results, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, precision, fused in (('bf16 fused', 'bfloat16', True),
                                        ('bf16 dense', 'bfloat16', False),
                                        ('f32 fused', None, True)):
            torch.manual_seed(0)
            trainer = Trainer.from_config(tas_train.get_trainer_config(
                Path(tmp) / label.replace(' ', '_'), variant='sepformer',
                updates={'precision': precision})).to('cuda')
            if sepformer_width(trainer.model) != SEPFORMER_WIDTH:
                fail(f'not the full-width SepFormer-TasNet: '
                     f'{sepformer_width(trainer.model)}')
            set_attention_backend(trainer.model, fused)
            example = trainer.model.example_to_device(batch, 'cuda')
            reset_launches()
            losses = losses_over(trainer, example, steps)
            launches[label] = dict(flash_attention.launches)
            variant = '_bf16' if precision else ''
            want = with_zeros(launches[label], {
                'fwd_train' + variant: 16 * steps * fused,
                'bwd' + variant: 16 * steps * fused})
            if launches[label] != want:
                fail(f'phase 27 {label}: launches {launches[label]}, '
                     f'expected {want}')
            times = {samples: timed_step(
                trainer, tasnet_batch(4, samples, seed=1),
                loss_key='trainer', wrapper=flash_attention,
                per_step=16 * fused, variant=variant)
                for samples in (16000, 32000)}
            masters_are_float32(trainer, f'phase 27 {label}')
            if profile:
                profile_step(trainer, batch, f'phase 27 SepFormer {label}')
            results[label] = losses
            for samples, t in times.items():
                print(f'phase 27 SepFormer step {label} B=4 x {samples}: '
                      + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items()))
            del trainer
        diff = {other: max(abs(x - y) for x, y in zip(
            results['bf16 fused'], results[other]))
            for other in ('bf16 dense', 'f32 fused')}
        print(f'phase 27 losses over {steps} steps at B=4 x 16000: '
              + '; '.join(f'{k} {[round(x, 4) for x in v]}'
                          for k, v in results.items())
              + '; bf16 fused against '
              + ', '.join(f'{k} {v:.4f}' for k, v in diff.items())
              + f' largest difference; launches of the bf16 fused '
              f'run {launches["bf16 fused"]}; '
              f'{time.perf_counter() - start:.1f} s')
        bf16 = results['bf16 fused']
        if not (np.isfinite(bf16).all() and bf16[-1] < bf16[0]):
            fail(f'the bf16 SepFormer step on the kernels does not train: '
                 f'{bf16}')
    torch.cuda.empty_cache()
    return launches['bf16 fused']


# phase 28: the bf16 GRU kernels against their plain bf16 versions at
# phase 23's limits (LSTM_BF16_SHARE, LSTM_BF16_STATE_TOL,
# LSTM_BF16_STREAM_TOL): the float32 states (h_T; dh0) within 3e-4 and
# 1e-3, every stream element (out; acts, gh_n, h_prev; dgx, dgh) within one
# bf16 unit in the last place plus 1e-3 (2e-3 in the backward), at most 5%
# of them other than plain's; the plain version with float32 products on
# the same bf16 streams must exceed the share.  (label, T, rows per
# direction, H, mask kind, directions, the layer's input width for the
# cuDNN yardstick); the first is the shape of the kernels line's rows, the
# first five the shapes the recipes launch.  GRU_BF16_LIMIT_SHAPES adds the
# resident routes' widest H on this card and one above, found from the
# planners at run time.
GRU_BF16_SHAPES = [
    ('intra T=100 D*B=520 H=128', 100, 260, 128, None, 2, 64),
    ('inter T=65 D*B=800 H=128', 65, 400, 128, 'chunks', 2, 64),
    ('T=500 D*B=32 H=600', 500, 16, 600, 'ragged', 2, 1200),
    ('classifier recipe T=66 D*B=8 H=64 one direction', 66, 8, 64,
     'ragged', 1, 512),
    ('classifier defaults T=503 D*B=16 H=256 one direction', 503, 16, 256,
     'ragged', 1, 1024),
    ('H=12 T=40 D*B=6 prefix', 40, 3, 12, 'prefix', 2, 24),
    ('H=100 T=40 D*B=5 one direction', 40, 5, 100, 'ragged', 1, 200),
    ('served intra T=100 D*B=66 H=128', 100, 33, 128, None, 2, 64),
    ('served inter T=33 D*B=200 H=128', 33, 100, 128, 'chunks', 2, 64),
]
GRU_BF16_TIMED = 5          # the first five shapes are timed


def gru_bf16_limit_shapes():
    """The shapes at the bf16 resident routes' widest H on this card and
    one above (forwards and backward; both directions; the forward's limit
    under prefix padding), then at the ``mma`` route's widest H and one
    above (the lean forward's cluster route's narrowest), at H = 160 and
    at the cluster route's widest H and one above, with the limits."""
    limits = gru_kernels.device_limits(torch.cuda.current_device())

    def widest(plan, **kwargs):
        return max(h for h in range(1, 512)
                   if plan(1, 1, h, *limits, **kwargs) is not None)

    fwd, bwd = (widest(gru_kernels.resident_plan, elem=2),
                widest(gru_kernels.resident_bwd_plan, elem=2))
    mma = min(widest(functools.partial(gru_kernels.mma_plan, kernel))
              for kernel in ('fwd_train', 'bwd'))
    reach = max(h for h in range(1, 512)
                if gru_kernels.cluster_shape(h, limits[1]) is not None)
    shapes = [(f'H={fwd} T=30 D*B=8 prefix (the widest resident forward)',
               30, 4, fwd, 'prefix', 2, 2 * fwd),
              (f'H={fwd + 1} T=30 D*B=3 one direction', 30, 3, fwd + 1,
               'ragged', 1, 2 * fwd),
              (f'H={bwd} T=30 D*B=10 (the widest resident backward)', 30, 5,
               bwd, 'ragged', 2, 2 * bwd),
              (f'H={bwd + 1} T=30 D*B=10', 30, 5, bwd + 1, 'ragged', 2,
               2 * bwd),
              (f'H={mma} T=30 D*B=18 (the widest mma training forward and '
               f'backward)', 30, 9, mma, 'ragged', 2, 2 * mma),
              (f'H={mma + 1} T=30 D*B=18 (the narrowest lean cluster)', 30,
               9, mma + 1, 'ragged', 2, 2 * mma),
              ('H=160 T=60 D*B=16 one direction', 60, 16, 160, 'ragged', 1,
               320),
              (f'H={reach} T=30 D*B=18 (the widest lean cluster)', 30, 9,
               reach, 'ragged', 2, 2 * reach),
              (f'H={reach + 1} T=30 D*B=3 one direction', 30, 3, reach + 1,
               'ragged', 1, 2 * reach)]
    return shapes, {'fwd': fwd, 'bwd': bwd, 'mma': mma, 'cluster': reach}


def gru_bf16_case(label, t_len, batch, hdim, kind, n_dir, in_size, timed):
    """The three bf16 GRU kernels at one shape: agreement with plain, the
    control, the routes (``kernel_route``; on the ``mma`` route the card's
    plan equal to the mirror ``gru.mma_plan``, the lean forward's there
    the training forward's; on the lean forward's ``cluster`` route the
    card's plan the mirror ``gru.cluster_plan``'s at the card's count of
    co-resident clusters), the lean forward's ``out`` and ``h_T`` bit for
    bit the training forward's where both take ``mma``, the same bits
    twice; timed beside the float32 kernels, plain, cuDNN in bf16 and the
    bound."""
    args, cot = recurrence_inputs(t_len, batch, hdim, kind, gates=3,
                                  directions=n_dir)
    gx, w, mask, h0 = args
    gx16, d_out16, dh = gx.to(torch.bfloat16), cot[0].to(torch.bfloat16), \
        cot[1]
    args16 = (gx16, w, mask, h0)
    valid = t_len * n_dir * batch if mask is None else float(mask.sum())
    flops = gru_flops(valid, hdim)
    device = torch.cuda.current_device()
    limits = gru_kernels.device_limits(device)
    route = {name: gru_kernels.kernel_route(name, n_dir, batch, hdim, True,
                                            *limits) or 'cooperative'
             for name in ('fwd', 'fwd_train', 'bwd')}
    plans = {}
    for name in ('fwd', 'fwd_train', 'bwd'):
        if route[name] == 'mma':
            # one forward plan
            plan_kernel = 'fwd_train' if name == 'fwd' else name
            plans[name] = gru_kernels.mma_plan(plan_kernel, n_dir, batch,
                                               hdim, *limits)
            card = gru_kernels.device_mma_plan(plan_kernel, n_dir, batch,
                                               hdim, device)
        elif route[name] == 'cluster':
            card, clusters = gru_kernels.device_cluster_plan(
                n_dir, batch, hdim, device)
            plans[name] = gru_kernels.cluster_plan(n_dir, batch, hdim,
                                                   limits[1], clusters)
        else:
            continue
        if card != plans[name]:
            fail(f'gru bf16 {name} at {label}: the card\'s {route[name]} '
                 f'plan {card} is not the mirror\'s {plans[name]}')

    def fwd():
        return gru_cell_scan(*args16, compute_dtype='bfloat16')

    def fwd_train():
        return gru_kernels._launch(gx16, w, n_dir, mask, h0, train=True)

    want_train = gru_cell_scan_train_plain(*args16, 'bfloat16')
    _, acts, gh_n, h_prev, _ = want_train
    bwd_in = (acts, gh_n, h_prev, w, mask, d_out16, dh)

    def bwd():
        return gru_kernels._launch_bwd(acts, gh_n, h_prev, w, n_dir, mask,
                                       d_out16, dh)

    reset_launches()
    got = {'fwd': fwd(), 'fwd_train': fwd_train(), 'bwd': bwd()}
    again = {'fwd': fwd(), 'fwd_train': fwd_train(), 'bwd': bwd()}
    torch.cuda.synchronize()
    launched = dict(gru_cell_scan.launches)
    routed = {name: dict(gru_cell_scan.routes[name + '_bf16'])
              for name in route}
    want_routed = {name: {**dict.fromkeys(routed[name], 0), route[name]: 2}
                   for name in route}
    if launched != with_zeros(launched, {'fwd_bf16': 2, 'fwd_train_bf16': 2,
                                         'bwd_bf16': 2}) \
            or routed != want_routed:
        fail(f'gru bf16 at {label}: launches {launched}, routes {routed}, '
             f'expected {want_routed}')
    for name in route:
        if not all(torch.equal(a, b) for a, b in zip(got[name], again[name])):
            fail(f'two bf16 gru {name} runs at {label} differ')
    del again
    if route['fwd'] == route['fwd_train'] == 'mma':
        # one route, one arithmetic: the lean forward's out and h_T are the
        # training forward's
        lean, train = got['fwd'], got['fwd_train']
        if not (torch.equal(lean[0], train[0])
                and torch.equal(lean[1], train[4])):
            fail(f'gru bf16 at {label}: the lean forward\'s out or h_T on '
                 f'mma differ from the training forward\'s')
        print(f'phase 28 gru bf16 {label}: the lean forward\'s out and h_T '
              f'on mma equal the training forward\'s bit for bit')
    want = {'fwd': gru_cell_scan_plain(*args16, 'bfloat16'),
            'fwd_train': want_train,
            'bwd': gru_cell_scan_bwd_plain(*bwd_in, 'bfloat16')}
    control = {'fwd': gru_cell_scan_plain(*args16),
               'fwd_train': gru_cell_scan_train_plain(*args16),
               'bwd': gru_cell_scan_bwd_plain(*bwd_in)}
    torch.cuda.synchronize()
    streams = {'fwd': 1, 'fwd_train': 4, 'bwd': 2}
    if timed:
        # the float32 kernels at the same shape, on float32 inputs
        f32_train = gru_kernels._launch(gx, w, n_dir, mask, h0, train=True)
        f32 = {'fwd': lambda: gru_cell_scan(*args),
               'fwd_train': lambda: gru_kernels._launch(
                   gx, w, n_dir, mask, h0, train=True),
               'bwd': lambda: gru_kernels._launch_bwd(
                   *f32_train[1:4], w, n_dir, mask, *cot)}
        plain = {'fwd': lambda: gru_cell_scan_plain(*args16, 'bfloat16'),
                 'fwd_train': lambda: gru_cell_scan_train_plain(
                     *args16, 'bfloat16'),
                 'bwd': lambda: gru_cell_scan_bwd_plain(*bwd_in,
                                                        'bfloat16')}
        kernel = {'fwd': fwd, 'fwd_train': fwd_train, 'bwd': bwd}
        library = cudnn_layer_ms(torch.nn.GRU, t_len, batch, in_size, hdim,
                                 n_dir, dtype=torch.bfloat16)
        inputs = {'fwd': args16, 'fwd_train': args16, 'bwd': bwd_in}
    rows = {}
    for name in ('fwd', 'fwd_train', 'bwd'):
        n = streams[name]
        tol, stream_tol = (LSTM_BF16_STATE_TOL[name],
                           LSTM_BF16_STREAM_TOL[name])
        excess, share = bf16_distance(got[name][:n], want[name][:n],
                                      stream_tol)
        state_err = max_err(got[name][n:], want[name][n:])
        _, control_share = bf16_distance(control[name][:n], want[name][:n],
                                         stream_tol)
        control_state = max_err(control[name][n:], want[name][n:])
        shown = (f'phase 28 gru bf16 {name} {label} ({route[name]} '
                 f'route): states max |kernel - plain| {state_err:.3e} (tol '
                 f'{tol}; plain with float32 products {control_state:.3e}); '
                 f'streams {excess + stream_tol:.3e} beyond one bf16 ulp '
                 f'(tol {stream_tol}), {share:.3%} of them differ (tol '
                 f'{LSTM_BF16_SHARE:.0%}; plain with float32 products '
                 f'{control_share:.3%})')
        row = {'shape': label, 'max_abs_err': max_err(got[name],
                                                      want[name]),
               'share_differing': share, 'state_err': state_err,
               'control_share': control_share, 'gru_route': route[name]}
        if name in plans:
            row[f'{route[name]}_plan'] = plans[name]._asdict()
            shown += (f'; plan {plans[name]._asdict()} (the card\'s, the '
                      f'mirror\'s)')
        if timed:
            ms = cuda_ms(kernel[name], iters=10)
            f32_ms = cuda_ms(f32[name], iters=10)
            plain_ms = cuda_ms(plain[name], iters=2)
            limit = bound(nbytes(*inputs[name], *got[name]), flops,
                          peak=PEAK_BF16_FLOPS)
            shown += (f'; kernel {ms:.3f} ms, the float32 kernel '
                      f'{f32_ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN bf16 '
                      f'nn.GRU layer {library[name]:.3f} ms, bound '
                      f'{limit["bound_ms"]:.4f} ms by {limit["bound_by"]}')
            row.update(ms=ms, f32_kernel_ms=f32_ms, plain_ms=plain_ms,
                       **limit, library_ms=library[name])
        print(shown)
        if not (excess <= 0 and share <= LSTM_BF16_SHARE
                and state_err <= tol):
            fail(f'gru bf16 {name} kernel disagrees with plain at {label}: '
                 f'streams {excess} beyond the limit, {share} of them '
                 f'differ, states {state_err}')
        if not control_share > LSTM_BF16_SHARE:
            fail(f'the limit does not tell bf16 products from float32 at '
                 f'{label} ({name}): {control_share}')
        rows[name] = row
    return rows


# the float32 GRU kernels' outputs on fixed inputs, at phase 8's five
# shapes and phase 31's 2 x 2048 layer: lean forward, training forward and
# backward; beside them the lean bf16 forward's (' bf16 lean') and the bf16
# training forward's and backward's (' bf16 training'); run in a process of
# its own from a checkout's root, so that two checkouts' kernels can be
# compared (``python3 -c "import chip_smoke as c;
# print(c.gru_f32_digests('<checkout>'))"``)
GRU_DIGEST_CODE = r"""
import hashlib, json, sys
import numpy as np
import torch
from padertorch_tpu_torch.ops.kernels import gru
out = {}
def raw(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16
            else t).cpu().numpy().tobytes()
for label, t_len, batch, hdim, n_dir in json.loads(sys.argv[1]):
    rng = np.random.RandomState(hdim + t_len)
    lens = rng.randint(t_len // 2, t_len + 1, size=batch)
    fwd = np.arange(t_len)[:, None] < lens[None, :]
    mask = np.concatenate([fwd, fwd[::-1]][:n_dir], axis=1)
    rows = n_dir * batch
    put = lambda a: torch.from_numpy(a.astype('float32')).cuda()
    gx = put(rng.uniform(-1, 1, (t_len, rows, 3 * hdim)))
    w = put(rng.uniform(-1, 1, (n_dir, hdim, 3 * hdim)) / np.sqrt(hdim))
    h0 = put(rng.uniform(-0.1, 0.1, (rows, hdim)))
    d_out = put(rng.uniform(-1, 1, (t_len, rows, hdim)))
    dh = put(rng.uniform(-1, 1, (rows, hdim)))
    digest, lean16, train16 = (hashlib.sha256() for _ in range(3))
    for m in (None, put(mask)):
        lean = gru.gru_cell_scan(gx, w, m, h0)
        train = gru._launch(gx, w, n_dir, m, h0, train=True)
        bwd = gru._launch_bwd(*train[1:4], w, n_dir, m, d_out, dh)
        for t in (*lean, *train, *bwd):
            digest.update(raw(t))
        gx16 = gx.bfloat16()
        lean = gru.gru_cell_scan(gx16, w, m, h0, compute_dtype='bfloat16')
        for t in lean:
            lean16.update(raw(t))
        train = gru._launch(gx16, w, n_dir, m, h0, train=True)
        bwd = gru._launch_bwd(*train[1:4], w, n_dir, m, d_out.bfloat16(),
                              dh)
        for t in (*train, *bwd):
            train16.update(raw(t))
    out[label] = digest.hexdigest()[:16]
    out[label + ' bf16 lean'] = lean16.hexdigest()[:16]
    out[label + ' bf16 training'] = train16.hexdigest()[:16]
print(json.dumps(out))
"""


def gru_f32_digests(root):
    """{shape: digest} of the float32 GRU kernels of the checkout at
    ``root``, and of its lean bf16 forward and its bf16 training forward
    and backward (see GRU_DIGEST_CODE)."""
    shapes = [(label, t_len, batch, hdim, 2)
              for label, t_len, batch, hdim, _ in RECURRENCE_SHAPES]
    shapes += [(label, t_len, batch, hdim, 1)
               for label, t_len, batch, hdim, _, _ in CLASSIFIER_GRU_SHAPES]
    shapes += [(label, t_len, batch, hdim, 2)
               for label, kind, t_len, batch, hdim, bf16, _
               in WIDE_RECURRENCES if kind == 'gru' and bf16]
    proc = subprocess.run(
        [sys.executable, '-c', GRU_DIGEST_CODE, json.dumps(shapes)],
        cwd=root, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f'the GRU digests of {root} failed:\n{proc.stderr}')
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_gru_bf16_kernels():
    """Phase 28: the three bf16 GRU kernels at GRU_BF16_SHAPES and at the
    resident routes' limits; the float32 GRU kernels' digests.  Returns
    {label: {kernel: row}}."""
    start = time.perf_counter()
    limit_shapes, widest = gru_bf16_limit_shapes()
    print(f'phase 28 the bf16 resident routes on this card reach H = '
          f'{widest["fwd"]} (forwards) and H = {widest["bwd"]} (backward); '
          f'the mma route of the three kernels H = {widest["mma"]} '
          f'(GRU_MMA_MAX_H); the lean forward\'s cluster route H = '
          f'{gru_kernels.GRU_CLUSTER_MIN_H} to {widest["cluster"]}')
    rows = {}
    for i, shape in enumerate(GRU_BF16_SHAPES + limit_shapes):
        rows[shape[0]] = gru_bf16_case(*shape, timed=i < GRU_BF16_TIMED)
        torch.cuda.empty_cache()
    digests = gru_f32_digests(Path(__file__).resolve().parent)
    print(f'phase 28 GRU kernels\' digests (float32: lean, training '
          f'forward, backward; bf16 lean; bf16 training forward and '
          f'backward; unmasked and ragged): {json.dumps(digests)}; '
          f'{time.perf_counter() - start:.1f} s')
    return rows


# the bf16 GRU kernels' launches on the main paths (phases 29 and 30) by
# route, added up where bf16_gru_launches reads their counts
GRU_BF16_MAIN_ROUTES = {name: dict.fromkeys(gru_cell_scan.routes[name], 0)
                        for name in ('fwd_bf16', 'fwd_train_bf16',
                                     'bwd_bf16')}


def bf16_gru_launches():
    """The bf16 GRU kernels' launches since the counts were last reset (a
    main path's); their routes are added to GRU_BF16_MAIN_ROUTES."""
    for name, routes in GRU_BF16_MAIN_ROUTES.items():
        for route, n in gru_cell_scan.routes[name].items():
            routes[route] += n
    return {k: gru_cell_scan.launches[k] for k in GRU_BF16_MAIN_ROUTES}


# phase 29's three runs of the bgru DPRNN-TasNet from one start: (label,
# the trainer's precision, the GRUs' compute_dtype); the first is the
# contract this slice ports
DPRNN_BGRU_RUNS = [('bf16 GRUs', 'bfloat16', 'bfloat16'),
                   ('policy alone', 'bfloat16', None),
                   ('f32', None, None)]


def phase_dprnn_bgru_bf16():
    """Phase 29: the recipe's full-width ``dprnn`` with ``bgru`` chunk RNNs
    under ``precision='bfloat16'`` after ``set_rnn_backend(trainer.model,
    'pallas', compute_dtype='bfloat16')``, beside the policy alone (the
    float32 GRU kernels on bf16 inputs) and float32, from one start: 20
    steps' losses at B=4 x 16000 (bench.py's ``bench_dprnn``), the first 3
    steps' launches (the bf16 training forwards and backwards on the mma
    route), timed steps at 4 x 16000 and 4 x 32000 and the card's busy time
    a step at 4 x 16000 (``torch.profiler``); then 4 requests through the
    tasnet recipe's ``evaluate_example`` on the lean bf16 forward.  Returns
    the bf16 kernels' launches of the bf16 run."""
    start = time.perf_counter()
    steps = 20
    batch = tasnet_batch(4, 16000, seed=1)
    results, main = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, precision, compute_dtype in DPRNN_BGRU_RUNS:
            torch.manual_seed(0)
            trainer = Trainer.from_config(tas_train.get_trainer_config(
                Path(tmp) / label.replace(' ', '_'), variant='dprnn',
                updates=tasnet_updates('bgru', {'precision': precision}))
            ).to('cuda')
            if compute_dtype:
                set_rnn_backend(trainer.model, 'pallas',
                                compute_dtype=compute_dtype)
            example = trainer.model.example_to_device(batch, 'cuda')
            reset_launches()
            losses = losses_over(trainer, example, 3)
            launches = dict(gru_cell_scan.launches)
            # the bf16 training forward and backward on the mma route
            routes = check_gru_routes(f'phase 29 {label}', 'resident',
                                      fwd_train_bf16='mma', bwd_bf16='mma')
            variant = '_bf16' if compute_dtype else ''
            want = with_zeros(launches, {'fwd_train' + variant: 36,
                                         'bwd' + variant: 36})
            if launches != want:
                fail(f'phase 29 {label}: 3 steps launched {launches}, '
                     f'expected {want}')
            losses += losses_over(trainer, example, steps - 3)
            if compute_dtype:
                main = bf16_gru_launches()
            times = {}
            for samples in (16000, 32000):
                # timed_step counts its timed steps' launches from zero
                times[samples] = timed_step(
                    trainer, tasnet_batch(4, samples, seed=1),
                    loss_key='trainer', wrapper=gru_cell_scan, per_step=12,
                    variant=variant)
                if compute_dtype:
                    for name, n in bf16_gru_launches().items():
                        main[name] += n
            masters_are_float32(trainer, f'phase 29 {label}')
            # the card's busy time a step beside the host clock
            profile_step(trainer, example, f'phase 29 {label} B=4 x 16000',
                         table=False)
            results[label] = losses
            for samples, t in times.items():
                print(f'phase 29 bgru DPRNN step {label} B=4 x {samples}: '
                      + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items()))
            print(f'phase 29 {label}: launches in the first 3 steps '
                  f'{launches}, by route {routes}')
            if label == 'bf16 GRUs':
                model = trainer.model.eval()
                served = serve_bf16_tasnet(model)
                for name, n in served.items():
                    main[name] += n
            del trainer
        diff = {other: max(abs(x - y) for x, y in zip(
            results['bf16 GRUs'], results[other]))
            for other in ('policy alone', 'f32')}
        print(f'phase 29 losses over {steps} steps at B=4 x 16000: '
              + '; '.join(f'{k} {[round(x, 4) for x in v]}'
                          for k, v in results.items())
              + '; bf16 GRUs against '
              + ', '.join(f'{k} {v:.4f}' for k, v in diff.items())
              + f' largest difference; {time.perf_counter() - start:.1f} s')
        bf16 = results['bf16 GRUs']
        if not (np.isfinite(bf16).all() and bf16[-1] < bf16[0]):
            fail(f'the bgru DPRNN step on the bf16 GRU kernels does not '
                 f'train: {bf16}')
    torch.cuda.empty_cache()
    return main


def serve_bf16_tasnet(model):
    """4 requests through the tasnet recipe's ``evaluate_example`` with the
    GRUs at ``compute_dtype='bfloat16'``: the lean bf16 forward on its
    ``mma`` route, 12 launches a request, no float32 GRU launch; SI-SDR
    finite."""
    examples = list(tas_data.synthetic_database(num_examples=4, seed=2))
    reset_launches()
    latencies = []
    for example in examples:
        begin = time.perf_counter()
        _, metrics = tas_evaluate.evaluate_example(model, example)
        latencies.append((time.perf_counter() - begin) * 1e3)
        if not np.isfinite(metrics['output_si_sdr']).all():
            fail(f'bad metrics from the bf16-GRU DPRNN: {metrics}')
    launches = dict(gru_cell_scan.launches)
    routes = check_gru_routes('phase 29 serving', 'resident', fwd_bf16='mma')
    print(f'phase 29 the bf16-GRU model served {len(examples)} requests, '
          f'latency ms {[round(x, 3) for x in latencies]}, launches '
          f'{launches}, by route {routes}')
    if launches != with_zeros(launches, {'fwd_bf16': 12 * len(examples)}):
        fail(f'{len(examples)} requests launch 12 lean bf16 forwards each, '
             f'got {launches}')
    return bf16_gru_launches()


def speaker_runs(label, make_trainer, batch, steps, route, requests,
                 train_route, serve_route):
    """Phase 30 for one classifier: ``make_trainer(precision)`` from seed
    0, once under the bf16 policy with the GRU at
    ``compute_dtype='bfloat16'`` and once in float32, ``steps`` losses on
    ``batch`` each; the bf16 run's launches (fused_logmel and the bf16 GRU
    kernels: the training forward and backward on ``train_route``, the
    float32 ones on ``route``; no float32 GRU launch in the bf16 run), a
    timed step, then ``requests`` through ``evaluate_batch`` (the lean
    bf16 forward on ``serve_route``).  Returns the bf16 kernels'
    launches."""
    losses, main = {}, {}
    for precision in ('bfloat16', None):
        torch.manual_seed(0)
        trainer = make_trainer(precision).to('cuda')
        if precision:
            set_rnn_backend(trainer.model, 'pallas',
                            compute_dtype='bfloat16')
        example = trainer.model.example_to_device(batch, 'cuda')
        reset_launches()
        losses[precision] = losses_over(trainer, example, steps)
        launches = {'fused_logmel': fused_logmel.launches,
                    **gru_cell_scan.launches}
        routes = check_gru_routes(f'phase 30 {label}', route,
                                  fwd_train_bf16=train_route,
                                  bwd_bf16=train_route)
        variant = '_bf16' if precision else ''
        want = with_zeros(launches, {'fused_logmel': steps,
                                     'fwd_train' + variant: steps,
                                     'bwd' + variant: steps})
        if launches != want:
            fail(f'phase 30 {label} {precision}: launches {launches}, '
                 f'expected {want}')
        if precision:
            main = bf16_gru_launches()
        t = timed_step(trainer, batch, loss_key='trainer',
                       wrapper=gru_cell_scan, per_step=1, variant=variant)
        if precision:
            for name, n in bf16_gru_launches().items():
                main[name] += n
        masters_are_float32(trainer, f'phase 30 {label}')
        print(f'phase 30 {label} step, precision {precision}: '
              + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items())
              + f'; launches over {steps} steps {launches}, GRU by route '
              f'{routes}')
        if precision:
            model = trainer.model.eval()
            reset_launches()
            results, latencies = {}, []
            for request in requests:
                begin = time.perf_counter()
                results.update(spk_evaluate.evaluate_batch(model, request))
                latencies.append((time.perf_counter() - begin) * 1e3)
            served = dict(gru_cell_scan.launches)
            served_routes = check_gru_routes(f'phase 30 {label} served',
                                             route, fwd_bf16=serve_route)
            confidences = [v['confidence'] for v in results.values()]
            print(f'phase 30 {label}: {len(requests)} requests through '
                  f'evaluate_batch, latency ms '
                  f'{[round(x, 3) for x in latencies]}, launches {served} by '
                  f'route {served_routes}, {len(results)} utterances')
            if served != with_zeros(served, {'fwd_bf16': len(requests)}) \
                    or not np.isfinite(confidences).all():
                fail(f'phase 30 {label}: requests launched {served}, '
                     f'confidences {confidences}')
            for name, n in bf16_gru_launches().items():
                main[name] += n
        del trainer
    bf16, f32 = losses['bfloat16'], losses[None]
    print(f'phase 30 {label} losses over {steps} steps from one start, '
          f'bf16 policy with a bf16 GRU: {[round(x, 4) for x in bf16]}; '
          f'f32: {[round(x, 4) for x in f32]}; largest difference '
          f'{max(abs(x - y) for x, y in zip(bf16, f32)):.4f}')
    if not (np.isfinite(bf16).all() and bf16[-1] < bf16[0]):
        fail(f'the speaker classifier {label} under the bf16 policy does '
             f'not train: {bf16}')
    return main


def phase_speaker_bf16():
    """Phase 30: the speaker classifier under ``precision='bfloat16'`` with
    a bf16 GRU (``set_rnn_backend``) and the float32 ``fused_logmel`` in
    front: the recipe's classifier (64 units: the three bf16 kernels on
    the mma route) on its batches of 8 x 8000 samples, and the class
    defaults (251 speakers, (32, 64) channels, 256 units: the training
    forward and backward on the cooperative route, the served lean forward
    on the cluster route) on 16 x 64000, each beside float32 from the same
    start.  Returns the bf16 kernels' launches."""
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        train_ds, dev_ds = spk_train.synthetic_split(8)
        encoder = spk_data.get_label_encoder(tmp, train_ds)
        train = list(spk_data.prepare_dataset_audio(
            train_ds, encoder, batch_size=8, shuffle=False, prefetch=False))
        dev = list(spk_data.prepare_dataset_audio(
            dev_ds, encoder, batch_size=8, shuffle=False, prefetch=False))

        def recipe(precision):
            return Trainer.from_config(spk_train.get_trainer_config(
                Path(tmp) / f'recipe_{precision}', len(encoder.label_mapping),
                on_device_features=True, precision=precision))

        def defaults(precision):
            return Trainer(
                SpeakerClf(FusedAudioLogMelExtractor(16000, 512, 128, 64)),
                Path(tmp) / f'full_{precision}',
                Adam(gradient_clipping=10.0, lr=3e-4), precision=precision)

        main = speaker_runs('recipe (64 units)', recipe, train[0], 20,
                            'resident', dev, train_route='mma',
                            serve_route='mma')
        batch = speaker_batch(16, 64000, 251)
        requests = [dict(batch, example_id=[f'request{i}_{j}'
                                            for j in range(16)])
                    for i in range(2)]
        full = speaker_runs('class defaults (256 units)', defaults, batch,
                            20, 'cooperative', requests,
                            train_route='cooperative', serve_route='cluster')
    print(f'phase 30 {time.perf_counter() - start:.1f} s')
    torch.cuda.empty_cache()
    return {name: main[name] + full[name] for name in main}


# ---------------------------------------------------------------------------
# Phase 31: the geometries the reference's kernels take that the card
# refused before (each against its plain version)

# (label, kind, T, rows per direction, H, bf16, the layer's input width
# for the cuDNN yardstick): layers whose W_hh no co-resident grid holds on
# an H100, which take the streamed route
WIDE_RECURRENCES = [
    ('lstm 2 x 1024 f32', 'lstm', 50, 16, 1024, False, 1024),
    ('lstm 2 x 1536 bf16', 'lstm', 50, 16, 1536, True, 1536),
    ('gru 2 x 1024 f32', 'gru', 50, 16, 1024, False, 1024),
    ('gru 2 x 2048 f32', 'gru', 50, 16, 2048, False, 2048),
    ('gru 2 x 2048 bf16', 'gru', 50, 16, 2048, True, 2048),
]


def route_totals(wrapper):
    """A copy of a cell-scan wrapper's launches by route, summed over its
    kernels."""
    total = {}
    for counts in wrapper.routes.values():
        for route, n in counts.items():
            total[route] = total.get(route, 0) + n
    return total


def wide_recurrence_case(label, kind, t_len, batch, hdim, bf16, in_size,
                         timed=True):
    """The three kernels of a wide layer against their plain versions
    (float32: 1e-5; bf16: phase 23's limits), on the route the card's
    planner takes (the forwards' must be ``streamed``; ``lstm.scan_grid``,
    the planner's mirror, must name the same routes); with ``timed`` their
    times beside plain, cuDNN's layer and the bound (W_hh's bytes read once
    a step).  Returns {kernel: row}."""
    gates = 4 if kind == 'lstm' else 3
    args, cot = recurrence_inputs(t_len, batch, hdim, 'ragged', gates=gates)
    stream = torch.bfloat16 if bf16 else torch.float32
    cd = 'bfloat16' if bf16 else None
    args = [args[0].to(stream), *args[1:]]
    cot = [cot[0].to(stream), *cot[1:]]
    gx, w, mask = args[:3]
    device = torch.cuda.current_device()
    limits = gru_kernels.device_limits(device)
    for part in ('fwd', 'bwd'):
        card = lstm_kernels.device_grid(f'{kind}_{part}', 2, batch, hdim,
                                        bf16, device)
        mirror = lstm_kernels.scan_grid(f'{kind}_{part}', 2, batch, hdim,
                                        *limits, elem=2 if bf16 else 4)
        print(f'phase 31 {label} {part} grid: card {card}; mirror '
              f'{None if mirror is None else mirror._asdict()}')
        if card['blocks'] == 0 or mirror is None \
                or bool(card['streamed']) != mirror.streamed \
                or (part == 'fwd' and not mirror.streamed):
            fail(f'{label}: the {part} kernels\' route is not the one the '
                 f'mirror names, or the forwards do not stream: {card}, '
                 f'{mirror}')
    if kind == 'lstm':
        mod, wrapper, layer = lstm_kernels, lstm_cell_scan, torch.nn.LSTM
        plain_train = lstm_cell_scan_train_plain(*args, cd)
        _, c_seq, acts = plain_train[:3]
        bwd_in = (acts, c_seq, w, mask, *cot)
        kernel = {'fwd': lambda: wrapper(*args, compute_dtype=cd),
                  'fwd_train': lambda: mod._launch(*args[:2], 2, *args[2:],
                                                   train=True),
                  'bwd': lambda: mod._launch_bwd(acts, c_seq, w, 2, mask,
                                                 *cot)}
        plain = {'fwd': lambda: lstm_cell_scan_plain(*args, cd),
                 'fwd_train': lambda: lstm_cell_scan_train_plain(*args, cd),
                 'bwd': lambda: lstm_cell_scan_bwd_plain(*bwd_in, cd)}
        streams = {'fwd': 1, 'fwd_train': 3, 'bwd': 1}
    else:
        mod, wrapper, layer = gru_kernels, gru_cell_scan, torch.nn.GRU
        plain_train = gru_cell_scan_train_plain(*args, cd)
        residuals = plain_train[1:4]
        bwd_in = (*residuals, w, mask, *cot)
        kernel = {'fwd': lambda: wrapper(*args, compute_dtype=cd),
                  'fwd_train': lambda: mod._launch(*args[:2], 2, *args[2:],
                                                   train=True),
                  'bwd': lambda: mod._launch_bwd(*residuals, w, 2, mask,
                                                 *cot)}
        plain = {'fwd': lambda: gru_cell_scan_plain(*args, cd),
                 'fwd_train': lambda: gru_cell_scan_train_plain(*args, cd),
                 'bwd': lambda: gru_cell_scan_bwd_plain(*bwd_in, cd)}
        streams = {'fwd': 1, 'fwd_train': 4, 'bwd': 2}
    with torch.no_grad():
        routes = route_totals(wrapper)
        got = {name: fn() for name, fn in kernel.items()}
        want = {name: fn() for name, fn in plain.items()}
    torch.cuda.synchronize()
    launched = {k: v - routes[k] for k, v in route_totals(wrapper).items()}
    library = (cudnn_layer_ms(layer, t_len, batch, in_size, hdim,
                              dtype=stream) if timed else {})
    valid = t_len * 2 * batch if mask is None else float(mask.sum())
    rows = {}
    for name in ('fwd', 'fwd_train', 'bwd'):
        n = streams[name]
        if bf16:
            tol, stream_tol = (LSTM_BF16_STATE_TOL[name],
                               LSTM_BF16_STREAM_TOL[name])
            excess, share = bf16_distance(got[name][:n], want[name][:n],
                                          stream_tol)
            state_err = max_err(got[name][n:], want[name][n:])
            ok = (excess <= 0 and share <= LSTM_BF16_SHARE
                  and state_err <= tol)
            shown = (f'streams {excess + stream_tol:.3e} beyond one bf16 '
                     f'ulp (tol {stream_tol}), {share:.3%} differ (tol '
                     f'{LSTM_BF16_SHARE:.0%}); states {state_err:.3e} (tol '
                     f'{tol})')
        else:
            err = max_err(got[name], want[name])
            ok = err <= LSTM_TOL
            shown = f'max |kernel - plain| {err:.3e} (tol {LSTM_TOL})'
        row = {'max_abs_err': max_err(got[name], want[name]), 'shape': label}
        if timed:
            ms = cuda_ms(kernel[name], iters=5)
            plain_ms = cuda_ms(plain[name], iters=1)
            # the streamed route reads W_hh once a step, in the product's
            # type (bf16: rounded once a launch)
            limit = bound(w.numel() * (2 if bf16 else 4) * t_len
                          + nbytes(*args, *got[name]),
                          valid * 2 * hdim * gates * hdim)
            row.update(ms=ms, plain_ms=plain_ms, **limit,
                       library_ms=library[name])
            shown += (f'; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN '
                      f'layer {library[name]:.3f} ms, bound '
                      f'{limit["bound_ms"]:.4f} ms by {limit["bound_by"]}')
        print(f'phase 31 {label} {name}: {shown}')
        if not ok:
            fail(f'{label}: the {name} kernel disagrees with plain')
        rows[name] = row
    if launched.get('streamed', 0) == 0:
        fail(f'{label}: no launch took the streamed route: {launched}')
    return rows


# the streamed forwards measured with and without an L2 access-policy
# window over their packed weights: (label, kind, T, batch, H, bf16)
L2_WINDOW_CASES = [('lstm 2 x 1024 f32', 'lstm', 50, 16, 1024, False),
                   ('lstm 2 x 1536 bf16', 'lstm', 50, 16, 1536, True)]


def l2_window_case(label, kind, t_len, batch, hdim, bf16):
    """The streamed LSTM forward on a stream of its own, timed without an
    L2 access-policy window, with one over its packed weights (the
    persisting L2 at its largest, ``scan_l2_window``), and without again;
    the window's runs give the bits of the others.  Returns the times."""
    args, _ = recurrence_inputs(t_len, batch, hdim, 'ragged', gates=4)
    stream_dtype = torch.bfloat16 if bf16 else torch.float32
    gx, w, mask, h0, c0 = [args[0].to(stream_dtype), *args[1:]]
    wpack = torch.empty(lstm_kernels.packed_bytes('lstm_fwd', 2, hdim, bf16),
                        dtype=torch.uint8, device='cuda')
    lib = _build.load_library()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    info = (ctypes.c_int * 2)()
    with torch.cuda.stream(side):
        stream, device = _build.stream_and_device(gx)

        def run():
            return lstm_kernels._launch(gx, w, 2, mask, h0, c0, wpack=wpack)

        def window(n_bytes):
            err = lib.scan_l2_window(wpack.data_ptr() if n_bytes else None,
                                     n_bytes, device, stream,
                                     ctypes.addressof(info))
            _build.check(lib, err, 'scan_l2_window')

        ms = {'without': cuda_ms(run, iters=5)}
        base = run()
        window(wpack.numel())
        try:
            ms['window'] = cuda_ms(run, iters=5)
            windowed = run()
        finally:
            persisting, span = info[0], info[1]
            window(0)
        ms['without, after'] = cuda_ms(run, iters=5)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(base, windowed))
    print(f'phase 31 {label} fwd, streamed, L2 access-policy window over its '
          f'{wpack.numel()} bytes of packed weights (persisting L2 '
          f'{persisting} bytes, window {span} bytes): '
          + ', '.join(f'{k} {v:.3f} ms' for k, v in ms.items())
          + f'; the same bits {same}')
    if not same:
        fail(f'{label}: the L2 window changed the streamed forward\'s bits')
    return ms


# the float32 LSTM kernels' outputs on fixed inputs at phase 3's, 4's and
# 9's shapes: lean forward, training forward and backward; run in a
# process of its own from a checkout's root, so that two checkouts'
# kernels can be compared (``python3 -c "import chip_smoke as c;
# print(c.lstm_f32_digests('<checkout>'))"``)
LSTM_DIGEST_CODE = r"""
import hashlib, json, sys
import numpy as np
import torch
from padertorch_tpu_torch.ops.kernels import lstm
out = {}
for label, t_len, batch, hdim in json.loads(sys.argv[1]):
    rng = np.random.RandomState(hdim + t_len)
    lens = rng.randint(t_len // 2, t_len + 1, size=batch)
    fwd = np.arange(t_len)[:, None] < lens[None, :]
    mask = np.concatenate([fwd, fwd[::-1]], axis=1)
    rows = 2 * batch
    put = lambda a: torch.from_numpy(a.astype('float32')).cuda()
    gx = put(rng.uniform(-1, 1, (t_len, rows, 4 * hdim)))
    w = put(rng.uniform(-1, 1, (2, hdim, 4 * hdim)) / np.sqrt(hdim))
    h0 = put(rng.uniform(-0.1, 0.1, (rows, hdim)))
    c0 = put(rng.uniform(-0.1, 0.1, (rows, hdim)))
    d_out = put(rng.uniform(-1, 1, (t_len, rows, hdim)))
    dh = put(rng.uniform(-1, 1, (rows, hdim)))
    dc = put(rng.uniform(-1, 1, (rows, hdim)))
    digest = hashlib.sha256()
    for m in (None, put(mask)):
        lean = lstm.lstm_cell_scan(gx, w, m, h0, c0)
        train = lstm._launch(gx, w, 2, m, h0, c0, train=True)
        bwd = lstm._launch_bwd(train[2], train[1], w, 2, m, d_out, dh, dc)
        for t in (*lean, *train, *bwd):
            digest.update(t.cpu().numpy().tobytes())
    out[label] = digest.hexdigest()[:16]
print(json.dumps(out))
"""


def lstm_f32_digests(root):
    """{shape: digest} of the float32 LSTM kernels of the checkout at
    ``root`` (see LSTM_DIGEST_CODE), at RECURRENCE_SHAPES."""
    shapes = [(label, t_len, batch, hdim)
              for label, t_len, batch, hdim, _ in RECURRENCE_SHAPES]
    proc = subprocess.run(
        [sys.executable, '-c', LSTM_DIGEST_CODE, json.dumps(shapes)],
        cwd=root, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f'the float32 LSTM digests of {root} failed:\n{proc.stderr}')
    return json.loads(proc.stdout.strip().splitlines()[-1])


# the bf16 LSTM backward's outputs (dgates_x, dh0, dc0) on fixed inputs at
# phase 23's shapes, unmasked and ragged: residuals drawn from a seed (not
# a forward's, so that they do not depend on the forward kernels); run in
# a process of its own from a checkout's root, so that two checkouts'
# kernels can be compared (``python3 -c "import chip_smoke as c;
# print(c.lstm_bf16_bwd_digests('<checkout>'))"``)
LSTM_BF16_BWD_DIGEST_CODE = r"""
import hashlib, json, sys
import numpy as np
import torch
from padertorch_tpu_torch.ops.kernels import lstm
out = {}
for label, t_len, batch, hdim in json.loads(sys.argv[1]):
    rng = np.random.RandomState(hdim + t_len)
    lens = rng.randint(t_len // 2, t_len + 1, size=batch)
    fwd = np.arange(t_len)[:, None] < lens[None, :]
    mask = np.concatenate([fwd, fwd[::-1]], axis=1)
    rows = 2 * batch
    put = lambda a: torch.from_numpy(a.astype('float32')).cuda()
    acts = rng.uniform(0, 1, (t_len, rows, 4, hdim))
    acts[:, :, 2] = 2 * acts[:, :, 2] - 1          # g = tanh(.) in (-1, 1)
    gates = put(acts.reshape(t_len, rows, 4 * hdim)).bfloat16()
    c_seq = put(rng.uniform(-1, 1, (t_len, rows, hdim))).bfloat16()
    w = put(rng.uniform(-1, 1, (2, hdim, 4 * hdim)) / np.sqrt(hdim))
    d_out = put(rng.uniform(-1, 1, (t_len, rows, hdim))).bfloat16()
    dh = put(rng.uniform(-1, 1, (rows, hdim)))
    dc = put(rng.uniform(-1, 1, (rows, hdim)))
    digest = hashlib.sha256()
    for m in (None, put(mask)):
        bwd = lstm._launch_bwd(gates, c_seq, w, 2, m, d_out, dh, dc)
        for t in bwd:
            digest.update(t.cpu().contiguous().view(torch.uint8).numpy()
                          .tobytes())
    out[label] = digest.hexdigest()[:16]
print(json.dumps(out))
"""


def lstm_bf16_bwd_digests(root):
    """{shape: digest} of the bf16 LSTM backward of the checkout at
    ``root`` (see LSTM_BF16_BWD_DIGEST_CODE), at LSTM_BF16_SHAPES."""
    shapes = [(label, t_len, batch, hdim)
              for label, t_len, batch, hdim, _, _ in LSTM_BF16_SHAPES]
    proc = subprocess.run(
        [sys.executable, '-c', LSTM_BF16_BWD_DIGEST_CODE, json.dumps(shapes)],
        cwd=root, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f'the bf16 LSTM backward digests of {root} failed:\n'
             f'{proc.stderr}')
    return json.loads(proc.stdout.strip().splitlines()[-1])


DEEP_DILATIONS = [2 ** (i % 10) for i in range(30)]   # to 512: 3,069 slots
# (label, layers, R, S, O, dilations, rows, steps)
WAVENET_GEOMETRIES = [
    ('30 layers to 512, R=64, 1 row', 30, 64, 256, 256, DEEP_DILATIONS, 1,
     40),
    ('30 layers to 512, R=64, 8 rows', 30, 64, 256, 256, DEEP_DILATIONS, 8,
     40),
    ('30 layers to 512, R=64, 132 rows', 30, 64, 256, 256, DEEP_DILATIONS,
     132, 40),
    ('24 layers to 128, R=128, 4 rows', 24, 128, 256, 256,
     [2 ** (i % 8) for i in range(24)], 4, 40),
    ('R=60, S=250, O=254, 3 rows', 4, 60, 250, 254, [1, 2, 4, 8], 3, 60),
    ('80 layers, 2 rows', 80, 16, 32, 256, [2 ** (i % 4) for i in range(80)],
     2, 40),
    ('rings in device memory, R=512, 2 rows', 30, 512, 256, 256,
     DEEP_DILATIONS, 2, 20),
]


def wavenet_test_weights(n_layers, r, s, o, rng, c=256, scale=None):
    """Sampler weights of the kernel's contract, each product's scaled by
    its input width (as an initialised model's, so that 30 layers of
    residual sums neither blow up nor vanish); with ``scale``, every weight
    and bias uniform in (-scale, scale) whatever the width."""
    def u(*shape):
        bound = np.sqrt(3.0 / shape[-2]) if len(shape) > 1 else 0.1
        bound = bound if scale is None else scale
        return torch.from_numpy(
            rng.uniform(-bound, bound, shape).astype('float32')).cuda()
    return {'w_prev': u(n_layers, r, 2 * r), 'w_curr': u(n_layers, r, 2 * r),
            'b_dil': u(n_layers, 2 * r), 'w_res': u(n_layers - 1, r, r),
            'b_res': u(n_layers - 1, r), 'w_skip': u(n_layers, r, s),
            'b_skip': u(n_layers, s), 'w_out': u(s, o), 'w_end': u(o, o),
            'embed': torch.from_numpy(rng.randn(c, r).astype(
                'float32')).cuda()}


def wavenet_geometry_case(label, n_layers, r, s, o, dilations, rows, steps,
                          scale=None):
    """The sampler at a geometry the card refused before: teacher-forced
    logits within WAVENET_TOL of plain's (of max(1, |logit|)), every
    teacher-forced choice plain's where plain's two best logits are
    further apart than twice that; the plan it took; the greedy run's
    first row equal, bit for bit, to that row alone (weights of
    :func:`wavenet_test_weights` at ``scale``).  Returns the plan."""
    rng = np.random.RandomState(r + n_layers)
    w = wavenet_test_weights(n_layers, r, s, o, rng, scale=scale)
    cond = torch.from_numpy(rng.randn(steps, rows, n_layers, 2 * r).astype(
        'float32')).cuda()
    forced = torch.from_numpy(rng.randint(0, o, (steps, rows)).astype(
        'int32')).cuda()
    padded = [-(-x // 4) * 4 for x in (r, s, o)]
    plan = wavenet_kernels.device_plan(rows, n_layers, *padded,
                                       sum(dilations), 0)
    with torch.no_grad():
        idx, logits = wavenet_sample(cond, w, dilations, forced_input=forced,
                                     return_logits=True)
        want_idx, want = wavenet_sample_plain(
            cond, w, dilations, forced_input=forced, return_logits=True)
        greedy = wavenet_sample(cond, w, dilations)
        alone = wavenet_sample(cond[:, :1].contiguous(), w, dilations)
    torch.cuda.synchronize()
    scale = max(1.0, float(want.abs().max()))
    err = float((logits - want).abs().max()) / scale
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * WAVENET_TOL * scale
    choices = bool(torch.equal(idx[clear], want_idx[clear]))
    same = torch.equal(greedy[:, :1], alone)
    # a step's time, and its bound: the products' float32 operations of
    # every row (the 2R-long dilated pair, S + R skip and residual, w_out
    # and w_end)
    with torch.no_grad():
        step_ms = cuda_ms(lambda: wavenet_sample(cond, w, dilations),
                          iters=2) / steps
    flops = rows * 2 * (n_layers * (2 * r * 2 * r + r * (s + r)) + s * o
                        + o * o)
    print(f'phase 31 wavenet_sample {label}: plan {plan._asdict()}; '
          f'teacher-forced logits max |kernel - plain| / max(1, |logit|) '
          f'{err:.3e} (tol {WAVENET_TOL}), choices equal where clear '
          f'{choices} ({int(clear.sum())} of {clear.numel()}); greedy row 0 '
          f'alone the same bits {same}; {step_ms * 1e3:.2f} us a step '
          f'(bound {flops / PEAK_F32_FLOPS * 1e6:.3f} us by operations)')
    if not (err <= WAVENET_TOL and choices and same):
        fail(f'wavenet_sample disagrees with plain at {label}')
    return plan


def wavenet_f64_logits(cond, w, dilations, forced):
    """Teacher-forced logits of the sampler in float64: a step loop of its
    own (the layer's input kept in a ring of ``d`` slots, zero at step 0),
    the witness of what exact arithmetic gives on these inputs."""
    w = {k: v.double() for k, v in w.items()}
    cond = cond.double()
    r = w['embed'].shape[1]
    rings = [cond.new_zeros((int(d), cond.shape[1], r)) for d in dilations]
    logits = []
    for step in range(cond.shape[0]):
        x = w['embed'][forced[step].long()]
        skip = 0.0
        for i, d in enumerate(dilations):
            past = rings[i][step % int(d)].clone()
            rings[i][step % int(d)] = x if step > 0 else 0.0
            a = (past @ w['w_prev'][i] + x @ w['w_curr'][i] + w['b_dil'][i]
                 + cond[step, :, i])
            z = torch.tanh(a[:, :r]) * torch.sigmoid(a[:, r:])
            skip = skip + z @ w['w_skip'][i] + w['b_skip'][i]
            if i < len(dilations) - 1:
                x = x + z @ w['w_res'][i] + w['b_res'][i]
        logits.append(torch.relu(torch.relu(skip) @ w['w_out'])
                      @ w['w_end'])
    return torch.stack(logits)


# the sampler with every weight uniform in (-0.2, 0.2), not scaled by its
# input width: 30 layers at R = 512 (rings in device memory) amplify each
# rounding through the depth, so float32 itself, plain or kernel, lands
# far from float64 and from each other; 4 layers to dilation 1024 at the
# same weights and route, 1100 steps (every ring read back), stay well
# conditioned and are held to WAVENET_TOL
WAVENET_UNSCALED_DEEP = ('rings in device memory, R=512, 2 rows, 30 layers',
                         30, 512, 256, 256, DEEP_DILATIONS, 2, 20)
WAVENET_UNSCALED_SHALLOW = ('rings in device memory, R=512, 2 rows, 4 layers '
                            'to 1024, weights uniform 0.2', 4, 512, 256, 256,
                            [1, 512, 1024, 512], 2, 1100)
# the kernel's distance to float64 at most this many times plain float32's
WAVENET_F64_FACTOR = 4.0


def wavenet_unscaled_witness():
    """Weights of 0.2 whatever the width (the kernel's ring_global route at
    R = 512): at 30 layers the kernel's teacher-forced logits, plain's in
    float32 and a float64 step loop's, each distance of max(1, |logit|);
    the kernel passes if it is no further from float64 than
    WAVENET_F64_FACTOR times plain float32 (and within WAVENET_TOL of
    float64 where plain float32 is).  At 4 layers to dilation 1024 on the
    same route and weights, :func:`wavenet_geometry_case` at WAVENET_TOL."""
    label, n_layers, r, s_dim, o_dim, dilations, rows, steps = \
        WAVENET_UNSCALED_DEEP
    rng = np.random.RandomState(r + n_layers)
    w = wavenet_test_weights(n_layers, r, s_dim, o_dim, rng, scale=0.2)
    cond = torch.from_numpy(rng.randn(steps, rows, n_layers, 2 * r).astype(
        'float32')).cuda()
    forced = torch.from_numpy(rng.randint(0, o_dim, (steps, rows)).astype(
        'int32')).cuda()
    plan = wavenet_kernels.device_plan(rows, n_layers, r, s_dim, o_dim,
                                       sum(dilations), 0)
    with torch.no_grad():
        _, kernel = wavenet_sample(cond, w, dilations, forced_input=forced,
                                   return_logits=True)
        _, plain = wavenet_sample_plain(cond, w, dilations,
                                        forced_input=forced,
                                        return_logits=True)
        exact = wavenet_f64_logits(cond, w, dilations, forced)
    scale = max(1.0, float(exact.abs().max()))
    dist = {name: float((x.double() - y.double()).abs().max()) / scale
            for name, (x, y) in {'kernel - plain': (kernel, plain),
                                 'plain - float64': (plain, exact),
                                 'kernel - float64': (kernel, exact)}.items()}
    limit = max(WAVENET_TOL, WAVENET_F64_FACTOR * dist['plain - float64'])
    print(f'phase 31 wavenet_sample {label}, weights uniform 0.2: plan '
          f'{plan._asdict()}; teacher-forced logits over {steps} steps, '
          f'largest |logit| (float64) {scale:.2f}, distances / max(1, '
          f'|logit|): ' + ', '.join(f'{k} {v:.3e}' for k, v in dist.items())
          + f' (the kernel to float64 within {limit:.3e}: '
          f'{WAVENET_F64_FACTOR:g} times plain\'s, at least WAVENET_TOL)')
    if not plan.ring_global or not dist['kernel - float64'] <= limit:
        fail(f'wavenet_sample at {label}, weights uniform 0.2: the route '
             f'is not ring_global or the kernel is further from float64 '
             f'than plain float32 is: {dist}')
    plan = wavenet_geometry_case(*WAVENET_UNSCALED_SHALLOW, scale=0.2)
    if not plan.ring_global:
        fail(f'{WAVENET_UNSCALED_SHALLOW[0]}: plan {plan} is not ring_global')


# (label, size, shift, mels, batch, samples)
LOGMEL_LONG_HOPS = [('1600/800, 80 mels', 1600, 800, 80, 16, 64000),
                    ('1024/1024, 64 mels', 1024, 1024, 64, 16, 64000)]


def logmel_long_hop_case(label, size, shift, mels, batch, samples):
    """fused_logmel at a hop whose 64 frames' span does not fit one block:
    the sliced route against plain (LOGMEL_TOL), its time beside plain's;
    and at the recipe's hop the sliced route forced equals the span route
    bit for bit."""
    frontend = LogMelFrontend(size=size, shift=shift, n_mels=mels)
    x = torch.from_numpy(np.random.RandomState(size).randn(
        batch, samples).astype('float32') * 0.1).cuda()
    before = dict(fused_logmel.routes)
    got = frontend(x)
    want = frontend.plain(x)
    torch.cuda.synchronize()
    routed = {k: v - before[k] for k, v in fused_logmel.routes.items()}
    err = float((got - want).abs().max())
    ms = cuda_ms(lambda: frontend(x), iters=10, warmup=2)
    plain_ms = cuda_ms(lambda: frontend.plain(x), iters=5)
    # phase 16's bound: the DFT at 3xTF32, the mel's nonzeros at float32
    frames, f_bins = got.shape[1], size // 2 + 1
    bands = frontend.bands_on('cpu')[:3 * mels].reshape(mels, 3)
    mel_terms = int((bands[:, 1] - bands[:, 0]).sum())
    by_ops = (batch * frames * 4 * size * f_bins / PEAK_3XTF32_FLOPS
              + batch * frames * 2 * mel_terms / PEAK_F32_FLOPS) * 1e3
    by_bytes = nbytes(x, got, *frontend.bases_on('cuda')[:3]) \
        / PEAK_BYTES_PER_S * 1e3
    print(f'phase 31 fused_logmel {label} ({batch} x {samples}): routes '
          f'{routed}; max |kernel - plain| {err:.3e} (tol {LOGMEL_TOL}); '
          f'kernel {ms:.3f} ms (eager), plain {plain_ms:.3f} ms, bound '
          f'{max(by_ops, by_bytes):.4f} ms by '
          f'{"operations" if by_ops >= by_bytes else "bytes"}')
    if routed != {'span': 0, 'sliced': 1} or not err <= LOGMEL_TOL:
        fail(f'fused_logmel at {label}: routes {routed}, error {err}')


def logmel_routes_agree():
    """The sliced route forced at the recipe's hop gives the span route's
    bits."""
    frontend = LogMelFrontend(size=512, shift=128, n_mels=64)
    x = torch.from_numpy(np.random.RandomState(1).randn(8, 8000).astype(
        'float32') * 0.1).cuda()
    span = frontend(x)
    lo, hi = frontend._pad_widths(x.shape[1])
    n_frames = (x.shape[1] + lo + hi - 512) // 128 + 1
    plan = logmel_plan(8, n_frames, 512, 128, 257, frontend.n_partials,
                       *gru_kernels.device_limits(x.get_device()))
    plan = plan._replace(sliced=True, smem=logmel_smem(
        512, 128, frontend.n_partials, sliced=True))
    sliced = torch.empty_like(span)
    stream, device = _build.stream_and_device(x)
    frontend._launch(x, sliced, lo, n_frames, plan, device, stream)
    torch.cuda.synchronize()
    same = torch.equal(sliced, span)
    print(f'phase 31 fused_logmel 512/128 (8 x 8000): the sliced route '
          f'forced gives the span route\'s bits {same}')
    if not same:
        fail('fused_logmel\'s sliced route differs from the span route')


# (label, B, H, Hkv, T, D, masks)
ATTENTION_WIDE_CASES = [
    ('D=192 (2, 4, 300, 192) causal, ragged', 2, 4, 4, 300, 192,
     {'causal': True, 'key_padding_lens': [300, 123]}),
    ('D=256 gqa (2, 8 over 2, 1024, 256) full', 2, 8, 2, 1024, 256, {}),
    ('D=256 (2, 4, 700, 256) window (100, 30)', 2, 4, 4, 700, 256,
     {'window': (100, 30)}),
]


def attention_wide_case(label, b, h, h_kv, t_len, d, masks, dtype):
    """The attention kernels at a head above 128 (the wrapper pads it to
    256): float32 against the plain version (O within ATTENTION_TOL, the
    gradients ATTENTION_GRAD_RTOL of their largest entry), bf16 against
    the plain bf16 versions on the unpadded heads at phase 26's limits;
    two runs give the same bits."""
    rng = np.random.RandomState(d)
    q, k, v, d_o = (torch.tensor(rng.randn(*shape), dtype=torch.float32,
                                 device='cuda').to(dtype)
                    for shape in ((b, h, t_len, d), (b, h_kv, t_len, d),
                                  (b, h_kv, t_len, d), (b, h, t_len, d)))
    lens = attention_kernels._lens_tensor(masks.get('key_padding_lens'), b,
                                          q.device)
    config = (masks.get('causal', False),
              *attention_kernels._norm_window(masks.get('window')),
              1.0 / np.sqrt(d))
    before = dict(flash_attention.launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, **masks)
    grads = torch.autograd.grad(out, leaves, d_o)
    again = torch.autograd.grad(flash_attention(*leaves, **masks), leaves,
                                d_o)
    same = all(torch.equal(x, y) for x, y in zip(grads, again))
    launched = {k_: v_ - before[k_] for k_, v_ in
                flash_attention.launches.items()}
    if dtype == torch.float32:
        plain_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        want = flash_attention_plain(*plain_leaves, **masks)
        want_grads = torch.autograd.grad(want, plain_leaves, d_o)
        err = float((out - want).abs().max())
        rel = max(float((g - w_).abs().max() / w_.abs().max())
                  for g, w_ in zip(grads, want_grads))
        ok = err <= ATTENTION_TOL and rel <= ATTENTION_GRAD_RTOL
        shown = (f'O max |kernel - plain| {err:.3e} (tol {ATTENTION_TOL}), '
                 f'gradients {rel:.3e} of their largest entry (tol '
                 f'{ATTENTION_GRAD_RTOL})')
    else:
        pad = lambda x: torch.nn.functional.pad(x, (0, 256 - d)).contiguous()
        o_p, lse = attention_kernels._launch_fwd(
            pad(q), pad(k), pad(v), lens, *config, train=True)
        o = o_p[..., :d]
        want, want_lse = attention_bf16_fwd_plain(q, k, v, **masks)
        want_grads = flash_attention_bwd_plain(q, k, v, o, lse, d_o,
                                               **masks)
        kernel_grads = attention_kernels._launch_bwd(
            pad(q), pad(k), pad(v), lens, pad(d_o), lse,
            (d_o.float() * o.float()).sum(-1), *config)
        kernel_grads = [x[..., :d] for x in kernel_grads]
        same = same and all(torch.equal(x, y)
                            for x, y in zip(kernel_grads, grads))
        excess, share = bf16_distance([out], [want], ATTENTION_BF16_FWD_ATOL)
        lse_err = lse_distance(lse, want_lse)
        grad_excess, grad_share = bf16_grad_distance(kernel_grads,
                                                     want_grads)
        ok = (excess <= 0 and share <= ATTENTION_BF16_FWD_SHARE
              and lse_err <= ATTENTION_BF16_LSE_TOL and grad_excess <= 0
              and grad_share <= ATTENTION_BF16_GRAD_SHARE)
        shown = (f'O {excess + ATTENTION_BF16_FWD_ATOL:.3e} beyond one ulp, '
                 f'{share:.3%} differ; LSE {lse_err:.3e}; dq, dk, dv '
                 f'{grad_excess:.3e} beyond the limit, {grad_share:.3%} '
                 f'differ (phase 26\'s limits)')
    torch.cuda.synchronize()
    print(f'phase 31 attention {str(dtype)[6:]} {label}: {shown}; launches '
          f'{ {k_: v_ for k_, v_ in launched.items() if v_} }; two runs '
          f'the same bits {same}')
    if not ok or not same:
        fail(f'the attention kernels disagree with plain at {label} '
             f'({dtype})')


def phase_geometries():
    """Phase 31: the geometries of the reference's kernels that the card
    refused before: wide LSTM and GRU layers (the streamed route), the
    float32 LSTM kernels' digests at the earlier shapes, the sampler's
    large rings, channels that are no multiple of 4 and 80 layers, the
    log-mel's long hops, attention heads of 192 and 256."""
    start = time.perf_counter()
    rows = {}
    for label, *shape in WIDE_RECURRENCES:
        rows[label] = wide_recurrence_case(label, *shape)
        torch.cuda.empty_cache()
    for case in L2_WINDOW_CASES:
        l2_window_case(*case)
        torch.cuda.empty_cache()
    digests = lstm_f32_digests(Path(__file__).resolve().parent)
    print(f'phase 31 float32 LSTM kernels\' digests (lean, training '
          f'forward, backward, unmasked and ragged): {json.dumps(digests)}')
    for case in WAVENET_GEOMETRIES:
        wavenet_geometry_case(*case)
    wavenet_unscaled_witness()
    for case in LOGMEL_LONG_HOPS:
        logmel_long_hop_case(*case)
    logmel_routes_agree()
    for case in ATTENTION_WIDE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            attention_wide_case(*case, dtype)
            torch.cuda.empty_cache()
    print(f'phase 31 took {time.perf_counter() - start:.1f} s')
    return rows


# ---------------------------------------------------------------------------
# Phases 33 to 36: the rest of the separation and enhancement family.

# the first Conv-TasNet step, card vs CPU: the loss is a mean of log10
# ratios, the norm sums 8.7 M gradients through 32 blocks of cuDNN
# convolutions (TF32 off) and gLN reductions summed in another order
CONVNET_STEP_RTOL = 1e-4
# (filters, filter length, N, hidden channels, blocks, repeats, norm) of
# the tasnet recipe's convnet variant
CONVNET_WIDTH = (256, 20, 256, 512, 8, 4, 'GlobalLayerNorm')
# the first mask-estimator step, card vs CPU (one BLSTM layer of 256
# units, three linear layers, binary cross entropy), as phase 7's
MASK_ESTIMATOR_STEP_RTOL = 1e-5
# the first deep-clustering step and the served embeddings, card vs CPU
# (two BLSTM layers of 600 units, a linear layer to F * E, a unit norm)
DC_STEP_RTOL = 1e-5
DC_TOL = 1e-5
# a request's masks, card vs CPU: float32 sums of one BLSTM layer and of
# 1024-wide products in another order, through a sigmoid
MASK_ESTIMATOR_MASK_TOL = 1e-5
# its metric triples, card vs CPU (stoi, and SI-SDR and SDR in dB): the
# observed and masked signals' and MVDR's beamformed one's.  GEV's are not
# compared: where a model trained a few iterations gives speech and noise
# masks near 0.5, the two PSD matrices nearly coincide and the principal
# generalized eigenvector moves with the masks' last bits (0.95 dB of
# beamformed SI-SDR from masks within 3.6e-7 in a development run on an
# H100); the beamformers run on the host, the same numpy code on both
# sides
MASK_ESTIMATOR_METRIC_TOL = 1e-3


def lstm_kernels_case(phase, label, t_len, batch, hdim, kind, in_size,
                      directions=2):
    """The three float32 LSTM kernels and the ``autograd.Function`` at one
    shape of ``directions`` directions against their plain versions at
    phases 3, 6 and 9's limits, each with its TF32 control failing them (plain with
    ``W_hh`` rounded to TF32: cuBLAS keeps a product of 4 rows a direction
    on its float32 path even with TF32 allowed); the route each
    kernel took (``lstm_cell_scan.routes``) and the card's grid against the
    mirror ``lstm.scan_grid``'s; timed beside plain, one ``torch.nn.LSTM`` layer
    of as many directions (cuDNN) with ``in_size`` inputs, and the bound.
    Returns a row of numbers per kernel."""
    args, cot = recurrence_inputs(t_len, batch, hdim, kind, gates=4,
                                  directions=directions)
    gx, w, mask, h0, c0 = args
    valid = (t_len * directions * batch if mask is None
             else float(mask.sum()))

    def fwd_train():
        return lstm_kernels._launch(gx, w, directions, mask, h0, c0,
                                    train=True)

    reset_launches()
    got = lstm_cell_scan(*args)
    got_train = fwd_train()
    want = lstm_cell_scan_plain(*args)
    want_train = lstm_cell_scan_train_plain(*args)
    _, c_seq, gates, _, _ = want_train

    def bwd():
        return lstm_kernels._launch_bwd(gates, c_seq, w, directions, mask,
                                        *cot)

    got_bwd = bwd()
    want_bwd = lstm_cell_scan_bwd_plain(gates, c_seq, w, mask, *cot)
    torch.cuda.synchronize()
    took = {name: [r for r, n in lstm_cell_scan.routes[name].items() if n]
            for name in ('fwd', 'fwd_train', 'bwd')}
    n_sm, max_smem = gru_kernels.device_limits(0)
    card = {name: lstm_kernels.device_grid(
                'lstm_bwd' if name == 'bwd' else 'lstm_fwd', directions,
                batch, hdim, False, 0, name == 'fwd_train')
            for name in took}
    mirror = {name: lstm_kernels.scan_grid(
                  'lstm_bwd' if name == 'bwd' else 'lstm_fwd', directions,
                  batch, hdim, n_sm, max_smem)
              for name in took}

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (gx, w, h0, c0)]
        outs = fn(leaves[0], leaves[1], mask, leaves[2], leaves[3])
        return torch.autograd.grad(outs, leaves, cot)

    want_grads = grads(lstm_cell_scan_plain)
    err = {'fwd': max_err(got, want),
           'fwd_train': max_err(got_train, want_train),
           'bwd': max_err(got_bwd, want_bwd),
           'function': max_rel_err(grads(lstm_cell_scan), want_grads)}
    # the TF32 control: plain with W_hh rounded to TF32, as phase 12's
    # controls round their operands (at 4 rows a direction cuBLAS keeps
    # the recurrent product on its float32 path even with TF32 allowed)
    w_tf32 = tf32_round(w)
    args_tf32 = [gx, w_tf32, mask, h0, c0]
    tf32 = {'fwd': max_err(lstm_cell_scan_plain(*args_tf32), want),
            'fwd_train': max_err(lstm_cell_scan_train_plain(*args_tf32),
                                 want_train),
            'bwd': max_err(lstm_cell_scan_bwd_plain(
                gates, c_seq, w_tf32, mask, *cot), want_bwd),
            'function': max_rel_err(
                grads(lambda x, w_leaf, *rest: lstm_cell_scan_plain(
                    x, w_leaf + (w_tf32 - w), *rest)), want_grads)}
    times = {'fwd': cuda_ms(lambda: lstm_cell_scan(*args), iters=20),
             'fwd_train': cuda_ms(fwd_train, iters=20),
             'bwd': cuda_ms(bwd, iters=20)}
    plain = {'fwd': cuda_ms(lambda: lstm_cell_scan_plain(*args), iters=3),
             'fwd_train': cuda_ms(
                 lambda: lstm_cell_scan_train_plain(*args), iters=3),
             'bwd': cuda_ms(lambda: lstm_cell_scan_bwd_plain(
                 gates, c_seq, w, mask, *cot), iters=3)}
    library = cudnn_layer_ms(torch.nn.LSTM, t_len, batch, in_size, hdim,
                             directions)
    flops = valid * (2 * hdim * 4 * hdim + 30 * hdim)
    limits = {
        'fwd': bound(nbytes(*args, *got), flops),
        'fwd_train': bound(nbytes(*args, *got_train), flops),
        'bwd': bound(nbytes(gates, c_seq, w, mask, *cot, *got_bwd), flops)}
    rows = {}
    for name, tol in (('fwd', LSTM_TOL), ('fwd_train', LSTM_TOL),
                      ('bwd', LSTM_BWD_TOL), ('function', LSTM_GRAD_RTOL)):
        if name == 'function':
            print(f'phase {phase} lstm Function vs autograd through plain '
                  f'{label}: max relative difference {err[name]:.3e} (tol '
                  f'{tol}), with W_hh rounded to TF32 {tf32[name]:.3e}')
        else:
            route = 'streamed' if mirror[name].streamed else 'cooperative'
            print(f'phase {phase} lstm {name} {label}: max |kernel - plain| '
                  f'{err[name]:.3e} (tol {tol}), plain with W_hh rounded to '
                  f'TF32 {tf32[name]:.3e}; route {took[name]}, the card\'s grid '
                  f'{card[name]}, the mirror\'s {mirror[name]._asdict()}; '
                  f'kernel {times[name]:.4f} ms, plain {plain[name]:.3f} '
                  f'ms, cuDNN layer {library[name]:.4f} ms, bound '
                  f'{limits[name]["bound_ms"]:.4f} ms by '
                  f'{limits[name]["bound_by"]}')
            if took[name] != [route] or any(
                    card[name][key] != getattr(mirror[name], key)
                    for key in ('U', 'n_rb', 'RB', 'RS', 'KS', 'blocks',
                                'streamed')):
                fail(f'lstm {name} at {label} took {took[name]} on '
                     f'{card[name]}, the mirror plans {mirror[name]}')
            rows[name] = {'shape': label, 'max_abs_err': err[name],
                          'ms': times[name], 'plain_ms': plain[name],
                          **limits[name], 'library_ms': library[name],
                          'lstm_route': took[name][0]}
        if not err[name] <= tol:
            fail(f'lstm {name} disagrees with plain at {label}: '
                 f'{err[name]}')
        if not tf32[name] > tol:
            fail(f'the limit {tol} does not tell W_hh rounded to TF32 from '
                 f'f32 at {label}: {tf32[name]}')
    return rows


def istft_case(phase, label, n_rows, frames):
    """``masked_istft`` against plain at the recipe's STFT (512, 128,
    257 bins) on ``n_rows`` signals of ``frames`` frames: the route, the
    time from CUDA-graph replays and eager, plain's, the bound (the
    FFT's)."""
    stft = STFT(512, 128, fading='full', complex_representation='stacked')
    spec, mask = istft_inputs(n_rows, frames, seed=frames)
    before = dict(masked_istft.routes)
    got = masked_istft(spec, mask, stft=stft)
    want = masked_istft_plain(spec, mask, stft=stft)
    torch.cuda.synchronize()
    took = [name for name in before
            if masked_istft.routes[name] != before[name]]
    err = max_err([got], [want])

    def kernel():
        return masked_istft(spec, mask, stft=stft)

    graph = graph_ms(kernel, iters=20)
    eager = cuda_ms(kernel, iters=20, warmup=3)
    plain_ms = cuda_ms(lambda: masked_istft_plain(spec, mask, stft=stft),
                       iters=20)
    limit = bound(nbytes(spec, mask, got) + 512 * 8 + 512 * 4,
                  fft_flops(n_rows, frames, 512, 512))
    print(f'phase {phase} masked_istft {label}: route {took}, max |kernel - '
          f'plain| {err:.3e} (tol {ISTFT_TOL}); from CUDA-graph replays '
          f'{graph:.4f} ms, eager {eager:.4f} ms, plain {plain_ms:.4f} ms, '
          f'bound {limit["bound_ms"]:.4f} ms by {limit["bound_by"]}')
    if took != ['fft'] or not err <= ISTFT_TOL:
        fail(f'masked_istft at {label}: route {took}, error {err}')
    return {'shape': label, 'max_abs_err': err, 'ms': graph,
            'eager_ms': eager, 'plain_ms': plain_ms, **limit,
            'library_ms': None}


def train_recipe(phase, name, trainer, train, dev, metric):
    """``test_run``, then ``Trainer.train`` with a validation hook on
    ``metric`` and a :class:`Recorder`, on the card; returns the
    recorder's losses and norms, the iterations and the launches of the
    LSTM kernels over the training."""
    start = time.perf_counter()
    trainer.test_run(train, dev)
    print(f'phase {phase}a {name} test_run passed on the card in '
          f'{time.perf_counter() - start:.2f} s')
    recorder = Recorder()
    trainer.register_hook(recorder)
    trainer.register_validation_hook(dev, metric=metric)
    reset_launches()
    start = time.perf_counter()
    trainer.train(train)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = dict(lstm_cell_scan.launches)
    losses = [float(x) for x in recorder.losses]
    norms = [float(x) for x in recorder.norms]
    iterations = trainer.iteration
    print(f'phase {phase}b {name} trained {iterations} iterations in '
          f'{seconds:.2f} s (validations and checkpoints included), lstm '
          f'launches {launches}; losses {[round(x, 4) for x in losses]}')
    if iterations < 3 or len(losses) != iterations or not (
            np.isfinite(losses).all() and np.isfinite(norms).all()):
        fail(f'phase {phase} {name}: {iterations} iterations, losses '
             f'{losses}, norms {norms}')
    return losses, norms, iterations, launches


def check_launches(label, launches, want):
    if launches != with_zeros(launches, want):
        fail(f'{label}: launches {launches}, expected {want}')


def serve(label, requests, wrapper_counts):
    """``requests`` [(name, fn)], each called once as one request; returns
    the results, the latencies and ``wrapper_counts()`` read after."""
    reset_launches()
    results, latencies = [], []
    for _, fn in requests:
        start = time.perf_counter()
        results.append(fn())
        latencies.append((time.perf_counter() - start) * 1e3)
    torch.cuda.synchronize()
    counts = wrapper_counts()
    print(f'phase {label}: {len(requests)} requests, latency ms '
          f'{[round(x, 3) for x in latencies]} (median '
          f'{np.median(latencies):.3f}), launches {counts}')
    return results, latencies, counts


def convnet_width(model):
    separator = model.separator
    block = separator.conv_blocks[0][0]
    return (model.encoder.feature_size, model.encoder.window_length,
            separator.input_size, block.conv.in_channels,
            len(separator.conv_blocks[0]), len(separator.conv_blocks),
            type(block.input_conv.norm).__name__)


def phase_convtasnet():
    """Phase 33: the tasnet recipe's ``--variant convnet`` (Conv-TasNet)
    at full width: ``test_run`` and 4 iterations into a storage dir that
    loads back, the first step against the CPU, timed steps by stage at
    ragged 4 x 32000 and 4 x 16000, three requests.  No Pallas kernel is on
    this path: its convolutions are cuDNN's."""
    start_phase = time.perf_counter()
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        storage_dir = Path(tmp) / 'tasnet' / '1'
        config = tas_train.get_trainer_config(
            storage_dir, variant='convnet', updates={
                'stop_trigger': (1, 'epoch'),
                'summary_trigger': (4, 'iteration')})
        dump_config({'trainer': config}, storage_dir / 'config.json')
        trainer = Trainer.from_config(config)
        width = convnet_width(trainer.model)
        n_params = sum(p.numel() for p in trainer.model.parameters())
        print(f'phase 33 Conv-TasNet width (filters, filter length, N, H, '
              f'blocks, repeats, norm) {width}: {n_params} parameters')
        if width != CONVNET_WIDTH:
            fail(f'not the full-width Conv-TasNet: {width}')
        model_cpu = copy.deepcopy(trainer.model)
        trainer.to('cuda')
        train, dev = (tas_data.prepare_dataset(
            tas_data.synthetic_database(num_examples=n, seed=seed),
            batch_size=4, segment_length=8000, shuffle=False, prefetch=False)
            for n, seed in ((16, 0), (8, 1)))
        losses, norms, iterations, launches = train_recipe(
            33, 'convnet', trainer, train, dev, 'si-sdr')
        check_launches('phase 33 convnet training', launches, {})
        compare_first_step(
            '33c convnet', losses, norms,
            *first_step(model_cpu, next(iter(train)), tmp, 5.0, 'cpu',
                        config['loss_weights']),
            (CONVNET_STEP_RTOL, CONVNET_STEP_RTOL))
        names = check_storage_dir(storage_dir, iterations,
                                  'ckpt_best_si-sdr.ptt')
        loaded_cpu = TasNet.from_storage_dir(
            storage_dir, checkpoint_name='ckpt_best_si-sdr.ptt').eval()
        loaded = copy.deepcopy(loaded_cpu).to('cuda')
        print(f'phase 33d convnet storage dir {names} loads')
        examples = list(tas_data.synthetic_database(num_examples=3, seed=2))
        results, _, _ = serve('33e convnet served', [
            (e['example_id'],
             functools.partial(tas_evaluate.evaluate_example, loaded, e))
            for e in examples], lambda: {})
        for example_id, metrics in results:
            if not np.isfinite(metrics['output_si_sdr']).all():
                fail(f'{example_id}: bad output metrics {metrics}')
        _, ref = tas_evaluate.evaluate_example(loaded_cpu, examples[0])
        diff = float(np.abs(np.subtract(
            ref['output_si_sdr'], results[0][1]['output_si_sdr'])).max())
        print(f'phase 33e convnet {examples[0]["example_id"]} SI-SDR card vs '
              f'CPU: max |diff| {diff:.3e} dB (tol {SI_SDR_TOL})')
        if not diff <= SI_SDR_TOL:
            fail(f'Conv-TasNet SI-SDR on the card disagrees with the CPU: '
                 f'{diff}')
        with torch.no_grad():
            request = loaded.example_to_device(tas_data.post_batch_transform(
                [examples[0]]))
            forward_ms = cuda_ms(lambda: loaded(request), iters=5, warmup=2)
        print(f'phase 33e convnet model forward of one request '
              f'({examples[0]["observation"].shape[-1]} samples) '
              f'{forward_ms:.3f} ms')
        for samples in (32000, 16000):
            t = timed_step(trainer, tasnet_batch(4, samples, seed=1),
                           loss_key='si-sdr', wrapper=None)
            print(f'phase 33f convnet training step B=4 x {samples} samples: '
                  + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items()))
    print(f'phase 33 took {time.perf_counter() - start_phase:.1f} s')


def phase_or_pit():
    """Phase 34: the or_pit recipe at its defaults (a ``blstm`` DPRNN
    TasNet with 2 outputs, ``max_iterations=2``): ``test_run`` and 4
    iterations with launch counts, the first step against the CPU, a timed
    step at 4 x 32000, ``separate`` on three requests.  Returns the LSTM
    kernels' launches of the training and of the requests."""
    start_phase = time.perf_counter()
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        storage_dir = Path(tmp) / 'or_pit' / '1'
        config = orpit_train.get_trainer_config(storage_dir, {
            'stop_trigger': (1, 'epoch'),
            'summary_trigger': (4, 'iteration')})
        dump_config({'trainer': config}, storage_dir / 'config.json')
        trainer = Trainer.from_config(config)
        separator = trainer.model.separator
        width = (separator.encoder.feature_size,
                 separator.separator.input_size,
                 len(separator.separator.dprnn_blocks),
                 separator.separator.dprnn_blocks[0].intra_chunk_rnn.rnn
                 .hidden_size, separator.num_speakers,
                 trainer.model.max_iterations)
        if width != (256, 64, 6, 128, 2, 2):
            fail(f'not the recipe\'s OR-PIT: {width}')
        model_cpu = copy.deepcopy(trainer.model)
        trainer.to('cuda')
        train, dev = (tas_data.prepare_dataset(
            tas_data.synthetic_database(num_examples=n, seed=seed),
            batch_size=4, segment_length=8000, shuffle=False, prefetch=False)
            for n, seed in ((16, 0), (8, 1)))
        n_dev = len(list(dev))
        losses, norms, iterations, trained = train_recipe(
            34, 'or_pit', trainer, train, dev, 'loss')
        validations = trainer.epoch + 1
        check_launches('phase 34 or_pit training', trained, {
            'fwd': 12 * n_dev * validations, 'fwd_train': 12 * iterations,
            'bwd': 12 * iterations})
        compare_first_step(
            '34c or_pit', losses, norms,
            *first_step(model_cpu, next(iter(train)), tmp, 5.0, 'cpu'),
            (TASNET_STEP_RTOL, TASNET_STEP_RTOL))
        names = check_storage_dir(storage_dir, iterations,
                                  'ckpt_best_loss.ptt')
        loaded_cpu = OneAndRestPIT.from_storage_dir(storage_dir).eval()
        loaded = copy.deepcopy(loaded_cpu).to('cuda')
        print(f'phase 34d or_pit storage dir {names} loads')
        examples = list(tas_data.synthetic_database(num_examples=3, seed=2))
        results, _, served = serve('34e or_pit separate', [
            (e['example_id'],
             functools.partial(orpit_evaluate.evaluate_example, loaded, e))
            for e in examples], lambda: {
                'launches': dict(lstm_cell_scan.launches),
                'routes': {k: {r: n for r, n in v.items() if n}
                           for k, v in lstm_cell_scan.routes.items()
                           if any(v.values())}})
        check_launches('phase 34 or_pit separate', served['launches'],
                       {'fwd': 12 * len(examples)})
        for example_id, metrics in results:
            if not np.isfinite(metrics['output_si_sdr']).all():
                fail(f'{example_id}: bad output metrics {metrics}')
        _, ref = orpit_evaluate.evaluate_example(loaded_cpu, examples[0])
        diff = float(np.abs(np.subtract(
            ref['output_si_sdr'], results[0][1]['output_si_sdr'])).max())
        print(f'phase 34e or_pit {examples[0]["example_id"]} SI-SDR card vs '
              f'CPU: max |diff| {diff:.3e} dB (tol {SI_SDR_TOL})')
        if not diff <= SI_SDR_TOL:
            fail(f'OR-PIT SI-SDR on the card disagrees with the CPU: {diff}')
        t = timed_step(trainer, tasnet_batch(4, 32000, seed=1),
                       loss_key=None, wrapper=lstm_cell_scan, per_step=12)
        print(f'phase 34f or_pit training step B=4 x 32000 samples: '
              + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items()))
    print(f'phase 34 took {time.perf_counter() - start_phase:.1f} s')
    return trained, served['launches']


def without_dropout(model):
    for module in model.modules():
        if isinstance(module, torch.nn.Dropout):
            module.p = 0.0
    return model


def phase_mask_estimator():
    """Phase 35: the mask estimator (``num_units=1024``: a BLSTM of 2 x 256
    units on 257 bins): the three LSTM kernels and the Function against
    plain at its shape (4 rows a direction, the 4 examples of 16000 samples
    of a training batch or the 4 channels of a request, and a ragged
    batch), ``masked_istft`` at a request's (one signal); the recipe's
    ``test_run``, 4 iterations, the first step against the CPU (dropout
    off on both), a timed step; ``evaluate_example`` on the synthetic
    4-channel database with both beamformers.  Returns the kernel rows
    and the launches of the training and of the requests."""
    start_phase = time.perf_counter()
    stft = me_train._stft
    frames = stft.samples_to_frames(16000)
    kernel_rows = {}
    for kind, what in (('full', '4 x 16000 samples or 4 channels'),
                       ('ragged', 'ragged')):
        label = f'T={frames} D*B=8 H=256 {what}'
        kernel_rows[label] = lstm_kernels_case('35a', label, frames, 4, 256,
                                               kind, in_size=257)
        torch.cuda.empty_cache()
    istft_row = istft_case('35a', f'one signal, T={frames} F=257', 1, frames)
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        storage_dir = Path(tmp) / 'mask_estimator' / '1'
        config = me_train.get_trainer_config(storage_dir, epochs=1)
        config['summary_trigger'] = (4, 'iteration')
        dump_config({'trainer': config}, storage_dir / 'config.json')
        trainer = Trainer.from_config(config)
        model = trainer.model
        width = (model.num_features, model.blstm.hidden_size,
                 model.blstm.num_layers, model.lin1.out_features,
                 model.drop1.p)
        if width != (257, 256, 1, 1024, 0.5):
            fail(f'not the recipe\'s mask estimator: {width}')
        model_cpu = copy.deepcopy(model)
        trainer.to('cuda')
        train_ds = me_train.synthetic_database(num_examples=16)
        train = me_train.prepare_dataset(train_ds, 4, shuffle=False)
        dev = me_train.prepare_dataset(
            me_train.synthetic_database(num_examples=8, seed=1), 4,
            shuffle=False)
        n_dev = len(list(dev))
        losses, norms, iterations, trained = train_recipe(
            35, 'mask estimator', trainer, train, dev, 'loss')
        validations = trainer.epoch + 1
        check_launches('phase 35 mask estimator training', trained, {
            'fwd': n_dev * validations, 'fwd_train': iterations,
            'bwd': iterations})
        batch = next(iter(train))
        card = first_step(without_dropout(copy.deepcopy(model_cpu)), batch,
                          tmp, 10.0, 'cuda')
        compare_first_step(
            '35c mask estimator (dropout off)', [card[0]], [card[1]],
            *first_step(without_dropout(model_cpu), batch, tmp, 10.0, 'cpu'),
            (MASK_ESTIMATOR_STEP_RTOL, MASK_ESTIMATOR_STEP_RTOL))
        names = check_storage_dir(storage_dir, iterations,
                                  'ckpt_best_loss.ptt')
        loaded_cpu = SimpleMaskEstimator.from_storage_dir(storage_dir).eval()
        loaded = copy.deepcopy(loaded_cpu).to('cuda')
        print(f'phase 35d mask estimator storage dir {names} loads')
        examples = list(me_evaluate.synthetic_multichannel_database())
        spec = np.asarray(stft(examples[0]['observation']))   # (C, T, F)
        features = {'observation_abs': np.abs(spec).astype('float32'),
                    'num_frames': np.full(spec.shape[0], spec.shape[1],
                                          'int32')}
        with torch.no_grad():
            masks = [model(model.example_to_device(features))[
                'speech_mask_prediction'].cpu()
                for model in (loaded, loaded_cpu)]
        mask_err = float((masks[0] - masks[1]).abs().max())
        print(f'phase 35e mask estimator {examples[0]["example_id"]} '
              f'({spec.shape[0]} channels, {spec.shape[1]} frames) speech '
              f'masks card vs CPU: max |diff| {mask_err:.3e} (tol '
              f'{MASK_ESTIMATOR_MASK_TOL})')
        if not mask_err <= MASK_ESTIMATOR_MASK_TOL:
            fail(f'phase 35: the masks on the card disagree with the CPU: '
                 f'{mask_err}')
        served = {}
        for beamformer in ('mvdr_souden', 'gev'):
            results, _, counts = serve(
                f'35e mask estimator evaluate_example, {beamformer}', [
                    (e['example_id'], functools.partial(
                        me_evaluate.evaluate_example, loaded, stft, e,
                        beamformer=beamformer))
                    for e in examples], lambda: {
                        'lstm': dict(lstm_cell_scan.launches),
                        'masked_istft': masked_istft.launches,
                        'masked_istft_routes': dict(masked_istft.routes)})
            check_launches(f'phase 35 {beamformer} requests', counts['lstm'],
                           {'fwd': len(examples)})
            if counts['masked_istft'] != len(examples) \
                    or counts['masked_istft_routes']['fft'] != len(examples):
                fail(f'phase 35 {beamformer}: masked_istft launches '
                     f'{counts}, expected {len(examples)} on the fft route')
            for key, value in counts.items():
                if key == 'lstm':
                    value = value['fwd']
                elif key == 'masked_istft_routes':
                    continue
                served[key] = served.get(key, 0) + value
            for example_id, metrics in results:
                values = [v for kind in metrics.values()
                          for v in kind.values()]
                if len(values) != 9 or not np.isfinite(values).all():
                    fail(f'{example_id}: bad metric triples {metrics}')
            print(f'phase 35e {beamformer} metric triples: '
                  + json.dumps(dict(results)))
            _, ref = me_evaluate.evaluate_example(
                loaded_cpu, stft, examples[0], beamformer=beamformer)
            got = results[0][1]
            diff = {f'{kind} {metric}': abs(got[kind][metric] - value)
                    for kind, triple in ref.items()
                    for metric, value in triple.items()}
            held = {key: value for key, value in diff.items()
                    if beamformer == 'mvdr_souden'
                    or not key.startswith('beamformed')}
            print(f'phase 35e {beamformer} {examples[0]["example_id"]} '
                  f'metrics card vs CPU: |diff| '
                  + ', '.join(f'{k} {v:.3e}' for k, v in diff.items())
                  + f' (tol {MASK_ESTIMATOR_METRIC_TOL} on '
                  f'{sorted(held)})')
            for key, value in held.items():
                if not value <= MASK_ESTIMATOR_METRIC_TOL:
                    fail(f'phase 35 {beamformer} {key}: card vs CPU {value}')
        t = timed_step(trainer, batch, loss_key=None, wrapper=lstm_cell_scan,
                       per_step=1)
        print(f'phase 35f mask estimator training step B=4 x {frames} '
              f'frames: ' + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items()))
    print(f'phase 35 took {time.perf_counter() - start_phase:.1f} s')
    return kernel_rows, istft_row, trained, served


def phase_deep_clustering():
    """Phase 36: ``DeepClusteringModel`` (F=257, 2 x 600 BLSTM, E=20) on 4
    of the pit recipe's synthetic mixtures, ``target_mask`` the ideal
    binary masks of their speakers' STFTs: the served embeddings and the
    first Adam step (clip 10) against the CPU, timed steps.  Returns the
    LSTM kernels' launches of one served batch and one step."""
    start_phase = time.perf_counter()
    torch.manual_seed(0)
    model_cpu = DeepClusteringModel()
    width = (model_cpu.F, model_cpu.blstm.hidden_size,
             model_cpu.blstm.num_layers, model_cpu.E)
    if width != (257, 600, 2, 20):
        fail(f'not the deep-clustering model\'s defaults: {width}')
    examples = list(pit_data.synthetic_database(num_examples=4, seed=3))
    batch = pit_data.post_batch_transform(
        [pit_data.pre_batch_transform(e) for e in examples])
    x_abs = batch['X_abs']                                  # (B, T, K, F)
    batch = {'Y_abs': batch['Y_abs'], 'num_frames': batch['num_frames'],
             'target_mask': (x_abs == x_abs.max(axis=2, keepdims=True))
             .astype('float32')}
    shape = f'B=4 T={batch["Y_abs"].shape[1]} (frames {batch["num_frames"]})'
    model = copy.deepcopy(model_cpu).to('cuda').eval()
    reset_launches()
    with torch.no_grad():
        got = model(model.example_to_device(batch))
        torch.cuda.synchronize()
        served = dict(lstm_cell_scan.launches)
        want = model_cpu.eval()(model_cpu.example_to_device(batch))
    err = float((got.cpu() - want).abs().max())
    print(f'phase 36a deep clustering {shape}: embeddings card vs CPU max '
          f'|diff| {err:.3e} (tol {DC_TOL}), launches {served}')
    check_launches('phase 36 served', served, {'fwd': 2})
    if tuple(got.shape) != (4, batch['Y_abs'].shape[1], 20, 257) \
            or not err <= DC_TOL:
        fail(f'deep-clustering embeddings on the card disagree with the '
             f'CPU: {err}')
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        card = first_step(copy.deepcopy(model_cpu), batch, tmp, 10.0, 'cuda')
        torch.cuda.synchronize()
        trained = dict(lstm_cell_scan.launches)
        check_launches('phase 36 training step', trained,
                       {'fwd_train': 2, 'bwd': 2})
        compare_first_step('36b deep clustering', [card[0]], [card[1]],
                           *first_step(model_cpu, batch, tmp, 10.0, 'cpu'),
                           (DC_STEP_RTOL, DC_STEP_RTOL))
        trainer = Trainer(model.train(), Path(tmp) / 'timed',
                          Adam(gradient_clipping=10.0))
        t = timed_step(trainer, batch, loss_key='dc_loss',
                       wrapper=lstm_cell_scan, per_step=2)
        print(f'phase 36c deep clustering training step {shape}: '
              + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items()))
    print(f'phase 36 took {time.perf_counter() - start_phase:.1f} s')
    return served, trained


# ---- phase 37: the speech-recognition family ----------------------------
# the first ASR step, card vs CPU: a mean of per-token lattice (CTC,
# transducer) or cross-entropy losses, and the norm of 0.4 to 0.6 M
# gradients through two conformer layers (the attention on the kernels'
# 3xTF32 products, the batch norm's and the lattice's sums in another
# order)
ASR_STEP_RTOL = 1e-4
# a request's encoder frames, card vs CPU: two conformer layers in eval
# mode, the attention kernels against the CPU's dense float32 path
ASR_ENCODER_TOL = 1e-4
# the two best scores of a greedy choice closer than this: a difference
# within the limits above may change the choice there
ASR_TIE = 1e-3
# the recipe's width: d_model, layers, heads, kernel, vocabulary, batch
ASR_WIDTH = (96, 2, 4, 15, 10)
ASR_LENS = [32, 30, 27, 25, 22, 19, 16, 12]
# (label, B, H, Hkv, Tq, Tk, D, masks, timed): the conformer's
# self-attention at the recipe's widest batch (8 utterances padded to 128
# STFT frames, T' = 32 after the 4x subsampling; the batches hold 96 or
# 128) and at a 10 s request (T' about 165: more than one 64-key tile),
# and the attention decoder's causal self-attention and cross-attention
# (U + 1 = 9 positions over T' = 32 frames); heads of 24, which the
# wrapper pads to 32
ASR_ATTENTION_CASES = [
    ('conformer (8, 4, 32, 24) ragged', 8, 4, 4, 32, 32, 24,
     {'key_padding_lens': ASR_LENS}, True),
    ('conformer (8, 4, 32, 24) causal, ragged', 8, 4, 4, 32, 32, 24,
     {'causal': True, 'key_padding_lens': ASR_LENS}, True),
    ('conformer (8, 4, 32, 24) window (16, 16), ragged', 8, 4, 4, 32, 32,
     24, {'window': (16, 16), 'key_padding_lens': ASR_LENS}, True),
    ('conformer request (1, 4, 165, 24)', 1, 4, 4, 165, 165, 24, {}, True),
    ('conformer request (1, 4, 165, 24) causal', 1, 4, 4, 165, 165, 24,
     {'causal': True}, True),
    ('decoder self (8, 4, 9, 24) causal', 8, 4, 4, 9, 9, 24,
     {'causal': True}, True),
    ('decoder cross (8, 4, 9 x 32, 24) ragged', 8, 4, 4, 9, 32, 24,
     {'key_padding_lens': ASR_LENS}, True),
]
# (label, T, rows): the transducer's prediction network, one direction of
# 96 units: a training batch's 8 label histories of U + 1 = 9, and the
# greedy decode's one history
ASR_LSTM_CASES = [
    ('prediction network T=9 rows=8 H=96 one direction', 9, 8),
    ('greedy decode T=5 rows=1 H=96 one direction', 5, 1),
]
# (head, causal): the trained runs of 37b
ASR_RUNS = [('ctc', False), ('ctc', True), ('transducer', False),
            ('aed', False)]
# attention launches a training step (or a forward) makes: one a conformer
# layer, and the attention decoder's self- and cross-attention per layer
ASR_ATTENTION_PER_STEP = {'ctc': 2, 'transducer': 2, 'aed': 6}


def asr_width(model):
    encoder = model.acoustic.encoder
    return (encoder.d_model, len(encoder.layers),
            encoder.layers[0].self_attn.num_heads,
            encoder.layers[0].conv.kernel_size, model.vocab_size)


def asr_launches():
    return {'attention': dict(flash_attention.launches),
            'lstm': dict(lstm_cell_scan.launches)}


def run_main(module, args):
    """``python -m module args`` in this process: the entry point a user
    calls, on the card (the recipes' default device)."""
    argv = sys.argv
    sys.argv = [module.__name__, *args]
    try:
        module.main()
    finally:
        sys.argv = argv


def check_asr_launches(label, head, launches, training, serving):
    """The kernels a head must launch, and nothing else: the attention
    forward keeping the LSE and the backward in ``training`` steps (in
    equal numbers, a multiple of the head's launches a step), the lean
    forward in ``serving`` (validation, requests); the LSTM kernels the
    same way for the transducer's prediction network only."""
    att, lstm = launches['attention'], launches['lstm']
    per_step = ASR_ATTENTION_PER_STEP[head]
    ok = (att['fwd_train'] == att['bwd'] and att['fwd_train'] % per_step == 0
          and all(v == 0 for k, v in att.items()
                  if k not in ('fwd', 'fwd_train', 'bwd')))
    ok = ok and (att['fwd_train'] > 0) == training \
        and (att['fwd'] > 0) == serving
    if head == 'transducer':
        ok = ok and lstm == with_zeros(lstm, {
            'fwd': lstm['fwd'], 'fwd_train': att['fwd_train'] // 2,
            'bwd': att['bwd'] // 2}) and (lstm['fwd'] > 0) == serving
    else:
        ok = ok and not any(lstm.values())
    if not ok:
        fail(f'{label}: kernel launches {launches} are not those of a '
             f'{head} head ({"training" if training else ""} '
             f'{"serving" if serving else ""})')


def phase_asr_kernels():
    """Phase 37a: the attention kernels (forward, forward keeping the LSE,
    backward) and the three float32 LSTM kernels of one direction at the
    speech-recognition path's shapes, against plain at phases 12's and 9's
    limits with their TF32 controls, timed beside plain, the library call
    and the bound; the LSTM grids the card takes beside the CPU mirror's."""
    attention = {case[0]: attention_case(*case, phase='37a')
                 for case in ASR_ATTENTION_CASES}
    lstm = {label: lstm_kernels_case('37a', label, t_len, rows, 96, None,
                                     in_size=96, directions=1)
            for label, t_len, rows in ASR_LSTM_CASES}
    return attention, lstm


def phase_asr_training(root):
    """Phase 37b: the recipe's ``train.py`` on the card at its defaults
    (d_model 96, 2 layers, 4 heads, kernel 15, batches of 8, 10 tokens;
    48 synthetic utterances, one epoch: ``test_run``, 5 iterations,
    validation, checkpoints) for the CTC, transducer and attention heads
    and the causal CTC variant, with the kernels' launches; the first
    step of each against the CPU on the same batch and weights; a timed
    step by stage.  Returns the storage dirs and the launches."""
    dirs, launches = {}, {}
    train_ds, _ = asr_train.synthetic_split(48, 8)
    batch = next(iter(asr_data.prepare_dataset(
        train_ds, batch_size=8, shuffle=False, prefetch=False)))
    for head, causal in ASR_RUNS:
        name = head + (' causal' if causal else '')
        storage_root = Path(root) / name.replace(' ', '_')
        args = ['--storage_root', str(storage_root), '--synthetic',
                '--epochs', '1', '--num_examples', '48', '--model', head]
        reset_launches()
        start = time.perf_counter()
        run_main(asr_train, args + (['--causal'] if causal else []))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches[name] = asr_launches()
        storage_dir = storage_root / 'ctc_asr' / '1'
        check_storage_dir(storage_dir, 5, 'ckpt_best_loss.ptt')
        check_asr_launches(f'phase 37b {name} training', head,
                           launches[name], training=True, serving=True)
        model = asr_evaluate.load_model(storage_dir)
        if asr_width(model) != ASR_WIDTH or model.causal != causal:
            fail(f'phase 37b {name}: not the recipe\'s width '
                 f'{asr_width(model)}')
        dirs[name] = storage_dir
        print(f'phase 37b {name}: train.py (test_run, 5 iterations, '
              f'validation, checkpoints) on the card in {seconds:.2f} s, '
              f'{sum(p.numel() for p in model.parameters())} parameters, '
              f'launches {launches[name]}')
        # the first step, card vs CPU, on the same batch and weights (the
        # SpecAugment masks drawn from the same seed)
        torch.manual_seed(0)
        model_cpu = Trainer.from_config(asr_train.get_trainer_config(
            Path(root) / 'first', head, causal=causal)).model
        torch.manual_seed(1)
        card = first_step(copy.deepcopy(model_cpu), batch, root, 10.0,
                          'cuda')
        torch.manual_seed(1)
        compare_first_step(f'37b {name}', [card[0]], [card[1]],
                           *first_step(model_cpu, batch, root, 10.0, 'cpu'),
                           (ASR_STEP_RTOL, ASR_STEP_RTOL))
        if causal:
            continue
        trainer = Trainer(model.train(), Path(root) / f'timed_{head}',
                          Adam(gradient_clipping=10.0))
        t = timed_step(trainer, batch, loss_key=None,
                       wrapper=flash_attention,
                       per_step=ASR_ATTENTION_PER_STEP[head])
        print(f'phase 37b {head} training step B=8 T\'='
              f'{(batch["stft"].shape[2] + 3) // 4}: '
              + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items()))
    return dirs, launches


def recorded_joint(model):
    """Keep the scores of every call of a transducer's joint (greedy
    decoding: one frame, one history a call)."""
    scores = []
    joint = type(model)._joint

    def wrapped(enc, pred):
        out = joint(model, enc, pred)
        scores.append(out.reshape(-1).detach().cpu())
        return out

    model._joint = wrapped
    return scores


def greedy_near_tie(scores_a, scores_b):
    """Two runs of one greedy decoding part where their choices part: the
    two best scores of the first differing choice closer than
    ``ASR_TIE`` in either run."""
    for a, b in zip(scores_a, scores_b):
        if int(a.argmax()) != int(b.argmax()):
            return any(bool(near_ties(s, ASR_TIE)) for s in (a, b))
    return False


def aed_near_tie(model, enc, mem_len, a, b):
    """Where two token sequences of the attention head part, the two best
    teacher-forced logits of the first differing position closer than
    ``ASR_TIE``."""
    n = min(len(a), len(b))
    j = next((i for i in range(n) if a[i] != b[i]), n)
    prefix = torch.tensor([[model.bos] + list(a[:j])], device=enc.device)
    with torch.no_grad():
        h = model.decoder(model.embed(prefix), enc[None],
                          memory_seq_len=torch.tensor([mem_len],
                                                      device=enc.device))
        return bool(near_ties(model.head(h[0, -1]), ASR_TIE))


def hypotheses(results):
    return {k: v['hypothesis'] for k, v in results.items()}


def stream_against_offline(model, request, weights):
    """A causal transducer's ``stream_decode`` of one request in chunks of
    8 frames against its offline greedy ``decode`` of the same frames:
    equal, or parted at a near tie.  Returns the stream's launches."""
    t_in = int(request['seq_len'][0]) // 8 * 8
    offline_batch = {**request, 'stft': request['stft'][:, :, :t_in],
                     'seq_len': np.asarray([t_in], 'int32')}
    scores = recorded_joint(model)
    offline = list(hypotheses(model.decode(offline_batch)).values())[0]
    offline_scores, scores[:] = list(scores), []
    reset_launches()
    start = time.perf_counter()
    streamed = model.stream_decode(
        [request['stft'][0, 0, s:s + 8] for s in range(0, t_in, 8)],
        max_frames=t_in)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = asr_launches()
    del model._joint
    tie = streamed != offline and greedy_near_tie(offline_scores, scores)
    print(f'phase 37c causal transducer ({weights} weights) stream_decode '
          f'({t_in // 8} chunks of 8 frames) in {seconds * 1e3:.1f} ms: '
          f'{len(streamed)} tokens {streamed} vs offline greedy {offline} '
          f'(equal: {streamed == offline}, at a near tie: {tie}), launches '
          f'{counts}')
    if streamed != offline and not tie:
        fail('phase 37c: stream_decode differs from the offline greedy '
             'decode without a near tie')
    if not len(streamed) <= counts['lstm']['fwd'] <= len(streamed) + 1 \
            or any(counts['attention'].values()):
        fail(f'phase 37c: stream_decode runs the prediction network once '
             f'per emitted symbol and the encoder on the dense decode path, '
             f'launched {counts}')
    return counts


def phase_asr_serving(dirs):
    """Phase 37c: the recipe's ``evaluate.py`` on the card for each head
    (8 held-out requests, ``eval/means.json``): CTC greedy and beam 4 with
    an n-gram LM (``--lm_order 2``), transducer and attention head greedy
    and beam 4; then each head's requests one at a time, the latency on
    the host clock beside the encoder forward (CUDA events); the attention
    head's ``serve_decode`` equal to its greedy ``decode``; a causal
    transducer's ``stream_decode`` equal to its offline greedy transcript;
    a request of 50 to 60 tokens (about 10 s) on the card against the CPU.
    Returns the launches of the requests."""
    launches = {}
    for name, extra in (('ctc', []),
                        ('ctc', ['--beam_width', '4', '--lm_order', '2']),
                        ('transducer', []),
                        ('transducer', ['--beam_width', '4']),
                        ('aed', []), ('aed', ['--beam_width', '4'])):
        label = f'{name} {" ".join(extra) or "greedy"}'
        reset_launches()
        start = time.perf_counter()
        run_main(asr_evaluate, ['--model_path', str(dirs[name]),
                                '--synthetic', '--num_examples', '8',
                                *extra])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches[f'evaluate {label}'] = asr_launches()
        check_asr_launches(f'phase 37c evaluate {label}', name,
                           launches[f'evaluate {label}'], training=False,
                           serving=True)
        means = json.loads((dirs[name] / 'eval' / 'means.json').read_text())
        if means['num_examples'] != 8 or not all(
                np.isfinite(means[k]) for k in ('wer', 'ser')):
            fail(f'phase 37c evaluate {label}: {means}')
        print(f'phase 37c evaluate.py {label}: 8 requests in {seconds:.2f} '
              f's, wer {means["wer"]:.4f}, ser {means["ser"]:.4f}, '
              f'launches {launches[f"evaluate {label}"]}')
    requests = list(asr_data.prepare_dataset(
        asr_data.synthetic_database(num_examples=8, seed=1), batch_size=1,
        shuffle=False, prefetch=False))
    lm = NGramLM(order=2).fit([ex['labels'] for ex in
                               asr_data.synthetic_database(96)])
    for name, beam in (('ctc', None), ('ctc', 4), ('transducer', None),
                       ('transducer', 4), ('aed', None), ('aed', 4)):
        model = asr_evaluate.load_model(dirs[name])
        kwargs = {'lm_fn': lm} if name == 'ctc' and beam else {}
        label = f'37c {name} {"greedy" if beam is None else f"beam {beam}"}'
        _, latencies, counts = serve(label, [
            (r['example_id'][0], functools.partial(
                model.decode, r, beam_width=beam, **kwargs))
            for r in requests], asr_launches)
        launches[label] = counts
        check_asr_launches(f'phase {label}', name, counts, training=False,
                           serving=True)
        with torch.no_grad():
            encoder = [cuda_ms(functools.partial(model._encode, r), iters=3)
                       for r in requests]
        print(f'phase {label}: latency per request median '
              f'{np.median(latencies):.3f} ms (host clock), the encoder '
              f'forward median {np.median(encoder):.3f} ms (CUDA events)')
    # the attention head's continuous batching equals its greedy decode
    model = asr_evaluate.load_model(dirs['aed'])
    batch = next(iter(asr_data.prepare_dataset(
        asr_data.synthetic_database(num_examples=8, seed=1), batch_size=8,
        shuffle=False, prefetch=False)))
    reset_launches()
    served = hypotheses(model.serve_decode(batch, num_slots=4))
    launches['37c aed serve_decode'] = asr_launches()
    greedy = hypotheses(model.decode(batch))
    with torch.no_grad():
        enc, enc_len = model._encode(batch)
    parted = [i for i, k in enumerate(batch['example_id'])
              if served[k] != greedy[k]]
    ties = [aed_near_tie(model, enc[i], int(enc_len[i]),
                         served[batch['example_id'][i]],
                         greedy[batch['example_id'][i]]) for i in parted]
    print(f'phase 37c aed serve_decode (4 slots, 8 requests) equals the '
          f'greedy decode on {8 - len(parted)} of 8 requests (the others at '
          f'near ties: {ties}), launches {launches["37c aed serve_decode"]}')
    if not all(ties):
        fail(f'phase 37c: serve_decode differs from the greedy decode '
             f'without a near tie: {served} vs {greedy}')
    # a causal transducer streamed: the trained weights with causal masks,
    # and the same model from its initial weights (whose random joint
    # emits symbols at most frames, where the trained one's few steps
    # emit mostly blanks)
    trained = asr_evaluate.load_model(dirs['transducer'])
    device = next(trained.parameters()).device
    config = json.loads((dirs['transducer'] / 'config.json').read_text())
    config = {**config['trainer']['model'], 'causal': True}
    torch.manual_seed(0)
    initial = asr_model.TransducerASR.from_config(config)
    causal = asr_model.TransducerASR.from_config(config)
    causal.load_state_dict(trained.state_dict())
    for weights, model in (('trained', causal), ('initial', initial)):
        model = model.to(device).eval()
        for request in requests[:2]:
            launches[f'37c stream_decode {weights} '
                     f'{request["example_id"][0]}'] = \
                stream_against_offline(model, request, weights)
    launches.update(asr_long_request(dirs))
    return launches


def asr_long_request(dirs):
    """A request of 50 to 60 tokens (about 10 s, T' about 165) through
    each head's greedy decode on the card and on the CPU: the encoder
    frames within ``ASR_ENCODER_TOL``, the transcripts equal but at near
    ties; latency and launches."""
    request = next(iter(asr_data.prepare_dataset(
        asr_data.synthetic_database(num_examples=1, min_tokens=50,
                                    max_tokens=60, seed=3),
        batch_size=1, shuffle=False, prefetch=False)))
    tokens = int(request['label_lengths'][0])
    launches = {}
    for name in ('ctc', 'transducer', 'aed'):
        model = asr_evaluate.load_model(dirs[name])
        model_cpu = asr_evaluate.load_model(dirs[name], device='cpu')
        with torch.no_grad():
            enc, enc_len = model._encode(request)
            enc_cpu, _ = model_cpu._encode(request)
        err = float((enc.cpu() - enc_cpu).abs().max())
        if name == 'transducer':
            scores, scores_cpu = recorded_joint(model), recorded_joint(
                model_cpu)
        reset_launches()
        start = time.perf_counter()
        got = list(hypotheses(model.decode(request)).values())[0]
        torch.cuda.synchronize()
        latency = (time.perf_counter() - start) * 1e3
        launches[f'37c {name} long request'] = counts = asr_launches()
        want = list(hypotheses(model_cpu.decode(request)).values())[0]
        tie = False
        if got != want:
            if name == 'transducer':
                tie = greedy_near_tie(scores, scores_cpu)
            elif name == 'aed':
                tie = aed_near_tie(model, enc[0], int(enc_len[0]), got, want)
            else:
                with torch.no_grad():
                    tie = bool(near_ties(model.head(enc[0, :int(enc_len[0])]),
                                         ASR_TIE).any())
        if name == 'transducer':
            del model._joint, model_cpu._joint
        print(f'phase 37c {name} request of {tokens} tokens, '
              f'{request["stft"].shape[2]} frames (T\'={int(enc_len[0])}): '
              f'latency {latency:.2f} ms (host clock), encoder card vs CPU '
              f'max |diff| {err:.3e} (tol {ASR_ENCODER_TOL}), transcript '
              f'equal to the CPU\'s: {got == want} (at a near tie: {tie}), '
              f'{len(got)} tokens, launches {counts}')
        if not 50 <= tokens <= 60 or not err <= ASR_ENCODER_TOL:
            fail(f'phase 37c {name} long request: {tokens} tokens, encoder '
                 f'error {err}')
        if got != want and not tie:
            fail(f'phase 37c {name} long request: the card\'s transcript '
                 f'differs from the CPU\'s without a near tie')
        check_asr_launches(f'phase 37c {name} long request', name, counts,
                           training=False, serving=True)
    return launches


def phase_asr():
    """Phase 37: the speech-recognition family (37a kernels, 37b training,
    37c serving).  Returns the kernel rows and the launches of the main
    paths: {'attention': {...}, 'lstm': {...}} summed over 37b's training
    runs and 37c's requests."""
    start_phase = time.perf_counter()
    attention_rows, lstm_rows = phase_asr_kernels()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        dirs, trained = phase_asr_training(root)
        served = phase_asr_serving(dirs)
    totals = {'attention': {}, 'lstm': {}}
    for counts in (*trained.values(), *served.values()):
        for kernel, by_name in counts.items():
            for key, n in by_name.items():
                totals[kernel][key] = totals[kernel].get(key, 0) + n
    print(f'phase 37 launches on its main paths: {totals} (training '
          f'{trained}; serving {served})')
    for kernel, names in (('attention', ('fwd', 'fwd_train', 'bwd')),
                          ('lstm', ('fwd', 'fwd_train', 'bwd'))):
        for key in names:
            if totals[kernel][key] == 0:
                fail(f'phase 37 never launched the {kernel} {key} kernel')
    print(f'phase 37 took {time.perf_counter() - start_phase:.1f} s')
    return attention_rows, lstm_rows, totals


# the distance estimator's GRU: one direction over a batch of 8 scenes, 64
# units; 8000 samples give 128 frames at shift 64, which the recipe's
# CNN2d pools to 32 steps (32 channels x 32 bins into the GRU), and 128
# steps as a longer scene would give:
# (label, T, rows, H, mask kind, width of the layer's input)
DISTANCE_GRU_SHAPES = [
    ('distance estimator T=32 D*B=8 H=64 one direction', 32, 8, 64,
     'ragged', 1024),
    ('distance estimator T=128 D*B=8 H=64 one direction', 128, 8, 64,
     'ragged', 1024),
]


def kernel_launches():
    """The launch count of every kernel of the port, by wrapper (and by
    kernel for the wrappers of several); zero counts left out."""
    counts = {'lstm': dict(lstm_cell_scan.launches),
              'gru': dict(gru_cell_scan.launches),
              'attention': dict(flash_attention.launches),
              'masked_istft': masked_istft.launches,
              'fused_logmel': fused_logmel.launches,
              'wavenet_sample': wavenet_sample.launches,
              'int8_matmul': int8_matmul.launches}
    out = {}
    for wrapper, n in counts.items():
        if isinstance(n, dict):
            n = {k: v for k, v in n.items() if v}
        if n:
            out[wrapper] = n
    return out


def audio_reader_times(root):
    """``AudioReader``'s time per file on the host: 4 s of audio written
    as int16 mono, stereo int16, int32 and 8 kHz int16 (resampled to 16
    kHz); the median of 20 reads each on one thread, and the mean over
    four threads reading 80 files together."""
    from concurrent.futures import ThreadPoolExecutor
    rng = np.random.RandomState(0)
    audio = 0.3 * np.sin(2 * np.pi * 440 * np.arange(64000) / 16000) \
        + 0.05 * rng.randn(64000)
    files = {
        'int16': wav_dbs.write_wav(root / 'int16.wav', audio, 16000),
        'stereo': wav_dbs.write_wav(root / 'stereo.wav',
                                    np.stack([audio, audio], 1), 16000),
        'int32': wav_dbs.write_wav(root / 'int32.wav', audio, 16000,
                                   'int32'),
        '8khz': wav_dbs.write_wav(root / '8khz.wav', audio[::2], 8000),
    }
    reader = AudioReader()
    times = {}
    for kind, path in files.items():
        reader({'audio_path': path})
        reads = []
        for _ in range(20):
            start = time.perf_counter()
            reader({'audio_path': path})
            reads.append((time.perf_counter() - start) * 1e3)
        times[kind] = float(np.median(reads))
    paths = [files['int16']] * 80
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda p: reader({'audio_path': p}), paths[:8]))
        start = time.perf_counter()
        list(pool.map(lambda p: reader({'audio_path': p}), paths))
        times['int16, 4 threads'] = (time.perf_counter() - start) * 1e3 / 80
    return times


def write_real_audio(root):
    """Phase 38a: the WAV trees and JSON databases; returns their paths."""
    root = Path(root)
    dbs = {
        'wsj0_2mix': wav_dbs.write_wsj0_2mix(root, (6, 4, 3),
                                             min_samples=16000),
        'librispeech': wav_dbs.write_librispeech(root, min_samples=16000),
        'audioset': wav_dbs.write_audioset(root, min_samples=16000),
    }
    run_main(de_create_jsons, ['--synthetic', str(root / 'rir_tree'),
                               '--out', str(root / 'rirs.json')])
    dbs['rirs'] = root / 'rirs.json'
    sizes = {}
    for name, path in dbs.items():
        db = JsonDatabase(path)
        sizes[name] = {split: len(db.get_dataset(split))
                       for split in db.dataset_names}
    kinds = {}
    for path in sorted(root.rglob('*.wav')):
        from scipy.io import wavfile
        sr, data = wavfile.read(path)
        kind = f'{data.dtype} {"stereo" if data.ndim == 2 else "mono"} {sr}'
        kinds[kind] = kinds.get(kind, 0) + 1
    return dbs, sizes, kinds


def check_recipe_dir(label, storage_dir, database=None):
    """``config.json``, the latest checkpoint and the ``Makefile``, whose
    ``evaluate`` target names the database the training read."""
    for name in ('config.json', 'Makefile', 'checkpoints/ckpt_latest.ptt'):
        if not (storage_dir / name).exists():
            fail(f'{label}: {name} missing from {storage_dir}')
    makefile = (storage_dir / 'Makefile').read_text()
    if database is not None and f'--database {database}' not in makefile:
        fail(f'{label}: the Makefile does not name {database}:\n{makefile}')


def run_recipe(label, module, args):
    """``python -m module args`` on the card with the launch counts set to
    0 before and read after (the GRU backward's by route added to the
    main paths'); returns (launches, seconds)."""
    reset_launches()
    start = time.perf_counter()
    run_main(module, [str(a) for a in args])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = kernel_launches()
    add_main_bwd_routes()
    print(f'phase {label}: {module.__name__.split("examples.")[-1]} '
          f'{" ".join(str(a) for a in args[:1])}... on the card in '
          f'{seconds:.2f} s, launches {launches}')
    return launches, seconds


def means_of(path):
    return json.loads(Path(path).read_text())


def finite_numbers(tree):
    values = []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, (int, float)) and not isinstance(x, bool):
            values.append(float(x))
    walk(tree)
    return bool(values) and bool(np.isfinite(values).all())


def expect_launches(label, launches, required, allowed=()):
    """Each kernel of ``required`` ((wrapper, kernel or None)) launched,
    and nothing outside ``required`` and ``allowed``."""
    names = set(required) | set(allowed)
    for wrapper, kernel in required:
        n = launches.get(wrapper, {})
        n = n.get(kernel, 0) if kernel else n
        if not n:
            fail(f'{label}: no {wrapper} {kernel or ""} launch: {launches}')
    for wrapper, counts in launches.items():
        kernels = counts if isinstance(counts, dict) else {None: counts}
        for kernel in kernels:
            if (wrapper, kernel) not in names:
                fail(f'{label}: an unexpected {wrapper} {kernel} launch: '
                     f'{launches}')


def add_launches(total, launches):
    for wrapper, counts in launches.items():
        if isinstance(counts, dict):
            into = total.setdefault(wrapper, {})
            for kernel, n in counts.items():
                into[kernel] = into.get(kernel, 0) + n
        else:
            total[wrapper] = total.get(wrapper, 0) + counts


LSTM_ALL = [('lstm', 'fwd'), ('lstm', 'fwd_train'), ('lstm', 'bwd')]
GRU_ALL = [('gru', 'fwd'), ('gru', 'fwd_train'), ('gru', 'bwd')]


def phase_real_audio():
    """Phase 38: the recipes on WAV files (see the module docstring).
    Returns the GRU rows at the distance estimator's shapes, the launches
    of the recipe runs, added up by wrapper and kernel, and the vocoder
    request's sampler launches by route."""
    start_phase = time.perf_counter()
    if not native.NATIVE_AVAILABLE:
        fail('phase 38a: the native data prep (native/_dataprep.cpp) did '
             'not build: AudioReader would decode int16 in numpy')
    total = {}
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        dbs, sizes, kinds = write_real_audio(root / 'data')
        times = audio_reader_times(root)
        print(f'phase 38a databases {sizes}; WAV files by type, layout and '
              f'rate {kinds}; NATIVE_AVAILABLE {native.NATIVE_AVAILABLE}; '
              f'AudioReader ms per 4 s file on the host: '
              + ', '.join(f'{k} {v:.3f}' for k, v in times.items()))
        gru_rows = {label: gru_kernels_case('38b', label, t_len, batch, hdim,
                                            kind, 1, in_size)
                    for label, t_len, batch, hdim, kind, in_size
                    in DISTANCE_GRU_SHAPES}

        # 38c: uPIT on wsj0-2mix
        db = dbs['wsj0_2mix']
        launches, _ = run_recipe('38c', pit_train, [
            '--storage_root', root / 'exp', '--database', db, '--epochs', 1,
            '--batch_size', 2])
        expect_launches('38c pit train.py', launches, LSTM_ALL)
        add_launches(total, launches)
        storage_dir = root / 'exp' / 'pit' / '1'
        check_recipe_dir('38c pit', storage_dir, db)
        launches, _ = run_recipe('38c', pit_evaluate, [
            '--model_path', storage_dir, '--database', db, '--dataset',
            'mix_2_spk_min_tt'])
        expect_launches('38c pit evaluate.py', launches,
                        [('lstm', 'fwd'), ('masked_istft', None)])
        if masked_istft.routes != {'fft': launches['masked_istft'],
                                   'dft': 0}:
            fail(f'38c: the requests\' masked_istft launches did not all '
                 f'take the fft route: {masked_istft.routes}')
        add_launches(total, launches)
        result = means_of(storage_dir / 'eval' / 'result.json')
        if sorted(result) != [f'mix_2_spk_min_tt_{i}' for i in range(3)] \
                or not finite_numbers(result):
            fail(f'38c: pit evaluate.py results {result}')
        print(f'phase 38c pit means '
              f'{means_of(storage_dir / "eval" / "means.json")}')

        # 38d: the speaker classifier on LibriSpeech-style files
        db = dbs['librispeech']
        launches, _ = run_recipe('38d', spk_train, [
            '--storage_root', root / 'exp', '--database', db, '--epochs', 2,
            '--on_device_features'])
        expect_launches('38d speaker train.py', launches,
                        [*GRU_ALL, ('fused_logmel', None)])
        add_launches(total, launches)
        storage_dir = root / 'exp' / 'speaker_clf' / '1'
        check_recipe_dir('38d speaker', storage_dir, db)
        launches, _ = run_recipe('38d', spk_evaluate, [
            '--model_path', storage_dir, '--database', db, '--dataset',
            'test_clean'])
        expect_launches('38d speaker evaluate.py', launches,
                        [('gru', 'fwd'), ('fused_logmel', None)])
        add_launches(total, launches)
        means = means_of(storage_dir / 'eval' / 'means.json')
        print(f'phase 38d speaker means {means}')
        if means['num_examples'] != sizes['librispeech']['test_clean'] \
                or not finite_numbers(means):
            fail(f'38d: speaker evaluate.py means {means}')

        # 38e: the audio tagger on AudioSet-style files
        db = dbs['audioset']
        launches, _ = run_recipe('38e', tag_train, [
            '--storage_root', root / 'exp', '--database', db, '--epochs', 2,
            '--batch_size', 2])
        expect_launches('38e tagging train.py', launches, [])
        storage_dir = root / 'exp' / 'tagging' / '1'
        check_recipe_dir('38e tagging', storage_dir, db)
        launches, _ = run_recipe('38e', tag_evaluate, [
            '--model_path', storage_dir, '--database', db, '--dataset',
            'eval'])
        expect_launches('38e tagging evaluate.py', launches, [])
        means = means_of(storage_dir / 'eval' / 'means.json')
        print(f'phase 38e tagging means {means}')
        if means['num_examples'] != sizes['audioset']['eval'] \
                or not finite_numbers(means):
            fail(f'38e: tagging evaluate.py means {means}')

        # 38f: the distance estimator
        launches, _ = run_recipe('38f', de_train, [
            '--storage_root', root / 'exp', '--synthetic', '--epochs', 1])
        expect_launches('38f distance train.py', launches, GRU_ALL)
        add_launches(total, launches)
        storage_dir = root / 'exp' / 'distance' / '1'
        check_recipe_dir('38f distance', storage_dir)
        launches, _ = run_recipe('38f', de_evaluate, [
            '--model_path', storage_dir, '--synthetic'])
        expect_launches('38f distance evaluate.py', launches,
                        [('gru', 'fwd')])
        add_launches(total, launches)
        summary = means_of(storage_dir / 'eval' /
                           'evaluation_result.json')['summary']
        print(f'phase 38f distance summary {summary}')
        if summary['num_examples'] != 32 or not finite_numbers(summary):
            fail(f'38f: distance evaluate.py summary {summary}')

        # 38g: the vocoder on LibriSpeech-style files
        db = dbs['librispeech']
        launches, _ = run_recipe('38g', wn_train, [
            '--storage_root', root / 'exp', '--database', db, '--epochs', 1])
        expect_launches('38g wavenet train.py', launches, [])
        storage_dir = root / 'exp' / 'wavenet' / '1'
        check_recipe_dir('38g wavenet', storage_dir, db)
        launches, _ = run_recipe('38g', wn_evaluate, [
            '--model_path', storage_dir, '--database', db, '--dataset',
            'test_clean', '--max_examples', 1, '--parallel',
            '--chunk_length', 4000, '--chunk_overlap', 1000])
        expect_launches('38g wavenet evaluate.py', launches,
                        [('wavenet_sample', None)])
        add_launches(total, launches)
        wavenet_routes = dict(wavenet_sample.routes)
        means = means_of(storage_dir / 'eval' / 'means.json')
        print(f'phase 38g wavenet means {means}')
        if means['num_examples'] != 1 or not finite_numbers(means):
            fail(f'38g: wavenet evaluate.py means {means}')
    print(f'phase 38 launches of the recipe runs: {total}')
    print(f'phase 38 took {time.perf_counter() - start_phase:.1f} s')
    return gru_rows, total, wavenet_routes


# --------------------------------------------------------------------- #
# phase 39: the rest of the Trainer                                      #
# --------------------------------------------------------------------- #
# card vs CPU after three steps, largest difference over a tensor's
# largest entry: elementwise arithmetic is the same on both (the gradients
# are copied across), Adafactor's means are summed in another order
OPTIMIZER_RTOL = 1e-6
# Muon: the quintic Newton-Schulz iteration multiplies a matrix's small
# singular directions by up to 3.4445 ** 5 (about 480), so the rounding of
# its float32 products, summed in another order by cuBLAS and the CPU's
# BLAS, grows as much: the orthogonalized update of a (1200, 2400) matrix
# differs by 2e-4 to 5e-4 of its largest entry between two BLAS orders on
# one CPU and from float64; over three steps the parameters by less
MUON_RTOL = 1e-4
# one adversarial SGD step (lr 0.05) of the vocoder at full width, card vs
# CPU, largest parameter difference: the gradients through 3
# discriminators and the multi-resolution STFT loss, cuDNN's float32
# convolutions (TF32 off) against the CPU's, summed in other orders
GAN_STEP_TOL = 1e-5
OPTIMIZER_CASES = [
    ('Adadelta', {}),
    ('Adafactor', {'lr': 1e-3}),
    ('Adafactor lr=None', {'lr': None}),
    ('Lion', {'lr': 1e-4, 'weight_decay': 0.1}),
    ('Muon', {}),
]
CARD = ''   # nvidia-smi's name and power limit, set by phase 1


def lr_schedule(count):
    """Phase 39a's learning-rate schedule: an exponential decay."""
    return 1e-3 * 0.8 ** count


class TrainerRecorder(Hook):
    """Per optimizer step the iteration, the learning rate and (with
    ``params``) a host copy of the trained parameters; at the first
    ``pre_step`` after a back-off, that the parameters are the best
    checkpoint's, bit for bit, and that ``ckpt_latest`` points at it."""

    def __init__(self, params=False):
        self.rows = []
        self.params = params
        self.back_off = None

    def pre_step(self, trainer):
        if (self.back_off is not None or not self.rows
                or trainer.iteration > self.rows[-1]['iteration']):
            return
        hook, = [h for h in trainer.hooks
                 if isinstance(h, BackOffValidationHook)]
        best = hook.ckpt_ranking[0][0]
        latest = (trainer.checkpoint_dir / 'ckpt_latest.ptt').resolve().name
        stored = load_state(trainer.checkpoint_dir / best)['model']
        live = to_jax_state_dict(trainer.model)
        if latest != best or stored.keys() != live.keys() or not all(
                np.array_equal(live[k], v) for k, v in stored.items()):
            fail(f'phase 39a: after the back-off ckpt_latest points at '
                 f'{latest} and the model is not {best} bit for bit')
        self.back_off = (trainer.iteration, best)

    def post_optimize(self, trainer, summary):
        row = {'iteration': trainer.iteration, 'lr': trainer.optimizer.lr}
        if self.params:
            row['params'] = {n: p.detach().to('cpu', copy=True)
                             for n, p in trainer.model.named_parameters()
                             if p.requires_grad}
        self.rows.append(row)


def flagship_trainer(root, name, **updates):
    """The uPIT recipe's trainer at full width on the card: 3 x 600 BLSTM,
    Adam, two batches of 4 an epoch."""
    torch.manual_seed(0)
    config = pit_train.get_trainer_config(
        Path(root) / name, nested_merge(
            {'stop_trigger': (3, 'epoch'),
             'summary_trigger': (2, 'iteration')}, updates))
    return Trainer.from_config(config).to('cuda')


def flagship_data():
    make = functools.partial(pit_data.prepare_dataset, batch_size=4,
                             shuffle=False, prefetch=False)
    return (make(pit_data.synthetic_database(num_examples=8)),
            make(pit_data.synthetic_database(num_examples=8, seed=1)))


def trace_kernels(path):
    """The names of the card's kernels in a Chrome trace, and which of the
    three ``lstm_cell_scan`` kernels (lean forward, training forward,
    backward) they hold (demangled ``<false`` / ``<true`` or mangled
    ``ILb0`` / ``ILb1`` as the first template argument)."""
    events = json.loads(Path(path).read_text())['traceEvents']
    names = {e.get('name', '') for e in events
             if e.get('cat', '').lower() == 'kernel'}

    def fwd(train):
        flags = ('<true', 'ILb1') if train else ('<false', 'ILb0')
        return any('lstm_fwd_kernel' in n and any(
            n.split('lstm_fwd_kernel', 1)[1].startswith(f) for f in flags)
            for n in names)
    found = {'fwd': fwd(False), 'fwd_train': fwd(True),
             'bwd': any('lstm_bwd_kernel' in n for n in names)}
    return names, found


def power_limit_watts():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=power.limit',
         '--format=csv,noheader,nounits', '-i', '0'],
        capture_output=True, text=True, check=True).stdout
    return float(out.strip())


def phase_trainer_hooks(root):
    """39a: the flagship under the schedule, EMA, profiler and energy
    hooks, then under annealing and a back-off; the checkpoint's blocking
    times.  Returns the LSTM launches."""
    train, dev = flagship_data()
    total = {'fwd': 0, 'fwd_train': 0, 'bwd': 0}

    trainer = flagship_trainer(root, 'hooks')
    ema = EMAHook(decay=0.9)
    profiler = TorchProfilerHook((100, 'epoch'), num_steps=2)
    recorder = TrainerRecorder(params=True)
    trainer.register_hook([LRSchedulerHook(lr_schedule, (1, 'iteration')),
                           ema, profiler, recorder])
    trainer.register_validation_hook(dev)
    reset_launches()
    start = time.perf_counter()
    trainer.train(train, track_emissions=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = dict(lstm_cell_scan.launches)
    for name in total:
        total[name] += launches[name]
    lrs = [(row['iteration'], row['lr']) for row in recorder.rows]
    if [lr for _, lr in lrs] != [lr_schedule(it) for it, _ in lrs] \
            or len(lrs) != 6:
        fail(f'phase 39a: the learning rates {lrs} are not the schedule\'s')
    average = {n: p.detach().cpu() for n, p in ema.ema_params.items()}
    expect = recorder.rows[0]['params']
    for row in recorder.rows[1:]:
        expect = {n: 0.9 * expect[n] + (1 - 0.9) * p
                  for n, p in row['params'].items()}
    ema_err = max(float((average[n] - expect[n]).abs().max())
                  for n in expect)
    names, found = trace_kernels(profiler.trace_path)
    energy, = [h for h in trainer.hooks if isinstance(h, EnergyEstimateHook)]
    watts = power_limit_watts()
    print(f'phase 39a flagship with LRSchedulerHook, EMAHook, '
          f'TorchProfilerHook, track_emissions and validation: '
          f'{len(lrs)} steps in {seconds:.2f} s, learning rates {lrs}; EMA '
          f'vs host recomputation {ema_err:.3e} (tol 1e-6); trace '
          f'{profiler.trace_path.name}: {len(names)} kernel names, LSTM '
          f'kernels {found}; energy hook chip_watts {energy.chip_watts} '
          f'(nvidia-smi {watts}); LSTM launches {launches}')
    if ema_err > 1e-6:
        fail('phase 39a: the EMA is not the host recomputation')
    if not all(found.values()):
        fail(f'phase 39a: the profiler\'s trace lacks an lstm_cell_scan '
             f'kernel: {found}; LSTM-like names '
             f'{[n for n in names if "lstm" in n]}')
    if energy.chip_watts != watts:
        fail(f'phase 39a: the energy hook took {energy.chip_watts} W, the '
             f'card\'s power limit is {watts} W')
    if not all(launches[name] for name in total):
        fail(f'phase 39a: an LSTM kernel was not launched: {launches}')

    # the checkpoint's time on the caller's thread, synchronous and not
    blocking = {}
    for mode in (False, True):
        trainer.async_checkpointing = mode
        start = time.perf_counter()
        trainer.save_checkpoint(Path(root) / f'save_{mode}.ptt')
        blocked = time.perf_counter() - start
        trainer.wait_for_checkpoint_writes()
        blocking['async' if mode else 'sync'] = (
            blocked * 1e3, (time.perf_counter() - start) * 1e3)
    size = (Path(root) / 'save_False.ptt').stat().st_size / 2 ** 20
    print(f'phase 39a save_checkpoint of the flagship ({size:.1f} MiB: '
          f'model, Adam, EMA) blocks {blocking["sync"][0]:.1f} ms '
          f'synchronous, {blocking["async"][0]:.1f} ms with '
          f'async_checkpointing (written after {blocking["async"][1]:.1f} '
          f'ms) on {CARD}')

    # the back-off: maximize=True on the loss, so a falling validation
    # loss is a degradation; validated on the training batches, whose loss
    # the first two steps lower
    trainer = flagship_trainer(root, 'back_off')
    recorder = TrainerRecorder()
    trainer.register_hook([LRAnnealingHook((1, 'epoch'), [(2, 0.5)],
                                           'epoch'), recorder])
    trainer.register_validation_hook(
        train, maximize=True, n_back_off=1, back_off_patience=0,
        lr_update_factor=0.5)
    reset_launches()
    trainer.train(train)
    torch.cuda.synchronize()
    launches = dict(lstm_cell_scan.launches)
    for name in total:
        total[name] += launches[name]
    rows = [(row['iteration'], row['lr']) for row in recorder.rows]
    want = [(0, 1e-3), (1, 1e-3), (0, 5e-4), (1, 5e-4), (2, 7.5e-4),
            (3, 7.5e-4), (4, 5e-4), (5, 5e-4)]
    print(f'phase 39a flagship with LRAnnealingHook and a back-off '
          f'(maximize=True, patience 0, factor 0.5): (iteration, lr) per '
          f'step {rows}; back-off to {recorder.back_off}; LSTM launches '
          f'{launches}')
    if recorder.back_off is None or len(rows) != len(want) or not all(
            i == j and np.isclose(a, b, rtol=1e-12, atol=0)
            for (i, a), (j, b) in zip(rows, want)):
        fail(f'phase 39a: expected the steps {want} (the annealed rate, '
             f'halved by the back-off until the next epoch)')
    return total


def optimizer_errors(params, grads, name, kwargs):
    """Three steps of the optimizer on the card and on the CPU from the
    same parameters and gradients (halved at each step): the largest
    difference over a tensor's largest entry."""
    cls = getattr(train_optim, name.split()[0])
    out = {}
    for device in ('cuda', 'cpu'):
        tensors = {n: torch.nn.Parameter(p.to(device, copy=True))
                   for n, p in params.items()}
        opt = cls(**kwargs).set_parameters(tensors.items())
        for i in range(3):
            for n, t in tensors.items():
                t.grad = (grads[n] * 0.5 ** i).to(device, copy=True)
            opt.step()
        out[device] = tensors
    return max(float((out['cuda'][n].detach().cpu() - out['cpu'][n].detach()
                      ).abs().max() / out['cpu'][n].detach().abs().max())
               for n in params)


def phase_trainer_optimizers(root):
    """39b: the four optimizers at the flagship's shapes, card vs CPU, then
    Trainer steps with each.  Returns the LSTM launches."""
    train, _ = flagship_data()
    batch = next(iter(train))
    trainer = flagship_trainer(root, 'optimizers')
    loss = trainer.train_step(trainer.model, batch)[0]
    loss.backward()
    params = {n: p.detach().clone() for n, p in
              trainer.model.named_parameters() if p.requires_grad}
    grads = {n: p.grad.detach().clone() for n, p in
             trainer.model.named_parameters() if p.requires_grad}
    total = {'fwd': 0, 'fwd_train': 0, 'bwd': 0}
    rows = {}
    for name, kwargs in OPTIMIZER_CASES:
        err = optimizer_errors(params, grads, name, kwargs)
        tol = MUON_RTOL if name == 'Muon' else OPTIMIZER_RTOL
        with torch.no_grad():
            for n, p in trainer.model.named_parameters():
                if n in params:
                    p.copy_(params[n])
        stepper = Trainer(trainer.model, Path(root) / name.replace(' ', '_'),
                          getattr(train_optim, name.split()[0])(**kwargs),
                          loss_weights=trainer.loss_weights)
        losses = []
        for example in list(train)[:2]:
            step_loss = stepper.train_step(stepper.model, example)[0]
            step_loss.backward()
            stepper.optimizer.step()
            stepper.optimizer.zero_grad()
            losses.append(float(step_loss.detach()))
        times = timed_step(stepper, batch, loss_key='trainer')
        add = dict(lstm_cell_scan.launches)
        for n in total:
            total[n] += add[n]
        rows[name] = {'err': err, 'tol': tol, 'losses': losses,
                      'step_ms': times['host_step'],
                      'optimizer_ms': times['adam']}
        print(f'phase 39b {name} {kwargs}: 3 steps card vs CPU, largest '
              f'difference {err:.3e} of a tensor\'s largest entry (tol '
              f'{tol:g}'
              + ('; Muon: the Newton-Schulz iteration multiplies small '
                 'singular directions by up to 3.4445 ** 5, and with them '
                 'the rounding of its products, summed in another order by '
                 'cuBLAS and the CPU' if name == 'Muon' else '')
              + f'); two Trainer steps, losses {losses}; a flagship step '
              f'B=4 {times["host_step"]:.3f} ms (host clock), of it the '
              f'optimizer {times["adam"]:.3f} ms, clip {times["clip"]:.3f} '
              f'ms (CUDA events) on {CARD}')
        if not err <= tol:
            fail(f'phase 39b: {name} on the card is not the CPU\'s')
        if not np.isfinite(losses).all():
            fail(f'phase 39b: {name}: non-finite loss {losses}')
    return total, rows


def phase_trainer_gan(root):
    """39c: the GAN vocoder at the recipe's widths: train.py with
    asynchronous checkpoints, a resume, evaluate.py, an adversarial step
    against the CPU.  Returns the ms per adversarial step."""
    from padertorch_tpu_torch.contrib.examples.audio_synthesis \
        .gan_vocoder import (
            data as gan_data, evaluate as gan_evaluate, model as gan_model,
            train as gan_train)
    from padertorch_tpu_torch.io import load_config
    start = time.perf_counter()
    run_main(gan_train, ['--storage_root', str(Path(root) / 'gan'),
                         '--synthetic', '--epochs', '1', '--num_examples',
                         '8', '--batch_size', '4', '--async_checkpointing'])
    storage_dir = Path(root) / 'gan' / 'gan_vocoder' / '1'
    check_recipe_dir('39c gan_vocoder', storage_dir)
    config = load_config(storage_dir / 'config.json')['trainer']
    config['stop_trigger'] = (2, 'epoch')
    resumed = Trainer.from_config(config).to('cuda')
    dev = gan_data.prepare_dataset(
        gan_data.synthetic_database(num_examples=8, seed=1), batch_size=4,
        shuffle=False, prefetch=False)
    train = gan_data.prepare_dataset(
        gan_data.synthetic_database(num_examples=8), batch_size=4)
    resumed.register_validation_hook(dev)
    resumed.train(train, resume=True)
    if resumed.iteration != 4 or not resumed.async_checkpointing:
        fail(f'phase 39c: the resume ran to iteration {resumed.iteration}')
    run_main(gan_evaluate, ['--model_path', str(storage_dir),
                            '--synthetic'])
    means = means_of(storage_dir / 'eval' / 'means.json')
    wavs = sorted(p.name for p in (storage_dir / 'eval' / 'audio').iterdir())
    seconds = time.perf_counter() - start
    print(f'phase 39c gan_vocoder train.py --async_checkpointing (2 '
          f'iterations, test_run), resumed to iteration '
          f'{resumed.iteration}, evaluate.py: {means}, {len(wavs)} WAVs; '
          f'{seconds:.2f} s')
    if not finite_numbers(means) or len(wavs) != 4:
        fail('phase 39c: evaluate.py gave no finite metrics or WAVs')

    # one adversarial step, card against CPU, from the same weights (a
    # batch of 2 x 16000 samples, to keep the CPU's step short)
    torch.manual_seed(0)
    batch = next(iter(gan_data.prepare_dataset(
        gan_data.synthetic_database(num_examples=2), batch_size=2,
        shuffle=False, prefetch=False)))
    start_model = gan_model.GANVocoder()
    width = (start_model.generator.pre.out_channels,
             start_model.generator.upsample_rates)
    if width != (128, (5, 5, 4, 2)):
        fail(f'phase 39c: not the recipe\'s widths: {width}')

    def step(device, loss_weights=None, name='step'):
        model = copy.deepcopy(start_model).to(device)
        trainer = Trainer(
            model, Path(root) / f'{name}_{device}',
            {'generator': train_optim.SGD(lr=0.05, gradient_clipping=10.0),
             'discriminator': train_optim.SGD(lr=0.05,
                                              gradient_clipping=10.0)},
            adversarial=True, loss_weights=loss_weights,
            stop_trigger=(1, 'iteration'))
        trainer.train([batch])
        return trainer, {n: p.detach().cpu()
                         for n, p in trainer.model.named_parameters()}

    card, card_params = step('cuda')
    _, cpu_params = step('cpu')
    _, zero_params = step('cuda', {'generator': 1.0, 'discriminator': 0.0},
                          'zero')
    start_params = dict(start_model.named_parameters())
    err = max(float((card_params[n] - cpu_params[n]).abs().max())
              for n in cpu_params)
    gen_err = max(float((zero_params[n] - card_params[n]).abs().max())
                  for n in card_params if n.startswith('generator.'))
    disc_still = all(torch.equal(zero_params[n], start_params[n].detach())
                     for n in zero_params if n.startswith('discriminator.'))
    moved = all(not torch.equal(card_params[n], start_params[n].detach())
                for n in card_params)

    # the adversarial step's time: one forward, a gradient per key, two
    # optimizer steps
    model = card.model
    example = model.example_to_device(batch, 'cuda')
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, weighted, _, _, _ = card._step(model, example, card.train_timer)
        card._backward(loss, weighted)
        for opt in card.optimizer.values():
            opt.step()
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(times))
    print(f'phase 39c one adversarial SGD step at base_channels 128, '
          f'upsampling (5, 5, 4, 2), B=2 x 16000: card vs CPU {err:.3e} '
          f'(tol {GAN_STEP_TOL:g}), every parameter moved {moved}; with '
          f'the discriminator\'s loss weight 0 the generator\'s update '
          f'{gen_err:.3e} from the full step\'s, the discriminator '
          f'unchanged {disc_still}; an adversarial step {step_ms:.3f} ms '
          f'(host clock, median of 5) on {CARD}')
    if not (err <= GAN_STEP_TOL and moved and disc_still
            and gen_err <= GAN_STEP_TOL):
        fail('phase 39c: the adversarial step failed a check')
    return step_ms


def phase_trainer_interactive(root):
    """39d: ``InteractiveTrainer`` prints its scalars."""
    base = flagship_trainer(root, 'interactive_model')
    trainer = InteractiveTrainer(
        base.model, Path(root) / 'interactive', Adam(gradient_clipping=10.0),
        loss_weights=base.loss_weights, summary_trigger=(1, 'iteration'),
        stop_trigger=(2, 'iteration'))
    train, _ = flagship_data()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer.train(train)
    lines = [line for line in out.getvalue().splitlines()
             if line.startswith('[') and ('/loss:' in line
                                          or 'grad_norm:' in line)]
    print('phase 39d InteractiveTrainer, 2 steps on the card: '
          + '; '.join(lines))
    if not any('training/loss' in line for line in lines) or any(
            'tfevents' in p.name for p in trainer.storage_dir.iterdir()):
        fail('phase 39d: InteractiveTrainer printed no loss or wrote an '
             'event file')


def phase_trainer():
    """Phase 39: the rest of the Trainer (see the module docstring).
    Returns the LSTM launches of 39a and 39b, the optimizers' rows and the
    ms per adversarial step."""
    start = time.perf_counter()
    total = {'fwd': 0, 'fwd_train': 0, 'bwd': 0}
    with tempfile.TemporaryDirectory() as root:
        for name, n in phase_trainer_hooks(root).items():
            total[name] += n
        launches, rows = phase_trainer_optimizers(root)
        for name, n in launches.items():
            total[name] += n
        gan_ms = phase_trainer_gan(root)
        phase_trainer_interactive(root)
    seconds = time.perf_counter() - start
    print(f'phase 39 in {seconds:.1f} s, LSTM launches {total}')
    return total, rows, gan_ms


# phase 40: serving from exported artifacts (``serve.py`` over
# ``torch.export``, the kernels as ``ptt`` custom operators), LoRA and the
# online enhancer.  An artifact runs the eager model's kernels, in the
# same order on the same shapes: its outputs equal the eager model's on
# the card, within EXPORT_TOL of the largest output.
EXPORT_TOL = 1e-6
# the generation loop an artifact unrolls: its trace grows with the steps
# times the layers (about 200 graph nodes a layer a step), so 16 steps of
# the first GENERATE_LAYERS layers of the full-width decoder are exported
# (all 12 layers took 800.6 s to export and 106.4 s to load on an H100's
# host, PERF.md); the scoring artifact keeps all 12
EXPORT_NEW_TOKENS = 16
GENERATE_LAYERS = 2
# the merged LoRA model against the adapted one, float32 forward logits,
# relative to the largest
LORA_MERGE_RTOL = 1e-4
# the online enhancer (streaming STFT, StatefulLSTM mask, streaming iSTFT,
# 4 frames a chunk) against the offline pipeline on the card: the streamed
# STFT sums its frames in another order (the CPU tests see 2e-5 of frames
# up to about 30), the mask and the synthesis carry that on
ONLINE_TOL = 1e-4

FRESH_PROCESS = r'''
import json, sys
import numpy as np
import torch
import padertorch_tpu_torch.ops.kernels
from padertorch_tpu_torch.ops.kernels.lstm import lstm_cell_scan
artifact, tmp = sys.argv[1:]
program = torch.export.load(artifact)
batch = {'Y_abs': torch.from_numpy(np.load(tmp + '/y.npy')).cuda(),
         'num_frames': torch.from_numpy(np.load(tmp + '/n.npy')).cuda()}
with torch.no_grad():
    out = program.module()(batch)
np.save(tmp + '/out.npy', out.cpu().numpy())
print(json.dumps({'launches': lstm_cell_scan.launches['fwd']}))
'''


def served_requests(label, fn, eager, requests, counts, want_per_request):
    """Each request through the artifact ``fn`` and the eager ``eager``;
    the launches ``counts()`` reads must grow by ``want_per_request`` a
    request.  Returns the largest difference relative to each request's
    largest output."""
    worst = 0.0
    for batch in requests:
        before = counts()
        got = fn(batch)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in counts().items()}
        with torch.no_grad():
            want = eager(batch)
        if tuple(got.shape) != tuple(want.shape):
            fail(f'{label}: artifact shape {tuple(got.shape)}, eager '
                 f'{tuple(want.shape)}')
        worst = max(worst, max_rel_err([got.float()], [want.float()]))
        if launched != want_per_request:
            fail(f'{label}: a request launched {launched}, expected '
                 f'{want_per_request}')
    return worst


def phase_export_separator(tmp):
    """40a: the uPIT flagship exported with symbolic batch and frames,
    dumped, loaded in a fresh process and here, and served; the bf16
    policy's artifact; one request's tensor part (model, masks, fused
    iSTFT) as ``export_fn``.  Returns the launches of the served
    requests."""
    torch.manual_seed(0)
    model = PermutationInvariantTrainingModel(
        F=257, recurrent_layers=3, units=600, K=2).eval().cuda()
    axes = {'Y_abs': {0: 'b', 1: 't'}, 'num_frames': {0: 'b'}}

    def on_card(batch):
        return {k: v.cuda() for k, v in batch.items()}

    start = time.perf_counter()
    path = dump_exported(model, on_card(ragged_batch(2, 200)),
                         Path(tmp) / 'upit', dynamic_axes=axes)
    export_s = time.perf_counter() - start
    size = (path / 'forward.pt2').stat().st_size
    # a fresh process with torch and the operator registrations only
    request = ragged_batch(3, 317, seed=5)
    np.save(Path(tmp) / 'y.npy', request['Y_abs'].numpy())
    np.save(Path(tmp) / 'n.npy', request['num_frames'].numpy())
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-c', FRESH_PROCESS, str(path / 'forward.pt2'),
         tmp], capture_output=True, text=True, timeout=300,
        cwd=Path(__file__).resolve().parent)
    fresh_s = time.perf_counter() - start
    if proc.returncode != 0:
        fail(f'the artifact did not load in a fresh process:\n'
             f'{proc.stderr[-3000:]}')
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])
    with torch.no_grad():
        want = model(on_card(request)).cpu()
    fresh_err = max_rel_err([torch.from_numpy(np.load(
        Path(tmp) / 'out.npy'))], [want])
    print(f'phase 40a uPIT flagship (3 x 600 BLSTM, F=257, K=2) exported '
          f'with symbolic batch and frames in {export_s:.2f} s, '
          f'forward.pt2 {size / 2**20:.1f} MiB; loaded and served in a '
          f'fresh process (torch and the ptt operators only) in '
          f'{fresh_s:.2f} s: lstm_cell_scan launches {fresh["launches"]}, '
          f'against the eager model {fresh_err:.3e} (tol {EXPORT_TOL}) on '
          f'{CARD}')
    if fresh['launches'] != 3 or not fresh_err <= EXPORT_TOL:
        fail(f'the fresh process served with {fresh["launches"]} launches, '
             f'{fresh_err} from the eager model')
    served = load_exported(path)
    requests = [on_card(ragged_batch(b, t, seed=b))
                for b, t in ((1, 500), (3, 317), (5, 240))]

    def lstm_counts():
        return dict(lstm_cell_scan.launches)

    f32_err = served_requests(
        '40a', served, model, requests, lstm_counts,
        with_zeros(lstm_cell_scan.launches, {'fwd': 3}))
    one = requests[0]
    with torch.no_grad():
        artifact_ms = cuda_ms(lambda: served(one), iters=10, warmup=2)
        eager_ms = cuda_ms(lambda: model(one), iters=10, warmup=2)
    model16 = set_rnn_backend(copy.deepcopy(model), 'pallas',
                              compute_dtype='bfloat16')
    start = time.perf_counter()
    served16 = load_exported(export_model(
        model16, on_card(ragged_batch(2, 200)), dynamic_axes=axes))
    export16_s = time.perf_counter() - start
    bf16_err = served_requests(
        '40a bf16', served16, model16, requests, lstm_counts,
        with_zeros(lstm_cell_scan.launches, {'fwd_bf16': 3}))
    print(f'phase 40a artifact vs eager on 3 requests (B, T) = (1, 500), '
          f'(3, 317), (5, 240): float32 {f32_err:.3e}, bf16 policy '
          f'{bf16_err:.3e} (exported and loaded in {export16_s:.2f} s; tol '
          f'{EXPORT_TOL}); 3 lean LSTM launches a request each; B=1 T=500 '
          f'request {artifact_ms:.3f} ms from the artifact, {eager_ms:.3f} '
          f'ms eager (CUDA events) on {CARD}')
    if not max(f32_err, bf16_err) <= EXPORT_TOL:
        fail(f'the artifacts disagree with the eager model: {f32_err}, '
             f'{bf16_err}')
    # one request's tensor part: masks, then the fused mask and iSTFT
    stft = STFT(pit_data.STFT_SIZE, pit_data.STFT_SHIFT, fading='full',
                complex_representation='stacked')

    def separate(batch):
        spec = batch['spec']
        y_abs = torch.sqrt(spec[..., 0] ** 2 + spec[..., 1] ** 2)
        masks = model({'Y_abs': y_abs, 'num_frames': batch['num_frames']})
        return stft.masked_inverse(spec, masks.permute(2, 0, 1, 3))

    def mixture(b, samples, seed):
        audio = torch.from_numpy(np.random.RandomState(seed).randn(
            b, samples).astype('float32') * 0.1).cuda()
        spec = stft(audio)
        return {'spec': spec,
                'num_frames': torch.full((b,), spec.shape[1],
                                         device='cuda')}

    start = time.perf_counter()
    separator = load_exported(export_fn(
        separate, mixture(2, 16000, 0),
        dynamic_axes={'spec': {0: 'b', 1: 't'}, 'num_frames': {0: 'b'}}))
    request_s = time.perf_counter() - start

    def request_counts():
        return {'lstm': lstm_cell_scan.launches['fwd'],
                'masked_istft': masked_istft.launches}

    request_err = served_requests(
        '40a request', separator, separate,
        [mixture(1, 24000, 1), mixture(3, 12345, 2)], request_counts,
        {'lstm': 3, 'masked_istft': 1})
    print(f'phase 40a export_fn of a request (model, masks, fused mask and '
          f'iSTFT) exported and loaded in {request_s:.2f} s, served 2 '
          f'requests: against eager {request_err:.3e} (tol {EXPORT_TOL}), '
          f'3 lean LSTM and 1 masked_istft launches a request')
    if not request_err <= EXPORT_TOL:
        fail(f'the request artifact disagrees with eager: {request_err}')
    return {'fwd': 9 + 2 * 3, 'fwd_bf16': 9, 'masked_istft': 2}


def phase_export_decoder():
    """40b: LoRA on bench.py's int8 decoder at full width: three float32
    Adam steps of the adapters, the merge, bf16, int8, the whole greedy
    loop exported and served at B=1 and B=4 against eager generation; a
    teacher-forced scoring forward exported (the bf16 attention forward
    and the int8 products in one artifact).  Returns the launches."""
    dec, head, emb, _, _ = full_width_decoder()
    d_model = DECODER['d_model']
    adapted = apply_lora(dec, rank=8, targets=('q_proj', 'v_proj'))
    frozen = mark_only_lora_trainable(dec)
    head.requires_grad_(False)
    factors = [p for p in dec.parameters() if p.requires_grad]
    base = [p.detach().clone() for p in dec.parameters()
            if not p.requires_grad]
    rng = np.random.RandomState(1)
    tokens = torch.from_numpy(rng.randint(0, VOCAB, (2, 17))).cuda()
    memory = torch.tensor(rng.randn(2, MEMORY_FRAMES, d_model),
                          dtype=torch.float32, device='cuda')
    x = emb[tokens[:, :-1]]
    optimizer = torch.optim.Adam(factors, lr=1e-3)
    reset_launches()
    losses = []
    dec.train()
    for _ in range(3):
        optimizer.zero_grad()
        logits = head(dec(x, memory))
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, VOCAB), tokens[:, 1:].reshape(-1))
        loss.backward()
        optimizer.step()
        losses.append(float(loss))
    torch.cuda.synchronize()
    train_launches = {k: flash_attention.launches[k]
                      for k in ('fwd_train', 'bwd')}
    dec.eval()
    moved = sum(int((p.grad is not None) and bool(p.detach().abs().sum()))
                for p in factors)
    kept = all(torch.equal(a, b) for a, b in zip(
        base, [p for p in dec.parameters() if not p.requires_grad]))
    print(f'phase 40b LoRA (rank 8 on q_proj and v_proj: {adapted} '
          f'adapters, {frozen} parameters frozen, '
          f'{sum(p.numel() for p in factors)} trainable) on the full-width '
          f'int8 decoder: 3 float32 Adam steps on the card, losses '
          f'{[round(v, 4) for v in losses]}, factors with a gradient and '
          f'a value {moved} of {len(factors)}, the frozen base unchanged '
          f'{kept}; attention kernel launches {train_launches}')
    if not (kept and np.isfinite(losses).all() and moved == len(factors)):
        fail('the LoRA steps moved the base, left a factor, or diverged')
    if min(train_launches.values()) < DECODER['num_layers']:
        fail(f'the LoRA steps launched the attention kernels '
             f'{train_launches} times')
    del base, optimizer
    with torch.no_grad():
        want = head(dec(x, memory))
        merged = merge_lora(dec)
        got = head(dec(x, memory))
    merge_err = max_rel_err([got], [want])
    print(f'phase 40b merge_lora folded {merged} adapters: merged vs '
          f'adapted logits {merge_err:.3e} relative (tol {LORA_MERGE_RTOL})')
    if merged != adapted or not merge_err <= LORA_MERGE_RTOL:
        fail(f'merge_lora: {merged} merged, {merge_err} from the adapted')
    dec16 = dec.to(torch.bfloat16)
    quantize_module(dec16)
    q_head = QuantizedLinear.from_linear(head.to(torch.bfloat16))
    emb16 = emb.to(torch.bfloat16)

    def embed(t):
        return emb16[t]

    def memory16(b, seed):
        return torch.tensor(np.random.RandomState(seed).randn(
            b, MEMORY_FRAMES, d_model), dtype=torch.bfloat16, device='cuda')

    # the depth cut: the merged, quantized decoder's first layers and its
    # final norm (shared, not copied)
    cut = TransformerDecoder(d_model, 0, DECODER['num_heads'])
    cut.layers = torch.nn.ModuleList(list(dec16.layers)[:GENERATE_LAYERS])
    cut.final_norm = dec16.final_norm
    start = time.perf_counter()
    blob = export_generate(cut, memory16(2, 2), embed=embed,
                           logits_head=q_head, bos_id=0,
                           max_len=EXPORT_NEW_TOKENS)
    export_s = time.perf_counter() - start
    start = time.perf_counter()
    generate_fn = load_exported(blob)
    load_s = time.perf_counter() - start
    nodes = len(generate_fn.program.graph.nodes)
    per_request = EXPORT_NEW_TOKENS * (8 * GENERATE_LAYERS + 1)
    ties, int8_total = 0, 0
    for b in (1, 4):
        mem = memory16(b, 10 + b)
        before = int8_matmul.launches
        got_tokens, _ = generate_fn(mem)
        torch.cuda.synchronize()
        launched = int8_matmul.launches - before
        int8_total += launched
        seen = []

        def recording_head(h, seen=seen):
            out = q_head(h)
            seen.append(out.float())
            return out

        want_tokens, _ = generate(
            cut, recording_head, emb16, mem, max_len=EXPORT_NEW_TOKENS)
        if launched != per_request:
            fail(f'40b: the artifact launched int8_matmul {launched} times '
                 f'at B={b}, expected {per_request} '
                 f'({8 * GENERATE_LAYERS + 1} a token; the cross K/V '
                 f'projections of {MEMORY_FRAMES * b} rows take the '
                 f'composed route inside the operator)')
        scale = max(float(s.abs().max()) for s in seen)
        for row in range(b):
            got_row = got_tokens[row].tolist()
            want_row = want_tokens[row].tolist()
            if got_row == want_row:
                continue
            n = next(i for i, (p, q) in enumerate(zip(got_row, want_row))
                     if p != q)
            if not bool(near_ties(seen[n][row], 2 * SERVE_LOGIT_RTOL
                                  * scale)):
                fail(f'40b B={b} row {row}: the artifact gives {got_row}, '
                     f'eager {want_row}, not at a near tie')
            ties += 1
    print(f'phase 40b bf16 int8 decoder: export_generate of '
          f'{EXPORT_NEW_TOKENS} greedy steps (unrolled, the first '
          f'{GENERATE_LAYERS} of the {DECODER["num_layers"]} layers a '
          f'step; {nodes} graph nodes) in {export_s:.1f} s, '
          f'{len(blob) / 2**20:.1f} MiB, loaded in {load_s:.1f} s; served '
          f'B=1 and B=4: tokens equal to eager autoregressive_generate but '
          f'at {ties} near ties, int8_matmul {per_request} launches a '
          f'request on {CARD}')
    del blob, generate_fn
    # teacher-forced scoring: the bf16 attention forward and the int8
    # products in one artifact
    def score(batch):
        return q_head(dec16(batch['x'], batch['memory']))

    def scoring_batch(b, seed):
        ids = torch.from_numpy(np.random.RandomState(seed).randint(
            0, VOCAB, (b, EXPORT_NEW_TOKENS))).cuda()
        return {'x': emb16[ids], 'memory': memory16(b, seed)}

    start = time.perf_counter()
    scorer = load_exported(export_fn(
        score, scoring_batch(2, 3),
        dynamic_axes={'x': {0: 'b'}, 'memory': {0: 'b'}}))
    score_s = time.perf_counter() - start

    def score_counts():
        return {'int8_matmul': int8_matmul.launches,
                'fwd_bf16': flash_attention.launches['fwd_bf16']}

    # per forward of 2 x 16 tokens: the self-attention's four products,
    # the cross-attention's query and output, the FFN's two and the head
    # on the kernel (97, as a decode step), the cross K/V projections of
    # 2 x 128 rows composed inside the operator; two attention calls a
    # layer
    score_err = served_requests(
        '40b scoring', scorer, score, [scoring_batch(2, 4)], score_counts,
        {'int8_matmul': 8 * DECODER['num_layers'] + 1,
         'fwd_bf16': 2 * DECODER['num_layers']})
    print(f'phase 40b teacher-forced scoring exported and loaded in '
          f'{score_s:.1f} s: logits against eager {score_err:.3e} (tol '
          f'{EXPORT_TOL}); the bf16 attention forward and int8_matmul '
          f'launched from the artifact')
    if not score_err <= EXPORT_TOL:
        fail(f'the scoring artifact disagrees with eager: {score_err}')
    return {'int8_matmul': int8_total + 8 * DECODER['num_layers'] + 1,
            'fwd_bf16': 2 * DECODER['num_layers'], **train_launches}


def phase_export_classifier(tmp):
    """40c: the speaker classifier at the recipe's defaults with the
    on-device front end, exported with symbolic batch and samples and
    served: ``fused_logmel`` and the lean GRU forward from the artifact.
    Returns the launches."""
    torch.manual_seed(0)
    config = spk_train.get_trainer_config(Path(tmp) / 'clf', 8,
                                          on_device_features=True)
    model = Trainer.from_config(config).model.eval().cuda()

    def batch(b, samples, seed):
        return {k: torch.from_numpy(v).cuda() for k, v in speaker_batch(
            b, samples, 8, seed).items() if k != 'speaker_id'}

    start = time.perf_counter()
    served = load_exported(export_model(
        model, batch(2, 8000, 0),
        dynamic_axes={'audio_data': {0: 'b', 1: 't'}, 'seq_len': {0: 'b'}}))
    export_s = time.perf_counter() - start

    def counts():
        return {'fused_logmel': fused_logmel.launches,
                'gru': gru_cell_scan.launches['fwd']}

    requests = [batch(1, 16000, 1), batch(4, 12000, 2), batch(8, 8000, 3)]
    err = served_requests('40c', served, model, requests, counts,
                          {'fused_logmel': 1, 'gru': 1})
    print(f'phase 40c speaker classifier (the recipe\'s (16, 32) channels, '
          f'64 GRU units, --on_device_features) exported and loaded in '
          f'{export_s:.2f} s; 3 requests (1 x 16000, 4 x 12000, 8 x 8000 '
          f'samples) against eager {err:.3e} (tol {EXPORT_TOL}), one '
          f'fused_logmel and one lean GRU launch a request')
    if not err <= EXPORT_TOL:
        fail(f'the classifier artifact disagrees with eager: {err}')
    return {'fused_logmel': 3, 'fwd': 3}


def phase_online_enhancer():
    """40d: the online enhancer at the flagship's widths with one
    direction: streaming STFT (512/128), a 3 x 600 ``StatefulLSTM`` mask,
    streaming iSTFT, 4 s of 16 kHz audio in chunks of 4 frames, against
    the offline pipeline on the card.  Returns the LSTM launches."""
    stft = STFT(512, 128, complex_representation='stacked')
    bins = 257
    torch.manual_seed(0)
    lstm = StatefulLSTM(bins, 600, num_layers=3).eval().cuda()
    head = torch.nn.Linear(600, bins).cuda()
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, 4 * 16000).astype('float32') * 0.1).cuda()

    def magnitude(frames):
        return torch.sqrt(frames[..., 0] ** 2 + frames[..., 1] ** 2 + 1e-8)

    def mask_net(frames):
        return torch.sigmoid(head(lstm(magnitude(frames))))[..., None]

    with torch.no_grad():
        spec = stft(x)
        want = stft.inverse(spec * mask_net(spec))
        chunk = 4 * stft.shift

        def stream():
            del lstm.states
            analysis, synthesis = StreamingSTFT(stft), StreamingISTFT(stft)
            a_state = analysis.init_state((1,), device='cuda')
            s_state = synthesis.init_state((1,), device='cuda')
            outs = []
            for start in range(0, x.shape[-1], chunk):
                a_state, frames = analysis.step(
                    a_state, x[..., start:start + chunk])
                s_state, samples = synthesis.step(
                    s_state, frames * mask_net(frames))
                outs.append(samples)
            tail = analysis.finalize(a_state)
            s_state, samples = synthesis.step(s_state,
                                              tail * mask_net(tail))
            outs += [samples, synthesis.finalize(s_state)]
            return torch.cat(outs, dim=-1)[..., synthesis.warmup_samples:]

        chunks = x.shape[-1] // chunk + 1
        before = lstm_cell_scan.launches['fwd']
        got = stream()
        torch.cuda.synchronize()
        launches = lstm_cell_scan.launches['fwd'] - before
        stream()
        torch.cuda.synchronize()
        start = time.perf_counter()
        stream()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    err = max_err([got], [want])
    print(f'phase 40d online enhancer (streaming STFT 512/128, 3 x 600 '
          f'StatefulLSTM mask, streaming iSTFT): 4 s of 16 kHz audio in '
          f'{chunks} chunks of 4 frames, {seconds / chunks * 1e3:.3f} ms a '
          f'chunk (host clock), real-time factor {seconds / 4:.4f}; against '
          f'the offline pipeline {err:.3e} (tol {ONLINE_TOL}); lean LSTM '
          f'launches {launches} ({chunks} chunks x 3 layers) on {CARD}')
    if got.shape != want.shape or not err <= ONLINE_TOL:
        fail(f'the online enhancer disagrees with offline: {err}')
    if launches != 3 * chunks:
        fail(f'the online enhancer launched the lean LSTM {launches} times')
    return launches


def phase_export():
    """Phase 40: serving from exported artifacts, LoRA, the online
    enhancer; returns the launches by kernel."""
    start = time.perf_counter()
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        separator = phase_export_separator(tmp)
        torch.cuda.empty_cache()
        decoder = phase_export_decoder()
        torch.cuda.empty_cache()
        classifier = phase_export_classifier(tmp)
    online = phase_online_enhancer()
    launches = {
        'lstm fwd': separator['fwd'] + online,
        'lstm fwd_bf16': separator['fwd_bf16'],
        'masked_istft': separator['masked_istft'],
        'int8_matmul': decoder['int8_matmul'],
        'attention fwd_bf16': decoder['fwd_bf16'],
        'attention fwd_train': decoder['fwd_train'],
        'attention bwd': decoder['bwd'],
        'fused_logmel': classifier['fused_logmel'],
        'gru fwd': classifier['fwd']}
    print(f'phase 40 in {time.perf_counter() - start:.1f} s, launches '
          f'{launches}')
    return launches


def main():
    profile = '--profile' in sys.argv[1:]
    phase_device()
    phase_build()
    lstm, library = phase_lstm()
    istft = phase_istft()
    launches = phase_slice()
    train_kernels, kernel_times = phase_train_kernels(library)
    train_launches = phase_training(kernel_times, profile=profile)
    for name in ('fwd_train', 'bwd'):
        if train_launches[name] == 0:
            fail(f'the training path never launched the {name} kernel')
    gru = phase_gru_kernels()
    lstm_dprnn = phase_lstm_at_dprnn_shapes()
    served = {rnn_type: phase_tasnet_serving(rnn_type)
              for rnn_type in ('bgru', 'blstm')}
    trained = {rnn_type: phase_tasnet_training(rnn_type, profile=profile)
               for rnn_type in ('bgru', 'blstm')}
    attention = phase_attention_kernels()
    sepformer_served = phase_sepformer_serving()
    sepformer_trained = phase_tasnet_training('sepformer', profile=profile)
    wavenet = phase_wavenet_kernel()
    torch.cuda.empty_cache()
    logmel = phase_logmel_kernel()
    wavenet_launches, wavenet_routes = phase_wavenet_serving()
    phase_wavenet_training()
    torch.cuda.empty_cache()
    speaker = phase_speaker_clf()
    torch.cuda.empty_cache()
    int8_row = phase_int8_kernel()
    torch.cuda.empty_cache()
    int8_launches, decoder_models = phase_decode(profile=profile)
    serve_launches = phase_serving(decoder_models)
    del decoder_models
    torch.cuda.empty_cache()
    lstm_bf16 = phase_lstm_bf16_kernels()
    lstm_bf16_launches = phase_flagship_bf16()
    phase_dprnn_bf16(profile=profile)
    attention_bf16, headline = phase_attention_bf16()
    phase_attention_bf16_bwd(attention_bf16)
    attention_bf16_launches = phase_sepformer_bf16(profile=profile)
    gru_bf16 = phase_gru_bf16_kernels()
    dprnn_bgru_launches = phase_dprnn_bgru_bf16()
    speaker_bf16_launches = phase_speaker_bf16()
    phase_geometries()
    torch.cuda.empty_cache()
    phase_convtasnet()
    torch.cuda.empty_cache()
    orpit_trained, orpit_served = phase_or_pit()
    torch.cuda.empty_cache()
    me_rows, me_istft, me_trained, me_served = phase_mask_estimator()
    torch.cuda.empty_cache()
    dc_served, dc_trained = phase_deep_clustering()
    torch.cuda.empty_cache()
    asr_attention_rows, asr_lstm_rows, asr_launches_ = phase_asr()
    torch.cuda.empty_cache()
    distance_gru_rows, real_audio, real_wavenet_routes = phase_real_audio()
    torch.cuda.empty_cache()
    trainer_launches, optimizer_rows, gan_step_ms = phase_trainer()
    torch.cuda.empty_cache()
    exported = phase_export()
    real_lstm = real_audio.get('lstm', {})
    real_gru = real_audio.get('gru', {})
    # the bf16 GRU kernels' launches on the main paths: the bgru DPRNN
    # under the policy (20 steps and 4 requests) and both classifiers
    gru_bf16_launches = {
        name: dprnn_bgru_launches[name] + speaker_bf16_launches[name]
        for name in dprnn_bgru_launches}
    for name, n in gru_bf16_launches.items():
        if n == 0:
            fail(f'phases 29 and 30 never launched the gru {name} kernel')
        if sum(GRU_BF16_MAIN_ROUTES[name].values()) != n:
            fail(f'the gru {name} kernel\'s launches by route '
                 f'{GRU_BF16_MAIN_ROUTES[name]} do not add up to its {n}')
    for name in ('fwd_bf16', 'fwd_train_bf16', 'bwd_bf16'):
        if GRU_BF16_MAIN_ROUTES[name]['mma'] == 0:
            fail(f'no gru {name} launch of phases 29 and 30 took the mma '
                 f'route: {GRU_BF16_MAIN_ROUTES[name]}')
    if GRU_BF16_MAIN_ROUTES['fwd_bf16']['cluster'] == 0:
        fail(f'no lean bf16 gru launch of phase 30 took the cluster route: '
             f'{GRU_BF16_MAIN_ROUTES["fwd_bf16"]}')
    for name in ('fwd_train_bf16', 'bwd_bf16'):
        if attention_bf16_launches[name] == 0:
            fail(f'the bf16 SepFormer step never launched the attention '
                 f'{name} kernel')
    # and the real-audio runs' (phase 38: the vocoder's request on a file)
    wavenet_launches += real_audio['wavenet_sample']
    wavenet_routes = {route: n + real_wavenet_routes.get(route, 0)
                      for route, n in wavenet_routes.items()}
    if wavenet_launches == 0:
        fail('the vocoder\'s requests never launched the wavenet_sample '
             'kernel')
    for name, n in speaker.items():
        if n == 0:
            fail(f'the speaker classifier\'s path never launched '
                 f'{name}')
    attention_launches = {
        'fwd': sepformer_served + sepformer_trained['fwd']
        + sepformer_trained['fwd_train'],
        'bwd': sepformer_trained['bwd']}
    for name, n in attention_launches.items():
        if n == 0:
            fail(f'the SepFormer paths never launched the attention {name} '
                 f'kernel')
    # and the speech-recognition paths' (phase 37: the conformer, the
    # attention decoder; training and requests)
    asr_attention = asr_launches_['attention']
    attention_launches['fwd'] += asr_attention['fwd'] \
        + asr_attention['fwd_train']
    attention_launches['bwd'] += asr_attention['bwd']
    # the GRU kernels' launches: the TasNet paths with GRU chunk RNNs plus
    # the speaker classifier's
    gru_launches = {
        'fwd': served['bgru'] + trained['bgru']['fwd'] + speaker['fwd'],
        'fwd_train': trained['bgru']['fwd_train'] + speaker['fwd_train'],
        'bwd': trained['bgru']['bwd'] + speaker['bwd']}
    # and phase 38's: the speaker classifier and the distance estimator on
    # the real-audio path
    for name in gru_launches:
        gru_launches[name] += real_gru.get(name, 0)
    # and phase 40's: the classifier served from its artifact
    gru_launches['fwd'] += exported['gru fwd']
    for name, n in gru_launches.items():
        if n == 0:
            fail(f'the TasNet paths never launched the gru {name} kernel')
    if (sum(GRU_BWD_MAIN_ROUTES.values()) != gru_launches['bwd']
            or GRU_BWD_MAIN_ROUTES['resident'] == 0):
        fail(f'the GRU backward\'s launches by route '
             f'{GRU_BWD_MAIN_ROUTES} do not add up to its '
             f'{gru_launches["bwd"]} launches on the main paths, or none '
             f'took the resident route')
    # the LSTM kernels' launches: the uPIT paths, the TasNet paths with
    # LSTM chunk RNNs, OR-PIT, the mask estimator and deep clustering
    # (phases 34 to 36: training, validation and requests)
    new_paths = {
        name: orpit_trained[name] + me_trained[name] + dc_trained[name]
        + (orpit_served[name] + me_served['lstm'] + dc_served[name]
           if name == 'fwd' else 0)
        for name in ('fwd', 'fwd_train', 'bwd')}
    lstm_launches = {
        'fwd': launches['lstm_cell_scan'] + served['blstm']
        + trained['blstm']['fwd'] + new_paths['fwd'],
        'fwd_train': train_launches['fwd_train']
        + trained['blstm']['fwd_train'] + new_paths['fwd_train'],
        'bwd': train_launches['bwd'] + trained['blstm']['bwd']
        + new_paths['bwd']}
    # and the transducer's prediction network (phase 37: one direction)
    for name in lstm_launches:
        lstm_launches[name] += asr_launches_['lstm'][name]
    # and uPIT trained and served from WAV files (phase 38)
    for name in lstm_launches:
        lstm_launches[name] += real_lstm.get(name, 0)
    # and the flagship under the hooks and optimizers of phase 39
    for name in lstm_launches:
        lstm_launches[name] += trainer_launches[name]
    # and phase 40's: the flagship served from its artifacts, the online
    # enhancer's StatefulLSTM
    lstm_launches['fwd'] += exported['lstm fwd']
    for name, n in new_paths.items():
        if n == 0:
            fail(f'phases 34 to 36 never launched the lstm {name} kernel')
    print(f'launches on the main paths: lstm {lstm_launches} (uPIT serving '
          f'{launches["lstm_cell_scan"]}, uPIT training {train_launches}, '
          f'TasNet blstm serving {served["blstm"]}, training '
          f'{trained["blstm"]}); gru {gru_launches}; LSTM kernels at '
          f'DPRNN shapes (ms): {lstm_dprnn}; attention '
          f'{attention_launches} (SepFormer serving {sepformer_served} '
          f'lean forward, training {sepformer_trained}); wavenet_sample '
          f'{wavenet_launches} (the vocoder\'s requests); speaker '
          f'classifier {speaker}; int8_matmul {int8_launches} (one B=1 '
          f'decode of 128 tokens), {serve_launches} (16 batched requests); '
          f'bf16 lstm {lstm_bf16_launches} (the bf16 flagship: 20 training '
          f'steps, 4 requests); bf16 attention {attention_bf16_launches} '
          f'(the bf16 SepFormer step: 20 training steps); bf16 gru '
          f'{gru_bf16_launches} (the bgru DPRNN under the policy '
          f'{dprnn_bgru_launches}, the speaker classifiers '
          f'{speaker_bf16_launches}); of the lstm launches OR-PIT, the '
          f'mask estimator and deep clustering {new_paths} (OR-PIT '
          f'training {orpit_trained}, separate {orpit_served}; the mask '
          f'estimator training {me_trained}, requests {me_served}; deep '
          f'clustering served {dc_served}, a step {dc_trained}); the '
          f'speech-recognition paths (phase 37) {asr_launches_}; the '
          f'real-audio runs (phase 38) {real_audio}; the Trainer\'s hooks '
          f'and optimizers (phase 39) {trainer_launches}; the exported '
          f'artifacts, LoRA and the online enhancer (phase 40) {exported}')
    print('phase 39 flagship step ms by optimizer (host clock, B=4) and the '
          f'adversarial step on {CARD}: ' + json.dumps(
              {name: round(row['step_ms'], 3)
               for name, row in optimizer_rows.items()})
          + f', GAN vocoder {gan_step_ms:.3f}')
    # every row's numbers are those of its ``shape``: the GRU rows those of
    # the intra-chunk shape, which six of a TasNet's twelve chunk RNNs run
    # (phase 8 prints the rows of the other shapes, the classifier's two
    # among them); the LSTM rows those of the uPIT flagship layer
    gru_rows = gru[RECURRENCE_SHAPES[0][0]]
    flagship = 'T=500 D*B=32 H=600 ragged'
    bf16_rows = lstm_bf16[LSTM_BF16_SHAPES[0][0]]
    print('gru kernels at the speaker classifier\'s shapes: ' + json.dumps(
        {shape[0]: gru[shape[0]] for shape in CLASSIFIER_GRU_SHAPES}))
    # the attention rows are those of the intra-chunk shape (8 of a
    # model's 16 layers); the forward row counts lean and training launches
    attention_rows = attention[ATTENTION_CASES[0][0]]
    attention_bf16_rows = attention_bf16[ATTENTION_BF16_CASES[0][0]]
    gru_bf16_rows = gru_bf16[GRU_BF16_SHAPES[0][0]]
    kernels = [
        {'name': 'lstm_cell_scan', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/lstm_cell_scan.cu',
         'replaces': 'padertorch_tpu/ops/pallas/lstm.py:275',
         'launches': lstm_launches['fwd'], 'op': 'ptt::lstm_cell_scan',
         'shape': flagship, **lstm,
         'other_shapes': [rows['fwd'] for rows in me_rows.values()],
         'asr_shapes': [rows['fwd'] for rows in asr_lstm_rows.values()]},
        {'name': 'lstm_cell_scan_train', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/lstm_cell_scan.cu',
         'replaces': 'padertorch_tpu/ops/pallas/lstm.py:293',
         'launches': lstm_launches['fwd_train'], 'shape': flagship,
         **train_kernels['fwd_train'],
         'other_shapes': [rows['fwd_train'] for rows in me_rows.values()],
         'asr_shapes': [rows['fwd_train']
                        for rows in asr_lstm_rows.values()]},
        {'name': 'lstm_cell_scan_bwd', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/lstm_cell_scan_bwd.cu',
         'replaces': 'padertorch_tpu/ops/pallas/lstm.py:339',
         'launches': lstm_launches['bwd'], 'shape': flagship,
         **train_kernels['bwd'],
         'other_shapes': [rows['bwd'] for rows in me_rows.values()],
         'asr_shapes': [rows['bwd'] for rows in asr_lstm_rows.values()]},
        {'name': 'lstm_cell_scan_bf16', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/lstm_cell_scan.cu',
         'replaces': 'padertorch_tpu/ops/pallas/lstm.py:275',
         'launches': lstm_bf16_launches['fwd_bf16']
         + exported['lstm fwd_bf16'], 'op': 'ptt::lstm_cell_scan',
         'lstm_route': 'mma: bf16 mma.sync, W_hh in registers, h exchanged '
                       'as bf16',
         'shape': flagship + ' bf16', **bf16_rows['fwd']},
        {'name': 'lstm_cell_scan_train_bf16', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/lstm_cell_scan.cu',
         'replaces': 'padertorch_tpu/ops/pallas/lstm.py:293',
         'launches': lstm_bf16_launches['fwd_train_bf16'],
         'lstm_route': 'mma: bf16 mma.sync, W_hh in registers, h exchanged '
                       'as bf16',
         'shape': flagship + ' bf16', **bf16_rows['fwd_train']},
        {'name': 'lstm_cell_scan_bwd_bf16', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/lstm_cell_scan_bwd.cu',
         'replaces': 'padertorch_tpu/ops/pallas/lstm.py:339',
         'launches': lstm_bf16_launches['bwd_bf16'],
         'lstm_route': 'mma: bf16 mma.sync, W_hh in registers',
         'shape': flagship + ' bf16', **bf16_rows['bwd']},
        {'name': 'masked_istft', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/masked_istft.cu',
         'replaces': 'padertorch_tpu/ops/pallas/masked_istft.py:135',
         'launches': launches['masked_istft'] + me_served['masked_istft']
         + real_audio['masked_istft'] + exported['masked_istft'],
         'op': 'ptt::masked_istft',
         'launches_by_route': {
             **launches['masked_istft_routes'],
             # phases 35 and 38 check their route
             'fft': launches['masked_istft_routes']['fft']
             + me_served['masked_istft'] + real_audio['masked_istft']},
         'launches_mask_estimator': me_served['masked_istft'],
         'launches_real_audio': real_audio['masked_istft'],
         'shape': 'K=2 T=127 F=257', **istft[(2, 127)],
         'other_shapes': [me_istft]},
        {'name': 'gru_cell_scan', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/gru_cell_scan.cu',
         'replaces': 'padertorch_tpu/ops/pallas/gru.py:182',
         'launches': gru_launches['fwd'], 'op': 'ptt::gru_cell_scan',
         **gru_rows['fwd'],
         'distance_shapes': [rows['fwd']
                             for rows in distance_gru_rows.values()]},
        {'name': 'gru_cell_scan_train', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/gru_cell_scan.cu',
         'replaces': 'padertorch_tpu/ops/pallas/gru.py:198',
         'launches': gru_launches['fwd_train'], **gru_rows['fwd_train'],
         'distance_shapes': [rows['fwd_train']
                             for rows in distance_gru_rows.values()]},
        {'name': 'gru_cell_scan_bwd', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/gru_cell_scan_bwd.cu',
         'replaces': 'padertorch_tpu/ops/pallas/gru.py:259',
         'launches': gru_launches['bwd'],
         'launches_by_route': dict(GRU_BWD_MAIN_ROUTES), **gru_rows['bwd'],
         'distance_shapes': [rows['bwd']
                             for rows in distance_gru_rows.values()]},
        {'name': 'gru_cell_scan_bf16', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/gru_cell_scan.cu',
         'sources': ['padertorch_tpu_torch/csrc/gru_cell_scan.cu',
                     'padertorch_tpu_torch/csrc/gru_cell_scan_cluster.cu'],
         'replaces': 'padertorch_tpu/ops/pallas/gru.py:182',
         'launches': gru_bf16_launches['fwd_bf16'],
         'launches_by_route': GRU_BF16_MAIN_ROUTES['fwd_bf16'],
         'gru_routes': 'mma: bf16 mma.sync, W_hh in registers (H <= 128); '
                       'cluster: a thread-block cluster, h shared through '
                       'distributed shared memory (H above 128)',
         **gru_bf16_rows['fwd']},
        {'name': 'gru_cell_scan_train_bf16', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/gru_cell_scan.cu',
         'replaces': 'padertorch_tpu/ops/pallas/gru.py:198',
         'launches': gru_bf16_launches['fwd_train_bf16'],
         'launches_by_route': GRU_BF16_MAIN_ROUTES['fwd_train_bf16'],
         **gru_bf16_rows['fwd_train']},
        {'name': 'gru_cell_scan_bwd_bf16', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/gru_cell_scan_bwd.cu',
         'replaces': 'padertorch_tpu/ops/pallas/gru.py:259',
         'launches': gru_bf16_launches['bwd_bf16'],
         'launches_by_route': GRU_BF16_MAIN_ROUTES['bwd_bf16'],
         **gru_bf16_rows['bwd']},
        {'name': 'flash_attention', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/flash_attention.cu',
         'replaces': 'padertorch_tpu/ops/pallas/attention.py:328',
         'launches': attention_launches['fwd']
         + exported['attention fwd_train'], 'op': 'ptt::flash_attention',
         'attention_route': 'tensor cores, 3xTF32 mma.sync',
         'shape': ATTENTION_CASES[0][0], **attention_rows['fwd'],
         'asr_shapes': [{'shape': label, **rows['fwd']}
                        for label, rows in asr_attention_rows.items()]},
        {'name': 'flash_attention_bwd', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/flash_attention_bwd.cu',
         'replaces': 'padertorch_tpu/ops/pallas/attention.py:351',
         'launches': attention_launches['bwd']
         + exported['attention bwd'],
         'shape': ATTENTION_CASES[0][0], **attention_rows['bwd'],
         'asr_shapes': [{'shape': label, **rows['bwd']}
                        for label, rows in asr_attention_rows.items()]},
        {'name': 'flash_attention_bf16', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/flash_attention_fwd_bf16.cu',
         'replaces': 'padertorch_tpu/ops/pallas/attention.py:328',
         'launches': attention_bf16_launches['fwd_bf16']
         + attention_bf16_launches['fwd_train_bf16']
         + exported['attention fwd_bf16'], 'op': 'ptt::flash_attention',
         'attention_route': 'tensor cores, bf16 wgmma from TMA tiles',
         'shape': ATTENTION_BF16_CASES[0][0] + ' bf16',
         **attention_bf16_rows['fwd']},
        {'name': 'flash_attention_bwd_bf16', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/flash_attention_bwd_bf16.cu',
         'replaces': 'padertorch_tpu/ops/pallas/attention.py:351',
         'launches': attention_bf16_launches['bwd_bf16'],
         'attention_route': 'tensor cores, bf16 wgmma from TMA tiles, P '
                            'and dS in three bf16 pieces',
         'shape': ATTENTION_BF16_CASES[0][0] + ' bf16',
         **attention_bf16_rows['bwd']},
        {'name': 'wavenet_sample', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/wavenet_sample.cu',
         'replaces': 'padertorch_tpu/ops/pallas/wavenet.py:192',
         'launches': wavenet_launches, 'launches_by_route': wavenet_routes,
         **wavenet},
        {'name': 'fused_logmel', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/fused_logmel.cu',
         'replaces': 'padertorch_tpu/ops/pallas/logmel.py:78',
         'launches': speaker['fused_logmel'] + real_audio['fused_logmel']
         + exported['fused_logmel'], 'op': 'ptt::fused_logmel',
         **logmel},
        {'name': 'int8_matmul', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/int8_matmul.cu',
         'replaces': 'padertorch_tpu/ops/pallas/int8_matmul.py:85',
         'launches': int8_launches + exported['int8_matmul'],
         'op': 'ptt::int8_matmul', 'shape': 'M=1 K=1024 N=4096 bf16',
         **int8_row},
    ]
    print('bench.py flash_attention_causal_train_ms counterpart (ms): '
          + json.dumps(headline))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
