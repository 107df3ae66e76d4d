"""GPU smoke run of the PyTorch/CUDA port: builds the kernels, checks each
against its plain PyTorch twin on the card, drives the min-sum main path,
the SMNGDBF bit-flip path, the BP, layered and DD-BMP paths, the
hardware-model bit-flip paths (NGDBFhw, the SystemC model), the
streaming refill harness (the NGDBFhw stream among them), the
non-binary FFT-QSPA paths, the experiment tools (replay and trace,
redecode statistics, message tracing, the throughput report) and the
multi-device engine (the operating-point grid, a two-process group, the
sweep's ``--distributed`` routes, sharded streams) at full width, and
measures every kernel against its bounds.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``cuobjdump`` (``CUDA_HOME`` or
/usr/local/cuda) and this checkout.  Phases (any failed check raises and
the exit code is non-zero):

  1. the card (``nvidia-smi`` name, power limit and SM clocks);
  2. build the kernels from ``ldpcsimulation_tpu_torch/csrc`` (seconds, and
     the compiler's register report);
  3. kernel B1 (min-sum CN update) against its twin at the main path's
     shapes — qc_1008_504, B=32768, f16 and f32 storage, all three
     variants — equal bit for bit (int32 views: signed zeros too); its f16
     store (the flooding steps' instance) equal to the twin's and to the
     f32 output cast (int16 views);
  4. kernel B2 (Philox AWGN) against its twin: samples and 24-bit integers
     equal under ``torch.equal``, then the decode of those samples with the
     kernels equal bit for bit to the plain path's decode on the CPU;
  5. the main path: ``simulate`` on qc_1008_504 at 2.0 dB, T=10, f16
     storage, 4 batches of 32768 frames, with the launch counters reset just
     before and read just after — BER in [2.2e-2, 2.6e-2], B1 and B5 T
     times per batch, B2 and B6 once (B2 by its float4 instance); bit errors, word
     errors and iterations equal to the parent commit's run (the noise is
     keyed); decoded info bits/s and a per-layer time breakdown (B1's f16
     store, B5, the iteration);
  6. the sweep CLI in-process for one point, and its log row;
  7. kernel B3 (keyed Philox uniforms) against its twin at [1008 x 32768]
     in both layouts: equal under ``torch.equal``, on the 24-bit grid;
  8. kernel B4 (keyed erfinv Gaussians) against its twin, channel form
     (offset 1, scale sigma, [batch, n]) and decoder form (offset 0,
     [n, batch]): samples (infinities included) and integers equal under
     ``torch.equal``, and the channel form's moments;
  9. the GDBF decode on the card against the CPU plain path, bit for bit,
     for SMNGDBF, RSMNGDBF (3 phases) and StochasticNGDBF at 256 frames:
     the keyed draws are made on the card (B4/B3), copied to the CPU and
     injected there; the keyed card decode also equals the card decode
     with its own draws injected;
 10. the SMNGDBF main path: ``simulate`` on qc_1008_504 at 3.25 dB, T=300,
     4 batches of 32768 frames after a warm-up batch, counters reset just
     before and read just after — B2 launched once per batch, B4, B6 and
     B7 once per executed decoder step (B4 by its float2 instance), B1
     never; bit errors,
     word errors and iterations equal to the parent commit's run; BER, FER
     and average iterations within 4 joint standard errors of the JAX
     package's values; decoded info bits/s and a per-layer breakdown;
 11. the sweep CLI's gdbf route for one point each of ``SMNGDBF
     --uniform-noise`` and ``StochasticNGDBF --nq 3 --ymax 2.5``, counters
     reset before and read after: B3 launched, rows well formed;
 12. edge shapes: B2, B3 and B4 (both layouts), with and without the
     integers, against their twins under ``torch.equal`` on shapes that
     reach the wide-store and the tail instances, from a first frame just
     below 2^32; the launches each instance took;
 13. bounds of every kernel at the main path's shapes: its time, its plain
     twin's, the nearest PyTorch call's (same work, not the same function),
     the memory bound (bytes over 3.35 TB/s), the operation bound (f32
     operations over 67 TFLOP/s), the roofline share (the larger bound over
     the time), the issue bound as a diagnostic (the SASS instructions on
     one thread's path, ``tools/sass_count.py``, over 132 SMs x 4 warp
     instructions per clock at the maximum SM clock) and its share, and
     the launches per batch on each path.
 14. kernel B1 against its twin bit for bit on tied messages in the forms
     of the slot-array and generalized QC paths: the generic slot form on
     peg_1008_504 (B=32768, f16 and f32), highrate_2048_384 (dc_max 33,
     B=32768, all three variants), highrate_4376_282 (dc_max 63), the
     generalized plan of dvbs2_1_2_qc (pairs and an absent edge, B=8192),
     a synthetic table of 70000 checks (past grid y's 65535), an odd batch
     (B=32771, f16 and f32, three variants: the 1-lane instance) and a
     view two elements into its buffer (the 2-lane instance), each f16
     form also with the f16 store; each form's time, plain twin's time,
     memory bound, roofline share and issue bound, and the f16 store's
     time and bound;
 15. the card against the CPU plain path, bit for bit, on the card's
     samples: ``decode_minsum`` on peg_1008_504, ``decode_minsum_qc`` on
     dvbs2_1_2_qc and wifi_1944_972 (the offset variant on
     ``quantize_no_zero`` samples), 256 frames each (dvbs2_1_2_qc 64), T=10;
 16. the slice's path at full width: ``simulate`` with ``decode_minsum`` on
     peg_1008_504 at 2.0 dB, T=10, f16 storage, 4 batches of 32768 frames
     after a warm-up, counters reset just before and read just after — BER
     and FER within 4 joint standard errors of the JAX package's CPU run
     (``tests/jax_reference_stats.py``), decoded info bits/s and a per-layer
     breakdown; then one dvbs2_1_2_qc point at B=32768 on real codewords
     (``dvbs2_rate12_encode``, every word checked against H), its peak
     device memory under ``DVBS2_PEAK_GIB``;
 17. the sweep CLI's new routes for one point each: ``--alist`` on a
     temporary alist of qc_1008_504 (the "detected QC" note),
     ``offsetminsum`` on wifi_1944_972 and ``normalizedminsum`` on
     peg_1008_504;
 18. the row-layered min-sum decoder and DD-BMP on the card against the CPU
     plain path under ``torch.equal`` on hard decisions, iterations and
     flags: layered min-sum on qc_1008_504 (plain, f16; 256 frames),
     wifi_1944_972 (normalized; 256) and dvbs2_1_2_qc (offset, on
     ``quantize_no_zero`` samples; 32), with B11 counted once per pair-free
     layer and B1 once per pair layer of each executed iteration, and never
     their twins; DD-BMP on qc_1008_504 (QC form; 256) and
     reg4_4000_2000 (generic, T=100; 64);
 19. sum-product BP on the card against the CPU plain path, by tolerance
     (CUDA's ``exp``/``log`` differ from the CPU's by ulps): one check update
     each of ``bp_cn_update``, ``qc_cn_bp`` and ``qc_bp_layered_step`` within
     ``BP_RTOL``/``BP_ATOL``, and T=20 decodes of 256 frames (slot-array, QC
     with f16 storage and early termination, layered) agreeing in at least
     ``BP_FRAME_AGREEMENT`` of the frames; then the slot-array, stratified
     and layered routes on kernel B8 against their plain bodies from before
     it (``tests/frozen_bp.py``) on the card, bit for bit: ``bp_cn_update``
     on peg_1008_504 and wifi_1944_972 (f16, f32; peg_1008_504 f16 also
     at B=32768, the batch of [21]'s decode_bp), ``stratified_bp_step`` on
     [42]'s 802.3an geometry (f16, f32), ``qc_bp_layered_step`` on
     wifi_1944_972 and dvbs2_1_2_qc (pairs, an absent edge), B8 launched
     once an update (Mb times a layered step);
 20. kernel B1 at a layer's shape (one base row of qc_1008_504,
     wifi_1944_972 and dvbs2_1_2_qc; f32, tied samples, all three variants)
     against its twin bit for bit, with its time per launch (behind a long
     sleep kernel: device time, not the host's enqueue rate) and its bounds;
 21. ``simulate`` at full width (B=32768), counters reset just before and
     read just after, each gated within 4 joint standard errors of the JAX
     package's CPU run at the same point (``tests/jax_reference_stats.py``):
     (a) ``decode_bp`` on peg_1008_504 at 1.6 dB, T=20, f32; (b)
     ``decode_bp_qc`` on qc_1008_504 at 2.0 dB, T=20, early termination, f16;
     (c) ``decode_minsum_layered_qc`` on wifi_1944_972 at 2.0 dB, T=10, early
     termination, with flooding min-sum beside it (both BERs and average
     iterations), B11 launched Mb per executed iteration; (d) ``decode_ddbmp``
     on reg4_4000_2000 at 3.9 dB, Ymax 1.6, 8 levels, T=100; decoded info
     bits/s, ms per iteration, peak memory and a breakdown for each;
 22. the sweep CLI's ``bp``, ``bp --schedule layered``, ``minsum --schedule
     layered`` and ``ddbmp`` routes, one point each;
 23. the fixed-point NGDBFhw on the card against the CPU plain path under
     ``torch.equal`` on hard decisions, iterations, flags, least errors and
     ring pointers: qc_1008_504 (QC row gathers; 256 frames) and
     highrate_2048_384 (generic; 128), one and three phases, with and
     without per-lane ``qpointer0``, T=60; the ring drawn by B4 once per
     decode on the card, copied to the CPU and injected there;
 24. the SystemC-model NGDBF on the card against the CPU plain path under
     ``torch.equal``: peg_1008_504, 3.0 dB, T=100, smoothed and unsmoothed,
     256 frames, the source stream drawn by B4 on the card and injected on
     the CPU;
 25. both at full width through ``simulate`` (B=32768, 2 batches after a
     warm-up, counters reset just before and read just after: B2 and B4 once
     per batch each): NGDBFhw on highrate_2048_384 at 4.25 dB, T=600, the
     802.3an defaults, one phase; the SystemC model on peg_1008_504 at 3.0
     dB, T=300, additive channel, smoothed; BER, FER and average iterations
     within 4 joint standard errors of the JAX package's CPU runs
     (``JAX_POINTS``); decoded info bits/s, ms per step, peak memory; then
     B4 at the ring's [2648 x 32768] and the source's [1308 x 32768] shapes
     against its twin, with times and bounds;
 26. the sweep CLI's ``ngdbfhw`` route with ``--persistent-qpointer`` and
     ``--itdist-biased`` (its row and its itdist file), and its refusal of
     ``--stream`` with the pointer carry (the JAX CLI's message);
 27. the streaming harness on the card against the CPU plain path: every
     binary stream adapter (QC and slot-array min-sum, layered min-sum, QC
     and slot-array DD-BMP, QC, slot-array and layered BP) and the GDBF
     stream (SMNGDBF, RSMNGDBF with 3 phases, StochasticNGDBF), 64 lanes
     over a pool of 256 frames drawn by B2 on the card: the recorded
     frames (gid, iterations, errors, decisions; phases, satisfied flags
     and smoothing uses for GDBF) and the counters equal under
     ``torch.equal``, BP by frame agreement; then B3/B4's per-lane
     instances against their twins (scattered int64 gids and steps, both
     domains and layouts, with the integers) at [1008 x 32768] and
     [33 x 1007], and against the contiguous kernels on contiguous gids,
     with times and bounds;
 28. the stream paths at full width (32768 lanes), counters reset just
     before and read just after: ``bp_qc_stream`` (qc_1008_504, 2.0 dB,
     T=20, f16), ``minsum_layered_qc_stream`` (wifi_1944_972, 2.0 dB,
     T=10), ``ddbmp_stream`` (reg4_4000_2000, 3.9 dB, T=100) and
     ``simulate_stream_gdbf`` SMNGDBF ([10]'s point), each gated within 4
     joint standard errors of the JAX package's CPU run, its integer
     totals equal to the batch decoder's on the card over the same 4096+
     frame prefix (2048 lanes), with decoded info bits/s, lane-iterations
     per counted frame against the batch path's rounds, peak memory, the
     launches, and one normal call's steady state and host syncs (zero,
     ``torch.cuda.set_sync_debug_mode``);
 29. the sweep CLI's ``--stream`` routes (QC min-sum, QC and layered BP,
     DD-BMP, ``gdbf --uniform-noise``), one row each;
 30. the NGDBFhw stream (``harness/stream_ngdbfhw.py``) recorded on the card
     and on the CPU plain path over one B2 pool (highrate_2048_384 with one
     phase, refill every 16 steps and a refill cap of 32 of 64 lanes, and
     with three phases every 4 steps; qc_1008_504 on the QC graph
     operations): records (gid, least iterations, least errors,
     exit-satisfied, ring offset, decisions) and counters equal under
     ``torch.equal``, B2 once and B4's per-lane entry once per boundary;
     B4's per-lane entry on the ring's stream (``lane_rings``) against its
     twin at [2648 x 32768] and [2648 x 33] (gids from 2^31, with the
     integers), against ``keyed_ring`` on contiguous gids past 2^31, with
     times and bounds at the refill shapes; the NB decoders card against
     CPU on ``nb_regular(480, 320, 3, q)`` for q = 4, 8, 16 (the three
     check-node forms): one check update's normalized probabilities within
     ``NB_PROB_ATOL`` (f16 storage: plus two f16 ulps of the log values),
     T=10 decodes agreeing on ``NB_FRAME_AGREEMENT``
     of 128 frames in f32 and f16 storage, min-sum and min-max under
     ``torch.equal`` on the same negative logs; the NB stream on the card
     equal frame by frame to the batch decoder on the card, and agreeing
     with the CPU stream;
 31. at full width, counters reset just before and read just after: (a)
     ``simulate_stream_ngdbfhw`` on highrate_2048_384 at 4.25 dB, T=600,
     the 802.3an defaults, one phase, 32768 lanes refilled every 16 steps
     (4 x 32768 frames), gated within 4 joint s.e. of the JAX CPU run
     (BER, FER, average iterations), then a 2048-lane recorded stream over
     4096 frames equal frame by frame to the batch decoder on the card at
     the recorded ring offsets, the steady state with its host syncs (zero)
     and one step's and one boundary's device time; (b) the NB path on
     ``nb_regular(6000, 4000, 3, q=8, seed=0)`` at 1.3 dB, T=20, f16
     storage: ``simulate_stream_nb`` (512 lanes, refill every iteration,
     16 x 512 frames) and ``simulate_nb`` (B=512) over the same frames,
     each gated within 4 joint s.e. of the JAX CPU run (SER, BER, FER,
     average iterations), their totals equal; bits/s, lane-iterations per
     frame, ms per iteration, peak memory and the NB layers' times;
 32. B2 against its twin at the NB batch [512 x 18000] and at the NB and
     NGDBFhw stream pools' shapes, with times and bounds;
 33. the sweep CLI's ``ngdbfhw --stream`` and ``nbqspa`` routes
     (``--nb-random``, ``--stream``, an NB alist), one row each, and the
     refusals of ``--stream --persistent-qpointer`` and of ``--distributed
     nbqspa`` with two SNRs on one slot (the JAX CLI's messages);
 34. replay and trace (``tools/replay.py``): for SMNGDBF at [10]'s point,
     StochasticNGDBF (3.0 dB, T=100) and SMNGDBF with uniform noise, one
     batch of 32768 frames at batch index 2 decoded on the card, then 4
     failed and 4 satisfied frames replayed through ``replay_channel`` and
     ``trace_gdbf`` at B=1 on the card: iterations, flag and last row
     equal to the in-batch decode; the same traces on the CPU with the
     card's keyed draws injected, every row equal; B2, B3 and B4 at batch 1
     against their twins and the batch draw's row or column, with the
     instance each took, its device time and its bounds;
 35. ``redecode_statistics`` on qc_1008_504 at 3.5 dB (SMNGDBF, T=300, the
     CLI defaults), 200 frames x 100 attempts in one decode of [1008 x
     20000]: wall seconds, decoded frames/s, peak memory; the mean Pe(f)
     and the share of frames with Pe > 0 within 4 joint standard errors of
     the JAX tool's CPU run (``JAX_REDECODE``); three attempts re-decoded
     alone at B=1 with equal error weights; B4 at [1008 x 20000] against
     its twin with its bounds;
 36. ``trace_soft_decoder`` on a peg_1008_504 frame on the card and the
     CPU: min-sum equal (B1 once per iteration at B=1), BP decisions and
     sign errors equal and each iteration's messages within
     ``BP_RTOL``/``BP_ATOL``; B1 at B=1 against its twin with its time;
     ``perf_report``'s flagship row and its SM-NGDBF working-point row
     beside [5]'s and [10]'s rates (not gated on time);
 37. the grid engine (``parallel/``): ``init_distributed`` (NCCL, a group
     of one on cuda:0); ``simulate_distributed`` on the default mesh's one
     slot at [5]'s point, its totals equal to [5]'s ``PARENT_TOTALS`` (the
     same frames), its rate beside [5]'s; ``simulate_grid`` on a 4-slot
     mesh repeating cuda:0 over an SMNGDBF grid (qc_1008_504, 3.0 and 3.25
     dB x lambda 0.99 and 0.995, T=100, 2 rounds of 32768 frames per slot),
     every point's counters equal to ``simulate``'s over its frames, the
     3.0 dB, lambda 0.99 point within 4 joint s.e. of the JAX grid's
     (``JAX_GRID``), grid and point-by-point rates, ms per round;
 38. two processes, the ranks of one gloo group (the backend given: NCCL
     refuses two ranks on one card), both on cuda:0 with one slot each:
     two rounds of a 2-point grid step (normalized QC min-sum at B=32768)
     and a 2-slot ``simulate_stream``, every rank's all-reduced counters
     equal to this process running the same mesh alone;
 39. ``sweep --distributed --resume`` on the card: min-sum (two SNRs),
     SMNGDBF (two lambdas) and its uniform-noise form, NGDBFhw
     (highrate_2048_384, T=100, its itdist file) and nbqspa (GF(8) at 1.3
     dB), every row equal to the port's ``simulate`` (or ``simulate_nb``)
     over its frames with the route's decode, the JAX CLI's resume keys;
     then ``simulate_stream`` (QC min-sum, f16) and the GDBF stream
     (SMNGDBF, StochasticNGDBF) on a 2-slot mesh of cuda:0, recorded:
     every retired frame equal to its batch decode on the card, each
     slot's gids inside its windows, no host sync in a normal call;
 40. the dense graph route (``decoders/dense_ops.py``, the sweep's route
     for the bit-flip decoders on codes without QC structure): its four
     operations against the slot-array gathers on random decisions at
     B=32768 on highrate_2048_384 and peg_1008_504 under ``torch.equal``
     (values and dtypes), each timed beside its gathers with its memory
     and f16 tensor-core bounds; ``decode_ngdbf_hw`` at [25]'s point (T=600,
     one batch of 32768) and SMNGDBF ``decode_gdbf`` at [10]'s point on
     peg_1008_504, dense against generic under ``torch.equal``, with ms per
     step of both routes (two runs each, alternated; each decode's
     launches read on their own); the NGDBFhw stream with ``dense=`` (2048
     lanes, 4096 frames) equal frame by frame to the generic batch decode
     at the recorded ring offsets; ``simulate_stream_ngdbfhw`` with
     ``dense=`` at [31]'s full width (32768 lanes, 4·32768 frames), gated
     on the JAX point, its totals and histograms those of the generic
     stream; ``simulate_stream_gdbf`` SMNGDBF with ``dense=`` on
     peg_1008_504 (32768 lanes, 2·32768 frames), its totals those of the
     dense batch decoder over the same gids; the sweep's ``ngdbfhw --code
     highrate_2048_384`` route building a ``DenseGraph``, its row and
     itdist file those of the generic route; slot-array min-sum T=10 on
     highrate_2048_384 against its memory bound.  Every dense run's
     launches are read from a window of its own;
 41. the public surface: the ``examples/compare_decoders_torch.py`` rows
     (4096 frames each at 2.5 dB) equal to ``simulate`` with the same
     arguments; ``native.parse_alist_native`` equal to the Python parser on
     highrate_2048_384's alist, a GF(8) alist and the packaged one;
 42. the stratified family on the 802.3an geometry (the script's own
     generator: 2048 columns, 6 strata of 64 rows, dv 6, dc 32, not QC):
     the structure (6 x 64 strata, 60 groups of up to 47 columns); min-sum
     (plain, normalized 1.3, offset 0.15; f16, early termination) and
     DD-BMP card vs CPU and card stratified vs card slot-array under
     ``torch.equal``, BP by tolerance (one step) and frame agreement, over
     256 frames; both stratified streams at 64 lanes, every frame equal to
     the batch decode; the sweep's stratified routes (minsum,
     offsetminsum, normalizedminsum, bp, ddbmp, minsum and bp --stream),
     one row each, every bp row on B8 (on the slot arrays past 64
     groups); B1's and B8's refusal of more than 64 column groups; min-sum
     T=10 f16 at B=32768, 4.25 dB (counts from 0: B1 launched T times),
     decisions equal to ``decode_minsum``'s, ms per iteration in turns
     with it, peak memory; B1 at the stratified table's instance against
     its twin and its bounds;
 43. kernel B5 (the flooding min-sum VN update, in place over c2v) against
     its twin bit for bit (int16/int32 views) on four tables — QC
     qc_1008_504, slot-array peg_1008_504, the generalized dvbs2_1_2_qc
     plan (pairs, an absent edge) and the irregular slot array of
     wifi_1944_972 (dv_max 11, padding slots) — in f16 and f32 storage with
     f32 and f16 channels, at B=32768, 32770, 32771 and 1 (the 4-, 2- and
     1-lane instances; the DVB-S2 twin on 4096-lane chunks); each table's
     time at B=32768, its twin's, the memory bound and the roofline share;
 44. kernel B6 (the parity check) against its twin under ``torch.equal``
     (satisfied flags and the bipolar syndrome) on every caller's table at
     B=32768 — the QC min-sum check of qc_1008_504 and its QCGraph
     syndrome (int32 and int8), peg_1008_504, dvbs2_1_2_qc, the
     stratified 802.3an table — and at an odd batch and a misaligned view
     (the 1-lane instance); kernel B7 (the parallel GDBF step) against its
     twin bit for bit (d, the thresholds' int32 views, the smoothing sums)
     in all 16 parallel flag combinations on qc_1008_504 with int8
     decisions, a quarter of the lanes inactive, then int32 decisions, the
     slot-array graph of peg_1008_504 and an odd batch; each form's time,
     its twin's, the memory bound and the roofline share.  B6 counts on
     every path that checks decisions and B7 on every parallel bit-flip
     path are part of the launch checks above;
 45. the bit-flip decoder's chunk path (``kernels.gdbf.gdbf_chunk``: the
     steps between two exit checks in one C call, with the ``[B]``
     bookkeeping as one kernel) against its per-step loop on the card,
     bit for bit on every result field and the step count: SMNGDBF at
     [10]'s point (T=300) at B=32768 and 32771 (the 1-lane instances),
     RSMNGDBF with three phases of T=41 (restarts inside chunks, the
     per-VN weight) and the noiseless SATGDBF; B4, B6 and B7 launched
     once a step on both paths, the bookkeeping kernel once a step on
     the chunks, every step counted on its path; the T=300 decode's time
     on each path, alternated.  [9], [10] and [37] count the bookkeeping
     kernel, and [10] gates that every step took the chunks;
 46. kernel B8 (the sum-product check update) against its twin bit for bit
     (int32 views: signed zeros too) through ``qc_cn_bp`` on qc_1008_504
     (B=32768, f16 and f32), wifi_1944_972, the generalized dvbs2_1_2_qc
     plan (pairs, an absent edge; B=2048), a qc_peg base of dc_max 10 and
     two-row bases of dc_max 24 and 48 (the 16-, 32- and 64-slot caps), an
     odd batch (B=32771, the 1-lane instances) and a view two f16 elements
     into its buffer (the 2-lane instance); each form's time per launch
     behind a long sleep kernel, its twin's, the memory and issue bounds;
     then a T=20 early-terminating ``decode_bp_qc`` (f16, B=32768) with B8
     launched once a round and the twin never, its results equal to the
     same decode with the twin in the kernel's place;
 47. kernel B9 (the sum-product VN update) against its twin bit for bit
     (int views: signed zeros, NaN, the ±20 clip) through ``bp_vn_update``
     on qc_1008_504 (B=32768, f16 and f32 storage, f32 and f16 channel),
     wifi_1944_972 (dv_max 11, past the terms held in registers), the
     generalized dvbs2_1_2_qc plan (B=2048), an odd batch (B=32771, the
     1-lane instances) and c2v a view two f32 elements into its buffer
     (the 2-lane instance); each form's time per launch behind a long
     sleep kernel, its twin's and the memory bound; then a T=20
     early-terminating ``decode_bp_qc`` (f16, B=32768) with B9 launched
     once a round and the twin never, its results equal to the same
     decode with the twin in the kernel's place;
 48. kernel B10 (the early-termination decision merge, in place) against
     its twin bit for bit, synchronized after each launch, on the
     DVB-S2 posterior ([64800, 8192] f32), qc_1008_504's ([1008, 32768]
     f32, f16 and bf16) and an odd batch ([1008, 32771] f32, the 1-lane
     instance), each holding ±0.0, NaN and ±inf with half the frames done;
     each form's time per launch, its least time by the byte count of
     ``et_merge_roofline_pct`` and its twin's time; then one decode of
     each early-terminating cell's configuration (DVB-S2 min-sum T=50 at
     1.6 dB, B=8192; BP T=20 at 2.0 dB, B=32768; f16 messages) with B10
     launched once per executed round, by its wide instance, and the twin
     never, the results equal to the same decode on the twin;
 49. kernel B11 (one layer of row-layered min-sum: the posterior in place,
     new messages) against its twin bit for bit (int views: signed zeros,
     NaN, ±inf, the f16 clamp), layer by layer, synchronized after each
     launch: wifi_1944_972 at B=32768 (f16 and f32 storage; normalized
     α=1.25, offset δ=0.15, plain), an odd batch (B=32771, the 1-lane
     instance), dvbs2_1_2_qc's pair-free layers (an absent edge among them;
     B=8192) and a qc_peg base of dc_max 10 and two-row bases of dc_max 24
     and 48 (the 16-, 32- and 64-slot caps); each form's time per launch
     of its first layer, its least time by the byte count of
     ``layer_step_roofline_pct`` and its twin's time; then the layered
     cell's decode (B=32768, normalized α=1.25, T=30 with early
     termination, f16 messages, 2.2 dB quantized to 8 levels) with B11
     launched Mb times per executed round by its 4-lane instance and B1
     never, its results equal to the decode on the step from before B11
     (``tests/frozen_layered.py``).

The last three lines are the card, one JSON object describing the kernels
(each with the launches of the path that runs it and its bounds) and one
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CODE = "qc_1008_504"
BATCH = 32768
SNR_DB = 2.0
T = 10
SEED = 2024

# The SMNGDBF path: the reference's ngdbf_example_PEGReg504x1008.sh point
# with the working alpha of docs/VALIDATION.md, on qc_1008_504.
GDBF_SNR_DB = 3.25
GDBF_T = 300
GDBF_KW = dict(theta=-0.9, noise_scale=0.975, lam=0.988, alpha=0.75,
               window_size=64)
GDBF_YMAX = 2.5
# The JAX package's statistics at that point (its CPU run, 131072 frames,
# seed 0; PERF.md): (value, standard error).
JAX_SMNGDBF = dict(
    ber=(2.676872980026972e-04, 1.0231122548830475e-05),
    fer=(1.318359375e-02, 3.1505046386775366e-04),
    avg_iterations=(73.43167877197266, 0.13458862689481313),
)
# (bit errors, word errors, total iterations) of the two ``simulate`` runs
# ([5] min-sum, [10] SMNGDBF) in the parent commit's chip_smoke.py on the
# card: the noise is keyed and the kernels equal their twins, so a change
# of kernel must give the same integers.
PARENT_TOTALS = dict(minsum=(3156026, 84885, 1310720),
                     smngdbf=(33190, 1761, 9631883))
# The slot-array path [16]: peg_1008_504, 2.0 dB, T=10, f16 storage.  The
# JAX package's decode_minsum there (its CPU run, 131072 frames, seed 0,
# ``python -m tests.jax_reference_stats minsum_peg``): (value, s.e.).
PEG_CODE = "peg_1008_504"
JAX_PEG_MINSUM = dict(
    ber=(0.024125386798192584, 8.639914746255443e-05),
    fer=(0.6111602783203125, 0.0013465048084980611),
)
DVBS2_CODE = "dvbs2_1_2_qc"
ODD_BATCH = 32771  # B1's 1-lane instance
DVBS2_BATCH = 8192  # B1's DVB-S2 form: its twin's f32 temporaries
DVBS2_POINT_BATCH = BATCH  # [16]'s DVB-S2 point (B1 and B5 store f16)
DVBS2_PEAK_GIB = 70.0
DVBS2_SNR_DB = 2.5

# The BP, layered and DD-BMP paths [21].  The JAX package's CPU runs at the
# same points (seed 0, ``python -m tests.jax_reference_stats <point>``; the
# frame counts are chosen so that each run takes a few minutes at most on the
# CPU: 131072 for the BP points, 65536 for the layered one, 16384 for
# DD-BMP): (value, standard error).
JAX_POINTS = dict(
    bp_peg=dict(  # 131072 frames
        ber=(0.01319847409687345, 7.337482435187254e-05),
        fer=(0.2583160400390625, 0.0012090107639789614)),
    bp_qc=dict(  # 131072 frames
        ber=(0.0020970541333395335, 3.0072514725982847e-05),
        fer=(0.05408477783203125, 0.0006247534586913568),
        avg_iterations=(9.926643371582031, 0.010502526341304346)),
    minsum_layered_wifi=dict(  # 65536 frames
        ber=(0.002326400191695602, 5.787675797763303e-05),
        fer=(0.0540618896484375, 0.0008833585297688832),
        avg_iterations=(6.363555908203125, 0.0064888559138918875)),
    ddbmp_reg4=dict(  # 16384 frames
        ber=(0.00205279541015625, 6.742019045496297e-05),
        fer=(0.17010498046875, 0.002935351567318561),
        avg_iterations=(50.1552734375, 0.22792395690114237)),
    ngdbfhw_highrate=dict(  # 65536 frames
        ber=(0.0004718899726867676, 1.846390349252273e-05),
        fer=(0.0110015869140625, 0.0004074604862350933),
        avg_iterations=(48.49998474121094, 0.30050957640179926)),
    systemc_peg=dict(  # 65536 frames
        ber=(0.003871675521608383, 7.604523978040917e-05),
        fer=(0.0428619384765625, 0.0007911944503361386),
        avg_iterations=(68.33592224121094, 0.23725365977424873)),
    nbqspa_gf8=dict(  # 4096 frames, 1393 word errors
        ser=(0.021400105794270832, 0.0007956466506496585),
        ber=(0.009873521592881945, 0.00036239711103423815),
        fer=(0.340087890625, 0.007402163252668095),
        avg_iterations=(18.515625, 0.02625371543273826)),
)
WIFI_CODE = "wifi_1944_972"
REG4_CODE = "reg4_4000_2000"
# BP on the card against the CPU: |card - cpu| <= BP_ATOL + BP_RTOL * |cpu| on
# every output of one check update (messages within +-20; CUDA's exp and log
# are a few ulps from the CPU's, and the log of a ratio near 1 turns an ulp
# of the ratio into ~1e-7 absolute), and the share of frames whose T=20
# decisions must agree in every bit.
BP_RTOL, BP_ATOL = 2e-5, 2e-5
BP_FRAME_AGREEMENT = 0.97

# The hardware-model paths [23]-[26]: NGDBFhw on the registry's
# 802.3an-class code with the 802.3an defaults (the JAX CPU run counts 721
# word errors there), and the SystemC model at docs/VALIDATION.md's
# operating point.
HW_CODE = "highrate_2048_384"
HW_SNR_DB, HW_T = 4.25, 600
SYSTEMC_SNR_DB, SYSTEMC_T = 3.0, 300
SYSTEMC_KW = dict(theta=-0.5, lam=0.975, alpha=0.95, ymax=3.0, nq_levels=16,
                  smoothed=True)

# The card's peaks (H100 SXM at 700 W: HBM3 rate and FP32 vector rate).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SMS = 132


START = time.perf_counter()


def header(text: str) -> None:
    """A phase's first line, with the seconds since the script started."""
    print(f"{text}  (+{time.perf_counter() - START:.1f} s)", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def b6_and_rest(launches) -> tuple[int, dict]:
    """(B6's launches, the others): the paths whose parity checks depend on
    the data (early exits) check B6 apart from their exact counts."""
    rest = dict(launches)
    return rest.pop("parity_check", 0), rest


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sm_clocks() -> tuple[float, float]:
    """(current, maximum) SM clock in MHz, as ``nvidia-smi`` reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    cur, top = out.stdout.strip().splitlines()[0].split(",")
    return float(cur), float(top)


def time_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events), after
    one warm-up call.  A sleep kernel ahead of the start event keeps the
    card busy while the host enqueues the calls, so a short kernel's time
    is not its launch overhead."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tied_messages(gen, rows, batch, dtype, device):
    """Messages with exact ties, zeros and -0.0 (the scan's hazards)."""
    v = torch.round(torch.randn(rows, batch, generator=gen, device=device)
                    * 4.0) / 2.0
    neg_zero = torch.rand(rows, batch, generator=gen, device=device) < 0.05
    v = torch.where(neg_zero, torch.full_like(v, -0.0), v)
    return v.to(dtype)


def same_bits(got, want) -> bool:
    """f32 or f16 tensors equal bit for bit (``torch.equal`` takes -0.0 for
    0.0, and B1's outputs carry signed zeros)."""
    if got.dtype != want.dtype:
        return False
    it = torch.int16 if got.dtype == torch.float16 else torch.int32
    return torch.equal(got.view(it), want.view(it))


def phase_b1(qc, device, batch, sigma, timer):
    """Kernel B1 against its twin at the main path's shapes.  Returns
    (max |kernel - plain|, {dtype: (kernel ms, plain ms)})."""
    from ldpcsimulation_tpu_torch.decoders.minsum_qc import (
        qc_plan,
        qc_ragged_init,
    )
    from ldpcsimulation_tpu_torch.kernels.channel import awgn_philox
    from ldpcsimulation_tpu_torch.kernels.minsum import (
        minsum_cn_scan,
        minsum_cn_scan_plain,
    )

    plan = qc_plan(qc, device)
    gen = torch.Generator(device=device).manual_seed(7)
    y = awgn_philox(SEED, 0, batch, qc.n, sigma, device)
    times, max_err = {}, 0.0
    for dtype in (torch.float16, torch.float32):
        states = {
            "channel": qc_ragged_init(qc, y.t().contiguous(), dtype),
            "tied": tied_messages(gen, plan.num_planes * qc.z, batch, dtype,
                                  device),
        }
        for variant, kw in (("plain", {}), ("normalized", {"alpha": 0.8}),
                            ("offset", {"delta": 0.15})):
            for name, v2c in states.items():
                got = minsum_cn_scan(v2c, plan.cn_rows, variant, **kw)
                want = minsum_cn_scan_plain(v2c, plan.cn_rows, variant, **kw)
                max_err = max(max_err, float((got - want).abs().max()))
                check(same_bits(got, want),
                      f"B1 {variant} {dtype} {name}: kernel != plain")
                if dtype == torch.float16:  # the storage-typed store
                    got16 = minsum_cn_scan(v2c, plan.cn_rows, variant,
                                           out_dtype=dtype, **kw)
                    want16 = minsum_cn_scan_plain(v2c, plan.cn_rows, variant,
                                                  out_dtype=dtype, **kw)
                    check(same_bits(got16, want16)
                          and same_bits(got16, want.half()),
                          f"B1 f16 store {variant} {name}: kernel != plain "
                          "or != the f32 output cast")
            print(f"  B1 {variant:10s} {str(dtype):13s} equal (2 states"
                  + (", f32 and f16 stores)" if dtype == torch.float16
                     else ")"))
        v2c = states["channel"]
        if dtype == torch.float16:
            v2c16 = v2c  # the main path's state
        times[dtype] = (
            timer(lambda: minsum_cn_scan(v2c, plan.cn_rows)),
            timer(lambda: minsum_cn_scan_plain(v2c, plan.cn_rows), 3),
        )
        print(f"  B1 {str(dtype)} kernel {times[dtype][0]:.4f} ms, plain "
              f"{times[dtype][1]:.4f} ms per call [{plan.num_planes * qc.z}"
              f" x {batch}]")
    f16 = torch.float16  # the main path's store
    times["f16 store"] = (
        timer(lambda: minsum_cn_scan(v2c16, plan.cn_rows, out_dtype=f16)),
        timer(lambda: minsum_cn_scan_plain(v2c16, plan.cn_rows,
                                           out_dtype=f16), 3),
    )
    print(f"  B1 f16 store kernel {times['f16 store'][0]:.4f} ms, plain "
          f"{times['f16 store'][1]:.4f} ms per call (the main path's "
          "instance)")
    return max_err, times


def phase_b2(qc, device, batch, sigma, timer):
    """Kernel B2 against its twin, then the decode of its samples."""
    from ldpcsimulation_tpu_torch.decoders import decode_minsum_qc
    from ldpcsimulation_tpu_torch.kernels.channel import (
        awgn_philox,
        awgn_philox_plain,
    )

    y, bits = awgn_philox(SEED, 5 * batch, batch, qc.n, sigma, device,
                          with_bits=True)
    y_p, bits_p = awgn_philox_plain(SEED, 5 * batch, batch, qc.n, sigma,
                                    device, with_bits=True)
    check(torch.equal(bits, bits_p), "B2 24-bit integers: kernel != plain")
    err = float((y - y_p).abs().max())
    check(torch.equal(y, y_p), f"B2 samples: kernel != plain (max |dy| "
          f"{err})")
    check(torch.equal(awgn_philox(SEED, 5 * batch, batch, qc.n, sigma,
                                  device), y_p),
          "B2 without integers: kernel != plain")
    print(f"  B2 samples and integers equal to the twin's ({y.numel()} "
          "samples, with and without the integers)")
    check(abs(float(y.mean()) - 1.0) < 2e-3
          and abs(float(y.std()) - sigma) < 2e-3, "B2 moments")

    sdt = torch.float16
    sub = min(batch, 4096)
    for et, rows in ((False, sub), (True, min(batch, 1024))):
        res = decode_minsum_qc(qc, y, T, early_termination=et,
                               storage_dtype=sdt)
        ref = decode_minsum_qc(qc, y[:rows].cpu(), T, early_termination=et,
                               storage_dtype=sdt)
        for f in ("hard", "iterations", "satisfied"):
            check(torch.equal(getattr(res, f)[:rows].cpu(), getattr(ref, f)),
                  f"decode (early_termination={et}) {f}: kernel path != "
                  "plain path")
        print(f"  decode of B2's samples (ET={et}): kernel path on the card"
              f" == plain path on the CPU for {rows} frames")
    gen = torch.Generator(device=device).manual_seed(SEED)
    times = (
        timer(lambda: awgn_philox(SEED, 0, batch, qc.n, sigma, device)),
        timer(lambda: awgn_philox_plain(SEED, 0, batch, qc.n, sigma, device),
              3),
        timer(lambda: torch.randn(batch, qc.n, generator=gen,
                                  device=device)),
    )
    print(f"  B2 kernel {times[0]:.4f} ms, plain {times[1]:.4f} ms, "
          f"torch.randn (same work, not the same function) {times[2]:.4f} "
          f"ms per call [{batch} x {qc.n}]")
    return err, times


def breakdown(qc, device, batch, sigma, timer):
    """Device time of each layer of one main-path batch (CUDA events)."""
    from ldpcsimulation_tpu_torch.decoders import decode_minsum_qc
    from ldpcsimulation_tpu_torch.decoders.minsum_qc import (
        qc_check_satisfied,
        qc_minsum_step,
        qc_plan,
        qc_ragged_init,
    )
    from ldpcsimulation_tpu_torch.kernels.channel import awgn_philox
    from ldpcsimulation_tpu_torch.kernels.minsum import (
        minsum_cn_scan,
        minsum_vn_update,
    )

    f16 = torch.float16
    plan = qc_plan(qc, device)
    y = awgn_philox(SEED, 0, batch, qc.n, sigma, device)
    yt = y.t().contiguous()
    v2c = qc_ragged_init(qc, yt, f16)
    step = qc_minsum_step(qc, storage_dtype=f16)
    d = torch.where(yt > 0, 1, -1).to(torch.int32)
    c2v = minsum_cn_scan(v2c, plan.cn_rows, out_dtype=f16)
    parts = {
        "channel (B2)": timer(
            lambda: awgn_philox(SEED, 0, batch, qc.n, sigma, device)),
        "CN update (B1)": timer(
            lambda: minsum_cn_scan(v2c, plan.cn_rows, out_dtype=f16)),
        # in place: each call folds the last one's output (the same work)
        "VN update (B5)": timer(
            lambda: minsum_vn_update(c2v, yt, plan.vn_rows)),
        "iteration (B1 + B5)": timer(lambda: step(v2c, yt)),
        "syndrome check": timer(lambda: qc_check_satisfied(qc, d)),
        "decode T=10": timer(
            lambda: decode_minsum_qc(qc, y, T, storage_dtype=torch.float16),
            3),
        "error count": timer(lambda: (d.t() != 1).sum(dim=1)),
    }
    for k, v in parts.items():
        print(f"  {k:22s} {v:9.4f} ms")
    return parts


def phase_b3(n, device, batch, timer):
    """Kernel B3 against its twin in both layouts."""
    from ldpcsimulation_tpu_torch.kernels.channel import (
        noise_stream,
        uniform_philox,
        uniform_philox_plain,
    )

    stream = noise_stream(17, 1)
    max_err = 0.0
    for layout in ("nb", "bn"):
        u, k = uniform_philox(SEED, 3 * batch, batch, n, stream, device,
                              layout, with_bits=True)
        u_p, k_p = uniform_philox_plain(SEED, 3 * batch, batch, n, stream,
                                        layout, device, with_bits=True)
        check(torch.equal(k, k_p), f"B3 {layout} integers: kernel != plain")
        max_err = max(max_err, float((u - u_p).abs().max()))
        check(torch.equal(u, u_p), f"B3 {layout} uniforms: kernel != plain")
        check(bool((u > 0).all()) and bool((u <= 1).all()),
              f"B3 {layout} range")
        check(torch.equal(u, (k.float() + 0.5) * 2.0**-24),
              f"B3 {layout} grid")
        check(abs(float(u.mean()) - 0.5) < 1e-3, f"B3 {layout} mean")
        print(f"  B3 {layout}: kernel == plain, {u.numel()} uniforms in "
              "(0, 1] on the grid")
    gen = torch.Generator(device=device).manual_seed(SEED)
    times = (
        timer(lambda: uniform_philox(SEED, 0, batch, n, stream, device)),
        timer(lambda: uniform_philox_plain(SEED, 0, batch, n, stream, "nb",
                                           device), 3),
        timer(lambda: torch.rand(n, batch, generator=gen, device=device)),
        timer(lambda: uniform_philox(SEED, 0, batch, n, stream, device,
                                     "bn")),
    )
    print(f"  B3 kernel {times[0]:.4f} ms ([batch, n]: {times[3]:.4f} ms), "
          f"plain {times[1]:.4f} ms, torch.rand (same work, not the same "
          f"function) {times[2]:.4f} ms per call [{n} x {batch}]")
    return max_err, times


def phase_b4(n, device, batch, sigma, timer):
    """Kernel B4 against its twin, channel form and decoder form."""
    from ldpcsimulation_tpu_torch.kernels.channel import (
        gauss_philox,
        gauss_philox_plain,
        noise_stream,
    )

    stream = noise_stream(5, 0)
    max_err = 0.0
    for form, offset, scale, layout in (("channel", 1.0, sigma, "bn"),
                                        ("decoder", 0.0, 0.6817, "nb")):
        y, k = gauss_philox(SEED, 7 * batch, batch, n, stream, offset,
                            scale, device, layout, with_bits=True)
        y_p, k_p = gauss_philox_plain(SEED, 7 * batch, batch, n, stream,
                                      offset, scale, layout, device,
                                      with_bits=True)
        check(torch.equal(k, k_p), f"B4 {form} integers: kernel != plain")
        fin = torch.isfinite(y_p)
        err = float((y[fin] - y_p[fin]).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(y, y_p), f"B4 {form} samples: kernel != plain "
              f"(max |dy| {err})")
        check(torch.equal(gauss_philox(SEED, 7 * batch, batch, n, stream,
                                       offset, scale, device, layout), y_p),
              f"B4 {form} without integers: kernel != plain")
        print(f"  B4 {form} form: samples and integers equal to the twin's,"
              f" {int((~fin).sum())} infinite (u = 1.0)")
        if form == "channel":
            yf = y[fin]
            check(abs(float(yf.mean()) - 1.0) < 2e-3
                  and abs(float(yf.std()) - sigma) < 2e-3, "B4 moments")
    gen = torch.Generator(device=device).manual_seed(SEED)
    times = (
        timer(lambda: gauss_philox(SEED, 0, batch, n, stream, 0.0, 0.6817,
                                   device)),
        timer(lambda: gauss_philox_plain(SEED, 0, batch, n, stream, 0.0,
                                         0.6817, "nb", device), 3),
        timer(lambda: torch.randn(n, batch, generator=gen, device=device)),
        timer(lambda: gauss_philox(SEED, 0, batch, n, stream, 1.0, sigma,
                                   device, "bn")),
    )
    print(f"  B4 kernel {times[0]:.4f} ms ([batch, n]: {times[3]:.4f} ms), "
          f"plain {times[1]:.4f} ms, torch.randn (same work, not the same "
          f"function) {times[2]:.4f} ms per call [{n} x {batch}]")
    return max_err, times


def phase_gdbf_equal(qc, device, frames=256):
    """The GDBF decode on the card against the CPU plain path, bit for bit,
    on the card's keyed draws."""
    from ldpcsimulation_tpu_torch.channel import (
        awgn_all_zero,
        saturate,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.decoders import (
        NoiseKey,
        decode_gdbf,
        keyed_draws,
        preset,
    )
    from ldpcsimulation_tpu_torch.kernels import build

    fields = ("hard", "iterations", "satisfied", "phases", "smoothing_used")
    code_d, code_c = qc.to_code(device), qc.to_code("cpu")
    rate = (qc.n - qc.m) / qc.n
    seen = {}
    for name, snr, T, extra in (
        ("SMNGDBF", 3.25, 100, {}),
        ("RSMNGDBF", 3.0, 40, dict(max_phases=3)),
        ("StochasticNGDBF", 3.5, 100, {}),
    ):
        cfg = preset(name, T, **GDBF_KW, **extra)
        sigma = snr_to_sigma(snr, rate)
        frame0 = 11 * frames
        y = saturate(awgn_all_zero(SEED, frame0, frames, qc.n, sigma,
                                   device), GDBF_YMAX)
        key = NoiseKey(SEED, frame0)
        build.LAUNCHES.clear()
        res = decode_gdbf(code_d, y, sigma, cfg, key=key, qc=qc)
        launched = dict(build.LAUNCHES)
        # B6 every step; B7 and the bookkeeping kernel every step of the
        # parallel rule (its keyed decode runs in chunks)
        want = {"gauss_philox": res.steps} if cfg.add_noise else {
            "uniform_philox": res.steps}
        want["parity_check"] = res.steps
        if not cfg.quantize_probabilities:
            want["gdbf_parallel_step"] = res.steps
            want["gdbf_lanes"] = res.steps
        check(launched == want, f"{name}: launches {launched} != {want}")
        seen.update({f"{name} {k}": v for k, v in launched.items()})
        steps = cfg.max_phases * T
        pert, unif = keyed_draws(cfg, sigma, key, qc.n, frames, steps,
                                 device)
        inj = decode_gdbf(code_d, y, sigma, cfg, perturbations=pert,
                          stoch_uniforms=unif, qc=qc)
        cpu = decode_gdbf(
            code_c, y.cpu(), sigma, cfg, qc=qc,
            perturbations=None if pert is None else pert.cpu(),
            stoch_uniforms=None if unif is None else unif.cpu(),
        )
        for f in fields:
            got = getattr(res, f)
            check(torch.equal(got, getattr(inj, f)),
                  f"{name} {f}: keyed != injected on the card")
            check(torch.equal(got.cpu(), getattr(cpu, f)),
                  f"{name} {f}: card != CPU plain path")
        drawn = (pert if pert is not None else unif).numel() * 4
        unsat = float((~res.satisfied).float().mean())
        print(f"  {name} T={T} x{cfg.max_phases}: card == CPU for "
              f"{frames} frames ({res.steps} steps, {drawn / 1e6:.0f} MB "
              f"injected, unsatisfied {unsat:.3g}, max phases "
              f"{int(res.phases.max())}); launches {launched}")
    return seen


def check_totals(path: str, stats) -> tuple[int, int, int]:
    """The run's (bit errors, word errors, total iterations) against the
    parent commit's."""
    got = (stats.errors, stats.word_errors, stats.total_iterations)
    want = PARENT_TOTALS[path]
    print(f"  totals (bit errors, word errors, iterations) {got}, the "
          f"parent commit's {want}")
    check(got == want, f"{path} totals {got} != the parent's {want}")
    return got


def mc_moments(stats, n):
    """(value, standard error) of BER, FER and average iterations from a
    run's per-frame histograms."""
    f = stats.total_words
    w = np.arange(1, n + 1)
    h = stats.error_weight_hist
    mean_e = stats.errors / f
    ber_se = math.sqrt(((w**2 * h).sum() / f - mean_e**2) / (f - 1)) / n
    ith = stats.iteration_hist
    it = np.arange(len(ith))
    mean_i = (it * ith).sum() / f
    it_se = math.sqrt(((it**2 * ith).sum() / f - mean_i**2) / (f - 1))
    fer_se = math.sqrt(stats.fer * (1 - stats.fer) / f)
    return dict(ber=(stats.ber, ber_se), fer=(stats.fer, fer_se),
                avg_iterations=(stats.avg_iterations, it_se))


def gdbf_breakdown(qc, device, batch, sigma, timer):
    """Device time of each part of one SMNGDBF step at full width (B4's
    draw, B6's syndrome and check, B7's VN side in and out of the smoothing
    window, the [B] bookkeeping in plain torch) and of one batch's decode,
    with its time per step."""
    from ldpcsimulation_tpu_torch.channel import awgn_all_zero, saturate
    from ldpcsimulation_tpu_torch.decoders import NoiseKey, decode_gdbf
    from ldpcsimulation_tpu_torch.decoders import gdbf as gd
    from ldpcsimulation_tpu_torch.decoders.qc_ops import qc_graph
    from ldpcsimulation_tpu_torch.kernels.channel import gauss_philox
    from ldpcsimulation_tpu_torch.kernels.check import parity_check
    from ldpcsimulation_tpu_torch.kernels.gdbf import gdbf_parallel_step

    cfg = gd.preset("SMNGDBF", GDBF_T, **GDBF_KW)
    code = qc.to_code(device)
    g = qc_graph(qc, device)
    y = saturate(awgn_all_zero(SEED, 0, batch, qc.n, sigma, device),
                 GDBF_YMAX)
    yt = y.t().contiguous()
    ns = float(np.float32(sigma * cfg.noise_scale))
    d = torch.where(torch.signbit(yt), -1, 1).to(torch.int8)
    _, syn = parity_check(g.check_cols, d, syndrome=True)
    pert = gauss_philox(SEED, 0, batch, qc.n, 1, 0.0, ns, device)
    thetas = torch.full_like(yt, float(np.float32(cfg.theta)))
    dsum = torch.zeros(d.shape, dtype=torch.int32, device=device)
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    act = ~done
    iters = torch.zeros(batch, dtype=torch.int32, device=device)
    lam = float(np.float32(cfg.lam))
    alpha = float(np.float32(cfg.alpha))

    def b7(window):
        return lambda: gdbf_parallel_step(d, yt, syn, g.vn_checks, thetas,
                                          dsum, act, alpha, pert, lam,
                                          window)

    def bookkeeping():  # the decode's [B] updates of one step
        sat = syn[0] > 0
        newly = act & sat
        it = torch.where(newly, 5, iters)
        ph = torch.where(newly, 1, iters)
        used = iters + newly.to(torch.int32)
        return it, ph, used, ~(done | sat), done | newly

    res = decode_gdbf(code, y, sigma, cfg, key=NoiseKey(SEED, 0), qc=qc)
    parts = {
        "noise draw (B4)": timer(
            lambda: gauss_philox(SEED, 0, batch, qc.n, 1, 0.0, ns, device)),
        "syndrome + check (B6)": timer(
            lambda: parity_check(g.check_cols, d, syndrome=True)),
        "VN step in the window (B7)": timer(b7(True)),
        "VN step out of the window (B7)": timer(b7(False)),
        "[B] bookkeeping (plain torch)": timer(bookkeeping),
        f"decode T={GDBF_T} (one batch)": timer(
            lambda: decode_gdbf(code, y, sigma, cfg, key=NoiseKey(SEED, 0),
                                qc=qc), 2),
    }
    parts[f"decode, per step of {res.steps}"] = (
        parts[f"decode T={GDBF_T} (one batch)"] / res.steps)
    for k, v in parts.items():
        print(f"  {k:30s} {v:9.4f} ms")
    return parts


def phase_gdbf_main(qc, device, batch, timer):
    """The SMNGDBF path at full width through ``simulate``."""
    from ldpcsimulation_tpu_torch.channel import saturate, snr_to_sigma
    from ldpcsimulation_tpu_torch.decoders import decode_gdbf, preset
    from ldpcsimulation_tpu_torch.harness import StopRule, simulate
    from ldpcsimulation_tpu_torch.kernels import build

    code = qc.to_code(device)
    rate = (qc.n - qc.m) / qc.n
    sigma = snr_to_sigma(GDBF_SNR_DB, rate)
    cfg = preset("SMNGDBF", GDBF_T, **GDBF_KW)
    steps = []

    def dec(yq, key):
        res = decode_gdbf(code, yq, sigma, cfg, key=key, qc=qc)
        steps.append(res.steps)
        return res

    def run(frames):
        return simulate(code, dec, GDBF_SNR_DB, stop=StopRule.fixed_frames(
            frames), batch_size=batch, seed=SEED, device=device,
            preprocess=lambda y: saturate(y, GDBF_YMAX))

    run(batch)  # warm-up batch
    torch.cuda.synchronize()
    steps.clear()
    build.LAUNCHES.clear()
    build.PATHS.clear()
    stats = run(4 * batch)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    paths = dict(build.PATHS)
    rate_bits = stats.total_words * (qc.n - qc.m) / stats.wall_seconds
    print(f"  BER {stats.ber!r} FER {stats.fer!r} avg iterations "
          f"{stats.avg_iterations!r} over {stats.total_words} frames in "
          f"{stats.wall_seconds:.4f} s: {rate_bits:.6g} decoded info bits/s;"
          f" steps per batch {steps}; launches {launches}; smoothing used "
          f"{stats.extra.get('smoothing_used')}")
    check(launches.get("parity_check", 0) > 0, "B6 not launched")
    check(launches.get("gdbf_parallel_step", 0) > 0, "B7 not launched")
    check(launches == {"awgn_philox": 4, "gauss_philox": sum(steps),
                       "parity_check": sum(steps),
                       "gdbf_parallel_step": sum(steps),
                       "gdbf_lanes": sum(steps)},
          f"SMNGDBF path launches {launches}, steps {steps}")
    # every step issued by the chunk path (share 1.0)
    check(paths == {("awgn_philox", "fast"): 4,
                    ("gauss_philox", "fast"): sum(steps),
                    ("gdbf_step", "chunk"): sum(steps)},
          f"SMNGDBF path instances {paths}")
    check_totals("smngdbf", stats)
    got = mc_moments(stats, qc.n)
    for k, (want, want_se) in JAX_SMNGDBF.items():
        val, se = got[k]
        bound = 4 * math.hypot(se, want_se)
        print(f"  {k}: port {val:.6g} (se {se:.3g}), JAX {want:.6g} (se "
              f"{want_se:.3g}), |diff| {abs(val - want):.3g} <= {bound:.3g}")
        check(abs(val - want) <= bound, f"SMNGDBF {k} outside 4 joint s.e.")
    parts = gdbf_breakdown(qc, device, batch, sigma, timer)
    return stats, rate_bits, launches, parts


def phase_gdbf_sweep(device, batch):
    """The sweep CLI's gdbf route, one point each of the uniform-noise and
    stochastic variants."""
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.tools.sweep import main as sweep_main

    common = ["gdbf", "--code", CODE, "-T", "100", "--batch", str(batch),
              "--max-frames", str(2 * batch), "--min-errors", "0",
              "--min-word-errors", "0", "--device", str(device)]
    runs = (
        (["--preset", "SMNGDBF", "--uniform-noise", "--snr", "3.25",
          "--theta", "-0.9", "--noise-scale", "0.975", "--lam", "0.988",
          "--alpha", "0.75", "--window", "64", "--ymax", "2.5"],
         ["3.25", None, None, None, str(2 * batch * 1008),
          str(2 * batch), "100", "-0.9", "0.975", "0.988", "0.75", None,
          None, "64", "2.5", CODE]),
        (["--preset", "StochasticNGDBF", "--snr", "3.5", "--nq", "3",
          "--ymax", "2.5"],
         ["3.5", None, None, None, str(2 * batch * 1008), str(2 * batch),
          "100", "-0.9", "1", "3", "2.25", "2.5", CODE]),
    )
    build.LAUNCHES.clear()
    rows = []
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        for i, (args, want) in enumerate(runs):
            log_path = f"{tmp}/gdbf{i}.log"
            rc = sweep_main(common + args + ["--log", log_path])
            with open(log_path) as f:
                row = f.read().splitlines()
            check(rc == 0 and len(row) == 1, "gdbf sweep wrote one row")
            cols = row[0].split("\t")
            check(len(cols) == len(want) and all(
                w is None or c == w for c, w in zip(cols, want)),
                f"gdbf sweep row {cols}")
            check(0.0 <= float(cols[1]) <= 0.5, f"BER {cols[1]}")
            rows.append(row[0])
            print(f"  row: {row[0]}")
    launches = dict(build.LAUNCHES)
    print(f"  launches {launches}")
    check(launches.get("uniform_philox", 0) > 0, "B3 not launched")
    check(launches.get("awgn_philox", 0) == 4, f"B2 launches {launches}")
    return rows, launches


def phase_edges(device):
    """B2, B3 and B4 against their twins on shapes that reach both
    instances of each, from a first frame just below 2^32."""
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.kernels.channel import (
        awgn_philox,
        awgn_philox_plain,
        gauss_philox,
        gauss_philox_plain,
        uniform_philox,
        uniform_philox_plain,
    )

    f0 = 2**32 - 100
    sigma = 0.79

    def same(got, want, what):
        if isinstance(got, tuple):
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"{what}: kernel != plain")
        else:
            check(torch.equal(got, want), f"{what}: kernel != plain")

    build.PATHS.clear()
    b2 = [(n, b) for n in (1008, 1007, 1006, 3, 1)
          for b in (BATCH, 257, 1)] + [(3, 70001)]
    for n, b in b2:
        for bits in (False, True):
            same(awgn_philox(SEED, f0, b, n, sigma, device, bits),
                 awgn_philox_plain(SEED, f0, b, n, sigma, device, bits),
                 f"B2 [{b} x {n}] bits={bits}")
    stream = 2 * 41 + 1
    for n in (1008, 1007, 5):
        for b in (BATCH, 33, 1):
            for layout in ("nb", "bn"):
                for bits in (False, True):
                    what = f"[{b} x {n}] {layout} bits={bits}"
                    same(uniform_philox(SEED, f0, b, n, stream, device,
                                        layout, bits),
                         uniform_philox_plain(SEED, f0, b, n, stream, layout,
                                              device, bits), "B3 " + what)
                    same(gauss_philox(SEED, f0, b, n, stream, 0.0, 0.6817,
                                      device, layout, bits),
                         gauss_philox_plain(SEED, f0, b, n, stream, 0.0,
                                            0.6817, layout, device, bits),
                         "B4 " + what)
    paths = dict(build.PATHS)
    for name in ("awgn_philox", "uniform_philox", "gauss_philox"):
        fast, tail = paths.get((name, "fast"), 0), paths.get((name, "tail"),
                                                              0)
        print(f"  {name}: {fast} launches to the wide-store instance, {tail} "
              "to the tail, all equal to the twin")
        check(fast > 0 and tail > 0, f"{name} instances {paths}")
    print(f"  B2 shapes (batch, n) {[(b, n) for n, b in b2]}, with and "
          f"without integers; B3/B4 n in (1008, 1007, 5) x batch in "
          f"({BATCH}, 33, 1), both layouts; first frame 2^32 - 100")
    return paths


def phase_bounds(path, card, launches_per_batch, times, qc, batch):
    """Memory, operation and issue bounds of each kernel at the main
    path's shapes, beside its measured times.  The share is the roofline
    share (the larger of the memory and operation bounds over the time);
    the issue bound and its share are a diagnostic of the instruction
    stream, not a bound of the work."""
    from ldpcsimulation_tpu_torch.decoders.minsum_qc import qc_plan
    from ldpcsimulation_tpu_torch.kernels.minsum import lane_width
    from ldpcsimulation_tpu_torch.tools import sass_count

    cur, top = sm_clocks()
    kernels = sass_count.parse(sass_count.disassemble(path))
    n = qc.n
    nquads = (n + 3) // 4
    plan = qc_plan(qc, "cpu")
    m, dc = plan.cn_rows.shape
    rows = plan.num_planes * qc.z
    degrees = torch.unique((plan.cn_rows >= 0).sum(dim=1),
                           return_counts=True)
    # the main path's f16 planes come from the caching allocator (aligned)
    f16 = torch.float16
    lanes = lane_width(batch, f16, 0, 0, f16)
    samples = batch * n

    def b1_path(k):
        """A check of degree d: its scan's loads and d stores (the
        kernel's slot loops): the mean path over the code's checks."""
        paths = [b1_sass_path(k, int(d)) for d in degrees[0]]
        if None in paths:
            return None
        return sum(int(c) * p for p, c in zip(paths, degrees[1])) / m

    def all_stores(k):
        return k.path_length()

    # (mangled-name key, path, threads, bytes, f32 operations): operations
    # count the formula's f32 arithmetic with each transcendental (log,
    # cos, sqrt, erfinv) as one
    spec = {
        "minsum_cn_scan": (  # the f16 store, as the main path runs it
            b1_instance(f16, lanes, f16), b1_path,
            m * -(-batch // lanes),
            rows * batch * (2 + 2) + plan.cn_rows.numel() * 4,
            rows * batch * 6),
        "awgn_philox": ("awgn_philox_kernelILb1ELb0EE", all_stores,
                        batch * nquads, samples * 4, samples * 12),
        "uniform_philox": ("philox_draw_kernelILb0ELi1ELb1ELb0EE",
                           all_stores, nquads * (batch // 2), samples * 4,
                           samples * 2),
        "gauss_philox": ("philox_draw_kernelILb1ELi1ELb1ELb0EE", all_stores,
                         nquads * (batch // 2), samples * 4, samples * 8),
    }
    print(f"  SM clock {cur:g} MHz now, {top:g} MHz maximum (the issue "
          f"bound's); {card}")
    out = {}
    for name, (key, path_of, threads, nbytes, ops) in spec.items():
        k = sass_count.find(kernels, key)
        steps = path_of(k)
        mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        bound = max(mem_ms, ops_ms)
        bound_by = "bytes" if mem_ms >= ops_ms else "operations"
        ms = times[name][0]
        if steps is None:
            issue, issue_text = None, "issue not measured (SASS layout)"
        else:
            issue = sass_count.issue_ms(threads, steps, top, SMS)
            issue_text = (f"issue {issue:.4f} ms ({steps:g} SASS on one "
                          f"thread's path of {k.static_count}, {threads} "
                          f"threads; share {issue / ms:.1%})")
        out[name] = dict(
            bound_ms=bound, bound_by=bound_by, issue_ms=issue,
            issue_share=None if issue is None else issue / ms,
            sass_path=steps, sass_static=k.static_count, threads=threads,
            bytes=nbytes, operations=ops, share=bound / ms,
            memory_share=mem_ms / ms,
            launches_per_batch=launches_per_batch[name],
        )
        print(f"  {name:15s} {ms:.4f} ms; memory {mem_ms:.4f} ms "
              f"({nbytes / 1e6:.1f} MB), operations {ops_ms:.4f} ms: "
              f"{bound_by} bound, roofline share {bound / ms:.1%}; "
              f"{issue_text}; plain {times[name][1]:.4f} ms, yardstick "
              f"{'none' if times[name][2] is None else f'{times[name][2]:.4f} ms'}"
              f"; launches per batch {launches_per_batch[name]}")
    b1_steps = out["minsum_cn_scan"]["sass_path"]
    print(f"  (B1's path: the {lanes}-lane instance's slot loops for a "
          f"check's degree, averaged over the degrees "
          f"{dict(zip(degrees[0].tolist(), degrees[1].tolist()))}: "
          + ("not measured" if b1_steps is None else
             f"{b1_steps / (rows / m * lanes):.1f} SASS per edge-lane") + ")")
    return out


def b1_instance(dtype, lanes: int, out_dtype=torch.float32) -> str:
    """The mangled-name key of B1's instance of ``lanes`` lanes (an f16
    store names its type by the substitution of v2c's ``__half``)."""
    t = "6__half" if dtype == torch.float16 else "f"
    o = "S1_" if out_dtype == torch.float16 else "f"
    return f"minsum_cn_lanes_kernelI{t}Li{lanes}E{o}E"


def b1_sass_path(kernel, degree: int):
    """SASS on one thread's path through a B1 instance for a check of
    ``degree`` named slots (``Kernel.path_through``): the two row-table
    loads, the scan's message loads by fours, a two and a one in each
    32-slot half of the sign mask, and a store per slot in each half —
    the layout nvcc gives the kernel's loops (2 + 14 loads, 2 stores).
    None for another layout: the count is a diagnostic, not a check."""
    from ldpcsimulation_tpu_torch.tools import sass_count

    loads = [i for i, x in enumerate(kernel.instrs)
             if x.base in sass_count.LOADS]
    stores = [i for i, x in enumerate(kernel.instrs)
              if x.base in sass_count.STORES]
    if len(loads) != 16 or len(stores) != 2:
        return None
    msg, way = loads[2:], []
    for h, n in ((0, min(degree, 32)), (1, max(degree - 32, 0))):
        four, two, one = msg[7 * h:7 * h + 4], msg[7 * h + 4:7 * h + 6], \
            msg[7 * h + 6]
        way += four * (n // 4) + (two if n % 4 >= 2 else []) + (
            [one] if n % 2 else [])
    way += [stores[0]] * min(degree, 32) + [stores[1]] * max(degree - 32, 0)
    return kernel.path_through(way)


def b1_issue(kernels, cn_rows, v2c, top, ms):
    """Issue bound of one B1 launch of ``ms`` on ``v2c`` from its SASS: the
    slot loops of the instance the launcher picks, for each check's degree
    (:func:`b1_sass_path`).  Returns the fields ``lanes``, ``issue_ms``,
    ``issue_share`` and ``sass_per_edge_lane`` (None where the library has
    no such instance or another layout), and a line of text."""
    from ldpcsimulation_tpu_torch.kernels.minsum import lane_width
    from ldpcsimulation_tpu_torch.tools import sass_count

    batch = v2c.shape[1]
    lanes = lane_width(batch, v2c.dtype, v2c.data_ptr(), 0)
    fields = dict(lanes=lanes, issue_ms=None, issue_share=None,
                  sass_per_edge_lane=None)
    # the f32 store's instance; before the store type became a template
    # parameter (an older package in tools/ab_smoke.py), its only one
    keys = (b1_instance(v2c.dtype, lanes),
            b1_instance(v2c.dtype, lanes).replace("EfE", "EE"))
    hits = [sass_count.find(kernels, key) for key in keys
            if sum(key in name for name in kernels) == 1]
    if not hits:
        return fields, f"{lanes} lanes; issue not measured (no instance)"
    k = hits[0]
    degs, counts = torch.unique((cn_rows >= 0).sum(dim=1).cpu(),
                                return_counts=True)
    paths = [b1_sass_path(k, int(d)) for d in degs]
    if None in paths:
        return fields, f"{lanes} lanes; issue not measured (SASS layout)"
    total = sum(int(c) * p for p, c in zip(paths, counts))
    issue = sass_count.issue_ms(cn_rows.shape[0] * -(-batch // lanes),
                                total / cn_rows.shape[0], top, SMS)
    fields.update(issue_ms=issue, issue_share=issue / ms,
                  sass_per_edge_lane=total / (int((cn_rows >= 0).sum())
                                              * lanes))
    return fields, (f"{lanes} lanes; issue {issue:.4f} ms "
                    f"({fields['sass_per_edge_lane']:.1f} SASS per "
                    f"edge-lane)")


def b1_forms(device):
    """(name, cn_rows, rows of v2c, batch, dtypes, variants) of B1's
    slot-array and generalized QC forms, an odd batch among them."""
    from ldpcsimulation_tpu_torch.codes import load_named_code, load_named_qc
    from ldpcsimulation_tpu_torch.decoders import minsum_plan, qc_plan

    g = torch.Generator().manual_seed(14)
    big = torch.randperm(210000, generator=g)[:200000].to(torch.int32)
    big = torch.cat([big, torch.full((10000,), -1, dtype=torch.int32)])
    all3 = ("plain", "normalized", "offset")
    peg = minsum_plan(load_named_code(PEG_CODE), device).cn_rows
    return (
        ("generic peg_1008_504", peg, 3024, BATCH,
         (torch.float16, torch.float32), ("plain",)),
        ("32-slot highrate_2048_384", minsum_plan(
            load_named_code("highrate_2048_384"), device).cn_rows, 12288,
         BATCH, (torch.float16,), all3),
        ("64-slot highrate_4376_282", minsum_plan(
            load_named_code("highrate_4376_282"), device).cn_rows, 17504,
         BATCH, (torch.float16,), all3),
        ("generalized dvbs2_1_2_qc", qc_plan(
            load_named_qc(DVBS2_CODE), device).cn_rows, 226800, DVBS2_BATCH,
         (torch.float16,), ("plain", "offset")),
        ("70000 checks", big[torch.randperm(210000, generator=g)].view(
            70000, 3).to(device), 210000, 1024, (torch.float32,),
         ("plain",)),
        # an odd batch: the 1-lane instance
        (f"odd batch peg_1008_504 B={ODD_BATCH}", peg, 3024, ODD_BATCH,
         (torch.float16, torch.float32), all3),
    )


def phase_b1_forms(device, lib_path, timer):
    """Kernel B1 against its twin in the slot-array and generalized QC
    forms, bit for bit, with each form's time and bounds; the narrow
    instances (an odd batch, a misaligned view) against the twin; and a
    batch of 2^30, whose rows lie 2^32 bytes and more apart in c2v."""
    from ldpcsimulation_tpu_torch.codes import load_named_code
    from ldpcsimulation_tpu_torch.decoders import minsum_plan
    from ldpcsimulation_tpu_torch.kernels.minsum import (
        lane_width,
        minsum_cn_scan,
        minsum_cn_scan_plain,
    )
    from ldpcsimulation_tpu_torch.tools import sass_count

    _, top = sm_clocks()
    kernels = sass_count.parse(sass_count.disassemble(lib_path))
    gen = torch.Generator(device=device).manual_seed(14)
    all3 = ("plain", "normalized", "offset")
    peg = minsum_plan(load_named_code(PEG_CODE), device).cn_rows
    kw = {"plain": {}, "normalized": {"alpha": 0.8}, "offset": {"delta": 0.15}}
    out, max_err = {}, 0.0
    for name, cn_rows, rows, batch, dtypes, variants in b1_forms(device):
        named = torch.unique(cn_rows[cn_rows >= 0]).long()
        check(named.numel() == int((cn_rows >= 0).sum()),
              f"{name}: a row named twice")
        for dtype in dtypes:
            v2c = tied_messages(gen, rows, batch, dtype, device)
            for variant in variants:
                got = minsum_cn_scan(v2c, cn_rows, variant, **kw[variant])
                want = minsum_cn_scan_plain(v2c, cn_rows, variant,
                                            **kw[variant])
                got, want = got[named], want[named]
                max_err = max(max_err, float((got - want).abs().max()))
                check(same_bits(got, want),
                      f"B1 {name} {variant} {dtype}: kernel != plain")
                if dtype == torch.float16:  # the storage-typed store
                    got16 = minsum_cn_scan(v2c, cn_rows, variant,
                                           out_dtype=dtype, **kw[variant])
                    check(same_bits(got16[named], minsum_cn_scan_plain(
                        v2c, cn_rows, variant, out_dtype=dtype,
                        **kw[variant])[named])
                          and same_bits(got16[named], want.half()),
                          f"B1 {name} {variant} f16 store: kernel != plain "
                          "or != the f32 output cast")
                    del got16
                del got, want
            ms = timer(lambda: minsum_cn_scan(v2c, cn_rows))
            plain_ms = timer(lambda: minsum_cn_scan_plain(v2c, cn_rows), 2)
            nbytes = (named.numel() * batch * (v2c.element_size() + 4)
                      + cn_rows.numel() * 4)
            mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
            diag, diag_text = b1_issue(kernels, cn_rows, v2c, top, ms)
            key = f"{name} {str(dtype).split('.')[-1]}"
            out[key] = dict(
                shape=[rows, batch], dc_max=int(cn_rows.shape[1]), ms=ms,
                plain_ms=plain_ms, bytes=nbytes, bound_ms=mem_ms,
                bound_by="bytes", share=mem_ms / ms, **diag,
            )
            stores = " f32 and f16 stores" if dtype == torch.float16 else ""
            print(f"  B1 {key}: equal ({', '.join(variants)}{stores}); "
                  f"{ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms [{rows} x {batch}]; memory bound "
                  f"{mem_ms:.4f} ms ({nbytes / 1e6:.1f} MB), roofline share "
                  f"{mem_ms / ms:.1%}; {diag_text}")
            if dtype == torch.float16:  # the flooding steps' instance
                ms = timer(lambda: minsum_cn_scan(v2c, cn_rows,
                                                  out_dtype=dtype))
                nbytes = (named.numel() * batch * 4 + cn_rows.numel() * 4)
                mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
                out[f"{key} f16 store"] = dict(
                    shape=[rows, batch], dc_max=int(cn_rows.shape[1]),
                    ms=ms, bytes=nbytes, bound_ms=mem_ms, bound_by="bytes",
                    share=mem_ms / ms)
                print(f"  B1 {key} f16 store: {ms:.4f} ms; memory bound "
                      f"{mem_ms:.4f} ms, roofline share {mem_ms / ms:.1%}")
            del v2c
        torch.cuda.empty_cache()
    # a view two elements into its buffer: the 2-lane instance
    for dtype in (torch.float16, torch.float32):
        buf = tied_messages(gen, 3024 * BATCH + 2, 1, dtype, device).view(-1)
        v2c = buf[2:].view(3024, BATCH)
        check(lane_width(BATCH, dtype, v2c.data_ptr(), 0) == 2,
              f"B1 lanes on a view 2 elements in ({dtype})")
        for variant in all3:
            got = minsum_cn_scan(v2c, peg, variant, **kw[variant])
            want = minsum_cn_scan_plain(v2c, peg, variant, **kw[variant])
            check(same_bits(got, want),
                  f"B1 misaligned {variant} {dtype}: kernel != plain")
        del buf, v2c, got, want
    print(f"  B1 on a view 2 elements into its buffer [3024 x {BATCH}] f16 "
          f"and f32 (the 2-lane instance): equal (three variants)")
    # one check of two rows at a batch of 2^30: each row's output is the
    # other row's message, and the tail equals the twin's
    torch.cuda.empty_cache()
    huge = 1 << 30
    pair = torch.tensor([[0, 1]], dtype=torch.int32, device=device)
    v2c = (torch.randn(2, huge, generator=gen, device=device) + 0.5).to(
        torch.float16)
    got = minsum_cn_scan(v2c, pair)
    check(torch.equal(got[0], v2c[1].float())
          and torch.equal(got[1], v2c[0].float()),
          "B1 at batch 2^30: a row's output is not the other row's message")
    tail = v2c[:, -4096:].contiguous()
    check(same_bits(got[:, -4096:], minsum_cn_scan_plain(tail, pair)),
          "B1 at batch 2^30: the tail != plain")
    del v2c, got, tail
    torch.cuda.empty_cache()
    print("  B1 on one check of two rows at batch 2^30 [2 x 2^30] f16: each "
          "row gets the other's message, the tail equal to the twin")
    wide = torch.zeros((65, 65), dtype=torch.int32, device=device)
    try:
        minsum_cn_scan(torch.zeros((65, 8), device=device), wide)
        check(False, "B1 took dc_max 65")
    except ValueError as e:
        check("dc_max <= 64" in str(e), f"B1 refusal: {e}")
    print("  B1 refuses dc_max 65 by name")
    return out, max_err


def phase_b1_times(device, timer):
    """Kernel B1's time at every caller's form, with its memory bound and
    roofline share, and ms per iteration of the min-sum paths it carries
    (T=10 f16 decodes at B=32768, no early termination).  It calls only
    ``minsum_cn_scan`` and the decoders, so ``tools/ab_smoke.py --here``
    runs it over another checkout's package: two commits' B1 in one call.
    ``main`` does not call it: [3], [14], [20], [36] and [42] time the
    same forms beside their checks."""
    from ldpcsimulation_tpu_torch.channel import awgn_all_zero, snr_to_sigma
    from ldpcsimulation_tpu_torch.codes import (
        build_code,
        detect_stratified,
        load_named_code,
        load_named_qc,
    )
    from ldpcsimulation_tpu_torch.decoders import (
        decode_minsum,
        decode_minsum_qc,
        decode_minsum_stratified,
        minsum_plan,
        qc_plan,
        stratified_plan,
    )
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.kernels.minsum import minsum_cn_scan
    from ldpcsimulation_tpu_torch.tools import sass_count

    try:  # SASS per edge-lane where the package has the lane instances
        from ldpcsimulation_tpu_torch.kernels.minsum import lane_width  # noqa
        kernels = sass_count.parse(sass_count.disassemble(build.build()[0]))
    except ImportError:
        kernels = None
    _, top = sm_clocks()
    print(f"  {card_line()}")
    f16, f32 = torch.float16, torch.float32
    qc = load_named_qc(CODE)
    plan = qc_plan(qc, device)
    forms = [(f"QC {CODE}", plan.cn_rows, plan.num_planes * qc.z, BATCH,
              (f16, f32))]
    forms += [form[:5] for form in b1_forms(device)]
    for name, batch in ((CODE, BATCH), (WIFI_CODE, BATCH),
                        (DVBS2_CODE, DVBS2_BATCH)):
        code = load_named_qc(name)
        layers = qc_plan(code, device).layers
        lp = layers[max(range(code.mb), key=lambda bi: layers[bi].dc)]
        forms.append((f"{name} layer", lp.scan_rows, lp.dc * code.z, batch,
                      (f32,)))
    alist = stratified_alist(**STRAT_GEOMETRY)
    sc = detect_stratified(alist)
    forms.append(("stratified", stratified_plan(sc, device).cn_rows,
                  sc.mb * sc.kg * sc.w, BATCH, (f16,)))
    forms.append((f"B=1 {PEG_CODE}", minsum_plan(
        load_named_code(PEG_CODE), device).cn_rows, 3024, 1, (f32,)))
    gen = torch.Generator(device=device).manual_seed(14)
    out = {"forms": {}, "paths": {}}
    for name, cn_rows, rows, batch, dtypes in forms:
        named = int((cn_rows >= 0).sum())
        for dtype in dtypes:
            v2c = tied_messages(gen, rows, batch, dtype, device)
            ms = time_small_ms(lambda: minsum_cn_scan(v2c, cn_rows), 20)
            nbytes = (named * batch * (v2c.element_size() + 4)
                      + cn_rows.numel() * 4)
            mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
            key = f"{name} {str(dtype).split('.')[-1]}"
            row = dict(shape=[rows, batch], ms=ms, bytes=nbytes,
                       bound_ms=mem_ms, share=mem_ms / ms)
            text = ""
            if kernels is not None:
                diag, text = b1_issue(kernels, cn_rows, v2c, top, ms)
                row.update(diag)
                text = f"; {text}"
            out["forms"][key] = row
            print(f"  B1 {key} [{rows} x {batch}]: {ms:.4f} ms; memory "
                  f"bound {mem_ms:.4f} ms, roofline share {mem_ms / ms:.1%}"
                  f"{text}", flush=True)
            del v2c
        torch.cuda.empty_cache()

    def samples(code, snr):
        rate = (code.n - code.m) / code.n
        return awgn_all_zero(0, 0, BATCH, code.n, snr_to_sigma(snr, rate),
                             device)

    hr = load_named_code(HW_CODE).to(device)
    strat = build_code(alist, device)
    y_qc, y_hr, y_st = (samples(qc, SNR_DB), samples(hr, 3.5),
                        samples(strat, STRAT_SNR_DB))
    runs = {
        f"{CODE} QC min-sum": lambda: decode_minsum_qc(
            qc, y_qc, T, storage_dtype=f16),
        f"{HW_CODE} slot-array min-sum": lambda: decode_minsum(
            hr, y_hr, T, storage_dtype=f16),
        "802.3an geometry stratified min-sum": lambda: (
            decode_minsum_stratified(sc, y_st, T, storage_dtype=f16)),
        "802.3an geometry slot-array min-sum": lambda: decode_minsum(
            strat, y_st, T, storage_dtype=f16),
    }
    for name, fn in runs.items():
        out["paths"][name] = timer(fn, 3) / T
        print(f"  {name}: {out['paths'][name]:.4f} ms per iteration",
              flush=True)
    return out


def phase_card_vs_cpu(device):
    """The slot-array and generalized QC decodes on the card against the
    CPU plain path, bit for bit, on the card's channel samples (256 frames;
    64 on dvbs2_1_2_qc, whose CPU side is the slow one)."""
    from ldpcsimulation_tpu_torch.channel import (
        awgn_all_zero,
        quantize_no_zero,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.codes import load_named_code, load_named_qc
    from ldpcsimulation_tpu_torch.decoders import (
        decode_minsum,
        decode_minsum_qc,
    )

    f16 = torch.float16
    cases = (
        (PEG_CODE, False, 2.0, False, dict(storage_dtype=f16)),
        (PEG_CODE, False, 2.0, False, dict(variant="normalized", alpha=1.25,
                                           early_termination=True)),
        (DVBS2_CODE, True, DVBS2_SNR_DB, True, dict(
            variant="offset", delta=0.15, storage_dtype=f16)),
        ("wifi_1944_972", True, 2.5, True, dict(
            variant="offset", delta=0.15, storage_dtype=f16,
            early_termination=True)),
        ("wifi_1944_972", True, 2.5, False, {}),
    )
    for name, is_qc, snr, quantized, kw in cases:
        frames = 64 if name == DVBS2_CODE else 256
        if is_qc:
            qc = load_named_qc(name)
            n, rate = qc.n, (qc.n - qc.m) / qc.n
            dec = lambda y, T: decode_minsum_qc(qc, y, T, **kw)  # noqa: E731
        else:
            code = load_named_code(name)
            n, rate = code.n, code.rate
            dec = lambda y, T: decode_minsum(code, y, T, **kw)  # noqa: E731
        y = awgn_all_zero(SEED, 17 * frames, frames, n,
                          snr_to_sigma(snr, rate), device)
        if quantized:
            y = quantize_no_zero(y, 2.0, 8.0)
        res, ref = dec(y, T), dec(y.cpu(), T)
        for f in ("hard", "iterations", "satisfied"):
            check(torch.equal(getattr(res, f).cpu(), getattr(ref, f)),
                  f"{name} {kw} {f}: card != CPU plain path")
        print(f"  {name} {'QC' if is_qc else 'slot-array'} {kw}: card == "
              f"CPU for {frames} frames, T={T}; satisfied "
              f"{float(res.satisfied.float().mean()):.3g}, mean iterations "
              f"{float(res.iterations.float().mean()):.3g}")


def generic_breakdown(code, device, batch, sigma, timer):
    """Device time of each layer of one slot-array batch (CUDA events)."""
    from ldpcsimulation_tpu_torch.decoders import (
        decode_minsum,
        minsum_plan,
        minsum_step,
    )
    from ldpcsimulation_tpu_torch.decoders.base import xor_satisfied
    from ldpcsimulation_tpu_torch.kernels.channel import awgn_philox
    from ldpcsimulation_tpu_torch.kernels.minsum import (
        minsum_cn_scan,
        minsum_vn_update,
    )

    f16 = torch.float16
    plan = minsum_plan(code, device)
    y = awgn_philox(SEED, 0, batch, code.n, sigma, device)
    yt = y.t().contiguous()
    v2c = yt.to(f16).repeat_interleave(code.dv_max, dim=0)
    step = minsum_step(code, storage_dtype=f16)
    d = torch.where(yt > 0, 1, -1).to(torch.int32)
    c2v = minsum_cn_scan(v2c, plan.cn_rows, out_dtype=f16)
    parts = {
        "channel (B2)": timer(
            lambda: awgn_philox(SEED, 0, batch, code.n, sigma, device)),
        "CN update (B1)": timer(
            lambda: minsum_cn_scan(v2c, plan.cn_rows, out_dtype=f16)),
        "VN update (B5)": timer(
            lambda: minsum_vn_update(c2v, yt, plan.vn_rows)),
        "iteration (B1 + B5)": timer(lambda: step(v2c, yt)),
        "syndrome check": timer(lambda: xor_satisfied(plan.check_cols, d)),
        "decode T=10": timer(
            lambda: decode_minsum(code, y, T, storage_dtype=torch.float16),
            3),
        "error count": timer(lambda: (d.t() != 1).sum(dim=1)),
    }
    for k, v in parts.items():
        print(f"  {k:22s} {v:9.4f} ms")
    return parts


def phase_generic_main(device, timer):
    """The slot-array path at full width through ``simulate``, gated
    against the JAX package's statistics."""
    from ldpcsimulation_tpu_torch.channel import snr_to_sigma
    from ldpcsimulation_tpu_torch.codes import load_named_code
    from ldpcsimulation_tpu_torch.decoders import decode_minsum
    from ldpcsimulation_tpu_torch.harness import StopRule, simulate
    from ldpcsimulation_tpu_torch.kernels import build

    code = load_named_code(PEG_CODE, device)

    def dec(y, key):
        return decode_minsum(code, y, T, storage_dtype=torch.float16)

    def run(frames):
        return simulate(code, dec, SNR_DB, stop=StopRule.fixed_frames(frames),
                        batch_size=BATCH, seed=SEED, device=device)

    run(BATCH)  # warm-up batch
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    build.PATHS.clear()
    stats = run(4 * BATCH)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    rate_bits = stats.total_words * code.k / stats.wall_seconds
    print(f"  BER {stats.ber!r} FER {stats.fer!r} over {stats.total_words} "
          f"frames in {stats.wall_seconds:.4f} s: {rate_bits:.6g} decoded "
          f"info bits/s; totals (bit errors, word errors, iterations) "
          f"{(stats.errors, stats.word_errors, stats.total_iterations)}; "
          f"launches {launches}")
    check(launches == {"minsum_cn_scan": 4 * T, "minsum_vn_update": 4 * T,
                       "awgn_philox": 4, "parity_check": 4},
          f"slot-array path launches {launches}")
    got = mc_moments(stats, code.n)
    for k, (want, want_se) in JAX_PEG_MINSUM.items():
        val, se = got[k]
        bound = 4 * math.hypot(se, want_se)
        print(f"  {k}: port {val:.6g} (se {se:.3g}), JAX {want:.6g} (se "
              f"{want_se:.3g}), |diff| {abs(val - want):.3g} <= {bound:.3g}")
        check(abs(val - want) <= bound, f"slot-array {k} outside 4 joint s.e.")
    sigma = snr_to_sigma(SNR_DB, code.rate)
    parts = generic_breakdown(code, device, BATCH, sigma, timer)
    return stats, rate_bits, launches, parts


def phase_dvbs2_point(device):
    """One dvbs2_1_2_qc point at B=32768 on real codewords: the encoder's
    words, relabeled to the QC column order, each checked against H; the
    peak device memory under ``DVBS2_PEAK_GIB``."""
    from ldpcsimulation_tpu_torch.codes import load_named_qc
    from ldpcsimulation_tpu_torch.codes.standards import (
        dvbs2_rate12_encode,
        dvbs2_rate12_qc,
    )
    from ldpcsimulation_tpu_torch.decoders import (
        decode_minsum_qc,
        qc_check_satisfied,
    )
    from ldpcsimulation_tpu_torch.channel import snr_to_sigma
    from ldpcsimulation_tpu_torch.harness import StopRule, simulate
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.kernels.channel import awgn_philox

    det = dvbs2_rate12_qc()
    qc = load_named_qc(DVBS2_CODE)
    info = np.random.default_rng(SEED).integers(0, 2, (64, 32400), np.uint8)
    cw = dvbs2_rate12_encode(info)[:, det.col_perm]
    d = torch.as_tensor(1 - 2 * cw.T.astype(np.int32), device=device)
    check(bool(qc_check_satisfied(qc, d).all()),
          "an encoded DVB-S2 word violates H")
    code = qc.to_code(device)

    def dec(y, key):
        return decode_minsum_qc(qc, y, T, storage_dtype=torch.float16)

    def run():
        return simulate(code, dec, DVBS2_SNR_DB,
                        stop=StopRule.fixed_frames(DVBS2_POINT_BATCH),
                        batch_size=DVBS2_POINT_BATCH, seed=SEED,
                        codewords=cw, device=device)

    first = run()  # warm-up: the tables and the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    build.LAUNCHES.clear()
    stats = run()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    rate_bits = stats.total_words * 32400 / stats.wall_seconds
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    y = awgn_philox(SEED, 0, DVBS2_POINT_BATCH, qc.n,
                    snr_to_sigma(DVBS2_SNR_DB, 0.5), device)
    decode_ms = time_ms(lambda: dec(y, None), 2)
    print(f"  {DVBS2_CODE} {DVBS2_SNR_DB} dB T={T} f16 on {cw.shape[0]} "
          f"encoded words: BER {stats.ber!r} FER {stats.fer!r} over "
          f"{stats.total_words} frames in {stats.wall_seconds:.4f} s "
          f"({first.wall_seconds:.4f} s in the first call), "
          f"{rate_bits:.6g} decoded info bits/s; the decode alone "
          f"{decode_ms:.2f} ms (device); launches {launches}; peak device "
          f"memory {peak:.2f} GiB at B={DVBS2_POINT_BATCH}")
    check((stats.errors, stats.word_errors) == (first.errors,
                                                first.word_errors),
          "DVB-S2 run not repeatable")
    check(0.0 <= stats.ber <= 0.5, f"DVB-S2 BER {stats.ber}")
    check(launches == {"minsum_cn_scan": T, "minsum_vn_update": T,
                       "awgn_philox": 1, "parity_check": 1},
          f"DVB-S2 launches {launches}")
    check(peak < DVBS2_PEAK_GIB, f"DVB-S2 peak {peak:.1f} GiB at "
          f"B={DVBS2_POINT_BATCH}")
    return stats, rate_bits, launches, decode_ms, peak


def phase_minsum_sweep(device, batch):
    """The sweep CLI's --alist, offsetminsum and normalizedminsum routes,
    one point each."""
    import contextlib
    import io

    from ldpcsimulation_tpu_torch.codes import (
        code_to_alist,
        load_named_code,
        save_alist,
    )
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.tools.sweep import main as sweep_main

    common = ["-T", "10", "--snr", "2.0", "--batch", str(batch),
              "--max-frames", str(batch), "--msg-dtype", "f16",
              "--device", str(device)]
    build.LAUNCHES.clear()
    rows = []
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        alist = f"{tmp}/qc_1008_504.alist"
        save_alist(code_to_alist(load_named_code(CODE)), alist)
        runs = (
            (["minsum", "--alist", alist], 6, alist),
            (["offsetminsum", "--code", "wifi_1944_972", "--ymax", "2.0",
              "--nq", "8", "--delta", "0.15"], 8, "wifi_1944_972"),
            (["normalizedminsum", "--code", PEG_CODE, "--alpha", "1.25"], 7,
             PEG_CODE),
        )
        for i, (args, width, name) in enumerate(runs):
            log_path = f"{tmp}/ms{i}.log"
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = sweep_main(args + common + ["--log", log_path])
            with open(log_path) as f:
                row = f.read().splitlines()
            check(rc == 0 and len(row) == 1, f"{args[0]} wrote one row")
            cols = row[0].split("\t")
            check(len(cols) == width and cols[0] == "2" and cols[4] == "10"
                  and cols[-1] == name and 0.0 <= float(cols[1]) <= 0.5,
                  f"{args[0]} row {cols}")
            if "--alist" in args:
                check("detected QC structure z=84" in err.getvalue(),
                      f"no QC detection note: {err.getvalue()!r}")
            rows.append(row[0])
            print(f"  {' '.join(args[:3])}: {row[0]}")
    launches = dict(build.LAUNCHES)
    print(f"  launches {launches}")
    check(launches == {"minsum_cn_scan": 3 * T, "minsum_vn_update": 3 * T,
                       "awgn_philox": 3, "parity_check": 3},
          f"min-sum sweep launches {launches}")
    return rows, launches


def equal_results(res, ref, what):
    for f in ("hard", "iterations", "satisfied"):
        check(torch.equal(getattr(res, f).cpu(), getattr(ref, f)),
              f"{what} {f}: card != CPU plain path")


def phase_layered_ddbmp_card_vs_cpu(device):
    """Layered min-sum and DD-BMP on the card against the CPU plain path,
    bit for bit, on the card's channel samples; layered min-sum launches
    B11 once per pair-free layer and executed iteration, and B1 once per
    pair layer (DVB-S2's tied blocks).  The two cases whose CPU side is
    slow run fewer frames (dvbs2_1_2_qc 32, reg4_4000_2000 at T=100 64), the
    others 256.  Returns the counted launches per layered decode."""
    from ldpcsimulation_tpu_torch.channel import (
        awgn_all_zero,
        quantize_no_zero,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.codes import load_named_code, load_named_qc
    from ldpcsimulation_tpu_torch.decoders import (
        decode_ddbmp,
        decode_ddbmp_qc,
        decode_minsum_layered_qc,
        qc_plan,
    )
    from ldpcsimulation_tpu_torch.kernels import build

    f16 = torch.float16
    layered = (
        (CODE, 256, 2.0, None, dict(storage_dtype=f16)),
        (CODE, 256, 2.0, None, dict(storage_dtype=f16,
                                    early_termination=True)),
        (WIFI_CODE, 256, 2.0, None, dict(variant="normalized", alpha=1.25)),
        (DVBS2_CODE, 32, DVBS2_SNR_DB, (2.0, 8.0), dict(
            variant="offset", delta=0.15, storage_dtype=f16)),
    )
    counted, checks_seen = {}, {}
    for name, frames, snr, quant, kw in layered:
        qc = load_named_qc(name)
        y = awgn_all_zero(SEED, 19 * frames, frames, qc.n,
                          snr_to_sigma(snr, (qc.n - qc.m) / qc.n), device)
        if quant:
            y = quantize_no_zero(y, *quant)
        build.LAUNCHES.clear()
        res = decode_minsum_layered_qc(qc, y, T, **kw)
        launched = dict(build.LAUNCHES)
        ref = decode_minsum_layered_qc(qc, y.cpu(), T, **kw)
        check(dict(build.LAUNCHES) == launched, "the CPU decode launched")
        equal_results(res, ref, f"layered min-sum {name} {kw}")
        rounds = int(res.iterations.max())
        et = " ET" if kw.get("early_termination") else ""
        # B6: once at the end, or (ET) once before and after every round;
        # B11 a pair-free layer, B1 a pair layer
        checks = 1 + (rounds if et else 0)
        pairs = sum(lp.pair_first is not None
                    for lp in qc_plan(qc, device).layers)
        want = {"minsum_layer_step": (qc.mb - pairs) * rounds,
                "parity_check": checks}
        if pairs:
            want["minsum_cn_scan"] = pairs * rounds
        check(launched == want,
              f"layered {name}: launches {launched}, {qc.mb} layers "
              f"({pairs} with a pair) x {rounds} iterations, {checks} checks")
        counted[f"{name}{et}, one decode of {frames} frames"] = launched
        checks_seen[f"{name}{et}, one decode of {frames} frames"] = checks
        print(f"  layered min-sum {name} {kw}: card == CPU for {frames} "
              f"frames, T={T}; satisfied "
              f"{float(res.satisfied.float().mean()):.3g}, mean iterations "
              f"{float(res.iterations.float().mean()):.3g}; B11 launches "
              f"{(qc.mb - pairs) * rounds}, B1 {pairs * rounds} = "
              f"{qc.mb - pairs} and {pairs} layers x {rounds}, B6 {checks}")
    for name, is_qc, frames, snr, ymax, t_max in (
            (CODE, True, 256, 3.5, 1.5, 50),
            (REG4_CODE, False, 64, 3.9, 1.6, 100)):
        if is_qc:
            qc = load_named_qc(name)
            n, rate = qc.n, (qc.n - qc.m) / qc.n
            dec = lambda y: decode_ddbmp_qc(qc, y, t_max)  # noqa: E731
        else:
            code = load_named_code(name)
            n, rate = code.n, code.rate
            dec = lambda y: decode_ddbmp(code, y, t_max)  # noqa: E731
        y = quantize_no_zero(
            awgn_all_zero(SEED, 23 * frames, frames, n,
                          snr_to_sigma(snr, rate), device), ymax, 8.0)
        res, ref = dec(y), dec(y.cpu())
        equal_results(res, ref, f"DD-BMP {name}")
        print(f"  DD-BMP {name} {'QC' if is_qc else 'slot-array'} T={t_max}: "
              f"card == CPU for {frames} frames; satisfied "
              f"{float(res.satisfied.float().mean()):.3g}, mean break index "
              f"{float(res.iterations.float().mean()):.4g}")
    return counted, checks_seen


def bp_routes_vs_bodies(device, frames=256):
    """The slot-array, stratified and layered BP routes on kernel B8 against
    their plain bodies from before B8 (``tests/frozen_bp.py``) on the card,
    bit for bit (int32 views: signed zeros too; the stratified step's f16
    messages as int16), each with the launches it should make: B8 once a
    check update, the layered step once a layer."""
    from ldpcsimulation_tpu_torch.codes import (
        detect_stratified,
        load_named_code,
        load_named_qc,
    )
    from ldpcsimulation_tpu_torch.decoders import (
        bp_cn_update,
        qc_bp_layered_step,
        qc_plan,
        stratified_bp_step,
    )
    from ldpcsimulation_tpu_torch.decoders.minsum_stratified import (
        stratified_zero_pad,
    )
    from ldpcsimulation_tpu_torch.kernels import build
    from tests import frozen_bp

    gen = torch.Generator(device=device).manual_seed(47)

    def msgs(rows, b, dtype=torch.float32, scale=1.0):
        v = torch.clamp(1.0 + 6.0 * torch.randn(rows, b, generator=gen,
                                                device=device), -20, 20)
        u = torch.rand(rows, b, generator=gen, device=device)
        v = torch.where(u < 0.02, 0.0, v)
        v = torch.where(u > 0.98, -0.0, v)
        return (scale * v).to(dtype)

    def held(label, launches, got, want):
        launched = dict(build.LAUNCHES)
        check(launched == launches, f"{label}: launches {launched}")
        for g, w in zip(got, want):
            check(same_bits(g, w), f"{label}: B8 route != plain body ("
                  f"{int((g != w).sum())} of {g.numel()} differ)")
        print(f"  {label}: equal bit for bit to the plain body over "
              f"{len(got)} tensors; launches {launched}")

    f16 = torch.float16
    # the slot array at the main path's batch too ([21]'s decode_bp)
    for name, dtype, b in ((PEG_CODE, f16, frames),
                           (PEG_CODE, torch.float32, frames),
                           (PEG_CODE, f16, BATCH),
                           (WIFI_CODE, f16, frames),
                           (WIFI_CODE, torch.float32, frames)):
        code = load_named_code(name, device)
        v2c = msgs(code.n * code.dv_max, b, dtype)
        build.LAUNCHES.clear()
        got = bp_cn_update(code, v2c)
        held(f"bp_cn_update {name} B={b} {str(dtype).split('.')[-1]}",
             {"bp_cn_pair": 1}, [got], [frozen_bp.bp_cn_update(code, v2c)])
        del got, v2c
    sc = detect_stratified(stratified_alist(**STRAT_GEOMETRY))
    for dtype in (f16, torch.float32):
        v2c = stratified_zero_pad(sc, msgs(sc.mb * sc.kg * sc.w, frames,
                                           dtype))
        v2c = v2c.view(sc.mb, sc.kg, sc.w, frames)
        yg = msgs(sc.kg * sc.w, frames, scale=8.0).view(sc.kg, sc.w, frames)
        build.LAUNCHES.clear()
        got = stratified_bp_step(sc, storage_dtype=dtype)(v2c, yg)
        held(f"stratified_bp_step {sc.kg} groups "
             f"{str(dtype).split('.')[-1]}", {"bp_cn_pair": 1}, list(got),
             list(frozen_bp.stratified_bp_step(sc, v2c, yg, dtype)))
    for name, b in ((WIFI_CODE, frames), (DVBS2_CODE, 64)):
        qc = load_named_qc(name)
        plan = qc_plan(qc, device)
        q = msgs(qc.n, b, scale=1.5)  # posteriors past the ±20 clip
        L = tuple(msgs(lp.dc * qc.z, b) for lp in plan.layers)
        build.LAUNCHES.clear()
        (q2, L2), _ = qc_bp_layered_step(qc)((q, L))
        want_q, want_L = frozen_bp.qc_bp_layered_step(qc, q, L)
        held(f"qc_bp_layered_step {name} B={b}", {"bp_cn_pair": qc.mb},
             [q2, *L2], [want_q, *want_L])


def phase_bp_card_vs_cpu(device, frames=256):
    """BP on the card against the CPU plain path: one check update of each
    form within BP_RTOL/BP_ATOL, T=20 decodes by frame agreement; then the
    routes on B8 against their plain bodies (:func:`bp_routes_vs_bodies`).
    Returns the agreement rates seen."""
    from ldpcsimulation_tpu_torch.channel import (
        awgn_all_zero,
        llr_from_channel,
        snr_to_n0,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.codes import load_named_code, load_named_qc
    from ldpcsimulation_tpu_torch.decoders import (
        bp_cn_update,
        decode_bp,
        decode_bp_layered_qc,
        decode_bp_qc,
        qc_bp_layered_step,
        qc_cn_bp,
        qc_plan,
    )

    def close(got, want, what):
        got = got.cpu()
        err = (got - want).abs()
        worst = float((err - BP_RTOL * want.abs()).max())
        check(bool(torch.isfinite(got).all()) and worst <= BP_ATOL,
              f"{what}: card outside {BP_ATOL} + {BP_RTOL}|cpu| by {worst}")
        return float(err.max())

    gen = torch.Generator().manual_seed(19)
    code = load_named_code(PEG_CODE)
    v2c = torch.clamp(1.0 + 6.0 * torch.randn(
        code.n * code.dv_max, frames, generator=gen), -20, 20)
    v2c[torch.rand(v2c.shape, generator=gen) < 0.02] = 0.0
    err = close(bp_cn_update(code.to(device), v2c.to(device)),
                bp_cn_update(code, v2c), "bp_cn_update")
    print(f"  bp_cn_update {PEG_CODE} [{v2c.shape[0]} x {frames}]: max |card "
          f"- cpu| {err:.3g}")
    for name in (CODE, DVBS2_CODE):
        qc = load_named_qc(name)
        b = frames if name == CODE else 16
        planes = torch.clamp(1.0 + 6.0 * torch.randn(
            qc_plan(qc, "cpu").num_planes * qc.z, b, generator=gen), -20, 20)
        err = close(qc_cn_bp(qc, planes.to(device).half()),
                    qc_cn_bp(qc, planes.half()), f"qc_cn_bp {name}")
        print(f"  qc_cn_bp {name} f16 planes [{planes.shape[0]} x {b}]: max "
              f"|card - cpu| {err:.3g}")
    qc = load_named_qc(WIFI_CODE)
    plan = qc_plan(qc, "cpu")
    q = 2.0 + 12.0 * torch.randn(qc.n, frames, generator=gen)
    L = tuple(3.0 * torch.randn(lp.dc * qc.z, frames, generator=gen)
              for lp in plan.layers)
    step = qc_bp_layered_step(qc)
    (q_d, L_d), _ = step((q.to(device), tuple(x.to(device) for x in L)))
    (q_c, L_c), _ = step((q, L))
    err = max([close(q_d, q_c, "layered BP posterior")] + [
        close(a, b, f"layered BP layer {i}")
        for i, (a, b) in enumerate(zip(L_d, L_c))])
    print(f"  qc_bp_layered_step {WIFI_CODE} (posteriors up to +-"
          f"{float(q.abs().max()):.0f}): max |card - cpu| {err:.3g} over the "
          f"posterior and {len(L)} layers' messages")

    seen = {}
    qc1 = load_named_qc(CODE)
    cases = (
        ("decode_bp", PEG_CODE, 1.6, code.n, code.rate,
         lambda llr: decode_bp(code, llr, 20)),
        ("decode_bp_qc", CODE, 2.0, qc1.n, 0.5,
         lambda llr: decode_bp_qc(qc1, llr, 20, early_termination=True,
                                  storage_dtype=torch.float16)),
        ("decode_bp_layered_qc", WIFI_CODE, 1.5, qc.n, 0.5,
         lambda llr: decode_bp_layered_qc(qc, llr, 20,
                                          early_termination=True)),
    )
    for fn, name, snr, n, rate, dec in cases:
        y = awgn_all_zero(SEED, 29 * frames, frames, n,
                          snr_to_sigma(snr, rate), device)
        llr = llr_from_channel(y, snr_to_n0(snr, rate))
        res, ref = dec(llr), dec(llr.cpu())
        same = float((res.hard.cpu() == ref.hard).all(dim=1).float().mean())
        its = float((res.iterations.cpu() == ref.iterations).float().mean())
        seen[fn] = dict(frames_equal=same, iterations_equal=its)
        print(f"  {fn} {name} {snr} dB T=20: {same:.4f} of {frames} frames "
              f"equal the CPU's in every decision, {its:.4f} in the iteration"
              f" count (gate {BP_FRAME_AGREEMENT}); satisfied "
              f"{float(res.satisfied.float().mean()):.3g}")
        check(min(same, its) >= BP_FRAME_AGREEMENT,
              f"{fn}: card and CPU agree on {same}, {its} of the frames")
    bp_routes_vs_bodies(device, frames)
    return seen


def phase_b1_layer(device, lib_path, timer):
    """Kernel B1 at a layer's shape against its twin, with its time per
    launch and its bounds."""
    from ldpcsimulation_tpu_torch.codes import load_named_qc
    from ldpcsimulation_tpu_torch.decoders import qc_plan
    from ldpcsimulation_tpu_torch.kernels.minsum import (
        minsum_cn_scan,
        minsum_cn_scan_plain,
    )
    from ldpcsimulation_tpu_torch.tools import sass_count

    _, top = sm_clocks()
    kernels = sass_count.parse(sass_count.disassemble(lib_path))
    gen = torch.Generator(device=device).manual_seed(20)
    kw = {"plain": {}, "normalized": {"alpha": 1.25},
          "offset": {"delta": 0.15}}
    out, max_err = {}, 0.0
    for name, batch in ((CODE, BATCH), (WIFI_CODE, BATCH),
                        (DVBS2_CODE, DVBS2_BATCH)):
        qc = load_named_qc(name)
        layers = qc_plan(qc, device).layers
        # the widest layer, and one with an absent edge where the code has one
        picks = {max(range(qc.mb), key=lambda bi: layers[bi].dc)}
        picks |= {bi for bi in range(qc.mb) if layers[bi].absent is not None}
        for bi in sorted(picks):
            lp = layers[bi]
            rows = lp.dc * qc.z
            qext = tied_messages(gen, rows, batch, torch.float32, device)
            named = lp.scan_rows[lp.scan_rows >= 0].long()
            for variant in kw:
                got = minsum_cn_scan(qext, lp.scan_rows, variant,
                                     **kw[variant])[named]
                want = minsum_cn_scan_plain(qext, lp.scan_rows, variant,
                                            **kw[variant])[named]
                max_err = max(max_err, float((got - want).abs().max()))
                check(same_bits(got, want),
                      f"B1 layer {name}[{bi}] {variant}: kernel != plain")
            # a launch of ~0.06 ms: the long sleep keeps the host's
            # enqueue rate out of the device time
            ms = time_small_ms(lambda: minsum_cn_scan(qext, lp.scan_rows), 50)
            plain_ms = timer(
                lambda: minsum_cn_scan_plain(qext, lp.scan_rows), 3)
            nbytes = named.numel() * batch * 8 + lp.scan_rows.numel() * 4
            mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
            diag, diag_text = b1_issue(kernels, lp.scan_rows, qext, top, ms)
            out[f"{name} layer {bi}"] = dict(
                shape=[rows, batch], checks=qc.z, dc=lp.dc,
                absent=0 if lp.absent is None else int(lp.absent.numel()),
                ms=ms, plain_ms=plain_ms, bytes=nbytes, bound_ms=mem_ms,
                bound_by="bytes", share=mem_ms / ms, **diag,
            )
            print(f"  B1 {name} layer {bi} [{rows} x {batch}] f32, {qc.z} "
                  f"checks x {lp.dc} slots"
                  f"{'' if lp.absent is None else ', one absent edge'}: "
                  f"equal (3 variants, tied); {ms:.4f} ms per launch, plain "
                  f"{plain_ms:.4f} ms; memory bound {mem_ms:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB), roofline share "
                  f"{mem_ms / ms:.1%}; {diag_text}; a layered decode "
                  f"launches it {qc.mb} times per executed iteration")
            del qext
    return out, max_err


def gated_simulate(label, point, code, k_info, dec, rounds_of, snr, batches,
                   device, preprocess=None, gate=True,
                   awgn_form="multiplicative"):
    """One full-width ``simulate`` run after a warm-up batch: launch counters
    reset just before and read just after, the statistics held within 4
    joint standard errors of the JAX package's (``JAX_POINTS[point]``).
    ``rounds_of(result)`` gives the update rounds a decode executed."""
    from ldpcsimulation_tpu_torch.harness import StopRule, simulate
    from ldpcsimulation_tpu_torch.kernels import build

    rounds = []

    def counted(x, key):
        res = dec(x, key)
        rounds.append(rounds_of(res))
        return res

    def run(frames):
        return simulate(code, counted, snr, stop=StopRule.fixed_frames(frames),
                        batch_size=BATCH, seed=SEED, device=device,
                        preprocess=preprocess, awgn_form=awgn_form)

    run(BATCH)  # warm-up batch
    torch.cuda.synchronize()
    rounds.clear()
    torch.cuda.reset_peak_memory_stats(device)
    build.LAUNCHES.clear()
    stats = run(batches * BATCH)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    rate_bits = stats.total_words * k_info / stats.wall_seconds
    ms_per_round = stats.wall_seconds * 1e3 / sum(rounds)
    print(f"  {label}: BER {stats.ber!r} FER {stats.fer!r} avg iterations "
          f"{stats.avg_iterations!r} over {stats.total_words} frames in "
          f"{stats.wall_seconds:.4f} s: {rate_bits:.6g} decoded info bits/s; "
          f"rounds per batch {rounds}, {ms_per_round:.3f} ms of wall per "
          f"round; peak device memory {peak:.2f} GiB; launches {launches}")
    check(launches.get("awgn_philox", 0) == batches, f"{label}: B2 {launches}")
    got = mc_moments(stats, code.n)
    for k, (want, want_se) in (JAX_POINTS[point].items() if gate else ()):
        val, se = got[k]
        bound = 4 * math.hypot(se, want_se)
        print(f"  {k}: port {val:.6g} (se {se:.3g}), JAX {want:.6g} (se "
              f"{want_se:.3g}), |diff| {abs(val - want):.3g} <= {bound:.3g}")
        check(abs(val - want) <= bound, f"{label} {k} outside 4 joint s.e.")
    return dict(
        ber=stats.ber, fer=stats.fer, avg_iterations=stats.avg_iterations,
        frames=stats.total_words, decoded_info_bits_per_s=rate_bits,
        ms_per_round=ms_per_round, rounds=rounds, peak_gib=peak,
        launches=launches,
    )


def phase_new_paths(device, timer):
    """The BP, layered min-sum and DD-BMP paths at full width through
    ``simulate``, each gated against the JAX package's statistics, with a
    breakdown of each."""
    from ldpcsimulation_tpu_torch.channel import (
        awgn_all_zero,
        llr_from_channel,
        quantize_no_zero,
        snr_to_n0,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.codes import load_named_code, load_named_qc
    from ldpcsimulation_tpu_torch.decoders import (
        bp_cn_update,
        bp_step,
        decode_bp,
        decode_bp_qc,
        decode_ddbmp,
        decode_minsum_layered_qc,
        decode_minsum_qc,
        layered_l0,
        qc_bp_step,
        qc_cn_bp,
        qc_minsum_layered_step,
        qc_minsum_step,
        qc_ragged_init,
    )

    out = {}
    f16 = torch.float16
    fixed = lambda t: (lambda res: t)  # noqa: E731
    until_done = lambda res: int(res.iterations.max())  # noqa: E731

    def parts_of(label, parts):
        for k, v in parts.items():
            print(f"    {k:34s} {v:9.4f} ms")
        out[label]["breakdown_ms"] = parts

    # (a) slot-array BP
    peg = load_named_code(PEG_CODE, device)
    n0 = snr_to_n0(1.6, peg.rate)
    out["bp_peg"] = gated_simulate(
        f"(a) decode_bp {PEG_CODE} 1.6 dB T=20 f32", "bp_peg", peg, peg.k,
        lambda llr, key: decode_bp(peg, llr, 20), fixed(20), 1.6, 4, device,
        preprocess=lambda y: llr_from_channel(y, n0))
    llr_t = llr_from_channel(awgn_all_zero(
        SEED, 0, BATCH, peg.n, snr_to_sigma(1.6, peg.rate), device),
        n0).t().contiguous()
    v2c = llr_t.repeat_interleave(peg.dv_max, dim=0)
    step = bp_step(peg)
    parts_of("bp_peg", {
        "check update (bp_cn_update)": timer(
            lambda: bp_cn_update(peg, v2c), 3),
        "iteration (check + variable)": timer(lambda: step(v2c, llr_t), 3),
    })
    del v2c, llr_t

    # (b) QC BP, early termination, f16 storage
    qc = load_named_qc(CODE)
    code = qc.to_code(device)
    n0 = snr_to_n0(2.0, 0.5)
    out["bp_qc"] = gated_simulate(
        f"(b) decode_bp_qc {CODE} 2.0 dB T=20 ET f16", "bp_qc", code,
        qc.n - qc.m,
        lambda llr, key: decode_bp_qc(qc, llr, 20, early_termination=True,
                                      storage_dtype=f16),
        until_done, 2.0, 4, device,
        preprocess=lambda y: llr_from_channel(y, n0))
    llr_t = llr_from_channel(awgn_all_zero(
        SEED, 0, BATCH, qc.n, snr_to_sigma(2.0, 0.5), device),
        n0).t().contiguous()
    planes = qc_ragged_init(qc, llr_t, f16)
    step = qc_bp_step(qc, storage_dtype=f16)
    parts_of("bp_qc", {
        "check update (qc_cn_bp)": timer(lambda: qc_cn_bp(qc, planes), 3),
        "iteration (check + variable)": timer(lambda: step(planes, llr_t), 3),
    })
    del planes, llr_t

    # (c) layered min-sum beside flooding min-sum, both with early
    # termination, on the 802.11n (1944, 972) code
    wifi = load_named_qc(WIFI_CODE)
    wcode = wifi.to_code(device)
    out["minsum_layered_wifi"] = gated_simulate(
        f"(c) decode_minsum_layered_qc {WIFI_CODE} 2.0 dB T={T} ET f32",
        "minsum_layered_wifi", wcode, wifi.n - wifi.m,
        lambda y, key: decode_minsum_layered_qc(wifi, y, T,
                                                early_termination=True),
        until_done, 2.0, 4, device)
    lay = out["minsum_layered_wifi"]
    # B6: before the first round and after every round of each batch
    check(lay["launches"] == {
        "minsum_layer_step": wifi.mb * sum(lay["rounds"]), "awgn_philox": 4,
        "parity_check": sum(lay["rounds"]) + len(lay["rounds"])},
        f"layered path launches {lay['launches']}, rounds {lay['rounds']}")
    out["minsum_flooding_wifi"] = gated_simulate(
        f"(c) decode_minsum_qc {WIFI_CODE} 2.0 dB T={T} ET f32 (flooding, "
        "beside it)", None, wcode, wifi.n - wifi.m,
        lambda y, key: decode_minsum_qc(wifi, y, T, early_termination=True),
        until_done, 2.0, 4, device, gate=False)
    flo = out["minsum_flooding_wifi"]
    print(f"  layered vs flooding at T={T}: BER {lay['ber']:.6g} vs "
          f"{flo['ber']:.6g}, FER {lay['fer']:.6g} vs {flo['fer']:.6g}, "
          f"average iterations {lay['avg_iterations']:.4g} vs "
          f"{flo['avg_iterations']:.4g}")
    check(lay["ber"] < flo["ber"] and lay["avg_iterations"]
          < flo["avg_iterations"], "layered not ahead of flooding")
    y_t = awgn_all_zero(SEED, 0, BATCH, wifi.n, snr_to_sigma(2.0, 0.5),
                        device).t().contiguous()
    lstep = qc_minsum_layered_step(wifi)
    state = (y_t, layered_l0(wifi, BATCH, torch.float32, device))
    fstep = qc_minsum_step(wifi)
    fplanes = qc_ragged_init(wifi, y_t, torch.float32)
    parts_of("minsum_layered_wifi", {
        f"layered iteration ({wifi.mb} layers)": timer(
            lambda: lstep(state), 5),
        "flooding iteration (B1 + B5)": timer(lambda: fstep(fplanes, y_t), 5),
    })
    del state, fplanes, y_t

    # (d) DD-BMP on the (4000, 2000) code
    reg4 = load_named_code(REG4_CODE, device)
    out["ddbmp_reg4"] = gated_simulate(
        f"(d) decode_ddbmp {REG4_CODE} 3.9 dB Ymax 1.6 nq 8 T=100",
        "ddbmp_reg4", reg4, reg4.k,
        lambda yq, key: decode_ddbmp(reg4, yq, 100),
        lambda res: min(int(res.iterations.max()) + 1, 100), 3.9, 2, device,
        preprocess=lambda y: quantize_no_zero(y, 1.6, 8.0))
    return out


def phase_new_sweep(device, batch):
    """The sweep CLI's bp, layered and ddbmp routes, one point each."""
    from ldpcsimulation_tpu_torch.codes import load_named_qc
    from ldpcsimulation_tpu_torch.harness import fmt
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.tools.sweep import main as sweep_main

    common = ["--batch", str(batch), "--max-frames", str(batch), "--device",
              str(device)]
    # per route, the launches besides B2 and B6 as a function of B6's
    # (the BP decoders check once before their first round and after each:
    # B8 once a round, and the QC decoder's B9 and B10 merge too; the
    # layered decoders once a layer: BP on B8, min-sum on B11)
    mb = load_named_qc(WIFI_CODE).mb
    runs = (
        (["bp", "--code", CODE, "--snr", "2.0", "-T", "20",
          "--early-termination", "--msg-dtype", "f16"], 6, "20", CODE,
         lambda checks: {"bp_cn_pair": checks - 1,
                         "bp_vn_update": checks - 1,
                         "et_merge": checks - 1}),
        (["bp", "--code", WIFI_CODE, "--schedule", "layered", "--snr", "2.0",
          "-T", "10", "--early-termination"], 6, "10", WIFI_CODE,
         lambda checks: {"bp_cn_pair": mb * (checks - 1)}),
        (["minsum", "--code", WIFI_CODE, "--schedule", "layered", "--snr",
          "2.0", "-T", "10", "--msg-dtype", "f16"], 6, "10", WIFI_CODE,
         lambda checks: {"minsum_layer_step": mb * 10}),
        (["ddbmp", "--code", REG4_CODE, "--snr", "3.9", "-T", "100",
          "--ymax", "1.6", "--nq", "8"], 7, "100", REG4_CODE,
         lambda checks: {}),
    )
    rows = []
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        for i, (args, width, t_col, name, b1) in enumerate(runs):
            log_path = f"{tmp}/new{i}.log"
            build.LAUNCHES.clear()
            rc = sweep_main(args + common + ["--log", log_path])
            launches = dict(build.LAUNCHES)
            with open(log_path) as f:
                row = f.read().splitlines()
            check(rc == 0 and len(row) == 1, f"{args[0]} wrote one row")
            cols = row[0].split("\t")
            snr = fmt(float(args[args.index("--snr") + 1]))
            check(len(cols) == width and cols[0] == snr and cols[4] == t_col and cols[-1] == name
                  and 0.0 <= float(cols[1]) < 0.1
                  and 0.0 <= float(cols[2]) <= float(t_col),
                  f"{args[0]} row {cols}")
            checks, rest = b6_and_rest(launches)
            check(checks >= 1 and rest == {"awgn_philox": 1, **b1(checks)},
                  f"{' '.join(args[:5])}: launches {launches}")
            rows.append(row[0])
            print(f"  {' '.join(args[:5])}: {row[0]}; launches {launches}")
    return rows


HW_FIELDS = ("hard", "iterations", "satisfied", "least_errors", "qpointer")


def phase_hw_card_vs_cpu(device, frames=256):
    """NGDBFhw on the card against the CPU plain path under ``torch.equal``,
    on the card's samples and its keyed ring (B4, one launch per decode)."""
    from ldpcsimulation_tpu_torch.channel import awgn_all_zero, snr_to_sigma
    from ldpcsimulation_tpu_torch.codes import load_named_code, load_named_qc
    from ldpcsimulation_tpu_torch.decoders import (
        NGDBFHwConfig,
        NoiseKey,
        decode_ngdbf_hw,
        keyed_ring,
    )
    from ldpcsimulation_tpu_torch.kernels import build

    qc = load_named_qc(CODE)
    hw = load_named_code(HW_CODE, device)
    gen = torch.Generator().manual_seed(SEED)
    counted = {}
    for name, code_d, code_c, q, snr, b in (
        (CODE, qc.to_code(device), qc.to_code("cpu"), qc, 3.0, frames),
        (HW_CODE, hw, hw.to("cpu"), None, 4.0, frames // 2),
    ):
        n = code_d.n
        sigma = snr_to_sigma(snr, code_d.rate)
        for phases in (1, 3):
            cfg = NGDBFHwConfig(num_iterations=60, max_phases=phases,
                                ring_len=max(2648, n + 600))
            for with_qp in (False, True):
                frame0 = 13 * b + 7 * phases + with_qp
                y = awgn_all_zero(SEED, frame0, b, n, sigma, device)
                key = NoiseKey(SEED, frame0)
                qp = (torch.randint(0, cfg.ring_len - n, (b,), generator=gen,
                                    dtype=torch.int32) if with_qp else None)
                build.LAUNCHES.clear()
                res = decode_ngdbf_hw(
                    code_d, y, sigma, cfg, key=key, qc=q,
                    qpointer0=None if qp is None else qp.to(device))
                launched = dict(build.LAUNCHES)
                what = f"{name} x{phases}{' qpointer0' if with_qp else ''}"
                check(launched == {"gauss_philox": 1},
                      f"NGDBFhw {what}: launches {launched}")
                ring = keyed_ring(cfg, sigma, key, b, device)
                cpu = decode_ngdbf_hw(code_c, y.cpu(), sigma, cfg,
                                      ring_noise=ring.cpu(), qc=q,
                                      qpointer0=qp)
                for f in HW_FIELDS:
                    check(torch.equal(getattr(res, f).cpu(), getattr(cpu, f)),
                          f"NGDBFhw {what} {f}: card != CPU plain path")
                counted[what] = launched.get("gauss_philox", 0)
                unsat = float((~res.satisfied).float().mean())
                print(f"  {what}: card == CPU for {b} frames ({res.steps} "
                      f"steps, unsatisfied {unsat:.3g}, least errors "
                      f"{int(res.least_errors.sum())}); B4 launched once")
    return counted


def phase_systemc_card_vs_cpu(device, frames=256):
    """The SystemC model on the card against the CPU plain path under
    ``torch.equal``, on the card's samples and keyed source stream."""
    from ldpcsimulation_tpu_torch.channel import awgn_all_zero, snr_to_sigma
    from ldpcsimulation_tpu_torch.codes import load_named_code
    from ldpcsimulation_tpu_torch.decoders import (
        NoiseKey,
        SystemCNGDBFConfig,
        decode_ngdbf_systemc,
        keyed_source,
    )
    from ldpcsimulation_tpu_torch.kernels import build

    peg_d = load_named_code(PEG_CODE, device)
    peg_c = peg_d.to("cpu")
    sigma = snr_to_sigma(SYSTEMC_SNR_DB, peg_d.rate)
    counted, checks_seen = {}, {}
    for smoothed in (True, False):
        cfg = SystemCNGDBFConfig(num_iterations=100, **dict(
            SYSTEMC_KW, smoothed=smoothed))
        frame0 = 17 * frames + smoothed
        # all-(+1) word: the additive sample is the multiplicative one
        y = awgn_all_zero(SEED, frame0, frames, peg_d.n, sigma, device)
        key = NoiseKey(SEED, frame0)
        build.LAUNCHES.clear()
        res = decode_ngdbf_systemc(peg_d, y, sigma, cfg, key=key)
        launched = dict(build.LAUNCHES)
        what = f"{PEG_CODE} {'smoothed' if smoothed else 'unsmoothed'}"
        checks, rest = b6_and_rest(launched)
        check(checks >= 1 and rest == {"gauss_philox": 1},
              f"SystemC {what}: launches {launched}")
        src = keyed_source(cfg, sigma, key, peg_d.n, frames, device)
        cpu = decode_ngdbf_systemc(peg_c, y.cpu(), sigma, cfg,
                                   noise_stream=src.cpu())
        for f in ("hard", "iterations", "satisfied"):
            check(torch.equal(getattr(res, f).cpu(), getattr(cpu, f)),
                  f"SystemC {what} {f}: card != CPU plain path")
        counted[what] = launched.get("gauss_philox", 0)
        checks_seen[what] = checks
        unsat = float((~res.satisfied).float().mean())
        print(f"  {what}: card == CPU for {frames} frames (T=100, "
              f"unsatisfied {unsat:.3g}); B4 launched once, B6 {checks} "
              f"times")
    return counted, checks_seen


def b4_at_shape(device, lib_path, timer, rows, stream, scale, label):
    """B4 against its twin at a decoder's draw shape [rows, BATCH] (layout
    "nb"), with its time, its twin's and its bounds."""
    from ldpcsimulation_tpu_torch.kernels.channel import (
        gauss_philox,
        gauss_philox_plain,
    )
    from ldpcsimulation_tpu_torch.tools import sass_count

    y, k = gauss_philox(SEED, 0, BATCH, rows, stream, 0.0, scale, device,
                        with_bits=True)
    y_p, k_p = gauss_philox_plain(SEED, 0, BATCH, rows, stream, 0.0, scale,
                                  "nb", device, with_bits=True)
    check(torch.equal(k, k_p) and torch.equal(y, y_p),
          f"B4 {label}: kernel != plain")
    fin = torch.isfinite(y_p)
    err = float((y[fin] - y_p[fin]).abs().max())
    infinite = int((~fin).sum())
    del y, k, y_p, k_p, fin
    ms = timer(lambda: gauss_philox(SEED, 0, BATCH, rows, stream, 0.0, scale,
                                    device))
    plain_ms = timer(lambda: gauss_philox_plain(SEED, 0, BATCH, rows, stream,
                                                0.0, scale, "nb", device), 2)
    _, top = sm_clocks()
    kern = sass_count.find(sass_count.parse(sass_count.disassemble(lib_path)),
                           "philox_draw_kernelILb1ELi1ELb1ELb0EE")
    threads = (rows + 3) // 4 * (BATCH // 2)
    path = kern.path_length()
    nbytes, ops = rows * BATCH * 4, rows * BATCH * 8
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    issue = sass_count.issue_ms(threads, path, top, SMS)
    print(f"  B4 at the {label} [{rows} x {BATCH}]: equal to its twin "
          f"({infinite} infinite draws); {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms; memory {mem_ms:.4f} ms ({nbytes / 1e6:.1f} MB, share "
          f"{mem_ms / ms:.1%}), operations {ops_ms:.4f} ms, issue "
          f"{issue:.4f} ms ({path:g} SASS, share {issue / ms:.1%})")
    return dict(shape=[rows, BATCH], ms=ms, plain_ms=plain_ms,
                bound_ms=max(mem_ms, ops_ms),
                bound_by="bytes" if mem_ms >= ops_ms else "operations",
                issue_ms=issue, memory_share=mem_ms / ms, infinite=infinite,
                max_abs_err=err)


def hw_breakdown(code, cfg, sigma, device, timer):
    """Device time of each layer of one NGDBFhw step at full width (the
    generic graph, per-lane ring pointers)."""
    from ldpcsimulation_tpu_torch.channel import awgn_all_zero
    from ldpcsimulation_tpu_torch.decoders import NoiseKey
    from ldpcsimulation_tpu_torch.decoders import ngdbf_hw as hw

    y_t = awgn_all_zero(SEED, 0, BATCH, code.n, sigma, device).t()
    d = (y_t <= 0).to(torch.uint8)
    yint = hw.hw_quantize_int(y_t, cfg.nl, cfg.lmax).to(torch.int16)
    neg_yint = -yint
    key = NoiseKey(SEED, 0)
    qint = hw._ring_integers(cfg, hw.keyed_ring(cfg, sigma, key, BATCH,
                                                device))
    ring_mod = cfg.ring_len - code.n
    window = qint.as_strided((ring_mod, code.n, BATCH), (BATCH, BATCH, 1))
    rows = torch.arange(code.n, device=device)[:, None]
    lanes = torch.arange(BATCH, device=device)[None, :]
    gen = torch.Generator(device=device).manual_seed(SEED)
    qptr = torch.randint(0, ring_mod, (BATCH,), generator=gen,
                         device=device, dtype=torch.int32)
    syndrome01, satsum = hw.hw_graph_ops(code)
    syn = syndrome01(d)
    ss = satsum(syn)
    act = torch.ones(BATCH, dtype=torch.bool, device=device)

    def metric_and_flip():
        e = (torch.where(d.bool(), neg_yint, yint) + ss * cfg.smult
             + qint[5:5 + code.n])
        return torch.where(act[None, :] & (e <= cfg.theta_int), 1 - d, d)

    parts = {
        "ring draw (B4) + integers": timer(lambda: hw._ring_integers(
            cfg, hw.keyed_ring(cfg, sigma, key, BATCH, device))),
        "syndrome (row gathers)": timer(lambda: syndrome01(d)),
        "syndrome test (all zero)": timer(lambda: (syn == 0).all(dim=0)),
        "satisfied-neighbour sum": timer(lambda: satsum(syn)),
        "metric + flip (ring slice)": timer(metric_and_flip),
        "ring gather (per-lane pointers)": timer(
            lambda: window[qptr.long()[None, :], rows, lanes]),
        "pointer advance": timer(lambda: torch.where(
            act, (qptr + 1) % ring_mod, qptr)),
    }
    for k, v in parts.items():
        print(f"    {k:34s} {v:9.4f} ms")
    return parts


def systemc_breakdown(code, cfg, sigma, device, timer):
    """Device time of each layer of one SystemC-model step at full
    width."""
    from ldpcsimulation_tpu_torch.channel import awgn_all_zero
    from ldpcsimulation_tpu_torch.channel.quantize import (
        quantize_threshold_table,
    )
    from ldpcsimulation_tpu_torch.decoders import NoiseKey, keyed_source
    from ldpcsimulation_tpu_torch.decoders.qc_ops import (
        slot_graph,
        syndrome_bipolar,
        syndrome_sum_per_vn,
    )

    def qz(v):
        return quantize_threshold_table(v, cfg.ymax, cfg.nq_levels)

    y_t = awgn_all_zero(SEED, 0, BATCH, code.n, sigma, device).t()
    r = qz(y_t)
    x = torch.where(r > 0, 1, -1).to(torch.int8)
    theta = torch.full_like(r, cfg.theta)
    lam = torch.tensor(cfg.lam, device=device)
    w = (torch.tensor(cfg.alpha * cfg.ymax, device=device)
         / code.vn_deg.float())[:, None]
    gq = qz(keyed_source(cfg, sigma, NoiseKey(SEED, 0), code.n, BATCH,
                         device))
    graph = slot_graph(code, device)
    syn = syndrome_bipolar(graph, x)
    ssum = syndrome_sum_per_vn(graph, syn).float()
    act = torch.ones((1, BATCH), dtype=torch.bool, device=device)

    def metric_flip_adapt():
        e = x.float() * r + gq[5:5 + code.n].flip(0) + w * ssum
        flip = e < qz(theta)
        return (torch.where(act & flip, -x, x),
                torch.where(act, torch.where(flip, theta / lam,
                                             theta * lam), theta))

    parts = {
        "source draw (B4) + quantizer": timer(lambda: qz(keyed_source(
            cfg, sigma, NoiseKey(SEED, 0), code.n, BATCH, device))),
        "syndrome (B6)": timer(lambda: syndrome_bipolar(graph, x)),
        "syndrome test (all > 0)": timer(lambda: (syn > 0).all(dim=0)),
        "per-VN syndrome sum": timer(
            lambda: syndrome_sum_per_vn(graph, syn).float()),
        "quantizer of theta": timer(lambda: qz(theta)),
        "metric + flip + adaptation": timer(metric_flip_adapt),
    }
    for k, v in parts.items():
        print(f"    {k:34s} {v:9.4f} ms")
    return parts


def phase_hw_paths(device, lib_path, timer):
    """NGDBFhw and the SystemC model at full width through ``simulate``,
    each gated against the JAX package's statistics, then B4 at both draw
    shapes."""
    from ldpcsimulation_tpu_torch.channel import snr_to_sigma
    from ldpcsimulation_tpu_torch.codes import load_named_code
    from ldpcsimulation_tpu_torch.decoders import (
        NGDBFHwConfig,
        SystemCNGDBFConfig,
        decode_ngdbf_hw,
        decode_ngdbf_systemc,
    )
    from ldpcsimulation_tpu_torch.kernels.channel import (
        NGDBFHW_RING_STREAM,
        SYSTEMC_STREAM,
    )

    out = {}
    hw = load_named_code(HW_CODE, device)
    cfg = NGDBFHwConfig(num_iterations=HW_T, ring_len=max(2648, hw.n + 600))
    sigma = snr_to_sigma(HW_SNR_DB, hw.rate)
    out["ngdbfhw_highrate"] = gated_simulate(
        f"(a) decode_ngdbf_hw {HW_CODE} {HW_SNR_DB} dB T={HW_T} 802.3an "
        "defaults", "ngdbfhw_highrate", hw, hw.k,
        lambda y, key: decode_ngdbf_hw(hw, y, sigma, cfg, key=key),
        lambda res: res.steps, HW_SNR_DB, 2, device)
    peg = load_named_code(PEG_CODE, device)
    scfg = SystemCNGDBFConfig(num_iterations=SYSTEMC_T, **SYSTEMC_KW)
    ssigma = snr_to_sigma(SYSTEMC_SNR_DB, peg.rate)

    def systemc_rounds(res):
        return (SYSTEMC_T if bool((res.iterations == SYSTEMC_T).any())
                else int(res.iterations.max()) + 1)

    out["systemc_peg"] = gated_simulate(
        f"(b) decode_ngdbf_systemc {PEG_CODE} {SYSTEMC_SNR_DB} dB "
        f"T={SYSTEMC_T} additive, smoothed", "systemc_peg", peg, peg.k,
        lambda y, key: decode_ngdbf_systemc(peg, y, ssigma, scfg, key=key),
        systemc_rounds, SYSTEMC_SNR_DB, 2, device, awgn_form="additive")
    for label, path in out.items():
        # the SystemC model's syndrome is B6; NGDBFhw's parity is its own
        checks, rest = b6_and_rest(path["launches"])
        check(rest == {"awgn_philox": 2, "gauss_philox": 2}
              and (checks >= 1) == (label == "systemc_peg"),
              f"{label}: launches {path['launches']}")
    print("  (a) one NGDBFhw step:")
    out["ngdbfhw_highrate"]["breakdown_ms"] = hw_breakdown(
        hw, cfg, sigma, device, timer)
    print("  (b) one SystemC-model step:")
    out["systemc_peg"]["breakdown_ms"] = systemc_breakdown(
        peg, scfg, ssigma, device, timer)
    out["b4_shapes"] = {
        "ngdbfhw ring": b4_at_shape(
            device, lib_path, timer, cfg.ring_len, NGDBFHW_RING_STREAM,
            float(np.float32(sigma * cfg.noise_scale)), "NGDBFhw ring"),
        "systemc source": b4_at_shape(
            device, lib_path, timer, peg.n + SYSTEMC_T, SYSTEMC_STREAM,
            float(np.float32(ssigma)), "SystemC source"),
    }
    return out


def phase_hw_sweep(device, batch):
    """The sweep CLI's ngdbfhw route with the pointer carry and the biased
    itdist estimator, and its refusal of --stream with the pointer carry
    (the JAX CLI's)."""
    from ldpcsimulation_tpu_torch.harness import fmt
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.tools.sweep import main as sweep_main

    args = ["ngdbfhw", "--code", CODE, "--snr", "3.5", "-T", "100",
            "--frames", str(2 * batch), "--batch", str(batch),
            "--persistent-qpointer", "--itdist-biased", "--device",
            str(device)]
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        log_path = f"{tmp}/hw.log"
        build.LAUNCHES.clear()
        rc = sweep_main(args + ["--log", log_path])
        launches = dict(build.LAUNCHES)
        with open(log_path) as f:
            row = f.read().splitlines()
        with open(f"{log_path}_3.5_itdist.dat") as f:
            itdist = [line.split("\t") for line in f.read().splitlines()]
        try:
            sweep_main(args + ["--stream", "--log", log_path])
            refused = ""
        except SystemExit as e:
            refused = str(e)
    check(rc == 0 and len(row) == 1, "ngdbfhw sweep wrote one row")
    cols = row[0].split("\t")
    want = ["3.5", None, None, None, None, None, str(2 * batch * 1008),
            str(2 * batch), "100", fmt(-0.525), fmt(0.95), fmt(0.185),
            fmt(1.625), "5", "1", "0"]
    check(len(cols) == len(want) and all(
        w is None or c == w for c, w in zip(cols, want)),
        f"ngdbfhw sweep row {cols}")
    check(0.0 <= float(cols[3]) < 0.5, f"BER {cols[3]}")
    vals = [float(v) for _, v in itdist]
    check([int(i) for i, _ in itdist] == list(range(len(itdist)))
          and vals[0] == 1.0 and len(vals) > 1, f"itdist {itdist[:3]}")
    check(launches == {"awgn_philox": 2, "gauss_philox": 2},
          f"ngdbfhw sweep launches {launches}")
    check("already chains ring offsets" in refused,
          f"--stream refusal {refused!r}")
    print(f"  row: {row[0]}; itdist {len(itdist)} lines from "
          f"{itdist[0]} to {itdist[-1]}; launches {launches}; --stream: "
          f"{refused}")
    return launches


# The stream paths [27]-[29] (ROADMAP A10 and the GDBF half of A11.4): the
# refill cadence of the sweep (2 rounds; 8 for the bit-flip family at
# T >= 64), lanes at full width.
STREAM_GDBF_K = 8
STREAM_FIELDS = ("gid", "iters", "errs", "hard")
GDBF_STREAM_FIELDS = STREAM_FIELDS + ("phases", "sat", "smooth")


def lanes_draws(device, lib_path, timer):
    """B3/B4's per-lane instances against their twins under ``torch.equal``
    (scattered int64 gids and steps, both domains and layouts, with the
    integers) at [1008 x 32768] and an edge shape, and against the
    contiguous kernels on contiguous gids and one step; each one's time,
    its twin's, the contiguous kernel's and its bounds."""
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.kernels.channel import (
        gauss_philox,
        gauss_philox_lanes,
        gauss_philox_lanes_plain,
        noise_stream,
        uniform_philox,
        uniform_philox_lanes,
        uniform_philox_lanes_plain,
    )
    from ldpcsimulation_tpu_torch.tools import sass_count

    n, scale = 1008, 0.6817
    gen = torch.Generator(device=device).manual_seed(SEED)
    kinds = {
        "uniform_philox_lanes": (
            lambda *a, **k: uniform_philox_lanes(*a, **k),
            lambda *a, **k: uniform_philox_lanes_plain(*a, **k), (),
            lambda f0, b, nn, s: uniform_philox(SEED, f0, b, nn, s, device),
            "ILb0ELi1ELb1ELb0EE", 2),
        "gauss_philox_lanes": (
            lambda *a, **k: gauss_philox_lanes(*a, **k),
            lambda *a, **k: gauss_philox_lanes_plain(*a, **k), (0.0, scale),
            lambda f0, b, nn, s: gauss_philox(SEED, f0, b, nn, s, 0.0, scale,
                                              device),
            "ILb1ELi1ELb1ELb0EE", 8),
    }
    kernels = sass_count.parse(sass_count.disassemble(lib_path))
    _, top = sm_clocks()
    build.PATHS.clear()
    out = {}
    for name, (fn, plain, extra, contiguous, key, ops_per) in kinds.items():
        err = 0.0
        for nn, b in ((n, BATCH), (1007, 33)):
            gid = torch.randint(-1, 2**40, (b,), generator=gen, device=device)
            step = torch.randint(0, 2**31 - 2, (b,), generator=gen,
                                 device=device, dtype=torch.int32)
            for domain in (0, 1):
                for layout in ("nb", "bn"):
                    got, k = fn(SEED, gid, step, nn, domain, *extra, layout,
                                with_bits=True)
                    want, k_p = plain(SEED, gid, step, nn, domain, *extra,
                                      layout, with_bits=True)
                    fin = torch.isfinite(want)
                    err = max(err, float((got[fin] - want[fin]).abs().max()))
                    check(torch.equal(k, k_p) and torch.equal(got, want),
                          f"{name} [{b} x {nn}] {layout} domain {domain}: "
                          "kernel != plain")
            # contiguous gids from below 2^32, one step: the contiguous
            # kernel's bits
            f0 = 2**32 - 100
            cg = f0 + torch.arange(b, device=device)
            cs = torch.full((b,), 37, dtype=torch.int32, device=device)
            check(torch.equal(fn(SEED, cg, cs, nn, 1, *extra),
                              contiguous(f0, b, nn, noise_stream(37, 1))),
                  f"{name} [{b} x {nn}]: per-lane != contiguous kernel")
        gid = torch.randint(0, 2**40, (BATCH,), generator=gen, device=device)
        step = torch.randint(0, 600, (BATCH,), generator=gen, device=device,
                             dtype=torch.int32)
        ms = timer(lambda: fn(SEED, gid, step, n, 0, *extra))
        plain_ms = timer(lambda: plain(SEED, gid, step, n, 0, *extra), 2)
        cont_ms = timer(lambda: contiguous(0, BATCH, n, noise_stream(5, 0)))
        k = sass_count.find(kernels, "philox_lanes_kernel" + key)
        path = k.path_length()
        threads = (n + 3) // 4 * (BATCH // 2)
        nbytes = n * BATCH * 4 + BATCH * (8 + 4)
        ops = n * BATCH * ops_per
        mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        issue = sass_count.issue_ms(threads, path, top, SMS)
        out[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, contiguous_ms=cont_ms,
            bound_ms=max(mem_ms, ops_ms),
            bound_by="bytes" if mem_ms >= ops_ms else "operations",
            issue_ms=issue, sass_path=path, sass_static=k.static_count,
            threads=threads, bytes=nbytes, operations=ops,
            share=max(mem_ms, ops_ms) / ms, issue_share=issue / ms,
            memory_share=mem_ms / ms)
        print(f"  {name}: kernel == plain at [{n} x {BATCH}] and [33 x "
              f"1007], both domains and layouts, and == the contiguous "
              f"kernel on contiguous gids; {ms:.4f} ms (contiguous "
              f"{cont_ms:.4f} ms), plain {plain_ms:.4f} ms; memory "
              f"{mem_ms:.4f} ms ({nbytes / 1e6:.1f} MB, share "
              f"{mem_ms / ms:.1%}), operations {ops_ms:.4f} ms, issue "
              f"{issue:.4f} ms ({path:g} SASS on one thread's path of "
              f"{k.static_count}, share {issue / ms:.1%}), roofline share "
              f"{max(mem_ms, ops_ms) / ms:.1%}")
    paths = {k: v for k, v in build.PATHS.items() if "lanes" in k[0]}
    check(all(paths.get((nm, p), 0) > 0 for nm in kinds
              for p in ("fast", "tail")), f"per-lane instances {paths}")
    return out


def stream_cases(device):
    """(label, adapter, code n, pool preprocess, SNR, T, refill_every, is BP)
    of the binary adapters, on the main path's codes."""
    from ldpcsimulation_tpu_torch.channel import (
        llr_from_channel,
        quantize_no_zero,
        snr_to_n0,
    )
    from ldpcsimulation_tpu_torch.codes import load_named_code, load_named_qc
    from ldpcsimulation_tpu_torch.harness import stream

    qc = load_named_qc(CODE)
    peg = load_named_code(PEG_CODE, device)
    f16 = torch.float16
    rate = (qc.n - qc.m) / qc.n

    def llr(snr):
        n0 = float(snr_to_n0(snr, rate))
        return lambda y: llr_from_channel(y, n0)

    quant = lambda y: quantize_no_zero(y, 1.6, 8.0)  # noqa: E731
    return [
        ("minsum qc f16", stream.minsum_qc_stream(qc, storage_dtype=f16),
         qc.n, None, 2.0, 10, 2, False),
        ("minsum slot-array f16", stream.minsum_stream(
            peg, storage_dtype=f16), peg.n, None, 2.0, 10, 2, False),
        ("minsum layered qc", stream.minsum_layered_qc_stream(qc), qc.n,
         None, 2.0, 10, 2, False),
        ("ddbmp qc", stream.ddbmp_qc_stream(qc), qc.n, quant, 3.9, 20, 2,
         False),
        ("ddbmp slot-array", stream.ddbmp_stream(peg), peg.n, quant, 3.9,
         20, 2, False),
        ("bp qc f16", stream.bp_qc_stream(qc, storage_dtype=f16), qc.n,
         llr(2.0), 2.0, 20, 2, True),
        ("bp slot-array", stream.bp_stream(peg), peg.n, llr(1.6), 1.6, 20,
         2, True),
        ("bp layered qc", stream.bp_layered_qc_stream(qc), qc.n, llr(2.0),
         2.0, 10, 2, True),
    ]


def records_of(acc, rec, fields):
    """A recorded call's valid records on the CPU."""
    rc = int(acc["rc"])
    return {f: rec[f][:rc].cpu() for f in fields}


def bp_records_agree(got, want, label):
    """BP card against CPU: the share of frames (by gid) whose iterations,
    errors and decisions agree, at least BP_FRAME_AGREEMENT."""
    def per(r):
        return {int(g): (int(i), int(e), h.numpy().tobytes()) for g, i, e, h
                in zip(r["gid"], r["iters"], r["errs"], r["hard"])}

    a, b = per(got), per(want)
    same = sum(a.get(g) == v for g, v in b.items()) / max(len(b), 1)
    check(set(a) == set(b) and same >= BP_FRAME_AGREEMENT,
          f"{label}: {len(a)} vs {len(b)} frames, agreement {same:.4f}")
    return same


def phase_streams_card_vs_cpu(device, lib_path, timer, lanes=64,
                              frames=256):
    """Every stream adapter and the GDBF stream, recorded on the card and on
    the CPU plain path over the same pool (kernel B2's rows on the card):
    records and counters equal under ``torch.equal`` (BP by agreement, as
    in [19]); then B3/B4's per-lane instances."""
    from ldpcsimulation_tpu_torch.channel import saturate, snr_to_sigma
    from ldpcsimulation_tpu_torch.codes import load_named_qc
    from ldpcsimulation_tpu_torch.decoders import preset
    from ldpcsimulation_tpu_torch.harness import stream, stream_gdbf
    from ldpcsimulation_tpu_torch.kernels import build

    counted = {}
    rate = 0.5
    for label, dec, n, pre, snr, t_max, k, is_bp in stream_cases(device):
        pool = stream.build_channel_pool(dec, SEED, 5 * frames, frames, n,
                                         snr_to_sigma(snr, rate), pre,
                                         device=device)
        rounds = 2 * t_max // k
        got = {}
        for dev, rows in ((device, pool), ("cpu", [p.cpu() for p in pool])):
            call = stream.make_stream_call(dec, n, t_max, rounds, k,
                                           record=True,
                                           rec_cap=frames + lanes)
            state = stream.stream_init(dec, lanes, n, device=dev)
            build.LAUNCHES.clear()
            state, acc, rec = call(state, *rows, 5 * frames)
            if dev == device:
                launched = dict(build.LAUNCHES)
            got[str(dev)] = (stream.fetch(acc), records_of(acc, rec,
                                                           STREAM_FIELDS))
        (a, r), (a_c, r_c) = got[str(device)], got["cpu"]
        check(a["rc"] > lanes, f"{label}: {a['rc']} frames retired")
        if is_bp:
            same = bp_records_agree(r, r_c, label)
            note = f"agreement {same:.4f}"
        else:
            for f in STREAM_FIELDS:
                check(torch.equal(r[f], r_c[f]), f"{label} {f}: card != CPU")
            for key in a:
                check(np.array_equal(a[key], a_c[key]),
                      f"{label} acc {key}: card != CPU")
            note = "records and counters equal"
        counted[label] = launched
        print(f"  {label} T={t_max} K={k}: {a['rc']} frames retired of "
              f"{a['consumed']} taken, {lanes} lanes, card vs CPU: {note}; "
              f"launches {launched}")

    qc = load_named_qc(CODE)
    code_d = qc.to_code(device)
    sat = lambda y: saturate(y, GDBF_YMAX)  # noqa: E731
    for name, snr, t_max, extra in (
        ("SMNGDBF", 3.25, 48, {}),
        ("RSMNGDBF", 3.0, 16, dict(max_phases=3)),
        ("StochasticNGDBF", 3.5, 32, {}),
    ):
        cfg = preset(name, t_max, **GDBF_KW, **extra)
        sigma = snr_to_sigma(snr, rate)
        pool = stream_gdbf.build_channel_pool_gdbf(
            code_d, SEED, 7 * frames, frames, sigma, sat, qc=qc,
            device=device)
        rounds = 2 * cfg.max_phases * t_max // STREAM_GDBF_K
        got = {}
        for dev, rows in ((device, pool), ("cpu", [p.cpu() for p in pool])):
            call = stream_gdbf.make_gdbf_stream_call(
                code_d, rounds, STREAM_GDBF_K, qc=qc, record=True,
                rec_cap=frames + lanes)
            state = stream_gdbf.gdbf_stream_init(code_d, cfg, lanes,
                                                 device=dev)
            build.LAUNCHES.clear()
            state, acc, rec = call(state, *rows, 7 * frames, SEED, sigma,
                                   cfg)
            if dev == device:
                launched = dict(build.LAUNCHES)
            got[str(dev)] = (stream.fetch(acc),
                             records_of(acc, rec, GDBF_STREAM_FIELDS))
        (a, r), (a_c, r_c) = got[str(device)], got["cpu"]
        for f in GDBF_STREAM_FIELDS:
            check(torch.equal(r[f], r_c[f]), f"{name} {f}: card != CPU")
        for key in a:
            check(np.array_equal(a[key], a_c[key]),
                  f"{name} acc {key}: card != CPU")
        draws = rounds * STREAM_GDBF_K
        want = ({"gauss_philox_lanes": draws} if cfg.add_noise else
                {"uniform_philox_lanes": draws})
        # B6: the syndrome of every lane-step (the stream's VN side is
        # plain torch)
        want["parity_check"] = draws
        check(launched == want, f"{name}: launches {launched} != {want}")
        counted[name] = launched
        print(f"  {name} T={t_max} x{cfg.max_phases} K={STREAM_GDBF_K}: "
              f"{a['rc']} frames retired, card == CPU (records, counters); "
              f"max phases {int(r['phases'].max())}; launches {launched}")
    return counted, lanes_draws(device, lib_path, timer)


def count_steps(dec, steps):
    """``dec`` with each iteration counted in ``steps[0]``."""
    import dataclasses

    def counted(fn):
        if fn is None:
            return None

        def wrapped(*a):
            steps[0] += 1
            return fn(*a)

        return wrapped

    return dataclasses.replace(dec, step=counted(dec.step),
                               step_fresh=counted(dec.step_fresh))


def stream_steady(make_call, init, pool_of, lanes, rounds, k, extra=()):
    """Frames retired per second and lane-iterations per frame in a normal
    call after a warm one (the lanes filled, their finishing times spread),
    and the host syncs of that call (``torch.cuda.set_sync_debug_mode``)."""
    import warnings

    from ldpcsimulation_tpu_torch.harness.stream import fetch

    call = make_call(rounds, k)
    state = init()
    base = 0
    pool = pool_of(base)
    state, acc, _ = call(state, *pool, base, *extra)
    base += fetch(acc)["consumed"]
    pool = pool_of(base)
    torch.cuda.synchronize()
    def sync_warnings(caught):
        # the warning of each sync; the mode's own first warning (that it is
        # a prototype which does not see every sync) is none
        return [w for w in caught
                if "called a synchronizing" in str(w.message)]

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        state, acc, _ = call(state, *pool, base, *extra)
        torch.cuda.set_sync_debug_mode("default")
    a = fetch(acc)
    secs = time.perf_counter() - t0
    syncs = sync_warnings(caught)
    for w in syncs:
        print(f"  host sync: {w.filename}:{w.lineno}: {w.message}")
    with warnings.catch_warnings(record=True) as control:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        bool(state["idle"].all())  # a sync the mode must see
        torch.cuda.set_sync_debug_mode("default")
    check(len(sync_warnings(control)) == 1, "the sync detector saw no sync")
    syncs = len(syncs)
    return dict(frames=a["frames"], seconds=secs,
                frames_per_s=a["frames"] / secs,
                lane_iterations_per_frame=rounds * k * lanes / a["frames"],
                syncs=syncs)


def stream_path(label, jax_point, k_info, run, exact, steady, batch_rounds,
                device):
    """One stream path at full width: the gated run (launch counters reset
    just before and read just after, statistics within 4 joint s.e. of the
    JAX package's CPU run), the exactness run (integer totals equal to the
    batch decoder's over the same gid prefix) and the steady state."""
    from ldpcsimulation_tpu_torch.kernels import build

    steps = [0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    build.LAUNCHES.clear()
    stats = run(steps)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    rate_bits = stats.total_words * k_info / stats.wall_seconds
    per_frame = steps[0] * BATCH / stats.total_words
    print(f"  {label}: BER {stats.ber!r} FER {stats.fer!r} avg iterations "
          f"{stats.avg_iterations!r} over {stats.total_words} frames in "
          f"{stats.wall_seconds:.4f} s (drain included): {rate_bits:.6g} "
          f"decoded info bits/s; {steps[0]} stream iterations, "
          f"{per_frame:.4g} lane-iterations per counted frame (the batch "
          f"path: {batch_rounds}); peak device memory {peak:.2f} GiB; "
          f"launches {launches}")
    check(launches.get("awgn_philox", 0) >= 1, f"{label}: B2 {launches}")
    got = mc_moments(stats, len(stats.error_weight_hist))
    for key, (want, want_se) in jax_point.items():
        val, se = got[key]
        bound = 4 * math.hypot(se, want_se)
        print(f"  {key}: port {val:.6g} (se {se:.3g}), JAX {want:.6g} (se "
              f"{want_se:.3g}), |diff| {abs(val - want):.3g} <= {bound:.3g}")
        check(abs(val - want) <= bound, f"{label} {key} outside 4 joint s.e.")
    s_stats, b_stats = exact()
    totals = [(s.errors, s.word_errors, s.total_iterations)
              for s in (s_stats, b_stats)]
    print(f"  exactness: stream and batch decoder over gids 0 .. "
          f"{s_stats.total_words - 1}: (bit errors, word errors, "
          f"iterations) {totals[0]} and {totals[1]}")
    check(s_stats.total_words == b_stats.total_words
          and totals[0] == totals[1], f"{label}: stream != batch {totals}")
    st = steady()
    st_bits = st["frames_per_s"] * k_info
    print(f"  steady state: {st['frames']} frames in one normal call of "
          f"{st['seconds']:.4f} s: {st_bits:.6g} decoded info bits/s, "
          f"{st['lane_iterations_per_frame']:.4g} lane-iterations per "
          f"frame; {st['syncs']} host syncs in the call")
    check(st["syncs"] == 0, f"{label}: {st['syncs']} syncs in a normal call")
    return dict(
        ber=stats.ber, fer=stats.fer, avg_iterations=stats.avg_iterations,
        frames=stats.total_words, decoded_info_bits_per_s=rate_bits,
        stream_iterations=steps[0], lane_iterations_per_frame=per_frame,
        batch_rounds_per_frame=batch_rounds, peak_gib=peak,
        launches=launches, exact_totals=totals[0], exact_frames=
        s_stats.total_words, steady_bits_per_s=st_bits,
        steady_lane_iterations_per_frame=st["lane_iterations_per_frame"],
        syncs_in_a_normal_call=st["syncs"])


def phase_stream_paths(device):
    """The four stream paths at full width (lanes = 32768) at the operating
    points of [21] and [10]."""
    from ldpcsimulation_tpu_torch.channel import (
        llr_from_channel,
        quantize_no_zero,
        saturate,
        snr_to_n0,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.codes import load_named_code, load_named_qc
    from ldpcsimulation_tpu_torch.decoders import (
        decode_bp_qc,
        decode_ddbmp,
        decode_gdbf,
        decode_minsum_layered_qc,
        preset,
    )
    from ldpcsimulation_tpu_torch.harness import (
        StopRule,
        simulate,
        stream,
        stream_gdbf,
    )

    f16 = torch.float16
    exact_lanes, exact_frames = 2048, 4096
    out = {}

    def binary(label, point, code, k_info, dec, pre, snr, t_max, frames,
               batch_dec, batch_rounds, pool_dtype=None):
        rate = k_info / code.n

        def run_stream(steps, lanes, n_frames, pool_bytes=None):
            return stream.simulate_stream(
                code.n, count_steps(dec, steps), snr, rate, t_max,
                stop=StopRule.fixed_frames(n_frames), lanes=lanes,
                refill_every=2, seed=SEED, preprocess=pre,
                pool_dtype=pool_dtype, pool_bytes=pool_bytes, device=device)

        def exact():
            s = run_stream([0], exact_lanes, exact_frames,
                           pool_bytes=code.n * 4 * 3 * exact_lanes)
            b = simulate(code, lambda y, key: batch_dec(y), snr, rate=rate,
                         stop=StopRule.fixed_frames(s.total_words),
                         batch_size=exact_frames, seed=SEED,
                         preprocess=pre, device=device)
            return s, b

        sigma = snr_to_sigma(snr, rate)
        # a normal call of about a frame's average iterations
        rounds = math.ceil(JAX_POINTS[point]["avg_iterations"][0] / 2) + 1

        def steady():
            return stream_steady(
                lambda r, k: stream.make_stream_call(dec, code.n, t_max, r,
                                                     k),
                lambda: stream.stream_init(dec, BATCH, code.n, device=device),
                lambda base: stream.build_channel_pool(
                    dec, SEED, base, 3 * BATCH, code.n, sigma, pre,
                    device=device),
                BATCH, rounds, 2)

        out[point] = stream_path(
            label, JAX_POINTS[point], k_info,
            lambda steps: run_stream(steps, BATCH, frames), exact, steady,
            batch_rounds, device)

    qc = load_named_qc(CODE)
    code = qc.to_code(device)
    n0 = float(snr_to_n0(2.0, 0.5))
    llr = lambda y: llr_from_channel(y, n0)  # noqa: E731
    binary(f"(a) bp_qc_stream {CODE} 2.0 dB T=20 f16", "bp_qc", code,
           qc.n - qc.m, stream.bp_qc_stream(qc, storage_dtype=f16), llr, 2.0,
           20, 8 * BATCH,
           lambda y: decode_bp_qc(qc, y, 20, early_termination=True,
                                  storage_dtype=f16), 20)
    wifi = load_named_qc(WIFI_CODE)
    binary(f"(b) minsum_layered_qc_stream {WIFI_CODE} 2.0 dB T={T} f32",
           "minsum_layered_wifi", wifi.to_code(device), wifi.n - wifi.m,
           stream.minsum_layered_qc_stream(wifi), None, 2.0, T, 8 * BATCH,
           lambda y: decode_minsum_layered_qc(wifi, y, T,
                                              early_termination=True), T)
    reg4 = load_named_code(REG4_CODE, device)
    binary(f"(c) ddbmp_stream {REG4_CODE} 3.9 dB Ymax 1.6 nq 8 T=100",
           "ddbmp_reg4", reg4, reg4.k, stream.ddbmp_stream(reg4),
           lambda y: quantize_no_zero(y, 1.6, 8.0), 3.9, 100, BATCH,
           lambda y: decode_ddbmp(reg4, y, 100), 100)

    # (d) SMNGDBF, the reference's PEGReg504x1008 point ([10])
    cfg = preset("SMNGDBF", GDBF_T, **GDBF_KW)
    sat = lambda y: saturate(y, GDBF_YMAX)  # noqa: E731
    rate = (qc.n - qc.m) / qc.n
    sigma = snr_to_sigma(GDBF_SNR_DB, rate)

    def run_gdbf(lanes, n_frames, pool_bytes=None):
        return stream_gdbf.simulate_stream_gdbf(
            code, cfg, GDBF_SNR_DB, stop=StopRule.fixed_frames(n_frames),
            lanes=lanes, refill_every=STREAM_GDBF_K, seed=SEED,
            preprocess=sat, qc=qc, pool_bytes=pool_bytes, device=device)

    def exact_gdbf():
        s = run_gdbf(exact_lanes, exact_frames, qc.n * 4 * 3 * exact_lanes)
        b = simulate(code, lambda yq, key: decode_gdbf(code, yq, sigma, cfg,
                                                       key=key, qc=qc),
                     GDBF_SNR_DB, stop=StopRule.fixed_frames(s.total_words),
                     batch_size=exact_frames, seed=SEED, preprocess=sat,
                     device=device)
        return s, b

    def gdbf_counted(steps):
        from ldpcsimulation_tpu_torch.kernels import build

        stats = run_gdbf(BATCH, 4 * BATCH)
        steps[0] = build.LAUNCHES["gauss_philox_lanes"]  # one per step
        return stats

    out["smngdbf"] = stream_path(
        f"(d) simulate_stream_gdbf SMNGDBF {CODE} {GDBF_SNR_DB} dB "
        f"T={GDBF_T}", JAX_SMNGDBF, qc.n - qc.m, gdbf_counted, exact_gdbf,
        lambda: stream_steady(
            lambda r, k: stream_gdbf.make_gdbf_stream_call(code, r, k,
                                                           qc=qc),
            lambda: stream_gdbf.gdbf_stream_init(code, cfg, BATCH,
                                                 device=device),
            lambda base: stream_gdbf.build_channel_pool_gdbf(
                code, SEED, base, 3 * BATCH, sigma, sat, qc=qc,
                device=device),
            BATCH, math.ceil(JAX_SMNGDBF["avg_iterations"][0]
                             / STREAM_GDBF_K) + 1,
            STREAM_GDBF_K, extra=(SEED, sigma, cfg)),
        GDBF_T, device)
    return out


def phase_stream_sweep(device, batch):
    """The sweep CLI's --stream routes, one row each (the NGDBFhw and NB
    stream routes in [33])."""
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.tools.sweep import main as sweep_main

    common = ["--batch", str(batch), "--max-frames", str(batch), "--device",
              str(device), "--stream"]
    et = ["--early-termination"]
    runs = (
        (["minsum", "--code", CODE, "--snr", "2.0", "-T", "10",
          "--msg-dtype", "f16", *et], 6, "10", "minsum_cn_scan"),
        (["bp", "--code", CODE, "--snr", "2.0", "-T", "20", "--msg-dtype",
          "f16", *et], 6, "20", "bp_cn_pair"),
        (["bp", "--code", WIFI_CODE, "--schedule", "layered", "--snr", "2.0",
          "-T", "10", *et], 6, "10", "bp_cn_pair"),
        (["ddbmp", "--code", CODE, "--snr", "3.9", "-T", "100", "--ymax",
          "1.6"], 7, "100", None),
        (["gdbf", "--preset", "SMNGDBF", "--uniform-noise", "--code", CODE,
          "--snr", "3.25", "-T", "100", "--theta", "-0.9", "--noise-scale",
          "0.975", "--lam", "0.988", "--alpha", "0.75", "--ymax", "2.5"], 16,
         "100", "uniform_philox_lanes"),
    )
    launched = {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        for i, (args, width, t_col, kernel) in enumerate(runs):
            log_path = f"{tmp}/stream{i}.log"
            build.LAUNCHES.clear()
            rc = sweep_main(args + common + ["--log", log_path])
            launches = dict(build.LAUNCHES)
            with open(log_path) as f:
                row = f.read().splitlines()
            check(rc == 0 and len(row) == 1, f"{args[:3]} wrote one row")
            cols = row[0].split("\t")
            t_at = 6 if args[0] == "gdbf" else 4
            check(len(cols) == width and cols[t_at] == t_col
                  and 0.0 <= float(cols[1]) < 0.1, f"{args[:3]} row {cols}")
            check(launches.get("awgn_philox", 0) >= 1 and (
                kernel is None or launches.get(kernel, 0) > 0),
                f"{' '.join(args[:5])}: launches {launches}")
            for k, v in launches.items():
                launched[k] = launched.get(k, 0) + v
            print(f"  {' '.join(args[:5])} --stream: {row[0]}; launches "
                  f"{launches}")
    return launched


# The NGDBFhw stream (ROADMAP A11.4, second half) and the non-binary family
# (A12).  The NGDBFhw stream refills every 16 steps with
# lanes = 32768, as the JAX CLI's ``ngdbfhw --stream``; the NB path decodes
# GF(8) ``nb_regular(6000, 4000, 3, q=8, seed=0)`` (the geometry of the
# reference's q8.sp.6000.4000.3000.1) at B=512 (the JAX package's documented
# batch), 1.3 dB (its knee: FER 0.34 in the JAX CPU run), T=20, early
# termination, f16 message storage; its stream refills every iteration.
HW_STREAM_K = 16
NB_CODE = (6000, 4000, 3, 8)
NB_SNR_DB, NB_T, NB_BATCH = 1.3, 20, 512
# NB card against CPU: one check update's messages as normalized
# probabilities p = exp(x - max over the field), |card - cpu| <=
# NB_PROB_ATOL (f32 storage) or, with f16 storage, <= 1.1 p (u(x) + u(max))
# + NB_PROB_ATOL with u one f16 ulp at the log value's magnitude -- compared
# as probabilities because the inverse WHT of a vanishing probability
# cancels to a residue of either sign, whose log (clamped at 0, plus
# 1e-30) is -69 or ~-18 -- and the share of frames whose T=10 symbols and
# iterations agree.
NB_PROB_ATOL = 1e-5
NB_FRAME_AGREEMENT = 0.97
HW_STREAM_FIELDS = ("gid", "iters", "errs", "sat", "qp0", "hard")


def nb_moments(stats):
    """(value, standard error) of SER, BER, FER and average iterations from
    an NB run's per-frame histograms."""
    f = stats.total_words

    def hist(h, offset, scale):
        w = np.arange(len(h)) + offset
        mean = (w * h).sum() / f
        var = ((w**2 * h).sum() / f - mean**2) * f / (f - 1)
        return mean / scale, math.sqrt(var / f) / scale

    m = stats.q.bit_length() - 1
    return dict(ser=hist(stats.symbol_weight_hist, 1, stats.n),
                ber=hist(stats.bit_weight_hist, 1, stats.n * m),
                fer=(stats.fer, math.sqrt(stats.fer * (1 - stats.fer) / f)),
                avg_iterations=hist(stats.iteration_hist, 0, 1.0))


def f16_ulp(x):
    """One f16 ulp at each element's magnitude, as f32."""
    return torch.from_numpy(np.spacing(x.abs().numpy().astype(np.float16))
                            .astype(np.float32))


def gate(label, got, point):
    """Each statistic within 4 joint standard errors of the JAX point."""
    for key, (want, want_se) in point.items():
        val, se = got[key]
        bound = 4 * math.hypot(se, want_se)
        print(f"  {key}: port {val:.6g} (se {se:.3g}), JAX {want:.6g} (se "
              f"{want_se:.3g}), |diff| {abs(val - want):.3g} <= {bound:.3g}")
        check(abs(val - want) <= bound, f"{label} {key} outside 4 joint s.e.")


def nb_code(device):
    from ldpcsimulation_tpu_torch.codes import build_code, nb_regular

    n, m, dv, q = NB_CODE
    return build_code(nb_regular(n, m, dv, q, seed=0), device)


def ring_lanes_draw(device, lib_path, timer):
    """B4's per-lane entry on the ring's stream (``lane_rings``) against its
    twin (scattered int64 gids, past 2^31, with the integers), against the
    contiguous ``keyed_ring`` on contiguous gids, and the CPU twin against
    the card; its time, its twin's and its bounds at the refill shapes."""
    from ldpcsimulation_tpu_torch.decoders import NoiseKey
    from ldpcsimulation_tpu_torch.decoders.ngdbf_hw import (
        RING_LANE_STEP,
        NGDBFHwConfig,
        _ring_integers,
        keyed_ring,
        lane_rings,
    )
    from ldpcsimulation_tpu_torch.harness.stream_ngdbfhw import (
        default_refill_cap,
    )
    from ldpcsimulation_tpu_torch.kernels.channel import (
        gauss_philox_lanes,
        gauss_philox_lanes_plain,
    )
    from ldpcsimulation_tpu_torch.tools import sass_count

    cfg = NGDBFHwConfig(num_iterations=HW_T, ring_len=2648)
    sigma = 0.5
    scale = float(np.float32(sigma * cfg.noise_scale))
    gen = torch.Generator(device=device).manual_seed(SEED)
    err = 0.0
    for b in (BATCH, 33):
        gid = torch.randint(2**31 - 2 * b, 2**40, (b,), generator=gen,
                            device=device)
        step = torch.full((b,), RING_LANE_STEP, dtype=torch.int32,
                          device=device)
        got, k = gauss_philox_lanes(SEED, gid, step, cfg.ring_len, 0, 0.0,
                                    scale, with_bits=True)
        want, k_p = gauss_philox_lanes_plain(SEED, gid, step, cfg.ring_len,
                                             0, 0.0, scale, with_bits=True)
        check(torch.equal(k, k_p) and torch.equal(got, want),
              f"ring lanes [{cfg.ring_len} x {b}]: kernel != plain")
        check(torch.equal(lane_rings(cfg, sigma, SEED, gid), got),
              "lane_rings != gauss_philox_lanes on the ring step")
        fin = torch.isfinite(want)
        err = max(err, float((got[fin] - want[fin]).abs().max()))
        del got, k, want, k_p, fin
    f0 = 2**31 - 700
    cg = f0 + torch.arange(1024, device=device)
    ring = lane_rings(cfg, sigma, SEED, cg)
    check(torch.equal(ring, keyed_ring(cfg, sigma, NoiseKey(SEED, f0), 1024,
                                       device)),
          "lane_rings != keyed_ring on contiguous gids past 2^31")
    ring_c = lane_rings(cfg, sigma, SEED, cg.cpu())
    raw_equal = torch.equal(ring_c, ring.cpu())
    check(torch.equal(_ring_integers(cfg, ring_c),
                      _ring_integers(cfg, ring).cpu()),
          "lane_rings: the CPU twin's ring integers != the card's")
    kern = sass_count.find(sass_count.parse(sass_count.disassemble(lib_path)),
                           "philox_lanes_kernelILb1ELi1ELb1ELb0EE")
    _, top = sm_clocks()
    hint = JAX_POINTS["ngdbfhw_highrate"]["avg_iterations"][0]
    out = dict(max_abs_err=err, shapes={})
    for cols in (default_refill_cap(BATCH, HW_STREAM_K, hint), BATCH):
        gid = torch.randint(0, 2**40, (cols,), generator=gen, device=device)
        ms = timer(lambda: lane_rings(cfg, sigma, SEED, gid))
        step = torch.full((cols,), RING_LANE_STEP, dtype=torch.int32,
                          device=device)
        plain_ms = timer(lambda: gauss_philox_lanes_plain(
            SEED, gid, step, cfg.ring_len, 0, 0.0, scale), 2)
        threads = (cfg.ring_len + 3) // 4 * ((cols + 1) // 2)
        path = kern.path_length()
        nbytes = cfg.ring_len * cols * 4 + cols * (8 + 4)
        ops = cfg.ring_len * cols * 8
        mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        issue = sass_count.issue_ms(threads, path, top, SMS)
        out["shapes"][f"[{cfg.ring_len} x {cols}]"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(mem_ms, ops_ms),
            bound_by="bytes" if mem_ms >= ops_ms else "operations",
            issue_ms=issue, memory_share=mem_ms / ms,
            share=max(mem_ms, ops_ms, issue) / ms, bytes=nbytes,
            operations=ops, sass_path=path)
        print(f"  ring lanes [{cfg.ring_len} x {cols}]: {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; memory {mem_ms:.4f} ms ({nbytes / 1e6:.1f}"
              f" MB, share {mem_ms / ms:.1%}), operations {ops_ms:.4f} ms, "
              f"issue {issue:.4f} ms ({path:g} SASS, share {issue / ms:.1%})")
    print(f"  ring lanes: kernel == twin at [{cfg.ring_len} x {BATCH}] and "
          f"[{cfg.ring_len} x 33] (gids from 2^31, step {RING_LANE_STEP}), "
          "== keyed_ring on contiguous gids; the CPU twin's ring integers =="
          f" the card's (raw draws equal: {raw_equal})")
    return out


def phase_hw_nb_card_vs_cpu(device, lib_path, timer, lanes=64, frames=256):
    """[30] The NGDBFhw stream recorded on the card and on the CPU plain path
    over the same B2 pool (records and counters under ``torch.equal``), B4's
    per-lane ring draw, the NB decoders card against CPU (QSPA by tolerance
    and agreement, min-sum/min-max under ``torch.equal`` on the same
    negative logs) and the NB stream on the card against the batch decoder
    on the card (``torch.equal`` per frame) and against the CPU stream."""
    from ldpcsimulation_tpu_torch.channel import (
        awgn_all_zero,
        snr_to_n0,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.channel.nb import symbol_priors
    from ldpcsimulation_tpu_torch.codes import (
        build_code,
        load_named_code,
        load_named_qc,
        nb_regular,
    )
    from ldpcsimulation_tpu_torch.decoders import NGDBFHwConfig
    from ldpcsimulation_tpu_torch.decoders.nb_minsum import (
        decode_nb_minsum_nll,
        nb_nll,
    )
    from ldpcsimulation_tpu_torch.decoders.nb_qspa import (
        decode_nb_qspa,
        nb_qspa_machine,
    )
    from ldpcsimulation_tpu_torch.harness import stream
    from ldpcsimulation_tpu_torch.harness import stream_ngdbfhw as sh
    from ldpcsimulation_tpu_torch.kernels import build

    counted = {}
    qc = load_named_qc(CODE)
    hw = load_named_code(HW_CODE, device)
    for label, code_d, q, snr, phases, k, cap in (
        (f"{HW_CODE} x1 K=16 cap 32", hw, None, HW_SNR_DB, 1, 16, 32),
        (f"{HW_CODE} x3 K=4", hw, None, 4.0, 3, 4, None),
        (f"{CODE} (QC ops) x1 K=16", qc.to_code(device), qc, 3.5, 1, 16,
         None),
    ):
        cfg = NGDBFHwConfig(num_iterations=60, max_phases=phases,
                            ring_len=max(2648, code_d.n + 600))
        sigma = snr_to_sigma(snr, code_d.rate)
        rounds = 3 * 60 * phases // k
        build.LAUNCHES.clear()
        pool = sh.build_channel_pool_hw(code_d, SEED, 9 * frames, frames,
                                        sigma, q, device=device)
        got = {}
        for dev, rows in ((device, pool), ("cpu", [p.cpu() for p in pool])):
            code = code_d.to(dev)
            call = sh.make_hw_stream_call(code, cfg, rounds, k, qc=q,
                                          record=True,
                                          rec_cap=frames + lanes,
                                          refill_cap=cap)
            state = sh.hw_stream_init(code, cfg, lanes, dev, record=True)
            state, acc, rec = call(state, *rows, 9 * frames, SEED, sigma)
            if dev == device:
                launched = dict(build.LAUNCHES)
            got[str(dev)] = (stream.fetch(acc),
                             records_of(acc, rec, HW_STREAM_FIELDS))
        (a, r), (a_c, r_c) = got[str(device)], got["cpu"]
        check(a["rc"] > lanes, f"NGDBFhw stream {label}: {a['rc']} retired")
        for f in HW_STREAM_FIELDS:
            check(torch.equal(r[f], r_c[f]),
                  f"NGDBFhw stream {label} {f}: card != CPU")
        for key in a:
            check(np.array_equal(a[key], a_c[key]),
                  f"NGDBFhw stream {label} acc {key}: card != CPU")
        check(launched == {"awgn_philox": 1, "gauss_philox_lanes": rounds},
              f"NGDBFhw stream {label}: launches {launched}")
        counted[label] = launched
        print(f"  NGDBFhw stream {label}: {a['rc']} frames retired of "
              f"{a['consumed']} taken, {lanes} lanes, card == CPU (records, "
              f"counters); {len(set(r['qp0'].tolist()))} ring offsets; "
              f"launches {launched}")
    rings = ring_lanes_draw(device, lib_path, timer)

    # the NB decoders: the three check-node forms (q = 4, 8, 16)
    # points where ~97 % of frames check out within T=10: a frame that does
    # not wanders, and an ulp sends it elsewhere
    for q, snr in ((4, 2.6), (8, 2.6), (16, 2.6)):
        m = q.bit_length() - 1
        code_c = build_code(nb_regular(480, 320, 3, q, seed=0))
        code_d = code_c.to(device)
        n0 = float(snr_to_n0(snr, code_c.rate))
        y = awgn_all_zero(SEED, 0, 128, code_c.n * m, math.sqrt(n0 / 2),
                          device).reshape(128, code_c.n, m)
        pri = symbol_priors(y, n0, q)
        pri_c = symbol_priors(y.cpu(), n0, q)
        perr = float((pri.cpu() - pri_c).abs().max())
        check(perr <= 1e-6, f"NB q={q} priors card vs CPU {perr}")
        for sdt in (None, torch.float16):
            M_d = nb_qspa_machine(code_d, q, torch.float32, sdt)
            M_c = nb_qspa_machine(code_c, q, torch.float32, sdt)
            lp = M_c["log_of"](pri_c.permute(1, 2, 0).contiguous())
            v2c = M_c["init"](lp)
            c2v = M_d["cn_update"](v2c.to(device)).float().cpu()
            x = M_c["cn_update"](v2c).float()
            top = x.amax(dim=1, keepdim=True)
            p_c = torch.exp(x - top)
            dp = (torch.exp(c2v - c2v.amax(dim=1, keepdim=True)) - p_c).abs()
            tol = NB_PROB_ATOL
            if sdt is not None:
                tol = tol + 1.1 * p_c * (f16_ulp(x) + f16_ulp(top))
            check(bool((dp <= tol).all()),
                  f"NB q={q} {sdt} cn_update: card vs CPU {dp.max()}")
            dp = float(dp.max())
            res = decode_nb_qspa(code_d, pri, 10, storage_dtype=sdt)
            ref = decode_nb_qspa(code_c, pri_c, 10, storage_dtype=sdt)
            same = float(((res.symbols.cpu() == ref.symbols).all(dim=1)
                          & (res.iterations.cpu() == ref.iterations))
                         .float().mean())
            check(same >= NB_FRAME_AGREEMENT,
                  f"NB q={q} {sdt} decode: agreement {same}")
            print(f"  NB QSPA q={q} storage {sdt or 'f32'}: one check update "
                  f"card vs CPU within {dp:.2g}, T=10 decodes agree on "
                  f"{same:.4f} of 128 frames (satisfied "
                  f"{float(res.satisfied.float().mean()):.3f}); priors "
                  f"within {perr:.2g}")
        nll = nb_nll(pri_c)
        for variant in ("minsum", "minmax"):
            res = decode_nb_minsum_nll(code_d, nll.to(device), 10, variant)
            ref = decode_nb_minsum_nll(code_c, nll, 10, variant)
            for f in ("symbols", "iterations", "satisfied"):
                check(torch.equal(getattr(res, f).cpu(), getattr(ref, f)),
                      f"NB {variant} q={q} {f}: card != CPU")
        print(f"  NB min-sum and min-max q={q}: card == CPU on the same "
              "negative logs")

    # the NB stream: card against the card's batch decoder, and the CPU, at
    # 1.6 dB, where frames check out ([31] holds the 1.3 dB point's totals)
    code = nb_code(device)
    q = code.q
    n0 = float(snr_to_n0(1.6, code.rate))
    sigma = math.sqrt(n0 / 2)
    f16 = torch.float16
    dec = stream.nb_qspa_stream(code, n0, q, f16)
    nb_frames, nb_lanes = 4 * 64, 64
    pool = stream.build_channel_pool_nb(dec, SEED, 0, nb_frames, code.n, q,
                                        sigma, device)
    got = {}
    for dev, rows in ((device, pool), ("cpu", [p.cpu() for p in pool])):
        dec_d = stream.nb_qspa_stream(code.to(dev), n0, q, f16)
        call = stream.make_stream_call(dec_d, code.n, NB_T, NB_T + 10, 1,
                                       record=True,
                                       rec_cap=nb_frames + nb_lanes,
                                       max_weight=code.n * 3)
        state = stream.stream_init(dec_d, nb_lanes, code.n * q, device=dev)
        build.LAUNCHES.clear()
        state, acc, rec = call(state, *rows, 0)
        got[str(dev)] = (stream.fetch(acc), records_of(acc, rec,
                                                       STREAM_FIELDS))
    (a, r), (_, r_c) = got[str(device)], got["cpu"]
    m = q.bit_length() - 1
    y = awgn_all_zero(SEED, 0, nb_frames, code.n * m, sigma, device)
    res = decode_nb_qspa(code, symbol_priors(y.reshape(nb_frames, code.n, m),
                                             n0, q), NB_T, storage_dtype=f16)
    g = r["gid"].long()
    check(torch.equal(r["iters"], res.iterations.cpu()[g])
          and torch.equal(r["hard"], res.symbols.cpu()[g].to(torch.int8)),
          "NB stream on the card != the batch decoder on the card")
    per = {int(gg): (int(i), int(e)) for gg, i, e in
           zip(r["gid"], r["iters"], r["errs"])}
    per_c = {int(gg): (int(i), int(e)) for gg, i, e in
             zip(r_c["gid"], r_c["iters"], r_c["errs"])}
    same = sum(per_c.get(gg) == v for gg, v in per.items()) / len(per)
    check(a["rc"] >= nb_lanes and same >= NB_FRAME_AGREEMENT,
          f"NB stream card vs CPU: {a['rc']} frames, agreement {same}")
    print(f"  NB stream GF(8) ({code.n} symbols, f16, 1.6 dB): {a['rc']} "
          f"frames retired, each equal to the card's batch decode (symbols, "
          f"iterations); card vs CPU stream agreement {same:.4f}")
    return counted, rings


def hw_stream_path(device, timer):
    """[31a] ``simulate_stream_ngdbfhw`` at full width, gated on the JAX
    point; a 2048-lane recorded stream over a 4096-frame prefix equal frame
    by frame to the batch decoder on the card at the recorded ring offsets;
    the steady state; one step's and one boundary's device time."""
    from ldpcsimulation_tpu_torch.channel import snr_to_sigma
    from ldpcsimulation_tpu_torch.codes import load_named_code
    from ldpcsimulation_tpu_torch.decoders import (
        NGDBFHwConfig,
        NoiseKey,
        decode_ngdbf_hw,
    )
    from ldpcsimulation_tpu_torch.harness import StopRule, stream
    from ldpcsimulation_tpu_torch.harness import stream_ngdbfhw as sh
    from ldpcsimulation_tpu_torch.kernels import build

    code = load_named_code(HW_CODE, device)
    cfg = NGDBFHwConfig(num_iterations=HW_T, ring_len=max(2648, code.n + 600))
    sigma = snr_to_sigma(HW_SNR_DB, code.rate)
    hint = JAX_POINTS["ngdbfhw_highrate"]["avg_iterations"][0]
    label = (f"(a) simulate_stream_ngdbfhw {HW_CODE} {HW_SNR_DB} dB T={HW_T}"
             f" K={HW_STREAM_K}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    build.LAUNCHES.clear()
    stats = sh.simulate_stream_ngdbfhw(
        code, cfg, HW_SNR_DB, stop=StopRule.fixed_frames(4 * BATCH),
        lanes=BATCH, refill_every=HW_STREAM_K, avg_iters_hint=hint,
        seed=SEED, device=device)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    rate_bits = stats.total_words * code.k / stats.wall_seconds
    steps = stats.extra["steps"]
    per_frame = steps * BATCH / stats.total_words
    print(f"  {label}: BER {stats.ber!r} FER {stats.fer!r} avg iterations "
          f"{stats.avg_iterations!r} over {stats.total_words} frames in "
          f"{stats.wall_seconds:.4f} s (drain included): {rate_bits:.6g} "
          f"decoded info bits/s; {steps} stream steps, {per_frame:.4g} "
          f"lane-iterations per counted frame (the batch path: {HW_T}); "
          f"peak device memory {peak:.2f} GiB; launches {launches}")
    check(launches.get("awgn_philox", 0) >= 1
          and launches.get("gauss_philox_lanes", 0) >= 1
          and "gauss_philox" not in launches, f"{label}: launches {launches}")
    gate(label, mc_moments(stats, code.n), JAX_POINTS["ngdbfhw_highrate"])

    # exactness: every frame of a recorded 2048-lane stream equals the batch
    # decode on the card at its ring offset
    lanes, frames = 2048, 4096
    call = sh.make_hw_stream_call(
        code, cfg, 16, HW_STREAM_K, record=True, rec_cap=frames + lanes,
        refill_cap=sh.default_refill_cap(lanes, HW_STREAM_K, hint))
    state = sh.hw_stream_init(code, cfg, lanes, device, record=True)
    pool = sh.build_channel_pool_hw(code, SEED, 0, frames, sigma,
                                    device=device)
    parts = []
    for ptr0 in (0, *([frames] * (2 + HW_T // (16 * HW_STREAM_K)))):
        if ptr0 and bool(state["idle"].all()):
            break
        state, acc, rec = call(state, *pool, 0, SEED, sigma, ptr0)
        parts.append(records_of(acc, rec, HW_STREAM_FIELDS))
    rec = {f: torch.cat([p[f] for p in parts]) for f in HW_STREAM_FIELDS}
    order = torch.argsort(rec["gid"])
    rec = {f: v[order] for f, v in rec.items()}
    check(torch.equal(rec["gid"], torch.arange(frames)),
          f"exactness stream: frames {len(rec['gid'])} of {frames}")
    res = decode_ngdbf_hw(code, pool[0], sigma, cfg, key=NoiseKey(SEED, 0),
                          qpointer0=rec["qp0"].to(device))
    for f, v in (("iters", res.iterations), ("errs", res.least_errors),
                 ("sat", res.satisfied), ("hard", res.hard.to(torch.int8))):
        check(torch.equal(rec[f], v.cpu()), f"exactness stream {f} != batch")
    totals = (int(rec["errs"].sum()), int((rec["errs"] > 0).sum()),
              int(rec["iters"].sum()))
    print(f"  exactness: {frames} frames of a {lanes}-lane stream equal the "
          f"batch decoder on the card at their ring offsets "
          f"({len(set(rec['qp0'].tolist()))} offsets): (bit errors, word "
          f"errors, iterations) {totals}")

    cap = sh.default_refill_cap(BATCH, HW_STREAM_K, hint)
    st = stream_steady(
        lambda r, k: sh.make_hw_stream_call(code, cfg, r, k, refill_cap=cap),
        lambda: sh.hw_stream_init(code, cfg, BATCH, device),
        lambda base: sh.build_channel_pool_hw(code, SEED, base, 3 * BATCH,
                                              sigma, device=device),
        BATCH, math.ceil(hint / HW_STREAM_K) + 1, HW_STREAM_K,
        extra=(SEED, sigma))
    st_bits = st["frames_per_s"] * code.k
    print(f"  steady state: {st['frames']} frames in one normal call of "
          f"{st['seconds']:.4f} s: {st_bits:.6g} decoded info bits/s, "
          f"{st['lane_iterations_per_frame']:.4g} lane-iterations per "
          f"frame; {st['syncs']} host syncs in the call")
    check(st["syncs"] == 0, f"{label}: {st['syncs']} syncs in a normal call")

    # one step and one boundary: calls of one boundary and 1 or 17 steps
    pool = sh.build_channel_pool_hw(code, SEED, 0, 4 * BATCH, sigma,
                                    device=device)
    state = [sh.hw_stream_init(code, cfg, BATCH, device)]
    times = {}
    for k in (1, 17):
        call = sh.make_hw_stream_call(code, cfg, 1, k, refill_cap=cap)

        def one():
            state[0], _, _ = call(state[0], *pool, 0, SEED, sigma)

        for _ in range(12):
            one()  # lanes filled, their finishing times spread
        times[k] = timer(one, 5)
    step_ms = (times[17] - times[1]) / 16
    boundary_ms = times[1] - step_ms
    print(f"  device time: one step {step_ms:.3f} ms, one boundary "
          f"{boundary_ms:.3f} ms (refill cap {cap} of {BATCH} lanes)")
    return dict(
        ber=stats.ber, fer=stats.fer, avg_iterations=stats.avg_iterations,
        frames=stats.total_words, decoded_info_bits_per_s=rate_bits,
        stream_steps=steps, lane_iterations_per_frame=per_frame,
        batch_rounds_per_frame=HW_T, peak_gib=peak, launches=launches,
        exact_totals=totals, exact_frames=frames,
        steady_bits_per_s=st_bits,
        steady_lane_iterations_per_frame=st["lane_iterations_per_frame"],
        syncs_in_a_normal_call=st["syncs"], step_ms=step_ms,
        boundary_ms=boundary_ms, refill_cap=cap)


def nb_breakdown(code, device, timer):
    """Device time of each NB layer at B=512: priors, one check update, one
    variable update, the decision and the syndrome check."""
    from ldpcsimulation_tpu_torch.channel import awgn_all_zero, snr_to_n0
    from ldpcsimulation_tpu_torch.channel.nb import symbol_priors
    from ldpcsimulation_tpu_torch.decoders.nb_qspa import nb_qspa_machine

    q = code.q
    m = q.bit_length() - 1
    n0 = float(snr_to_n0(NB_SNR_DB, code.rate))
    y = awgn_all_zero(SEED, 0, NB_BATCH, code.n * m, math.sqrt(n0 / 2),
                      device).reshape(NB_BATCH, code.n, m)
    M = nb_qspa_machine(code, q, torch.float32, torch.float16)
    pri = symbol_priors(y, n0, q)
    lp = M["log_of"](pri.permute(1, 2, 0).contiguous())
    v2c = M["init"](lp)
    c2v = M["cn_update"](v2c)
    _, post = M["vn_update"](c2v, lp)
    sym = M["decide"](post)
    parts = {
        "priors": timer(lambda: M["log_of"](symbol_priors(y, n0, q).permute(
            1, 2, 0).contiguous()), 5),
        "cn_update": timer(lambda: M["cn_update"](v2c), 5),
        "vn_update": timer(lambda: M["vn_update"](c2v, lp), 5),
        "decide": timer(lambda: M["decide"](post), 5),
        "syndrome_ok": timer(lambda: M["syndrome_ok"](sym), 5),
    }
    print(f"  NB layers at B={NB_BATCH} (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))
    return parts


def nb_paths(device, timer):
    """[31b] ``simulate_stream_nb`` (512 lanes, refill every iteration) and
    ``simulate_nb`` (B=512) at the NB point, each gated on the JAX point,
    their totals equal over the same frames; the batch decode's ms per
    iteration, the stream's steady state and the layers' times."""
    import contextlib

    from ldpcsimulation_tpu_torch.channel import (
        awgn_all_zero,
        snr_to_n0,
    )
    from ldpcsimulation_tpu_torch.channel.nb import symbol_priors
    from ldpcsimulation_tpu_torch.decoders.nb_qspa import decode_nb_qspa
    from ldpcsimulation_tpu_torch.harness import StopRule, stream
    from ldpcsimulation_tpu_torch.harness.montecarlo_nb import simulate_nb
    from ldpcsimulation_tpu_torch.kernels import build

    code = nb_code(device)
    q = code.q
    m = q.bit_length() - 1
    k_info = (code.n - code.m) * m
    n0 = float(snr_to_n0(NB_SNR_DB, code.rate))
    f16 = torch.float16
    point = JAX_POINTS["nbqspa_gf8"]
    out = {}

    @contextlib.contextmanager
    def counting(steps):
        orig = stream.nb_qspa_stream
        stream.nb_qspa_stream = lambda *a, **k: count_steps(orig(*a, **k),
                                                            steps)
        try:
            yield
        finally:
            stream.nb_qspa_stream = orig

    def measured(label, run):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        build.LAUNCHES.clear()
        stats = run()
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        rate_bits = stats.total_words * k_info / stats.wall_seconds
        print(f"  {label}: SER {stats.ser!r} BER {stats.ber!r} FER "
              f"{stats.fer!r} avg iterations {stats.avg_iterations!r} over "
              f"{stats.total_words} frames in {stats.wall_seconds:.4f} s: "
              f"{rate_bits:.6g} decoded info bits/s; peak device memory "
              f"{peak:.2f} GiB; launches {launches}")
        check(launches.get("awgn_philox", 0) >= 1 and set(launches) == {
            "awgn_philox"}, f"{label}: launches {launches}")
        gate(label, nb_moments(stats), point)
        return stats, dict(
            ser=stats.ser, ber=stats.ber, fer=stats.fer,
            avg_iterations=stats.avg_iterations, frames=stats.total_words,
            decoded_info_bits_per_s=rate_bits, peak_gib=peak,
            launches=launches)

    steps = [0]
    with counting(steps):
        s_stats, out["stream"] = measured(
            f"(b) simulate_stream_nb GF(8) {NB_SNR_DB} dB T={NB_T} f16, "
            f"{NB_BATCH} lanes", lambda: stream.simulate_stream_nb(
                code, NB_SNR_DB, NB_T, stop=StopRule.fixed_frames(
                    16 * NB_BATCH), lanes=NB_BATCH, refill_every=1,
                seed=SEED, storage_dtype=f16, device=device))
    per_frame = steps[0] * NB_BATCH / s_stats.total_words
    out["stream"].update(stream_iterations=steps[0],
                         lane_iterations_per_frame=per_frame)
    print(f"  {steps[0]} stream iterations: {per_frame:.4g} lane-iterations "
          f"per counted frame (the batch path runs {NB_T} while any frame "
          "of a batch fails)")
    simulate_nb(code, NB_SNR_DB, NB_T, stop=StopRule.fixed_frames(NB_BATCH),
                batch_size=NB_BATCH, seed=SEED, storage_dtype=f16,
                device=device)  # warm-up batch
    b_stats, out["batch"] = measured(
        f"(c) simulate_nb GF(8) {NB_SNR_DB} dB T={NB_T} f16, B={NB_BATCH}",
        lambda: simulate_nb(code, NB_SNR_DB, NB_T, stop=StopRule.fixed_frames(
            s_stats.total_words), batch_size=NB_BATCH, seed=SEED,
            storage_dtype=f16, device=device))
    keys = ("bit_errors", "symbol_errors", "word_errors", "total_iterations")
    totals = [tuple(getattr(s, k) for k in keys) for s in (s_stats, b_stats)]
    print(f"  exactness: stream and batch over gids 0 .. "
          f"{s_stats.total_words - 1}: (bit, symbol, word errors, "
          f"iterations) {totals[0]} and {totals[1]}")
    check(totals[0] == totals[1], f"NB stream != batch {totals}")
    out["exact_totals"] = totals[0]

    # one batch decode: ms per executed iteration
    y = awgn_all_zero(SEED, 0, NB_BATCH, code.n * m, math.sqrt(n0 / 2),
                      device).reshape(NB_BATCH, code.n, m)
    pri = symbol_priors(y, n0, q)
    res = decode_nb_qspa(code, pri, NB_T, storage_dtype=f16)
    executed = (NB_T if not bool(res.satisfied.all())
                else int(res.iterations.max()))
    ms = timer(lambda: decode_nb_qspa(code, pri, NB_T, storage_dtype=f16), 3)
    out["batch"].update(decode_ms=ms, ms_per_iteration=ms / executed)
    print(f"  one decode of {NB_BATCH} frames: {ms:.2f} ms for {executed} "
          f"iterations, {ms / executed:.3f} ms per iteration")
    dec = stream.nb_qspa_stream(code, n0, q, f16)
    st = stream_steady(
        lambda r, k: stream.make_stream_call(dec, code.n, NB_T, r, k,
                                             max_weight=code.n * m),
        lambda: stream.stream_init(dec, NB_BATCH, code.n * q, device=device),
        lambda base: stream.build_channel_pool_nb(
            dec, SEED, base, 3 * NB_BATCH, code.n, q, math.sqrt(n0 / 2),
            device),
        NB_BATCH, math.ceil(point["avg_iterations"][0]) + 1, 1)
    st_bits = st["frames_per_s"] * k_info
    print(f"  stream steady state: {st['frames']} frames in one normal call "
          f"of {st['seconds']:.4f} s: {st_bits:.6g} decoded info bits/s, "
          f"{st['lane_iterations_per_frame']:.4g} lane-iterations per "
          f"frame; {st['syncs']} host syncs in the call")
    check(st["syncs"] == 0, f"NB stream: {st['syncs']} syncs in a call")
    out["stream"].update(
        steady_bits_per_s=st_bits,
        steady_lane_iterations_per_frame=st["lane_iterations_per_frame"],
        syncs_in_a_normal_call=st["syncs"])
    out["breakdown_ms"] = nb_breakdown(code, device, timer)
    return out


def b2_at_shape(device, lib_path, timer, batch, n, label):
    """B2 against its twin (on the card) at [batch, n]: samples and
    integers under ``torch.equal``; its time, its twin's and its bounds."""
    from ldpcsimulation_tpu_torch.kernels.channel import (
        awgn_philox,
        awgn_philox_plain,
    )
    from ldpcsimulation_tpu_torch.tools import sass_count

    sigma = 0.7
    y, bits = awgn_philox(SEED, 3 * batch, batch, n, sigma, device,
                          with_bits=True)
    y_p, bits_p = awgn_philox_plain(SEED, 3 * batch, batch, n, sigma, device,
                                    with_bits=True)
    check(torch.equal(bits, bits_p) and torch.equal(y, y_p),
          f"B2 {label} [{batch} x {n}]: kernel != plain")
    err = float((y - y_p).abs().max())
    del y, bits, y_p, bits_p
    ms = timer(lambda: awgn_philox(SEED, 0, batch, n, sigma, device))
    plain_ms = timer(lambda: awgn_philox_plain(SEED, 0, batch, n, sigma,
                                               device), 2)
    _, top = sm_clocks()
    kern = sass_count.find(sass_count.parse(sass_count.disassemble(lib_path)),
                           "awgn_philox_kernelILb1ELb0EE")
    threads = batch * ((n + 3) // 4)
    path = kern.path_length()
    nbytes, ops = batch * n * 4, batch * n * 12
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    issue = sass_count.issue_ms(threads, path, top, SMS)
    print(f"  B2 at the {label} [{batch} x {n}]: equal to its twin; "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms; memory {mem_ms:.4f} ms "
          f"({nbytes / 1e6:.1f} MB, share {mem_ms / ms:.1%}), operations "
          f"{ops_ms:.4f} ms, issue {issue:.4f} ms ({path:g} SASS, share "
          f"{issue / ms:.1%})")
    return dict(shape=[batch, n], ms=ms, plain_ms=plain_ms,
                bound_ms=max(mem_ms, ops_ms),
                bound_by="bytes" if mem_ms >= ops_ms else "operations",
                issue_ms=issue, memory_share=mem_ms / ms,
                share=max(mem_ms, ops_ms, issue) / ms, max_abs_err=err)


def phase_b2_shapes(device, lib_path, timer):
    """[32] B2 at the NB batch [512 x 18000] and at the two new pools' shapes
    (the NB stream's and the NGDBFhw stream's, by ``pool_policy``)."""
    from ldpcsimulation_tpu_torch.harness.stream import pool_policy

    n, _, _, q = NB_CODE
    m = q.bit_length() - 1
    _, nb_pool = pool_policy(NB_BATCH, 1, None, 6.0, n * q * 4,
                             default_rounds=32)
    hint = JAX_POINTS["ngdbfhw_highrate"]["avg_iterations"][0]
    _, hw_pool = pool_policy(BATCH, HW_STREAM_K, None, hint, 2048 * 4,
                             default_rounds=32)
    return {
        "nb batch": b2_at_shape(device, lib_path, timer, NB_BATCH, n * m,
                                "NB batch"),
        "nb stream pool": b2_at_shape(device, lib_path, timer, nb_pool,
                                      n * m, "NB stream pool"),
        "ngdbfhw stream pool": b2_at_shape(device, lib_path, timer, hw_pool,
                                           2048, "NGDBFhw stream pool"),
    }


def phase_hw_nb_sweep(device):
    """[33] The sweep CLI's ``ngdbfhw --stream`` and ``nbqspa`` routes
    (``--nb-random``, ``--stream``, an NB alist written here), one row each
    with the JAX CLI's columns, and the refusals."""
    from ldpcsimulation_tpu_torch.codes import nb_regular, save_alist
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.tools.sweep import main as sweep_main

    nb_spec = ":".join(map(str, NB_CODE))
    common = ["--device", str(device)]
    nb = ["-T", str(NB_T), "--msg-dtype", "f16", "--batch", str(NB_BATCH),
          "--max-frames", str(2 * NB_BATCH)]
    launched = {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        alist = f"{tmp}/gf16.alist"
        save_alist(nb_regular(960, 640, 3, 16, seed=1), alist)
        runs = (
            (["ngdbfhw", "--code", HW_CODE, "--snr", str(HW_SNR_DB), "-T",
              str(HW_T), "--frames", "16384", "--batch", "8192", "--stream"],
             16, "gauss_philox_lanes"),
            (["nbqspa", "--nb-random", nb_spec, "--snr", str(NB_SNR_DB),
              "--early-termination", *nb], 7, None),
            (["nbqspa", "--nb-random", nb_spec, "--snr", str(NB_SNR_DB),
              "--stream", *nb], 7, None),
            (["nbqspa", "--alist", alist, "--snr", "2.0",
              "--early-termination", *nb], 7, None),
        )
        for i, (args, width, kernel) in enumerate(runs):
            log_path = f"{tmp}/r{i}.log"
            build.LAUNCHES.clear()
            rc = sweep_main(args + common + ["--log", log_path])
            launches = dict(build.LAUNCHES)
            with open(log_path) as f:
                row = f.read().splitlines()
            check(rc == 0 and len(row) == 1, f"{args[:3]} wrote one row")
            cols = row[0].split("\t")
            t_at = 8 if args[0] == "ngdbfhw" else 5
            check(len(cols) == width and cols[t_at] == args[args.index("-T")
                                                            + 1],
                  f"{args[:3]} row {cols}")
            if args[0] == "nbqspa":
                check(cols[6] == (alist if "--alist" in args
                                  else f"nb_random_{nb_spec}")
                      and 0.0 <= float(cols[2]) <= float(cols[1]) <= 1.0,
                      f"nbqspa row {cols}")
            check(launches.get("awgn_philox", 0) >= 1 and (
                kernel is None or launches.get(kernel, 0) > 0),
                f"{' '.join(args[:4])}: launches {launches}")
            for k, v in launches.items():
                launched[k] = launched.get(k, 0) + v
            print(f"  {' '.join(args[:4])}{' --stream' * ('--stream' in args)}"
                  f": {row[0]}; launches {launches}")
        for args, want in (
            (["ngdbfhw", "--code", HW_CODE, "--snr", "4.25", "-T", "600",
              "--stream", "--persistent-qpointer"],
             "already chains ring offsets"),
            (["nbqspa", "--nb-random", "24:12:3:4", "--snr", "2.0,3.0",
              "-T", "4", "--distributed"],
             "needs len(snrs)=2 to divide the device count (1)"),
        ):
            try:
                sweep_main(args + common + ["--log", f"{tmp}/x.log"])
                msg = ""
            except SystemExit as e:
                msg = str(e)
            check(want in msg, f"{' '.join(args[:3])}: {msg!r}")
            print(f"  {' '.join(args[-2:])} refused: {msg}")
    return launched


# The experiment tools [34]-[36].  Replay: [10]'s SMNGDBF point, the
# stochastic rule (B3's flip uniforms) and the uniform-noise transform (B3
# through the perturbation), one batch each at batch index 2, 4 failed and
# 4 satisfied frames replayed per family: (label, preset, SNR, T, config
# overrides).
REPLAY_FAMILIES = (
    ("SMNGDBF", "SMNGDBF", GDBF_SNR_DB, GDBF_T, {}),
    ("StochasticNGDBF", "StochasticNGDBF", 3.0, 100, {}),
    ("SMNGDBF --uniform-noise", "SMNGDBF", GDBF_SNR_DB, GDBF_T,
     dict(uniform_noise=True)),
)
REPLAY_BATCH_INDEX = 2
REPLAY_FRAMES = 4
# redecode_statistics at its CLI's documented point (qc_1008_504, 3.5 dB,
# SMNGDBF T=300 with the CLI defaults, 200 frames x 100 attempts, seed 0)
# and the JAX tool's values there (``python -m tests.jax_reference_stats
# redecode_qc``, its CPU run): (value, standard error over frames).
REDECODE_SNR_DB, REDECODE_FRAMES, REDECODE_ATTEMPTS = 3.5, 200, 100
JAX_REDECODE = dict(
    mean_pe=(0.0007000000000000001, 0.0003131137189664884),
    share_pe_pos=(0.035, 0.012995191418367026),
)


def time_small_ms(fn, reps: int = 50) -> float:
    """:func:`time_ms` for a launch-bound call (batch 1): a sleep kernel of
    ~25 ms keeps the card busy while the host enqueues all ``reps`` calls,
    so the time is the device's, not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def draw_bound(kind, batch, n, ms):
    """(bound ms, what bounds it) of a keyed draw of [batch, n] samples:
    each written once (f32), no input read; the f32 operations of
    [13]'s counts."""
    samples = batch * n
    ops = {"awgn_philox": 12, "uniform_philox": 2, "gauss_philox": 8}[kind]
    mem_ms = samples * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = samples * ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(mem_ms, ops_ms),
                bound_by="bytes" if mem_ms >= ops_ms else "operations",
                share=max(mem_ms, ops_ms) / ms)


def draws_at_batch1(device, timer, frame0, g, sigma):
    """B2, B3 and B4 at batch 1 for frame g (the instance each takes):
    equal to their twins and to frame g's row (column) of the batch draw
    of frames frame0 ... frame0 + BATCH - 1; times and bounds."""
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.kernels.channel import (
        awgn_philox,
        awgn_philox_plain,
        gauss_philox,
        gauss_philox_plain,
        noise_stream,
        uniform_philox,
        uniform_philox_plain,
    )

    n, j = 1008, g - frame0
    st_u, st_g = noise_stream(7, 1), noise_stream(7, 0)
    cases = {
        "awgn_philox": (
            lambda b, f0: awgn_philox(SEED, f0, b, n, sigma, device),
            lambda: awgn_philox_plain(SEED, g, 1, n, sigma, device),
            lambda big: big[j:j + 1]),
        "uniform_philox": (
            lambda b, f0: uniform_philox(SEED, f0, b, n, st_u, device),
            lambda: uniform_philox_plain(SEED, g, 1, n, st_u, "nb", device),
            lambda big: big[:, j:j + 1]),
        "gauss_philox": (
            lambda b, f0: gauss_philox(SEED, f0, b, n, st_g, 0.0, 0.6817,
                                       device),
            lambda: gauss_philox_plain(SEED, g, 1, n, st_g, 0.0, 0.6817,
                                       "nb", device),
            lambda big: big[:, j:j + 1]),
    }
    out = {}
    for kind, (draw, plain, column) in cases.items():
        build.PATHS.clear()
        one = draw(1, g)
        paths = dict(build.PATHS)
        check(list(paths.values()) == [1] and next(iter(paths))[0] == kind,
              f"{kind} at batch 1: instances {paths}")
        instance = next(iter(paths))[1]
        want = plain()
        fin = torch.isfinite(want)
        err = float((one[fin] - want[fin]).abs().max())
        check(torch.equal(one, want), f"{kind} at batch 1: kernel != plain")
        check(torch.equal(one, column(draw(BATCH, frame0))),
              f"{kind} at batch 1 != its column of the batch draw")
        ms = time_small_ms(lambda: draw(1, g))
        plain_ms = timer(plain, 5)
        out[kind] = dict(shape=[1, n], instance=instance, ms=ms,
                         plain_ms=plain_ms, max_abs_err=err,
                         **draw_bound(kind, 1, n, ms))
        print(f"  {kind} at batch 1 (frame {g}, its {instance} instance): "
              f"equal to its twin and to the batch draw's row; {ms:.4f} ms "
              f"of device time, plain {plain_ms:.4f} "
              f"ms; bound {out[kind]['bound_ms']:.2e} ms "
              f"({out[kind]['bound_by']}, share {out[kind]['share']:.2%})")
    return out


def phase_replay(qc, device, timer):
    """[34] Replay and trace on the card at full width: one batch of 32768
    frames at batch index 2 per family, 4 failed and 4 satisfied frames
    replayed through ``replay_channel`` + ``trace_gdbf`` at B=1 on the card
    (iterations, flag and last row equal to the in-batch decode), the same
    traces on the CPU with the card's keyed draws injected (every row
    equal), and B2, B3, B4 at batch 1."""
    from collections import Counter

    from ldpcsimulation_tpu_torch.channel import (
        awgn_all_zero,
        saturate,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.decoders import NoiseKey, decode_gdbf, preset
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.tools.replay import (
        replay_channel,
        replay_decoder_randomness,
        trace_gdbf,
    )

    code_d, code_c = qc.to_code(device), qc.to_code("cpu")
    rate = (qc.n - qc.m) / qc.n
    frame0 = REPLAY_BATCH_INDEX * BATCH
    out = {"launches": {}, "traced": {}}
    for label, name, snr, T_, kw in REPLAY_FAMILIES:
        t0 = time.perf_counter()
        cfg = preset(name, T_, **GDBF_KW, **kw)
        sigma = snr_to_sigma(snr, rate)
        build.LAUNCHES.clear()
        y = awgn_all_zero(SEED, frame0, BATCH, qc.n, sigma, device)
        res = decode_gdbf(code_d, saturate(y, GDBF_YMAX), sigma, cfg,
                          key=NoiseKey(SEED, frame0), qc=qc)
        sat, iters, hard = (res.satisfied.cpu(), res.iterations.cpu(),
                            res.hard.cpu())
        failed = torch.nonzero(~sat).flatten()[:REPLAY_FRAMES].tolist()
        good = torch.nonzero(sat).flatten()[:REPLAY_FRAMES].tolist()
        check(len(failed) == len(good) == REPLAY_FRAMES,
              f"{label}: {int((~sat).sum())} failed frames in the batch")
        traced = Counter()
        for f in failed + good:
            y_f, key = replay_channel(code_d, SEED, REPLAY_BATCH_INDEX, f,
                                      BATCH, sigma, device=device)
            check(torch.equal(y_f, y[f]), f"{label} frame {f}: channel")
            yq = saturate(y_f, GDBF_YMAX)
            before = Counter(build.LAUNCHES)
            tr = trace_gdbf(code_d, yq, sigma, cfg, key=key)
            traced.update(Counter(build.LAUNCHES) - before)
            check(tr.iterations == int(iters[f])
                  and tr.satisfied == bool(sat[f])
                  and np.array_equal(tr.decisions[-1], hard[f].numpy()),
                  f"{label} frame {f}: the trace ({tr.iterations}, "
                  f"{tr.satisfied}) != the in-batch decode "
                  f"({int(iters[f])}, {bool(sat[f])})")
            pert, unif = replay_decoder_randomness(qc.n, cfg, key, 1, 0,
                                                   sigma, device=device)
            cpu = trace_gdbf(
                code_c, yq.cpu(), sigma, cfg,
                perturbations=None if pert is None else pert.cpu(),
                stoch_uniforms=None if unif is None else unif.cpu())
            check((cpu.iterations, cpu.satisfied) == (tr.iterations,
                                                      tr.satisfied)
                  and np.array_equal(cpu.decisions, tr.decisions)
                  and np.array_equal(cpu.syndromes, tr.syndromes),
                  f"{label} frame {f}: CPU trace != card trace")
        out["launches"][label] = dict(build.LAUNCHES)
        out["traced"][label] = dict(traced)
        steps = cfg.max_phases * T_
        want = "uniform_philox" if (cfg.uniform_noise or
                                    cfg.quantize_probabilities) else \
            "gauss_philox"
        # a trace: B6 every step and on its rows, B7 every parallel step
        traces = 2 * REPLAY_FRAMES
        want = Counter({want: traces * steps,
                        "parity_check": traces * (steps + 1)})
        if not cfg.quantize_probabilities:
            want["gdbf_parallel_step"] = traces * steps
        check(traced == want, f"{label}: trace launches {dict(traced)}")
        print(f"  {label} ({snr} dB, T={T_}): frames {failed} failed and "
              f"{good} satisfied of batch {REPLAY_BATCH_INDEX} "
              f"({int((~sat).sum())} failed of {BATCH}) replay at B=1 on the "
              f"card equal to their in-batch decode, and on the CPU on the "
              f"card's draws row for row; launches {dict(build.LAUNCHES)} "
              f"({time.perf_counter() - t0:.1f} s)")
    out["batch1"] = draws_at_batch1(device, timer, frame0,
                                    frame0 + 17, snr_to_sigma(3.25, rate))
    return out


def phase_redecode(device, timer):
    """[35] redecode_statistics at its documented size on the card: wall,
    frames per second, peak memory; mean Pe(f) and the share of frames
    with Pe > 0 within 4 joint standard errors of the JAX tool's run
    (frames the sampling unit); three attempts replayed alone at B=1; B4
    at the attempts' [1008 x F·NR] against its twin with its bounds."""
    from ldpcsimulation_tpu_torch.channel import awgn_all_zero, snr_to_sigma
    from ldpcsimulation_tpu_torch.codes import load_named_code
    from ldpcsimulation_tpu_torch.decoders import decode_gdbf, preset
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.kernels.channel import (
        gauss_philox,
        gauss_philox_plain,
        noise_stream,
    )
    from ldpcsimulation_tpu_torch.tools.redecode_stats import (
        attempt_key,
        redecode_statistics,
    )

    code = load_named_code(CODE, device)
    cfg = preset("SMNGDBF", GDBF_T, **GDBF_KW)
    nf, nr = REDECODE_FRAMES, REDECODE_ATTEMPTS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    out = redecode_statistics(code, cfg, REDECODE_SNR_DB, num_frames=nf,
                              num_redecodes=nr, seed=0, device=device)
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    pe = (out > 0).mean(axis=1)
    got = dict(mean_pe=(pe.mean(), pe.std(ddof=1) / math.sqrt(nf)))
    share = (pe > 0).mean()
    got["share_pe_pos"] = (share, math.sqrt(share * (1 - share) / nf))
    print(f"  {nf} frames x {nr} attempts in {wall:.3f} s: "
          f"{nf * nr / wall:.6g} decoded frames/s, peak {peak:.2f} GiB; "
          f"launches {launches}; {int((out > 0).sum())} failed attempts")
    check(launches.get("awgn_philox") == 1 and launches.get(
        "gauss_philox", 0) > 0, f"redecode launches {launches}")
    for k, (want, want_se) in JAX_REDECODE.items():
        val, se = got[k]
        bound = 4 * math.hypot(se, want_se)
        print(f"  {k}: port {val:.6g} (se {se:.3g}), JAX {want:.6g} (se "
              f"{want_se:.3g}), |diff| {abs(val - want):.3g} <= {bound:.3g}")
        check(abs(val - want) <= bound, f"redecode {k} outside 4 joint s.e.")
    sigma = snr_to_sigma(REDECODE_SNR_DB, code.rate)
    bad = np.argwhere(out > 0)
    pairs = [(0, 0), (nf - 1, nr - 1)] + (
        [tuple(int(x) for x in bad[0])] if len(bad) else [(nf // 2, 7)])
    for f, a in pairs:
        y = awgn_all_zero(0, f, 1, code.n, sigma, device)
        res = decode_gdbf(code, y, sigma, cfg, key=attempt_key(0, f, a, nr))
        w = int((res.hard != 1).sum())
        check(w == out[f, a], f"attempt ({f}, {a}): {w} != {out[f, a]}")
    print(f"  attempts {pairs} replayed alone at B=1: equal error weights "
          f"{[int(out[f, a]) for f, a in pairs]}")
    cols, stream = nf * nr, noise_stream(3, 0)
    ns = float(np.float32(sigma * cfg.noise_scale))
    big = gauss_philox(0, 0, cols, code.n, stream, 0.0, ns, device)
    plain = gauss_philox_plain(0, 0, cols, code.n, stream, 0.0, ns, "nb",
                               device)
    check(torch.equal(big, plain), "B4 at [1008 x F·NR]: kernel != plain")
    fin = torch.isfinite(plain)
    err = float((big[fin] - plain[fin]).abs().max())
    del big, plain, fin
    ms = timer(lambda: gauss_philox(0, 0, cols, code.n, stream, 0.0, ns,
                                    device))
    plain_ms = timer(lambda: gauss_philox_plain(0, 0, cols, code.n, stream,
                                                0.0, ns, "nb", device), 2)
    b4 = dict(shape=[code.n, cols], ms=ms, plain_ms=plain_ms,
              max_abs_err=err, **draw_bound("gauss_philox", cols, code.n,
                                            ms))
    print(f"  B4 at [{code.n} x {cols}]: equal to its twin; {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms; bound {b4['bound_ms']:.4f} ms "
          f"({b4['bound_by']}, share {b4['share']:.1%})")
    return dict(wall_s=wall, frames_per_s=nf * nr / wall, peak_gib=peak,
                mean_pe=got["mean_pe"], share_pe_pos=got["share_pe_pos"],
                launches=launches, b4=b4)


def phase_tools_card(device, timer, rates):
    """[36] ``trace_soft_decoder`` on a peg_1008_504 frame, card against
    CPU (min-sum equal; BP: decisions and sign errors equal, and each
    iteration's messages from the same input within BP_RTOL/BP_ATOL), B1
    at B=1 against its twin with its time; then ``perf_report``'s flagship
    and SM-NGDBF working-point rows beside [5]'s and [10]'s rates."""
    from ldpcsimulation_tpu_torch.channel import (
        awgn_all_zero,
        llr_from_channel,
        snr_to_n0,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.codes import load_named_code
    from ldpcsimulation_tpu_torch.decoders import bp_step, minsum_plan
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.kernels.minsum import (
        minsum_cn_scan,
        minsum_cn_scan_plain,
    )
    from ldpcsimulation_tpu_torch.tools import perf_report
    from ldpcsimulation_tpu_torch.tools.msg_trace import trace_soft_decoder

    code_c = load_named_code(PEG_CODE)
    code_d = code_c.to(device)
    sigma = snr_to_sigma(SNR_DB, 0.5)
    y = awgn_all_zero(SEED, 5, 1, code_c.n, sigma, "cpu")[0]
    truth = np.ones(code_c.n)
    build.LAUNCHES.clear()
    ms_d = trace_soft_decoder(code_c, y, truth, T, "minsum", device=device)
    launches = dict(build.LAUNCHES)
    ms_c = trace_soft_decoder(code_c, y, truth, T, "minsum", device="cpu")
    for field in ("v2c_sign_errors", "checks_with_errors", "decisions"):
        for a, b in zip(getattr(ms_d, field), getattr(ms_c, field)):
            check(np.array_equal(a, b), f"msg_trace min-sum {field}: card "
                  "!= CPU")
    check(launches == {"minsum_cn_scan": T, "minsum_vn_update": T},
          f"min-sum trace launches {launches}")
    llr = llr_from_channel(y, snr_to_n0(1.6, 0.5))
    bp_d = trace_soft_decoder(code_c, llr, truth, 20, "bp", device=device)
    bp_c = trace_soft_decoder(code_c, llr, truth, 20, "bp", device="cpu")
    for a, b in zip(bp_d.decisions, bp_c.decisions):
        check(np.array_equal(a, b), "msg_trace BP decisions: card != CPU")
    for a, b in zip(bp_d.v2c_sign_errors, bp_c.v2c_sign_errors):
        check(np.array_equal(a, b), "msg_trace BP sign errors: card != CPU")
    step_d, step_c = bp_step(code_d), bp_step(code_c)
    y_c = llr[:, None]
    v2c = y_c.repeat_interleave(code_c.dv_max, dim=0)
    worst = 0.0
    for _ in range(20):
        got, _ = step_d(v2c.to(device), y_c.to(device))
        v2c, _ = step_c(v2c, y_c)
        diff = (got.cpu() - v2c).abs()
        check(bool((diff <= BP_ATOL + BP_RTOL * v2c.abs()).all()),
              f"BP messages: card vs CPU by {float(diff.max())}")
        worst = max(worst, float(diff.max()))
    print(f"  msg_trace: min-sum T={T} card == CPU ({launches}; sign errors "
          f"{[int(e.sum()) for e in ms_d.v2c_sign_errors]}), BP T=20 "
          f"decisions and sign errors equal, messages within "
          f"{BP_ATOL:g} + {BP_RTOL:g}·|x| (max |diff| {worst:.3g})")
    # B1 at B=1 (msg_trace's shape)
    plan = minsum_plan(code_c, device)
    gen = torch.Generator(device=device).manual_seed(36)
    v = tied_messages(gen, code_c.n * code_c.dv_max, 1, torch.float32,
                      device)
    named = torch.unique(plan.cn_rows[plan.cn_rows >= 0]).long()
    got = minsum_cn_scan(v, plan.cn_rows)[named]
    want = minsum_cn_scan_plain(v, plan.cn_rows)[named]
    check(same_bits(got, want), "B1 at B=1: kernel != plain")
    ms = time_small_ms(lambda: minsum_cn_scan(v, plan.cn_rows))
    plain_ms = timer(lambda: minsum_cn_scan_plain(v, plan.cn_rows), 5)
    nbytes = named.numel() * (4 + 4) + plan.cn_rows.numel() * 4
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = named.numel() * 6 / F32_OPS_PER_S * 1e3
    b1 = dict(shape=[int(plan.cn_rows.numel()), 1], ms=ms, plain_ms=plain_ms,
              max_abs_err=float((got - want).abs().max()),
              bound_ms=max(mem_ms, ops_ms),
              bound_by="bytes" if mem_ms >= ops_ms else "operations",
              share=max(mem_ms, ops_ms) / ms)
    print(f"  B1 at B=1 (peg_1008_504): equal to its twin; {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms; bound {b1['bound_ms']:.2e} ms "
          f"({b1['bound_by']}, share {b1['share']:.2%})")
    build.LAUNCHES.clear()
    report = {}
    for only in ("flagship", "SM-NGDBF T<=100 @3.5dB (working pt), QC, "
                 "batched"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = perf_report.main(["--only", only, "--repeats", "1"])
        rows = [r for r in buf.getvalue().splitlines() if r.startswith("| ")
                and not r.startswith("| configuration")]
        check(rc == 0 and len(rows) == 1, f"perf_report --only {only!r}")
        report[only] = rows[0]
        print(f"  perf_report: {rows[0]}")
    report_launches = dict(build.LAUNCHES)
    check(report_launches.get("minsum_cn_scan", 0) > 0 and report_launches.get(
        "gauss_philox", 0) > 0, f"perf_report launches {report_launches}")
    print(f"  beside this run's simulate rates: QC min-sum [5] "
          f"{rates['minsum']:.6g}, SMNGDBF [10] {rates['smngdbf']:.6g} "
          f"decoded info bits/s (perf_report counts no host copy per call); "
          f"perf_report launches {report_launches}")
    return dict(msg_trace_launches=launches, bp_max_abs_diff=worst, b1=b1,
                perf_report=report, perf_report_launches=report_launches)


# The multi-device engine [37]-[39] (``parallel/``).  [37]'s grid: an
# SMNGDBF cut of the reference's MNGDBF grid script
# (``mngdbf_example_PEGReg504x1008.sh:31-59``: its SNRs 3.0 and 3.25, T=100,
# two values of its lambda sweep), the other parameters [10]'s working
# point (the script's alpha of 2.x diverges for SMNGDBF).  The JAX package's
# ``simulate_grid`` at 3.0 dB, lambda 0.99 (its CPU run on 8 slots, 16384
# frames, seed 0, ``python -m tests.jax_reference_stats grid_smngdbf``):
# (value, standard error).
GRID_SNRS = (3.0, 3.25)
GRID_LAMS = (0.99, 0.995)
GRID_T = 100
GRID_SLOTS = 4
JAX_GRID = dict(
    ber=(0.009218609522259424, 0.00011472989486894838),
    fer=(0.3861083984375, 0.0038035620054165525),
    avg_iterations=(76.4844970703125, 0.19655686752843374),
)
# [39]'s frames per slot and a mesh stream's lanes per slot: the full
# width, as [5] and [28] (the NB route takes NB_BATCH)
DIST_BATCH = BATCH
# frames per reference batch decode of a mesh stream's windows
MESH_REF_CHUNK = BATCH
# [38]: two ranks on one card, one snr slot each
CLUSTER_RANKS = 2
CLUSTER_TIMEOUT_S = 600


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def totals_of(s) -> tuple:
    """A run's integer totals and histograms (trailing empty iteration
    bins dropped: ``simulate`` grows its histogram, the grid's is T+1)."""
    return (s.total_words, s.errors, s.word_errors, s.total_iterations,
            s.satisfied_words, s.uncoded_errors,
            tuple(s.error_weight_hist.tolist()),
            tuple(np.trim_zeros(s.iteration_hist, "b").tolist()),
            s.extra.get("smoothing_used"))


def f32(v) -> float:
    return float(np.float32(v))


def phase_grid(qc, device, rate5):
    """[37] The grid engine on the card: ``init_distributed`` (NCCL, a
    group of one on cuda:0), ``simulate_distributed`` on the default mesh's
    one slot at [5]'s point (its totals must be [5]'s: the same frames),
    then ``simulate_grid`` on a 4-slot mesh that repeats cuda:0 over the
    SMNGDBF grid, each point equal to ``simulate`` over its frames and the
    3.0 dB, lambda 0.99 point within 4 joint s.e. of the JAX grid's."""
    import dataclasses

    import torch.distributed as dist

    from ldpcsimulation_tpu_torch.channel import saturate, snr_to_sigma
    from ldpcsimulation_tpu_torch.decoders import (
        decode_gdbf,
        decode_minsum_qc,
        preset,
    )
    from ldpcsimulation_tpu_torch.harness import StopRule, simulate
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
    )
    from ldpcsimulation_tpu_torch.parallel.montecarlo import (
        simulate_distributed,
        simulate_grid,
    )

    torch.cuda.set_device(device)
    init_distributed(backend="nccl",
                     init_method=f"tcp://localhost:{free_port()}", rank=0,
                     world_size=1)
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
          and float(probe) == 1.0, "an NCCL group of one on cuda:0")
    code = qc.to_code(device)
    k = qc.n - qc.m
    mesh = make_mesh()
    check(mesh.slots == ((0, device),), f"default mesh {mesh.slots}")

    def one_slot(frames):
        return simulate_distributed(
            code, lambda y, sigma, key: decode_minsum_qc(
                qc, y, T, storage_dtype=torch.float16),
            [SNR_DB], mesh, stop=StopRule.fixed_frames(frames),
            batch_per_device=BATCH, max_iterations=T, seed=SEED)[0]

    one_slot(BATCH)  # warm-up round, as [5] warms up
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    build.PATHS.clear()
    st = one_slot(4 * BATCH)
    torch.cuda.synchronize()
    single = dict(build.LAUNCHES)
    rate1 = st.total_words * k / st.wall_seconds
    print(f"  one slot: BER {st.ber!r} over {st.total_words} frames in "
          f"{st.wall_seconds:.4f} s: {rate1:.6g} decoded info bits/s "
          f"([5]'s simulate: {rate5:.6g}); launches {single}")
    check(single == {"minsum_cn_scan": 4 * T, "minsum_vn_update": 4 * T,
                     "awgn_philox": 4, "parity_check": 4},
          f"single-slot launches {single}")
    check_totals("minsum", st)

    cfg0 = preset("SMNGDBF", GRID_T, **GDBF_KW)
    points = [{"snr": s, "lam": lam} for s in GRID_SNRS for lam in GRID_LAMS]
    gmesh = make_mesh(n_snr=GRID_SLOTS, devices=[device] * GRID_SLOTS)
    steps = []

    def gdec(y, sigma, key, point):
        res = decode_gdbf(code, y, sigma,
                          dataclasses.replace(cfg0, lam=point["lam"]),
                          key=key, qc=qc)
        steps.append(res.steps)
        return res

    build.LAUNCHES.clear()
    build.PATHS.clear()
    stats = simulate_grid(
        code, gdec, points, gmesh, max_iterations=GRID_T,
        stop=StopRule.fixed_frames(2 * BATCH), batch_per_device=BATCH,
        seed=SEED, preprocess=lambda y, point: saturate(y, GDBF_YMAX),
        param_names=("lam",))
    torch.cuda.synchronize()
    grid = dict(build.LAUNCHES)
    grid_s = stats[0].wall_seconds
    frames = sum(s.total_words for s in stats)
    rounds = frames // (GRID_SLOTS * BATCH)
    print(f"  grid: {len(points)} points on {GRID_SLOTS} slots of {device}, "
          f"{rounds} rounds, {frames} frames in {grid_s:.4f} s "
          f"({1e3 * grid_s / rounds:.1f} ms per round): "
          f"{frames * k / grid_s:.6g} decoded info bits/s; steps {steps}; "
          f"launches {grid}")
    check(rounds == 2 and grid == {"awgn_philox": 8,
                                   "gauss_philox": sum(steps),
                                   "parity_check": sum(steps),
                                   "gdbf_parallel_step": sum(steps),
                                   "gdbf_lanes": sum(steps)},
          f"grid launches {grid}, steps {steps}")
    ref_s = 0.0
    for p, s in zip(points, stats):
        sigma = f32(snr_to_sigma(p["snr"], code.rate))
        cfg = dataclasses.replace(cfg0, lam=f32(p["lam"]))
        ref = simulate(
            code, lambda yq, key: decode_gdbf(code, yq, sigma, cfg, key=key,
                                              qc=qc),
            p["snr"], stop=StopRule.fixed_frames(2 * BATCH),
            batch_size=BATCH, seed=SEED, device=device,
            preprocess=lambda y: saturate(y, GDBF_YMAX))
        ref_s += ref.wall_seconds
        print(f"  {p}: BER {s.ber!r} FER {s.fer!r} avg iterations "
              f"{s.avg_iterations!r}; simulate over the same frames "
              f"{ref.wall_seconds:.4f} s")
        check(totals_of(s) == totals_of(ref),
              f"grid point {p} != simulate over its frames")
    print(f"  the same points through simulate, one after another: "
          f"{ref_s:.4f} s, {frames * k / ref_s:.6g} decoded info bits/s")
    gate(f"grid {points[0]}", mc_moments(stats[0], qc.n), JAX_GRID)
    dist.destroy_process_group()
    return dict(single=dict(rate=rate1, rate_simulate_5=rate5,
                            seconds=st.wall_seconds, launches=single),
                grid=dict(points=len(points), slots=GRID_SLOTS,
                          rounds=rounds, frames=frames, seconds=grid_s,
                          ms_per_round=1e3 * grid_s / rounds,
                          rate=frames * k / grid_s,
                          simulate_seconds=ref_s,
                          simulate_rate=frames * k / ref_s,
                          launches=grid,
                          ber=stats[0].ber, fer=stats[0].fer,
                          avg_iterations=stats[0].avg_iterations))


def cluster_cases(device) -> dict:
    """[38]'s work on a 2-slot mesh of ``device`` (one slot per rank in a
    two-rank group): two rounds of the grid step (normalized QC min-sum,
    2.0 and 2.5 dB, alpha 1 and 1.25, B=32768 per slot) and a 2-slot
    ``simulate_stream``.  JSON-ready results and the launches."""
    from ldpcsimulation_tpu_torch.channel import snr_to_sigma
    from ldpcsimulation_tpu_torch.codes import load_named_qc
    from ldpcsimulation_tpu_torch.decoders import decode_minsum_qc
    from ldpcsimulation_tpu_torch.harness import StopRule
    from ldpcsimulation_tpu_torch.harness.stream import (
        minsum_qc_stream,
        simulate_stream,
    )
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.parallel.mesh import (
        make_grid_step,
        make_mesh,
    )

    qc = load_named_qc(CODE)
    code = qc.to_code(device)
    rate = (qc.n - qc.m) / qc.n
    build.LAUNCHES.clear()
    step = make_grid_step(
        code, lambda y, sigma, key, p: decode_minsum_qc(
            qc, y, T, variant="normalized", alpha=p["alpha"],
            storage_dtype=torch.float16),
        make_mesh(n_snr=CLUSTER_RANKS, devices=[device] * CLUSTER_RANKS),
        batch_per_device=BATCH, max_iterations=T, param_names=("alpha",))
    out = {}
    for r in range(2):
        got = step(SEED, [snr_to_sigma(s, rate) for s in (2.0, 2.5)],
                   {"alpha": [1.0, 1.25]}, [r * BATCH] * CLUSTER_RANKS)
        out[f"round {r}"] = {k: v.tolist() for k, v in got.items()}
    st = simulate_stream(
        qc.n, minsum_qc_stream(qc, storage_dtype=torch.float16), SNR_DB,
        rate, T, stop=StopRule.fixed_frames(4 * 4096), lanes=2 * 4096,
        refill_every=2, rounds_per_call=16, pool_frames=4 * 8192, seed=SEED,
        mesh=make_mesh(n_snr=1, devices=[device] * CLUSTER_RANKS))
    out["stream"] = [st.total_words, st.errors, st.word_errors,
                     st.total_iterations, st.uncoded_errors,
                     st.iteration_hist.tolist()]
    if device.type == "cuda":
        torch.cuda.synchronize()
    return dict(results=out, launches=dict(build.LAUNCHES))


def cluster_worker(port: int, rank: int, out_path: str, device: str) -> int:
    """One rank of [38]: join the gloo group of CLUSTER_RANKS processes,
    run :func:`cluster_cases` on ``device`` and write its results."""
    import datetime

    import torch.distributed as dist

    from ldpcsimulation_tpu_torch.parallel.mesh import init_distributed

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_distributed(backend="gloo", init_method=f"tcp://localhost:{port}",
                     rank=rank, world_size=CLUSTER_RANKS,
                     timeout=datetime.timedelta(seconds=CLUSTER_TIMEOUT_S))
    check(dist.get_backend() == "gloo"
          and dist.get_world_size() == CLUSTER_RANKS, "the gloo group")
    got = cluster_cases(device)
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump(got, f)
    dist.destroy_process_group()
    return 0


def phase_cluster(device):
    """[38] Two processes, each a rank of one gloo group (NCCL refuses two
    ranks on one card; the backend is given, never switched), both driving
    cuda:0 with one slot each: every rank's all-reduced counters must equal
    this process running the same 2-slot mesh alone."""
    import torch.distributed as dist

    from ldpcsimulation_tpu_torch.kernels import build

    check(not dist.is_initialized(), "no group in the parent")
    port = free_port()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        out = f"{tmp}/cluster.json"
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--cluster-worker", str(port),
             str(rank), out, str(device)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for rank in range(CLUSTER_RANKS)]
        try:
            logs = [p.communicate(timeout=CLUSTER_TIMEOUT_S)[0].decode()
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}")
        ranks = []
        for rank in range(CLUSTER_RANKS):
            with open(f"{out}.{rank}") as f:
                ranks.append(json.load(f))
    secs = time.perf_counter() - t0
    local = json.loads(json.dumps(cluster_cases(device)))
    for rank, got in enumerate(ranks):
        check(got["results"] == local["results"],
              f"rank {rank}'s counters != the single-process run")
    errs = [local["results"][f"round {r}"]["errors"] for r in range(2)]
    print(f"  {CLUSTER_RANKS} gloo ranks on {device} in {secs:.1f} s "
          f"(process start included): counters equal to one process's, "
          f"bit errors by round and slot {errs}, stream "
          f"{local['results']['stream'][:4]}; launches per rank "
          f"{[r['launches'] for r in ranks]}, one process "
          f"{local['launches']}")
    check(all(min(e) > 0 for e in errs), "the cluster's points saw errors")
    return dict(seconds=secs, launches=[r["launches"] for r in ranks],
                single_process_launches=local["launches"])


def mesh_records(recs, window, local) -> dict:
    """The records of a mesh call's slots as device tensors, valid rows
    only, concatenated; slot di's gids checked to lie in its windows
    ``[w·window + di·local, w·window + (di+1)·local)``."""
    out = {}
    for di, r in enumerate(recs):
        rc = int(r["rc_local"])
        check(bool((((r["gid"][:rc] % window) // local) == di).all()),
              f"slot {di} retired a gid outside its window")
        for key, v in r.items():
            if key != "rc_local":
                out.setdefault(key, []).append(v[:rc])
    return {key: torch.cat(v) for key, v in out.items()}


def drive_mesh_stream(make_call, init, pool_of, mesh, lanes, window,
                      windows, extra=()):
    """A recorded stream over the mesh's data slots: ``windows`` pool
    windows of ``window`` global rows, then the drain.  Returns the
    records (gids checked unique and inside their slot's window) and one
    normal call's host syncs."""
    import warnings

    from ldpcsimulation_tpu_torch.harness.stream import (
        _all_idle,
        fetch,
        mesh_pools,
        mesh_setup,
    )

    nd, _, state = mesh_setup(mesh, lanes, window, False, init)
    call = make_call(mesh)
    local = window // nd
    recs, syncs, base, pools = [], None, 0, None
    for w in range(windows):
        pools = mesh_pools(mesh, base, local, pool_of)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            state, acc, rec = call(state, *pools, base, *extra)
            torch.cuda.set_sync_debug_mode("default")
        if w == 1:  # the second call: lanes full, a normal call
            syncs = [c for c in caught
                     if "called a synchronizing" in str(c.message)]
        a = fetch(acc)
        got = mesh_records(rec, window, local)
        check(a["frames"] == got["gid"].numel(), "records vs counters")
        recs.append(got)
        base += window
    for _ in range(100):
        if _all_idle(state):
            break
        state, acc, rec = call(state, *pools, base, *extra, local)
        recs.append(mesh_records(rec, window, local))
    check(_all_idle(state), "the mesh stream drained")
    out = {key: torch.cat([r[key] for r in recs]) for key in recs[0]}
    gid = out["gid"]
    check(gid.numel() == torch.unique(gid).numel(), "a frame retired twice")
    return out, [str(c.message) for c in syncs]


def phase_distributed_sweep(qc, device):
    """[39] ``sweep --distributed`` on the card: min-sum (qc_1008_504, two
    SNRs, the slot-array decoder), SMNGDBF (two lambdas) and its
    uniform-noise form, NGDBFhw (highrate_2048_384, its itdist file) and
    nbqspa (GF(8) nb_regular(6000, 4000, 3), one SNR), each row equal to
    the port's ``simulate`` over the same frames with the route's decode
    (f32 point scalars), the ``--resume`` keys the JAX CLI writes; then
    ``simulate_stream`` and the GDBF stream (SMNGDBF and StochasticNGDBF)
    with ``mesh=`` on 2 slots of cuda:0: every retired frame equal to its
    batch decode on the card, no host sync in a normal call."""
    from ldpcsimulation_tpu_torch.channel import (
        saturate,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.codes import load_named_code
    from ldpcsimulation_tpu_torch.decoders import (
        decode_gdbf,
        decode_minsum,
        decode_minsum_qc,
        preset,
    )
    from ldpcsimulation_tpu_torch.decoders.base import NoiseKey
    from ldpcsimulation_tpu_torch.decoders.ngdbf_hw import (
        NGDBFHwConfig,
        decode_ngdbf_hw,
    )
    from ldpcsimulation_tpu_torch.harness import (
        StopRule,
        fmt,
        gdbf_log_row,
        minsum_log_row,
        ngdbfhw_log_row,
        simulate,
        simulate_nb,
    )
    from ldpcsimulation_tpu_torch.harness import stream
    from ldpcsimulation_tpu_torch.harness import stream_gdbf as sg
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.parallel.mesh import make_mesh
    from ldpcsimulation_tpu_torch.tools.sweep import (
        _grid_key,
        _parse_snr,
        build_parser,
    )
    from ldpcsimulation_tpu_torch.tools.sweep import main as sweep_main

    code = qc.to_code(device)
    hw_code = load_named_code(HW_CODE, device)
    nb = nb_code(device)
    b = DIST_BATCH
    sm = dict(theta=f32(-0.9), noise_scale=f32(0.975), alpha=f32(0.75),
              window_size=64)
    hw_cfg = NGDBFHwConfig(num_iterations=GRID_T, w=f32(0.185),
                           ymax=f32(1.625), noise_scale=f32(0.95),
                           theta0=f32(-0.525), ring_len=2648)
    nb_spec = ":".join(map(str, NB_CODE))

    def sim(snr, dec, stop, c=code, pre=None):
        return simulate(c, dec, snr, stop=stop, batch_size=b, seed=0,
                        preprocess=pre, device=device)

    def gdbf_want(snr, lam, uniform):
        cfg = preset("SMNGDBF", GRID_T, lam=f32(lam), uniform_noise=uniform,
                     **sm)
        sigma = f32(snr_to_sigma(snr, code.rate))
        st = sim(snr, lambda yq, key: decode_gdbf(code, yq, sigma, cfg,
                                                  key=key, qc=qc),
                 StopRule(200, 20, b), pre=lambda y: saturate(y, f32(2.5)))
        return gdbf_log_row(snr, st, GRID_T, -0.9, CODE, noise_scale=0.975,
                            lam=lam, alpha=0.75,
                            smoothing_used=int(st.extra["smoothing_used"]),
                            window_size=64, ymax=2.5)

    def hw_want(snr):
        sigma = f32(snr_to_sigma(snr, hw_code.rate))
        st = sim(snr, lambda y, key: decode_ngdbf_hw(hw_code, y, sigma,
                                                     hw_cfg, key=key),
                 StopRule.fixed_frames(b), c=hw_code)
        return ngdbfhw_log_row(snr, st, GRID_T, -0.525, 0.95, 0.185, 1.625,
                               5, 1, 0)

    def nb_want(snr):
        st = simulate_nb(nb, snr, NB_T, stop=StopRule(200, 20, 2 * NB_BATCH),
                         batch_size=NB_BATCH, seed=0, early_termination=True,
                         storage_dtype=torch.float16, device=device)
        return "\t".join(fmt(v) for v in (snr, st.ser, st.ber,
                                          st.avg_iterations, st.fer, NB_T)
                         ) + f"\tnb_random_{nb_spec}"

    gdbf_args = ["gdbf", "--preset", "SMNGDBF", "--code", CODE, "--snr",
                 "3.25", "-T", str(GRID_T), "--theta", "-0.9",
                 "--noise-scale", "0.975", "--alpha", "0.75", "--window",
                 "64", "--ymax", "2.5", "--batch", str(b), "--max-frames",
                 str(b)]
    runs = (
        ("minsum", ["minsum", "--code", CODE, "--snr", "2.0,2.5", "-T",
                    str(T), "--msg-dtype", "f16", "--batch", str(b),
                    "--max-frames", str(2 * b)],
         [minsum_log_row(snr, sim(snr, lambda y, key: decode_minsum(
             code, y, T, storage_dtype=torch.float16),
             StopRule(200, 20, 2 * b)), T, CODE) for snr in (2.0, 2.5)],
         "minsum_cn_scan"),
        ("gdbf", gdbf_args + ["--lam", "0.988", "0.99"],
         [gdbf_want(3.25, lam, False) for lam in (0.988, 0.99)],
         "gauss_philox"),
        ("gdbf --uniform-noise", gdbf_args + ["--lam", "0.988",
                                              "--uniform-noise"],
         [gdbf_want(3.25, 0.988, True)], "uniform_philox"),
        ("ngdbfhw", ["ngdbfhw", "--code", HW_CODE, "--snr", str(HW_SNR_DB),
                     "-T", str(GRID_T), "--frames", str(b), "--batch",
                     str(b)], [hw_want(HW_SNR_DB)], "gauss_philox"),
        ("nbqspa", ["nbqspa", "--nb-random", nb_spec, "--snr",
                    str(NB_SNR_DB), "-T", str(NB_T), "--early-termination",
                    "--msg-dtype", "f16", "--batch", str(NB_BATCH),
                    "--max-frames", str(2 * NB_BATCH)],
         [nb_want(NB_SNR_DB)], "awgn_philox"),
    )
    launched = {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        for i, (label, args, want, kernel) in enumerate(runs):
            log_path = f"{tmp}/d{i}.log"
            build.LAUNCHES.clear()
            t0 = time.perf_counter()
            rc = sweep_main(args + ["--device", str(device), "--log",
                                    log_path, "--distributed", "--resume"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = dict(build.LAUNCHES)
            with open(log_path) as f:
                rows = f.read().splitlines()
            print(f"  {label}: {len(rows)} rows in {secs:.2f} s, widths "
                  f"{[len(r.split(chr(9))) for r in rows]}; launches "
                  f"{launches}")
            for row in rows:
                print(f"    {row}")
            check(rc == 0 and rows == want,
                  f"{label} rows != simulate over their frames: {want}")
            check(launches.get(kernel, 0) > 0, f"{label}: {kernel} not "
                  f"launched ({launches})")
            if label == "nbqspa":
                check(not os.path.exists(log_path + ".done"),
                      "the JAX CLI's nbqspa route writes no sidecar")
            else:
                # the keys of the JAX CLI's sidecar: one per grid point
                ns = build_parser().parse_args(args + ["--log", log_path])
                want_keys = [_grid_key(pt) for pt in itertools.product(
                    _parse_snr(ns.snr), ns.ymax, ns.nq, ns.alpha, ns.delta,
                    ns.theta, ns.noise_scale, ns.lam, ns.w, ns.theta0)]
                with open(log_path + ".done") as f:
                    keys = f.read().splitlines()
                check(keys == want_keys, f"{label} resume keys {keys}")
            if label == "ngdbfhw":
                check(os.path.exists(f"{log_path}_{HW_SNR_DB:g}_itdist.dat"),
                      "the ngdbfhw itdist file")
            for key, v in launches.items():
                launched[f"{key} {label}"] = v

        # streams over a 2-slot mesh of the card
        mesh = make_mesh(n_snr=1, devices=[device] * 2)
        sigma = snr_to_sigma(SNR_DB, code.rate)
        dec = stream.minsum_qc_stream(qc, storage_dtype=torch.float16)
        lanes = 2 * DIST_BATCH  # DIST_BATCH per slot
        window = 2 * lanes
        build.LAUNCHES.clear()
        recs, syncs = drive_mesh_stream(
            lambda m: stream.make_stream_call(
                dec, qc.n, T, 16, 2, record=True, rec_cap=window, mesh=m),
            lambda n_lanes, dev: stream.stream_init(
                dec, n_lanes, qc.n, device=dev),
            lambda base, frames, dev: stream.build_channel_pool(
                dec, SEED, base, frames, qc.n, sigma, device=dev),
            mesh, lanes, window, 2)
        s_launches = dict(build.LAUNCHES)
        g = recs["gid"]
        for f0 in range(0, 2 * window, MESH_REF_CHUNK):
            y = stream.build_channel_pool(dec, SEED, f0, MESH_REF_CHUNK,
                                          qc.n, sigma, device=device)[0]
            res = decode_minsum_qc(qc, y, T, early_termination=True,
                                   storage_dtype=torch.float16)
            at = ((g >= f0) & (g < f0 + MESH_REF_CHUNK)).nonzero()[:, 0]
            gl = g[at] - f0
            hard = res.hard[gl].to(torch.int8)
            check(torch.equal(recs["iters"][at],
                              res.iterations[gl].to(torch.int32))
                  and torch.equal(recs["hard"][at], hard)
                  and torch.equal(recs["errs"][at],
                                  (hard != 1).sum(dim=1).to(torch.int32)),
                  f"mesh stream frames {f0}+ != their batch decode")
        local = window // 2
        check(bool((((g % window) // local).unique().numel() == 2)),
              "both slots retired frames")
        print(f"  simulate_stream mesh: 2 slots x {lanes // 2} lanes, "
              f"{g.numel()} retired frames equal to the batch decode; host "
              f"syncs in a normal call: {len(syncs)}; launches {s_launches}")
        for w in syncs:
            print(f"    host sync: {w}")
        check(not syncs, "a normal mesh call synced with the host")

        # the GDBF stream: SMNGDBF (B4's per-lane entry) and
        # StochasticNGDBF (B3's)
        glanes = 2 * DIST_BATCH  # DIST_BATCH per slot
        gwindow = 2 * glanes
        g_launches, g_frames = {}, {}
        for name, snr, lane_kernel in (
                ("SMNGDBF", GDBF_SNR_DB, "gauss_philox_lanes"),
                ("StochasticNGDBF", 3.0, "uniform_philox_lanes")):
            cfg = preset(name, GRID_T, **(
                GDBF_KW if name == "SMNGDBF" else
                dict(theta=-0.9, noise_scale=0.975, alpha=0.75)))
            gsigma = snr_to_sigma(snr, code.rate)

            def gpool(base, frames, dev, gsigma=gsigma):
                return sg.build_channel_pool_gdbf(
                    code, SEED, base, frames, gsigma,
                    lambda y: saturate(y, GDBF_YMAX), qc=qc, device=dev)

            build.LAUNCHES.clear()
            grecs, gsyncs = drive_mesh_stream(
                lambda m: sg.make_gdbf_stream_call(
                    code, 16, STREAM_GDBF_K, qc=qc, record=True,
                    rec_cap=gwindow, mesh=m),
                lambda n_lanes, dev, cfg=cfg: sg.gdbf_stream_init(
                    code, cfg, n_lanes, device=dev),
                gpool, mesh, glanes, gwindow, 2, extra=(SEED, gsigma, cfg))
            launches = dict(build.LAUNCHES)
            g = grecs["gid"]
            for f0 in range(0, 2 * gwindow, MESH_REF_CHUNK):
                rows = gpool(f0, MESH_REF_CHUNK, device)[0]
                gres = decode_gdbf(code, rows, gsigma, cfg,
                                   key=NoiseKey(SEED, f0), qc=qc)
                at = ((g >= f0) & (g < f0 + MESH_REF_CHUNK)).nonzero()[:, 0]
                gl = g[at] - f0
                check(torch.equal(grecs["iters"][at],
                                  gres.iterations[gl].to(torch.int32))
                      and torch.equal(grecs["hard"][at],
                                      gres.hard[gl].to(torch.int8))
                      and torch.equal(grecs["sat"][at], gres.satisfied[gl]),
                      f"{name} mesh stream frames {f0}+ != their batch "
                      "decode")
            print(f"  simulate_stream_gdbf mesh ({name}, {snr} dB, "
                  f"T={GRID_T}): {g.numel()} retired frames equal to the "
                  f"batch decode; host syncs in a normal call: "
                  f"{len(gsyncs)}; launches {launches}")
            check(launches.get(lane_kernel, 0) > 0 and not gsyncs,
                  f"{name} mesh stream launches {launches}, syncs "
                  f"{gsyncs}")
            for key, v in launches.items():
                g_launches[key] = g_launches.get(key, 0) + v
            g_frames[name] = int(g.numel())
    return dict(sweeps=launched, stream=s_launches, gdbf_stream=g_launches,
                stream_frames=int(recs["gid"].numel()),
                gdbf_stream_frames=g_frames, stream_syncs=len(syncs))


# The dense graph route [40] (ROADMAP C1): the sweep's route for the
# bit-flip decoders on codes without QC structure, against the slot-array
# gathers it replaces there; [41] the public names that close the port.
F16_OPS_PER_S = 989e12
DENSE_GDBF_CODE = PEG_CODE


def op_bounds(ins, out, ops):
    """(memory ms, f16 tensor-core ms) of a function that reads ``ins``
    once, writes ``out`` once and does ``ops`` operations."""
    nbytes = sum(t.numel() * t.element_size() for t in (*ins, out))
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F16_OPS_PER_S * 1e3


def dense_ops_vs_gathers(code, dg, device, timer):
    """The four dense operations against the slot-gather route on random
    decisions at B=32768, under ``torch.equal`` (values and dtypes), each
    timed beside its gather twin with its bounds."""
    from ldpcsimulation_tpu_torch.decoders import dense_ops as do
    from ldpcsimulation_tpu_torch.decoders import qc_ops
    from ldpcsimulation_tpu_torch.decoders.ngdbf_hw import hw_graph_ops

    gen = torch.Generator(device=device).manual_seed(SEED)
    d = torch.where(torch.rand(code.n, BATCH, generator=gen, device=device)
                    < 0.05, -1, 1).to(torch.int32)
    g = qc_ops.slot_graph(code, device)
    syndrome01, satsum = hw_graph_ops(code)
    syn = do.dense_syndrome_bipolar(dg, d)
    synf = syn.float()
    d01 = (d < 0).to(torch.uint8)
    s01 = do.dense_syndrome01(dg, d01)
    cases = {
        "syndrome_bipolar": (lambda: do.dense_syndrome_bipolar(dg, d),
                             lambda: qc_ops.syndrome_bipolar(g, d), d),
        "syndrome_sum_per_vn": (
            lambda: do.dense_syndrome_sum_per_vn(dg, synf),
            lambda: qc_ops.syndrome_sum_per_vn(g, synf), synf),
        "syndrome01": (lambda: do.dense_syndrome01(dg, d01),
                       lambda: syndrome01(d01), d01),
        "sat_sum_per_vn": (lambda: do.dense_sat_sum_per_vn(dg, s01),
                           lambda: satsum(s01), s01),
    }
    out = {}
    for name, (dense, gather, x) in cases.items():
        got, want = dense(), gather()
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"dense {name} != the gathers on {code.n} x {BATCH}")
        mem, tc = op_bounds((x, dg.h), got, 2 * dg.m * dg.n * BATCH)
        ms, gms = timer(dense), timer(gather)
        out[name] = dict(ms=ms, gather_ms=gms, memory_bound_ms=mem,
                         f16_bound_ms=tc, dtype=str(got.dtype))
        print(f"    {name}: dense {ms:.4f} ms, gathers {gms:.4f} ms; bound "
              f"{max(mem, tc):.4f} ms (bytes {mem:.4f}, f16 tensor cores "
              f"{tc:.4f}); {100 * max(mem, tc) / ms:.1f} % of the bound; "
              f"{got.dtype}, equal")
    return out


def timed_decode(fn):
    """(result, ms of device and host time) of one call, synchronized."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end)


def dense_hw_stream(code, dg, cfg, hint, device):
    """``simulate_stream_ngdbfhw`` with ``dense=`` at [31]'s full width
    (BATCH lanes, 4·BATCH frames): gated on the JAX point, its totals and
    histograms equal to the generic stream's over the same frames (the same
    gids, rings and iterations); each run's launches read on their own."""
    from ldpcsimulation_tpu_torch.harness import StopRule
    from ldpcsimulation_tpu_torch.harness import stream_ngdbfhw as sh
    from ldpcsimulation_tpu_torch.kernels import build

    runs, launches = {}, {}
    for route, dense in (("dense", dg), ("generic", None)):
        torch.cuda.synchronize()
        build.LAUNCHES.clear()
        runs[route] = sh.simulate_stream_ngdbfhw(
            code, cfg, HW_SNR_DB, stop=StopRule.fixed_frames(4 * BATCH),
            lanes=BATCH, refill_every=HW_STREAM_K, avg_iters_hint=hint,
            seed=SEED, dense=dense, device=device)
        torch.cuda.synchronize()
        launches[route] = dict(build.LAUNCHES)
    d, g = runs["dense"], runs["generic"]
    label = (f"simulate_stream_ngdbfhw dense {HW_CODE} {HW_SNR_DB} dB "
             f"T={HW_T}, {BATCH} lanes")
    check(launches["dense"].get("awgn_philox", 0) >= 1
          and launches["dense"].get("gauss_philox_lanes", 0) >= 1
          and "gauss_philox" not in launches["dense"],
          f"{label}: launches {launches['dense']}")
    same = ((d.total_words, d.errors, d.word_errors, d.total_iterations,
             d.satisfied_words, d.extra["steps"])
            == (g.total_words, g.errors, g.word_errors, g.total_iterations,
                g.satisfied_words, g.extra["steps"])
            and np.array_equal(d.iteration_hist, g.iteration_hist)
            and np.array_equal(d.error_weight_hist, g.error_weight_hist))
    check(same, f"{label}: totals differ from the generic stream's")
    rate = {r: s.total_words * code.k / s.wall_seconds
            for r, s in runs.items()}
    print(f"  {label}: {d.total_words} frames, BER {d.ber!r} FER {d.fer!r} "
          f"avg iterations {d.avg_iterations!r}, {d.extra['steps']} stream "
          f"steps; totals and histograms equal to the generic stream's; "
          f"{d.wall_seconds:.4f} s dense ({rate['dense']:.6g} decoded info "
          f"bits/s), {g.wall_seconds:.4f} s generic ({rate['generic']:.6g});"
          f" launches {launches['dense']}")
    gate(label, mc_moments(d, code.n), JAX_POINTS["ngdbfhw_highrate"])
    return dict(frames=d.total_words, steps=d.extra["steps"],
                seconds={r: s.wall_seconds for r, s in runs.items()},
                decoded_info_bits_per_s=rate, launches=launches["dense"])


def dense_gdbf_stream(code, dg, cfg, sigma, device):
    """``simulate_stream_gdbf`` SMNGDBF with ``dense=`` at full width
    (BATCH lanes, 2·BATCH frames) on a code without QC structure, its
    integer totals equal to the dense batch decoder's over the same gids;
    its launches read on their own."""
    from ldpcsimulation_tpu_torch.channel import saturate
    from ldpcsimulation_tpu_torch.decoders import decode_gdbf
    from ldpcsimulation_tpu_torch.harness import StopRule, simulate
    from ldpcsimulation_tpu_torch.harness import stream_gdbf as sg
    from ldpcsimulation_tpu_torch.kernels import build

    sat = lambda y: saturate(y, GDBF_YMAX)  # noqa: E731
    label = (f"simulate_stream_gdbf SMNGDBF dense {DENSE_GDBF_CODE} "
             f"{GDBF_SNR_DB} dB T={GDBF_T}, {BATCH} lanes")
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    s = sg.simulate_stream_gdbf(
        code, cfg, GDBF_SNR_DB, stop=StopRule.fixed_frames(2 * BATCH),
        lanes=BATCH, refill_every=STREAM_GDBF_K, seed=SEED, preprocess=sat,
        dense=dg, device=device)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    check(launches.get("awgn_philox", 0) >= 1
          and launches.get("gauss_philox_lanes", 0) >= 1,
          f"{label}: launches {launches}")
    b = simulate(code, lambda yq, key: decode_gdbf(code, yq, sigma, cfg,
                                                   key=key, dense=dg),
                 GDBF_SNR_DB, stop=StopRule.fixed_frames(s.total_words),
                 batch_size=BATCH, seed=SEED, preprocess=sat, device=device)
    totals = [(r.total_words, r.errors, r.word_errors, r.total_iterations,
               r.satisfied_words) for r in (s, b)]
    check(totals[0] == totals[1], f"{label}: stream != batch {totals}")
    rate = s.total_words * code.k / s.wall_seconds
    print(f"  {label}: {s.total_words} frames, FER {s.fer!r} avg iterations "
          f"{s.avg_iterations!r}; (frames, bit errors, word errors, "
          f"iterations, satisfied) {totals[0]}, the dense batch decoder's "
          f"over the same gids; {s.wall_seconds:.4f} s ({rate:.6g} decoded "
          f"info bits/s, drain included); launches {launches}")
    return dict(frames=s.total_words, seconds=s.wall_seconds,
                decoded_info_bits_per_s=rate, launches=launches)


def phase_dense(device, timer):
    """[40] The dense graph route on the card: its four operations against
    the gathers (highrate_2048_384 and peg_1008_504, B=32768); NGDBFhw at
    T=600 and SMNGDBF decodes, dense against generic under ``torch.equal``,
    with ms per step of both; the NGDBFhw stream with ``dense=`` equal to
    its batch decode; the sweep's ngdbfhw route on highrate_2048_384
    building a DenseGraph, its rows the generic route's; slot-array min-sum
    T=10 on highrate_2048_384 against its memory bound (the stratified
    family's cost reference)."""
    from ldpcsimulation_tpu_torch.channel import saturate, snr_to_sigma
    from ldpcsimulation_tpu_torch.channel.awgn import awgn_all_zero
    from ldpcsimulation_tpu_torch.codes import load_named_code
    from ldpcsimulation_tpu_torch.decoders import (
        NGDBFHwConfig,
        NoiseKey,
        decode_gdbf,
        decode_minsum,
        decode_ngdbf_hw,
        preset,
    )
    from ldpcsimulation_tpu_torch.decoders.dense_ops import DenseGraph
    from ldpcsimulation_tpu_torch.harness import stream_ngdbfhw as sh
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.tools import sweep

    out = {"ops": {}}
    hw_code = load_named_code(HW_CODE, device)
    peg_code = load_named_code(DENSE_GDBF_CODE, device)
    graphs = {HW_CODE: (hw_code, DenseGraph.from_code(hw_code, device)),
              DENSE_GDBF_CODE: (peg_code,
                                DenseGraph.from_code(peg_code, device))}
    for name, (code, dg) in graphs.items():
        check(dg.h.dtype == torch.float16 and dg.h.is_cuda,
              f"{name}: dense H {dg.h.dtype} on {dg.h.device}")
        print(f"  {name} [{dg.m} x {dg.n}] {dg.h.dtype}, B={BATCH}:")
        out["ops"][name] = dense_ops_vs_gathers(code, dg, device, timer)

    # NGDBFhw at [25]'s point, T=600, one batch: dense against generic
    hw_dg = graphs[HW_CODE][1]
    cfg = NGDBFHwConfig(num_iterations=HW_T,
                        ring_len=max(2648, hw_code.n + 600))
    sigma = snr_to_sigma(HW_SNR_DB, hw_code.rate)
    y = awgn_all_zero(SEED, 0, BATCH, hw_code.n, sigma, device)
    key = NoiseKey(SEED, 0)

    def alternated(decode, dense):
        """Two decodes of each route, dense first: {route: [(result, ms
        per step)]}, and the dense decodes' launches, each decode's read
        from a window of its own."""
        runs, dense_launches = {}, {}
        for route, dg in (("dense", dense), ("generic", None),
                          ("dense", dense), ("generic", None)):
            build.LAUNCHES.clear()
            res, ms = timed_decode(lambda: decode(dg))
            launches = dict(build.LAUNCHES)
            check(launches.get("gauss_philox", 0) >= 1,
                  f"{route} decode: launches {launches}")
            if route == "dense":
                for k, v in launches.items():
                    dense_launches[k] = dense_launches.get(k, 0) + v
            runs.setdefault(route, []).append((res, ms / res.steps))
        return runs, dense_launches

    runs, hw_launches = alternated(lambda dg: decode_ngdbf_hw(
        hw_code, y, sigma, cfg, key=key, dense=dg), hw_dg)
    (dres, _), (gres, _) = runs["dense"][0], runs["generic"][0]
    for f in ("hard", "iterations", "satisfied", "least_errors", "qpointer"):
        check(torch.equal(getattr(dres, f), getattr(gres, f)),
              f"NGDBFhw dense {f} != generic")
    # one ring per decode
    check(hw_launches == {"gauss_philox": 2}, f"dense rings {hw_launches}")
    hw_step = {r: [v[1] for v in runs[r]] for r in runs}
    print(f"  decode_ngdbf_hw {HW_CODE} {HW_SNR_DB} dB T={HW_T} B={BATCH}: "
          f"dense equal to generic ({dres.steps} steps, "
          f"{int(dres.satisfied.sum())} satisfied, least errors "
          f"{int(dres.least_errors.sum())}); ms per step dense "
          f"{hw_step['dense']}, generic {hw_step['generic']}; the two dense "
          f"decodes' launches {hw_launches}")
    out["ngdbfhw"] = dict(steps=dres.steps, step_ms=hw_step,
                          launches=hw_launches,
                          least_errors=int(dres.least_errors.sum()))

    # SMNGDBF at [10]'s point on peg_1008_504 (no QC structure)
    peg_dg = graphs[DENSE_GDBF_CODE][1]
    gcfg = preset("SMNGDBF", GDBF_T, **GDBF_KW)
    gsigma = snr_to_sigma(GDBF_SNR_DB, peg_code.rate)
    yq = saturate(awgn_all_zero(SEED, 0, BATCH, peg_code.n, gsigma, device),
                  GDBF_YMAX)
    runs, g_launches = alternated(lambda dg: decode_gdbf(
        peg_code, yq, gsigma, gcfg, key=key, dense=dg), peg_dg)
    (dres, _), (gres, _) = runs["dense"][0], runs["generic"][0]
    for f in ("hard", "iterations", "satisfied", "phases", "smoothing_used"):
        check(torch.equal(getattr(dres, f), getattr(gres, f)),
              f"SMNGDBF dense {f} != generic")
    g_step = {r: [v[1] for v in runs[r]] for r in runs}
    print(f"  decode_gdbf SMNGDBF {DENSE_GDBF_CODE} {GDBF_SNR_DB} dB "
          f"T={GDBF_T} B={BATCH}: dense equal to generic ({dres.steps} "
          f"steps, FER {1 - float(dres.satisfied.float().mean()):.4g}); ms "
          f"per step dense {g_step['dense']}, generic {g_step['generic']}; "
          f"the two dense decodes' launches {g_launches}")
    out["smngdbf"] = dict(steps=dres.steps, step_ms=g_step,
                          launches=g_launches)

    # the NGDBFhw stream on the dense graph: a recorded 2048-lane stream
    # over 4096 frames, every frame equal to the generic batch decode at
    # its ring offset
    hint = JAX_POINTS["ngdbfhw_highrate"]["avg_iterations"][0]
    lanes, frames = 2048, 4096
    build.LAUNCHES.clear()
    call = sh.make_hw_stream_call(
        hw_code, cfg, 16, HW_STREAM_K, dense=hw_dg, record=True,
        rec_cap=frames + lanes,
        refill_cap=sh.default_refill_cap(lanes, HW_STREAM_K, hint))
    state = sh.hw_stream_init(hw_code, cfg, lanes, device, record=True)
    pool = sh.build_channel_pool_hw(hw_code, SEED, 0, frames, sigma,
                                    dense=hw_dg, device=device)
    parts = []
    for ptr0 in (0, *([frames] * (2 + HW_T // (16 * HW_STREAM_K)))):
        if ptr0 and bool(state["idle"].all()):
            break
        state, acc, rec = call(state, *pool, 0, SEED, sigma, ptr0)
        parts.append(records_of(acc, rec, HW_STREAM_FIELDS))
    s_launches = dict(build.LAUNCHES)
    rec = {f: torch.cat([p[f] for p in parts]) for f in HW_STREAM_FIELDS}
    order = torch.argsort(rec["gid"])
    rec = {f: v[order] for f, v in rec.items()}
    check(torch.equal(rec["gid"], torch.arange(frames)),
          f"dense stream: frames {len(rec['gid'])} of {frames}")
    res = decode_ngdbf_hw(hw_code, pool[0], sigma, cfg, key=key,
                          qpointer0=rec["qp0"].to(device))
    for f, v in (("iters", res.iterations), ("errs", res.least_errors),
                 ("sat", res.satisfied), ("hard", res.hard.to(torch.int8))):
        check(torch.equal(rec[f], v.cpu()), f"dense stream {f} != batch")
    print(f"  NGDBFhw stream, dense: {frames} frames of a {lanes}-lane "
          f"stream equal to the generic batch decoder at their ring "
          f"offsets ({len(set(rec['qp0'].tolist()))} offsets); launches "
          f"{s_launches}")
    out["stream"] = dict(frames=frames, lanes=lanes, launches=s_launches)
    out["hw_stream"] = dense_hw_stream(hw_code, hw_dg, cfg, hint, device)
    out["gdbf_stream"] = dense_gdbf_stream(peg_code, peg_dg, gcfg, gsigma,
                                           device)

    # the sweep's ngdbfhw route on highrate_2048_384: it builds a
    # DenseGraph, and its row is the generic route's
    built = []

    class Counted(DenseGraph):
        @classmethod
        def from_code(cls, code, device=None):
            built.append(code.n)
            return super().from_code(code, device)

    args = ["ngdbfhw", "--code", HW_CODE, "--snr", str(HW_SNR_DB), "-T",
            "100", "--frames", str(BATCH), "--batch", str(BATCH),
            "--device", str(device)]
    rows, route_launches = {}, {}
    real_dg, real_worth = sweep.DenseGraph, sweep.dense_worthwhile
    try:
        with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
            for route in ("dense", "generic"):
                sweep.DenseGraph = Counted
                if route == "generic":
                    sweep.dense_worthwhile = lambda code: False
                t0 = time.perf_counter()
                log = f"{tmp}/{route}.log"
                build.LAUNCHES.clear()
                check(sweep.main(args + ["--log", log]) == 0,
                      f"sweep {route}")
                route_launches[route] = dict(build.LAUNCHES)
                secs = time.perf_counter() - t0
                with open(log) as f:
                    rows[route] = (f.read().splitlines(), secs)
                with open(f"{log}_{HW_SNR_DB:g}_itdist.dat") as f:
                    rows[route] += (f.read(),)
    finally:
        sweep.DenseGraph, sweep.dense_worthwhile = real_dg, real_worth
    sweep_launches = route_launches["dense"]
    check(sweep_launches.get("awgn_philox", 0) >= 1
          and sweep_launches.get("gauss_philox", 0) >= 1,
          f"dense sweep launches {sweep_launches}")
    check(built == [hw_code.n], f"sweep built DenseGraphs {built}")
    check(rows["dense"][0] == rows["generic"][0] and len(rows["dense"][0])
          == 1 and rows["dense"][2] == rows["generic"][2],
          f"sweep rows {rows['dense'][0]} != {rows['generic'][0]}")
    print(f"  sweep ngdbfhw --code {HW_CODE} -T 100: a DenseGraph built, "
          f"the row and itdist file the generic route's "
          f"({rows['dense'][1]:.2f} s dense, {rows['generic'][1]:.2f} s "
          f"generic): {rows['dense'][0]}; the dense route's launches "
          f"{sweep_launches}")
    out["sweep"] = dict(row=rows["dense"][0][0],
                        seconds={r: v[1] for r, v in rows.items()},
                        launches=sweep_launches)

    # slot-array min-sum T=10 on highrate_2048_384: the stratified family's
    # cost reference (its gate accepts up to 2x the slot traffic)
    ym = awgn_all_zero(SEED, 0, BATCH, hw_code.n,
                       snr_to_sigma(3.5, hw_code.rate), device)
    ms = timer(lambda: decode_minsum(hw_code, ym, 10,
                                     storage_dtype=torch.float16), 3)
    e = int(hw_code.cn_mask.sum())
    mem = (4 * e * 2 + 8 * hw_code.n) * BATCH * 10 / HBM_BYTES_PER_S * 1e3
    print(f"  decode_minsum {HW_CODE} T=10 f16 B={BATCH}: {ms:.3f} ms, "
          f"{ms / 10:.4f} ms per iteration; memory bound {mem:.3f} ms (4 "
          f"edge passes of f16 messages and 8 bytes per variable); "
          f"{100 * mem / ms:.1f} % of it")
    out["minsum_highrate"] = dict(ms=ms, memory_bound_ms=mem)
    return out


def phase_surface(device):
    """[41] The public names that close the port: the
    ``compare_decoders_torch`` example's five rows at 4096 frames each equal
    to ``simulate`` with the same arguments; ``native.parse_alist_native``
    equal to the Python parser (binary, GF(8), the packaged alist)."""
    import importlib.util
    import pathlib

    from ldpcsimulation_tpu_torch import native
    from ldpcsimulation_tpu_torch.channel import (
        llr_from_channel,
        saturate,
        snr_to_n0,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.codes import (
        code_to_alist,
        dumps_alist,
        load_named_code,
        load_named_qc,
        nb_regular,
        parse_alist,
    )
    from ldpcsimulation_tpu_torch.decoders import (
        decode_bp_layered_qc,
        decode_bp_qc,
        decode_gdbf,
        decode_minsum_layered_qc,
        decode_minsum_qc,
    )
    from ldpcsimulation_tpu_torch.harness import StopRule, simulate
    from ldpcsimulation_tpu_torch.kernels import build

    root = pathlib.Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location(
        "compare_decoders_torch",
        root / "examples" / "compare_decoders_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    snr, frames = 2.5, 4096
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    got = ex.rows(snr, frames, frames, device)
    secs = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    qc = load_named_qc(CODE)
    code = qc.to_code(device)
    n0, sigma = snr_to_n0(snr, code.rate), snr_to_sigma(snr, code.rate)

    def sim(dec, pre=None):
        return simulate(code, dec, snr, stop=StopRule.fixed_frames(frames),
                        batch_size=frames, preprocess=pre, seed=ex.SEED,
                        device=device)

    def llr(y):
        return llr_from_channel(y, n0)

    want = [
        sim(lambda y, k: decode_minsum_qc(qc, y, 10, early_termination=True,
                                          storage_dtype=torch.float16)),
        sim(lambda y, k: decode_minsum_layered_qc(qc, y, 10,
                                                  early_termination=True)),
        sim(lambda x, k: decode_bp_qc(qc, x, 30, early_termination=True),
            llr),
        sim(lambda x, k: decode_bp_layered_qc(qc, x, 30,
                                              early_termination=True), llr),
        sim(lambda yq, k: decode_gdbf(code, yq, sigma, ex.SM_CFG, key=k,
                                      qc=qc), lambda y: saturate(y, 2.5)),
    ]
    rows = {}
    for (name, st), w in zip(got, want):
        t = (st.errors, st.word_errors, st.total_iterations)
        check(st.total_words == w.total_words == frames and t == (
            w.errors, w.word_errors, w.total_iterations),
            f"example row {name}: {t} != simulate's")
        rows[name] = dict(ber=st.ber, fer=st.fer,
                          avg_iterations=st.avg_iterations, totals=t)
        print(f"  {name:26s} {snr:5.2f} dB BER {st.ber:.3e} FER "
              f"{st.fer:.3e} iterations {st.avg_iterations:.2f}: equal to "
              f"simulate")
    print(f"  example: {frames} frames per row in {secs:.2f} s; launches "
          f"{launches}")

    texts = {
        "highrate_2048_384": dumps_alist(code_to_alist(
            load_named_code(HW_CODE))),
        "gf8": dumps_alist(nb_regular(600, 400, 3, q=8, seed=0)),
        "peg_1008_504.alist": (root / "ldpcsimulation_tpu_torch" / "data"
                               / "peg_1008_504.alist").read_text(),
    }
    check(native.available(), "native library unavailable")
    parse = {}
    for name, text in texts.items():
        t0 = time.perf_counter()
        a = native.parse_alist_native(text)
        t1 = time.perf_counter()
        b = parse_alist(text)
        t2 = time.perf_counter()
        check(a == b, f"parse_alist_native {name} != parse_alist")
        parse[name] = dict(native_s=t1 - t0, python_s=t2 - t1)
        print(f"  parse_alist_native {name}: equal to parse_alist "
              f"({t1 - t0:.4f} s against {t2 - t1:.4f} s)")
    return dict(example=rows, example_seconds=secs, launches=launches,
                parse=parse)


# The stratified family [42] (codes/stratified.py): the sweep's BP route for
# an --alist file whose H stratifies, on the 802.3an geometry, against the
# slot arrays; min-sum and DD-BMP on it against the slot arrays the sweep
# keeps for them.
STRAT_GEOMETRY = dict(n=2048, h=64, mb=6, p_edge=1.0, seed=0)
STRAT_SNR_DB = 4.25


def stratified_alist(n, h, mb, p_edge, seed):
    """A non-QC alist with dense row strata: each of ``mb`` strata of ``h``
    rows deals a shuffled round-robin of the columns to its rows, keeping
    each (column, stratum) edge with probability ``p_edge`` (the JAX test
    suite's generator, ``tests/test_stratified.py``).  With p_edge = 1 and
    (2048, 64, 6): the 802.3an geometry, 384 rows, dv 6, dc 32."""
    from ldpcsimulation_tpu_torch.codes import Alist

    rng = np.random.default_rng(seed)
    m = h * mb
    nlist = [[] for _ in range(n)]
    mlist = [[] for _ in range(m)]
    for b in range(mb):
        perm = rng.permutation(n)
        for i, c in enumerate(perm):
            last_chance = not nlist[c] and b == mb - 1
            if rng.random() < p_edge or last_chance:
                r = b * h + (i % h)
                nlist[c].append(r)
                mlist[r].append(c)
    for c in range(n):
        nlist[c].sort()
    for r in range(m):
        mlist[r].sort()
    return Alist(n=n, m=m, nlist=nlist, mlist=mlist)


def stratified_card_vs_cpu(sc, code, device, sigma, rate, frames=256):
    """Min-sum (three variants, f16, early termination) and DD-BMP on the
    card against the CPU plain path and against the card's slot-array
    decoders under ``torch.equal``; BP by tolerance (one step) and frame
    agreement.  Returns B1's launches per min-sum variant."""
    from ldpcsimulation_tpu_torch.channel import (
        awgn_all_zero,
        llr_from_channel,
        quantize_no_zero,
        snr_to_n0,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.decoders import (
        decode_bp,
        decode_bp_stratified,
        decode_ddbmp,
        decode_ddbmp_stratified,
        decode_minsum,
        decode_minsum_stratified,
        stratified_bp_step,
    )
    from ldpcsimulation_tpu_torch.decoders.minsum_stratified import (
        stratified_grid,
        stratified_init,
    )
    from ldpcsimulation_tpu_torch.kernels import build

    def equal_on_card(res, other, what):
        for f in ("hard", "iterations", "satisfied"):
            check(torch.equal(getattr(res, f), getattr(other, f)),
                  f"{what} {f}: stratified != slot-array")

    f16 = torch.float16
    y = awgn_all_zero(SEED, 42 * frames, frames, code.n, sigma, device)
    yc = y.cpu()
    counted = {}
    for label, kw in (("plain", {}),
                      ("normalized", dict(variant="normalized", alpha=1.3)),
                      ("offset", dict(variant="offset", delta=0.15))):
        kw = dict(kw, storage_dtype=f16, early_termination=True)
        build.LAUNCHES.clear()
        res = decode_minsum_stratified(sc, y, T, **kw)
        counted[label] = build.LAUNCHES.get("minsum_cn_scan", 0)
        equal_results(res, decode_minsum_stratified(sc, yc, T, **kw),
                      f"stratified min-sum {label}")
        equal_on_card(res, decode_minsum(code, y, T, **kw),
                      f"min-sum {label}")
        check(counted[label] >= 1, f"B1 not launched ({label})")
        print(f"  min-sum {label} f16 T={T} ET, {frames} frames: card == CPU"
              f" == card slot-array; satisfied "
              f"{float(res.satisfied.float().mean()):.4f}, B1 launches "
              f"{counted[label]}")
    # DD-BMP at 5.5 dB, where about half of the frames converge
    yq = quantize_no_zero(awgn_all_zero(
        SEED, 43 * frames, frames, code.n, snr_to_sigma(5.5, rate), device),
        1.5, 8.0)
    res = decode_ddbmp_stratified(sc, yq, 20)
    equal_results(res, decode_ddbmp_stratified(sc, yq.cpu(), 20),
                  "stratified DD-BMP")
    equal_on_card(res, decode_ddbmp(code, yq, 20), "DD-BMP")
    print(f"  DD-BMP 5.5 dB T=20: card == CPU == card slot-array; "
          f"satisfied {float(res.satisfied.float().mean()):.4f}")
    llr = llr_from_channel(y, snr_to_n0(STRAT_SNR_DB, rate))
    yg = stratified_grid(sc, llr.t().contiguous())
    step = stratified_bp_step(sc, storage_dtype=f16)
    v2c = stratified_init(sc, yg, f16)
    for _ in range(2):
        v2c, _ = step(v2c, yg)
    (v_d, t_d), (v_c, t_c) = step(v2c, yg), step(v2c.cpu(), yg.cpu())
    worst = float(((t_d.cpu() - t_c).abs() - BP_RTOL * t_c.abs()).max())
    check(worst <= BP_ATOL, f"stratified BP step total: card off by {worst}")
    kw = dict(early_termination=True, storage_dtype=f16)
    res = decode_bp_stratified(sc, llr, T, **kw)
    agree = {}
    for other, ref in (("CPU", decode_bp_stratified(sc, llr.cpu(), T, **kw)),
                       ("card slot-array", decode_bp(code, llr, T, **kw))):
        same = float(((res.hard.cpu() == ref.hard.cpu()).all(dim=1)
                      & (res.iterations.cpu() == ref.iterations.cpu()))
                     .float().mean())
        agree[other] = same
        check(same >= BP_FRAME_AGREEMENT,
              f"stratified BP vs {other}: {same} of the frames agree")
    print(f"  BP f16 T={T} ET: one step's totals within {BP_ATOL} + "
          f"{BP_RTOL}|cpu| of the CPU's; frames equal to the CPU's "
          f"{agree['CPU']:.4f}, to the card slot-array's "
          f"{agree['card slot-array']:.4f}")
    return counted, agree


def stratified_stream_full(label, dec, pre, batch_dec, sc, sigma, device):
    """One stratified stream at full width: BATCH lanes over a window of
    2·BATCH pool rows, recorded, then drained.  Its launches are read in a
    window of their own (counts from 0 just before its first call, read
    just after its last); every retired frame equals the card's batch
    decode of its pool row, in BATCH-frame chunks."""
    from ldpcsimulation_tpu_torch.harness import stream
    from ldpcsimulation_tpu_torch.harness.stream import _all_idle, fetch
    from ldpcsimulation_tpu_torch.kernels import build

    window = 2 * BATCH
    rows, unc, sat0 = stream.build_channel_pool(
        dec, SEED, 0, window, sc.n, sigma, pre, device=device)
    call = stream.make_stream_call(dec, sc.n, T, T, 2, record=True,
                                   rec_cap=window)
    state = stream.stream_init(dec, BATCH, sc.n, device=device)
    recs, ptr, calls = [], 0, 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    while calls < 20:
        state, acc, rec = call(state, rows, unc, sat0, 0, ptr)
        calls += 1
        a = fetch(acc)
        recs.append({k: v[:a["rc"]] for k, v in rec.items()})
        ptr += a["consumed"]
        if ptr >= window and _all_idle(state):
            break
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    got = {k: torch.cat([r[k] for r in recs]) for k in recs[0]}
    g = got["gid"]
    check(g.numel() == window and torch.unique(g).numel() == window,
          f"{label}: {g.numel()} frames retired of {window}")
    for f0 in range(0, window, BATCH):
        res = batch_dec(rows[f0:f0 + BATCH])
        at = ((g >= f0) & (g < f0 + BATCH)).nonzero()[:, 0]
        gl = g[at] - f0
        check(torch.equal(got["iters"][at],
                          res.iterations[gl].to(torch.int32))
              and torch.equal(got["hard"][at], res.hard[gl].to(torch.int8)),
              f"{label}: frames {f0}+ != their batch decode")
        del res
    avg = float(got["iters"].float().mean())
    print(f"  {label} f16 T={T} K=2, {BATCH} lanes: {window} frames in "
          f"{calls} calls (drain included), {secs:.4f} s "
          f"({window / secs:.6g} frames/s), avg iterations {avg:.4f}; every "
          f"frame equal to the card's batch decode ({BATCH}-frame chunks); "
          f"peak {peak:.2f} GiB; launches {launches}")
    return dict(frames=window, calls=calls, seconds=secs,
                frames_per_s=window / secs, avg_iterations=avg,
                peak_gib=peak, launches=launches)


def stratified_streams(sc, device, sigma, rate):
    """Both stratified streams at full width, each against its batch
    decoder on the card."""
    from ldpcsimulation_tpu_torch.channel import llr_from_channel, snr_to_n0
    from ldpcsimulation_tpu_torch.decoders import (
        decode_bp_stratified,
        decode_minsum_stratified,
    )
    from ldpcsimulation_tpu_torch.harness import stream

    f16 = torch.float16
    n0 = snr_to_n0(STRAT_SNR_DB, rate)
    out = {
        "minsum_stratified_stream": stratified_stream_full(
            "minsum_stratified_stream", stream.minsum_stratified_stream(
                sc, storage_dtype=f16), None,
            lambda rows: decode_minsum_stratified(
                sc, rows, T, early_termination=True, storage_dtype=f16),
            sc, sigma, device),
        "bp_stratified_stream": stratified_stream_full(
            "bp_stratified_stream", stream.bp_stratified_stream(
                sc, storage_dtype=f16), lambda y: llr_from_channel(y, n0),
            lambda rows: decode_bp_stratified(
                sc, rows, T, early_termination=True, storage_dtype=f16),
            sc, sigma, device),
    }
    check(out["minsum_stratified_stream"]["launches"].get(
        "minsum_cn_scan", 0) > 0, "B1 not launched by the min-sum stream")
    return out


def stratified_bp_ddbmp_full(sc, code, device, rate, timer):
    """``decode_bp_stratified`` (f16, T=10, 4.25 dB) and
    ``decode_ddbmp_stratified`` (T=20, 5.5 dB) at B=BATCH against
    ``decode_bp`` (frame agreement) and ``decode_ddbmp`` (``torch.equal``)
    on the same inputs: peak memory and time of both, in turns."""
    from ldpcsimulation_tpu_torch.channel import (
        awgn_all_zero,
        llr_from_channel,
        quantize_no_zero,
        snr_to_n0,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.decoders import (
        decode_bp,
        decode_bp_stratified,
        decode_ddbmp,
        decode_ddbmp_stratified,
    )

    f16 = torch.float16
    llr = llr_from_channel(awgn_all_zero(
        SEED, 0, BATCH, code.n, snr_to_sigma(STRAT_SNR_DB, rate), device),
        snr_to_n0(STRAT_SNR_DB, rate))
    yq = quantize_no_zero(awgn_all_zero(
        SEED, BATCH, BATCH, code.n, snr_to_sigma(5.5, rate), device),
        1.5, 8.0)
    routes = {
        "bp": (lambda: decode_bp_stratified(sc, llr, T, storage_dtype=f16),
               lambda: decode_bp(code, llr, T, storage_dtype=f16), T),
        "ddbmp": (lambda: decode_ddbmp_stratified(sc, yq, 20),
                  lambda: decode_ddbmp(code, yq, 20), 20),
    }
    out = {}
    for name, (strat, slot, t_max) in routes.items():
        peaks, res = {}, {}
        for route, fn in (("stratified", strat), ("slot-array", slot)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            res[route] = fn()
            torch.cuda.synchronize()
            peaks[route] = torch.cuda.max_memory_allocated(device) / 2**30
        a, b = res["stratified"], res["slot-array"]
        if name == "bp":
            agree = float(((a.hard == b.hard).all(dim=1)
                           & (a.iterations == b.iterations)).float().mean())
            check(agree >= BP_FRAME_AGREEMENT,
                  f"stratified BP at B={BATCH}: {agree} of the frames agree")
            what = f"frames equal to decode_bp's {agree:.6f}"
        else:
            agree = None
            for f in ("hard", "iterations", "satisfied"):
                check(torch.equal(getattr(a, f), getattr(b, f)),
                      f"stratified DD-BMP at B={BATCH} {f} != decode_ddbmp")
            what = "equal to decode_ddbmp (torch.equal)"
        rounds = int(a.iterations.max())
        sat = float(a.satisfied.float().mean())
        del res, a, b
        times = {"stratified": [], "slot-array": []}
        for route in ("stratified", "slot-array", "slot-array",
                      "stratified"):
            times[route].append(timer(
                strat if route == "stratified" else slot, 2))
        print(f"  decode_{name}_stratified B={BATCH} T={t_max}: {what}; "
              f"satisfied {sat:.4f}, up to {rounds} iterations; "
              f"{', '.join(f'{t:.4f}' for t in times['stratified'])} ms per "
              f"decode against decode_{name}'s "
              f"{', '.join(f'{t:.4f}' for t in times['slot-array'])} (runs "
              f"in turns); peak {peaks['stratified']:.2f} GiB against "
              f"{peaks['slot-array']:.2f}")
        out[name] = dict(agreement=agree, satisfied=sat, t_max=t_max,
                         max_iterations=rounds, ms=times["stratified"],
                         slot_array_ms=times["slot-array"],
                         peak_gib=peaks["stratified"],
                         slot_array_peak_gib=peaks["slot-array"])
    return out


def stratified_sweeps(alist, wide, device, batch=8192):
    """The sweep on a stratifiable --alist file: one row each.  ``bp``
    takes the stratified decoder (the detection line on stderr) on 60
    groups and the slot arrays on ``wide``'s 66, which are more column
    groups than B8 takes (a line that says so), B8 launched on both;
    min-sum and DD-BMP keep the slot arrays (no line; B1 launched by
    min-sum), also on ``wide``."""
    from ldpcsimulation_tpu_torch.codes import save_alist
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.tools.sweep import main as sweep_main

    line = "sweep: detected stratified structure ("
    common = ["--snr", str(STRAT_SNR_DB), "-T", str(T), "--batch",
              str(batch), "--max-frames", str(batch), "--msg-dtype", "f16",
              "--device", str(device)]
    out = {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        path, wide_path = f"{tmp}/strat_2048.alist", f"{tmp}/wide_800.alist"
        save_alist(alist, path)
        save_alist(wide, wide_path)
        for args, on, groups in (
                (["minsum"], path, None),
                (["offsetminsum", "--delta", "0.15"], path, None),
                (["normalizedminsum", "--alpha", "1.3"], path, None),
                (["bp"], path, "6x64 strata, 60 column groups"),
                (["ddbmp"], path, None),
                (["minsum", "--stream", "--early-termination"], path, None),
                (["bp", "--stream", "--early-termination"], path,
                 "6x64 strata, 60 column groups"),
                (["minsum"], wide_path, None),
                (["bp"], wide_path, None)):
            log_path = f"{tmp}/s.log"
            err = io.StringIO()
            build.LAUNCHES.clear()
            with contextlib.redirect_stderr(err):
                rc = sweep_main(args + ["--alist", on, "--log", log_path]
                                + common)
            launched = dict(build.LAUNCHES)
            with open(log_path) as f:
                row = f.read().splitlines()
            os.remove(log_path)
            os.remove(log_path + ".done")
            key = " ".join(args) + (" (66 groups)" if on == wide_path
                                    else "")
            said = err.getvalue()
            check(rc == 0 and len(row) == 1
                  and (line in said) == (groups is not None)
                  and (groups is None or f"({groups})" in said),
                  f"sweep {key}: rc {rc}, rows {row}, {said!r}")
            if "minsum" in args[0]:
                check(launched.get("minsum_cn_scan", 0) > 0,
                      f"sweep {key}: B1 not launched")
            if args[0] == "bp":
                check(launched.get("bp_cn_pair", 0) > 0,
                      f"sweep {key}: B8 not launched ({launched})")
                check(("(3x16 strata, 66 column groups) wider than kernel "
                       "B8's 64 slots" in said) == (on == wide_path),
                      f"sweep {key}: {said!r}")
            out[key] = dict(row=row[0], launches=launched)
            print(f"  sweep {key}: {'stratified' if groups else 'slot-array'}"
                  f" route; {row[0]}; launches {launched}")
    return out


def phase_stratified(device, lib_path, timer):
    """[42] The stratified family on the 802.3an geometry: the structure,
    card against CPU and against the slot arrays, both streams at full
    width, the sweep's routes (BP stratified; min-sum and DD-BMP on the
    slot arrays, also past B1's 64 groups), stratified BP and DD-BMP at
    B=32768 against the slot-array decoders, then min-sum T=10 f16 at
    B=32768 against ``decode_minsum`` on the same code and B1 at its new
    instance against its bounds."""
    from ldpcsimulation_tpu_torch.channel import awgn_all_zero, snr_to_sigma
    from ldpcsimulation_tpu_torch.codes import (
        build_code,
        detect_qc,
        detect_stratified,
        stratify,
    )
    from ldpcsimulation_tpu_torch.decoders import (
        decode_bp_stratified,
        decode_minsum,
        decode_minsum_stratified,
        minsum_plan,
        minsum_step,
        stratified_check_satisfied,
        stratified_minsum_step,
        stratified_plan,
    )
    from ldpcsimulation_tpu_torch.decoders.base import xor_satisfied
    from ldpcsimulation_tpu_torch.decoders.minsum_stratified import (
        stratified_grid,
        stratified_init,
    )
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.kernels.minsum import (
        minsum_cn_scan,
        minsum_cn_scan_plain,
    )
    from ldpcsimulation_tpu_torch.tools import sass_count

    alist = stratified_alist(**STRAT_GEOMETRY)
    t0 = time.perf_counter()
    sc = detect_stratified(alist)
    secs = time.perf_counter() - t0
    check(sc is not None and (sc.mb, sc.h, sc.kg, sc.w) == (6, 64, 60, 47)
          and sc.num_edges == 12288 and detect_qc(alist) is None,
          f"stratified structure {sc}")
    code = build_code(alist, device)
    rate = code.rate
    sigma = snr_to_sigma(STRAT_SNR_DB, rate)
    print(f"  {sc} in {secs:.2f} s (host); {alist.n} x {alist.m}, dv "
          f"{set(alist.dv)}, dc {set(alist.dc)}, not QC; rate {rate:.4f}")
    out = {"structure": dict(mb=sc.mb, h=sc.h, kg=sc.kg, w=sc.w,
                             cost=sc.cost, detect_seconds=secs)}

    counted, agree = stratified_card_vs_cpu(sc, code, device, sigma, rate)
    out["card_vs_cpu"] = dict(b1_launches=counted, bp_agreement=agree)
    out["streams"] = stratified_streams(sc, device, sigma, rate)
    wide = stratified_alist(800, 16, 3, 1.0, 1)  # 66 groups, dc 50
    out["sweeps"] = stratified_sweeps(alist, wide, device)
    out["bp_ddbmp"] = stratified_bp_ddbmp_full(sc, code, device, rate,
                                               timer)

    # B1 refuses more than 64 column groups by name, never the twin
    small = stratified_alist(192, 24, 4, 0.9, 3)
    wide = stratify(small, col_groups=[[c] for c in range(small.n)])
    try:
        decode_minsum_stratified(wide, torch.ones((8, small.n),
                                                  device=device), 1)
        check(False, f"B1 took kg={wide.kg}")
    except ValueError as e:
        check("dc_max <= 64" in str(e), f"B1 refusal: {e}")
    try:
        decode_bp_stratified(wide, torch.ones((8, small.n), device=device),
                             1)
        check(False, f"B8 took kg={wide.kg}")
    except ValueError as e:
        check("bp_cn_pair" in str(e) and "dc_max <= 64" in str(e),
              f"B8 refusal: {e}")
    print(f"  kg={wide.kg} column groups: B1 and B8 refuse them by name")

    # full width: the main path's run (counts from 0), then the timings
    f16 = torch.float16
    y = awgn_all_zero(SEED, 0, BATCH, code.n, sigma, device)
    decode_minsum_stratified(sc, y, T, storage_dtype=f16)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    build.LAUNCHES.clear()
    res = decode_minsum_stratified(sc, y, T, storage_dtype=f16)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    check(launches == {"minsum_cn_scan": T, "parity_check": 1},
          f"stratified min-sum launches {launches}")
    slot = decode_minsum(code, y, T, storage_dtype=f16)
    check(torch.equal(res.hard, slot.hard), "stratified != slot-array at "
          f"B={BATCH}")
    torch.cuda.reset_peak_memory_stats(device)
    decode_minsum(code, y, T, storage_dtype=f16)
    peak_slot = torch.cuda.max_memory_allocated(device) / 2**30
    times = {"stratified": [], "slot-array": []}
    for route in ("stratified", "slot-array", "slot-array", "stratified"):
        if route == "stratified":
            ms = timer(lambda: decode_minsum_stratified(
                sc, y, T, storage_dtype=f16), 3)
        else:
            ms = timer(lambda: decode_minsum(code, y, T, storage_dtype=f16),
                       3)
        times[route].append(ms)
    ber = float((res.hard != 1).float().mean())
    print(f"  decode_minsum_stratified T={T} f16 B={BATCH} at "
          f"{STRAT_SNR_DB} dB (BER {ber:.4g}): "
          f"{', '.join(f'{t / T:.4f}' for t in times['stratified'])} ms per "
          f"iteration against decode_minsum's "
          f"{', '.join(f'{t / T:.4f}' for t in times['slot-array'])} "
          f"(runs in turns); equal decisions; peak {peak:.2f} GiB against "
          f"{peak_slot:.2f}; launches {launches}")

    # one iteration's parts on the same samples (CUDA events)
    cn_rows = stratified_plan(sc, device).cn_rows
    plan = minsum_plan(code, device)
    yt = y.t().contiguous()
    yg = stratified_grid(sc, yt)
    v_s = stratified_init(sc, yg, f16)
    v_g = yt.repeat_interleave(code.dv_max, dim=0).to(f16)
    d_g = torch.where(yt > 0, 1, -1).to(torch.int8)
    d_s = torch.where(yg > 0, 1, -1).to(torch.int8)
    step_s = stratified_minsum_step(sc, storage_dtype=f16)
    step_g = minsum_step(code, storage_dtype=f16)
    parts = {
        "stratified step": timer(lambda: step_s(v_s, yg)),
        "stratified B1": timer(lambda: minsum_cn_scan(
            v_s.view(-1, BATCH), cn_rows)),
        "stratified syndrome": timer(
            lambda: stratified_check_satisfied(sc, d_s)),
        "stratified grid gather": timer(lambda: stratified_grid(sc, yt)),
        "slot-array step": timer(lambda: step_g(v_g, yt)),
        "slot-array B1": timer(lambda: minsum_cn_scan(v_g, plan.cn_rows)),
        "slot-array syndrome": timer(
            lambda: xor_satisfied(plan.check_cols, d_g)),
    }
    print("  one iteration's parts, ms: " + "; ".join(
        f"{k} {v:.4f}" for k, v in parts.items()))
    del v_s, v_g, yg

    # B1 at the new instance: [mb·kg·w, B] VN-slot planes, [mb·h, kg]
    gen = torch.Generator(device=device).manual_seed(42)
    v2c = tied_messages(gen, sc.mb * sc.kg * sc.w, BATCH, f16, device)
    named = cn_rows[cn_rows >= 0].long()
    max_err = 0.0
    for variant, kw in (("plain", {}), ("normalized", dict(alpha=1.3)),
                        ("offset", dict(delta=0.15))):
        got = minsum_cn_scan(v2c, cn_rows, variant, **kw)[named]
        want = minsum_cn_scan_plain(v2c, cn_rows, variant, **kw)[named]
        max_err = max(max_err, float((got - want).abs().max()))
        check(same_bits(got, want), f"B1 stratified {variant}: kernel != "
              "plain")
        del got, want
    b1_ms = timer(lambda: minsum_cn_scan(v2c, cn_rows))
    plain_ms = timer(lambda: minsum_cn_scan_plain(v2c, cn_rows), 2)
    nbytes = named.numel() * BATCH * (v2c.element_size() + 4) + (
        cn_rows.numel() * 4)
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    _, top = sm_clocks()
    kernels = sass_count.parse(sass_count.disassemble(lib_path))
    diag, diag_text = b1_issue(kernels, cn_rows, v2c, top, b1_ms)
    print(f"  B1 stratified [{v2c.shape[0]} x {BATCH}] f16, table "
          f"[{cn_rows.shape[0]} x {cn_rows.shape[1]}]: equal to the twin "
          f"(plain, normalized 1.3, offset 0.15); {b1_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; memory bound {mem_ms:.4f} ms "
          f"({nbytes / 1e9:.3f} GB), roofline share {mem_ms / b1_ms:.1%}; "
          f"{diag_text}; {b1_ms / (min(times['stratified']) / T):.1%}"
          f" of a stratified iteration")
    out["full_width"] = dict(
        breakdown_ms=parts,
        ms_per_iteration=[t / T for t in times["stratified"]],
        slot_array_ms_per_iteration=[t / T for t in times["slot-array"]],
        peak_gib=peak, slot_array_peak_gib=peak_slot, ber=ber,
        launches=launches)
    out["b1"] = dict(shape=[v2c.shape[0], BATCH], dc_max=int(sc.kg),
                     ms=b1_ms, plain_ms=plain_ms, bytes=nbytes,
                     bound_ms=mem_ms, bound_by="bytes", share=mem_ms / b1_ms,
                     max_abs_err=max_err, **diag)
    return out


B5_CHUNK = 4096  # lanes per twin comparison on the DVB-S2 table
B5_PAIRS = ((torch.float16, torch.float32), (torch.float32, torch.float32),
            (torch.float16, torch.float16), (torch.float32, torch.float16))


def b5_tables(device):
    """(name, vn_rows) of kernel B5's four tables: QC, slot-array, the
    DVB-S2 generalized plan (pairs, an absent edge, degrees 2, 3 and 8) and
    an irregular slot array (dv_max 11: past the 8 terms held in
    registers, and padding slots)."""
    from ldpcsimulation_tpu_torch.codes import load_named_code, load_named_qc
    from ldpcsimulation_tpu_torch.decoders import minsum_plan, qc_plan

    return (
        (f"QC {CODE}", qc_plan(load_named_qc(CODE), device).vn_rows),
        (f"slot-array {PEG_CODE}", minsum_plan(
            load_named_code(PEG_CODE), device).vn_rows),
        (f"generalized {DVBS2_CODE}", qc_plan(
            load_named_qc(DVBS2_CODE), device).vn_rows),
        (f"slot-array {WIFI_CODE}", minsum_plan(
            load_named_code(WIFI_CODE), device).vn_rows),
    )


def b5_inputs(rows, n, lo, hi, sdt, cdt, device):
    """c2v [rows, hi - lo] and y [n, hi - lo] for lanes [lo, hi) of a B5
    check (keyed by lo): tied messages with -0.0 and 1 % at +-60000.5
    (past f16's range once summed), samples around 1 with 1 % at 65510
    (an f32 sum past 65504 reaches the clamp, an f16 one inf)."""
    g = torch.Generator(device=device).manual_seed(43 + lo)
    w = hi - lo
    c2v = tied_messages(g, rows, w, torch.float32, device)
    big = torch.rand(rows, w, generator=g, device=device) < 0.01
    c2v = torch.where(big, torch.where(c2v < 0, -60000.5, 60000.5), c2v)
    y = 1.0 + 0.8 * torch.randn(n, w, generator=g, device=device)
    big = torch.rand(n, w, generator=g, device=device) < 0.01
    y = torch.where(big, 65510.0, y)
    return c2v.to(sdt), y.to(cdt)


def phase_b5(device, timer):
    """Kernel B5 against its twin bit for bit (int views: signed zeros,
    the clamp, f16 infinities) on its four tables, in the four (storage,
    channel) dtype pairs, at B=32768, B=32770 (2 lanes a thread), an odd
    batch (1 lane) and B=1; the DVB-S2 table's twin runs on chunks of
    ``B5_CHUNK`` lanes (its full-width temporaries would not fit beside the
    kernel's).  Each table's time at B=32768 (f16 storage, f32 channel: the
    main path's; and f32), its twin's, the memory bound and the roofline
    share."""
    from ldpcsimulation_tpu_torch.kernels.minsum import (
        NO_TERM,
        minsum_vn_update,
        minsum_vn_update_plain,
        vn_lane_width,
    )

    out, max_err, lanes_seen = {}, 0.0, set()
    for name, vn_rows in b5_tables(device):
        n, dv = vn_rows.shape
        rows = int((vn_rows != NO_TERM).sum())
        read = int((vn_rows >= 0).sum())
        named = torch.where(vn_rows >= 0, vn_rows, -vn_rows - 2)[
            vn_rows != NO_TERM]
        check(torch.equal(named.sort().values.long(),
                          torch.arange(rows, device=device)),
              f"B5 {name}: the table does not name rows 0..R-1 once each")
        wide = rows * BATCH * 4 > 8 << 30
        for batch in (BATCH, BATCH + 2, ODD_BATCH, 1):
            step = B5_CHUNK if wide else batch
            spans = [(lo, min(lo + step, batch))
                     for lo in range(0, batch, step)]
            for sdt, cdt in B5_PAIRS:
                c2v = torch.empty((rows, batch), dtype=sdt, device=device)
                y = torch.empty((n, batch), dtype=cdt, device=device)
                for lo, hi in spans:
                    c2v[:, lo:hi], y[:, lo:hi] = b5_inputs(
                        rows, n, lo, hi, sdt, cdt, device)
                # total is a fresh allocation, aligned as y is
                lanes_seen.add(vn_lane_width(c2v, y, y))
                v2c, total = minsum_vn_update(c2v, y, vn_rows)
                for lo, hi in spans:
                    want = minsum_vn_update_plain(*b5_inputs(
                        rows, n, lo, hi, sdt, cdt, device), vn_rows)
                    for got, ref in zip((v2c[:, lo:hi], total[:, lo:hi]),
                                        want):
                        check(same_bits(got, ref), f"B5 {name} B={batch} "
                              f"{sdt}/{cdt} lanes [{lo}, {hi}): kernel != "
                              "plain")
                        d = (got.float() - ref.float()).abs_()
                        max_err = max(max_err, float(torch.nan_to_num_(
                            d, 0.0, 0.0, 0.0).max()))  # inf - inf
                        del d
                    del want
                key = (f"{name} B={batch} "
                       f"{str(sdt).split('.')[-1]}/{str(cdt).split('.')[-1]}")
                if batch == BATCH and cdt == torch.float32:
                    ms = timer(lambda: minsum_vn_update(c2v, y, vn_rows))
                    plain_ms = (None if wide else timer(
                        lambda: minsum_vn_update_plain(c2v, y, vn_rows), 2))
                    ssize = c2v.element_size()
                    nbytes = ((read + rows) * batch * ssize
                              + 2 * n * batch * 4 + vn_rows.numel() * 4)
                    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
                    out[key] = dict(
                        shape=[rows, batch], n=n, dv_max=dv, ms=ms,
                        plain_ms=plain_ms, bytes=nbytes, bound_ms=mem_ms,
                        bound_by="bytes", share=mem_ms / ms)
                    plain = ("not measured (full width)" if plain_ms is None
                             else f"{plain_ms:.4f} ms")
                    print(f"  B5 {key}: {ms:.4f} ms, plain {plain}; memory "
                          f"bound {mem_ms:.4f} ms ({nbytes / 1e6:.1f} MB), "
                          f"roofline share {mem_ms / ms:.1%}", flush=True)
                del c2v, y, v2c, total
                torch.cuda.empty_cache()
            print(f"  B5 {name} [{rows} x {batch}], dv_max {dv}: equal to "
                  f"the twin in {len(B5_PAIRS)} dtype pairs", flush=True)
    check(lanes_seen == {1, 2, 4}, f"B5 instances {lanes_seen}")
    return dict(forms=out, max_abs_err=max_err)


def b6_inputs(gen, n, batch, dtype, device):
    """±1 decisions [N, B] with every eighth lane all +1 (a codeword)."""
    d = torch.where(torch.rand(n, batch, generator=gen, device=device)
                    < 0.9, 1, -1).to(dtype)
    d[:, ::8] = 1
    return d


def b6_forms(device):
    """(label, check table, N, batch, dtypes) of B6's callers at full
    width: the flagship QC min-sum check, the slot-array and DVB-S2 checks,
    the bit-flip syndrome on qc_1008_504's QCGraph, the stratified 802.3an
    table, and the 1-lane instance (odd batch, misaligned view)."""
    from ldpcsimulation_tpu_torch.codes import (
        detect_stratified,
        load_named_code,
        load_named_qc,
    )
    from ldpcsimulation_tpu_torch.decoders import (
        minsum_plan,
        qc_plan,
        stratified_plan,
    )
    from ldpcsimulation_tpu_torch.decoders.qc_ops import qc_graph

    i8, i32 = torch.int8, torch.int32
    qc = load_named_qc(CODE)
    peg = load_named_code(PEG_CODE)
    dvb = load_named_qc(DVBS2_CODE)
    sc = detect_stratified(stratified_alist(**STRAT_GEOMETRY))
    return [
        (f"QC {CODE} check", qc_plan(qc, device).check_cols, qc.n, BATCH,
         (i32, i8)),
        (f"QCGraph {CODE} syndrome", qc_graph(qc, device).check_cols, qc.n,
         BATCH, (i8, i32)),
        (f"slot-array {PEG_CODE} check", minsum_plan(peg, device).check_cols,
         peg.n, BATCH, (i32,)),
        (f"QC {DVBS2_CODE} check", qc_plan(dvb, device).check_cols, dvb.n,
         BATCH, (i32,)),
        ("stratified 802.3an check", stratified_plan(sc, device).check_cols,
         sc.kg * sc.w, BATCH, (i8,)),
        (f"slot-array {PEG_CODE} check B={ODD_BATCH}",
         minsum_plan(peg, device).check_cols, peg.n, ODD_BATCH, (i32,)),
    ]


def phase_b6(device, timer):
    """Kernel B6 against its twin under ``torch.equal`` (satisfied flags and
    the bipolar syndrome) on every caller's table at full width, with its
    time, the twin's, the memory bound and the roofline share."""
    from ldpcsimulation_tpu_torch.kernels.check import (
        check_lane_width,
        parity_check,
        parity_check_plain,
    )

    gen = torch.Generator(device=device).manual_seed(44)
    out, lanes_seen = {}, set()
    for label, cols, n, batch, dtypes in b6_forms(device):
        m = cols.shape[0]
        edges = int((cols < n).sum())
        for dtype in dtypes:
            d = b6_inputs(gen, n, batch, dtype, device)
            views = [d]
            if "B=" in label:  # a view one element in: the 1-lane instance
                buf = torch.empty(n * batch + 1, dtype=dtype, device=device)
                buf[1:].copy_(d.view(-1))
                views.append(buf[1:].view(n, batch))
            for dv in views:
                lanes_seen.add(check_lane_width(dv))
                sat, syn = parity_check(cols, dv, syndrome=True)
                want_sat, want_syn = parity_check_plain(cols, dv,
                                                        syndrome=True)
                check(torch.equal(sat, want_sat) and torch.equal(
                    syn, want_syn) and torch.equal(parity_check(cols, dv),
                                                   want_sat),
                      f"B6 {label} {dtype} B={batch}: kernel != plain")
                check(bool(sat[::8].all()) and not bool(sat.all()),
                      f"B6 {label}: the codeword lanes")
            size = d.element_size()
            key = f"{label} {str(dtype).split('.')[-1]}"
            for syndrome in (False, True):
                ms = timer(lambda: parity_check(cols, d, syndrome=syndrome))
                plain_ms = timer(lambda: parity_check_plain(
                    cols, d, syndrome=syndrome), 2)
                nbytes = (n * batch * size + batch + cols.numel() * 8
                          + (m * batch * size if syndrome else 0))
                mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
                # one XOR per named edge-lane, a compare per check-lane
                ops = edges * batch + m * batch
                op_ms = ops / F32_OPS_PER_S * 1e3
                bound = max(mem_ms, op_ms)
                form = f"{key}{' + syndrome' if syndrome else ''}"
                out[form] = dict(
                    shape=[m, n, batch], ms=ms, plain_ms=plain_ms,
                    bytes=nbytes, bound_ms=bound,
                    bound_by="bytes" if mem_ms >= op_ms else "operations",
                    share=bound / ms, lanes=check_lane_width(d))
                print(f"  B6 {form} [{m} checks x {n} x {batch}]: {ms:.4f} "
                      f"ms, plain {plain_ms:.4f} ms; memory bound "
                      f"{mem_ms:.4f} ms ({nbytes / 1e6:.1f} MB), roofline "
                      f"share {bound / ms:.1%}", flush=True)
            del d, views, sat, syn, want_sat, want_syn
            torch.cuda.empty_cache()
    check(lanes_seen == {1, 4, 16}, f"B6 instances {lanes_seen}")
    return dict(forms=out, max_abs_err=0.0)


def b7_case(gen, g, n, batch, dtype, w_vn, pert, device):
    """One step's inputs on ``g``'s tables: ±1 decisions and their
    syndrome, saturated samples, adapted thresholds, smoothing sums, a
    quarter of the lanes inactive, the perturbation when asked."""
    from ldpcsimulation_tpu_torch.kernels.check import parity_check

    d = b6_inputs(gen, n, batch, dtype, device)
    syn = parity_check(g.check_cols, d, syndrome=True)[1]
    y = (1.0 + 0.8 * torch.randn(n, batch, generator=gen, device=device)
         ).clamp_(-GDBF_YMAX, GDBF_YMAX)
    k = torch.randint(0, 6, (n, batch), generator=gen, device=device)
    thetas = torch.full((n, batch), float(np.float32(GDBF_KW["theta"])),
                        device=device)
    for j in range(1, 6):  # adapted 0-5 times
        thetas = torch.where(k >= j, thetas * float(np.float32(
            GDBF_KW["lam"])), thetas)
    dsum = torch.randint(-20, 21, (n, batch), generator=gen, device=device,
                         dtype=torch.int32)
    act = torch.rand(batch, generator=gen, device=device) < 0.75
    p = (0.7 * torch.randn(n, batch, generator=gen, device=device)
         if pert else None)
    return d, y, syn, thetas, dsum, act, w_vn, p


def phase_b7(device, timer):
    """Kernel B7 against its twin bit for bit (d, the thresholds' bits and
    the smoothing sums) at full width on qc_1008_504's QCGraph with int8
    decisions, in every parallel flag combination (adaptation on and off,
    in and out of the smoothing window, scalar and per-VN w, perturbation
    given and absent), a quarter of the lanes inactive; then int32
    decisions, the slot-array graph of peg_1008_504 and the 1-lane
    instance (odd batch).  Each case's time, its twin's, the memory bound
    and the roofline share."""
    import itertools

    from ldpcsimulation_tpu_torch.codes import load_named_code, load_named_qc
    from ldpcsimulation_tpu_torch.decoders.qc_ops import qc_graph, slot_graph
    from ldpcsimulation_tpu_torch.kernels.gdbf import (
        gdbf_parallel_step,
        gdbf_parallel_step_plain,
        step_lane_width,
    )

    gen = torch.Generator(device=device).manual_seed(45)
    qc = load_named_qc(CODE)
    peg = load_named_code(PEG_CODE, device)
    graphs = {CODE: (qc_graph(qc, device), qc.n, qc.m,
                     qc.to_code(device).vn_deg),
              PEG_CODE: (slot_graph(peg, device), peg.n, peg.m, peg.vn_deg)}
    lam = float(np.float32(GDBF_KW["lam"]))
    alpha = float(np.float32(GDBF_KW["alpha"]))
    cases = [(CODE, BATCH, torch.int8, *flags)
             for flags in itertools.product((True, False), repeat=4)]
    cases += [(CODE, BATCH, torch.int32, True, True, False, True),
              (PEG_CODE, BATCH, torch.int8, True, True, False, True),
              (PEG_CODE, ODD_BATCH, torch.int8, True, True, True, True)]
    out, lanes_seen = {}, set()
    for name, batch, dtype, adapt, smooth, per_vn, pert in cases:
        g, n, m, deg = graphs[name]
        w = (torch.tensor(np.float32(alpha * GDBF_YMAX), device=device)
             / deg.float()) if per_vn else alpha
        args = b7_case(gen, g, n, batch, dtype, w, pert, device)
        d, y, syn, thetas, dsum, act, w, p = args
        kw = dict(lam=lam if adapt else None, smooth=smooth)
        state = [d.clone(), thetas.clone(), dsum.clone()]
        gdbf_parallel_step(state[0], y, syn, g.vn_checks, state[1],
                           state[2], act, w, p, **kw)
        want = [d.clone(), thetas.clone(), dsum.clone()]
        gdbf_parallel_step_plain(want[0], y, syn, g.vn_checks, want[1],
                                 want[2], act, w, p, **kw)
        lanes_seen.add(step_lane_width(d, y, syn, thetas, dsum, act, p))
        label = (f"{name} {str(dtype).split('.')[-1]} B={batch} "
                 f"adapt={int(adapt)} window={int(smooth)} "
                 f"w={'per-VN' if per_vn else 'scalar'} pert={int(pert)}")
        check(torch.equal(state[0], want[0])
              and torch.equal(state[1].view(torch.int32),
                              want[1].view(torch.int32))
              and torch.equal(state[2], want[2]),
              f"B7 {label}: kernel != plain")
        flipped = float((state[0] != d).float().mean())
        check(0.0 < flipped < 1.0 and not bool(
            (state[0] != d)[:, ~act].any()), f"B7 {label}: flips {flipped}")
        ms = timer(lambda: gdbf_parallel_step(
            state[0], y, syn, g.vn_checks, state[1], state[2], act, w,
            p, **kw))
        plain_ms = timer(lambda: gdbf_parallel_step_plain(
            want[0], y, syn, g.vn_checks, want[1], want[2], act, w, p,
            **kw), 2)
        size = d.element_size()
        plane = n * batch
        nbytes = (m * batch * size + 2 * plane * size + plane * 4
                  + plane * 4 * (2 if adapt else 1)
                  + (plane * 4 if pert else 0)
                  + (2 * plane * 4 if smooth else 0) + batch
                  + g.vn_checks.numel() * 8 + (n * 4 if per_vn else 0))
        mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # the neighbour adds, the metric's 3 (4) f32 operations, the
        # compare, the threshold multiply
        ops = (int((g.vn_checks < m).sum()) * batch
               + plane * (5 + int(pert) + int(adapt)))
        op_ms = ops / F32_OPS_PER_S * 1e3
        bound = max(mem_ms, op_ms)
        out[label] = dict(
            shape=[n, batch], ms=ms, plain_ms=plain_ms, bytes=nbytes,
            bound_ms=bound,
            bound_by="bytes" if mem_ms >= op_ms else "operations",
            share=bound / ms)
        print(f"  B7 {label}: equal to the twin (flipped {flipped:.3g}); "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms; memory bound "
              f"{mem_ms:.4f} ms ({nbytes / 1e6:.1f} MB), roofline share "
              f"{bound / ms:.1%}", flush=True)
        del args, d, y, syn, thetas, dsum, act, p, state, want
    check(lanes_seen == {1, 4}, f"B7 instances {lanes_seen}")
    torch.cuda.empty_cache()
    return dict(forms=out, max_abs_err=0.0)


def phase_gdbf_chunks(qc, device):
    """The bit-flip decoder's two step paths on the card: the chunk path
    (``kernels.gdbf.gdbf_chunk``) against the per-step loop (forced by
    replacing ``decoders.gdbf._takes_chunks``), bit for bit on every
    result field and the step count, at [10]'s point (SMNGDBF, T=300) at
    B=32768 and 32771 (the 1-lane instances of B6 and B7, B4's tail), with
    RSMNGDBF's phase restarts (per-VN weight) and the noiseless SATGDBF;
    each path's launches and step counts, then the T=300 decode's time on
    each path, alternated."""
    from ldpcsimulation_tpu_torch.channel import (
        awgn_all_zero,
        saturate,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.decoders import NoiseKey, preset
    from ldpcsimulation_tpu_torch.decoders import gdbf as gd
    from ldpcsimulation_tpu_torch.kernels import build

    fields = ("hard", "iterations", "satisfied", "phases", "smoothing_used")
    code = qc.to_code(device)
    rate = (qc.n - qc.m) / qc.n
    real = gd._takes_chunks

    def decode(cfg, y, sigma, key, chunked):
        gd._takes_chunks = real if chunked else (lambda *a: False)
        try:
            build.LAUNCHES.clear()
            build.PATHS.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = gd.decode_gdbf(code, y, sigma, cfg, key=key, qc=qc)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            gd._takes_chunks = real
        return res, ms, dict(build.LAUNCHES), dict(build.PATHS)

    out = {}
    for name, snr, T, batch, extra in (
        ("SMNGDBF", GDBF_SNR_DB, GDBF_T, BATCH, {}),
        ("SMNGDBF", GDBF_SNR_DB, GDBF_T, ODD_BATCH, {}),
        ("RSMNGDBF", 3.0, 41, BATCH, dict(max_phases=3)),
        ("SATGDBF", 3.5, 100, ODD_BATCH, {}),
    ):
        cfg = preset(name, T, **GDBF_KW, **extra)
        sigma = snr_to_sigma(snr, rate)
        frame0 = 3 * batch
        y = saturate(awgn_all_zero(SEED, frame0, batch, qc.n, sigma,
                                   device), GDBF_YMAX)
        key = NoiseKey(SEED, frame0)
        c, _, c_l, c_p = decode(cfg, y, sigma, key, True)
        lo, _, l_l, l_p = decode(cfg, y, sigma, key, False)
        for f in fields:
            check(torch.equal(getattr(c, f), getattr(lo, f)),
                  f"{name} B={batch} {f}: chunks != per-step loop")
        check(c.steps == lo.steps, f"{name} B={batch} steps {c.steps} != "
              f"{lo.steps}")
        steps = c.steps
        noise = {"gauss_philox": steps} if cfg.add_noise else {}
        want = {"parity_check": steps, "gdbf_parallel_step": steps, **noise}
        check(l_l == want and c_l == {**want, "gdbf_lanes": steps},
              f"{name} B={batch} launches: chunks {c_l}, loop {l_l}")
        inst = "fast" if batch % 2 == 0 else "tail"
        b4 = {("gauss_philox", inst): steps} if cfg.add_noise else {}
        check(c_p == {**b4, ("gdbf_step", "chunk"): steps}
              and l_p == {**b4, ("gdbf_step", "loop"): steps},
              f"{name} B={batch} paths: chunks {c_p}, loop {l_p}")
        label = f"{name} T={T} x{cfg.max_phases} B={batch}"
        out[label] = dict(steps=steps, chunk_launches=c_l,
                          loop_launches=l_l)
        print(f"  {label}: chunks == per-step loop ({steps} steps, "
              f"{int(c.satisfied.sum())} satisfied, max phases "
              f"{int(c.phases.max())}); chunk launches {c_l}; chunk share "
              f"{c_p[('gdbf_step', 'chunk')] / steps:.3f}", flush=True)
        del y, c, lo

    # the T=300 decode at [10]'s point, each path three times, alternated
    cfg = preset("SMNGDBF", GDBF_T, **GDBF_KW)
    sigma = snr_to_sigma(GDBF_SNR_DB, rate)
    y = saturate(awgn_all_zero(SEED, 0, BATCH, qc.n, sigma, device),
                 GDBF_YMAX)
    key = NoiseKey(SEED, 0)
    times = {"chunk": [], "loop": []}
    decode(cfg, y, sigma, key, True)  # warm-up
    for _ in range(3):
        for path in ("loop", "chunk"):
            res, ms, _, _ = decode(cfg, y, sigma, key, path == "chunk")
            times[path].append(ms)
    med = {k: sorted(v)[1] for k, v in times.items()}
    print(f"  SMNGDBF T={GDBF_T} B={BATCH} decode ({res.steps} steps), ms: "
          f"per-step loop {times['loop']}, chunks {times['chunk']}; medians "
          f"{med['loop']:.2f} -> {med['chunk']:.2f} "
          f"({med['loop'] / med['chunk']:.3f}x)")
    out["decode_ms"] = times
    return out


B8_DVBS2_BATCH = 2048  # B8's DVB-S2 form: its twin's f32 planes per slot


def b8_wide_qc(nb: int, z: int, seed: int):
    """A QC code of two base rows with every block present (random
    shifts): each check of degree ``nb``, past B8's first slot caps."""
    from ldpcsimulation_tpu_torch.codes import build_qc_code

    rng = np.random.default_rng(seed)
    return build_qc_code(rng.integers(0, z, (2, nb)), z)


def b8_forms():
    """(name, QC code, batch, storage dtypes, v2c's element offset into
    its buffer) of B8's forms: the main path's, the other QC plans (pairs
    and an absent edge in dvbs2_1_2_qc), the 16-, 32- and 64-slot caps, an
    odd batch (the 1-lane instances) and a view two f16 elements in (the
    2-lane instance)."""
    from ldpcsimulation_tpu_torch.codes import load_named_qc, qc_peg

    f16, f32 = torch.float16, torch.float32
    qc1 = load_named_qc(CODE)
    return (
        (CODE, qc1, BATCH, (f16, f32), 0),
        (WIFI_CODE, load_named_qc(WIFI_CODE), BATCH, (f16,), 0),
        (f"generalized {DVBS2_CODE}", load_named_qc(DVBS2_CODE),
         B8_DVBS2_BATCH, (f16,), 0),
        ("qc_peg(20, 6, 3, z=16), dc_max 10", qc_peg(20, 6, 3, z=16, seed=1),
         BATCH, (f16, f32), 0),
        ("2 x 24 base, z=32, dc_max 24", b8_wide_qc(24, 32, 24), BATCH,
         (f16,), 0),
        ("2 x 48 base, z=32, dc_max 48", b8_wide_qc(48, 32, 48), BATCH,
         (f16, f32), 0),
        (f"odd batch {CODE}", qc1, ODD_BATCH, (f16, f32), 0),
        (f"{CODE} view two elements in", qc1, BATCH, (f16,), 2),
    )


def b8_messages(gen, rows, batch, dtype, offset, device):
    """v2c planes as the decoder stores them (clamped to +-20, 1 % +0.0
    and 1 % -0.0: a zero input makes its check's other outputs zero, with
    the sign of the others' product), ``offset`` elements into their
    buffer."""
    v = torch.clamp(1.0 + 6.0 * torch.randn(rows, batch, generator=gen,
                                            device=device), -20.0, 20.0)
    u = torch.rand(rows, batch, generator=gen, device=device)
    v = torch.where(u < 0.01, 0.0, torch.where(u > 0.99, -0.0, v))
    buf = torch.empty(rows * batch + offset, dtype=dtype, device=device)
    out = buf[offset:].view(rows, batch)
    out.copy_(v)
    return out


def b8_instance(dtype, cap: int, lanes: int) -> str:
    """The mangled-name key of B8's instance."""
    t = "6__half" if dtype == torch.float16 else "f"
    return f"bp_cn_pair_kernelI{t}Li{cap}ELi{lanes}EE"


def b8_sass_path(kernel, degree: int, cap: int):
    """SASS on one thread's path through a B8 instance for a check of
    ``degree`` named slots (``Kernel.path_through``): the row-table loads
    (two past 32 slots), the first ``degree`` of the cap's unrolled message
    loads and the last ``degree`` of its unrolled stores (the backward
    loop emits slot cap-1 first).  None where nvcc lays the kernel out
    otherwise: the count is a diagnostic, not a check."""
    from ldpcsimulation_tpu_torch.tools import sass_count

    loads = [i for i, x in enumerate(kernel.instrs)
             if x.base in sass_count.LOADS]
    stores = [i for i, x in enumerate(kernel.instrs)
              if x.base in sass_count.STORES]
    table = 2 if cap > 32 else 1
    if len(loads) != table + cap or len(stores) != cap:
        return None
    try:
        return kernel.path_through(loads[:table + degree]
                                   + stores[cap - degree:])
    except ValueError:
        return None


def b8_issue(kernels, cn_rows, batch, dtype, cap, lanes, top, ms):
    """Issue bound of one B8 launch of ``ms`` from its SASS, summed over
    the checks' degrees (:func:`b8_sass_path`): the fields ``issue_ms``,
    ``issue_share`` and ``sass_per_edge_lane`` (None where not measured)
    and a line of text."""
    from ldpcsimulation_tpu_torch.tools import sass_count

    fields = dict(issue_ms=None, issue_share=None, sass_per_edge_lane=None)
    key = b8_instance(dtype, cap, lanes)
    if sum(key in name for name in kernels) != 1:
        return fields, "issue not measured (no instance)"
    k = sass_count.find(kernels, key)
    degs, counts = torch.unique((cn_rows >= 0).sum(dim=1).cpu(),
                                return_counts=True)
    paths = [b8_sass_path(k, int(d), cap) for d in degs]
    if None in paths:
        return fields, "issue not measured (SASS layout)"
    total = sum(int(c) * p for p, c in zip(paths, counts))
    issue = sass_count.issue_ms(cn_rows.shape[0] * -(-batch // lanes),
                                total / cn_rows.shape[0], top, SMS)
    fields.update(issue_ms=issue, issue_share=issue / ms,
                  sass_per_edge_lane=total / (int((cn_rows >= 0).sum())
                                              * lanes))
    return fields, (f"issue {issue:.4f} ms "
                    f"({fields['sass_per_edge_lane']:.1f} SASS per "
                    f"edge-lane)")


def phase_b8(device, lib_path, timer):
    """Kernel B8 (the sum-product check update) against its twin on the
    card, bit for bit (int32 views: signed zeros too), in every form of
    :func:`b8_forms`, through ``qc_cn_bp`` (the rows of absent edges zeroed
    after it), with each form's time per launch (behind a long sleep
    kernel), the twin's, the memory bound and the issue bound; then a T=20
    early-terminating ``decode_bp_qc`` (f16) whose B8 launches equal its
    rounds, which never calls the twin, and whose results equal the same
    decode with the twin in the kernel's place."""
    from ldpcsimulation_tpu_torch.channel import (
        awgn_all_zero,
        llr_from_channel,
        snr_to_n0,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.codes import load_named_qc
    from ldpcsimulation_tpu_torch.decoders import bp as dbp
    from ldpcsimulation_tpu_torch.decoders import bp_qc, qc_cn_bp, qc_plan
    from ldpcsimulation_tpu_torch.kernels import bp as kbp
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.tools import sass_count

    _, top = sm_clocks()
    kernels = sass_count.parse(sass_count.disassemble(lib_path))
    gen = torch.Generator(device=device).manual_seed(46)
    forms = {}
    for name, qc, batch, dtypes, offset in b8_forms():
        plan = qc_plan(qc, device)
        rows = plan.cn_rows
        edges = int((rows >= 0).sum())
        for dtype in dtypes:
            v2c = b8_messages(gen, plan.num_planes * qc.z, batch, dtype,
                              offset, device)
            want = kbp.bp_cn_pair_plain(v2c, rows)
            if plan.absent_rows is not None:
                want.index_fill_(0, plan.absent_rows, 0.0)
            build.LAUNCHES.clear()
            got = qc_cn_bp(qc, v2c)
            check(dict(build.LAUNCHES) == {"bp_cn_pair": 1},
                  f"B8 {name}: launches {dict(build.LAUNCHES)}")
            differ = int((got.view(torch.int32)
                          != want.view(torch.int32)).sum())
            check(same_bits(got, want), f"B8 {name} {dtype}: kernel != "
                  f"plain ({differ} of {got.numel()} differ)")
            zeros = want == 0
            neg_zeros = int((zeros & torch.signbit(want)).sum())
            cap, lanes = kbp.bp_instance(rows.shape[1], batch, dtype,
                                         v2c.data_ptr(), got.data_ptr())
            del got, want
            ms = time_small_ms(lambda: kbp.bp_cn_pair(v2c, rows), 20)
            plain_ms = timer(lambda: kbp.bp_cn_pair_plain(v2c, rows), 2)
            nbytes = (edges * batch * (v2c.element_size() + 4)
                      + rows.numel() * 4)
            mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
            diag, diag_text = b8_issue(kernels, rows, batch, dtype, cap,
                                       lanes, top, ms)
            label = f"{name} B={batch} {str(dtype).split('.')[-1]}"
            forms[label] = dict(
                shape=[v2c.shape[0], batch], checks=rows.shape[0],
                dc_max=rows.shape[1], cap=cap, lanes=lanes, ms=ms,
                plain_ms=plain_ms, bytes=nbytes, bound_ms=mem_ms,
                bound_by="bytes", share=mem_ms / ms,
                zero_outputs=int(zeros.sum()), negative_zeros=neg_zeros,
                **diag)
            print(f"  B8 {label} [{v2c.shape[0]} x {batch}], {rows.shape[0]}"
                  f" checks, dc_max {rows.shape[1]} (cap {cap}, {lanes} "
                  f"lanes): equal bit for bit ({int(zeros.sum())} zero "
                  f"outputs, {neg_zeros} of them -0.0); {ms:.4f} ms per "
                  f"launch, plain {plain_ms:.4f} ms; memory bound "
                  f"{mem_ms:.4f} ms ({nbytes / 1e6:.1f} MB), roofline "
                  f"share {mem_ms / ms:.1%}; {diag_text}", flush=True)
            del v2c
        torch.cuda.empty_cache()

    # a decode: B8 once a round, never the twin, equal to the twin's decode
    qc = load_named_qc(CODE)
    llr = llr_from_channel(awgn_all_zero(
        SEED, 0, BATCH, qc.n, snr_to_sigma(2.0, 0.5), device),
        snr_to_n0(2.0, 0.5))
    twin_calls = []
    real_plain, real_pair = kbp.bp_cn_pair_plain, dbp.bp_cn_pair

    def counted_plain(*args):
        twin_calls.append(1)
        return real_plain(*args)

    def decode():
        return bp_qc.decode_bp_qc(qc, llr, 20, early_termination=True,
                                  storage_dtype=torch.float16)

    kbp.bp_cn_pair_plain = counted_plain
    try:
        build.LAUNCHES.clear()
        res = decode()
        torch.cuda.synchronize()
        launched = dict(build.LAUNCHES)
    finally:
        kbp.bp_cn_pair_plain = real_plain
    rounds = int(res.iterations.max())
    check(launched == {"bp_cn_pair": rounds, "bp_vn_update": rounds,
                       "parity_check": rounds + 1} and not twin_calls,
          f"decode_bp_qc: launches {launched} for {rounds} rounds, "
          f"{len(twin_calls)} twin calls")
    dbp.bp_cn_pair = real_plain
    try:
        ref = decode()
    finally:
        dbp.bp_cn_pair = real_pair
    for f in ("hard", "iterations", "satisfied"):
        check(torch.equal(getattr(res, f), getattr(ref, f)),
              f"decode_bp_qc {f}: B8 != twin")
    print(f"  decode_bp_qc {CODE} 2.0 dB T=20 ET f16, B={BATCH}: {rounds} "
          f"rounds, launches {launched}, the twin never called; decisions, "
          f"iterations and flags equal to the decode on the twin "
          f"({int(res.satisfied.sum())} of {BATCH} satisfied)")
    return dict(forms=forms, decode=dict(rounds=rounds, launches=launched),
                max_abs_err=0.0)


def b9_forms():
    """(name, QC code, batch, [(storage, channel) dtypes], c2v's element
    offset into its buffer) of B9's forms: the main path's in the four
    dtype pairs, wifi_1944_972 (dv_max 11, past the 8 terms held in
    registers), the DVB-S2 plan (pairs, absent edges, degrees 2, 3 and 8),
    an odd batch (the 1-lane instances) and c2v a view two f32 elements in
    (the 2-lane instance)."""
    from ldpcsimulation_tpu_torch.codes import load_named_qc

    f16, f32 = torch.float16, torch.float32
    pairs = ((f16, f32), (f32, f32), (f16, f16), (f32, f16))
    qc1 = load_named_qc(CODE)
    return (
        (CODE, qc1, BATCH, pairs, 0),
        (WIFI_CODE, load_named_qc(WIFI_CODE), BATCH, pairs[:1] + pairs[2:3],
         0),
        (f"generalized {DVBS2_CODE}", load_named_qc(DVBS2_CODE),
         B8_DVBS2_BATCH, pairs[:1], 0),
        (f"odd batch {CODE}", qc1, ODD_BATCH, pairs, 0),
        (f"{CODE} c2v two elements in", qc1, BATCH, pairs[:1], 2),
    )


def b9_inputs(gen, plan, batch, cdt, offset, device):
    """(c2v [R, B] f32 ``offset`` elements into its buffer, y [N, B] in
    ``cdt``) as B8 and the decoder leave them: c2v spread past the ±20
    clip once summed, 1 % +0.0, 1 % -0.0 and 0.01 % NaN, +0.0 in the rows
    of absent edges; y clamped LLRs with 1 % -0.0 and, in the first 64
    lanes, every column's terms and sample -0.0 (a -0.0 posterior)."""
    rows, n = plan.num_planes * plan.z, plan.vn_rows.shape[0]
    v = 12.0 * torch.randn(rows, batch, generator=gen, device=device)
    u = torch.rand(rows, batch, generator=gen, device=device)
    v = torch.where(u < 0.01, 0.0, torch.where(u > 0.99, -0.0, v))
    v = torch.where(u < 1e-4, float("nan"), v)
    v[:, :64] = -0.0
    if plan.absent_rows is not None:
        v.index_fill_(0, plan.absent_rows, 0.0)
    buf = torch.empty(rows * batch + offset, device=device)
    c2v = buf[offset:].view(rows, batch)
    c2v.copy_(v)
    del v, u
    y = torch.clamp(1.0 + 6.0 * torch.randn(n, batch, generator=gen,
                                            device=device), -20.0, 20.0)
    y = torch.where(torch.rand(n, batch, generator=gen, device=device)
                    < 0.01, -0.0, y)
    y[:, :64] = -0.0
    return c2v, y.to(cdt)


def phase_b9(device, timer):
    """Kernel B9 (the sum-product VN update) against its twin on the card,
    bit for bit (int views: signed zeros, NaN, the clip), in every form of
    :func:`b9_forms`, through the wrapper, with each form's time per launch
    (behind a long sleep kernel), the twin's and the memory bound; then a
    T=20 early-terminating ``decode_bp_qc`` (f16) whose B9 launches equal
    its rounds, which never calls the twin, and whose results equal the
    same decode with the twin in the kernel's place."""
    from ldpcsimulation_tpu_torch.channel import (
        awgn_all_zero,
        llr_from_channel,
        snr_to_n0,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.codes import load_named_qc
    from ldpcsimulation_tpu_torch.decoders import bp_qc, qc_plan
    from ldpcsimulation_tpu_torch.decoders.bp import MAXLLR
    from ldpcsimulation_tpu_torch.kernels import bp as kbp
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.kernels.minsum import vn_lane_width

    gen = torch.Generator(device=device).manual_seed(47)
    forms, lanes_seen = {}, set()
    for name, qc, batch, pairs, offset in b9_forms():
        plan = qc_plan(qc, device)
        vn_rows = plan.vn_rows
        n, dv = vn_rows.shape
        edges = plan.num_planes * qc.z
        for sdt, cdt in pairs:
            c2v, y = b9_inputs(gen, plan, batch, cdt, offset, device)
            want_v, want_t = kbp.bp_vn_update_plain(c2v, y, vn_rows, MAXLLR,
                                                    sdt)
            build.LAUNCHES.clear()
            got_v, got_t = kbp.bp_vn_update(c2v, y, vn_rows, MAXLLR, sdt)
            check(dict(build.LAUNCHES) == {"bp_vn_update": 1},
                  f"B9 {name}: launches {dict(build.LAUNCHES)}")
            label = (f"{name} B={batch} {str(sdt).split('.')[-1]}/"
                     f"{str(cdt).split('.')[-1]}")
            for what, got, want in (("v2c'", got_v, want_v),
                                    ("total", got_t, want_t)):
                check(same_bits(got, want), f"B9 {label} {what}: kernel != "
                      f"plain")
            check(float(got_v.float().nan_to_num().abs().max()) <= MAXLLR,
                  f"B9 {label}: v2c' past the clip")
            neg = int((got_t == 0).logical_and(torch.signbit(got_t)).sum())
            nans = int(torch.isnan(got_v).sum())
            check(neg > 0 and nans > 0, f"B9 {label}: {neg} -0.0 totals, "
                  f"{nans} NaN messages")
            lanes = min(vn_lane_width(c2v, y, got_t),
                        vn_lane_width(got_v, got_v, got_v))
            lanes_seen.add(lanes)
            del got_v, got_t, want_v, want_t
            ms = time_small_ms(
                lambda: kbp.bp_vn_update(c2v, y, vn_rows, MAXLLR, sdt), 20)
            plain_ms = timer(lambda: kbp.bp_vn_update_plain(
                c2v, y, vn_rows, MAXLLR, sdt), 2)
            nbytes = (batch * (edges * (4 + sdt.itemsize)
                               + n * (cdt.itemsize + 4))
                      + vn_rows.numel() * 4)
            mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
            forms[label] = dict(
                shape=[edges, batch], n=n, dv_max=dv, lanes=lanes, ms=ms,
                plain_ms=plain_ms, bytes=nbytes, bound_ms=mem_ms,
                bound_by="bytes", share=mem_ms / ms, negative_zeros=neg,
                nan_messages=nans)
            print(f"  B9 {label} [{edges} x {batch}], {n} columns, dv_max "
                  f"{dv} ({lanes} lanes): equal bit for bit ({neg} -0.0 "
                  f"totals, {nans} NaN messages); {ms:.4f} ms per launch, "
                  f"plain {plain_ms:.4f} ms; memory bound {mem_ms:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB), roofline share "
                  f"{mem_ms / ms:.1%}", flush=True)
            del c2v, y
            torch.cuda.empty_cache()
    check(lanes_seen == {1, 2, 4}, f"B9 instances {lanes_seen}")

    # a decode: B9 once a round, never the twin, equal to the twin's decode
    qc = load_named_qc(CODE)
    llr = llr_from_channel(awgn_all_zero(
        SEED, 0, BATCH, qc.n, snr_to_sigma(2.0, 0.5), device),
        snr_to_n0(2.0, 0.5))
    twin_calls = []
    real_plain, real_vn = kbp.bp_vn_update_plain, bp_qc.bp_vn_update

    def counted_plain(*args):
        twin_calls.append(1)
        return real_plain(*args)

    def decode():
        return bp_qc.decode_bp_qc(qc, llr, 20, early_termination=True,
                                  storage_dtype=torch.float16)

    kbp.bp_vn_update_plain = counted_plain
    try:
        build.LAUNCHES.clear()
        res = decode()
        torch.cuda.synchronize()
        launched = dict(build.LAUNCHES)
    finally:
        kbp.bp_vn_update_plain = real_plain
    rounds = int(res.iterations.max())
    check(launched == {"bp_cn_pair": rounds, "bp_vn_update": rounds,
                       "parity_check": rounds + 1} and not twin_calls,
          f"decode_bp_qc: launches {launched} for {rounds} rounds, "
          f"{len(twin_calls)} twin calls")
    bp_qc.bp_vn_update = real_plain
    try:
        ref = decode()
    finally:
        bp_qc.bp_vn_update = real_vn
    for f in ("hard", "iterations", "satisfied"):
        check(torch.equal(getattr(res, f), getattr(ref, f)),
              f"decode_bp_qc {f}: B9 != twin")
    print(f"  decode_bp_qc {CODE} 2.0 dB T=20 ET f16, B={BATCH}: {rounds} "
          f"rounds, launches {launched}, the twin never called; decisions, "
          f"iterations and flags equal to the decode on the twin "
          f"({int(res.satisfied.sum())} of {BATCH} satisfied)")
    return dict(forms=forms, decode=dict(rounds=rounds, launches=launched),
                max_abs_err=0.0)


def b10_posterior(gen, rows, batch, dtype, device):
    """A posterior [rows, B] in ``dtype`` with the decision's hazards:
    1 % +0.0, 1 % -0.0, 0.1 % NaN, 0.1 % +inf and 0.1 % -inf."""
    total = 4.0 * torch.randn(rows, batch, generator=gen, device=device)
    u = torch.rand(rows, batch, generator=gen, device=device)
    for lo, hi, v in ((0.0, 0.01, 0.0), (0.01, 0.02, -0.0),
                      (0.02, 0.021, float("nan")),
                      (0.021, 0.022, float("inf")),
                      (0.022, 0.023, -float("inf"))):
        total.masked_fill_((u >= lo) & (u < hi), v)
    del u
    return total.to(dtype)


def b10_bytes(rows, batch, arith) -> int:
    """``et_merge_roofline_pct``'s least bytes of one merge: the posterior
    read, the decisions written, done read and the counts written."""
    return batch * (rows * (arith + 1) + 5)


def phase_et_merge(device, timer):
    """Kernel B10 (the early-termination decision merge) against its twin
    on the card, bit for bit, in every form, synchronized after each
    launch, with each form's time per launch, least time and twin's time;
    then one decode of each early-terminating cell's configuration with
    B10 once per executed round by its wide instance and the twin never,
    equal to the same decode on the twin."""
    from ldpcsimulation_tpu_torch.channel import (
        awgn_all_zero,
        llr_from_channel,
        snr_to_n0,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.codes import load_named_qc
    from ldpcsimulation_tpu_torch.decoders import base, bp_qc, minsum_qc
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.kernels import merge as kmerge

    gen = torch.Generator(device=device).manual_seed(48)
    f32, f16, bf16 = torch.float32, torch.float16, torch.bfloat16
    forms = {}
    for name, rows, batch, dtype, want_path in (
            (f"{DVBS2_CODE} B={DVBS2_BATCH}", 64800, DVBS2_BATCH, f32,
             "wide"),
            (f"{CODE} B={BATCH}", 1008, BATCH, f32, "wide"),
            (f"{CODE} B={BATCH} f16", 1008, BATCH, f16, "wide"),
            (f"{CODE} B={BATCH} bf16", 1008, BATCH, bf16, "wide"),
            (f"odd batch {CODE} B={ODD_BATCH}", 1008, ODD_BATCH, f32,
             "tail")):
        total = b10_posterior(gen, rows, batch, dtype, device)
        done = torch.rand(batch, generator=gen, device=device) < 0.5
        d0 = torch.where(torch.rand(rows, batch, generator=gen,
                                    device=device) < 0.5, 1, -1
                         ).to(torch.int8)
        it0 = torch.randint(0, 50, (batch,), generator=gen, device=device,
                            dtype=torch.int32)
        want_d, want_it = d0.clone(), it0.clone()
        kmerge.et_merge_plain(total, done, want_d, want_it, 7)
        torch.cuda.synchronize()
        got_d, got_it = d0.clone(), it0.clone()
        build.LAUNCHES.clear()
        build.PATHS.clear()
        kmerge.et_merge(total, done, got_d, got_it, 7)
        torch.cuda.synchronize()
        check(dict(build.LAUNCHES) == {"et_merge": 1}
              and dict(build.PATHS) == {("et_merge", want_path): 1},
              f"B10 {name}: launches {dict(build.LAUNCHES)}, instances "
              f"{dict(build.PATHS)}")
        check(torch.equal(got_d, want_d) and torch.equal(got_it, want_it),
              f"B10 {name}: kernel != plain")
        check(torch.equal(got_d[:, done], d0[:, done])
              and torch.equal(got_it[done], it0[done]),
              f"B10 {name}: a done lane changed")
        ms = timer(lambda: kmerge.et_merge(total, done, got_d, got_it, 7),
                   20)
        torch.cuda.synchronize()
        plain_ms = timer(lambda: kmerge.et_merge_plain(
            total, done, want_d, want_it, 7), 2)
        check(torch.equal(got_d, want_d), f"B10 {name}: repeated calls")
        nbytes = b10_bytes(rows, batch, dtype.itemsize)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        forms[name] = dict(
            shape=[rows, batch], dtype=str(dtype).split(".")[-1],
            instance=want_path, ms=ms, plain_ms=plain_ms, bytes=nbytes,
            bound_ms=bound_ms, bound_by="bytes", share=bound_ms / ms)
        print(f"  B10 {name} [{rows} x {batch}] "
              f"{forms[name]['dtype']} ({want_path}): equal bit for bit; "
              f"{ms:.4f} ms per launch, least {bound_ms:.4f} ms "
              f"({nbytes / 1e6:.1f} MB), share {bound_ms / ms:.1%}; "
              f"plain {plain_ms:.4f} ms", flush=True)
        del total, done, d0, it0, want_d, want_it, got_d, got_it
        torch.cuda.empty_cache()

    # one decode of each early-terminating cell's configuration
    dvb = load_named_qc(DVBS2_CODE)
    qc = load_named_qc(CODE)
    y6 = awgn_all_zero(SEED, 0, DVBS2_BATCH, dvb.n,
                       snr_to_sigma(1.6, 0.5), device)
    llr5 = llr_from_channel(awgn_all_zero(
        SEED, 0, BATCH, qc.n, snr_to_sigma(2.0, 0.5), device),
        snr_to_n0(2.0, 0.5))
    cells = {
        "dvbs2-et50-1.6dB": lambda: minsum_qc.decode_minsum_qc(
            dvb, y6, 50, early_termination=True,
            storage_dtype=torch.float16),
        "bp-et20-2.0dB": lambda: bp_qc.decode_bp_qc(
            qc, llr5, 20, early_termination=True,
            storage_dtype=torch.float16),
    }
    decodes = {}
    twin_calls = []
    real_plain, real_merge = kmerge.et_merge_plain, base.et_merge

    def counted_plain(*args):
        twin_calls.append(1)
        return real_plain(*args)

    for cell, decode in cells.items():
        decode()  # warm
        torch.cuda.synchronize()
        kmerge.et_merge_plain = counted_plain
        try:
            build.LAUNCHES.clear()
            build.PATHS.clear()
            t0 = time.perf_counter()
            res = decode()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launched, paths = dict(build.LAUNCHES), dict(build.PATHS)
        finally:
            kmerge.et_merge_plain = real_plain
        rounds = int(res.iterations.max())
        check(launched.get("et_merge") == rounds
              and paths.get(("et_merge", "wide")) == rounds
              and ("et_merge", "tail") not in paths and not twin_calls,
              f"{cell}: launches {launched}, instances {paths} for {rounds}"
              f" rounds, {len(twin_calls)} twin calls")
        base.et_merge = real_plain
        try:
            ref = decode()
        finally:
            base.et_merge = real_merge
        for f in ("hard", "iterations", "satisfied"):
            check(torch.equal(getattr(res, f), getattr(ref, f)),
                  f"{cell} {f}: B10 != twin")
        decodes[cell] = dict(rounds=rounds, launches=launched,
                             paths={"/".join(k): v for k, v in paths.items()},
                             seconds=secs,
                             satisfied=int(res.satisfied.sum()))
        print(f"  {cell}: {rounds} rounds in {secs:.4f} s, launches "
              f"{launched}, instances {paths}, the twin never called; "
              f"equal to the decode on the twin "
              f"({int(res.satisfied.sum())} of {res.satisfied.numel()} "
              f"satisfied)", flush=True)
        del res, ref
        torch.cuda.empty_cache()
    return dict(forms=forms, decodes=decodes, max_abs_err=0.0)


def b11_state(gen, plan, n, batch, sdt, device):
    """A posterior [N, B] f32 and the layers' stored messages in ``sdt``
    with the step's hazards: 1 % +0.0, 1 % -0.0, 0.1 % NaN, 0.1 % +-inf,
    0.5 % +-1e5 (outputs past f16's range); +0.0 in absent rows."""
    def hazards(rows, scale):
        x = scale * torch.randn(rows, batch, generator=gen, device=device)
        u = torch.rand(rows, batch, generator=gen, device=device)
        for lo, hi, v in ((0.0, 0.01, 0.0), (0.01, 0.02, -0.0),
                          (0.02, 0.021, float("nan")),
                          (0.021, 0.022, float("inf")),
                          (0.022, 0.023, -float("inf")),
                          (0.023, 0.0255, 1e5), (0.0255, 0.028, -1e5)):
            x.masked_fill_((u >= lo) & (u < hi), v)
        return x

    q = hazards(n, 6.0)
    L = []
    for lp in plan.layers:
        m = hazards(lp.dc * plan.z, 3.0)
        if lp.absent is not None:
            m.index_fill_(0, lp.absent, 0.0)
        L.append(m.to(sdt))
    return q, L


def b11_bytes(lp, batch, storage) -> int:
    """``layer_step_roofline_pct``'s least bytes of one layer: its distinct
    columns read and written in f32, its messages read and written in the
    storage type."""
    cols = int(lp.slot_cols[lp.slot_cols >= 0].unique().numel())
    edges = int((lp.slot_cols >= 0).sum())
    return batch * (cols * 2 * 4 + edges * 2 * storage)


def b11_forms():
    """(name, QC code, batch, [(storage, variant, kw)], expected (cap,
    lanes)) of B11's forms: the cell's code in both storage types and the
    two post-ops, an odd batch (the 1-lane instance), DVB-S2's pair-free
    layers (an absent edge among them) and the 16-, 32- and 64-slot caps."""
    from ldpcsimulation_tpu_torch.codes import load_named_qc, qc_peg

    f16, f32 = torch.float16, torch.float32
    norm = ("normalized", dict(alpha=1.25))
    off = ("offset", dict(delta=0.15))
    wifi = load_named_qc(WIFI_CODE)
    return (
        (WIFI_CODE, wifi, BATCH, [(f16, *norm), (f32, *norm), (f16, *off),
                                  (f32, *off), (f16, "plain", {})], (8, 4)),
        (f"odd batch {WIFI_CODE}", wifi, ODD_BATCH, [(f16, *norm),
                                                     (f32, *off)], (8, 1)),
        (f"generalized {DVBS2_CODE}", load_named_qc(DVBS2_CODE),
         DVBS2_BATCH, [(f16, *off)], (8, 4)),
        ("qc_peg(20, 6, 3, z=16), dc_max 10", qc_peg(20, 6, 3, z=16, seed=1),
         BATCH, [(f16, *norm)], (16, 2)),
        ("2 x 24 base, z=32, dc_max 24", b8_wide_qc(24, 32, 24), BATCH,
         [(f16, *norm)], (32, 1)),
        ("2 x 48 base, z=32, dc_max 48", b8_wide_qc(48, 32, 48), BATCH,
         [(f16, *norm), (f32, *off)], (64, 1)),
    )


def phase_b11(device, timer):
    """Kernel B11 (one layer of row-layered min-sum) against its twin on
    the card, bit for bit (int views: signed zeros, NaN, the f16 clamp),
    in every form of :func:`b11_forms`, layer by layer, the posterior
    updated in place and the new messages, synchronized after each launch;
    each form's time per launch of its first layer beside the least time
    and the twin's; then the cell wifi-layered-et30-2.2dB's decode (B=32768,
    normalized 1.25, T=30 with early termination, f16 messages, quantized
    2.2 dB samples) with B11 Mb times per executed round and B1 never,
    equal to the decode on the step from before B11
    (``tests/frozen_layered.py``)."""
    from ldpcsimulation_tpu_torch.channel import (
        awgn_all_zero,
        quantize_no_zero,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.codes import load_named_qc
    from ldpcsimulation_tpu_torch.decoders import minsum_layered, qc_plan
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.kernels import layered as klayered
    from tests import frozen_layered

    gen = torch.Generator(device=device).manual_seed(49)
    forms = {}
    for name, qc, batch, runs, want_inst in b11_forms():
        plan = qc_plan(qc, device)
        singles = [i for i, lp in enumerate(plan.layers)
                   if lp.pair_first is None]
        for sdt, variant, kw in runs:
            q, L = b11_state(gen, plan, qc.n, batch, sdt, device)
            build.LAUNCHES.clear()
            build.PATHS.clear()
            for i in singles:
                lp, l_old = plan.layers[i], L[i]
                q_want = q.clone()
                want = klayered.minsum_layer_step_plain(
                    q_want, l_old, lp, variant, sdt=sdt, **kw)
                torch.cuda.synchronize()
                got = klayered.minsum_layer_step(q, l_old, lp, variant,
                                                 sdt=sdt, **kw)
                torch.cuda.synchronize()
                label = (f"B11 {name} {variant} {str(sdt).split('.')[-1]} "
                         f"layer {i}")
                check(same_bits(got, want), f"{label}: messages != twin")
                check(same_bits(q, q_want), f"{label}: posterior != twin")
                del q_want, want, got
            lanes = want_inst[1]
            check(dict(build.LAUNCHES) == {"minsum_layer_step": len(singles)}
                  and dict(build.PATHS) == {("minsum_layer_step", lanes):
                                            len(singles)},
                  f"B11 {name}: launches {dict(build.LAUNCHES)}, instances "
                  f"{dict(build.PATHS)}, {len(singles)} pair-free layers")
            check(klayered.layer_instance(
                plan.layers[singles[0]].dc, q, L[singles[0]],
                L[singles[0]]) == want_inst, f"B11 {name}: instance")
            lp, l_old = plan.layers[singles[0]], L[singles[0]]
            ms = timer(lambda: klayered.minsum_layer_step(
                q, l_old, lp, variant, sdt=sdt, **kw), 20)
            plain_ms = timer(lambda: klayered.minsum_layer_step_plain(
                q, l_old, lp, variant, sdt=sdt, **kw), 2)
            nbytes = b11_bytes(lp, batch, sdt.itemsize)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            key = f"{name} B={batch} {variant} {str(sdt).split('.')[-1]}"
            forms[key] = dict(
                layers=len(singles), pair_layers=qc.mb - len(singles),
                dc=lp.dc, cap=want_inst[0], lanes=lanes, ms=ms,
                plain_ms=plain_ms, bytes=nbytes, bound_ms=bound_ms,
                bound_by="bytes", share=bound_ms / ms)
            print(f"  B11 {key}: {len(singles)} pair-free layers equal bit "
                  f"for bit (cap {want_inst[0]}, {lanes} lanes); layer "
                  f"{singles[0]} (dc {lp.dc}) {ms:.4f} ms per launch, least "
                  f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB), share "
                  f"{bound_ms / ms:.1%}; twin {plain_ms:.4f} ms", flush=True)
            del q, L
            torch.cuda.empty_cache()

    # the cell's decode: B11 Mb times a round, B1 never, equal to the
    # decode on the step from before B11
    wifi = load_named_qc(WIFI_CODE)
    y = quantize_no_zero(awgn_all_zero(
        SEED, 0, BATCH, wifi.n, snr_to_sigma(2.2, 0.5), device), 2.0, 8.0)

    def decode():
        return minsum_layered.decode_minsum_layered_qc(
            wifi, y, 30, variant="normalized", alpha=1.25,
            early_termination=True, storage_dtype=torch.float16)

    decode()  # warm
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    build.PATHS.clear()
    t0 = time.perf_counter()
    res = decode()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched, paths = dict(build.LAUNCHES), dict(build.PATHS)
    rounds = int(res.iterations.max())
    check(launched.get("minsum_layer_step") == wifi.mb * rounds
          and "minsum_cn_scan" not in launched
          and paths.get(("minsum_layer_step", 4)) == wifi.mb * rounds,
          f"the cell's decode: launches {launched}, instances {paths} for "
          f"{rounds} rounds of {wifi.mb} layers")
    real = minsum_layered.qc_minsum_layered_step
    minsum_layered.qc_minsum_layered_step = (
        frozen_layered.qc_minsum_layered_step)
    try:
        decode()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = decode()
        torch.cuda.synchronize()
        frozen_secs = time.perf_counter() - t0
    finally:
        minsum_layered.qc_minsum_layered_step = real
    for f in ("hard", "iterations", "satisfied"):
        check(torch.equal(getattr(res, f), getattr(ref, f)),
              f"the cell's decode {f}: B11 != the step before it")
    print(f"  wifi-layered-et30-2.2dB's decode (B={BATCH}): {rounds} rounds "
          f"in {secs:.4f} s (the step before B11: {frozen_secs:.4f} s), "
          f"launches {launched}, instances {paths}; equal to the decode on "
          f"the step before B11 ({int(res.satisfied.sum())} of {BATCH} "
          f"satisfied)", flush=True)
    return dict(forms=forms, decode=dict(
        rounds=rounds, launches=launched, seconds=secs,
        frozen_seconds=frozen_secs,
        paths={f"{k[0]}/{k[1]}": v for k, v in paths.items()}),
        max_abs_err=0.0)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from ldpcsimulation_tpu_torch.channel import snr_to_sigma
    from ldpcsimulation_tpu_torch.codes import load_named_qc
    from ldpcsimulation_tpu_torch.decoders import decode_minsum_qc
    from ldpcsimulation_tpu_torch.harness import StopRule, simulate
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.tools.sweep import main as sweep_main

    device = torch.device("cuda", 0)
    card = card_line()
    header(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    path, log, secs = build.build()
    build.library()
    header(f"[2] built {path.name} in {secs:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"    {line.strip()}")

    qc = load_named_qc(CODE)
    sigma = snr_to_sigma(SNR_DB, (qc.n - qc.m) / qc.n)
    header(f"[3] B1 vs plain, {CODE}, B={BATCH}")
    b1_err, b1_times = phase_b1(qc, device, BATCH, sigma, time_ms)
    header("[4] B2 vs plain")
    b2_err, b2_times = phase_b2(qc, device, BATCH, sigma, time_ms)

    header(f"[5] main path: simulate {CODE} {SNR_DB} dB T={T} f16, "
          f"4 x {BATCH} frames")
    code = qc.to_code(device)

    def dec(y, key):
        return decode_minsum_qc(qc, y, T, storage_dtype=torch.float16)

    def run():
        return simulate(code, dec, SNR_DB, stop=StopRule.fixed_frames(
            4 * BATCH), batch_size=BATCH, seed=SEED, device=device)

    run()  # warm-up: allocator and caches
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    build.PATHS.clear()
    stats = run()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    paths = dict(build.PATHS)
    rate = stats.total_words * (qc.n - qc.m) / stats.wall_seconds
    print(f"  BER {stats.ber!r} FER {stats.fer!r} over {stats.total_words} "
          f"frames in {stats.wall_seconds:.4f} s: {rate:.6g} decoded info "
          f"bits/s; launches {launches}")
    check(2.2e-2 <= stats.ber <= 2.6e-2, f"BER {stats.ber} outside "
          "[2.2e-2, 2.6e-2]")
    check(launches.get("minsum_cn_scan", 0) > 0, "B1 not launched")
    check(launches.get("minsum_vn_update", 0) > 0, "B5 not launched")
    check(launches.get("awgn_philox", 0) > 0, "B2 not launched")
    check(launches.get("parity_check", 0) > 0, "B6 not launched")
    check(launches == {"minsum_cn_scan": 4 * T, "minsum_vn_update": 4 * T,
                       "awgn_philox": 4, "parity_check": 4},
          f"unexpected launch counts {launches}")
    check(paths == {("awgn_philox", "fast"): 4}, f"B2 instances {paths}")
    check_totals("minsum", stats)
    parts = breakdown(qc, device, BATCH, sigma, time_ms)

    header("[6] sweep CLI, one point")
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        log_path = f"{tmp}/sweep.log"
        rc = sweep_main([
            "minsum", "--code", CODE, "--snr", "2.0", "-T", "10",
            "--msg-dtype", "f16", "--batch", str(BATCH), "--max-frames",
            str(2 * BATCH), "--log", log_path,
        ])
        with open(log_path) as f:
            row = f.read().splitlines()
    print(f"  row: {row}")
    check(rc == 0 and len(row) == 1, "sweep wrote one row")
    cols = row[0].split("\t")
    check(len(cols) == 6 and cols[0] == "2" and cols[4] == "10"
          and cols[5] == CODE and 2.2e-2 <= float(cols[1]) <= 2.6e-2,
          f"sweep row {cols}")

    n = qc.n
    header(f"[7] B3 vs plain [{n} x {BATCH}]")
    b3_err, b3_times = phase_b3(n, device, BATCH, time_ms)
    header(f"[8] B4 vs plain [{n} x {BATCH}]")
    b4_err, b4_times = phase_b4(n, device, BATCH, sigma, time_ms)
    header("[9] GDBF decode: card vs CPU plain path on injected draws")
    gdbf9 = phase_gdbf_equal(qc, device)
    header(f"[10] SMNGDBF path: simulate {CODE} {GDBF_SNR_DB} dB T={GDBF_T},"
          f" 4 x {BATCH} frames")
    g_stats, g_rate, g_launches, g_parts = phase_gdbf_main(
        qc, device, BATCH, time_ms)
    header("[11] sweep CLI, gdbf route")
    _, s_launches = phase_gdbf_sweep(device, BATCH)
    header("[12] edge shapes: B2, B3, B4 vs plain, both instances")
    phase_edges(device)

    header("[13] bounds at the main path's shapes")
    times = {
        "minsum_cn_scan": (*b1_times["f16 store"], None),
        "awgn_philox": b2_times[:3],
        "uniform_philox": b3_times[:3],
        "gauss_philox": b4_times[:3],
    }
    per_batch = {  # launches per batch of 32768 frames, by path
        name: {"minsum": launches.get(name, 0) / 4,
               "smngdbf": g_launches.get(name, 0) / 4}
        for name in times
    }
    per_batch["uniform_philox"]["gdbf sweep"] = (
        s_launches["uniform_philox"] / 4)
    bounds = phase_bounds(path, card, per_batch, times, qc, BATCH)

    header("[14] B1 vs plain, the slot-array and generalized QC forms")
    forms, forms_err = phase_b1_forms(device, path, time_ms)
    header("[15] min-sum decodes: card vs CPU plain path")
    phase_card_vs_cpu(device)
    header(f"[16] slot-array path: simulate {PEG_CODE} {SNR_DB} dB T={T} f16, "
          f"4 x {BATCH} frames; then {DVBS2_CODE} at B={DVBS2_POINT_BATCH}")
    p_stats, p_rate, p_launches, p_parts = phase_generic_main(device, time_ms)
    d_stats, d_rate, d_launches, d_ms, d_peak = phase_dvbs2_point(device)
    header("[17] sweep CLI, --alist and the quantized min-sum routes")
    _, ms_launches = phase_minsum_sweep(device, 8192)
    header("[18] layered min-sum and DD-BMP: card vs CPU plain path")
    layered_counted, layered_b6 = phase_layered_ddbmp_card_vs_cpu(device)
    header("[19] BP: card vs CPU plain path, by tolerance and agreement")
    bp_seen = phase_bp_card_vs_cpu(device)
    header("[20] B1 at a layer's shape vs plain")
    layer_forms, layer_err = phase_b1_layer(device, path, time_ms)
    header(f"[21] BP, layered min-sum and DD-BMP paths: simulate at B={BATCH}")
    new_paths = phase_new_paths(device, time_ms)
    header("[22] sweep CLI, the bp, layered and ddbmp routes")
    phase_new_sweep(device, 8192)
    header("[23] NGDBFhw: card vs CPU plain path on the keyed ring")
    hw_counted = phase_hw_card_vs_cpu(device)
    header("[24] SystemC model: card vs CPU plain path on the keyed source")
    sc_counted, sc_b6 = phase_systemc_card_vs_cpu(device)
    header(f"[25] NGDBFhw and SystemC paths: simulate at B={BATCH}")
    hw_paths = phase_hw_paths(device, path, time_ms)
    header("[26] sweep CLI, the ngdbfhw route")
    hw_sweep = phase_hw_sweep(device, 8192)
    header("[27] streams: card vs CPU plain path; B3/B4 per-lane draws")
    stream_counted, lanes = phase_streams_card_vs_cpu(device, path, time_ms)
    header(f"[28] stream paths at full width: {BATCH} lanes")
    stream_paths = phase_stream_paths(device)
    header("[29] sweep CLI, the --stream routes")
    stream_sweep = phase_stream_sweep(device, 8192)
    header("[30] NGDBFhw stream, ring draws and NB decoders: card vs CPU")
    hw_nb_counted, rings = phase_hw_nb_card_vs_cpu(device, path, time_ms)
    header(f"[31] NGDBFhw stream ({BATCH} lanes) and NB paths at full width")
    hw_stream = hw_stream_path(device, time_ms)
    nb = nb_paths(device, time_ms)
    header("[32] B2 at the NB and the new pools' shapes vs plain")
    b2_shapes = phase_b2_shapes(device, path, time_ms)
    header("[33] sweep CLI, ngdbfhw --stream and the nbqspa routes")
    hw_nb_sweep = phase_hw_nb_sweep(device)
    header(f"[34] replay and trace: batch {REPLAY_BATCH_INDEX} of {BATCH} "
           f"frames, three GDBF families, card and CPU")
    replay = phase_replay(qc, device, time_ms)
    header(f"[35] redecode_statistics: {REDECODE_FRAMES} frames x "
           f"{REDECODE_ATTEMPTS} attempts on {CODE}")
    redecode = phase_redecode(device, time_ms)
    header("[36] msg_trace card vs CPU, B1 at B=1, perf_report rows")
    tools36 = phase_tools_card(device, time_ms,
                               {"minsum": rate, "smngdbf": g_rate})
    header(f"[37] grid engine: one slot at [5]'s point, an SMNGDBF grid on "
           f"{GRID_SLOTS} slots of {device}")
    grid37 = phase_grid(qc, device, rate)
    header(f"[38] {CLUSTER_RANKS} gloo ranks on {device} against one "
           f"process")
    cluster38 = phase_cluster(device)
    header("[39] sweep --distributed routes; streams on a 2-slot mesh")
    dist39 = phase_distributed_sweep(qc, device)
    header(f"[40] the dense graph route: {HW_CODE} and {DENSE_GDBF_CODE} at "
           f"B={BATCH}, dense against the gathers")
    dense40 = phase_dense(device, time_ms)
    header("[41] the public surface: compare_decoders_torch, "
           "parse_alist_native")
    surface41 = phase_surface(device)
    header(f"[42] the stratified family: the 802.3an geometry at B={BATCH},"
           " stratified against the slot arrays")
    strat42 = phase_stratified(device, path, time_ms)
    torch.cuda.empty_cache()
    header(f"[43] B5 vs plain: four tables, {len(B5_PAIRS)} dtype pairs, "
           f"B={BATCH}, {BATCH + 2}, {ODD_BATCH} and 1")
    b5 = phase_b5(device, time_ms)
    header(f"[44] B6 and B7 vs plain at full width: the parity check on "
           f"every caller's table, the parallel GDBF step in every flag "
           f"combination")
    b6 = phase_b6(device, time_ms)
    b7 = phase_b7(device, time_ms)
    header("[45] the bit-flip decoder's chunk path against its per-step "
           "loop")
    chunks45 = phase_gdbf_chunks(qc, device)
    torch.cuda.empty_cache()
    header("[46] B8 vs plain: the sum-product check update in every form, "
           "and a T=20 decode")
    b8 = phase_b8(device, path, time_ms)
    torch.cuda.empty_cache()
    header("[47] B9 vs plain: the sum-product VN update in every form, and "
           "a T=20 decode")
    b9 = phase_b9(device, time_ms)
    torch.cuda.empty_cache()
    header("[48] B10 vs plain: the early-termination decision merge in "
           "every form, and one decode of each early-terminating cell")
    b10 = phase_et_merge(device, time_ms)
    torch.cuda.empty_cache()
    header("[49] B11 vs plain: the row-layered min-sum layer step in every "
           "form, and the layered cell's decode")
    b11 = phase_b11(device, time_ms)

    summary = {
        "card": card,
        "ber": stats.ber,
        "decoded_info_bits_per_s": rate,
        "breakdown_ms": parts,
        "smngdbf": {
            "ber": g_stats.ber, "fer": g_stats.fer,
            "avg_iterations": g_stats.avg_iterations,
            "frames": g_stats.total_words,
            "decoded_info_bits_per_s": g_rate,
            "breakdown_ms": g_parts,
        },
        "totals": {
            "minsum": (stats.errors, stats.word_errors,
                       stats.total_iterations),
            "smngdbf": (g_stats.errors, g_stats.word_errors,
                        g_stats.total_iterations),
        },
        "channel_form_ms": {"uniform_philox": b3_times[3],
                            "gauss_philox": b4_times[3]},
        "slot_array": {
            "code": PEG_CODE, "ber": p_stats.ber, "fer": p_stats.fer,
            "frames": p_stats.total_words,
            "decoded_info_bits_per_s": p_rate, "breakdown_ms": p_parts,
            "totals": (p_stats.errors, p_stats.word_errors,
                       p_stats.total_iterations),
        },
        "dvbs2": {"code": DVBS2_CODE, "ber": d_stats.ber, "fer": d_stats.fer,
                  "frames": d_stats.total_words,
                  "decoded_info_bits_per_s": d_rate,
                  "decode_ms": d_ms, "batch": DVBS2_POINT_BATCH,
                  "peak_gib": d_peak},
        "b1_forms": forms,
        "b1_layer_forms": layer_forms,
        "bp_card_vs_cpu": bp_seen,
        "new_paths": new_paths,
        "hw_paths": hw_paths,
        "stream_paths": stream_paths,
        "lanes_draws": lanes,
        "ngdbfhw_stream": hw_stream,
        "nb": nb,
        "ring_lanes": rings,
        "b2_shapes": b2_shapes,
        "replay": replay,
        "redecode": redecode,
        "tools": tools36,
        "grid": grid37,
        "cluster": cluster38,
        "distributed": dist39,
        "dense": dense40,
        "surface": surface41,
        "stratified": strat42,
        "b5": b5,
        "b6": b6,
        "b7": b7,
    }
    print(json.dumps(summary))
    print(card)
    # No PyTorch call computes B1-B4's functions (library_ms null); the
    # yardstick is PyTorch's own Philox draw of the same shape.
    batch1 = replay["batch1"]
    rows = [
        ("minsum_cn_scan", "minsum_cn_scan.cu", "minsum_pallas.py:60",
         launches["minsum_cn_scan"], max(b1_err, forms_err, layer_err,
                                         tools36["b1"]["max_abs_err"],
                                         strat42["b1"]["max_abs_err"]),
         None),
        ("awgn_philox", "awgn_philox.cu", "channel_pallas.py:56",
         launches["awgn_philox"],
         max(b2_err, batch1["awgn_philox"]["max_abs_err"],
             *(v["max_abs_err"] for v in b2_shapes.values())),
         f"torch.randn [{BATCH}, {n}]"),
        ("uniform_philox", "uniform_philox.cu", "channel_pallas.py:89",
         s_launches["uniform_philox"],
         max(b3_err, batch1["uniform_philox"]["max_abs_err"]),
         f"torch.rand [{n}, {BATCH}]"),
        ("gauss_philox", "uniform_philox.cu", "channel_pallas.py:114",
         g_launches["gauss_philox"],
         max(b4_err, batch1["gauss_philox"]["max_abs_err"],
             redecode["b4"]["max_abs_err"],
             *(v["max_abs_err"] for v in hw_paths["b4_shapes"].values())),
         f"torch.randn [{n}, {BATCH}]"),
    ]
    # B1's launches on each min-sum path of this run, and its other forms
    extra = {"minsum_cn_scan": {
        "launches_by_path": {"minsum qc [5]": launches["minsum_cn_scan"],
                             "slot-array [16]": p_launches["minsum_cn_scan"],
                             "dvbs2 [16]": d_launches["minsum_cn_scan"],
                             "sweep [17]": ms_launches["minsum_cn_scan"],
                             # the pair layers (DVB-S2); B11 takes the rest
                             **{f"layered [18] {k}": v["minsum_cn_scan"]
                                for k, v in layered_counted.items()
                                if "minsum_cn_scan" in v}},
        "forms": forms, "layer_forms": layer_forms},
        # B4's launches on each bit-flip path of this run, and its draws at
        # the hardware-model paths' shapes
        "gauss_philox": {
            "launches_by_path": {
                "smngdbf [10]": g_launches["gauss_philox"],
                **{f"ngdbfhw card vs cpu [23] {k}": v
                   for k, v in hw_counted.items()},
                **{f"systemc card vs cpu [24] {k}": v
                   for k, v in sc_counted.items()},
                "ngdbfhw [25]": hw_paths["ngdbfhw_highrate"]["launches"][
                    "gauss_philox"],
                "systemc [25]": hw_paths["systemc_peg"]["launches"][
                    "gauss_philox"],
                "ngdbfhw sweep [26]": hw_sweep["gauss_philox"]},
            "shapes": hw_paths["b4_shapes"]},
        # B2's launches on the paths of this slice ([31], [33]) and its
        # times at their shapes ([32])
        "awgn_philox": {
            "launches_by_path": {
                "minsum qc [5]": launches["awgn_philox"],
                "ngdbfhw stream [31]": hw_stream["launches"]["awgn_philox"],
                "nb stream [31]": nb["stream"]["launches"]["awgn_philox"],
                "nb batch [31]": nb["batch"]["launches"]["awgn_philox"],
                "ngdbfhw and nb sweeps [33]": hw_nb_sweep["awgn_philox"]},
            "shapes": b2_shapes}}
    # the tools' paths [34]-[36]: their launches and call shapes
    by_family = replay["launches"]
    extra["minsum_cn_scan"]["launches_by_path"].update({
        "msg_trace [36]": tools36["msg_trace_launches"]["minsum_cn_scan"],
        "perf_report [36]": tools36["perf_report_launches"][
            "minsum_cn_scan"]})
    extra["minsum_cn_scan"]["forms"]["msg_trace peg_1008_504 B=1 [36]"] = (
        tools36["b1"])
    extra["awgn_philox"]["launches_by_path"].update({
        **{f"replay [34] {k}": v["awgn_philox"]
           for k, v in by_family.items()},
        "redecode [35]": redecode["launches"]["awgn_philox"],
        "perf_report [36]": tools36["perf_report_launches"]["awgn_philox"]})
    extra["awgn_philox"]["shapes"]["batch 1 [34]"] = batch1["awgn_philox"]
    extra["uniform_philox"] = {
        "launches_by_path": {
            "gdbf sweep [11]": s_launches["uniform_philox"],
            **{f"replay [34] {k}": v["uniform_philox"]
               for k, v in by_family.items() if "uniform_philox" in v}},
        "shapes": {"batch 1 [34]": batch1["uniform_philox"]}}
    extra["gauss_philox"]["launches_by_path"].update({
        "replay [34] SMNGDBF": by_family["SMNGDBF"]["gauss_philox"],
        "redecode [35]": redecode["launches"]["gauss_philox"],
        "perf_report [36]": tools36["perf_report_launches"]["gauss_philox"]})
    extra["gauss_philox"]["shapes"].update({
        "batch 1 [34]": batch1["gauss_philox"],
        "redecode [1008 x F·NR] [35]": redecode["b4"]})
    # B1's and B4's launches on the stream paths [27]-[29]
    extra["minsum_cn_scan"]["launches_by_path"].update({
        **{f"stream card vs cpu [27] {k}": v.get("minsum_cn_scan", 0)
           for k, v in stream_counted.items()
           if "minsum" in k and not k.startswith("minsum layered")},
        "stream sweep [29]": stream_sweep["minsum_cn_scan"]})
    # The per-lane instances of B3/B4 (uniform_philox.cu's entries for the
    # stream's lanes): the same TPU kernels, a key per lane.  B4's runs on
    # the SMNGDBF stream path [28]; B3's on the --uniform-noise stream route
    # [29] and the stochastic stream [27].
    lane_rows = [
        ("uniform_philox_lanes", "channel_pallas.py:89",
         stream_sweep["uniform_philox_lanes"], {
             "stream sweep [29]": stream_sweep["uniform_philox_lanes"],
             "stochastic stream card vs cpu [27]": stream_counted[
                 "StochasticNGDBF"]["uniform_philox_lanes"]}),
        ("gauss_philox_lanes", "channel_pallas.py:114",
         stream_paths["smngdbf"]["launches"]["gauss_philox_lanes"], {
             "smngdbf stream [28]": stream_paths["smngdbf"]["launches"][
                 "gauss_philox_lanes"],
             **{f"stream card vs cpu [27] {k}": v["gauss_philox_lanes"]
                for k, v in stream_counted.items()
                if "gauss_philox_lanes" in v},
             # the NGDBFhw stream's rings: one launch per refill boundary
             "ngdbfhw stream [31]": hw_stream["launches"][
                 "gauss_philox_lanes"],
             **{f"ngdbfhw stream card vs cpu [30] {k}": v[
                 "gauss_philox_lanes"] for k, v in hw_nb_counted.items()},
             "ngdbfhw stream sweep [33]": hw_nb_sweep["gauss_philox_lanes"]}),
    ]
    # the multi-device paths [37]-[39]
    sweeps39 = dist39["sweeps"]
    extra["minsum_cn_scan"]["launches_by_path"].update({
        "grid one slot [37]": grid37["single"]["launches"]["minsum_cn_scan"],
        **{f"gloo rank {r} [38]": v.get("minsum_cn_scan", 0)
           for r, v in enumerate(cluster38["launches"])},
        "distributed sweep minsum [39]": sweeps39[
            "minsum_cn_scan minsum"],
        "stream mesh [39]": dist39["stream"].get("minsum_cn_scan", 0)})
    extra["awgn_philox"]["launches_by_path"].update({
        "grid one slot [37]": grid37["single"]["launches"]["awgn_philox"],
        "smngdbf grid [37]": grid37["grid"]["launches"]["awgn_philox"],
        **{f"gloo rank {r} [38]": v.get("awgn_philox", 0)
           for r, v in enumerate(cluster38["launches"])},
        **{f"distributed sweep {k.split(' ', 1)[1]} [39]": v
           for k, v in sweeps39.items() if k.startswith("awgn_philox")},
        "stream mesh [39]": dist39["stream"].get("awgn_philox", 0),
        "gdbf stream mesh [39]": dist39["gdbf_stream"].get("awgn_philox",
                                                           0)})
    extra["gauss_philox"]["launches_by_path"].update({
        "smngdbf grid [37]": grid37["grid"]["launches"]["gauss_philox"],
        **{f"distributed sweep {k.split(' ', 1)[1]} [39]": v
           for k, v in sweeps39.items() if k.startswith("gauss_philox ")}})
    extra["uniform_philox"]["launches_by_path"][
        "distributed sweep gdbf --uniform-noise [39]"] = sweeps39[
        "uniform_philox gdbf --uniform-noise"]
    for name, _, count, by_path in lane_rows:
        by_path["gdbf stream mesh [39]"] = dist39["gdbf_stream"].get(name, 0)
    # the dense route [40] and the example [41]
    extra["gauss_philox"]["launches_by_path"].update({
        "dense ngdbfhw decodes [40]": dense40["ngdbfhw"]["launches"][
            "gauss_philox"],
        "dense smngdbf decodes [40]": dense40["smngdbf"]["launches"][
            "gauss_philox"],
        "dense sweep ngdbfhw [40]": dense40["sweep"]["launches"].get(
            "gauss_philox", 0),
        "compare_decoders_torch [41]": surface41["launches"].get(
            "gauss_philox", 0)})
    extra["awgn_philox"]["launches_by_path"].update({
        "dense stream [40]": dense40["stream"]["launches"].get(
            "awgn_philox", 0),
        "dense ngdbfhw stream full width [40]": dense40["hw_stream"][
            "launches"].get("awgn_philox", 0),
        "dense gdbf stream full width [40]": dense40["gdbf_stream"][
            "launches"].get("awgn_philox", 0),
        "dense sweep ngdbfhw [40]": dense40["sweep"]["launches"].get(
            "awgn_philox", 0),
        "compare_decoders_torch [41]": surface41["launches"].get(
            "awgn_philox", 0)})
    extra["minsum_cn_scan"]["launches_by_path"][
        "compare_decoders_torch [41]"] = surface41["launches"].get(
        "minsum_cn_scan", 0)
    # the stratified family [42]: B1 on the stratified routing table
    by_path = extra["minsum_cn_scan"]["launches_by_path"]
    by_path["stratified min-sum B=32768 [42]"] = strat42["full_width"][
        "launches"]["minsum_cn_scan"]
    by_path.update({
        f"stratified card vs cpu {k} [42]": v
        for k, v in strat42["card_vs_cpu"]["b1_launches"].items()})
    by_path["stratified stream full width [42]"] = strat42["streams"][
        "minsum_stratified_stream"]["launches"]["minsum_cn_scan"]
    by_path.update({
        f"stratifiable alist sweep {k} [42]": v["launches"].get(
            "minsum_cn_scan", 0)
        for k, v in strat42["sweeps"].items() if "minsum" in k})
    check(all(v >= 1 for k, v in by_path.items()
              if k.startswith("stratifi")),
          f"B1 not launched on a stratified path: {by_path}")
    extra["minsum_cn_scan"]["forms"][
        "stratified 802.3an geometry f16 [42]"] = strat42["b1"]
    extra["awgn_philox"]["launches_by_path"].update({
        f"stratifiable alist sweep {k} [42]": v["launches"].get(
            "awgn_philox", 0)
        for k, v in strat42["sweeps"].items()})
    lane_rows[1][3].update({
        f"dense {label} [40]": dense40[k]["launches"].get(
            "gauss_philox_lanes", 0)
        for k, label in (("stream", "stream"),
                         ("hw_stream", "ngdbfhw stream full width"),
                         ("gdbf_stream", "gdbf stream full width"))})
    for name, _, count, by_path in lane_rows:
        check(count > 0, f"{name} not launched on its path")
    lanes["gauss_philox_lanes"]["max_abs_err"] = max(
        lanes["gauss_philox_lanes"]["max_abs_err"], rings["max_abs_err"])
    # B5: no Pallas original (the XLA fusion of the JAX QC step's VN side);
    # its launches on each flooding min-sum path of this run
    b5_main = b5["forms"][f"QC {CODE} B={BATCH} float16/float32"]
    b5_row = {
        "name": "minsum_vn_update", "route": "cuda",
        "source": "ldpcsimulation_tpu_torch/csrc/minsum_vn_update.cu",
        "replaces": "ldpcsimulation_tpu/decoders/minsum_qc.py:425",
        "pallas_original": None,
        "launches": launches["minsum_vn_update"],
        "max_abs_err": b5["max_abs_err"], "ms": b5_main["ms"],
        "plain_ms": b5_main["plain_ms"], "bound_ms": b5_main["bound_ms"],
        "bound_by": b5_main["bound_by"], "share": b5_main["share"],
        "library_ms": None,
        "launches_by_path": {
            "minsum qc [5]": launches["minsum_vn_update"],
            "slot-array [16]": p_launches["minsum_vn_update"],
            "dvbs2 [16]": d_launches["minsum_vn_update"],
            "sweep [17]": ms_launches["minsum_vn_update"],
            "flooding wifi [21]": new_paths["minsum_flooding_wifi"][
                "launches"].get("minsum_vn_update", 0),
            **{f"stream card vs cpu [27] {k}": v.get("minsum_vn_update", 0)
               for k, v in stream_counted.items() if "minsum" in k
               and "layered" not in k},
            "stream sweep [29]": stream_sweep.get("minsum_vn_update", 0),
            "msg_trace [36]": tools36["msg_trace_launches"][
                "minsum_vn_update"],
            "grid one slot [37]": grid37["single"]["launches"][
                "minsum_vn_update"],
            "stream mesh [39]": dist39["stream"].get("minsum_vn_update", 0),
            "compare_decoders_torch [41]": surface41["launches"].get(
                "minsum_vn_update", 0)},
        "forms": b5["forms"]}
    check(all(v >= 1 for k, v in b5_row["launches_by_path"].items()
              if "[41]" not in k),
          f"B5 not launched on a flooding min-sum path: "
          f"{b5_row['launches_by_path']}")
    # B6 and B7: no Pallas original (the XLA fusions of the JAX parity
    # checks and of the JAX bit-flip step's VN side); their launches on
    # each path of this run
    b6_main = b6["forms"][f"QC {CODE} check int32"]
    b6_row = {
        "name": "parity_check", "route": "cuda",
        "source": "ldpcsimulation_tpu_torch/csrc/parity_check.cu",
        "replaces": "ldpcsimulation_tpu/decoders/minsum_qc.py:383",
        "pallas_original": None,
        "launches": launches["parity_check"],
        "max_abs_err": b6["max_abs_err"], "ms": b6_main["ms"],
        "plain_ms": b6_main["plain_ms"], "bound_ms": b6_main["bound_ms"],
        "bound_by": b6_main["bound_by"], "share": b6_main["share"],
        "library_ms": None,
        "launches_by_path": {
            "minsum qc [5]": launches["parity_check"],
            "gdbf card vs cpu [9]": sum(
                v for k, v in gdbf9.items() if k.endswith("parity_check")),
            "smngdbf [10]": g_launches["parity_check"],
            "slot-array [16]": p_launches["parity_check"],
            "dvbs2 [16]": d_launches["parity_check"],
            "sweep [17]": ms_launches["parity_check"],
            **{f"layered [18] {k}": v for k, v in layered_b6.items()},
            "systemc card vs cpu [24]": sum(sc_b6.values()),
            "smngdbf stream card vs cpu [27]": stream_counted["SMNGDBF"][
                "parity_check"],
            "replay traces [34]": sum(
                v.get("parity_check", 0) for v in replay["traced"].values()),
            "grid one slot [37]": grid37["single"]["launches"][
                "parity_check"],
            "smngdbf grid [37]": grid37["grid"]["launches"]["parity_check"],
            "stratified min-sum B=32768 [42]": strat42["full_width"][
                "launches"]["parity_check"]},
        "forms": b6["forms"]}
    b7_main = b7["forms"][
        f"{CODE} int8 B={BATCH} adapt=1 window=1 w=scalar pert=1"]
    b7_row = {
        "name": "gdbf_parallel_step", "route": "cuda",
        "source": "ldpcsimulation_tpu_torch/csrc/gdbf_step.cu",
        "replaces": "ldpcsimulation_tpu/decoders/gdbf.py:414",
        "pallas_original": None,
        "launches": g_launches["gdbf_parallel_step"],
        "max_abs_err": b7["max_abs_err"], "ms": b7_main["ms"],
        "plain_ms": b7_main["plain_ms"], "bound_ms": b7_main["bound_ms"],
        "bound_by": b7_main["bound_by"], "share": b7_main["share"],
        "library_ms": None,
        "launches_by_path": {
            "smngdbf [10]": g_launches["gdbf_parallel_step"],
            "gdbf card vs cpu [9]": sum(
                v for k, v in gdbf9.items()
                if k.endswith("gdbf_parallel_step")),
            "replay traces [34]": sum(
                v.get("gdbf_parallel_step", 0)
                for v in replay["traced"].values()),
            "smngdbf grid [37]": grid37["grid"]["launches"][
                "gdbf_parallel_step"]},
        "forms": b7["forms"], "chunk_path": chunks45}
    # B8: no Pallas original (the XLA fusion of the JAX QC decoder's check
    # update); its launches on the QC and slot-array BP paths of this run
    b8_main = b8["forms"][f"{CODE} B={BATCH} float16"]
    b8_row = {
        "name": "bp_cn_pair", "route": "cuda",
        "source": "ldpcsimulation_tpu_torch/csrc/bp_cn_pair.cu",
        "replaces": "ldpcsimulation_tpu/decoders/bp_qc.py:34",
        "pallas_original": None,
        "launches": new_paths["bp_qc"]["launches"]["bp_cn_pair"],
        "max_abs_err": b8["max_abs_err"], "ms": b8_main["ms"],
        "plain_ms": b8_main["plain_ms"], "bound_ms": b8_main["bound_ms"],
        "bound_by": b8_main["bound_by"], "share": b8_main["share"],
        "library_ms": None,
        "launches_by_path": {
            "bp_qc [21]": new_paths["bp_qc"]["launches"]["bp_cn_pair"],
            "bp_peg [21]": new_paths["bp_peg"]["launches"].get(
                "bp_cn_pair", 0),
            "decode_bp_qc [46]": b8["decode"]["launches"]["bp_cn_pair"]},
        "forms": b8["forms"]}
    # B9: no Pallas original (the XLA fusion of the JAX QC BP step's VN
    # side); its launches on the QC BP paths of this run
    b9_main = b9["forms"][f"{CODE} B={BATCH} float16/float32"]
    b9_row = {
        "name": "bp_vn_update", "route": "cuda",
        "source": "ldpcsimulation_tpu_torch/csrc/bp_vn_update.cu",
        "replaces": "ldpcsimulation_tpu/decoders/bp_qc.py:98-101",
        "pallas_original": None,
        "launches": new_paths["bp_qc"]["launches"]["bp_vn_update"],
        "max_abs_err": b9["max_abs_err"], "ms": b9_main["ms"],
        "plain_ms": b9_main["plain_ms"], "bound_ms": b9_main["bound_ms"],
        "bound_by": b9_main["bound_by"], "share": b9_main["share"],
        "library_ms": None,
        "launches_by_path": {
            "bp_qc [21]": new_paths["bp_qc"]["launches"]["bp_vn_update"],
            "stream sweep [29]": stream_sweep.get("bp_vn_update", 0),
            "decode_bp_qc [47]": b9["decode"]["launches"]["bp_vn_update"]},
        "forms": b9["forms"]}
    # B10: no Pallas original (the XLA fusion of the JAX loop body's
    # latch); its launches on the two early-terminating cells' decodes
    b10_main = b10["forms"][f"{DVBS2_CODE} B={DVBS2_BATCH}"]
    b10_row = {
        "name": "et_merge", "route": "cuda",
        "source": "ldpcsimulation_tpu_torch/csrc/et_merge.cu",
        "replaces": "ldpcsimulation_tpu/decoders/base.py:293-295",
        "pallas_original": None,
        "launches": b10["decodes"]["dvbs2-et50-1.6dB"]["launches"][
            "et_merge"],
        "max_abs_err": b10["max_abs_err"], "ms": b10_main["ms"],
        "plain_ms": b10_main["plain_ms"], "bound_ms": b10_main["bound_ms"],
        "bound_by": b10_main["bound_by"], "share": b10_main["share"],
        "library_ms": None,
        "launches_by_path": {
            f"{cell} [48]": v["launches"]["et_merge"]
            for cell, v in b10["decodes"].items()},
        "forms": b10["forms"]}
    # B11: no Pallas original (the XLA fusion of the JAX layered step); its
    # launches on the layered min-sum paths of this run
    b11_main = b11["forms"][f"{WIFI_CODE} B={BATCH} normalized float16"]
    b11_row = {
        "name": "minsum_layer_step", "route": "cuda",
        "source": "ldpcsimulation_tpu_torch/csrc/minsum_layer_step.cu",
        "replaces": "ldpcsimulation_tpu/decoders/minsum_layered.py:96-175",
        "pallas_original": None,
        "launches": b11["decode"]["launches"]["minsum_layer_step"],
        "max_abs_err": b11["max_abs_err"], "ms": b11_main["ms"],
        "plain_ms": b11_main["plain_ms"], "bound_ms": b11_main["bound_ms"],
        "bound_by": b11_main["bound_by"], "share": b11_main["share"],
        "library_ms": None,
        "launches_by_path": {
            **{f"layered [18] {k}": v["minsum_layer_step"]
               for k, v in layered_counted.items()},
            "layered [21]": new_paths["minsum_layered_wifi"]["launches"][
                "minsum_layer_step"],
            **{f"stream card vs cpu [27] {k}": v.get("minsum_layer_step", 0)
               for k, v in stream_counted.items()
               if k.startswith("minsum layered")},
            "layered stream [28]": stream_paths["minsum_layered_wifi"][
                "launches"]["minsum_layer_step"],
            "wifi-layered-et30-2.2dB [49]": b11["decode"]["launches"][
                "minsum_layer_step"]},
        "forms": b11["forms"]}
    for row in (b6_row, b7_row, b8_row, b9_row, b10_row, b11_row):
        check(all(v >= 1 for v in row["launches_by_path"].values()),
              f"{row['name']} not launched on a path: "
              f"{row['launches_by_path']}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"ldpcsimulation_tpu_torch/csrc/{src}",
         "replaces": f"ldpcsimulation_tpu/kernels/{tpu}",
         "launches": count, "max_abs_err": err,
         "ms": times[name][0], "plain_ms": times[name][1],
         "library_ms": None, "yardstick_ms": times[name][2],
         "yardstick": yard and f"{yard}, same work, not the same function",
         **bounds[name], **extra.get(name, {})}
        for name, src, tpu, count, err, yard in rows
    ] + [
        {"name": name, "route": "cuda",
         "source": "ldpcsimulation_tpu_torch/csrc/uniform_philox.cu",
         "replaces": f"ldpcsimulation_tpu/kernels/{tpu}",
         "launches": count, "library_ms": None,
         "launches_by_path": by_path, **lanes[name],
         **({"ring_shapes": rings["shapes"]}
            if name == "gauss_philox_lanes" else {})}
        for name, tpu, count, by_path in lane_rows
    ] + [b5_row, b6_row, b7_row, b8_row, b9_row, b10_row, b11_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cluster-worker"]:
        # one rank of [38], started by phase_cluster
        sys.exit(cluster_worker(int(sys.argv[2]), int(sys.argv[3]),
                                sys.argv[4], sys.argv[5]))
    sys.exit(main())
