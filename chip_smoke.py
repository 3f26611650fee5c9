#!/usr/bin/env python3
"""Drive godsp_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero and prints no
final line):

  1. the card: torch.cuda must be available; prints nvidia-smi's name and
     power limit and torch's device name;
  2. builds the CUDA kernels from godsp_tpu_torch/csrc (nvcc, sm_90a);
  3. holds each kernel (K1 fft_pow2, K2 ifft_pow2, K3 rfft_pow2, K4
     pwelch_power_partials, K5, K7 csd_power_partials and K8: the
     register-radix design of csrc/fft_regs.cuh, K9
     peel_rows_fused_split) against its plain
     PyTorch version run in float64 on the card, at main-path shapes: SNR >= 120 dB, and each
     launch count must rise; times kernel, plain version (float32) and,
     where one PyTorch call computes the same function, that call
     (library_ms, a yardstick the port never calls) with CUDA events
     (utils.metrics.time_ms: after a warm-up, the median of 5 blocks'
     means of 10 back-to-back calls),
     beside the bound (utils.metrics.bound_ms): the larger of the bytes
     the function must move over 3.35 TB/s and its float32 operations
     over 67 TFLOP/s (the H100 SXM's published peaks).  The STFT kernels (K5 stft_complex /
     stft_power / stft_mel, K6 istft_overlap_add) are held the same way
     at the shapes of phase 5, and at an odd hop with pad > nfft; K8
     outer_dft_split at every shape phase 6 gives it; K9
     peel_rows_fused_split at the last peel of each fused step of phase 6
     ((16, 128, 8192) forward, (128, 128, 1024) inverse with 1/2^24) and
     at (3, 128, 256), each timed beside the separate route it replaces
     (K8 then K1/K2 rows) and beside torch.fft of the flattened rows
     (K9 computes that one (128 n3)-point DFT); K7 at phase 7's
     shape (the whole recording at 1024/512), at the speech hop 160
     with nfft 1000 and pad 1024, and at pad 16384; K10 ring_halo at
     phase 8's chunk shape (exactly equal to its plain version) and K11
     pwelch_power_partials_halo at three shapes (one shard of phase 8's
     chunk reading its neighbour's head, the last shard reading an
     injected tail, and hop 160 with nfft 1000 and pad 1024); K4, K10 and
     K11 at phase 8's chunk shape, and K6 at its timed shape, also get
     their kernel-only device time from the profiler's events of the
     kernel (utils.profiling.trace_to), printed beside the events time; K12 copy_split equal to its plain
     version at 1024 x 16384 and at 7 x 4099 (the scalar tail), and K13
     gmm_floor against its float64 plain version at 1024 x 16384 and at
     n = 128, 8192 and 16384 (n1 = 1 .. 128) and torch.equal to
     gmm_floor_sync at each, both timed at 1024 x 16384;
     and the redesign lines (phase_fft_redesign): K1 at 16384 x 1024,
     65536 x 256, 4096 x 4096, 2048 x 8192 and 1024 x 16384, K2 and K3 at
     16384 x 1024, each >= 120 dB against float64 and timed by chain
     (utils.metrics.time_chain_diff) beside fft_pow2_radix2 (K1's radix-2
     first design; K3's with n/2 + 1 bins), torch.fft and the bound,
     one line a kernel and shape; then K5 (stft_complex / stft_power /
     stft_mel over the whole recording at nfft = pad = 1024, hops 256 /
     512 / 256, 80 mels) and K8 (outer_dft_split at every shape of
     phase 6's calls: 16 x (128, 8192), (1024, 16384) inverse, the two
     calls of 2^28 and of 2^26) the same way beside their radix-2 first
     designs (stft_radix2, outer_dft_radix2), torch.stft (complex mode)
     and K12's copy of the same planes (K8), each yardstick's chains a
     counted session of their own (the yardsticks' only launches); then
     K4 (16384 segments at 1024/512, beside pwfloor_loadonly, its load
     floor; the bench's 52,428 at hop 160; 16384 at pad 2048) and K7
     (the recording's length at 1024/512, and at hop 160 with nfft
     1000, pad 1024) the same way beside pwelch_radix2 and csd_radix2,
     and K4, K11 and pwelch_radix2 at the streaming chunk alone by the
     profiler's events, after the CTAs K4/K11 and K7 launch are held to
     the host's plan; then (phase_istft_peel_redesign) K9 at each
     K9_SHAPES entry beside peel_rows_radix2 (its first design), the
     separate route (K8 then K1/K2 on the same planes) and torch.fft, with
     its cluster size and L2 re-read factor, and K6 at each K6_SHAPES
     entry beside istft_radix2, by chain and alone, after K9's cluster
     plan and K6's CTA are held to the host's (gdsp_peel_rows_geometry,
     gdsp_istft_geometry), and the public istft's whole-signal margin
     after the window-energy division at nfft 1024, 2048 and 4096 (Hann,
     hop nfft/4; its first and last nfft samples and interior apart)
     beside istft_radix2's (istft_margins); then
     (phase_lane_cluster_redesign) gmm_concat at 16384 x 1024 and
     ls_full there and at 1001 x 512 on their thread-block clusters
     beside their first designs (gmm_concat_stream, ls_full_stream),
     torch.matmul / torch.fft.fft, K13 and the bound, by chain and alone,
     with the clusters and shared bytes of the plan, after the plan
     is held to the host's (gdsp_lane_cluster_geometry,
     cuda_probes.lane_cluster_plan); then (phase_i8_tf32_redesign)
     i8_concat and gmm_tf32 at 16384 x 1024, i8_concat on its cluster of
     slices with the int8 tables resident (torch.equal to i8full and to
     its first design i8_concat_stream) and gmm_tf32 on wgmma fed by TMA
     (its tensor cores chaining 4 k-steps; its dB against the
     TF32-rounded float64 plain version within 3 dB of its first design's
     in the same run), each by chain and alone beside its first design (a
     counted session of its own), its library call, i8full (for
     i8_concat) and the bound, with the plan's clusters (pairs of CTAs
     for gmm_tf32) and shared bytes, after both plans are held to the host's
     (gdsp_lane_cluster_geometry kind 2, gdsp_gmm_tf32_geometry); then
     (phase_floor_dot_redesign) K13 gmm_floor at 16384 x 1024 and 1024 x
     16384 on its persistent grid (8 x 4 register tiles, x through a TMA
     ring; torch.equal to its first design gmm_floor_sync) and i8_dot at
     both probes.int8.DOT_SHAPES on 32 x 32 tiles loaded in one round
     (torch.equal to the exact product and to its first design
     i8_dot_bytes), each by chain and alone beside its first design (a
     counted session of its own), its library call (torch.matmul of the
     complex64 slices, TF32 off; torch._int_mm, whose GEMM kernel alone
     is averaged as i8_dot's is) and the bound, after both plans are held
     to the host's (gdsp_gmm_floor_geometry, gdsp_i8_dot_geometry) and
     printed; then (phase_halo_slice8_redesign) K10 ring_halo at phase
     8's chunk, the blocks as coll.shard_time gives them (ring_plan's
     view route held), beside its table route ring_halo_table (a counted
     session of its own) and torch.stack of the same blocks' heads, by
     chain, by events and alone; and K14d's slice8_add at 16384 x 1024
     (every slice's loads first) beside its first design slice8_add_sync
     (a counted session of its own), torch.add, K12's copy and
     reshape_add, by chain and alone, both designs torch.equal to
     add_one_plain; K10's library call is that stack of heads in its
     row too; then (phase_hi_store_redesign) K14d's bd_hi at 16384 x 1024
     on wgmma fed by TMA (its plan held to the host's through
     gdsp_bd_hi_geometry; it and its first design bd_hi_sync >= 120 dB
     against the float64 plain version and against each other) beside
     bd_hi_sync (a counted session of its own), torch.matmul of the
     complex64 slices and F128 (TF32 off) and the bound, and K14c's
     slicestore (every slice's loads first, the walk slice8_add runs)
     beside its first design slicestore_sync (a counted session of its
     own), copy_, K12's copy and concatstore, both designs torch.equal to
     their input, each by chain and alone; then (phase_bd1_vdif_redesign)
     K14d's bd_tf32 on wgmma m64n128k8 fed by TMA and K14h's vdif a warp a
     row through a cp.async buffer (both plans held to the host's through
     gdsp_bd_tf32_geometry and gdsp_vdif_geometry): bd_tf32 and its first
     design bd_tf32_sync >= 120 dB against the TF32-rounded float64 plain
     version at 16384 x 1024 and 1001 x 2048, the identity and
     cyclic-shift tables exact, the TF32 flags untouched; vdif and vdif_sync
     >= 120 dB against float64 at 16384 x 1024, 1001 x 512 and once at n1 1
     and 2, the digit order exact; at 16384 x 1024 each beside its first
     design (a counted session of its own), its library call (torch.matmul
     with TF32 on for that call; torch.fft.fft(norm="ortho")), K12's copy
     and the bound, by chain and alone; then (phase_anat_staged_redesign)
     K14d's anat_full on bd_hi's walk, each 32-column k-box brought by TMA
     with its partner n / 2 columns away, half3's rounds and the row made
     once a stage by the CTA in shared memory and the split in registers
     (its plan held to the host's through
     gdsp_anat_full_geometry), and K14a's pwfloor_staged, K4's body with
     each tile's span staged once by a 1-D TMA copy (its CTA held to the
     host's through gdsp_pwfloor_staged_geometry): anat_full and its first
     design anat_full_sync >= 120 dB against float64 at 16384 x 1024, 1001
     x 2048 and once at n1 1 and 3; pwfloor_staged torch.equal to K4 at the
     same tiles and >= 120 dB against float64 at phase 12's two geometries,
     hop 160 over 52,428 segments and pad 4096 (the block route); anat_full
     at 16384 x 1024 beside anat_full_sync (a counted session of its own),
     K12's copy, the unfused route (half3, the row as torch's elementwise
     calls, bd_hi) and the bound, pwfloor_staged at the probe geometry and
     at hop 160 beside pwfloor_staged_radix2 (a counted session of its
     own), K4 and the bound, by chain and alone; then
     (phase_noframe_sdif_redesign) K14a's pwfloor_noframe, K4's body with
     each frame read from its row 16 bytes a lane, and K14i's sdif_peel,
     the seven stages in registers on K8's column tile with Tb from K8's
     tile table (its plan held to the host's through gdsp_sdif_geometry):
     pwfloor_noframe torch.equal to K4 on the flattened frames and >= 120
     dB against float64 at phase 12's two geometries, pad 4096 (the block
     route) and hop 160's 52,428 frames; sdif_peel and its first design
     sdif_peel_sync >= 120 dB against float64 at 2^24, (3, 128, 1000), m =
     1 and m = 33; pwfloor_noframe at the probe geometry and at 52,428
     frames beside pwfloor_noframe_radix2 (a counted session of its own),
     K4 on the samples the frames were cut from and the bound, sdif_peel
     at 2^24 beside sdif_peel_sync (a counted session), K8
     outer_dft_split(x, 128, 1) on the same planes, K12's copy and the
     bound, by chain and alone; then (phase_i8full_frameonly_redesign)
     K14g's i8full, digit warps and product warps overlapped on one CTA an
     SM with two digit buffers handed over on named barriers (its plan held
     to the host's through gdsp_i8full_geometry), and K14a's
     pwfloor_frameonly, K4's body without the transform: i8full
     torch.equal to i8full_plain, to i8_concat and to its first design
     i8full_sync at 16384 x 1024, 1001 x 512 and 33 x 384;
     pwfloor_frameonly and its first design pwfloor_frameonly_shared >= 120
     dB against float64 at phase 12's two geometries, pad 4096 and hop
     160's 52,428 segments; i8full at 16384 x 1024 beside i8full_sync (a
     counted session of its own), torch.matmul of the complex64 slices
     (TF32 off), i8mm, i8_concat and the bound, pwfloor_frameonly at the
     probe geometry and at 52,428 segments beside pwfloor_frameonly_shared
     (a counted session), pwfloor_loadonly, K4 and the bound, by chain and
     alone, with K4 less frameonly;
  4. the main path at real size: a seeded 10-minute 44.1 kHz 16-bit mono
     recording (26,460,000 samples) written with the port's WavWriter,
     then, after one warm-up call, one session through the public entry
     points with the launch counts zeroed just before it and read just
     after it, and per step:
       - wav_psd(..., device="cuda") at nfft 1024 / noverlap 512 (the
         fused route: K4 once per chunk, nothing else);
       - wav_psd at nfft 1000 / noverlap 500 (the unfused route: frames,
         Bluestein over K1 and K2);
       - fft_real, ifft and rfft_split of the recording's 1024-point
         frames (K1 real input, K2, K3);
     then, outside the counted session, each result is held against a
     float64 oracle of the same decoded samples built on the card from
     the plain transforms (>= 120 dB), and the 129-bin golden goes
     through the public pwelch;
  5. the STFT family on the same recording, after one warm-up pass, as
     one counted session of its own (counts zeroed before, read after):
       - spectrogram_from_wav at nfft 1024 / hop 512 (K5 power once);
       - stft of the decoded samples at nfft 1024 / hop 256 (K5 complex
         once: 103,356 frames x 513 bins);
       - mel_spectrogram, 80 mels at nfft 1024 / hop 256 (K5 mel once);
       - spectra_to_wav of that STFT in chunks of 4096 frames (K6 once a
         chunk);
       - griffin_lim of the first 60 s of its magnitude, 32 iterations,
         momentum 0.99 (K6 33 times, K5 complex 32 times);
     then each result is held against a float64 oracle built on the card
     from the plain functions (>= 120 dB; the written WAV over the whole
     signal and over its interior, see check_synthesis), the
     istft(stft(x)) round trip is held to x over the interior
     [nfft, L - nfft), and Griffin-Lim is held to its float64 plain route
     at n_iter 0 (>= 120 dB) and at n_iter 32 by spectral convergence
     (within 0.5 dB); prints each step's wall and Msamples/s;
  6. the FFT surface at full size, after one warm-up pass, as one counted
     session of its own, every step through the public entry points:
       - fft of 16 x 2^20 complex64 (the reference's 2^20 benchmark
         transform, fft_test.go:262-280, batched to 2^24 points): K8
         once, K1 once;
       - ifft of one 2^24-point signal: K8 once, K2 once;
       - fft of one 2^28-point signal, the top of the large plan (two K8
         calls, K1 once);
       - hilbert of the decoded recording as host data with no device
         (it lands on the card): Bluestein at pad 2^26, twice;
       - fftn of a 256 x 256 x 256 Matrix built from host data (BASELINE
         config 3): K1 once per axis;
     then each result is held against a float64 oracle built on the card
     from the plain functions (>= 120 dB), and each step's wall and
     Msamples/s is printed beside torch.fft's at the same shape; then,
     with fft.large.set_fuse_rows_enabled(True) (restored in a finally),
     the first three steps again as a counted sub-session of their own:
     16 x 2^20 -> K9 once and nothing else, 2^24 inverse -> K8 once and
     K9 once, 2^28 (which does not fuse) -> two K8 calls and K1 once, its
     result torch.equal to the unfused run; the others >= 120 dB against
     the float64 oracle and against the unfused route; the first two
     steps' device time by kernel under torch.profiler, fused and not;
  7. the scipy-convention spectra and the cross-spectra on a seeded
     10-minute 44.1 kHz PCM16 STEREO recording (channel 0 is phase 4's
     mix, channel 1 is 0.7 x channel 0 delayed by 37 samples plus
     independent noise), decoded with read_wav and split into (L, 2),
     after one warm-up pass, as one counted session:
       - welch of both channels (axis 0) at 1024/512 without detrend (K4
         once), with the default constant detrend and with the median
         (the unfused route: K1 once each);
       - welch_csd and welch_coherence of the two channels (K7 once; K4
         twice and K7 once);
       - csd and coherence in the reference's conventions at nfft 1024,
         noverlap 864, the speech hop 160 (K7 once; K7 once, K4 twice);
       - spectrogram_scipy of channel 0 (K5 power once);
       - stream_welch over read_wav(...).blocks(2^20) of the mono
         recording (K4 once a chunk);
       - lombscargle of 65,536 seeded uneven times x 2,048 frequencies
         (no kernel: float32 trig and row sums);
     then the scipy-convention results are held against scipy.signal in
     float64 on the host on the same decoded samples, csd/coherence
     against a float64 oracle of the reference formula built on the card
     from the plain functions (all >= 120 dB), and lombscargle against
     its own float64 run on the CPU at the bound lomb_bound_db states;
     prints each step's wall and Msamples/s;
  8. the mesh-sharded paths at real size on meshes of eight shards that
     all sit on the card (eight shards on one card measure the overhead
     of sharding, not scaling), after one warm-up pass, as one counted
     session: wav_psd over a (dp=1, sp=8) mesh (the default ppermute
     halo: K4 once a shard a chunk); stream_pwelch over read_wav blocks
     with halo_impl ("pallas", False) (K10 once a chunk, K4 once a shard a
     chunk) and ("fused", False) (K11 once a shard a chunk, nothing
     else); pwelch_sharded of the decoded recording cut to 26,456,064
     samples under the three routes; the stereo recording through
     StreamingPwelch(channels=2) on a (dp=2, sp=4) mesh, fused route;
     spectrogram_sharded at 1024/256 (K5 power once a shard);
     istft_sharded of the port's stft of the cut recording, 103,336
     frames (K6 once a shard); fft_sharded of one 2^24-point complex64
     signal (local 2^21: K8 and K1 once a shard), then its inverse (K8
     and K2 once a shard); each result is then held against a float64
     oracle built on the card from the plain functions (>= 120 dB) and
     against the same entry without a mesh on the card (>= 120 dB, the
     measured agreement printed), and the streams' walls and Msamples/s
     are printed beside the one-device runs;
  9. the port's bench (godsp_tpu_torch/bench.py), its core cells as one
     counted session: fft1024_precise (K1 with K12 and K13 in the same
     rep), fft 4096/8192/16384, rfft1024, torch_fft1024, fft_2pow20 and
     the three pwelch rows; every cell >= 120 dB against its float64
     oracle, the copy ceiling and gmm floor fractions printed, and the
     summary line parsed and held to 1,800 characters;
 10. the rest of the FFT surface on the same recording, after one warm-up
     pass, as one counted session: dct (type 2, ortho) of its 1024-point
     frames (K1 once) and idct of that (K2 once); dctn of a seeded
     2048 x 2048 image (K1 once per axis); mfcc with 13 coefficients,
     nfft 1024, hop 256, 80 mels (K5 mel once, then the 80-point DCT as
     Bluestein at pad 256: K1 and K2 once); zoom_fft of its first 2^20
     samples, 8192 bins over 0-4 kHz (the chirp filter at pad 2^21: the
     large plan, K8 twice, K1 and K2 once); fht of 2^16 log-spaced points
     (rfft and irfft of 2^16: K8 twice, K1 and K2 once); ShortTimeFFT
     (periodic hann 1024, hop 256) stft (K1 once) and istft (K2 once) of
     the recording; then each result is held against scipy in float64 on
     the host on the same float32 inputs, >= 120 dB (mfcc: scipy's ortho
     DCT-II of a float64 log-mel that the port's own plain functions build
     on the card, so scipy checks only the DCT step there; mfcc's whole
     parity comes from tests/test_torch_mel.py against godsp_tpu);
 11. the filtering, design and LTI path on the same recording, after one
     warm-up pass, as one counted session: sosfilt and sosfiltfilt with
     butter(8, 4 kHz) in sections and lfilter with butter(4, 1 kHz) in
     (b, a) form over all 26,460,000 samples (blocked matmuls and
     log-depth scans in torch, TF32 off: no kernel of this library);
     fir_filter and fftconvolve(mode="same") with firwin(255, 4 kHz)
     (full length 26,460,254: pad 2^25, the large plan, K8 three times,
     K1 twice, K2 once); overlap_save with the same taps (4096-point
     blocks: K1 twice, K2 once); decimate by 4 (cheby1 8, sosfiltfilt);
     resample_poly of the first 10 s from 44.1 to 16 kHz (160/441: the
     zero-stuffed 70,560,000 samples and 8,821 taps at pad 2^27, K8 six
     times, K1 twice, K2 once); lsim of the analog butter(4, 2 pi 1 kHz)
     in a frequency-scaled state space (lti_system says why) over the
     first 44,100 samples, dt = 1/44100, and dlsim of its zoh
     discretization; each step's wall and Msamples/s printed; then each
     result held against scipy.signal in float64 on the host on the same
     float32 input (>= 120 dB);
 12. K14a, the fused-Welch floor twins (ops/cuda_probes.py; frameonly,
     noframe and staged the redesigns): each held
     against its plain version on the card (loadonly and frameonly
     against float64, noframe against the float64 rfft -> |X|^2 ->
     masked sum, staged against K4 on the same samples, torch.equal to
     it, and against float64), >= 120 dB, at the probe's geometry (16384
     segments, nfft = pad = 1024, hop 512) and at a ragged one; each timed there beside
     its plain version and bound; then the probe
     (godsp_tpu_torch.probes.pwfloor.run) at its full geometry as one
     counted session: loadonly, frameonly, noframe, staged, K4 and K3,
     each beside K12's copy ceiling of the bytes it reads;
 13. the signal toolkit at full width on the same recording and a seeded
     2048 x 2048 float32 image (three plane waves plus noise), after one
     warm-up pass, as one counted session: savgol_filter(101, 3) of all
     26,460,000 samples in interp and mirror mode (pad 2^25: the large
     plan), cwt of the first 10 s over ricker widths 1..64 (nfft 2^19,
     batch 64), find_peaks (host work), find_peaks_cwt of the first 1 s
     over widths 1..32, convolve2d/correlate2d/boundary='symm' with a
     31 x 31 Gaussian (pad 4096^2: K1 over rows and columns of both
     operands, K2 over both axes), wiener, medfilt2d, hilbert2, sepfir2d
     with 31-tap rows and columns, cspline2d, spline_filter, and the 1-D
     splines of the first 10 s (Bluestein at 2^20); exact launch counts a
     step (TOOLKIT_LAUNCHES); each result held against scipy in float64 on
     the host (cwt: per-row np.convolve; the splines, sepfir2d and
     find_peaks_cwt: the port's own float64 route on the host, as scipy
     truncates its splines) at >= 120 dB, medfilt2d and find_peaks equal,
     wiener at its derived float32 bound (wiener_bound_db);
 14. K14b fac_dft and K14c slicestore/concatstore/gmm_concat
     (ops/cuda_probes.py) against their plain versions on the card at
     16384 x 1024 and at 1001 x 2048 (fac_dft and gmm_concat >= 120 dB
     against float64, gmm_concat torch.equal to K13, the copies
     torch.equal to their input), each timed at 16384 x 1024 beside its
     plain version, bound and library call; then probes.facdft.run and
     probes.store.run (with K14g's i8_concat row) as two counted sessions;
 15. K14d, the anatomy twins (ops/cuda_probes.py: half3, slice8_add,
     reshape_add, bd_tf32, bd_hi, anat_full; the redesigns where a twin
     was redesigned) against their plain versions
     on the card at 16384 x 1024 and at 1001 x 2048 through
     probes.anatomy2.check_numerics, one launch a twin: half3 and the adds
     torch.equal to their float32 plain versions; bd_hi and anat_full
     >= 120 dB against float64; bd_tf32 >= 120 dB against its plain
     version with TF32-rounded operands summed in float64 (its dB against
     the exact product printed); bd_tf32 with an identity table equal to
     round_tf32(x) and with a cyclic shift equal to the rolled slices
     (the mma fragment maps); each timed at 16384 x 1024 beside its plain
     version, bound and library call, anat_full also beside the unfused
     route (half3, the row, bd_hi: separate_route_ms);
 16. probes.anatomy2.run at its full shape as one counted session: the six
     twins, copy_split (its copy row) and fft_pow2 (its K1 row) launched,
     nothing else;
 17. K14h vdif and K14i sdif_peel (ops/cuda_probes.py; both the
     redesigns) against their
     float64 plain versions on the card (>= 120 dB), one launch a check:
     vdif at 16384 x 1024 (n1 8, scale 1/32) and at a ragged 1001 x 512
     (n1 4), its digit order exact at both (single exponentials peak at
     (k mod n1) 128 + brev7(k // n1)); sdif_peel at 2^24 as
     (1, 128, 131072) and at a ragged (3, 128, 1000); each timed at the
     full shape beside its plain version, bound and library call
     (sdif_peel also beside K8 on the same planes: separate_route_ms);
 18. probes.vdif.run and probes.sdif.run at their full shapes as two
     counted sessions: vdif, copy_split, fac_dft and fft_pow2; sdif_peel,
     copy_split and outer_dft_split; nothing else;
 19. K14e lane_flip and K14f ls_network, gmm_tf32, ls_full and
     fft_pow2_rows (ops/cuda_probes.py) on the card, at 16384 x 1024 and
     at the ragged 1001 x 1024 and 1001 x 512 (n1 4): probes.r3's and
     probes.r4's check_numerics, their launches counted (ls_network and
     ls_full >= 120 dB against float64, gmm_tf32 >= 120 dB against its
     TF32-rounded float64 plain version, its dB against the exact product
     printed, every ls_full setting (store, chunks, rows a block)
     torch.equal to the default launch; lane_flip exact on the TPU probe's
     (8, 128) input and on the plane viewed as rows of 128); gmm_tf32
     exact on identity and cyclic-shift tables (the mma fragment maps);
     fft_pow2_rows >= 120 dB against K1's float64 plain version and
     torch.equal to K1 at 1 .. 16 rows a block there and at every setting
     of the sweep's 4096 x 4096, 2048 x 8192 and 1024 x 16384; each timed
     at 16384 x 1024 beside its plain version, bound and library call;
 20. probes.r4.run and probes.r3.run at their full shapes as two counted
     sessions: lane_flip, rfft_pow2, copy_split, fft_pow2_rows, fft_pow2
     and fft_pow2_radix2; ls_network, gmm_tf32, ls_full, copy_split,
     slicestore, gmm_floor, fft_pow2, fft_pow2_rows and fft_pow2_radix2;
     nothing else (the sweep times K1 at each rows a CTA beside its
     radix-2 first design);
 21. K14g i8_dot, i8mm, i8dec, i8full and i8_concat (ops/cuda_probes.py;
     i8_dot, i8full and i8_concat the redesigns) on the card at 16384 x
     1024 and at the ragged 1001 x 1024 and 1001 x 512 (n1 4):
     probes.int8's check_numerics and fragment_maps, their launches
     counted (i8_dot exact at (256, 128) @ (128, 128) and (1001, 128) @
     (128, 384); i8mm torch.equal to its plain version, which does
     the same integer arithmetic; i8dec, i8full and i8_concat equal to
     theirs or >= 120 dB; i8full equal to i8_concat; i8full's dB against
     the float64 product printed, the scheme's ~120, not gated; i8mm and
     i8dec exact on identity and cyclic-shift digit tables); each timed at
     16384 x 1024 (i8_dot at (256, 128) @ (128, 128)) beside its plain
     version, bound and library call, i8_dot and torch._int_mm also alone
     (the profiler's events of each call's device work);
 22. probes.int8.run at its full shape as one counted session: the five
     K14g wrappers, copy_split and gmm_floor; nothing else;
 23. prints {"kernels": [...]} (66 wrappers) and, last, {"ok": true,
     "device": {...}}.

Imports nothing of JAX.  Needs one card; stops nothing it did not start
(nvidia-smi runs to completion).
"""

from __future__ import annotations

import ast
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from godsp_tpu_torch.utils.metrics import bound_ms, fft_flops, rfft_flops, time_ms
from godsp_tpu_torch.utils.profiling import trace_to

SNR_DB = 120.0  # every kernel and the main path vs their float64 references
FS = 44100
SECONDS = 600
WELCH = dict(nfft=1024, noverlap=512)
WELCH_UNFUSED = dict(nfft=1000, noverlap=500)
PLANE = 1 << 24  # points per plane in the FFT kernel checks
# Steps of the counted main-path session (phase 4).
FUSED = "wav_psd(nfft=1024, noverlap=512)"
UNFUSED = "wav_psd(nfft=1000, noverlap=500)"
FFT_API = "fft_real/ifft/rfft_split(frames)"

# Steps of the counted STFT-family session (phase 5).
NFFT = 1024
SPECGRAM = "spectrogram_from_wav(nfft=1024, hop=512)"
STFT = "stft(nfft=1024, hop=256)"
MEL = "mel_spectrogram(n_mels=80, nfft=1024, hop=256)"
SYNTH = "spectra_to_wav(chunks of 4096 frames)"
GRIFFIN = "griffin_lim(60 s, n_iter=32, momentum=0.99)"
CHUNK = 4096  # frames per spectra_to_wav chunk
GL_ITERS = 32
GL_SECONDS = 60
GL_SC_DB = 0.5  # kernel vs float64 spectral convergence, dB apart at most

# Steps of the counted FFT-surface session (phase 6), and their sizes.
B20, N20, N24, N28, CUBE = 16, 1 << 20, 1 << 24, 1 << 28, 256
FFT20 = "fft(16 x 2^20 complex64)"
IFFT24 = "ifft(2^24)"
FFT28 = "fft(2^28)"
HILBERT = "hilbert(recording, 26,460,000, host data)"
FFTN = "fftn(Matrix 256^3, host data)"
# The counted sub-session of phase 6 with the fused peel + rows route on.
F_FFT20, F_IFFT24, F_FFT28 = (f"fused: {label}" for label in (FFT20, IFFT24, FFT28))
# K9 at the last peel of each fused step, and its smallest row (phase 3):
# (batch, n3, inverse, scale).
K9_SHAPES = ((B20, N20 // 128, False, 1.0), (128, N24 // 128 // 128, True, 1.0 / N24),
             (3, 256, False, 1.0))
# K6 at a spectra_to_wav chunk, at the Griffin-Lim shape (60 s) and at an
# odd hop with pad > nfft (phase 3): (frames, hop, pad), nfft = NFFT.
K6_SHAPES = ((CHUNK, 256, NFFT), ((FS * GL_SECONDS - NFFT) // 256 + 1, 256, NFFT),
             (CHUNK, 160, 2048))

# K6's whole-signal margins after the window-energy division (phase 3).
ISTFT_NFFTS = (1024, 2048, 4096)
EDGE_SECONDS = 10

# Steps of the counted session of the rest of the FFT surface (phase 10).
DCT = "dct(1024-point frames, type 2, ortho)"
IDCT = "idct(those spectra, type 2, ortho)"
DCTN = "dctn(2048 x 2048 image)"
MFCC = "mfcc(n_mfcc=13, nfft=1024, hop=256, n_mels=80)"
ZOOM = "zoom_fft(2^20 samples, 8192 bins over 0-4 kHz)"
FHT = "fht(2^16 log-spaced points, mu 0.5)"
STFFT = "ShortTimeFFT(hann 1024, hop 256).stft"
ISTFFT = "ShortTimeFFT(hann 1024, hop 256).istft"
IMAGE, ZOOM_N, ZOOM_M, ZOOM_BAND, FHT_N = 2048, 1 << 20, 8192, (0.0, 4000.0), 1 << 16

# Steps of the counted scipy-spectra session (phase 7), and their sizes.
W_FUSED = "welch(stereo, 1024/512, detrend=False, axis=0)"
W_CONST = "welch(stereo, 1024/512, detrend='constant', axis=0)"
W_MEDIAN = "welch(stereo, 1024/512, average='median', detrend=False)"
W_CSD = "welch_csd(ch0, ch1, nperseg=1024, detrend=False)"
W_COH = "welch_coherence(ch0, ch1, nperseg=1024, detrend=False)"
CSD160 = "csd(ch0, ch1, nfft=1024, noverlap=864)"
COH160 = "coherence(ch0, ch1, nfft=1024, noverlap=864)"
SPEC_SCIPY = "spectrogram_scipy(ch0, nperseg=1024, detrend=False)"
STREAM_WELCH = "stream_welch(mono, blocks of 2^20, nperseg=1024)"
LOMB = "lombscargle(65,536 uneven times x 2,048 frequencies)"
LOMB_N, LOMB_F, LOMB_FMAX = 1 << 16, 2048, 1000.0  # samples over 1 s, frequencies to 1 kHz
DELAY = 37  # samples between the stereo channels

# Steps of the counted mesh session (phase 8), on meshes of eight shards
# that all sit on the card.
SP, SEGS = 8, 256  # shards on "sp"; StreamingPwelch's default segments a shard a chunk
M_WAV = "mesh: wav_psd(1024/512, sp=8, ppermute)"
M_PALLAS = "mesh: stream_pwelch(blocks of 2^20, sp=8, pallas)"
M_FUSED = "mesh: stream_pwelch(blocks of 2^20, sp=8, fused)"
M_SHARDED = {r: f"mesh: pwelch_sharded(26,456,064, sp=8, {r})"
             for r in ("ppermute", "pallas", "fused")}
M_STEREO = "mesh: StreamingPwelch(stereo, channels=2, dp=2 x sp=4, fused)"
M_SPEC = "mesh: spectrogram_sharded(1024/256, sp=8)"
M_ISTFT = "mesh: istft_sharded(103,336 frames, 1024/256, sp=8)"
M_FFT = "mesh: fft_sharded(2^24 complex64, sp=8)"
M_IFFT = "mesh: fft_sharded(inverse=True) / 2^24"

# The counted bench session (phase 9): the port's bench, its core cells.
BENCH = "bench: core cells (fft1024 + K12/K13 reps, fft sizes, rfft, torch.fft, 2^20, pwelch)"

# Steps of the counted filtering session (phase 11), and their sizes.
SOSFILT = "sosfilt(butter(8, 4 kHz) sos, recording)"
SOSFILTFILT = "sosfiltfilt(butter(8, 4 kHz) sos, recording)"
LFILTER = "lfilter(butter(4, 1 kHz) b/a, recording)"
FIR = "fir_filter(recording, firwin(255, 4 kHz))"
FFTCONV = "fftconvolve(recording, firwin(255, 4 kHz), 'same')"
OLS = "overlap_save(recording, firwin(255, 4 kHz))"
DECIMATE = "decimate(recording, 4)"
RESAMPLE = "resample_poly(first 10 s, 160, 441)"
LSIM = "lsim(analog butter(4, 2 pi 1 kHz) state space, first 44,100 samples)"
DLSIM = "dlsim(its zoh discretization, first 44,100 samples)"
RESAMPLE_N, LSIM_N, FIR_TAPS = FS * 10, FS, 255

# The counted probe session (phase 12): probes.pwfloor at its geometry.
PWFLOOR = "probes.pwfloor.run (16384 segments, nfft = pad = 1024, hop 512)"

# Steps of the counted toolkit session (phase 13), and their sizes.
SG_INTERP = "savgol_filter(recording, 101, 3, interp)"
SG_MIRROR = "savgol_filter(recording, 101, 3, mirror)"
CWT = "cwt(first 10 s, ricker, widths 1..64)"
PEAKS = "find_peaks(recording, height 0.75, distance 441, prominence 0.5, wlen 441)"
PEAKS_CWT = "find_peaks_cwt(first 1 s, widths 1..32)"
CONV2 = "convolve2d(image, 31 x 31 gaussian, same)"
CORR2 = "correlate2d(image, 31 x 31 gaussian, valid)"
CONV2_SYMM = "convolve2d(image, 31 x 31 gaussian, same, boundary=symm)"
WIENER2 = "wiener(image, 5)"
MEDFILT2 = "medfilt2d(image, 5)"
HILBERT2 = "hilbert2(image)"
SEPFIR = "sepfir2d(image, 31-tap rows, 31-tap columns)"
CSPLINE2 = "cspline2d(image)"
SPLINE_FILTER = "spline_filter(image, 5.0)"
CSPLINE1 = "cspline1d(first 10 s)"
CSPLINE1_EVAL = "cspline1d_eval(those coefficients, 441,000 points)"
SYMIIR1 = "symiirorder1(first 10 s, c0 0.25, z1 0.5)"
SYMIIR2 = "symiirorder2(first 10 s, r 0.5, omega pi/8)"
TK_IMAGE, TK_SECONDS, TK_WIDTHS, TK_PEAK_WIDTHS, TK_TAPS = 2048, 10, 64, 32, 31

# The counted lane-probe sessions (phase 14): probes.facdft and probes.store.
FACDFT = "probes.facdft.run (16384 x 1024)"
STORE = "probes.store.run (16384 x 1024)"
LANE_B, LANE_N = 16384, 1024
# The anatomy twins (phases 15-16): probes.anatomy2.
ANATOMY = "probes.anatomy2.run (16384 x 1024)"
ANATOMY_TWINS = ("half3", "slice8_add", "reshape_add", "bd_tf32", "bd_hi", "anat_full")
# The counted butterfly-probe sessions (phase 18): probes.vdif and probes.sdif.
VDIF = "probes.vdif.run (16384 x 1024)"
SDIF = "probes.sdif.run (1 x 128 x 131072)"
# K14e and K14f (phases 19-20): probes.r4 and probes.r3.
R4 = "probes.r4.run (16384 x 1024; K1 at 2048 x 8192 and 1024 x 16384)"
R3 = "probes.r3.run (16384 x 1024; K1's rows-a-block sweep)"
LANE_SLICE_TWINS = ("ls_network", "gmm_tf32", "ls_full")
# K14g (phases 21-22): probes.int8.
INT8 = "probes.int8.run (16384 x 1024)"
INT8_TWINS = ("i8_dot", "i8mm", "i8dec", "i8full", "i8_concat")
# Phase 13's exact launches a step (worked out on the CPU with the wrappers
# counting and kernel_route patched; see the phase's comments).
_LARGE_CONV = {"outer_dft_split": 3, "fft_pow2": 2, "ifft_pow2": 1}
_CONV2 = {"fft_pow2": 4, "ifft_pow2": 2}
_BLUESTEIN_DCT = {"outer_dft_split": 4, "fft_pow2": 2, "ifft_pow2": 2}
TOOLKIT_LAUNCHES = {
    SG_INTERP: _LARGE_CONV, SG_MIRROR: _LARGE_CONV, CWT: _LARGE_CONV, PEAKS: {},
    PEAKS_CWT: _LARGE_CONV, CONV2: _CONV2, CORR2: _CONV2, CONV2_SYMM: _CONV2,
    WIENER2: {"fft_pow2": 8, "ifft_pow2": 4}, MEDFILT2: {},
    HILBERT2: {"fft_pow2": 2, "ifft_pow2": 2}, SEPFIR: _CONV2,
    CSPLINE2: {"fft_pow2": 2, "ifft_pow2": 2}, SPLINE_FILTER: {"fft_pow2": 6, "ifft_pow2": 4},
    CSPLINE1: _BLUESTEIN_DCT, CSPLINE1_EVAL: {}, SYMIIR1: _BLUESTEIN_DCT,
    SYMIIR2: _BLUESTEIN_DCT,
}

REPLACES = {
    "fft_pow2": "godsp_tpu/ops/pallas_fft.py:1125",
    "ifft_pow2": "godsp_tpu/ops/pallas_fft.py:1268",
    "rfft_pow2": "godsp_tpu/ops/pallas_fft.py:1466",
    "pwelch_power_partials": "godsp_tpu/ops/pallas_pwelch.py:483",
    "stft_complex": "godsp_tpu/ops/pallas_stft.py:150",
    "stft_power": "godsp_tpu/ops/pallas_stft.py:150",
    "stft_mel": "godsp_tpu/ops/pallas_stft.py:150",
    "istft_overlap_add": "godsp_tpu/ops/pallas_istft.py:167",
    "outer_dft_split": "godsp_tpu/ops/pallas_outer.py:245",
    "peel_rows_fused_split": "godsp_tpu/ops/pallas_outer.py:412",
    "csd_power_partials": "godsp_tpu/ops/pallas_csd.py:84",
    "ring_halo": "godsp_tpu/parallel/halo.py:63",
    "pwelch_power_partials_halo": "godsp_tpu/parallel/fused_halo.py:129",
    "copy_split": "godsp_tpu/utils/metrics.py:245",
    "gmm_floor": "godsp_tpu/utils/metrics.py:294",
    "pwfloor_loadonly": "tools/probe_pwfloor.py:189",
    "pwfloor_frameonly": "tools/probe_pwfloor.py:189",
    "pwfloor_noframe": "tools/probe_pwfloor.py:264",
    "pwfloor_staged": "tools/probe_pwfloor.py:229",
    "fac_dft": "tools/probe_facdft.py:175",
    "slicestore": "tools/probe_store.py:53",
    "concatstore": "tools/probe_store.py:53",
    "gmm_concat": "tools/probe_store.py:53",
    **{name: "tools/probe_anatomy2.py:87" for name in ANATOMY_TWINS},
    "vdif": "tools/probe_vdif.py:116",
    "sdif_peel": "tools/probe_sdif.py:116",
    **{name: "tools/probe_r3.py:157" for name in LANE_SLICE_TWINS},
    "lane_flip": "tools/probe_r4.py:67",
    "fft_pow2_rows": "godsp_tpu/ops/pallas_fft.py:1125",
    "fft_pow2_radix2": "godsp_tpu/ops/pallas_fft.py:1125",
    "stft_radix2": "godsp_tpu/ops/pallas_stft.py:150",
    "outer_dft_radix2": "godsp_tpu/ops/pallas_outer.py:245",
    "pwelch_radix2": "godsp_tpu/ops/pallas_pwelch.py:483",
    "csd_radix2": "godsp_tpu/ops/pallas_csd.py:84",
    "istft_radix2": "godsp_tpu/ops/pallas_istft.py:167",
    "peel_rows_radix2": "godsp_tpu/ops/pallas_outer.py:412",
    "i8_dot": "tools/probe_int8.py:213",
    "i8mm": "tools/probe_int8.py:71",
    "i8dec": "tools/probe_int8.py:71",
    "i8full": "tools/probe_int8.py:71",
    "i8_concat": "tools/probe_store.py:53",
    "gmm_concat_stream": "tools/probe_store.py:53",
    "ls_full_stream": "tools/probe_r3.py:157",
    "i8_concat_stream": "tools/probe_store.py:53",
    "gmm_tf32_sync": "tools/probe_r3.py:157",
    "gmm_floor_sync": "godsp_tpu/utils/metrics.py:294",
    "i8_dot_bytes": "tools/probe_int8.py:213",
    "ring_halo_table": "godsp_tpu/parallel/halo.py:63",
    "slice8_add_sync": "tools/probe_anatomy2.py:87",
    "bd_hi_sync": "tools/probe_anatomy2.py:87",
    "slicestore_sync": "tools/probe_store.py:53",
    "bd_tf32_sync": "tools/probe_anatomy2.py:87",
    "vdif_sync": "tools/probe_vdif.py:116",
    "anat_full_sync": "tools/probe_anatomy2.py:87",
    "pwfloor_staged_radix2": "tools/probe_pwfloor.py:229",
    "pwfloor_noframe_radix2": "tools/probe_pwfloor.py:264",
    "sdif_peel_sync": "tools/probe_sdif.py:116",
    "i8full_sync": "tools/probe_int8.py:71",
    "pwfloor_frameonly_shared": "tools/probe_pwfloor.py:189",
}
SOURCES = {
    "fft_pow2": "godsp_tpu_torch/csrc/fft_kernels.cu",
    "ifft_pow2": "godsp_tpu_torch/csrc/fft_kernels.cu",
    "rfft_pow2": "godsp_tpu_torch/csrc/fft_kernels.cu",
    "pwelch_power_partials": "godsp_tpu_torch/csrc/pwelch_kernel.cu",
    "stft_complex": "godsp_tpu_torch/csrc/stft_kernel.cu",
    "stft_power": "godsp_tpu_torch/csrc/stft_kernel.cu",
    "stft_mel": "godsp_tpu_torch/csrc/stft_kernel.cu",
    "istft_overlap_add": "godsp_tpu_torch/csrc/istft_kernel.cu",
    "outer_dft_split": "godsp_tpu_torch/csrc/outer_kernel.cu",
    "peel_rows_fused_split": "godsp_tpu_torch/csrc/peel_rows_kernel.cu",
    "csd_power_partials": "godsp_tpu_torch/csrc/csd_kernel.cu",
    "ring_halo": "godsp_tpu_torch/csrc/halo_kernel.cu",
    "pwelch_power_partials_halo": "godsp_tpu_torch/csrc/pwelch_kernel.cu",
    "copy_split": "godsp_tpu_torch/csrc/metrics_kernels.cu",
    "gmm_floor": "godsp_tpu_torch/csrc/metrics_kernels.cu",
    "pwfloor_loadonly": "godsp_tpu_torch/csrc/pwelch_probe_kernels.cu",
    "pwfloor_frameonly": "godsp_tpu_torch/csrc/pwelch_probe_kernels.cu",
    "pwfloor_noframe": "godsp_tpu_torch/csrc/pwelch_probe_kernels.cu",
    "pwfloor_staged": "godsp_tpu_torch/csrc/pwelch_probe_kernels.cu",
    "fac_dft": "godsp_tpu_torch/csrc/lane_probe_kernels.cu",
    "slicestore": "godsp_tpu_torch/csrc/lane_probe_kernels.cu",
    "concatstore": "godsp_tpu_torch/csrc/lane_probe_kernels.cu",
    "gmm_concat": "godsp_tpu_torch/csrc/lane_probe_kernels.cu",
    **{name: "godsp_tpu_torch/csrc/anatomy_probe_kernels.cu" for name in ANATOMY_TWINS},
    "vdif": "godsp_tpu_torch/csrc/dif_probe_kernels.cu",
    "sdif_peel": "godsp_tpu_torch/csrc/dif_probe_kernels.cu",
    **{name: "godsp_tpu_torch/csrc/lane_slice_probe_kernels.cu" for name in LANE_SLICE_TWINS},
    "lane_flip": "godsp_tpu_torch/csrc/lane_slice_probe_kernels.cu",
    "fft_pow2_rows": "godsp_tpu_torch/csrc/fft_kernels.cu",
    "fft_pow2_radix2": "godsp_tpu_torch/csrc/radix2_probe_kernels.cu",
    "stft_radix2": "godsp_tpu_torch/csrc/radix2_probe_kernels.cu",
    "outer_dft_radix2": "godsp_tpu_torch/csrc/radix2_probe_kernels.cu",
    "pwelch_radix2": "godsp_tpu_torch/csrc/radix2_probe_kernels.cu",
    "csd_radix2": "godsp_tpu_torch/csrc/radix2_probe_kernels.cu",
    "istft_radix2": "godsp_tpu_torch/csrc/radix2_probe_kernels.cu",
    "peel_rows_radix2": "godsp_tpu_torch/csrc/radix2_probe_kernels.cu",
    **{name: "godsp_tpu_torch/csrc/int8_probe_kernels.cu" for name in INT8_TWINS},
    "gmm_concat_stream": "godsp_tpu_torch/csrc/lane_probe_kernels.cu",
    "ls_full_stream": "godsp_tpu_torch/csrc/lane_slice_probe_kernels.cu",
    "i8_concat_stream": "godsp_tpu_torch/csrc/int8_probe_kernels.cu",
    "gmm_tf32_sync": "godsp_tpu_torch/csrc/lane_slice_probe_kernels.cu",
    "gmm_floor_sync": "godsp_tpu_torch/csrc/metrics_kernels.cu",
    "i8_dot_bytes": "godsp_tpu_torch/csrc/int8_probe_kernels.cu",
    "ring_halo_table": "godsp_tpu_torch/csrc/halo_kernel.cu",
    "slice8_add_sync": "godsp_tpu_torch/csrc/anatomy_probe_kernels.cu",
    "bd_hi_sync": "godsp_tpu_torch/csrc/anatomy_probe_kernels.cu",
    "slicestore_sync": "godsp_tpu_torch/csrc/lane_probe_kernels.cu",
    "bd_tf32_sync": "godsp_tpu_torch/csrc/anatomy_probe_kernels.cu",
    "vdif_sync": "godsp_tpu_torch/csrc/dif_probe_kernels.cu",
    "anat_full_sync": "godsp_tpu_torch/csrc/anatomy_probe_kernels.cu",
    "pwfloor_staged_radix2": "godsp_tpu_torch/csrc/pwelch_probe_kernels.cu",
    "pwfloor_noframe_radix2": "godsp_tpu_torch/csrc/pwelch_probe_kernels.cu",
    "sdif_peel_sync": "godsp_tpu_torch/csrc/dif_probe_kernels.cu",
    "i8full_sync": "godsp_tpu_torch/csrc/int8_probe_kernels.cu",
    "pwfloor_frameonly_shared": "godsp_tpu_torch/csrc/pwelch_probe_kernels.cu",
}


def log(*a):
    print(*a, flush=True)


def snr(got, want) -> float:
    from godsp_tpu_torch.dsputils import snr_db

    g, w = (t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t for t in (got, want))
    return snr_db(g, w)


def snr_on_card(got: torch.Tensor, want: torch.Tensor) -> float:
    """dsputils.snr_db's formula in float64 where the tensors lie (no copy
    of a 2^28-point result to the host)."""
    err = float((got.to(want.dtype) - want).abs().double().square().sum())
    sig = float(want.abs().double().square().sum())
    if err == 0.0:
        return float("inf")
    return float("-inf") if sig == 0.0 else 10.0 * np.log10(sig / err)


def cplx(planes):
    return planes[0].double() + 1j * planes[1].double()


def golden_pxx() -> np.ndarray:
    """The 129-bin go-dsp golden (pwelch_test.go:39-46), read from
    tests/test_spectral.py without importing it (that module imports jax)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "test_spectral.py")
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "GOLDEN_PXX":
            return np.asarray(ast.literal_eval(node.value), dtype=np.float64)
    raise LookupError("GOLDEN_PXX not found in tests/test_spectral.py")


def kernel_alone_ms(symbol: str, kernel, reps: int = 50):
    """(ms a launch of the CUDA kernel `symbol` by the profiler's events
    over reps calls of kernel(), or None where it recorded none; the
    profiler's rows with device time, for listing)."""
    kernel()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp, trace_to(tmp) as prof:
        for _ in range(reps):
            kernel()
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    own = [e for e in rows if symbol in e.key]
    if not own:
        return None, rows
    # The mean over the events the profiler kept (it may drop a few).
    return sum(e.self_device_time_total for e in own) / 1e3 / sum(e.count for e in own), rows


class KernelRecord:
    def __init__(self):
        self.err: dict[str, float] = {}
        self.times: dict[str, dict] = {}

    def time(self, name: str, shape: str, kernel, plain, library, nbytes: float,
             flops: float) -> None:
        """Time the kernel, its plain version and (when not None) the one
        PyTorch call computing the same function; the bound comes from
        the bytes and operations of these inputs."""
        b, by = bound_ms(nbytes, flops)
        self.times[name] = dict(ms=time_ms(kernel), plain_ms=time_ms(plain),
                                library_ms=None if library is None else time_ms(library),
                                bound_ms=b, bound_by=by, shape=shape)

    def device_time(self, name: str, symbol: str, kernel, reps: int = 50) -> None:
        """The kernel's own device time, ms a call: the profiler's events of
        the CUDA kernel `symbol` over reps calls of the wrapper, printed
        beside the events time, which at a small shape also holds the
        wrapper's host work.  The wrapper's other device work (fills,
        copies) is listed apart."""
        ms, rows = kernel_alone_ms(symbol, kernel, reps)
        t = self.times[name]
        t["kernel_device_ms"] = ms
        if ms is None:
            log(f"  {name:22s} device-only: not measured (no profiler event of {symbol})")
            return
        log(f"  {name:22s} device-only {ms:.4f} ms a launch (profiler events of {symbol}), "
            f"events {t['ms']:.4f} ms a call, at {t['shape']}")
        for e in rows:
            log(f"    {e.self_device_time_total / 1e3 / reps:.4f} ms x{e.count / reps:g} "
                f"{e.key[:80]}")

    def check(self, name: str, run, want, what: str) -> None:
        """Hold a float32 kernel result, run(), against its float64 plain
        version; run() must launch the kernel."""
        from godsp_tpu_torch.ops import launch_counts

        before = launch_counts()[name]
        got = run()
        if launch_counts()[name] <= before:
            raise AssertionError(f"{name} {what}: the kernel was not launched")
        db = snr(got, want)
        err = float((got.to(want.dtype) - want).abs().max())
        self.err[name] = max(self.err.get(name, 0.0), err)
        log(f"  {name:22s} {what:34s} snr {db:7.2f} dB  max_abs_err {err:.3e}")
        if not db >= SNR_DB:
            raise AssertionError(f"{name} {what}: {db:.2f} dB < {SNR_DB} dB")


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {smi}")
    name = torch.cuda.get_device_name(0)
    log(f"torch: {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from godsp_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)")


@contextlib.contextmanager
def plain_route():
    """Kernels off: the plain versions beneath the public entry points run
    on the card, in the dtype they are given (float64 for the oracles)."""
    from godsp_tpu_torch import fft

    fft.set_kernels_enabled(False)
    try:
        yield
    finally:
        fft.set_kernels_enabled(True)


def c128(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.complex128)


def phase_kernels(rec: KernelRecord, dev) -> None:
    from godsp_tpu_torch import window
    from godsp_tpu_torch.fft import convolve, fft
    from godsp_tpu_torch.fft.bluestein import bluestein_fft
    from godsp_tpu_torch.fft.pow2 import pow2_convolve
    from godsp_tpu_torch.ops import cuda_fft, cuda_pwelch

    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.float32)

    log("kernels vs their float64 plain versions on the card:")
    for n in (1024, 256, 4096, 16384):
        rows = PLANE // n
        xr, xi = rand(rows, n), rand(rows, n)
        xr64, xi64 = xr.double(), xi.double()
        shape = f"N={n} x {rows}"
        rec.check("fft_pow2", lambda: cplx(cuda_fft.fft_pow2(xr, xi)),
                  cplx(cuda_fft.fft_pow2_plain(xr64, xi64)), f"forward {shape}")
        rec.check("fft_pow2", lambda: cplx(cuda_fft.fft_pow2(xr, None)),
                  cplx(cuda_fft.fft_pow2_plain(xr64, None)), f"real input {shape}")
        rec.check("ifft_pow2", lambda: cplx(cuda_fft.ifft_pow2(xr, xi, 1.0 / n)),
                  cplx(cuda_fft.ifft_pow2_plain(xr64, xi64, 1.0 / n)), f"inverse 1/N {shape}")
        if n == 1024:
            z = torch.complex(xr, xi)
            moved = 16.0 * rows * n  # two float32 planes read, two written
            rec.time("fft_pow2", shape, lambda: cuda_fft.fft_pow2(xr, xi),
                     lambda: cuda_fft.fft_pow2_plain(xr, xi), lambda: torch.fft.fft(z),
                     moved, fft_flops(n, rows))
            rec.time("ifft_pow2", shape, lambda: cuda_fft.ifft_pow2(xr, xi, 1.0 / n),
                     lambda: cuda_fft.ifft_pow2_plain(xr, xi, 1.0 / n),
                     lambda: torch.fft.ifft(z), moved, fft_flops(n, rows) + 2.0 * rows * n)
            del z
        del xr, xi, xr64, xi64
    # K2 in its chains: Bluestein (forward K1, product, inverse K2) and convolve.
    for n in (1000, 1331):
        z = torch.complex(rand(512, n), rand(512, n))
        with plain_route():
            want = bluestein_fft(c128(z))
        rec.check("ifft_pow2", lambda: fft(z), want, f"Bluestein fft N={n} x 512")
    a = torch.complex(rand(256, 4096), rand(256, 4096))
    b = torch.complex(rand(256, 4096), rand(256, 4096))
    with plain_route():
        want = pow2_convolve(c128(a), c128(b), scale=1.0 / 4096)
    rec.check("ifft_pow2", lambda: convolve(a, b), want, "convolve N=4096 x 256")
    for n in (1024, 8192):
        rows = PLANE // n
        xr = rand(rows, n)
        shape = f"N={n} x {rows}"
        rec.check("rfft_pow2", lambda: cplx(cuda_fft.rfft_pow2(xr)),
                  cplx(cuda_fft.rfft_pow2_plain(xr.double())), f"one-sided {shape}")
        if n == 1024:
            rec.time("rfft_pow2", shape, lambda: cuda_fft.rfft_pow2(xr),
                     lambda: cuda_fft.rfft_pow2_plain(xr), lambda: torch.fft.rfft(xr),
                     4.0 * rows * n + 8.0 * rows * (n // 2 + 1), rfft_flops(n, rows))
        del xr
    # K4 at the streaming chunk (256 segments + halo), the whole recording,
    # hop 160, pad 2048 > nfft, and a ragged last tile (5001 segments at 10
    # a tile) with a partial mask.
    whole = (FS * SECONDS - 1024) // 512 + 1  # segments of the whole recording
    for nfft, stride, pad, S, keep in (
        (1024, 512, 1024, 256, 256),
        (1024, 512, 1024, whole, whole),
        (1024, 160, 1024, 4096, 4096),
        (1024, 512, 2048, 4096, 4096),
        (1024, 512, 1024, 5001, 4990),
    ):
        L = (S - 1) * stride + nfft
        ext = torch.rand(1, L, generator=g, device=dev) * 2 - 1  # [-1, 1), zero-mean like PCM16
        mask = (torch.arange(S, device=dev) < keep).float()[None]
        w = window.window_table("hann", pad, device=dev, dtype=torch.float32)
        bt = cuda_pwelch.segs_per_tile(S, 1)
        what = f"nfft {nfft} hop {stride} pad {pad} S {S} keep {keep}"
        want = cuda_pwelch.pwelch_power_partials_plain(ext.double(), mask.double(), w.double(),
                                                       nfft, stride, pad, bt)
        rec.check("pwelch_power_partials",
                  lambda: cuda_pwelch.pwelch_power_partials(ext, mask, w, nfft, stride, pad=pad),
                  want, what)
        if S == 256:
            # No one PyTorch call frames, windows, transforms and sums.
            tiles = -(-S // bt)
            rec.time("pwelch_power_partials", what,
                     lambda: cuda_pwelch.pwelch_power_partials(ext, mask, w, nfft, stride,
                                                               pad=pad),
                     lambda: cuda_pwelch.pwelch_power_partials_plain(ext, mask, w, nfft,
                                                                     stride, pad, bt),
                     None, 4.0 * (L + S + pad + tiles * (pad // 2 + 1)),
                     keep * (nfft + rfft_flops(pad) + 3.0 * (pad // 2 + 1)))
            rec.device_time("pwelch_power_partials", "pwelch_partials_kernel",
                            lambda: cuda_pwelch.pwelch_power_partials(ext, mask, w, nfft, stride,
                                                                      pad=pad))


# K1/K2/K3's register-radix design beside its radix-2 first design
# (fft_pow2_radix2), torch.fft and the bound, by chain: K1 at these shapes
# of 2^24 points, K2 and K3 at the first.
REDESIGN_SHAPES = ((16384, 1024), (65536, 256), (4096, 4096), (2048, 8192), (1024, 16384))


def phase_fft_redesign(rec: KernelRecord, dev) -> dict[str, dict[str, int]]:
    """Phase 3's redesign lines: at each shape of REDESIGN_SHAPES, K1 (and
    at 16384 x 1024 K2 and K3) held against its float64 plain version
    (>= 120 dB), then timed with utils.metrics.time_chain_diff beside
    fft_pow2_radix2 (K1's radix-2 first design, K3's with n/2 + 1
    bins stored), torch.fft (fft, ifft, rfft) and the bound; one line a
    kernel and shape.  fft_pow2_radix2 is checked and timed here for the
    kernels line (its launches come from phase 20's sweep).  Then K5's and
    K8's lines (phase_stft_outer_redesign), whose counted yardstick
    sessions it returns."""
    from godsp_tpu_torch.ops import cuda_fft, cuda_probes
    from godsp_tpu_torch.probes._common import chained
    from godsp_tpu_torch.utils.metrics import time_chain_diff

    def chain_ms(op, x):
        return time_chain_diff(chained(op), x) * 1e3

    g = torch.Generator(device=dev).manual_seed(3)
    log("K1/K2/K3 redesign vs the radix-2 first design, by chain:")
    for b, n in REDESIGN_SHAPES:
        xr = torch.randn(b, n, generator=g, device=dev)
        xi = torch.randn(b, n, generator=g, device=dev)
        x64 = (xr.double(), xi.double())
        z = torch.complex(xr, xi)
        shape = f"{b} x {n}"
        pts = float(b * n)
        rows = [("fft_pow2", lambda: cuda_fft.fft_pow2(xr, xi),
                 lambda: cuda_probes.fft_pow2_radix2(xr, xi), lambda: torch.fft.fft(z),
                 cuda_fft.fft_pow2_plain(*x64), 16.0 * pts, fft_flops(n, b))]
        if (b, n) == REDESIGN_SHAPES[0]:
            rows += [
                ("ifft_pow2", lambda: cuda_fft.ifft_pow2(xr, xi, 1.0 / n),
                 lambda: cuda_probes.fft_pow2_radix2(xr, xi, True, 1.0 / n),
                 lambda: torch.fft.ifft(z), cuda_fft.ifft_pow2_plain(*x64, 1.0 / n),
                 16.0 * pts, fft_flops(n, b) + 2.0 * pts),
                ("rfft_pow2", lambda: cuda_fft.rfft_pow2(xr),
                 lambda: cuda_probes.fft_pow2_radix2(xr, None, bins=n // 2 + 1),
                 lambda: torch.fft.rfft(xr), cuda_fft.rfft_pow2_plain(x64[0]),
                 4.0 * pts + 8.0 * b * (n // 2 + 1), rfft_flops(n, b))]
            rec.check("fft_pow2_radix2", lambda: cplx(cuda_probes.fft_pow2_radix2(xr, xi)),
                      cplx(cuda_fft.fft_pow2_plain(*x64)), f"forward {shape}")
            rec.time("fft_pow2_radix2", shape, lambda: cuda_probes.fft_pow2_radix2(xr, xi),
                     lambda: cuda_fft.fft_pow2_plain(xr, xi), lambda: torch.fft.fft(z),
                     16.0 * pts, fft_flops(n, b))
        for name, kernel, radix2, library, want, nbytes, flops in rows:
            got = cplx(kernel())
            db = snr(got, cplx(want))
            rec.err[name] = max(rec.err.get(name, 0.0), float((got - cplx(want)).abs().max()))
            del got
            if not db >= SNR_DB:
                raise AssertionError(f"{name} {shape}: {db:.2f} dB < {SNR_DB} dB")
            ms, r2, lib = chain_ms(kernel, xr), chain_ms(radix2, xr), chain_ms(library, xr)
            bnd, by = bound_ms(nbytes, flops)
            log(f"  redesign {name:10s} {shape:12s} {ms:.4f} ms  bound {bnd:.4f} ms ({by})  "
                f"library {lib:.4f} ms  radix-2 {r2:.4f} ms ({r2 / ms:.2f}x)  {db:.2f} dB  "
                f"faster than radix-2: {ms < r2}")
        del xr, xi, x64, z, rows
    steps = phase_stft_outer_redesign(rec, dev)
    steps.update(phase_welch_redesign(rec, dev))
    steps.update(phase_istft_peel_redesign(rec, dev))
    steps.update(phase_lane_cluster_redesign(rec, dev))
    steps.update(phase_i8_tf32_redesign(rec, dev))
    steps.update(phase_floor_dot_redesign(rec, dev))
    steps.update(phase_halo_slice8_redesign(rec, dev))
    steps.update(phase_hi_store_redesign(rec, dev))
    steps.update(phase_bd1_vdif_redesign(rec, dev))
    steps.update(phase_anat_staged_redesign(rec, dev))
    steps.update(phase_noframe_sdif_redesign(rec, dev))
    steps.update(phase_i8full_frameonly_redesign(rec, dev))
    return steps


# K5 and K8's redesign (PR 15) beside their radix-2 first designs, by chain:
# K5 in each mode over the whole recording at phase 5's hops, K8 at every
# shape phase 6 gives it (k8_shapes).
K5_REDESIGN = (("complex", 256), ("power", 512), ("mel", 256))


def redesign_line(rec: KernelRecord, steps: dict, name: str, yard: str, shape: str, op, radix2,
                  library, copy, view, want, nbytes: float, flops: float,
                  extra: tuple | None = None, yard_label: str = "radix-2") -> float:
    """One redesign line: view(op()) held against want (float64 on the
    card, >= 120 dB), then op, the yardstick radix2 (wrapper `yard`, the
    first design, printed as yard_label) and (where not None) library,
    K12's copy of the same planes and extra (a (label, op) pair, or a tuple
    of them) timed by chain (time_chain_diff); the yardstick's chains run as
    a counted session of their own, which must launch `yard` and nothing
    else.  Returns the kernel's ms."""
    from godsp_tpu_torch.probes._common import chained
    from godsp_tpu_torch.utils.metrics import time_chain_diff

    probe = torch.empty(1, device=want.device)

    def chain_ms(f):
        return time_chain_diff(chained(f), probe) * 1e3

    got = view(op())
    db = snr_on_card(got, want)
    rec.err[name] = max(rec.err.get(name, 0.0), float((got.to(want.dtype) - want).abs().max()))
    del got
    if not db >= SNR_DB:
        raise AssertionError(f"{name} {shape}: {db:.2f} dB < {SNR_DB} dB")
    ms = chain_ms(op)
    label = f"phase 3: {yard} by chain, {shape}"
    r2 = counted(label, lambda: chain_ms(radix2), steps)[0]
    for k, c in steps[label].items():
        if (c > 0) != (k == yard):
            raise AssertionError(f"{label}: {k} launched {c} times")
    bnd, by = bound_ms(nbytes, flops)
    lib = "none" if library is None else f"{chain_ms(library):.4f} ms"
    cp = "" if copy is None else f"  K12 copy {chain_ms(copy):.4f} ms"
    extras = () if extra is None else (extra,) if isinstance(extra[0], str) else extra
    ex = "".join(f"  {label} {chain_ms(fn):.4f} ms" for label, fn in extras)
    log(f"  redesign {name:15s} {shape:34s} {ms:.4f} ms  bound {bnd:.4f} ms ({by})  "
        f"library {lib}{cp}{ex}  {yard_label} {r2:.4f} ms ({r2 / ms:.2f}x)  {db:.2f} dB  "
        f"faster than {yard_label}: {ms < r2}")
    return ms


def alone_line(name: str, shape: str, ms: float, runs) -> None:
    """A redesign line's kernels alone: each (label, kernel symbol, op) of
    runs by the profiler's events of that kernel, printed beside the
    redesign's ms by chain."""
    alone = [(label, kernel_alone_ms(symbol, run, reps=20)[0]) for label, symbol, run in runs]
    log(f"  redesign alone (profiler events), {name} {shape}: " + "  ".join(
        f"{label} {'not measured' if t is None else f'{t:.4f} ms'}" for label, t in alone)
        + f"  (by chain {ms:.4f} ms)")


def phase_stft_outer_redesign(rec: KernelRecord, dev) -> dict[str, dict[str, int]]:
    """K5 (stft_complex / stft_power / stft_mel at nfft = pad = 1024 over
    the whole recording's length, hops 256 / 512 / 256, 80 mels) and K8
    (outer_dft_split at every shape of k8_shapes for phase 6's calls) each
    held against its float64 plain version and timed beside its radix-2
    first design (stft_radix2, outer_dft_radix2), the library call
    (torch.stft for the complex mode; none else), K12's copy of the same
    planes (K8) and the bound, by chain.  The yardsticks are checked (>=
    120 dB) and timed (time_ms) for the kernels line at the first line of
    each; their chains are the only launches of them in the run."""
    from godsp_tpu_torch import window
    from godsp_tpu_torch.dsputils import next_power_of_2
    from godsp_tpu_torch.models import mel_filterbank
    from godsp_tpu_torch.ops import cuda_metrics, cuda_outer, cuda_probes, cuda_stft

    steps: dict[str, dict[str, int]] = {}
    g = torch.Generator(device=dev).manual_seed(5)
    n = FS * SECONDS
    x = torch.rand(n, generator=g, device=dev) * 2 - 1
    w = window.window_table("hann", NFFT, device=dev, dtype=torch.float32)
    fb = mel_filterbank(80, NFFT, FS, device=dev, dtype=torch.float32)
    band = cuda_stft.mel_band(fb)
    band_bins = float((band[:, 1] - band[:, 0] + 1).clamp(min=0).sum())
    lp = NFFT // 2 + 1
    log("K5/K8 redesign vs the radix-2 first designs, by chain:")
    for out, hop in K5_REDESIGN:
        F = (n - NFFT) // hop + 1
        name = f"stft_{out}"
        mel = (fb,) if out == "mel" else ()
        shape = f"{F} x {NFFT}, hop {hop}" + (", 80 mels" if mel else "")
        want = cuda_stft.stft_pallas_plain(x.double(), w.double(), NFFT, hop, F, NFFT, out,
                                           fb.double())
        out_bytes = {"complex": 8.0 * lp, "power": 4.0 * lp, "mel": 4.0 * fb.shape[0]}[out]
        flops = F * (NFFT + rfft_flops(NFFT)
                     + {"complex": 0.0, "power": 3.0 * lp, "mel": 3.0 * lp + 2.0 * band_bins}[out])
        op = (lambda k=getattr(cuda_stft, name), m=mel, h=hop, f=F: k(x, w, NFFT, h, f, *m))
        radix2 = (lambda o=out, m=fb if mel else None, h=hop, f=F:
                  cuda_probes.stft_radix2(x, w, NFFT, h, f, out=o, fb=m))
        library = (lambda h=hop: torch.stft(x, NFFT, hop_length=h, window=w, center=False,
                                            return_complex=True)) if out == "complex" else None
        nbytes = 4.0 * (n + NFFT) + F * out_bytes + (4.0 * fb.numel() if mel else 0.0)
        redesign_line(rec, steps, name, "stft_radix2", shape, op, radix2, library, None,
                      lambda t: t, want, nbytes, flops)
        if "stft_radix2" not in rec.times:
            rec.check("stft_radix2", radix2, want, f"complex {shape}")
            rec.time("stft_radix2", shape, radix2,
                     lambda: cuda_stft.stft_pallas_plain(x, w, NFFT, hop, F, NFFT, out),
                     library, nbytes, flops)
        del want
    del x
    pad = next_power_of_2(2 * FS * SECONDS - 1)  # hilbert's Bluestein pad, 2^26
    cases = ([(s_, False) for s_ in k8_shapes(N20, B20)] + [(s_, True) for s_ in k8_shapes(N24)]
             + [(s_, False) for s_ in k8_shapes(N28)] + [(s_, False) for s_ in k8_shapes(pad)])
    for (b, m, n3), inverse in cases:
        xr = torch.randn(b, m, n3, generator=g, device=dev)
        xi = torch.randn(b, m, n3, generator=g, device=dev)
        shape = f"{b} x ({m}, {n3}) {'inverse' if inverse else 'forward'}"
        want = cplx(cuda_outer.outer_dft_split_plain(xr.double(), xi.double(), m, 1, inverse))
        points = float(b * m * n3)
        nbytes, flops = 16.0 * points, fft_flops(m, b * n3) + 12.0 * points
        op = lambda: cuda_outer.outer_dft_split(xr, xi, m, 1, inverse)
        radix2 = lambda: cuda_probes.outer_dft_radix2(xr, xi, m, 1, inverse)
        flat = (xr.view(b * m, n3), xi.view(b * m, n3))
        redesign_line(rec, steps, "outer_dft_split", "outer_dft_radix2", shape, op, radix2, None,
                      lambda: cuda_metrics.copy_split(*flat), cplx, want, nbytes, flops)
        if "outer_dft_radix2" not in rec.times:
            rec.check("outer_dft_radix2", lambda: cplx(radix2()), want, shape)
            rec.time("outer_dft_radix2", shape, radix2,
                     lambda: cuda_outer.outer_dft_split_plain(xr, xi, m, 1, inverse), None,
                     nbytes, flops)
        del xr, xi, want, flat
    return steps


# K4/K11 and K7's redesign beside their radix-2 first designs, by
# chain: K4 (nfft, hop, pad, segments) at K14a's geometry, the bench's hop
# 160 and pad 2048; K7 over the whole recording at 1024/512 and at hop 160
# (nfft 1000, pad 1024), phase 7's csd.
K4_REDESIGN = ((1024, 512, 1024, 16384), (1024, 160, 1024, (1 << 23) // 160),
               (2048, 1024, 2048, 16384))
K7_REDESIGN = ((1024, 512, 1024), (1000, 160, 1024))


def phase_welch_redesign(rec: KernelRecord, dev) -> dict[str, dict[str, int]]:
    """K4 at each shape of K4_REDESIGN (beside pwfloor_loadonly, K4's load
    floor, at K14a's) and K7 at each of K7_REDESIGN over the recording's
    length, each held against its float64 plain version and timed
    beside its radix-2 first design (pwelch_radix2, csd_radix2) and the
    bound, by chain; then K4, K11 and pwelch_radix2 at the streaming
    chunk (256 segments, 1024/512; K11 one shard's block and its
    neighbour's head) alone by the profiler's events of each kernel.  The
    yardsticks are checked (>= 120 dB) and timed (time_ms) for the
    kernels line at their first line; their chains are the only counted
    launches of them in the run.  First the CTAs the kernels launch
    (gdsp_pwelch_geometry, gdsp_csd_geometry) are held to the host's plan
    (cuda_pwelch.partials_cta, cuda_csd.sums_in_smem), which the CPU
    tests' bank counts and summation order read."""
    import ctypes

    from godsp_tpu_torch import window
    from godsp_tpu_torch.ops import _build, cuda_csd, cuda_fused_halo, cuda_probes, cuda_pwelch

    lib, out = _build.library(), (ctypes.c_int * 4)()
    for lg in range(1, 15):
        for tile in (1, 3, 8, 17, 64):
            plan = cuda_pwelch.partials_cta(1 << lg, tile, tile, 1)
            if lib.gdsp_pwelch_geometry(lg, tile, out) != 0 or tuple(out)[:3] != plan:
                raise AssertionError(f"K4's CTA at pad {1 << lg}, tile {tile}: {tuple(out)[:3]}"
                                     f" against the host's {plan}")
            plan = (*cuda_pwelch.partials_cta(1 << lg, tile, tile, 2),
                    int(cuda_csd.sums_in_smem(1 << lg)))
            if lib.gdsp_csd_geometry(lg, tile, out) != 0 or tuple(out) != plan:
                raise AssertionError(f"K7's CTA at pad {1 << lg}, tile {tile}: {tuple(out)}"
                                     f" against the host's {plan}")
    log("K4/K11 and K7's CTAs equal the host's plan at every pad")
    steps: dict[str, dict[str, int]] = {}
    g = torch.Generator(device=dev).manual_seed(16)
    log("K4/K11/K7 redesign vs the radix-2 first designs, by chain:")
    for nfft, hop, pad, S in K4_REDESIGN:
        L = (S - 1) * hop + nfft
        ext = torch.rand(1, L, generator=g, device=dev) * 2 - 1
        mask = torch.ones(1, S, device=dev)
        w = window.window_table("hann", pad, device=dev, dtype=torch.float32)
        bt = cuda_pwelch.segs_per_tile(S, 1)
        lp = pad // 2 + 1
        shape = f"{S} segments, nfft {nfft} hop {hop} pad {pad}"
        want = cuda_pwelch.pwelch_power_partials_plain(ext.double(), mask.double(), w.double(),
                                                       nfft, hop, pad, bt)
        op = lambda: cuda_pwelch.pwelch_power_partials(ext, mask, w, nfft, hop, pad)
        radix2 = lambda: cuda_probes.pwelch_radix2(ext, mask, w, nfft, hop, pad)
        floor = None
        if (nfft, hop, pad, S) == K4_REDESIGN[0]:
            floor = ("pwfloor_loadonly",
                     lambda: cuda_probes.pwfloor_loadonly(ext, mask, w, nfft, hop, pad))
        nbytes = 4.0 * (L + S + pad + -(-S // bt) * lp)
        flops = S * (nfft + rfft_flops(pad) + 3.0 * lp)
        redesign_line(rec, steps, "pwelch_power_partials", "pwelch_radix2", shape, op, radix2,
                      None, None, lambda t: t, want, nbytes, flops, extra=floor)
        # A call's host work is ~0.05 ms, as long as K4 at 16384 segments:
        # the kernels' own device time beside the chains.
        alone = [("K4", "pwelch_partials_kernel", op), ("radix-2", "pwelch_radix2_kernel", radix2)]
        if floor is not None:
            alone.append(("pwfloor_loadonly", "loadonly_kernel", floor[1]))
        fmt = [(label, kernel_alone_ms(symbol, run)[0]) for label, symbol, run in alone]
        log(f"  redesign alone (profiler events), {shape}: " + "  ".join(
            f"{label} {'not measured' if ms is None else f'{ms:.4f} ms'}" for label, ms in fmt))
        if "pwelch_radix2" not in rec.times:
            rec.check("pwelch_radix2", radix2, want, shape)
            # No one PyTorch call frames, windows, transforms and sums.
            rec.time("pwelch_radix2", shape, radix2,
                     lambda: cuda_pwelch.pwelch_power_partials_plain(ext, mask, w, nfft, hop,
                                                                     pad, bt),
                     None, nbytes, flops)
        del ext, want
    n = FS * SECONDS
    x = torch.rand(n, generator=g, device=dev) * 2 - 1
    y = 0.7 * torch.roll(x, DELAY) + 0.1 * torch.randn(n, generator=g, device=dev)
    for nfft, hop, pad in K7_REDESIGN:
        S = (n - nfft) // hop + 1
        L = (S - 1) * hop + nfft
        xs, ys = x[:L], y[:L]
        mask = torch.ones(S, device=dev)
        w = window.window_table("hann", pad, device=dev, dtype=torch.float32)
        bt = cuda_pwelch.segs_per_tile(S, 1)
        lp = pad // 2 + 1
        shape = f"{S} segments, nfft {nfft} hop {hop} pad {pad}"
        want = cplx(cuda_csd.csd_power_partials_plain(xs.double(), ys.double(), mask.double(),
                                                      w.double(), nfft, hop, pad, bt))
        op = lambda: cuda_csd.csd_power_partials(xs, ys, mask, w, nfft, hop, pad)
        radix2 = lambda: cuda_probes.csd_radix2(xs, ys, mask, w, nfft, hop, pad)
        nbytes = 4.0 * (2 * L + S + pad + 2 * -(-S // bt) * lp)
        flops = S * (2.0 * (nfft + rfft_flops(pad)) + 8.0 * lp)
        redesign_line(rec, steps, "csd_power_partials", "csd_radix2", shape, op, radix2, None,
                      None, cplx, want, nbytes, flops)
        if "csd_radix2" not in rec.times:
            rec.check("csd_radix2", lambda: cplx(radix2()), want, shape)
            # No one PyTorch call frames two signals and sums their cross power.
            rec.time("csd_radix2", shape, radix2,
                     lambda: cuda_csd.csd_power_partials_plain(xs, ys, mask, w, nfft, hop, pad,
                                                               bt),
                     None, nbytes, flops)
        del want
    del x, y
    # The streaming chunk alone: K4 on 256 segments, K11 on one shard's
    # block reading its neighbour's head, pwelch_radix2 on the K4 input.
    S, hop = SEGS, 512
    sig = torch.rand(1, 2 * S * hop, generator=g, device=dev) * 2 - 1
    ext, blk, src = sig[:, : S * hop + 512], sig[:, : S * hop], sig[:, S * hop:]
    mask = torch.ones(1, S, device=dev)
    w = window.window_table("hann", NFFT, device=dev, dtype=torch.float32)
    want = cuda_pwelch.pwelch_power_partials_plain(ext.double(), mask.double(), w.double(), NFFT,
                                                   hop, NFFT, cuda_pwelch.segs_per_tile(S, 1))
    alone = {}
    for name, symbol, run in (
        ("pwelch_power_partials", "pwelch_partials_kernel",
         lambda: cuda_pwelch.pwelch_power_partials(ext, mask, w, NFFT, hop)),
        ("pwelch_power_partials_halo", "pwelch_partials_kernel",
         lambda: cuda_fused_halo.pwelch_power_partials_halo(blk, src, mask[0], w, NFFT, hop)),
        ("pwelch_radix2", "pwelch_radix2_kernel",
         lambda: cuda_probes.pwelch_radix2(ext, mask, w, NFFT, hop)),
    ):
        db = snr_on_card(run(), want)
        if not db >= SNR_DB:
            raise AssertionError(f"{name} at the chunk: {db:.2f} dB < {SNR_DB} dB")
        alone[name] = kernel_alone_ms(symbol, run)[0]
    fmt = {k: "not measured" if v is None else f"{v:.4f} ms" for k, v in alone.items()}
    log(f"  redesign alone at the chunk ({S} segments, 1024/512): K4 {fmt['pwelch_power_partials']}"
        f"  K11 {fmt['pwelch_power_partials_halo']}  radix-2 {fmt['pwelch_radix2']}  "
        f"(profiler events)")
    return steps


def phase_istft_peel_redesign(rec: KernelRecord, dev) -> dict[str, dict[str, int]]:
    """K9 at each K9_SHAPES entry and K6 at each K6_SHAPES entry, each held
    against its float64 plain version and timed by chain beside its first
    design (peel_rows_radix2, istft_radix2; a counted session of its own),
    the bound and, for K9, torch.fft of the flattened rows and the separate
    route it replaces (K8 outer_dft_split(128, 1), then K1/K2 rows), with
    the kernels alone by the profiler's events.  First the plans the C side
    exports are held to the host's (cuda_outer.peel_plan,
    cuda_istft.istft_cta), which the CPU tests' scatter map, bank counts
    and summation order read.  The yardsticks are checked and timed for the
    kernels line at their first line."""
    import ctypes

    from godsp_tpu_torch import window
    from godsp_tpu_torch.ops import _build, cuda_fft, cuda_istft, cuda_outer, cuda_probes

    lib, out = _build.library(), (ctypes.c_int * 8)()
    for lg in range(8, 14):
        plan = tuple(cuda_outer.peel_plan(1 << lg))
        if lib.gdsp_peel_rows_geometry(lg, out) != 0 or tuple(out) != plan:
            raise AssertionError(f"K9's plan at n3 {1 << lg}: {tuple(out)} against the host's "
                                 f"{plan}")
    for lg in range(1, 15):
        for one in (True, False):
            cta = tuple(cuda_istft.istft_cta(1 << lg, one))
            if lib.gdsp_istft_geometry(lg, int(one), out) != 0 or tuple(out)[:6] != cta:
                side = "one-sided" if one else "full"
                raise AssertionError(f"K6's CTA at pad {1 << lg} ({side}): {tuple(out)[:6]} "
                                     f"against the host's {cta}")
    log("K9's cluster plan and K6's CTA equal the host's at every n3 and pad")
    steps: dict[str, dict[str, int]] = {}
    g = torch.Generator(device=dev).manual_seed(19)
    log("K9/K6 redesign vs the radix-2 first designs, by chain:")
    for b, n3, inverse, scale in K9_SHAPES:
        xr = torch.randn(b, 128, n3, generator=g, device=dev)
        xi = torch.randn(b, 128, n3, generator=g, device=dev)
        plan = cuda_outer.peel_plan(n3)
        shape = (f"{b} x (128, {n3}) {'inverse' if inverse else 'forward'}, cluster "
                 f"{plan.cluster}, re-read {plan.clusters}")
        want = cplx(cuda_outer.peel_rows_fused_split_plain(xr.double(), xi.double(), inverse,
                                                           scale))
        op = lambda: cuda_outer.peel_rows_fused_split(xr, xi, inverse, scale)
        radix2 = lambda: cuda_probes.peel_rows_radix2(xr, xi, inverse, scale)
        z = torch.complex(xr, xi).reshape(b, -1)
        library = ((lambda: torch.fft.ifft(z, norm="forward") * scale) if inverse
                   else (lambda: torch.fft.fft(z)))

        def separate():
            yr, yi = cuda_outer.outer_dft_split(xr, xi, 128, 1, inverse)
            if inverse:
                return cuda_fft.ifft_pow2(yr, yi, scale)
            return cuda_fft.fft_pow2(yr, yi, scale=scale)

        nbytes, flops = 16.0 * b * 128 * n3, fft_flops(128 * n3, b)
        redesign_line(rec, steps, "peel_rows_fused_split", "peel_rows_radix2", shape, op, radix2,
                      library, None, cplx, want, nbytes, flops,
                      extra=("separate K8 + K1/K2", separate))
        alone = [(label, kernel_alone_ms(symbol, run, reps=20)[0]) for label, symbol, run in (
            ("K9", "peel_rows_kernel", op), ("radix-2", "peel_rows_radix2_kernel", radix2))]
        log(f"  redesign alone (profiler events), {shape}: " + "  ".join(
            f"{label} {'not measured' if ms is None else f'{ms:.4f} ms'}" for label, ms in alone))
        if "peel_rows_radix2" not in rec.times:
            rec.check("peel_rows_radix2", lambda: cplx(radix2()), want, shape)
            rec.time("peel_rows_radix2", shape, radix2,
                     lambda: cuda_outer.peel_rows_fused_split_plain(xr, xi, inverse, scale),
                     library, nbytes, flops)
        del xr, xi, z, want
    w = window.window_table("hann", NFFT, device=dev, dtype=torch.float32)
    for F, hop, pad in K6_SHAPES:
        spec = torch.complex(torch.randn(F, pad // 2 + 1, generator=g, device=dev),
                             torch.randn(F, pad // 2 + 1, generator=g, device=dev))
        shape = f"{F} frames x {pad // 2 + 1} bins, nfft {NFFT} hop {hop} pad {pad}"
        want = cuda_istft.istft_overlap_add_plain(c128(spec), w.double(), NFFT, hop)
        op = lambda: cuda_istft.istft_overlap_add(spec, w, NFFT, hop)
        radix2 = lambda: cuda_probes.istft_radix2(spec, w, NFFT, hop)
        nbytes = 8.0 * spec.numel() + 4.0 * NFFT + 4.0 * ((F - 1) * hop + NFFT)
        flops = F * (rfft_flops(pad) + 2.0 * NFFT)
        redesign_line(rec, steps, "istft_overlap_add", "istft_radix2", shape, op, radix2, None,
                      None, lambda t: t, want, nbytes, flops)
        alone = [(label, kernel_alone_ms(symbol, run)[0]) for label, symbol, run in (
            ("K6", "istft_kernel", op), ("radix-2", "istft_radix2_kernel", radix2))]
        log(f"  redesign alone (profiler events), {shape}: " + "  ".join(
            f"{label} {'not measured' if ms is None else f'{ms:.4f} ms'}" for label, ms in alone))
        if "istft_radix2" not in rec.times:
            rec.check("istft_radix2", radix2, want, shape)
            # torch.istft also divides by the window-energy sum: not the same function.
            rec.time("istft_radix2", shape, radix2,
                     lambda: cuda_istft.istft_overlap_add_plain(spec, w, NFFT, hop), None, nbytes,
                     flops)
        del spec, want
    istft_margins(dev, g)
    return steps


def istft_margins(dev, g: torch.Generator) -> None:
    """The public istft (K6) over a whole signal, after its window-energy
    division, at each ISTFT_NFFTS entry (Hann, hop nfft/4, the complex64
    spectra of EDGE_SECONDS of float64 noise), against the float64 plain
    route on the same spectra, beside K6's first
    design (istft_radix2) under the same division: the whole signal, its
    first and last nfft samples (where the division scales float32 error
    by 1/w) and its interior.  K6 must hold SNR_DB over the whole signal."""
    from godsp_tpu_torch import window
    from godsp_tpu_torch.models import istft
    from godsp_tpu_torch.models._stft_impl import _nola_norm
    from godsp_tpu_torch.ops import cuda_istft, cuda_probes, cuda_stft

    x = torch.randn(FS * EDGE_SECONDS, generator=g, device=dev, dtype=torch.float64)
    log(f"K6 whole-signal margins (istft, Hann, hop nfft/4, {EDGE_SECONDS} s of noise) vs "
        "float64, beside istft_radix2 under the same division:")
    for nfft in ISTFT_NFFTS:
        hop = nfft // 4
        w64 = window.window_table("hann", nfft, device=dev)
        F = (x.numel() - nfft) // hop + 1
        L = (F - 1) * hop + nfft
        s32 = cuda_stft.stft_pallas_plain(x, w64, nfft, hop, F).to(torch.complex64)
        w32 = w64.float()
        # The float64 route on the same complex64 spectra: their rounding,
        # scaled by 1/w at the ends too, is the input's, not the kernel's.
        want = (cuda_istft.istft_overlap_add_plain(c128(s32), w64, nfft, hop)
                / _nola_norm(w64, F, hop, L))
        runs = (("K6", istft(s32, nfft, hop=hop)),
                ("radix-2", cuda_probes.istft_radix2(s32, w32, nfft, hop)
                 / _nola_norm(w32, F, hop, L)))
        parts = (("whole", slice(None)), ("head", slice(0, nfft)),
                 ("interior", slice(nfft, L - nfft)), ("tail", slice(L - nfft, L)))
        dbs = {label: {part: snr_on_card(y[sl], want[sl]) for part, sl in parts}
               for label, y in runs}
        runs_ht = cuda_istft.edge_runs(w32.cpu().numpy(), nfft)
        log(f"  nfft {nfft}, hop {hop}, edge runs {runs_ht}: " + "; ".join(f"{label} " + " ".join(f"{p} {v:.2f}" for p, v in d.items())
                        for label, d in dbs.items()) + " dB")
        if not dbs["K6"]["whole"] >= SNR_DB:
            raise AssertionError(f"istft at nfft {nfft}: {dbs['K6']['whole']:.2f} dB over the "
                                 f"whole signal < {SNR_DB} dB")
        del want, s32, runs


# K14c gmm_concat and K14f ls_full on thread-block clusters beside
# their first designs, by chain: gmm_concat at the probes' 16384 x 1024,
# ls_full there and at the ragged 1001 x 512.
LANE_REDESIGN = (("gmm_concat", 16384, 1024), ("ls_full", 16384, 1024), ("ls_full", 1001, 512))


def phase_lane_cluster_redesign(rec: KernelRecord, dev) -> dict[str, dict[str, int]]:
    """gmm_concat and ls_full's cluster kernels at each LANE_REDESIGN entry,
    held against the float64 plain version (>= 120 dB; gmm_concat also
    torch.equal to K13, ls_full to its first design) and timed by chain
    and alone (the profiler's events) beside their first designs
    (gmm_concat_stream, ls_full_stream: G streamed a tile; a counted session
    of their own), the library call (torch.matmul of the complex64 slices
    with K13's G, TF32 off; torch.fft.fft of the rows), K13 and the bound,
    with the plan's clusters and shared bytes.  First the plan the C side
    exports (gdsp_lane_cluster_geometry, from the resident clusters the card
    reports) is held to the host's (cuda_probes.lane_cluster_plan) at every
    n and setting kind.  The yardsticks are checked and timed for the
    kernels line at their first line."""
    import ctypes

    from godsp_tpu_torch.ops import _build, cuda_metrics
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes._common import complex_matmul, lane_planes
    from godsp_tpu_torch.probes._common import planes_equal as equal

    lib, out = _build.library(), (ctypes.c_int * 10)()
    settings = (("gmm_concat", 16, 16, 0), ("ls_full", 16, 16, 0), ("ls_full", 64, 2, 1))
    for kind, rows_per_block, chunk_rows, store_rows in settings:
        ns = (128, 384, 1024, 2048) if kind == "gmm_concat" else (128, 256, 512, 1024)
        for n in ns:
            resident = cp._cluster_resident(kind, n, dev)
            for b in (1, 1001, 16384):
                plan = tuple(cp.lane_cluster_plan(kind, b, n, rows_per_block, chunk_rows,
                                                  store_rows, resident))
                rc = lib.gdsp_lane_cluster_geometry(cp.LANE_KINDS.index(kind), b, n,
                                                    rows_per_block, chunk_rows, store_rows,
                                                    resident, out)
                if rc != 0 or tuple(out) != plan:
                    raise AssertionError(f"{kind}'s plan at {b} x {n}: {tuple(out)} against "
                                         f"the host's {plan}")
    log("gmm_concat's and ls_full's cluster plans equal the host's; resident clusters: " +
        ", ".join(f"{k} n {n}: {cp._cluster_resident(k, n, dev)}"
                  for k in ("gmm_concat", "ls_full") for n in (128, 512, 1024)))
    steps: dict[str, dict[str, int]] = {}
    log("gmm_concat/ls_full cluster redesign vs the first designs (G streamed a tile), "
        "by chain:")
    for name, b, n in LANE_REDESIGN:
        xr, xi = lane_planes(dev, b, n, seed=18)
        x64 = (xr.double(), xi.double())
        pts = float(b * n)
        plan = cp.lane_cluster_plan(name, b, n, resident=cp._cluster_resident(name, n, dev))
        shape = (f"{b} x {n}, {plan.clusters} clusters of {plan.cluster}, {plan.smem} B "
                 f"shared a CTA")
        k13 = lambda: cuda_metrics.gmm_floor(xr, xi)
        if name == "gmm_concat":
            op = lambda: cp.gmm_concat(xr, xi)
            yard, first = "gmm_concat_stream", lambda: cp.gmm_concat_stream(xr, xi)
            plain = lambda: cuda_metrics.gmm_floor_plain(xr, xi)
            want = cplx(cuda_metrics.gmm_floor_plain(*x64))
            if not equal(op(), k13()):
                raise AssertionError(f"gmm_concat {shape}: not equal to K13's result")
            library = complex_matmul(xr, xi)
            if torch.backends.cuda.matmul.allow_tf32:
                raise AssertionError("gmm_concat's library call: TF32 is on")
            flops = 768.0 * pts
        else:
            op = lambda: cp.ls_full(xr, xi)
            yard, first = "ls_full_stream", lambda: cp.ls_full_stream(xr, xi)
            plain = lambda: cp.ls_full_plain(xr, xi)
            want = cplx(cp.ls_full_plain(*x64))
            if not equal(op(), first()):
                raise AssertionError(f"ls_full {shape}: not equal to its first design")
            z = torch.complex(xr, xi)
            library = lambda: torch.fft.fft(z)
            flops = 5.0 * float(np.log2(n)) * pts  # the function is the row's DFT
        ms = redesign_line(rec, steps, name, yard, shape, op, first, library, None, cplx, want,
                           16.0 * pts, flops, extra=("K13", k13), yard_label="first design")
        alone = [(label, kernel_alone_ms(symbol, run, reps=20)[0]) for label, symbol, run in (
            (name, f"{name}_kernel", op), ("first design", f"{yard}_kernel", first))]
        log(f"  redesign alone (profiler events), {name} {shape}: " + "  ".join(
            f"{label} {'not measured' if t is None else f'{t:.4f} ms'}" for label, t in alone) +
            f"  (by chain {ms:.4f} ms)")
        if yard not in rec.times:
            rec.check(yard, lambda: cplx(first()), want, f"{b} x {n}")
            rec.time(yard, f"{b} x {n}", first, plain, library, 16.0 * pts, flops)
        del xr, xi, x64, want, library
    return steps


# K14c i8_concat and K14f gmm_tf32 redesigned (the int8 tables resident on
# a cluster of slices; wgmma fed by TMA) beside their first designs, at the
# probes' 16384 x 1024.  gmm_tf32's dB against the TF32-rounded float64
# plain version stays within GMM_TF32_DB_SLACK of its first design's, both
# measured in the same run.
I8_TF32_REDESIGN = (16384, 1024)
GMM_TF32_DB_SLACK = 3.0


def phase_i8_tf32_redesign(rec: KernelRecord, dev) -> dict[str, dict[str, int]]:
    """i8_concat and gmm_tf32 at I8_TF32_REDESIGN: first the plans the C
    side exports (gdsp_lane_cluster_geometry kind 2, gdsp_gmm_tf32_geometry)
    held to the host's (lane_cluster_plan "i8_concat", gmm_tf32_plan) at
    ragged b; then i8_concat torch.equal to i8full and to i8_concat_stream;
    gmm_tf32 (its tensor cores chaining GMM_TF32_CHAIN k-steps) and its
    first design gmm_tf32_sync against the TF32-rounded float64 plain
    version and the exact product, gmm_tf32 within GMM_TF32_DB_SLACK of the
    first design; then a redesign line each (by chain beside the first
    design as a counted session of its own, the library call: K13's
    torch.matmul of the complex64 slices with TF32 off for i8_concat, the
    three TF32 torch.matmul for gmm_tf32; i8full or K13 as the extra; the
    bound) and each alone by the profiler's events.  The yardsticks are
    checked and timed for the kernels line here."""
    import ctypes

    from godsp_tpu_torch.ops import _build, cuda_metrics
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes import int8, r3
    from godsp_tpu_torch.probes._common import INT8_OPS, TF32_FLOPS, complex_matmul, lane_planes
    from godsp_tpu_torch.probes._common import planes_equal as equal
    from godsp_tpu_torch.utils.metrics import FP32_FLOPS

    lib, out = _build.library(), (ctypes.c_int * 10)()
    tf32_resident = cp._tf32_resident(dev)
    for n in (128, 256, 512, 1024, 2048):
        i8_resident = cp._cluster_resident("i8_concat", n, dev) if n <= 1024 else None
        for b in (1, 65, 1001, 16384):
            if i8_resident is not None:
                plan = tuple(cp.lane_cluster_plan("i8_concat", b, n, resident=i8_resident))
                rc = lib.gdsp_lane_cluster_geometry(2, b, n, 0, 0, 0, i8_resident, out)
                if rc != 0 or tuple(out) != plan:
                    raise AssertionError(f"i8_concat's plan at {b} x {n}: {tuple(out)} "
                                         f"against the host's {plan}")
            plan = tuple(cp.gmm_tf32_plan(b, n, tf32_resident))
            rc = lib.gdsp_gmm_tf32_geometry(b, n, tf32_resident, out)
            if rc != 0 or tuple(out) != plan:
                raise AssertionError(f"gmm_tf32's plan at {b} x {n}: {tuple(out)} against "
                                     f"the host's {plan}")
    log("i8_concat's and gmm_tf32's plans equal the host's; resident clusters: " +
        ", ".join(f"i8_concat n {n}: {cp._cluster_resident('i8_concat', n, dev)}"
                  for n in (128, 512, 1024)) + f"; gmm_tf32: {tf32_resident} pairs of CTAs")
    steps: dict[str, dict[str, int]] = {}
    b, n = I8_TF32_REDESIGN
    xr, xi = lane_planes(dev, b, n, seed=19)
    x64 = (xr.double(), xi.double())
    pts = float(b * n)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("i8_concat's library call: TF32 is on")
    matmul = complex_matmul(xr, xi)

    # i8_concat: the int8 tables resident on a cluster of slices.
    plan = cp.lane_cluster_plan("i8_concat", b, n, resident=cp._cluster_resident("i8_concat", n,
                                                                                    dev))
    shape = f"{b} x {n}, {plan.clusters} clusters of {plan.cluster}, {plan.smem} B shared a CTA"
    full = cp.i8full(xr, xi)
    plain8 = cp.i8full_plain(xr, xi)
    for label, got in (("i8full", full), ("i8_concat_stream", cp.i8_concat_stream(xr, xi)),
                       ("its plain version", plain8)):
        if not equal(cp.i8_concat(xr, xi), got):
            raise AssertionError(f"i8_concat {shape}: not equal to {label}")
    want = cplx(plain8)
    del full, plain8
    tc8 = FP32_FLOPS / INT8_OPS
    flops8 = max(int8.OPS_PER_POINT["i8_concat"], int8.INT8_PER_POINT["i8_concat"] * tc8) * pts
    first8 = lambda: cp.i8_concat_stream(xr, xi)
    ms = redesign_line(rec, steps, "i8_concat", "i8_concat_stream", shape,
                       lambda: cp.i8_concat(xr, xi), first8, matmul, None, cplx, want,
                       16.0 * pts, flops8, extra=("i8full", lambda: cp.i8full(xr, xi)),
                       yard_label="first design")
    alone = [(label, kernel_alone_ms(symbol, run, reps=20)[0]) for label, symbol, run in (
        ("i8_concat", "i8_concat_kernel", lambda: cp.i8_concat(xr, xi)),
        ("first design", "i8_probe_kernel<2, true>", first8),
        ("i8full", "i8_probe_kernel<2, false>", lambda: cp.i8full(xr, xi)))]
    log(f"  redesign alone (profiler events), i8_concat {shape}: " + "  ".join(
        f"{label} {'not measured' if t is None else f'{t:.4f} ms'}" for label, t in alone) +
        f"  (by chain {ms:.4f} ms)")
    rec.check("i8_concat_stream", lambda: cplx(first8()), want, f"{b} x {n}")
    rec.time("i8_concat_stream", f"{b} x {n}", first8, lambda: cp.i8full_plain(xr, xi), matmul,
             16.0 * pts, flops8)
    del want

    # gmm_tf32 and its first design against the same references.
    want = cplx(cp.gmm_tf32_plain(*x64, tf32=True))
    exact = cplx(cp.gmm_tf32_plain(*x64))
    dbs = {}
    for label, fn in (("gmm_tf32", cp.gmm_tf32), ("first design", cp.gmm_tf32_sync)):
        got = cplx(fn(xr, xi))
        dbs[label] = (snr_on_card(got, want), snr_on_card(got, exact))
        del got
    chosen, first_db = dbs["gmm_tf32"][0], dbs["first design"][0]
    log(f"  gmm_tf32 {b} x {n}, chain {cp.GMM_TF32_CHAIN}: " + ", ".join(
        f"{label} {db:.2f} dB against the TF32-rounded plain version, {db_exact:.2f} dB "
        f"against the exact product" for label, (db, db_exact) in dbs.items()))
    if not chosen >= first_db - GMM_TF32_DB_SLACK:
        raise AssertionError(f"gmm_tf32 chain {cp.GMM_TF32_CHAIN}: {chosen:.2f} dB, more than "
                             f"{GMM_TF32_DB_SLACK} dB under the first design's {first_db:.2f}")
    tplan = cp.gmm_tf32_plan(b, n, tf32_resident)
    shape = (f"{b} x {n}, {tplan.pairs} pairs of CTAs, {tplan.smem} B shared a CTA, chain "
             f"{tplan.chain} ({chosen:.2f} dB)")
    tf32_lib = r3.ops(xr, xi)["gmm_default"][1]
    flops32 = 768.0 * pts * FP32_FLOPS / TF32_FLOPS
    first32 = lambda: cp.gmm_tf32_sync(xr, xi)
    ms = redesign_line(rec, steps, "gmm_tf32", "gmm_tf32_sync", shape,
                       lambda: cp.gmm_tf32(xr, xi), first32, tf32_lib, None, cplx, want,
                       16.0 * pts, flops32, extra=("K13", lambda: cuda_metrics.gmm_floor(xr, xi)),
                       yard_label="first design")
    alone = [(label, kernel_alone_ms(symbol, run, reps=20)[0]) for label, symbol, run in (
        ("gmm_tf32", "gmm_tf32_kernel", lambda: cp.gmm_tf32(xr, xi)),
        ("first design", "gmm_tf32_sync_kernel", first32))]
    log(f"  redesign alone (profiler events), gmm_tf32 {shape}: " + "  ".join(
        f"{label} {'not measured' if t is None else f'{t:.4f} ms'}" for label, t in alone) +
        f"  (by chain {ms:.4f} ms)")
    rec.check("gmm_tf32_sync", lambda: cplx(first32()), want, f"{b} x {n}")
    rec.time("gmm_tf32_sync", f"{b} x {n}", first32,
             lambda: cp.gmm_tf32_plain(xr, xi, tf32=True), tf32_lib, 16.0 * pts, flops32)
    del xr, xi, x64, want, exact, matmul
    return steps


# K13 gmm_floor and K14g i8_dot redesigned (8 x 4 register tiles fed by a
# TMA ring on a persistent grid; 32 x 32 tiles loaded in one round of
# 16-byte copies) beside their first designs, at the bench's two K13
# shapes and at both probes.int8.DOT_SHAPES.
FLOOR_REDESIGN = ((16384, 1024), (1024, 16384))


def phase_floor_dot_redesign(rec: KernelRecord, dev) -> dict[str, dict[str, int]]:
    """K13 and i8_dot: first the plans the C side exports
    (gdsp_gmm_floor_geometry from the resident CTAs the card reports,
    gdsp_i8_dot_geometry on both load paths) held to the host's
    (cuda_metrics.gmm_floor_plan, cuda_probes.i8_dot_plan) and printed; then
    K13 at each FLOOR_REDESIGN shape torch.equal to its first design
    gmm_floor_sync and >= 120 dB against float64, a redesign line (by chain
    beside gmm_floor_sync as a counted session of its own, torch.matmul of
    the complex64 slices with G, TF32 off, and the bound) and each alone
    by the profiler's events (torch.matmul's GEMM kernel too); then i8_dot
    at both DOT_SHAPES torch.equal to the exact product and to i8_dot_bytes,
    a redesign line (torch._int_mm by chain) and each alone beside
    torch._int_mm's GEMM kernel, all three averaged over their events.  The
    yardsticks are checked and timed for the kernels line here."""
    import ctypes

    from godsp_tpu_torch.ops import _build, cuda_metrics
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes import int8
    from godsp_tpu_torch.probes._common import INT8_OPS, complex_matmul, lane_planes
    from godsp_tpu_torch.probes._common import planes_equal as equal
    from godsp_tpu_torch.utils.metrics import FP32_FLOPS

    lib, out = _build.library(), (ctypes.c_int * 10)()
    resident = cuda_metrics._floor_resident(dev)
    for b in (1, 129, 1001, 16384, 1 << 17):
        for n in (128, 384, 1024, 16384):
            plan = tuple(cuda_metrics.gmm_floor_plan(b, n, resident))
            rc = lib.gdsp_gmm_floor_geometry(b, n, resident, out)
            if rc != 0 or tuple(out)[:7] != plan:
                raise AssertionError(f"K13's plan at {b} x {n}: {tuple(out)[:7]} against the "
                                     f"host's {plan}")
    dot_shapes = int8.DOT_SHAPES + ((17, 33, 5), (300, 256, 72), (64, 1024, 48),
                                    (32 * 65535 + 40, 16, 16))
    for m, k, n in dot_shapes:
        for aligned in (0, 1):
            plan = tuple(cp.i8_dot_plan(m, k, n, bool(aligned)))
            rc = lib.gdsp_i8_dot_geometry(m, k, n, aligned, out)
            if rc != 0 or tuple(out) != plan:
                raise AssertionError(f"i8_dot's plan at ({m}, {k}, {n}), aligned {aligned}: "
                                     f"{tuple(out)} against the host's {plan}")
    log(f"K13's and i8_dot's plans equal the host's; K13: {resident} resident CTAs, " + "; ".join(
        f"{b} x {n}: {cuda_metrics.gmm_floor_plan(b, n, resident)}" for b, n in FLOOR_REDESIGN))
    log("  i8_dot: " + "; ".join(f"({m}, {k}) @ ({k}, {n}): {cp.i8_dot_plan(m, k, n)}"
                                 for m, k, n in int8.DOT_SHAPES))
    steps: dict[str, dict[str, int]] = {}
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("K13's library call: TF32 is on")
    log("K13 and i8_dot redesigned vs their first designs, by chain and alone:")
    for b, n in FLOOR_REDESIGN:
        xr, xi = lane_planes(dev, b, n, seed=20)
        pts = float(b * n)
        plan = cuda_metrics.gmm_floor_plan(b, n, resident)
        shape = f"{b} x {n}, {plan.ctas} CTAs, {plan.items} items, {plan.smem} B shared a CTA"
        op = lambda: cuda_metrics.gmm_floor(xr, xi)
        first = lambda: cp.gmm_floor_sync(xr, xi)
        if not equal(op(), first()):
            raise AssertionError(f"K13 {shape}: not equal to gmm_floor_sync")
        want = cplx(cuda_metrics.gmm_floor_plain(xr.double(), xi.double()))
        library = complex_matmul(xr, xi)
        ms = redesign_line(rec, steps, "gmm_floor", "gmm_floor_sync", shape, op, first, library,
                           None, cplx, want, 16.0 * pts, 768.0 * pts, yard_label="first design")
        alone = [(label, kernel_alone_ms(symbol, run, reps=20)[0]) for label, symbol, run in (
            ("K13", "gmm_floor_kernel", op), ("first design", "gmm_floor_sync_kernel", first),
            ("torch.matmul", "gemm", library))]
        log(f"  redesign alone (profiler events), gmm_floor {shape}: " + "  ".join(
            f"{label} {'not measured' if t is None else f'{t:.4f} ms'}" for label, t in alone) +
            f"  (by chain {ms:.4f} ms)")
        if "gmm_floor_sync" not in rec.times:
            rec.check("gmm_floor_sync", lambda: cplx(first()), want, f"{b} x {n}")
            rec.time("gmm_floor_sync", f"{b} x {n}", first,
                     lambda: cuda_metrics.gmm_floor_plain(xr, xi), library, 16.0 * pts,
                     768.0 * pts)
        del xr, xi, want, library
    tc = FP32_FLOPS / INT8_OPS  # the products run on the int8 tensor cores
    for m, k, n in int8.DOT_SHAPES:
        a, b_ = int8.dot_inputs(dev, m, k, n)
        plan = cp.i8_dot_plan(m, k, n)
        shape = f"({m}, {k}) @ ({k}, {n}), {plan.ctas} CTAs"
        op = lambda: cp.i8_dot(a, b_)
        first = lambda: cp.i8_dot_bytes(a, b_)
        exact = cp.i8_dot_plain(a, b_)
        for label, got in (("the exact product", op()), ("i8_dot_bytes", first())):
            if not torch.equal(got, exact):
                raise AssertionError(f"i8_dot {shape}: not equal to {label}")
        want = exact.double()
        nbytes, flops = float(m * k + k * n + 4 * m * n), 2.0 * m * k * n * tc
        library = lambda: torch._int_mm(a, b_)
        ms = redesign_line(rec, steps, "i8_dot", "i8_dot_bytes", shape, op, first, library, None,
                           lambda c: c.double(), want, nbytes, flops, yard_label="first design")
        alone = [(label, kernel_alone_ms(symbol, run)[0]) for label, symbol, run in (
            ("i8_dot", "i8_dot_kernel", op), ("first design", "i8_dot_bytes_kernel", first),
            ("torch._int_mm", "gemm", library))]
        log(f"  redesign alone (profiler events), i8_dot {shape}: " + "  ".join(
            f"{label} {'not measured' if t is None else f'{t:.4f} ms'}" for label, t in alone) +
            f"  (by chain {ms:.4f} ms)")
        if "i8_dot_bytes" not in rec.times:
            rec.check("i8_dot_bytes", lambda: first().double(), want, shape)
            rec.time("i8_dot_bytes", f"{m} x {k} @ {k} x {n}", first,
                     lambda: cp.i8_dot_plain(a, b_), library, nbytes, flops)
        del a, b_, exact, want
    return steps


def phase_halo_slice8_redesign(rec: KernelRecord, dev) -> dict[str, dict[str, int]]:
    """K10 and K14d's slice8_add redesigned.  K10 at phase 8's chunk shape,
    the blocks as coll.shard_time gives them on one card: ring_plan's route
    "view" held and printed; ring_halo and its yardstick ring_halo_table (the
    pointer table) torch.equal to ring_halo_plain, one launch each; a
    redesign line (by chain beside ring_halo_table as a counted session of
    its own, the same-input library call torch.stack of the heads, the
    bound), then each by events and alone (the profiler's events of its
    kernel; of every kernel the stack launches).  slice8_add at 16384 x 1024
    torch.equal to add_one_plain and to slice8_add_sync; a redesign line
    beside slice8_add_sync, torch.add a plane, K12's copy and reshape_add;
    then each alone.  The yardsticks are checked and timed for the kernels
    line here."""
    from godsp_tpu_torch.ops import cuda_halo, cuda_metrics, launch_counts
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.parallel import _collectives as coll
    from godsp_tpu_torch.probes._common import lane_planes

    steps: dict[str, dict[str, int]] = {}
    g = torch.Generator(device=dev).manual_seed(21)
    block, halo = SEGS * 512, 512
    ext = torch.rand(1, SP * block + halo, generator=g, device=dev) * 2 - 1
    blocks = coll.shard_time(ext[:, : SP * block], [dev] * SP)
    plan = cuda_halo.ring_plan(blocks, halo)
    if plan.route != "view":
        raise AssertionError(f"ring_halo: shard_time's blocks take the {plan.route} route")
    shape = f"{SP} blocks x 1 row x {block}, halo {halo}"
    want = torch.stack(cuda_halo.ring_halo_plain(blocks, halo))
    op = lambda: cuda_halo.ring_halo(blocks, halo)
    first = lambda: cuda_halo.ring_halo_table(blocks, halo)
    heads = lambda: torch.stack([b[..., :halo] for b in blocks[1:] + blocks[:1]])
    for name, run in (("ring_halo", op), ("ring_halo_table", first)):
        before = launch_counts()[name]
        if not torch.equal(torch.stack(run()), want) or launch_counts()[name] != before + 1:
            raise AssertionError(f"{name} {shape}: not one launch equal to its plain version")
    if not torch.equal(heads(), want):
        raise AssertionError("ring_halo's library call differs from its plain version")
    log(f"K10 and slice8_add redesigned vs their first designs; K10's plan at {shape}: {plan}")
    nbytes = 8.0 * SP * halo
    ms = redesign_line(rec, steps, "ring_halo", "ring_halo_table", shape, op, first, heads, None,
                       torch.stack, want.double(), nbytes, 0.0, yard_label="table route")
    events = [(label, time_ms(run)) for label, run in (
        ("K10", op), ("table route", first), ("torch.stack of the heads", heads))]
    alone = [(label, kernel_alone_ms(symbol, run)[0]) for label, symbol, run in (
        ("K10", "ring_halo_view_kernel", op), ("table route", "ring_halo_table_kernel", first))]
    rows = kernel_alone_ms("", heads)[1]  # every kernel the stack launches, 50 calls
    alone.append(("torch.stack of the heads",
                  sum(e.self_device_time_total for e in rows) / 1e3 / 50 if rows else None))
    log(f"  redesign by events, ring_halo {shape}: " + "  ".join(
        f"{label} {t:.4f} ms" for label, t in events) + f"  (by chain {ms:.4f} ms)")
    log(f"  redesign alone (profiler events), ring_halo {shape}: " + "  ".join(
        f"{label} {'not measured' if t is None else f'{t:.4f} ms'}" for label, t in alone))
    rec.err["ring_halo_table"] = 0.0
    rec.time("ring_halo_table", shape, first,
             lambda: torch.stack(cuda_halo.ring_halo_plain(blocks, halo)), heads, nbytes, 0.0)
    del ext, blocks, want
    b, n = LANE_B, LANE_N
    xr, xi = lane_planes(dev, b, n, seed=21)
    pts = float(b * n)
    shape = f"{b} x {n}"
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    op = lambda: cp.slice8_add(xr, xi)
    first = lambda: cp.slice8_add_sync(xr, xi)
    library = lambda: (torch.add(xr, 1.0, out=yr), torch.add(xi, 1.0, out=yi))
    plain = cp.add_one_plain(xr, xi)
    for name, run in (("slice8_add", op), ("slice8_add_sync", first)):
        got = run()
        if not (torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])):
            raise AssertionError(f"{name} {shape}: not equal to add_one_plain")
    copy = lambda: cuda_metrics.copy_split(xr, xi)
    reshape = lambda: cp.reshape_add(xr, xi)
    # Held to the float32 plain version, which both designs equal bit for bit.
    ms = redesign_line(rec, steps, "slice8_add", "slice8_add_sync", shape, op, first, library,
                       copy, cplx, cplx(plain), 16.0 * pts, 2.0 * pts,
                       extra=("reshape_add", reshape), yard_label="first design")
    alone = [(label, kernel_alone_ms(symbol, run, reps=20)[0]) for label, symbol, run in (
        ("slice8_add", "slice8_kernel", op), ("first design", "add_one_kernel", first),
        ("reshape_add", "add_one_kernel", reshape), ("K12 copy", "copy_split_kernel", copy))]
    log(f"  redesign alone (profiler events), slice8_add {shape}: " + "  ".join(
        f"{label} {'not measured' if t is None else f'{t:.4f} ms'}" for label, t in alone) +
        f"  (by chain {ms:.4f} ms)")
    rec.err["slice8_add_sync"] = 0.0
    rec.time("slice8_add_sync", f"{b} x {n}", first, lambda: cp.add_one_plain(xr, xi), library,
             16.0 * pts, 2.0 * pts)
    del xr, xi, yr, yi, plain
    return steps


def phase_hi_store_redesign(rec: KernelRecord, dev) -> dict[str, dict[str, int]]:
    """K14d's bd_hi and K14c's slicestore redesigned.  bd_hi's plan as the C
    side exports it (gdsp_bd_hi_geometry from the resident pairs the card
    reports) held to the host's (cuda_probes.bd_hi_plan) at ragged b and
    n1 = 1, 3, 8, 16; at 16384 x 1024 bd_hi and its first design
    bd_hi_sync >= 120 dB against the float64 plain version and against
    each other (all three printed), the TF32 flags untouched; a redesign
    line (by chain beside bd_hi_sync as a counted session of its own,
    torch.matmul of the complex64 slices and F128 with TF32 off, the
    bound), then each alone by the profiler's events (the GEMM kernel
    too).  slicestore and slicestore_sync torch.equal to their input; a
    redesign line beside slicestore_sync, copy_ a plane, K12's copy and
    concatstore; then each alone.  The yardsticks are checked and timed
    for the kernels line here."""
    import ctypes

    from godsp_tpu_torch.ops import _build, cuda_metrics
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes import anatomy2
    from godsp_tpu_torch.probes._common import TF32_FLOPS, lane_planes
    from godsp_tpu_torch.utils.metrics import FP32_FLOPS

    lib, out = _build.library(), (ctypes.c_int * 10)()
    resident = cp._hi_resident(dev)
    for n in (128, 384, 1024, 2048):
        for b in (1, 65, 1001, 16384):
            plan = tuple(cp.bd_hi_plan(b, n, resident))
            rc = lib.gdsp_bd_hi_geometry(b, n, resident, out)
            if rc != 0 or tuple(out) != plan:
                raise AssertionError(f"bd_hi's plan at {b} x {n}: {tuple(out)} against the "
                                     f"host's {plan}")
    steps: dict[str, dict[str, int]] = {}
    b, n = LANE_B, LANE_N
    xr, xi = lane_planes(dev, b, n, seed=22)
    pts = float(b * n)
    plan = cp.bd_hi_plan(b, n, resident)
    log(f"bd_hi and slicestore redesigned vs their first designs; bd_hi's plan equals the "
        f"host's, at {b} x {n}: {plan}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("bd_hi's library call: TF32 is on")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    want = cplx(cp.bd_hi_plain(xr.double(), xi.double()))
    op = lambda: cp.bd_hi(xr, xi)
    first = lambda: cp.bd_hi_sync(xr, xi)
    new_c, first_c = cplx(op()), cplx(first())
    dbs = (snr_on_card(new_c, want), snr_on_card(first_c, want), snr_on_card(new_c, first_c))
    del new_c, first_c
    log(f"  bd_hi {b} x {n}, chain {plan.chain}: {dbs[0]:.2f} dB against float64, first design "
        f"{dbs[1]:.2f}, against each other {dbs[2]:.2f}")
    if not min(dbs) >= SNR_DB:
        raise AssertionError(f"bd_hi {b} x {n}: {dbs} dB, not all >= {SNR_DB}")
    if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != flags:
        raise AssertionError("bd_hi changed a TF32 flag")
    shape = (f"{b} x {n}, {plan.pairs} pairs of CTAs, {plan.smem} B shared a CTA, chain "
             f"{plan.chain} ({dbs[0]:.2f} dB)")
    library = anatomy2.ops(xr, xi, anatomy2.tw_row(dev, n))["bd_hi"][1]
    flops = 2304.0 * pts * FP32_FLOPS / TF32_FLOPS  # TF32 operations, at the float32 rate
    ms = redesign_line(rec, steps, "bd_hi", "bd_hi_sync", shape, op, first, library, None, cplx,
                       want, 16.0 * pts, flops, yard_label="first design")
    alone = [(label, kernel_alone_ms(symbol, run, reps=20)[0]) for label, symbol, run in (
        ("bd_hi", "bd_hi_kernel", op), ("first design", "bd_hi_sync_kernel", first),
        ("torch.matmul", "gemm", library))]
    log(f"  redesign alone (profiler events), bd_hi {shape}: " + "  ".join(
        f"{label} {'not measured' if t is None else f'{t:.4f} ms'}" for label, t in alone) +
        f"  (by chain {ms:.4f} ms)")
    rec.check("bd_hi_sync", lambda: cplx(first()), want, f"{b} x {n}")
    rec.time("bd_hi_sync", f"{b} x {n}", first, lambda: cp.bd_hi_plain(xr, xi), library,
             16.0 * pts, flops)
    del want, library
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    op = lambda: cp.slicestore(xr, xi)
    first = lambda: cp.slicestore_sync(xr, xi)
    for name, run in (("slicestore", op), ("slicestore_sync", first)):
        got = run()
        if not (torch.equal(got[0], xr) and torch.equal(got[1], xi)):
            raise AssertionError(f"{name} {b} x {n}: differs from its input")
    library = lambda: (yr.copy_(xr), yi.copy_(xi))
    copy = lambda: cuda_metrics.copy_split(xr, xi)
    concat = lambda: cp.concatstore(xr, xi)
    ms = redesign_line(rec, steps, "slicestore", "slicestore_sync", f"{b} x {n}", op, first,
                       library, copy, cplx, cplx((xr, xi)), 16.0 * pts, 0.0,
                       extra=("concatstore", concat), yard_label="first design")
    alone = [(label, kernel_alone_ms(symbol, run, reps=20)[0]) for label, symbol, run in (
        ("slicestore", "slicestore_kernel", op),
        ("first design", "slicestore_sync_kernel", first),
        ("K12 copy", "copy_split_kernel", copy), ("concatstore", "concatstore_kernel", concat))]
    log(f"  redesign alone (profiler events), slicestore {b} x {n}: " + "  ".join(
        f"{label} {'not measured' if t is None else f'{t:.4f} ms'}" for label, t in alone) +
        f"  (by chain {ms:.4f} ms)")
    rec.err["slicestore_sync"] = 0.0
    rec.time("slicestore_sync", f"{b} x {n}", first,
             lambda: cuda_metrics.copy_split_plain(xr, xi), library, 16.0 * pts, 0.0)
    del xr, xi, yr, yi
    return steps


# K14d's bd_tf32 and K14h's vdif redesigned (PR 23): bd_tf32 at the probe's
# shape (timed) and a ragged one; vdif at the probe's shape (timed), a
# ragged n1 4 and once each at n1 1 and 2.
BD1_REDESIGN = ((LANE_B, LANE_N), (1001, 2048))
VDIF_REDESIGN = ((LANE_B, LANE_N), (1001, 512), (257, 128), (33, 256))


def call_device_ms(run, reps: int = 20):
    """ms of device time a call of run(), every kernel it launches summed, by
    the profiler's events over reps calls (device events only: an operator's
    row may repeat its kernels' time); None where none was recorded."""
    rows = [e for e in kernel_alone_ms("", run, reps)[1]
            if e.device_type != torch.autograd.DeviceType.CPU]
    return sum(e.self_device_time_total for e in rows) / 1e3 / reps if rows else None


def phase_bd1_vdif_redesign(rec: KernelRecord, dev) -> dict[str, dict[str, int]]:
    """K14d's bd_tf32 and K14h's vdif redesigned.  bd_tf32's plan as the C
    side exports it (gdsp_bd_tf32_geometry from the resident CTAs the card
    reports) held to the host's (cuda_probes.bd_tf32_plan) at ragged b and
    n1 = 1, 3, 8, 16; at each BD1_REDESIGN shape bd_tf32 and its first
    design bd_tf32_sync >= 120 dB against bd_tf32_plain with TF32-rounded
    operands summed in float64 (both printed), the identity and
    cyclic-shift tables torch.equal to the rounded and rolled slices, the
    TF32 flags untouched; at 16384 x 1024 a redesign line (by chain beside
    bd_tf32_sync as a counted session of its own, torch.matmul of the
    (b, 8, 128) views and Re F128 with TF32 on for that call, K12's copy,
    the bound), then each alone by the profiler's events (a library call:
    all its kernels' device time a call).  vdif's plan
    (gdsp_vdif_geometry) held to vdif_plan at each width; at each
    VDIF_REDESIGN shape vdif and vdif_sync >= 120 dB against the float64
    plain version (both printed), the digit order exact; at 16384 x 1024 a
    redesign line beside vdif_sync, torch.fft.fft(norm="ortho"), K12's copy
    and the bound, then each alone.  The yardsticks are checked and timed
    for the kernels line here."""
    import ctypes

    from godsp_tpu_torch.ops import _build, cuda_metrics
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes import anatomy2, vdif
    from godsp_tpu_torch.probes._common import TF32_FLOPS, lane_planes
    from godsp_tpu_torch.utils.metrics import FP32_FLOPS

    lib = _build.library()
    out, out64 = (ctypes.c_int * 8)(), (ctypes.c_int64 * 3)()
    resident = cp._b1_resident(dev)
    for n in (128, 384, 1024, 2048):
        for b in (1, 65, 1001, 16384):
            plan = tuple(cp.bd_tf32_plan(b, n, resident))
            if lib.gdsp_bd_tf32_geometry(b, n, resident, out) != 0 or tuple(out) != plan:
                raise AssertionError(f"bd_tf32's plan at {b} x {n}: {tuple(out)} against the "
                                     f"host's {plan}")
    for n in (128, 256, 512, 1024):
        for b in (1, 5, 1001, 16384):
            plan = tuple(cp.vdif_plan(b, n))
            if lib.gdsp_vdif_geometry(b, n, out64) != 0 or tuple(out64) != plan:
                raise AssertionError(f"vdif's plan at {b} x {n}: {tuple(out64)} against the "
                                     f"host's {plan}")
    steps: dict[str, dict[str, int]] = {}
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tc = FP32_FLOPS / TF32_FLOPS
    log(f"bd_tf32 and vdif redesigned vs their first designs; both plans equal the host's; "
        f"bd_tf32 at {LANE_B} x {LANE_N}: {cp.bd_tf32_plan(LANE_B, LANE_N, resident)}; vdif: "
        f"{cp.vdif_plan(LANE_B, LANE_N)}")
    for b, n in BD1_REDESIGN:
        xr, xi = lane_planes(dev, b, n, seed=23)
        pts = float(b * n)
        shape = f"{b} x {n}"
        want = cplx(cp.bd_tf32_plain(xr.double(), xi.double(), tf32=True))
        op = lambda: cp.bd_tf32(xr, xi)
        first = lambda: cp.bd_tf32_sync(xr, xi)
        dbs = (snr_on_card(cplx(op()), want), snr_on_card(cplx(first()), want))
        log(f"  bd_tf32 {shape}: {dbs[0]:.2f} dB against its TF32-rounded float64 plain "
            f"version, first design {dbs[1]:.2f}")
        if not min(dbs) >= SNR_DB:
            raise AssertionError(f"bd_tf32 {shape}: {dbs} dB, not both >= {SNR_DB}")
        eye = torch.eye(128, device=dev)
        for table, what, planes in (
                (eye, "identity", [cp.round_tf32(v) for v in (xr, xi)]),
                (torch.roll(eye, 1, dims=1), "cyclic shift",
                 [torch.roll(cp.round_tf32(v).view(b, -1, 128), 1, dims=2).reshape(b, n)
                  for v in (xr, xi)])):
            for name in ("bd_tf32", "bd_tf32_sync"):
                got = getattr(cp, name)(xr, xi, table)
                if not (torch.equal(got[0], planes[0]) and torch.equal(got[1], planes[1])):
                    raise AssertionError(f"{name} {shape}: the {what} table is not exact")
            log(f"  bd_tf32 and bd_tf32_sync {shape}: the {what} table torch.equal")
        del got, planes
        if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != flags:
            raise AssertionError("bd_tf32 changed a TF32 flag")
        if (b, n) == (LANE_B, LANE_N):
            library = anatomy2.ops(xr, xi, anatomy2.tw_row(dev, n))["bd1"][1]
            copy = lambda: cuda_metrics.copy_split(xr, xi)
            flops = 512.0 * pts * tc
            ms = redesign_line(rec, steps, "bd_tf32", "bd_tf32_sync", f"{shape} ({dbs[0]:.2f} dB)",
                               op, first, library, copy, cplx, want, 16.0 * pts, flops,
                               yard_label="first design")
            alone = [(label, kernel_alone_ms(symbol, run, reps=20)[0]) for label, symbol, run in (
                ("bd_tf32", "bd_tf32_kernel", op), ("first design", "bd_tf32_sync_kernel", first),
                ("K12 copy", "copy_split_kernel", copy))]
            alone.insert(2, ("torch.matmul TF32", call_device_ms(library)))
            log(f"  redesign alone (profiler events), bd_tf32 {shape}: " + "  ".join(
                f"{label} {'not measured' if t is None else f'{t:.4f} ms'}" for label, t in alone)
                + f"  (by chain {ms:.4f} ms)")
            if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != flags:
                raise AssertionError("bd_tf32's library call left a TF32 flag changed")
            rec.check("bd_tf32_sync", lambda: cplx(first()), want, shape)
            rec.time("bd_tf32_sync", shape, first, lambda: cp.bd_tf32_plain(xr, xi, tf32=True),
                     library, 16.0 * pts, flops)
            del library
        del xr, xi, want
    for b, n in VDIF_REDESIGN:
        xr, xi = lane_planes(dev, b, n, seed=23)
        pts = float(b * n)
        s = n ** -0.5
        shape = f"{b} x {n}"
        want = cplx(cp.vdif_plain(xr.double(), xi.double(), s))
        op = lambda: cp.vdif(xr, xi, s)
        first = lambda: cp.vdif_sync(xr, xi, s)
        dbs = (snr_on_card(cplx(op()), want), snr_on_card(cplx(first()), want))
        exact = vdif.digit_order_exact(dev, n, s)
        log(f"  vdif {shape} (n1 {n // 128}): {dbs[0]:.2f} dB against float64, first design "
            f"{dbs[1]:.2f}; digit order exact: {exact}")
        if not (min(dbs) >= SNR_DB and exact):
            raise AssertionError(f"vdif {shape}: {dbs} dB, digit order exact {exact}")
        if (b, n) == (LANE_B, LANE_N):
            z = torch.complex(xr, xi)
            library = lambda: torch.fft.fft(z, norm="ortho")
            copy = lambda: cuda_metrics.copy_split(xr, xi)
            flops = vdif.OPS_PER_POINT["vdif"] * pts
            ms = redesign_line(rec, steps, "vdif", "vdif_sync", f"{shape} ({dbs[0]:.2f} dB)", op,
                               first, library, copy, cplx, want, 16.0 * pts, flops,
                               yard_label="first design")
            alone = [(label, kernel_alone_ms(symbol, run, reps=20)[0]) for label, symbol, run in (
                ("vdif", "vdif_kernel", op), ("first design", "vdif_sync_kernel", first),
                ("K12 copy", "copy_split_kernel", copy))]
            alone.insert(2, ("torch.fft.fft", call_device_ms(library)))
            log(f"  redesign alone (profiler events), vdif {shape}: " + "  ".join(
                f"{label} {'not measured' if t is None else f'{t:.4f} ms'}" for label, t in alone)
                + f"  (by chain {ms:.4f} ms)")
            rec.check("vdif_sync", lambda: cplx(first()), want, shape)
            rec.time("vdif_sync", shape, first, lambda: cp.vdif_plain(xr, xi, s), library,
                     16.0 * pts, flops)
            del z, library
        del xr, xi, want
    return steps


# K14d's anat_full and K14a's pwfloor_staged redesigned: anat_full
# at the probe's shape (timed), a ragged one and once each at n1 1 (the
# partner k-box in the same slice) and n1 3 (half a slice off);
# pwfloor_staged (nfft, hop, pad, segments, kept, timed) at phase 12's two
# geometries, at hop 160 over 52,428 segments (timed beside the probe
# geometry) and once at pad 4096 (the block route).
ANAT_REDESIGN = ((LANE_B, LANE_N), (1001, 2048), (257, 128), (33, 384))
STAGED_REDESIGN = ((1024, 512, 1024, 16384, 16384, True),
                   (1024, 160, 1024, (1 << 23) // 160, (1 << 23) // 160, True),
                   (1000, 160, 1024, 5001, 4990, False), (4096, 1024, 4096, 5000, 5000, False))


def phase_anat_staged_redesign(rec: KernelRecord, dev) -> dict[str, dict[str, int]]:
    """K14d's anat_full and K14a's pwfloor_staged redesigned.  anat_full's
    plan as the C side exports it (gdsp_anat_full_geometry from the resident
    pairs the card reports) held to the host's (cuda_probes.anat_full_plan)
    at ragged b and n1 = 1, 3, 8, 16, 128, and the staged CTA
    (gdsp_pwfloor_staged_geometry) to cuda_probes.staged_cta; at each
    ANAT_REDESIGN shape anat_full and its first design anat_full_sync >= 120
    dB against the float64 plain version (both printed); at 16384 x 1024 a
    redesign line (by chain beside anat_full_sync as a counted session of
    its own, K12's copy, the unfused route half3 + the row as torch's
    elementwise calls + bd_hi, the bound), then each alone by the profiler's
    events (the unfused route: all its kernels' device time a call).  At
    each STAGED_REDESIGN geometry pwfloor_staged torch.equal to K4 at the
    same tiles and >= 120 dB against float64; at the two timed ones a
    redesign line beside pwfloor_staged_radix2 (a counted session), K4 and
    the bound, then each alone.  The yardsticks are checked and timed for
    the kernels line here."""
    import ctypes

    from godsp_tpu_torch import window
    from godsp_tpu_torch.ops import _build, cuda_metrics, cuda_pwelch
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes import anat_staged, anatomy2
    from godsp_tpu_torch.probes._common import TF32_FLOPS, lane_planes
    from godsp_tpu_torch.utils.metrics import FP32_FLOPS

    lib = _build.library()
    out, out64 = (ctypes.c_int * 12)(), (ctypes.c_int64 * 4)()
    resident = cp._anat_resident(dev)
    for n in (128, 384, 1024, 2048, 16384):
        for b in (1, 65, 1001, 16384):
            plan = tuple(cp.anat_full_plan(b, n, resident))
            if lib.gdsp_anat_full_geometry(b, n, resident, out) != 0 or tuple(out) != plan:
                raise AssertionError(f"anat_full's plan at {b} x {n}: {tuple(out)} against the "
                                     f"host's {plan}")
    for lg in (9, 10, 11, 12):
        for tile, hop in ((1, 512), (16, 512), (50, 160), (5, 1024)):
            want = cp.staged_cta(1 << lg, tile, 1 << lg, hop)
            if lib.gdsp_pwfloor_staged_geometry(lg, tile, 1 << lg, hop, out64) != 0 or \
                    tuple(out64) != want:
                raise AssertionError(f"the staged CTA at pad {1 << lg}, tile {tile}: "
                                     f"{tuple(out64)} against the host's {want}")
    steps: dict[str, dict[str, int]] = {}
    tc = FP32_FLOPS / TF32_FLOPS
    log(f"anat_full and pwfloor_staged redesigned vs their first designs; both plans equal the "
        f"host's; anat_full at {LANE_B} x {LANE_N}: {cp.anat_full_plan(LANE_B, LANE_N, resident)}")
    for b, n in ANAT_REDESIGN:
        xr, xi = lane_planes(dev, b, n, seed=24)
        tw = anatomy2.tw_row(dev, n)
        pts = float(b * n)
        shape = f"{b} x {n}"
        want = cplx(cp.anat_full_plain(xr.double(), xi.double(), tw))
        op = lambda: cp.anat_full(xr, xi, tw)
        first = lambda: cp.anat_full_sync(xr, xi, tw)
        dbs = (snr_on_card(cplx(op()), want), snr_on_card(cplx(first()), want))
        log(f"  anat_full {shape} (n1 {n // 128}): {dbs[0]:.2f} dB against float64, first "
            f"design {dbs[1]:.2f}")
        if not min(dbs) >= SNR_DB:
            raise AssertionError(f"anat_full {shape}: {dbs} dB, not both >= {SNR_DB}")
        if (b, n) == (LANE_B, LANE_N):
            route = lambda: anat_staged.unfused_route(xr, xi, tw)
            copy = lambda: cuda_metrics.copy_split(xr, xi)
            flops = max(10.0 * pts, 2304.0 * pts * tc)
            ms = redesign_line(rec, steps, "anat_full", "anat_full_sync",
                               f"{shape} ({dbs[0]:.2f} dB)", op, first, None, copy, cplx, want,
                               16.0 * pts, flops, extra=("unfused half3 + row + bd_hi", route),
                               yard_label="first design")
            alone = [(label, kernel_alone_ms(symbol, run, reps=20)[0]) for label, symbol, run in (
                ("anat_full", "anat_full_kernel", op),
                ("first design", "anat_full_sync_kernel", first),
                ("K12 copy", "copy_split_kernel", copy))]
            alone.insert(2, ("unfused route", call_device_ms(route)))
            log(f"  redesign alone (profiler events), anat_full {shape}: " + "  ".join(
                f"{label} {'not measured' if t is None else f'{t:.4f} ms'}" for label, t in alone)
                + f"  (by chain {ms:.4f} ms)")
            rec.check("anat_full_sync", lambda: cplx(first()), want, shape)
            rec.time("anat_full_sync", shape, first, lambda: cp.anat_full_plain(xr, xi, tw), None,
                     16.0 * pts, flops)
        del xr, xi, want
    for nfft, hop, pad, S, keep, timed in STAGED_REDESIGN:
        g = torch.Generator(device=dev).manual_seed(hop)
        L = (S - 1) * hop + nfft
        ext = torch.rand(1, L, generator=g, device=dev) * 2 - 1
        mask = (torch.arange(S, device=dev) < keep).float()[None]
        w = window.window_table("hann", pad, device=dev, dtype=torch.float32)
        bt = cp.staged_segs_per_tile(S, 1, nfft, hop, pad)
        if bt != cuda_pwelch.segs_per_tile(S, 1):
            raise AssertionError(f"staged tiles {bt} differ from K4's")
        shape = f"nfft {nfft} hop {hop} pad {pad}, {keep} of {S} segments"
        op = lambda: cp.pwfloor_staged(ext, mask, w, nfft, hop, pad)
        k4 = lambda: cuda_pwelch.pwelch_power_partials(ext, mask, w, nfft, hop, pad)
        want = cp.pwfloor_staged_plain(ext.double(), mask.double(), w.double(), nfft, hop, pad, bt)
        equal, db = torch.equal(op(), k4()), snr_on_card(op(), want)
        log(f"  pwfloor_staged {shape}: torch.equal to K4 at tiles of {bt}: {equal}; {db:.2f} dB "
            f"against float64")
        if not (equal and db >= SNR_DB):
            raise AssertionError(f"pwfloor_staged {shape}: equal to K4 {equal}, {db:.2f} dB")
        if timed:
            first = lambda: cp.pwfloor_staged_radix2(ext, mask, w, nfft, hop, pad, bt=bt)
            tiles = -(-S // bt)
            nbytes = 4.0 * (L + S + pad + tiles * (pad // 2 + 1))
            flops = keep * (nfft + rfft_flops(pad) + 3.0 * (pad // 2 + 1))
            ms = redesign_line(rec, steps, "pwfloor_staged", "pwfloor_staged_radix2",
                               f"{shape} ({db:.2f} dB)", op, first, None, None, lambda t: t, want,
                               nbytes, flops, extra=("K4", k4), yard_label="first design")
            alone = [(label, kernel_alone_ms(symbol, run, reps=20)[0]) for label, symbol, run in (
                ("pwfloor_staged", "staged_partials_kernel", op),
                ("first design", "spectral_twin_kernel", first),
                ("K4", "pwelch_partials_kernel", k4))]
            log(f"  redesign alone (profiler events), pwfloor_staged {shape}: " + "  ".join(
                f"{label} {'not measured' if t is None else f'{t:.4f} ms'}" for label, t in alone)
                + f"  (by chain {ms:.4f} ms)")
            if hop == 512:
                rec.check("pwfloor_staged_radix2", first, want, shape)
                rec.time("pwfloor_staged_radix2", shape, first,
                         lambda: cp.pwfloor_staged_plain(ext, mask, w, nfft, hop, pad, bt), None,
                         nbytes, flops)
        del ext, mask, want
    return steps


# K14a's pwfloor_noframe: (pad, hop, frames, kept); hop None takes seeded
# random frames, a hop the frames cut from anat_staged's samples at that hop
# (timed, beside K4 on those samples): the probe geometry, phase 12's
# ragged pad-2048 case, the block route at pad 4096 and hop 160's 52,428
# segments.  K14i's sdif_peel: 2^24 points (timed), phase 17's ragged
# shape, m = 1 and m = 33.
NOFRAME_REDESIGN = ((1024, 512, 16384, 16384), (2048, None, 5001, 4990), (4096, None, 300, 290),
                    (1024, 160, (1 << 23) // 160, (1 << 23) // 160))
SDIF_REDESIGN = ((1, 128, 1 << 17), (3, 128, 1000), (2, 128, 1), (1, 128, 33))


def phase_noframe_sdif_redesign(rec: KernelRecord, dev) -> dict[str, dict[str, int]]:
    """K14a's pwfloor_noframe and K14i's sdif_peel redesigned.  sdif_peel's
    plan as the C side exports it (gdsp_sdif_geometry) held to the host's
    (cuda_probes.sdif_plan), ragged m and batches past grid.y included.  At
    each NOFRAME_REDESIGN case pwfloor_noframe torch.equal to K4 on the
    frames flattened (nfft = hop = pad, K4's tiles) and >= 120 dB against
    the float64 plain version; at the two timed ones a redesign line beside
    pwfloor_noframe_radix2 (a counted session of its own), K4 on the samples
    the frames were cut from and the bound, then each alone.  At each
    SDIF_REDESIGN shape sdif_peel and its first design sdif_peel_sync >= 120
    dB against float64 (both printed); at 2^24 a redesign line beside
    sdif_peel_sync (a counted session), K8 outer_dft_split(x, 128, 1) on the
    same planes, K12's copy and the bound, then each alone.  The yardsticks
    are checked and timed for the kernels line here."""
    import ctypes

    from godsp_tpu_torch import window
    from godsp_tpu_torch.ops import _build, cuda_metrics, cuda_outer, cuda_pwelch
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes import noframe_sdif
    from godsp_tpu_torch.probes._common import lane_planes

    lib, out = _build.library(), (ctypes.c_int64 * 4)()
    for m in (1, 31, 33, 1000, 8192, 1 << 17):
        for b in (0, 1, 3, 65537):
            plan = tuple(cp.sdif_plan(m, b))
            if lib.gdsp_sdif_geometry(m, b, out) != 0 or tuple(out) != plan:
                raise AssertionError(f"sdif_peel's plan at {b} x (128, {m}): {tuple(out)} against "
                                     f"the host's {plan}")
    steps: dict[str, dict[str, int]] = {}
    log(f"pwfloor_noframe and sdif_peel redesigned vs their first designs; sdif's plan equals the "
        f"host's: {cp.sdif_plan(1 << 17, 1)} at (1, 128, 131072)")

    g = torch.Generator(device=dev).manual_seed(25)
    for pad, hop, S, keep in NOFRAME_REDESIGN:
        if hop:
            ext, frames, mask, _ = noframe_sdif.noframe_inputs(dev, hop, S)
            ext, frames, mask = ext[None], frames[None], mask[None]
            shape = f"{S} frames of {pad} cut at hop {hop}"
        else:
            frames = torch.rand(1, S, pad, generator=g, device=dev) * 2 - 1
            mask = (torch.arange(S, device=dev) < keep).float()[None]
            shape = f"{keep} of {S} frames of {pad}"
        w = window.window_table("hann", pad, device=dev, dtype=torch.float32)
        bt = cuda_pwelch.segs_per_tile(S, 1)
        op = lambda: cp.pwfloor_noframe(frames, mask, w)
        k4f = lambda: cuda_pwelch.pwelch_power_partials(frames.view(1, -1), mask, w, pad, pad)
        want = cp.pwfloor_noframe_plain(frames.double(), mask.double(), w.double(), bt)
        equal, db = torch.equal(op(), k4f()), snr_on_card(op(), want)
        log(f"  pwfloor_noframe {shape}: torch.equal to K4 on the flattened frames at tiles of "
            f"{bt}: {equal}; {db:.2f} dB against float64")
        if not (equal and db >= SNR_DB):
            raise AssertionError(f"pwfloor_noframe {shape}: equal to K4 {equal}, {db:.2f} dB")
        if hop:
            first = lambda: cp.pwfloor_noframe_radix2(frames, mask, w)
            k4 = lambda: cuda_pwelch.pwelch_power_partials(ext, mask, w, pad, hop)
            tiles = -(-S // bt)
            nbytes = 4.0 * (frames.numel() + S + pad + tiles * (pad // 2 + 1))
            flops = keep * (pad + rfft_flops(pad) + 3.0 * (pad // 2 + 1))
            ms = redesign_line(rec, steps, "pwfloor_noframe", "pwfloor_noframe_radix2",
                               f"{shape} ({db:.2f} dB)", op, first, None, None, lambda t: t, want,
                               nbytes, flops, extra=("K4 on the samples", k4),
                               yard_label="first design")
            alone_line("pwfloor_noframe", shape, ms, (
                ("pwfloor_noframe", "noframe_partials_kernel", op),
                ("first design", "spectral_twin_kernel", first),
                ("K4 on the samples", "pwelch_partials_kernel", k4)))
            if hop == 512:
                rec.check("pwfloor_noframe_radix2", first, want, shape)
                rec.time("pwfloor_noframe_radix2", shape, first,
                         lambda: cp.pwfloor_noframe_plain(frames, mask, w, bt), None, nbytes,
                         flops)
            del ext
        del frames, mask, want
    for shape in SDIF_REDESIGN:
        xr, xi = (p.view(shape) for p in lane_planes(dev, shape[0] * shape[1], shape[2], seed=25))
        label = " x ".join(map(str, shape))
        want = cplx(cp.sdif_peel_plain(xr.double(), xi.double()))
        op = lambda: cp.sdif_peel(xr, xi)
        first = lambda: cp.sdif_peel_sync(xr, xi)
        dbs = (snr_on_card(cplx(op()), want), snr_on_card(cplx(first()), want))
        log(f"  sdif_peel {label}: {dbs[0]:.2f} dB against float64, first design {dbs[1]:.2f}")
        if not min(dbs) >= SNR_DB:
            raise AssertionError(f"sdif_peel {label}: {dbs} dB, not both >= {SNR_DB}")
        if shape == SDIF_REDESIGN[0]:
            pts = float(xr.numel())
            k8 = lambda: cuda_outer.outer_dft_split(xr, xi, 128, 1)
            copy = lambda: cuda_metrics.copy_split(xr.view(-1, 8192), xi.view(-1, 8192))
            ms = redesign_line(rec, steps, "sdif_peel", "sdif_peel_sync",
                               f"{label} ({dbs[0]:.2f} dB)", op, first, None, copy, cplx, want,
                               16.0 * pts, 41.0 * pts,
                               extra=("K8 outer_dft_split(x, 128, 1)", k8),
                               yard_label="first design")
            alone_line("sdif_peel", label, ms, (
                ("sdif_peel", "sdif_peel_kernel", op),
                ("first design", "sdif_peel_sync_kernel", first),
                ("K8", "outer_dft_kernel", k8)))
            rec.check("sdif_peel_sync", lambda: cplx(first()), want, label)
            rec.time("sdif_peel_sync", label, first, lambda: cp.sdif_peel_plain(xr, xi), None,
                     16.0 * pts, 41.0 * pts)
        del xr, xi, want
    return steps


# K14g's i8full: (b, n), the probe's planes (timed), phase 21's ragged
# (1001, 512) and a ragged (33, 384).  K14a's pwfloor_frameonly: (nfft, hop,
# pad, segments, kept, timed), phase 12's two cases (the probe geometry
# timed), the block route at pad 4096 and hop 160's 52,428 segments
# (timed); a timed case takes anat_staged's samples, the others seeded
# uniform ones with the last segments masked.
I8FULL_REDESIGN = ((16384, 1024), (1001, 512), (33, 384))
FRAMEONLY_REDESIGN = ((1024, 512, 1024, 16384, 16384, True), (1000, 160, 1024, 5001, 4990, False),
                      (4096, 1024, 4096, 300, 290, False),
                      (1024, 160, 1024, (1 << 23) // 160, (1 << 23) // 160, True))


def phase_i8full_frameonly_redesign(rec: KernelRecord, dev) -> dict[str, dict[str, int]]:
    """K14g's i8full and K14a's pwfloor_frameonly redesigned.  i8full's plan
    as the C side exports it (gdsp_i8full_geometry) held to the host's
    (cuda_probes.i8full_plan) at the card's resident CTAs and fewer, ragged
    b and b past grid.y included.  At each I8FULL_REDESIGN shape i8full
    torch.equal to i8full_plain, to i8_concat and to its first design
    i8full_sync; at 16384 x 1024 a redesign line (its dB against the
    float64 product) beside i8full_sync (a counted session of its own), the
    library call (torch.matmul of the complex64 slices and K13's G, TF32
    off), i8mm, i8_concat and the bound, then each alone.  At each
    FRAMEONLY_REDESIGN case pwfloor_frameonly and its first design
    pwfloor_frameonly_shared >= 120 dB against the float64 plain version;
    at the probe geometry and at 52,428 segments of hop 160 a redesign line
    beside pwfloor_frameonly_shared (a counted session), pwfloor_loadonly,
    K4 on the same samples and the bound, then each alone, and K4 less
    frameonly by chain.  The yardsticks are checked and timed for the
    kernels line here."""
    import ctypes

    from godsp_tpu_torch import window
    from godsp_tpu_torch.ops import _build, cuda_pwelch
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes import anat_staged
    from godsp_tpu_torch.probes._common import (INT8_OPS, complex_matmul, lane_planes,
                                                planes_equal)
    from godsp_tpu_torch.utils.metrics import FP32_FLOPS

    lib, out = _build.library(), (ctypes.c_int * 6)()
    resident = cp._i8full_resident(dev)
    for b, n in ((0, 128), (1, 128), (33, 384), (1001, 512), (16384, 1024), (16 * 65535 + 17, 128)):
        for res in (1, 7, resident):
            plan = tuple(cp.i8full_plan(b, n, res))
            if lib.gdsp_i8full_geometry(b, n, res, out) != 0 or tuple(out) != plan:
                raise AssertionError(f"i8full's plan at ({b}, {n}) over {res} CTAs: {tuple(out)} "
                                     f"against the host's {plan}")
    steps: dict[str, dict[str, int]] = {}
    log(f"i8full and pwfloor_frameonly redesigned vs their first designs; i8full's plan equals "
        f"the host's: {cp.i8full_plan(16384, 1024, resident)} at 16384 x 1024")

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("i8full's library call: TF32 is on")
    for b, n in I8FULL_REDESIGN:
        xr, xi = lane_planes(dev, b, n, seed=26)
        label = f"{b} x {n}"
        op = lambda: cp.i8full(xr, xi)
        first = lambda: cp.i8full_sync(xr, xi)
        got = op()
        eq = {"plain": planes_equal(got, cp.i8full_plain(xr, xi)),
              "i8_concat": planes_equal(got, cp.i8_concat(xr, xi)),
              "first design": planes_equal(got, first())}
        log(f"  i8full {label}: torch.equal to {eq}")
        if not all(eq.values()):
            raise AssertionError(f"i8full {label}: equal to {eq}")
        if (b, n) == I8FULL_REDESIGN[0]:
            pts = float(b * n)
            want = cplx(cp.gmm_tf32_plain(xr.double(), xi.double()))
            db = snr_on_card(cplx(got), want)
            flops = max(43.0 * pts, 4608.0 * pts * FP32_FLOPS / INT8_OPS)
            matmul = complex_matmul(xr, xi)
            mm, cat = (lambda: cp.i8mm(xr, xi)), (lambda: cp.i8_concat(xr, xi))
            ms = redesign_line(rec, steps, "i8full", "i8full_sync", f"{label} ({db:.2f} dB)", op,
                               first, matmul, None, cplx, want, 16.0 * pts, flops,
                               extra=(("i8mm", mm), ("i8_concat", cat)),
                               yard_label="first design")
            alone_line("i8full", label, ms, (
                ("i8full", "i8full_kernel", op), ("first design", "i8_probe_kernel", first),
                ("i8mm", "i8_probe_kernel", mm), ("i8_concat", "i8_concat_kernel", cat)))
            rec.check("i8full_sync", lambda: cplx(first()), cplx(cp.i8full_plain(xr, xi)),
                      f"{label}, equal to its plain version")
            rec.time("i8full_sync", label, first, lambda: cp.i8full_plain(xr, xi), matmul,
                     16.0 * pts, flops)
            del want
        del xr, xi, got
    g = torch.Generator(device=dev).manual_seed(26)
    for nfft, hop, pad, S, keep, timed in FRAMEONLY_REDESIGN:
        if timed:
            ext, mask, _ = anat_staged.pwelch_inputs(dev, hop, S)
            ext, mask = ext[None], mask[None]
        else:
            ext = torch.rand(1, (S - 1) * hop + nfft - 3, generator=g, device=dev) * 2 - 1
            mask = (torch.arange(S, device=dev) < keep).float()[None]
        w = window.window_table("hann", pad, device=dev, dtype=torch.float32)
        bt = cuda_pwelch.segs_per_tile(S, 1)
        shape = f"{keep} of {S} segments, nfft {nfft}, hop {hop}, pad {pad}"
        op = lambda: cp.pwfloor_frameonly(ext, mask, w, nfft, hop, pad)
        first = lambda: cp.pwfloor_frameonly_shared(ext, mask, w, nfft, hop, pad)
        want = cp.pwfloor_frameonly_plain(ext.double(), mask.double(), w.double(), nfft, hop, pad,
                                          bt)
        dbs = (snr_on_card(op(), want), snr_on_card(first(), want))
        log(f"  pwfloor_frameonly {shape}: {dbs[0]:.2f} dB against float64, first design "
            f"{dbs[1]:.2f}")
        if not min(dbs) >= SNR_DB:
            raise AssertionError(f"pwfloor_frameonly {shape}: {dbs} dB, not both >= {SNR_DB}")
        if timed:
            load = lambda: cp.pwfloor_loadonly(ext, mask, w, nfft, hop, pad)
            k4 = lambda: cuda_pwelch.pwelch_power_partials(ext, mask, w, nfft, hop, pad=pad)
            tiles = -(-S // bt)
            nbytes = 4.0 * (ext.numel() + S + pad + tiles * pad)
            flops = 2.0 * keep * nfft
            ms = redesign_line(rec, steps, "pwfloor_frameonly", "pwfloor_frameonly_shared",
                               f"{shape} ({dbs[0]:.2f} dB)", op, first, None, None, lambda t: t,
                               want, nbytes, flops, extra=(("loadonly", load), ("K4", k4)),
                               yard_label="first design")
            alone_line("pwfloor_frameonly", shape, ms, (
                ("pwfloor_frameonly", "frameonly_partials_kernel", op),
                ("first design", "frameonly_kernel", first),
                ("loadonly", "loadonly_kernel", load), ("K4", "pwelch_partials_kernel", k4)))
            from godsp_tpu_torch.probes._common import chained
            from godsp_tpu_torch.utils.metrics import time_chain_diff

            k4_ms = time_chain_diff(chained(k4), ext) * 1e3
            log(f"  K4 less pwfloor_frameonly by chain, {shape}: {k4_ms - ms:.4f} ms (K4 "
                f"{k4_ms:.4f}, frameonly {ms:.4f}): K4's transform, split and |X|^2")
            if hop == 512:
                rec.check("pwfloor_frameonly_shared", first, want, shape)
                rec.time("pwfloor_frameonly_shared", shape, first,
                         lambda: cp.pwfloor_frameonly_plain(ext, mask, w, nfft, hop, pad, bt),
                         None, nbytes, flops)
        del ext, mask, want
    return steps


def phase_stft_kernels(rec: KernelRecord, dev) -> None:
    """K5 in its three modes and K6 against their float64 plain versions,
    at the shapes of phase 5, plus an odd hop with pad > nfft."""
    from godsp_tpu_torch import window
    from godsp_tpu_torch.models import mel_filterbank
    from godsp_tpu_torch.ops import cuda_istft, cuda_stft

    g = torch.Generator(device=dev).manual_seed(1)
    n = FS * SECONDS
    x = torch.rand(n, generator=g, device=dev) * 2 - 1  # [-1, 1), zero-mean like decoded PCM16
    x64 = x.double()
    fb = mel_filterbank(80, NFFT, FS, device=dev, dtype=torch.float32)
    # The three modes on the whole recording's length, then complex at an
    # odd hop with pad > nfft on its first 2^22 samples.
    for out, hop, pad, L in (("complex", 256, NFFT, n), ("power", 512, NFFT, n),
                             ("mel", 256, NFFT, n), ("complex", 160, 2048, min(n, 1 << 22))):
        w = torch.nn.functional.pad(window.window_table("hann", NFFT, device=dev), (0, pad - NFFT))
        F = (L - NFFT) // hop + 1
        name = f"stft_{out}"
        kernel, mel_fb = getattr(cuda_stft, name), ((fb,) if out == "mel" else ())
        xs, xs64 = x[:L], x64[:L]
        shape = f"nfft {NFFT} hop {hop} pad {pad} x {F} frames"
        want = cuda_stft.stft_pallas_plain(xs64, w, NFFT, hop, F, pad, out, fb.double())
        rec.check(name, lambda: kernel(xs, w.float(), NFFT, hop, F, *mel_fb, pad=pad), want, shape)
        del want
        if name not in rec.times:  # time the first shape of each mode
            lp = pad // 2 + 1
            band = cuda_stft.mel_band(fb)
            band_bins = float((band[:, 1] - band[:, 0] + 1).clamp(min=0).sum())
            out_bytes = {"complex": 8.0 * lp, "power": 4.0 * lp, "mel": 4.0 * fb.shape[0]}[out]
            flops = F * (NFFT + rfft_flops(pad)
                         + {"complex": 0.0, "power": 3.0 * lp, "mel": 3.0 * lp + 2.0 * band_bins}[out])
            wn = w[:NFFT].float()
            # torch.stft computes the complex mode (bins x frames); no one
            # call computes the power or mel spectra.
            library = (lambda: torch.stft(xs, NFFT, hop_length=hop, window=wn, center=False,
                                          return_complex=True)) if out == "complex" else None
            rec.time(name, shape, lambda: kernel(xs, w.float(), NFFT, hop, F, *mel_fb, pad=pad),
                     lambda: cuda_stft.stft_pallas_plain(xs, w.float(), NFFT, hop, F, pad, out,
                                                         fb),
                     library, 4.0 * (L + pad) + F * out_bytes
                     + (4.0 * fb.numel() if out == "mel" else 0.0), flops)
    # K6 at a spectra_to_wav chunk, at the Griffin-Lim shape (60 s), and at
    # an odd hop with pad > nfft.
    w = window.window_table("hann", NFFT, device=dev)
    for F, hop, pad in K6_SHAPES:
        spec = torch.complex(torch.randn(F, pad // 2 + 1, generator=g, device=dev),
                             torch.randn(F, pad // 2 + 1, generator=g, device=dev))
        shape = f"nfft {NFFT} hop {hop} pad {pad} x {F} frames"
        want = cuda_istft.istft_overlap_add_plain(c128(spec), w, NFFT, hop)
        rec.check("istft_overlap_add",
                  lambda: cuda_istft.istft_overlap_add(spec, w.float(), NFFT, hop), want, shape)
        if F == CHUNK and hop == 256:
            # torch.istft also divides by the window-energy sum: not the same function.
            wf = w.float()
            rec.time("istft_overlap_add", shape,
                     lambda: cuda_istft.istft_overlap_add(spec, wf, NFFT, hop),
                     lambda: cuda_istft.istft_overlap_add_plain(spec, wf, NFFT, hop),
                     None, 8.0 * spec.numel() + 4.0 * NFFT + 4.0 * ((F - 1) * hop + NFFT),
                     F * (rfft_flops(pad) + 2.0 * NFFT))
            rec.device_time("istft_overlap_add", "istft_kernel",
                            lambda: cuda_istft.istft_overlap_add(spec, wf, NFFT, hop))


def k8_shapes(n: int, batch: int = 1) -> list[tuple[int, int, int]]:
    """The (batch, m, n3) views the large plan hands K8 for one N-point
    transform of `batch` rows: one call, or two above m = MAX_ROWS."""
    from godsp_tpu_torch.fft import large

    m, n3 = large._plan(n)
    if m <= large._MAX_ROWS:
        return [(batch, m, n3)]
    g, m2 = large._balanced(m)
    return [(batch, g, m2 * n3), (batch * g, m2, n3)]


def phase_outer_kernel(rec: KernelRecord, dev) -> None:
    """K8 against its float64 plain version at every shape phase 6 gives
    it (the 2^28 plan's two calls whole), timed at 2^24."""
    from godsp_tpu_torch.dsputils import next_power_of_2
    from godsp_tpu_torch.ops import cuda_outer

    pad = next_power_of_2(2 * FS * SECONDS - 1)  # hilbert's Bluestein pad, 2^26
    cases = ([(s, False) for s in k8_shapes(N20, B20)]
             + [(s, True) for s in k8_shapes(N24)]
             + [(s, False) for s in k8_shapes(N28)]
             + [(s, inv) for s in k8_shapes(pad) for inv in (False, True)])
    g = torch.Generator(device=dev).manual_seed(3)
    for (b, m, n3), inverse in cases:
        xr = torch.randn(b, m, n3, generator=g, device=dev)
        xi = torch.randn(b, m, n3, generator=g, device=dev)
        shape = f"{b} x ({m}, {n3}) {'inverse' if inverse else 'forward'}"
        want = cplx(cuda_outer.outer_dft_split_plain(xr.double(), xi.double(), m, 1, inverse))
        rec.check("outer_dft_split",
                  lambda: cplx(cuda_outer.outer_dft_split(xr, xi, m, 1, inverse)), want, shape)
        del want
        if (b, m, n3) == k8_shapes(N24)[0] and "outer_dft_split" not in rec.times:
            # No one PyTorch call computes a twiddled column DFT.
            points = b * m * n3
            rec.time("outer_dft_split", shape,
                     lambda: cuda_outer.outer_dft_split(xr, xi, m, 1, inverse),
                     lambda: cuda_outer.outer_dft_split_plain(xr, xi, m, 1, inverse),
                     None, 16.0 * points, fft_flops(m, points // m) + 12.0 * points)
        del xr, xi


def phase_peel_rows_kernel(rec: KernelRecord, dev) -> None:
    """K9 against its float64 plain version at the last peel of each fused
    step of phase 6 (16 x 2^20 forward, 2^24 inverse with the ifft's 1/N)
    and at its smallest row (an odd batch of n3 = 256), each timed beside
    its plain version, its bound and the separate route it replaces
    (K8 outer_dft_split(128, 1), then K1/K2 rows)."""
    from godsp_tpu_torch.ops import cuda_fft, cuda_outer

    g = torch.Generator(device=dev).manual_seed(9)
    for b, n3, inverse, scale in K9_SHAPES:
        xr = torch.randn(b, 128, n3, generator=g, device=dev)
        xi = torch.randn(b, 128, n3, generator=g, device=dev)
        shape = f"{b} x (128, {n3}) {'inverse' if inverse else 'forward'} scale {scale:.3g}"
        want = cplx(cuda_outer.peel_rows_fused_split_plain(xr.double(), xi.double(), inverse,
                                                           scale))
        rec.check("peel_rows_fused_split",
                  lambda: cplx(cuda_outer.peel_rows_fused_split(xr, xi, inverse, scale)), want,
                  shape)
        del want

        def kernel():
            return cuda_outer.peel_rows_fused_split(xr, xi, inverse, scale)

        def separate():
            yr, yi = cuda_outer.outer_dft_split(xr, xi, 128, 1, inverse)
            if inverse:
                return cuda_fft.ifft_pow2(yr, yi, scale)
            return cuda_fft.fft_pow2(yr, yi, scale=scale)

        # K9 is the (128 n3)-point DFT of each batch element read in row
        # order, bin k1 + 128 k3 stored at [k1, k3]: one torch.fft call on the
        # flattened rows computes it (the transpose is a view).
        z = torch.complex(xr, xi).reshape(b, -1)
        if inverse:
            def library():
                return torch.fft.ifft(z, norm="forward") * scale
        else:
            def library():
                return torch.fft.fft(z)
        # The kernels line keeps the first shape's times.
        bms, by = bound_ms(16.0 * b * 128 * n3, fft_flops(128 * n3, b))
        t = dict(ms=time_ms(kernel), separate_route_ms=time_ms(separate),
                 library_ms=time_ms(library),
                 plain_ms=time_ms(lambda: cuda_outer.peel_rows_fused_split_plain(
                     xr, xi, inverse, scale)), bound_ms=bms, bound_by=by, shape=shape)
        rec.times.setdefault("peel_rows_fused_split", t)
        log(f"  {'peel_rows_fused_split':22s} {shape}: kernel {t['ms']:.4f} ms, plain(f32) "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), library "
            f"torch.fft {t['library_ms']:.4f} ms; separate route K8 + "
            f"{'K2' if inverse else 'K1'} {t['separate_route_ms']:.4f} ms")
        del xr, xi, z


def phase_csd_kernel(rec: KernelRecord, dev) -> None:
    """K7 against its float64 plain version: at phase 7's shape (the whole
    recording at 1024/512, timed there), the speech hop 160 with nfft 1000
    and pad 1024, and pad 16384 (one shared buffer, the X_k in registers)."""
    from godsp_tpu_torch import window
    from godsp_tpu_torch.ops import cuda_csd, cuda_pwelch

    g = torch.Generator(device=dev).manual_seed(7)
    whole = (FS * SECONDS - 1024) // 512 + 1
    for nfft, stride, pad, S in ((1024, 512, 1024, whole), (1000, 160, 1024, 4096),
                                 (16384, 8192, 16384, 512)):
        L = (S - 1) * stride + nfft
        x = torch.rand(L, generator=g, device=dev) * 2 - 1  # [-1, 1), zero-mean like decoded PCM16
        y = 0.7 * torch.roll(x, DELAY) + 0.1 * torch.randn(L, generator=g, device=dev)
        keep = S - 3
        mask = (torch.arange(S, device=dev) < keep).float()
        w = window.window_table("hann", pad, device=dev, dtype=torch.float32)
        bt = cuda_pwelch.segs_per_tile(S, 1)
        what = f"nfft {nfft} hop {stride} pad {pad} S {S} keep {keep}"
        want = cplx(cuda_csd.csd_power_partials_plain(x.double(), y.double(), mask.double(),
                                                      w.double(), nfft, stride, pad, bt))
        rec.check("csd_power_partials",
                  lambda: cplx(cuda_csd.csd_power_partials(x, y, mask, w, nfft, stride, pad=pad)),
                  want, what)
        del want
        if S == whole:
            # No one PyTorch call frames two signals and sums their cross power.
            lp, tiles = pad // 2 + 1, -(-S // bt)
            rec.time("csd_power_partials", what,
                     lambda: cuda_csd.csd_power_partials(x, y, mask, w, nfft, stride, pad=pad),
                     lambda: cuda_csd.csd_power_partials_plain(x, y, mask, w, nfft, stride,
                                                               pad, bt),
                     None, 4.0 * (2 * L + S + pad + 2 * tiles * lp),
                     keep * (2.0 * (nfft + rfft_flops(pad)) + 8.0 * lp))
        del x, y


def phase_halo_kernels(rec: KernelRecord, dev) -> None:
    """K10 at phase 8's chunk shape, equal to its plain version, and K11
    against its float64 plain version at three shapes, timed at the first."""
    from godsp_tpu_torch import window
    from godsp_tpu_torch.ops import cuda_fused_halo, cuda_halo, cuda_pwelch, launch_counts

    g = torch.Generator(device=dev).manual_seed(10)
    # A StreamingPwelch chunk of phase 8 on the card: 8 blocks of 256 x 512
    # samples, views of the chunk + halo buffer (row stride 8 x 131,072 + 512).
    block, halo = SEGS * 512, 512
    ext = torch.rand(1, SP * block + halo, generator=g, device=dev) * 2 - 1
    blocks = list(ext[:, : SP * block].chunk(SP, dim=-1))
    shape = f"{SP} blocks x 1 row x {block}, halo {halo}"
    before = launch_counts()["ring_halo"]
    got = cuda_halo.ring_halo(blocks, halo)
    if launch_counts()["ring_halo"] != before + 1:
        raise AssertionError("ring_halo: not one launch for the ring")
    want = cuda_halo.ring_halo_plain(blocks, halo)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("ring_halo: differs from its plain version")
    rec.err["ring_halo"] = 0.0
    log(f"  {'ring_halo':22s} {shape:34s} equal to its plain version (torch.equal)")
    # The library call: one torch.stack of the heads of the same eight blocks.
    rec.time("ring_halo", shape, lambda: cuda_halo.ring_halo(blocks, halo),
             lambda: torch.stack(cuda_halo.ring_halo_plain(blocks, halo)),
             lambda: torch.stack([b[..., :halo] for b in blocks[1:] + blocks[:1]]),
             8.0 * SP * halo, 0.0)
    rec.device_time("ring_halo", "ring_halo_view_kernel",
                    lambda: cuda_halo.ring_halo(blocks, halo))
    del ext, blocks
    # K11: one shard of phase 8's chunk and its neighbour's head (views of
    # one signal), the last shard with an injected tail, and hop 160 with
    # nfft 1000 and pad 1024 (an 840-sample halo).
    for nfft, stride, pad, last in ((1024, 512, 1024, False), (1024, 512, 1024, True),
                                    (1000, 160, 1024, False)):
        S = SEGS
        L = S * stride
        sig = torch.rand(1, 2 * L, generator=g, device=dev) * 2 - 1
        x, src = sig[:, :L], sig[:, L:]
        if last:
            src = torch.rand(1, nfft - stride, generator=g, device=dev) * 2 - 1
        keep = S - 3 if last else S
        mask = (torch.arange(S, device=dev) < keep).float()
        w = window.window_table("hann", pad, device=dev, dtype=torch.float32)
        bt = cuda_pwelch.segs_per_tile(S, 1)
        what = (f"nfft {nfft} hop {stride} pad {pad} S {S} "
                f"{'tail' if last else 'neighbour'} {nfft - stride}")
        want = cuda_fused_halo.pwelch_power_partials_halo_plain(
            x.double(), src.double(), mask.double(), w.double(), nfft, stride, pad, bt)
        rec.check("pwelch_power_partials_halo",
                  lambda: cuda_fused_halo.pwelch_power_partials_halo(x, src, mask, w, nfft, stride,
                                                                     pad=pad),
                  want, what)
        if "pwelch_power_partials_halo" not in rec.times:
            # No one PyTorch call frames, windows, transforms and sums.
            H, tiles, lp = nfft - stride, -(-S // bt), pad // 2 + 1
            rec.time("pwelch_power_partials_halo", what,
                     lambda: cuda_fused_halo.pwelch_power_partials_halo(x, src, mask, w, nfft,
                                                                        stride, pad=pad),
                     lambda: cuda_fused_halo.pwelch_power_partials_halo_plain(
                         x, src, mask, w, nfft, stride, pad, bt),
                     None, 4.0 * (L + H + S + pad + tiles * lp),
                     keep * (nfft + rfft_flops(pad) + 3.0 * lp))
            rec.device_time("pwelch_power_partials_halo", "pwelch_partials_kernel",
                            lambda: cuda_fused_halo.pwelch_power_partials_halo(
                                x, src, mask, w, nfft, stride, pad=pad))
        del sig, want


def phase_metrics_kernels(rec: KernelRecord, dev) -> None:
    """K12 equal to its plain version at the flagship planes (1024 x 16384)
    and at an odd point count (the scalar tail); K13 against its float64
    plain version at 1024 x 16384 and at n = 128, 8192 and 16384 (n1 = 1
    .. 128), and torch.equal to its first design gmm_floor_sync at each,
    both timed at the flagship planes beside their bound and library
    yardstick."""
    from godsp_tpu_torch.ops import cuda_metrics, cuda_probes, launch_counts

    g = torch.Generator(device=dev).manual_seed(12)
    for b, n in ((PLANE // 1024, 1024), (7, 4099)):
        xr = torch.randn(b, n, generator=g, device=dev)
        xi = torch.randn(b, n, generator=g, device=dev)
        shape = f"{b} x {n}"
        before = launch_counts()["copy_split"]
        got = cuda_metrics.copy_split(xr, xi)
        if launch_counts()["copy_split"] != before + 1:
            raise AssertionError("copy_split: not one launch")
        want = cuda_metrics.copy_split_plain(xr, xi)
        if not all(torch.equal(a, c) for a, c in zip(got, want)):
            raise AssertionError(f"copy_split {shape}: differs from its plain version")
        rec.err["copy_split"] = 0.0
        log(f"  {'copy_split':22s} {shape:34s} equal to its plain version (torch.equal)")
        if n == 1024:
            yr, yi = torch.empty_like(xr), torch.empty_like(xi)
            rec.time("copy_split", shape, lambda: cuda_metrics.copy_split(xr, xi),
                     lambda: cuda_metrics.copy_split_plain(xr, xi),
                     lambda: (yr.copy_(xr), yi.copy_(xi)), 16.0 * b * n, 0.0)
        del xr, xi, got, want
    for n in (1024, 128, 8192, 16384):
        b = PLANE // n
        xr = torch.randn(b, n, generator=g, device=dev)
        xi = torch.randn(b, n, generator=g, device=dev)
        shape = f"N={n} x {b} (n1 {n // 128})"
        want = cplx(cuda_metrics.gmm_floor_plain(xr.double(), xi.double()))
        rec.check("gmm_floor", lambda: cplx(cuda_metrics.gmm_floor(xr, xi)), want, shape)
        del want
        got, first = cuda_metrics.gmm_floor(xr, xi), cuda_probes.gmm_floor_sync(xr, xi)
        if not (torch.equal(got[0], first[0]) and torch.equal(got[1], first[1])):
            raise AssertionError(f"gmm_floor {shape}: not equal to gmm_floor_sync")
        log(f"  {'gmm_floor':22s} {shape:34s} equal to gmm_floor_sync (torch.equal)")
        del got, first
        if n == 1024:
            # torch.matmul of the complex64 slices with the complex64 G:
            # one call, TF32 off (fault class a).
            gt = cuda_metrics.gmm_tables(n, dev)
            G = torch.complex(gt[:, 0], gt[:, 1])
            z = torch.complex(xr, xi).view(b, n // 128, 128).transpose(0, 1)
            if torch.backends.cuda.matmul.allow_tf32:
                raise AssertionError("gmm_floor yardstick: TF32 is on")
            rec.time("gmm_floor", shape, lambda: cuda_metrics.gmm_floor(xr, xi),
                     lambda: cuda_metrics.gmm_floor_plain(xr, xi), lambda: torch.matmul(z, G),
                     16.0 * b * n, 768.0 * b * n)
            del z, G
        del xr, xi


def write_recording(path: str, stereo_path: str | None = None) -> int:
    """Seeded sine mix + noise, 10 min of 44.1 kHz PCM16 mono; with
    stereo_path also the stereo twin: channel 0 the same mix, channel 1
    0.7 x channel 0 delayed by DELAY samples plus independent noise."""
    from godsp_tpu_torch import wav

    n = FS * SECONDS
    rng = np.random.default_rng(2024)
    rng1 = np.random.default_rng(2025)
    block = 1 << 20
    prev = np.zeros(DELAY)
    with contextlib.ExitStack() as stack:
        w = stack.enter_context(wav.WavWriter(path, FS, channels=1, float32=False))
        w2 = (stack.enter_context(wav.WavWriter(stereo_path, FS, channels=2, float32=False))
              if stereo_path else None)
        for i in range(0, n, block):
            t = np.arange(i, min(i + block, n)) / FS
            x = (0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(2 * np.pi * 3150.0 * t)
                 + 0.05 * np.sin(2 * np.pi * 11025.0 * t) + 0.1 * rng.normal(size=t.size))
            w.write(x)
            if w2 is not None:
                delayed = np.concatenate([prev, x])[: x.size]
                prev = x[-DELAY:]
                w2.write(np.stack([x, 0.7 * delayed + 0.1 * rng1.normal(size=x.size)]))
    return n


def oracle_pxx(samples: np.ndarray, opts, dev) -> np.ndarray:
    """float64 Pxx of the decoded samples on the card: Welch's frames
    (pwelch.go:104-136) over the plain transforms beneath the public entry
    points."""
    from godsp_tpu_torch import window
    from godsp_tpu_torch.dsputils import is_power_of_2, zero_pad
    from godsp_tpu_torch.fft import four_step_fft
    from godsp_tpu_torch.fft.bluestein import bluestein_fft
    from godsp_tpu_torch.spectral import segment

    nfft, wf, pad, noverlap, scaling = opts.resolved()
    fft_len, lp = max(pad, nfft), pad // 2 + 1
    x = torch.from_numpy(samples).to(dev, torch.float64)
    frames = zero_pad(segment(x, nfft, noverlap), fft_len)
    frames = frames * window.window_table(wf, fft_len, device=dev)
    z = c128(frames)
    del x, frames
    with plain_route():
        spec = (four_step_fft(z) if is_power_of_2(fft_len) else bluestein_fft(z))[..., :lp]
    p = (spec.real * spec.real + spec.imag * spec.imag).mean(dim=-2)
    p[1 : lp - 1] *= 2.0
    w_nfft = window.window_table(wf, nfft, device=dev)
    norm = torch.sum(w_nfft * w_nfft) * (FS if scaling else 1.0)
    return (p / norm).cpu().numpy()


def counted(label: str, run, steps: dict) -> tuple[object, float]:
    """run() as one step of the counted session; its launches go to steps[label]."""
    from godsp_tpu_torch.ops import launch_counts

    before = launch_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = launch_counts()
    steps[label] = {k: after[k] - before[k] for k in after}
    log(f"  step {label}: {wall:.3f} s, launches {steps[label]}")
    return out, wall


def read_frames(path: str) -> np.ndarray:
    """All frames of a multichannel recording as (L, channels), through
    Wav.read_channels."""
    from godsp_tpu_torch import wav

    r = wav.read_wav(path)
    try:
        return np.ascontiguousarray(r.read_channels(r.samples_remaining // r.num_channels).T)
    finally:
        r.close()


def read_decoded(path: str) -> np.ndarray:
    from godsp_tpu_torch import wav

    r = wav.read_wav(path)
    try:
        return r.read_floats(r.samples)
    finally:
        r.close()


def phase_main_path(dev, path: str) -> tuple[dict[str, int], dict[str, dict[str, int]]]:
    from godsp_tpu_torch import fft, spectral
    from godsp_tpu_torch.fft import four_step_fft
    from godsp_tpu_torch.models import wav_psd
    from godsp_tpu_torch.ops import launch_counts, reset_launch_counts

    decoded = read_decoded(path)
    n = decoded.size
    fused_o = spectral.PwelchOptions(**WELCH)
    unfused_o = spectral.PwelchOptions(**WELCH_UNFUSED)
    frames = torch.from_numpy(decoded[: (n // 1024) * 1024].reshape(-1, 1024)).to(dev)

    # A first call pays one-time costs (twiddle tables, allocator);
    # the counted session below is warm.
    t0 = time.perf_counter()
    wav_psd(path, fused_o, device=dev)
    log(f"  wav_psd nfft 1024/512 first call: {time.perf_counter() - t0:.3f} s")

    steps: dict[str, dict[str, int]] = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    res, wall = counted(FUSED, lambda: wav_psd(path, fused_o, device=dev), steps)
    res_u, wall_u = counted(UNFUSED, lambda: wav_psd(path, unfused_o, device=dev), steps)
    def spectra():
        spec = fft.fft_real(frames)
        return spec, fft.ifft(spec), fft.rfft_split(frames)

    (spec, back, (yr, yi)), _ = counted(FFT_API, spectra, steps)
    counts = launch_counts()

    log(f"  wav_psd nfft 1024/512 (fused): {res.metrics_json}")
    log(f"  wav_psd nfft 1024/512 wall {wall:.3f} s, {n / wall / 1e6:.3f} Msamples/s")
    log(f"  wav_psd nfft 1000/500 (unfused): {res_u.metrics_json}")
    log(f"  wav_psd nfft 1000/500 wall {wall_u:.3f} s, {n / wall_u / 1e6:.3f} Msamples/s")
    log(f"  launches in the main path: {counts}")
    chunks = json.loads(res.metrics_json)["chunks"]
    if steps[FUSED] != {**{k: 0 for k in counts}, "pwelch_power_partials": chunks}:
        raise AssertionError(f"fused wav_psd launched {steps[FUSED]} for {chunks} chunks")
    for label, names in ((UNFUSED, ("fft_pow2", "ifft_pow2")),
                         (FFT_API, ("fft_pow2", "ifft_pow2", "rfft_pow2"))):
        for name in names:
            if steps[label][name] <= 0:
                raise AssertionError(f"{label} did not launch {name}")

    for label, r, o in (("fused", res, fused_o), ("unfused", res_u, unfused_o)):
        want = oracle_pxx(decoded, o, dev)
        if r.pxx.shape != want.shape or not np.all(np.isfinite(r.pxx)):
            raise AssertionError(f"wav_psd {label}: bad Pxx {r.pxx.shape}")
        db = snr(r.pxx, want)
        log(f"  wav_psd {label} Pxx vs float64 oracle: {db:.2f} dB over {r.pxx.size} bins")
        if not db >= SNR_DB:
            raise AssertionError(f"wav_psd {label}: {db:.2f} dB < {SNR_DB} dB")

    want_spec = four_step_fft(c128(frames))
    checks = (
        ("fft_real", spec, want_spec),
        ("ifft(fft_real)", back, frames.double()),
        ("rfft_split", torch.complex(yr, yi), want_spec[:, :513]),
    )
    for label, got, want in checks:
        db = snr(got, want)
        log(f"  {label} on {tuple(frames.shape)}: {db:.2f} dB")
        if not db >= SNR_DB:
            raise AssertionError(f"{label}: {db:.2f} dB < {SNR_DB} dB")

    # The golden is a check, run after the session's counts were read.
    golden, _ = spectral.pwelch(torch.arange(100, dtype=torch.float32, device=dev), 2.0)
    db = snr(golden, golden_pxx())
    log(f"  129-bin golden through pwelch on the card: {db:.2f} dB")
    if golden.shape != (129,) or not db >= SNR_DB:
        raise AssertionError(f"golden: {db:.2f} dB < {SNR_DB} dB")
    return counts, steps


def check_db(label: str, got, want) -> float:
    db = snr(got, want)
    log(f"  {label}: {db:.2f} dB")
    if not db >= SNR_DB:
        raise AssertionError(f"{label}: {db:.2f} dB < {SNR_DB} dB")
    return db


def check_synthesis(label: str, got: np.ndarray, want: torch.Tensor) -> None:
    """Hold a float32 synthesis to its float64 oracle over the whole signal
    and over its interior [nfft, L - nfft).  The first and last
    nfft - hop samples divide by a NOLA sum of Hann's near-zero ends
    (w[1]^2 ~ 1e-10 at nfft 1024), which scales float32 rounding by as
    much; the interior shows the synthesis apart from that."""
    want = want.cpu().numpy()
    check_db(f"{label}, whole signal", got, want)
    check_db(f"{label}, interior", got[NFFT:-NFFT], want[NFFT:-NFFT])


def expect_launches(label: str, steps: dict, want: dict[str, int]) -> None:
    got = steps[label]
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{label} launched {got}, expected {full}")


def phase_stft_family(dev, path: str) -> dict[str, dict[str, int]]:
    """The STFT family at real size, as one counted session (phase 5)."""
    from godsp_tpu_torch import window
    from godsp_tpu_torch.models import (griffin_lim, istft, mel_filterbank, mel_spectrogram,
                                        spectra_to_wav, spectrogram_from_wav, stft)
    from godsp_tpu_torch.models._stft_impl import _nola_norm
    from godsp_tpu_torch.models.griffin import _gl_loop
    from godsp_tpu_torch.ops import cuda_istft, cuda_stft, launch_counts, reset_launch_counts

    decoded = read_decoded(path)
    n = decoded.size
    x = torch.from_numpy(decoded).to(dev)
    synth = os.path.join(os.path.dirname(path), "synthesis.wav")
    F = (n - NFFT) // 256 + 1
    L = (F - 1) * 256 + NFFT
    F60 = (FS * GL_SECONDS - NFFT) // 256 + 1
    L60 = (F60 - 1) * 256 + NFFT
    n_chunks = -(-F // CHUNK)

    def session(step):
        """The five steps; step(label, fn) runs each and returns its result."""
        sg, _, _ = step(SPECGRAM, lambda: spectrogram_from_wav(path, nfft=NFFT, hop=512,
                                                               device=dev))
        S = step(STFT, lambda: stft(x, NFFT, hop=256))
        M = step(MEL, lambda: mel_spectrogram(x, FS, nfft=NFFT, hop=256, n_mels=80))
        written = step(SYNTH, lambda: spectra_to_wav(
            (S[i : i + CHUNK] for i in range(0, F, CHUNK)), synth, FS, NFFT, hop=256))
        y_gl = step(GRIFFIN, lambda: griffin_lim(S[:F60].abs(), NFFT, hop=256, n_iter=GL_ITERS,
                                                 momentum=0.99))
        return sg, S, M, written, y_gl

    # A first pass pays one-time costs (filterbank and band tables,
    # allocator); the counted session below is warm.
    t0 = time.perf_counter()
    session(lambda label, fn: fn())
    torch.cuda.synchronize()
    log(f"STFT family: first pass {time.perf_counter() - t0:.3f} s")

    steps: dict[str, dict[str, int]] = {}
    walls: dict[str, float] = {}

    def step(label, fn):
        out, walls[label] = counted(label, fn, steps)
        return out

    reset_launch_counts()
    sg, S, M, written, y_gl = session(step)
    counts = launch_counts()

    log(f"  launches in the STFT-family session: {counts}")
    expect_launches(SPECGRAM, steps, {"stft_power": 1})
    expect_launches(STFT, steps, {"stft_complex": 1})
    expect_launches(MEL, steps, {"stft_mel": 1})
    expect_launches(SYNTH, steps, {"istft_overlap_add": n_chunks})
    expect_launches(GRIFFIN, steps, {"istft_overlap_add": GL_ITERS + 1, "stft_complex": GL_ITERS})
    for label, samples in ((SPECGRAM, n), (STFT, n), (MEL, n), (SYNTH, written),
                           (GRIFFIN, L60)):
        log(f"  {label}: wall {walls[label]:.3f} s, {samples / walls[label] / 1e6:.3f} Msamples/s")
    log(f"  {GRIFFIN}: {walls[GRIFFIN] / GL_ITERS * 1e3:.3f} ms per iteration")

    # Checks, after the counts were read: float64 oracles on the card from
    # the plain functions on the same decoded samples.
    x64 = x.double()
    w64 = window.window_table("hann", NFFT, device=dev)
    shapes = [tuple(t.shape) for t in (sg, S, M, y_gl)]
    if shapes != [((n - NFFT) // 512 + 1, NFFT // 2 + 1), (F, NFFT // 2 + 1), (F, 80), (L60,)]:
        raise AssertionError(f"shapes of spectrogram, stft, mel, griffin_lim: {shapes}")
    check_db("spectrogram_from_wav vs float64 oracle", sg,
             cuda_stft.stft_pallas_plain(x64, w64, NFFT, 512, sg.shape[0], out="power"))
    check_db("stft vs float64 oracle", S, cuda_stft.stft_pallas_plain(x64, w64, NFFT, 256, F))
    fb64 = mel_filterbank(80, NFFT, FS, device=dev, dtype=torch.float64)
    check_db("mel_spectrogram vs float64 oracle", M,
             cuda_stft.stft_pallas_plain(x64, w64, NFFT, 256, F, out="mel", fb=fb64))
    got = read_decoded(synth)
    if written != L or got.shape != (L,) or not np.all(np.isfinite(got)):
        raise AssertionError(f"spectra_to_wav wrote {written} samples, read {got.shape}, want {L}")
    want = cuda_istft.istft_overlap_add_plain(c128(S), w64, NFFT, 256) / _nola_norm(w64, F, 256, L)
    check_synthesis("spectra_to_wav WAV vs float64 istft of the same spectra", got, want)
    del want
    y = istft(S, NFFT, hop=256)
    log(f"  istft(stft(x)) vs x over [{NFFT}, {L - NFFT}):")
    check_db("    round trip, interior", y[NFFT:-NFFT], x64[NFFT : L - NFFT])

    # Griffin-Lim: float32 kernels against the float64 plain route.
    mag = S[:F60].abs()
    mag64 = mag.double()

    def fwd64(s):
        return cuda_stft.stft_pallas_plain(s, w64, NFFT, 256, F60)

    def ola64(s):
        return cuda_istft.istft_overlap_add_plain(s, w64, NFFT, 256)

    def convergence(y):
        return float(torch.linalg.vector_norm(fwd64(y.double()).abs() - mag64)
                     / torch.linalg.vector_norm(mag64))

    y0 = griffin_lim(mag, NFFT, hop=256, n_iter=0)
    want0 = _gl_loop(mag64, w64, 256, L60, 0, 0.99, fwd64, ola64)
    check_db("griffin_lim n_iter 0 vs float64 plain route", y0, want0)
    y64 = _gl_loop(mag64, w64, 256, L60, GL_ITERS, 0.99, fwd64, ola64)
    sc, sc64 = convergence(y_gl), convergence(y64)
    sc_db, sc64_db = 20 * np.log10(sc), 20 * np.log10(sc64)
    log(f"  griffin_lim n_iter {GL_ITERS}: spectral convergence kernel {sc:.6f} ({sc_db:.3f} dB), "
        f"float64 plain route {sc64:.6f} ({sc64_db:.3f} dB)")
    if not (np.isfinite(sc_db) and abs(sc_db - sc64_db) <= GL_SC_DB):
        raise AssertionError(f"griffin_lim: {sc_db:.3f} dB vs {sc64_db:.3f} dB, > {GL_SC_DB} dB")
    return steps


def oracle_hilbert(x64: torch.Tensor) -> torch.Tensor:
    """float64 analytic signal on the card from the plain functions beneath
    the public hilbert: Bluestein forward, the one-sided weights, and the
    index-reversed Bluestein inverse (fft.go:35-52)."""
    from godsp_tpu_torch.fft.bluestein import bluestein_fft

    n = x64.shape[-1]
    h = torch.zeros(n, dtype=torch.float64, device=x64.device)
    h[0] = 1.0
    h[1 : (n + 1) // 2] = 2.0
    if n % 2 == 0:
        h[n // 2] = 1.0
    with plain_route():
        z = bluestein_fft(c128(x64)) * h
        return bluestein_fft(torch.roll(torch.flip(z, dims=(-1,)), 1, dims=-1)) / n


def profile_by_kernel(label: str, fn, reps: int = 10) -> None:
    """fn's device time a call by kernel name, from torch.profiler's events
    over reps warm calls (device events only: an aten:: row repeats its
    kernels' time; the profiler may drop a few events, so the counts a
    call are printed beside)."""
    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp, trace_to(tmp) as prof:
        for _ in range(reps):
            fn()
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0
            and not e.key.startswith(("aten::", "Activity Buffer"))]
    rows.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in rows) / 1e3 / reps
    log(f"  profile {label}: device {total:.3f} ms a call in "
        f"{sum(e.count for e in rows) / reps:g} kernel calls")
    for e in rows[:6]:
        log(f"    {e.self_device_time_total / 1e3 / reps:9.3f} ms x{e.count / reps:<4g} "
            f"{e.key[:80]}")


def phase_fft_surface(dev, path: str) -> dict[str, dict[str, int]]:
    """The FFT surface at full size, as one counted session (phase 6)."""
    from godsp_tpu_torch import dsputils, fft
    from godsp_tpu_torch.bench import fused_route
    from godsp_tpu_torch.fft import four_step_fft, large
    from godsp_tpu_torch.ops import launch_counts, reset_launch_counts

    decoded = read_decoded(path)  # host data: hilbert gets no device
    g = torch.Generator(device=dev).manual_seed(6)

    def crand(*shape):
        return torch.complex(torch.randn(*shape, generator=g, device=dev),
                             torch.randn(*shape, generator=g, device=dev))

    x20, y24, x28 = crand(B20, N20), crand(N24), crand(N28)
    rng = np.random.default_rng(256)
    n3d = CUBE ** 3
    cube = dsputils.make_matrix(rng.normal(size=n3d) + 1j * rng.normal(size=n3d), [CUBE] * 3)

    def session(step):
        """The five steps; step(label, fn) runs each and returns its result."""
        a = step(FFT20, lambda: fft.fft(x20))
        b = step(IFFT24, lambda: fft.ifft(y24))
        c = step(FFT28, lambda: fft.fft(x28))
        h = step(HILBERT, lambda: fft.hilbert(decoded))
        m = step(FFTN, lambda: fft.fftn(cube))
        return a, b, c, h, m

    # A first pass pays one-time costs (twiddle and chirp tables,
    # allocator); the counted session below is warm.
    t0 = time.perf_counter()
    session(lambda label, fn: fn())
    torch.cuda.synchronize()
    log(f"FFT surface: first pass {time.perf_counter() - t0:.3f} s")

    steps: dict[str, dict[str, int]] = {}
    walls: dict[str, float] = {}

    def step(label, fn):
        out, walls[label] = counted(label, fn, steps)
        return out

    reset_launch_counts()
    y20, z24, y28, an, spec3 = session(step)
    counts = launch_counts()

    log(f"  launches in the FFT-surface session: {counts}")
    expect_launches(FFT20, steps, {"outer_dft_split": 1, "fft_pow2": 1})
    expect_launches(IFFT24, steps, {"outer_dft_split": 1, "ifft_pow2": 1})
    expect_launches(FFT28, steps, {"outer_dft_split": 2, "fft_pow2": 1})
    expect_launches(HILBERT, steps, {"outer_dft_split": 8, "fft_pow2": 2, "ifft_pow2": 2})
    expect_launches(FFTN, steps, {"fft_pow2": 3})
    if an.device.type != dev.type:
        raise AssertionError(f"hilbert of host data ran on {an.device}, not the card")
    if not isinstance(spec3, dsputils.Matrix) or spec3.dimensions() != [CUBE] * 3:
        raise AssertionError(f"fftn of a Matrix returned {spec3!r}")

    # Beside torch.fft (cuFFT) at the same shapes: device time, CUDA events.
    xdec = torch.from_numpy(decoded).to(dev)
    cube_dev = torch.from_numpy(cube.array).to(dev, torch.complex64)
    yardsticks = {
        FFT20: (x20.numel(), lambda: fft.fft(x20), lambda: torch.fft.fft(x20)),
        IFFT24: (y24.numel(), lambda: fft.ifft(y24), lambda: torch.fft.ifft(y24)),
        FFT28: (x28.numel(), lambda: fft.fft(x28), lambda: torch.fft.fft(x28)),
        HILBERT: (decoded.size, lambda: fft.hilbert(xdec), lambda: torch.fft.fft(xdec)),
        FFTN: (n3d, lambda: fft.fftn(cube_dev), lambda: torch.fft.fftn(cube_dev)),
    }
    device_ms = {}
    for label, (samples, ours, lib) in yardsticks.items():
        ms, lib_ms = device_ms[label] = time_ms(ours, reps=5), time_ms(lib, reps=5)
        log(f"  {label}: wall {walls[label]:.4f} s, {samples / walls[label] / 1e6:.1f} "
            f"Msamples/s; device {ms:.3f} ms ({samples / ms / 1e3:.1f} Msamples/s) on a "
            f"device tensor, torch.fft {lib_ms:.3f} ms")
    del xdec, cube_dev

    # The fused peel + rows route (K9, fft.large.set_fuse_rows_enabled) on
    # the three giant steps, as a counted sub-session of its own after one
    # warm-up pass; the switch is restored in a finally.
    fused_steps = ((F_FFT20, FFT20, lambda: fft.fft(x20)),
                   (F_IFFT24, IFFT24, lambda: fft.ifft(y24)),
                   (F_FFT28, FFT28, lambda: fft.fft(x28)))
    large.set_fuse_rows_enabled(True)
    try:
        for _, _, fn in fused_steps:
            fn()
        torch.cuda.synchronize()
        reset_launch_counts()
        f20, f24, f28 = (step(label, fn) for label, _, fn in fused_steps)
        log(f"  launches in the fused sub-session: {launch_counts()}")
        fused_ms = {label: time_ms(fn, reps=5) for label, _, fn in fused_steps}
    finally:
        large.set_fuse_rows_enabled(False)
    for label, unfused, fn in fused_steps[:2]:
        profile_by_kernel(f"{unfused} (unfused)", yardsticks[unfused][1])
        profile_by_kernel(label, fused_route(fn))
    expect_launches(F_FFT20, steps, {"peel_rows_fused_split": 1})
    expect_launches(F_IFFT24, steps, {"outer_dft_split": 1, "peel_rows_fused_split": 1})
    expect_launches(F_FFT28, steps, {"outer_dft_split": 2, "fft_pow2": 1})
    for label, unfused, _ in fused_steps:
        log(f"  {label}: wall {walls[label]:.4f} s (unfused {walls[unfused]:.4f} s); device "
            f"{fused_ms[label]:.3f} ms (unfused {device_ms[unfused][0]:.3f} ms, torch.fft "
            f"{device_ms[unfused][1]:.3f} ms)")
    if not torch.equal(f28, y28):
        raise AssertionError(f"{F_FFT28}: differs from the unfused run (2^28 does not fuse)")
    log(f"  {F_FFT28}: torch.equal to the unfused run")
    del f28

    # Checks, after the counts were read: float64 oracles on the card from
    # the plain functions, and the fused results against the unfused ones.
    want = four_step_fft(c128(x20))
    check_db(f"{FFT20} vs float64 four-step", y20, want)
    check_db(f"{F_FFT20} vs float64 four-step", f20, want)
    check_db(f"{F_FFT20} vs the unfused route", f20, y20)
    want = four_step_fft(c128(y24), inverse=True) / N24
    check_db(f"{IFFT24} vs float64 four-step", z24, want)
    check_db(f"{F_IFFT24} vs float64 four-step", f24, want)
    check_db(f"{F_IFFT24} vs the unfused route", f24, z24)
    del y20, z24, f20, f24, want
    want = four_step_fft(c128(x28))
    check_db(f"{FFT28} vs float64 four-step", y28, want)
    del want, y28
    check_db(f"{HILBERT} vs float64 Bluestein oracle", an,
             oracle_hilbert(torch.from_numpy(decoded).to(dev, torch.float64)))
    want = torch.from_numpy(cube.array).to(dev)
    for axis in range(3):
        want = four_step_fft(want.movedim(axis, -1)).movedim(-1, axis)
    check_db(f"{FFTN} vs float64 four-step per axis", spec3.array, want)
    return steps


def oracle_csd(x64: torch.Tensor, y64: torch.Tensor, opts) -> torch.Tensor:
    """float64 Pxy of the reference's csd on the card: frames, zero pad to
    pad, the symmetric pad-length window, the plain transforms, the mean
    of conj(X) Y, doubling of [1:lp-1] and the NFFT-window norm
    (pwelch.go:104-136 over two signals)."""
    from godsp_tpu_torch import window
    from godsp_tpu_torch.dsputils import zero_pad
    from godsp_tpu_torch.fft import four_step_fft
    from godsp_tpu_torch.spectral import segment

    nfft, wf, pad, noverlap, scaling = opts.resolved()
    dev = x64.device
    lp = pad // 2 + 1
    w = window.window_table(wf, pad, device=dev)
    acc = torch.zeros(lp, dtype=torch.complex128, device=dev)
    frames_x, frames_y = segment(x64, nfft, noverlap), segment(y64, nfft, noverlap)
    nsegs = frames_x.shape[-2]
    with plain_route():
        for i in range(0, nsegs, 1 << 15):  # blocks of segments: bounded memory
            X = four_step_fft(c128(zero_pad(frames_x[i : i + (1 << 15)], pad) * w))[..., :lp]
            Y = four_step_fft(c128(zero_pad(frames_y[i : i + (1 << 15)], pad) * w))[..., :lp]
            acc += (torch.conj(X) * Y).sum(dim=-2)
    acc = acc / nsegs
    acc[1 : lp - 1] *= 2.0
    w_nfft = window.window_table(wf, nfft, device=dev)
    return acc / (torch.sum(w_nfft * w_nfft) * (FS if scaling else 1.0))


def lomb_bound_db(t: np.ndarray, freqs: np.ndarray) -> float:
    """The SNR lombscargle's float32 run must reach against float64.

    Each float32 phase w*t carries at most four roundings of relative size
    u = 2^-24 (t, w, their product, and the subtraction of tau), so its
    error is at most 4 u max|w t| radians; sin and cos pass it on
    unscaled, and the power, a ratio of quadratic forms in them, moves by
    about that relative amount.  The row sums add log2(n) u, far below.
    So 20 log10(1 / (4 u max|w t|))."""
    return float(-20.0 * np.log10(4.0 * 2.0 ** -24 * np.max(np.abs(freqs)) * np.max(np.abs(t))))


def phase_scipy_spectra(dev, mono_path: str, stereo_path: str) -> dict[str, dict[str, int]]:
    """The scipy-convention spectra and the cross-spectra at real size, as
    one counted session (phase 7)."""
    import scipy.signal as ss

    from godsp_tpu_torch import parallel, spectral, wav
    from godsp_tpu_torch.ops import launch_counts, reset_launch_counts

    decoded = read_frames(stereo_path)  # (L, 2)
    n = decoded.shape[0]
    x = torch.from_numpy(decoded).to(dev)
    ch0, ch1 = x[:, 0], x[:, 1]
    o160 = spectral.PwelchOptions(nfft=1024, noverlap=864)
    rng = np.random.default_rng(65536)
    t_l = np.sort(rng.uniform(0.0, 1.0, LOMB_N))
    y_l = 0.5 + np.sin(2 * np.pi * 97.0 * t_l) + 0.3 * rng.normal(size=LOMB_N)
    f_l = np.linspace(2 * np.pi, 2 * np.pi * LOMB_FMAX, LOMB_F)
    t_d, y_d, f_d = (torch.from_numpy(a).to(dev) for a in (t_l, y_l, f_l))
    kw = dict(fs=FS, nperseg=1024, detrend=False)

    def session(step):
        """The ten steps; step(label, fn) runs each and returns its result."""
        r = {}
        r[W_FUSED] = step(W_FUSED, lambda: spectral.welch(x, FS, nperseg=1024, noverlap=512,
                                                          detrend=False, axis=0)[1])
        r[W_CONST] = step(W_CONST, lambda: spectral.welch(x, FS, nperseg=1024, noverlap=512,
                                                          axis=0)[1])
        r[W_MEDIAN] = step(W_MEDIAN, lambda: spectral.welch(x, FS, nperseg=1024, noverlap=512,
                                                            average="median", detrend=False,
                                                            axis=0)[1])
        r[W_CSD] = step(W_CSD, lambda: spectral.welch_csd(ch0, ch1, **kw)[1])
        r[W_COH] = step(W_COH, lambda: spectral.welch_coherence(ch0, ch1, **kw)[1])
        r[CSD160] = step(CSD160, lambda: spectral.csd(ch0, ch1, FS, o160)[0])
        r[COH160] = step(COH160, lambda: spectral.coherence(ch0, ch1, FS, o160)[0])
        r[SPEC_SCIPY] = step(SPEC_SCIPY, lambda: spectral.spectrogram_scipy(ch0, **kw)[2])
        r[STREAM_WELCH] = step(STREAM_WELCH, lambda: parallel.stream_welch(
            wav.read_wav(mono_path).blocks(1 << 20), FS, nperseg=1024, device=dev)[1])
        r[LOMB] = step(LOMB, lambda: spectral.lombscargle(t_d, y_d, f_d))
        return r

    # A first pass pays one-time costs (twiddle tables, allocator); the
    # counted session below is warm.
    t0 = time.perf_counter()
    session(lambda label, fn: fn())
    torch.cuda.synchronize()
    log(f"scipy spectra: first pass {time.perf_counter() - t0:.3f} s")

    steps: dict[str, dict[str, int]] = {}
    walls: dict[str, float] = {}

    def step(label, fn):
        out, walls[label] = counted(label, fn, steps)
        return out

    reset_launch_counts()
    r = session(step)
    counts = launch_counts()

    log(f"  launches in the scipy-spectra session: {counts}")
    chunk, halo = 256 * 512, 512  # StreamingPwelch's default chunk at hop 512
    full = (n - halo) // chunk
    chunks = full + (1 if n - full * chunk >= 1024 else 0)
    expect_launches(W_FUSED, steps, {"pwelch_power_partials": 1})
    expect_launches(W_CONST, steps, {"fft_pow2": 1})
    expect_launches(W_MEDIAN, steps, {"fft_pow2": 1})
    expect_launches(W_CSD, steps, {"csd_power_partials": 1})
    expect_launches(W_COH, steps, {"pwelch_power_partials": 2, "csd_power_partials": 1})
    expect_launches(CSD160, steps, {"csd_power_partials": 1})
    expect_launches(COH160, steps, {"csd_power_partials": 1, "pwelch_power_partials": 2})
    expect_launches(SPEC_SCIPY, steps, {"stft_power": 1})
    expect_launches(STREAM_WELCH, steps, {"pwelch_power_partials": chunks})
    expect_launches(LOMB, steps, {})
    for label in walls:
        samples = {W_FUSED: 2 * n, W_CONST: 2 * n, W_MEDIAN: 2 * n, W_CSD: 2 * n, W_COH: 2 * n,
                   CSD160: 2 * n, COH160: 2 * n, SPEC_SCIPY: n, STREAM_WELCH: n,
                   LOMB: LOMB_N}[label]
        log(f"  {label}: wall {walls[label]:.4f} s, {samples / walls[label] / 1e6:.3f} "
            f"Msamples/s")
    log(f"  {LOMB}: {LOMB_N * LOMB_F / walls[LOMB] / 1e9:.3f} G(time, frequency) pairs/s")

    # Checks, after the counts were read.  scipy.signal in float64 on the
    # host, on the same decoded samples.
    x64 = decoded.astype(np.float64)
    a64, b64 = x64[:, 0], x64[:, 1]
    mono = read_decoded(mono_path).astype(np.float64)
    want = {
        W_FUSED: ss.welch(x64, FS, nperseg=1024, noverlap=512, detrend=False, axis=0)[1],
        W_CONST: ss.welch(x64, FS, nperseg=1024, noverlap=512, axis=0)[1],
        W_MEDIAN: ss.welch(x64, FS, nperseg=1024, noverlap=512, average="median",
                           detrend=False, axis=0)[1],
        W_CSD: ss.csd(a64, b64, **kw)[1],
        W_COH: ss.coherence(a64, b64, **kw)[1],
        SPEC_SCIPY: ss.spectrogram(a64, **kw)[2],
        STREAM_WELCH: ss.welch(mono, FS, nperseg=1024, detrend=False)[1],
    }
    for label, ref in want.items():
        got = r[label]
        if tuple(got.shape) != ref.shape:
            raise AssertionError(f"{label}: shape {tuple(got.shape)}, scipy {ref.shape}")
        check_db(f"{label} vs scipy.signal float64", got, ref)
    del want
    # The reference-convention cross-spectra: float64 on the card.
    c0, c1 = ch0.double(), ch1.double()
    pxy = oracle_csd(c0, c1, o160)
    pxx, pyy = oracle_csd(c0, c0, o160).real, oracle_csd(c1, c1, o160).real
    check_db(f"{CSD160} vs float64 oracle", r[CSD160], pxy)
    check_db(f"{COH160} vs float64 oracle", r[COH160], (pxy.real**2 + pxy.imag**2) / (pxx * pyy))
    # lombscargle: float32 on the card against its own float64 run on the CPU.
    want_l = spectral.lombscargle(torch.from_numpy(t_l), torch.from_numpy(y_l),
                                  torch.from_numpy(f_l))
    bound = lomb_bound_db(t_l, f_l)
    db = snr(r[LOMB], want_l)
    log(f"  {LOMB} vs its float64 CPU run: {db:.2f} dB (bound {bound:.2f} dB, max|w t| "
        f"{np.max(f_l) * np.max(t_l):.1f} rad)")
    if r[LOMB].shape != (LOMB_F,) or not db >= bound:
        raise AssertionError(f"lombscargle: {db:.2f} dB < {bound:.2f} dB")
    return steps


def stream_chunks(n: int, chunk: int, halo: int, nfft: int) -> int:
    """Chunks StreamingPwelch runs over n samples: the full ones (each
    with its halo buffered) and the zero-padded remainder."""
    full = (n - halo) // chunk
    return full + (1 if n - full * chunk >= nfft else 0)


def phase_mesh(dev, path: str, stereo_path: str) -> dict[str, dict[str, int]]:
    """The mesh-sharded paths at real size, as one counted session (phase 8)."""
    from godsp_tpu_torch import fft, models, parallel, spectral, wav, window
    from godsp_tpu_torch.fft import four_step_fft
    from godsp_tpu_torch.models._stft_impl import _nola_norm
    from godsp_tpu_torch.ops import cuda_istft, cuda_stft, launch_counts, reset_launch_counts

    mesh8 = parallel.make_mesh(parallel.MeshConfig(dp=1, sp=SP), devices=[dev] * SP)
    mesh24 = parallel.make_mesh(parallel.MeshConfig(dp=2, sp=4), devices=[dev] * 8)
    if not (mesh8.one_device and mesh24.one_device):
        raise AssertionError("phase 8 meshes must sit on the one card")
    o = spectral.PwelchOptions(**WELCH)
    decoded = read_decoded(path)
    n = decoded.size
    cut = n // (SP * 512) * (SP * 512)
    x = torch.from_numpy(decoded[:cut]).to(dev)
    spec = models.stft(x, NFFT, hop=256)  # the input of the istft step, outside the session
    F8 = spec.shape[0] // SP * SP
    spec = spec[:F8]
    g = torch.Generator(device=dev).manual_seed(8)
    z = torch.complex(torch.randn(N24, generator=g, device=dev),
                      torch.randn(N24, generator=g, device=dev))

    def stereo_stream(mesh):
        sp = parallel.StreamingPwelch(FS, o, mesh, channels=2, halo_impl=("fused", False),
                                      device=None if mesh is not None else dev)
        r = wav.read_wav(stereo_path)
        while r.samples_remaining > 0:
            sp.update(r.read_channels(min(1 << 19, r.samples_remaining // 2)))
        return sp.finalize()[0]

    def stream(route, mesh):
        blocks = wav.read_wav(path).blocks(1 << 20)
        if mesh is None:
            return parallel.stream_pwelch(blocks, FS, o, device=dev)[0]
        return parallel.stream_pwelch(blocks, FS, o, mesh, halo_impl=(route, False))[0]

    def session(step):
        """The twelve steps; step(label, fn) runs each and returns its result."""
        r = {M_WAV: step(M_WAV, lambda: models.wav_psd(path, o, mesh8).pxx),
             M_PALLAS: step(M_PALLAS, lambda: stream("pallas", mesh8)),
             M_FUSED: step(M_FUSED, lambda: stream("fused", mesh8))}
        for route, label in M_SHARDED.items():
            r[label] = step(label, lambda: parallel.pwelch_sharded(
                x, FS, o, mesh8, halo_impl=(route, False))[0])
        r[M_STEREO] = step(M_STEREO, lambda: stereo_stream(mesh24))
        r[M_SPEC] = step(M_SPEC, lambda: parallel.spectrogram_sharded(x, mesh8, NFFT, 256))
        r[M_ISTFT] = step(M_ISTFT, lambda: parallel.istft_sharded(spec, mesh8, NFFT, 256))
        r[M_FFT] = step(M_FFT, lambda: parallel.fft_sharded(z, mesh8))
        r[M_IFFT] = step(M_IFFT, lambda: parallel.fft_sharded(r[M_FFT], mesh8, inverse=True)
                         / N24)
        return r

    # A first pass pays one-time costs (twiddle tables, allocator); the
    # counted session below is warm.
    t0 = time.perf_counter()
    session(lambda label, fn: fn())
    torch.cuda.synchronize()
    log(f"mesh paths: first pass {time.perf_counter() - t0:.3f} s")

    steps: dict[str, dict[str, int]] = {}
    walls: dict[str, float] = {}

    def step(label, fn):
        out, walls[label] = counted(label, fn, steps)
        return out

    reset_launch_counts()
    r = session(step)
    counts = launch_counts()
    log(f"  launches in the mesh session: {counts}")

    mono = stream_chunks(n, SP * SEGS * 512, 512, 1024)
    two = stream_chunks(n, 4 * SEGS * 512, 512, 1024)
    k4, k10, k11 = "pwelch_power_partials", "ring_halo", "pwelch_power_partials_halo"
    expect_launches(M_WAV, steps, {k4: SP * mono})
    expect_launches(M_PALLAS, steps, {k10: mono, k4: SP * mono})
    expect_launches(M_FUSED, steps, {k11: SP * mono})
    expect_launches(M_SHARDED["ppermute"], steps, {k4: SP})
    expect_launches(M_SHARDED["pallas"], steps, {k10: 1, k4: SP})
    expect_launches(M_SHARDED["fused"], steps, {k11: SP})
    expect_launches(M_STEREO, steps, {k11: 8 * two})
    expect_launches(M_SPEC, steps, {"stft_power": SP})
    expect_launches(M_ISTFT, steps, {"istft_overlap_add": SP})
    expect_launches(M_FFT, steps, {"outer_dft_split": SP, "fft_pow2": SP})
    expect_launches(M_IFFT, steps, {"outer_dft_split": SP, "ifft_pow2": SP})
    log(f"  chunks: {mono} of {SP * SEGS * 512} samples (sp=8), {two} of {4 * SEGS * 512} "
        "(dp=2 x sp=4)")

    # The same entries without a mesh on the card: walls beside the
    # sharded ones, and the results the sharded ones must agree with.
    one = {}
    one_walls = {}
    for label, fn in ((M_WAV, lambda: models.wav_psd(path, o, device=dev).pxx),
                      (M_PALLAS, lambda: stream(None, None)),
                      (M_STEREO, lambda: stereo_stream(None)),
                      (M_SHARDED["ppermute"], lambda: spectral.pwelch(x, FS, o)[0]),
                      (M_SPEC, lambda: models.spectrogram(x, NFFT, 256)),
                      (M_ISTFT, lambda: models.istft(spec, NFFT, 256)[: F8 * 256]),
                      (M_FFT, lambda: fft.fft(z)),
                      (M_IFFT, lambda: fft.ifft(r[M_FFT]))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one[label] = fn()
        torch.cuda.synchronize()
        one_walls[label] = time.perf_counter() - t0
    one[M_FUSED] = one[M_PALLAS]
    one_walls[M_FUSED] = one_walls[M_PALLAS]
    for route in ("pallas", "fused"):
        one[M_SHARDED[route]] = one[M_SHARDED["ppermute"]]
        one_walls[M_SHARDED[route]] = one_walls[M_SHARDED["ppermute"]]
    samples = {M_WAV: n, M_PALLAS: n, M_FUSED: n, M_STEREO: 2 * n, M_SPEC: cut,
               M_ISTFT: F8 * 256, M_FFT: N24, M_IFFT: N24, **{v: cut for v in M_SHARDED.values()}}
    log("  eight shards on one card measure the overhead of sharding, not scaling:")
    for label in r:
        log(f"  {label}: wall {walls[label]:.4f} s, {samples[label] / walls[label] / 1e6:.3f} "
            f"Msamples/s; one device {one_walls[label]:.4f} s, "
            f"{samples[label] / one_walls[label] / 1e6:.3f} Msamples/s")

    # Checks, after the counts were read: float64 oracles on the card from
    # the plain functions, then the one-device results.
    st = read_frames(stereo_path)
    pxx_mono, pxx_cut = oracle_pxx(decoded, o, dev), oracle_pxx(decoded[:cut], o, dev)
    pxx_st = np.stack([oracle_pxx(np.ascontiguousarray(st[:, c]), o, dev) for c in range(2)])
    x64 = x.double()
    w64 = window.window_table("hann", NFFT, device=dev)
    with plain_route():
        z64 = c128(z)
        Z64 = four_step_fft(z64)
    oracles = {M_WAV: pxx_mono, M_PALLAS: pxx_mono, M_FUSED: pxx_mono, M_STEREO: pxx_st,
               **{v: pxx_cut for v in M_SHARDED.values()},
               M_SPEC: cuda_stft.stft_pallas_plain(x64, w64, NFFT, 256, (cut - NFFT) // 256 + 1,
                                                   out="power"),
               M_FFT: Z64, M_IFFT: z64}
    for label, want in oracles.items():
        got = r[label]
        if tuple(got.shape) != tuple(want.shape):
            raise AssertionError(f"{label}: shape {tuple(got.shape)}, want {tuple(want.shape)}")
        check_db(f"{label} vs float64 oracle", got, want)
    del oracles
    want = (cuda_istft.istft_overlap_add_plain(c128(spec), w64, NFFT, 256)
            / _nola_norm(w64, F8, 256, (F8 - 1) * 256 + NFFT))[: F8 * 256]
    check_synthesis(f"{M_ISTFT} vs float64 istft", r[M_ISTFT].cpu().numpy(), want)
    del want
    worst = min(check_db(f"{label} vs one device", r[label], one[label]) for label in r)
    log(f"  sharded vs one device on the card: >= {worst:.2f} dB over every step")
    return steps


def phase_fft_rest(dev, path: str) -> dict[str, dict[str, int]]:
    """The rest of the FFT surface on the recording, as one counted session
    (phase 10), each result held against scipy in float64 on the host."""
    import scipy.fft as sfft
    import scipy.signal as ss

    from godsp_tpu_torch import fft, models, window
    from godsp_tpu_torch.ops import cuda_stft, launch_counts, reset_launch_counts
    from godsp_tpu_torch.window.extended import get_window

    decoded = read_decoded(path)
    n = decoded.size
    x = torch.from_numpy(decoded).to(dev)
    frames = x[: n // NFFT * NFFT].reshape(-1, NFFT)
    g = torch.Generator(device=dev).manual_seed(10)
    image = torch.rand(IMAGE, IMAGE, generator=g, device=dev) * 2 - 1
    seg = x[:ZOOM_N]
    r = np.logspace(-2, 2, FHT_N)
    dln = float(np.log(r[1] / r[0]))
    a = torch.from_numpy(r * np.exp(-r * r / 2)).to(dev, torch.float32)
    offset = fft.fhtoffset(dln, 0.5)
    stf = models.ShortTimeFFT(get_window("hann", NFFT), 256, FS)

    def session(step):
        """The eight steps; step(label, fn) runs each and returns its result."""
        out = {DCT: step(DCT, lambda: fft.dct(frames, type=2, norm="ortho"))}
        out[IDCT] = step(IDCT, lambda: fft.idct(out[DCT], type=2, norm="ortho"))
        out[DCTN] = step(DCTN, lambda: fft.dctn(image))
        out[MFCC] = step(MFCC, lambda: models.mfcc(x, FS, n_mfcc=13, nfft=NFFT, hop=256,
                                                   n_mels=80))
        out[ZOOM] = step(ZOOM, lambda: fft.zoom_fft(seg, ZOOM_BAND, ZOOM_M, fs=FS))
        out[FHT] = step(FHT, lambda: fft.fht(a, dln, 0.5, offset=offset))
        out[STFFT] = step(STFFT, lambda: stf.stft(x))
        out[ISTFFT] = step(ISTFFT, lambda: stf.istft(out[STFFT], k1=n))
        return out

    # A first pass pays one-time costs (phase, chirp, filterbank and
    # twiddle tables, allocator); the counted session below is warm.
    t0 = time.perf_counter()
    session(lambda label, fn: fn())
    torch.cuda.synchronize()
    log(f"rest of the FFT surface: first pass {time.perf_counter() - t0:.3f} s")

    steps: dict[str, dict[str, int]] = {}
    walls: dict[str, float] = {}

    def step(label, fn):
        out, walls[label] = counted(label, fn, steps)
        return out

    reset_launch_counts()
    out = session(step)
    log(f"  launches in the session of the rest of the FFT surface: {launch_counts()}")
    large_plan = {"outer_dft_split": 2, "fft_pow2": 1, "ifft_pow2": 1}  # forward + inverse
    expect_launches(DCT, steps, {"fft_pow2": 1})
    expect_launches(IDCT, steps, {"ifft_pow2": 1})
    expect_launches(DCTN, steps, {"fft_pow2": 2})
    # K5 mel for the log-mel; the 80-point DCT is Bluestein at pad 256.
    expect_launches(MFCC, steps, {"stft_mel": 1, "fft_pow2": 1, "ifft_pow2": 1})
    expect_launches(ZOOM, steps, large_plan)  # the chirp filter at pad 2^21
    expect_launches(FHT, steps, large_plan)  # rfft and irfft of 2^16 points
    expect_launches(STFFT, steps, {"fft_pow2": 1})
    expect_launches(ISTFFT, steps, {"ifft_pow2": 1})
    samples = {DCT: frames.numel(), IDCT: frames.numel(), DCTN: IMAGE * IMAGE, MFCC: n,
               ZOOM: ZOOM_N, FHT: FHT_N, STFFT: n, ISTFFT: n}
    for label, wall in walls.items():
        log(f"  {label}: wall {wall:.4f} s, {samples[label] / wall / 1e6:.3f} Msamples/s")

    # Checks, after the counts were read: scipy in float64 on the host, on
    # the same float32 inputs (each cast to float64).
    h = {k: v.cpu().numpy().astype(np.float64) for k, v in
         (("frames", frames), ("image", image), ("seg", seg), ("a", a))}
    spec = out[DCT].cpu().numpy().astype(np.float64)
    want = {
        DCT: sfft.dct(h["frames"], type=2, norm="ortho"),
        IDCT: sfft.idct(spec, type=2, norm="ortho"),
        DCTN: sfft.dctn(h["image"]),
        ZOOM: ss.zoom_fft(h["seg"], list(ZOOM_BAND), ZOOM_M, fs=FS),
        FHT: sfft.fht(h["a"], dln, 0.5, offset=offset),
    }
    del spec
    # mfcc: scipy's ortho DCT-II of the float64 log-mel from the port's plain
    # functions on the card (Slaney filters, ln(mel + 1e-10)): scipy checks
    # the DCT step only; the log-mel's parity is the CPU test's against
    # godsp_tpu.
    F = (n - NFFT) // 256 + 1
    fb64 = models.mel_filterbank(80, NFFT, FS, norm="slaney", device=dev, dtype=torch.float64)
    w64 = window.window_table("hann", NFFT, device=dev)
    mel64 = cuda_stft.stft_pallas_plain(x.double(), w64, NFFT, 256, F, out="mel", fb=fb64)
    want[MFCC] = sfft.dct(torch.log(mel64 + 1e-10).cpu().numpy(), norm="ortho")[:, :13]
    del mel64
    ref = ss.ShortTimeFFT(stf.win, 256, FS)
    want[STFFT] = ref.stft(decoded.astype(np.float64))
    want[ISTFFT] = ref.istft(out[STFFT].cpu().numpy().astype(np.complex128), k1=n)
    for label, w in want.items():
        got = out[label]
        if tuple(got.shape) != w.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: shape {tuple(got.shape)}, scipy {w.shape}")
        check_db(f"{label} vs scipy float64", got, w)
    return steps


def phase_bench(dev) -> dict[str, dict[str, int]]:
    """The port's bench (godsp_tpu_torch/bench.py), its core cells, as one
    counted session (phase 9): every cell >= 120 dB against its float64
    oracle, K12 equal and K13 >= 120 dB in the flagship's own check, and a
    summary line that parses and fits the limit."""
    from godsp_tpu_torch import bench
    from godsp_tpu_torch.ops import reset_launch_counts

    steps: dict[str, dict[str, int]] = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    res, wall = counted(BENCH, lambda: bench.run(bench.CORE, device=dev, sweeps=False,
                                                 emit=False), steps)
    expect = ("fft_pow2", "rfft_pow2", "copy_split", "gmm_floor", "outer_dft_split",
              "pwelch_power_partials")
    for name in expect:
        if steps[BENCH][name] <= 0:
            raise AssertionError(f"{BENCH} did not launch {name}")
    if res.get("failed_sections"):
        raise AssertionError(f"bench sections failed: {res['failed_sections']}")
    fl = res["fft1024_precise"]
    log(f"  bench core cells in {wall:.2f} s:")
    for key, d in res.items():
        if not isinstance(d, dict) or "wall_s" not in d:
            continue
        extra = {k: d[k] for k in ("gbs", "roofline_fraction", "library_wall_s") if k in d}
        log(f"    {key}: {d['wall_s'] * 1e3:.4f} ms, snr {d.get('snr_db')}, {extra}")
        if "snr_db" in d and not d["snr_db"] >= SNR_DB:
            raise AssertionError(f"bench {key}: {d['snr_db']:.2f} dB < {SNR_DB} dB")
    log(f"    fft1024_precise: copy ceiling {fl['copy_ceiling_gbs']:.1f} GB/s, "
        f"fraction_of_copy_ceiling {fl['fraction_of_copy_ceiling']:.4f}, "
        f"fraction_of_gmm_floor {fl['fraction_of_gmm_floor']:.4f}, K13 "
        f"{fl['gmm_floor_snr_db']:.2f} dB, K12 equal {fl['copy_equal']}")
    if not (fl["copy_equal"] and fl["gmm_floor_snr_db"] >= SNR_DB):
        raise AssertionError("bench flagship: K12 not equal or K13 below the bar")
    line = bench.summary_line(res, torch.cuda.get_device_name(dev))
    parsed = json.loads(line)
    log(f"  bench summary line ({len(line)} characters): {line}")
    if len(line) > bench.SUMMARY_MAX_CHARS or parsed["metric"] != \
            "fft1024_precise_roofline_fraction":
        raise AssertionError("bench summary line malformed")
    return steps


def lti_system():
    """The analog butter(4, 2 pi 1 kHz) in state space, frequency-scaled:
    tf2ss's controllable canonical form carries den's coefficients, up to
    w0^4 = 1.6e15, and at dt = 1/44100 its matrix exponential is
    ill-conditioned in float64 itself (the port's Pade-13 and scipy's
    expm give float64 outputs that agree below 110 dB;
    tests/test_torch_lti.py).  x = diag(w0^3, w0^2, w0, 1) z is the same
    system with entries O(w0), where both agree to rounding."""
    from godsp_tpu_torch.models import butter, tf2ss

    w0 = 2 * np.pi * 1000.0
    A, B, C, D = tf2ss(*butter(4, w0, analog=True))
    T = np.diag(w0 ** np.arange(3.0, -1.0, -1.0))
    Ti = np.linalg.inv(T)
    return Ti @ A @ T, Ti @ B, C @ T, D


def phase_filtering(dev, path: str) -> dict[str, dict[str, int]]:
    """The filtering, design and LTI path on the recording, as one counted
    session (phase 11), each result held against scipy.signal in float64
    on the host on the same float32 input."""
    import scipy.signal as ss

    from godsp_tpu_torch import models
    from godsp_tpu_torch.ops import launch_counts, reset_launch_counts

    decoded = read_decoded(path)
    n = decoded.size
    x = torch.from_numpy(decoded).to(dev)
    sos = models.butter(8, 4000, fs=FS, output="sos")
    b, a = models.butter(4, 1000, fs=FS)
    taps = models.firwin(FIR_TAPS, 4000 / (FS / 2))
    sysc = lti_system()
    dt = 1.0 / FS
    sysd = models.cont2discrete(sysc, dt, "zoh")
    u = decoded[:LSIM_N].astype(np.float64)
    t = np.arange(LSIM_N) * dt

    def session(step):
        """The ten steps; step(label, fn) runs each and returns its result."""
        return {
            SOSFILT: step(SOSFILT, lambda: models.sosfilt(sos, x)),
            SOSFILTFILT: step(SOSFILTFILT, lambda: models.sosfiltfilt(sos, x)),
            LFILTER: step(LFILTER, lambda: models.lfilter(b, a, x)),
            FIR: step(FIR, lambda: models.fir_filter(x, taps)),
            FFTCONV: step(FFTCONV, lambda: models.fftconvolve(x, taps, mode="same")),
            OLS: step(OLS, lambda: models.overlap_save(x, taps)),
            DECIMATE: step(DECIMATE, lambda: models.decimate(x, 4)),
            RESAMPLE: step(RESAMPLE, lambda: models.resample_poly(x[:RESAMPLE_N], 160, 441)),
            LSIM: step(LSIM, lambda: models.lsim(sysc, u, t)[1]),
            DLSIM: step(DLSIM, lambda: models.dlsim(sysd, u)[1][:, 0]),
        }

    # A first pass pays one-time costs (block and twiddle tables,
    # allocator); the counted session below is warm.
    t0 = time.perf_counter()
    session(lambda label, fn: fn())
    torch.cuda.synchronize()
    log(f"filtering path: first pass {time.perf_counter() - t0:.3f} s")

    steps: dict[str, dict[str, int]] = {}
    walls: dict[str, float] = {}

    def step(label, fn):
        out, walls[label] = counted(label, fn, steps)
        return out

    reset_launch_counts()
    out = session(step)
    log(f"  launches in the filtering session: {launch_counts()}")
    # The IIR and LTI steps are matmuls and scans in torch: no kernel of
    # this library.  A pad of 2^25 (the recording's full convolution) and
    # 2^27 (the zero-stuffed 10 s) takes the large plan: K8 once a
    # transform at 2^25, twice at 2^27; each convolution is two forward
    # transforms and one inverse.  overlap_save's 4096-point blocks: the
    # tap spectrum (K1) and one batched circular filter (K1, K2).
    large25 = {"outer_dft_split": 3, "fft_pow2": 2, "ifft_pow2": 1}
    for label in (SOSFILT, SOSFILTFILT, LFILTER, DECIMATE, LSIM, DLSIM):
        expect_launches(label, steps, {})
    expect_launches(FIR, steps, large25)
    expect_launches(FFTCONV, steps, large25)
    expect_launches(OLS, steps, {"fft_pow2": 2, "ifft_pow2": 1})
    expect_launches(RESAMPLE, steps, {"outer_dft_split": 6, "fft_pow2": 2, "ifft_pow2": 1})
    samples = {label: n for label in out}
    samples.update({RESAMPLE: RESAMPLE_N, LSIM: LSIM_N, DLSIM: LSIM_N})
    for label, wall in walls.items():
        log(f"  {label}: wall {wall:.4f} s, {samples[label] / wall / 1e6:.3f} Msamples/s")

    # Checks, after the counts were read: scipy in float64 on the host, on
    # the same float32 input (cast to float64).
    x64 = decoded.astype(np.float64)
    full = ss.oaconvolve(x64, taps)
    want = {
        SOSFILT: ss.sosfilt(sos, x64),
        SOSFILTFILT: ss.sosfiltfilt(sos, x64),
        LFILTER: ss.lfilter(b, a, x64),
        FIR: full[:n],
        FFTCONV: full[(FIR_TAPS - 1) // 2 : (FIR_TAPS - 1) // 2 + n],
        OLS: full[:n],
        DECIMATE: ss.decimate(x64, 4),
        RESAMPLE: ss.resample_poly(x64[:RESAMPLE_N], 160, 441),
        LSIM: ss.lsim(sysc, u, t)[1],
        DLSIM: ss.dlsim(sysd, u)[1][:, 0],
    }
    del full
    for label, w in want.items():
        got = out[label]
        if isinstance(got, torch.Tensor):
            ok = bool(torch.isfinite(got).all())
        else:
            ok = bool(np.all(np.isfinite(got)))
        if tuple(got.shape) != w.shape or not ok:
            raise AssertionError(f"{label}: shape {tuple(got.shape)}, scipy {w.shape}")
        check_db(f"{label} vs scipy float64", got, w)
    return steps


def phase_probe_kernels(rec: KernelRecord, dev) -> None:
    """K14a, the fused-Welch floor twins (tools/probe_pwfloor.py's
    build_variant bodies), against their plain versions on the card at the
    probe's geometry (16384 segments, nfft = pad = 1024, hop 512) and at a
    ragged one (nfft 1000, hop 160, pad 1024, 5001 segments of which 4990
    count; noframe at pad 2048): loadonly (K4's first design's load, a
    floor of K4's bytes) and frameonly (K4's body without the transform:
    its framing load and masked sums in registers) against their float64
    plain versions, noframe (K4's body with each frame read from
    its row 16 bytes a lane: twice K4's bytes, none re-read) against the
    float64 rfft -> |X|^2 -> masked sum, staged (K4's body with each
    tile's span staged once by the TMA, the frames cut from shared
    memory) against K4 on the same samples, torch.equal to it, and
    against the float64 plain version; each timed at the probe's geometry
    beside its plain version and bound (no one PyTorch call computes any
    twin's function).  The redesigns' lines beside their first designs
    are phase 3's (phase_anat_staged_redesign, phase_noframe_sdif_redesign,
    phase_i8full_frameonly_redesign)."""
    from godsp_tpu_torch import window
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.ops import cuda_pwelch
    from godsp_tpu_torch.probes import pwfloor

    x = pwfloor.inputs(dev)
    g = torch.Generator(device=dev).manual_seed(14)
    S, bins = 5001, 513
    ext = torch.rand(1, (S - 1) * 160 + 1000, generator=g, device=dev) * 2 - 1
    mask = (torch.arange(S, device=dev) < 4990).float()[None]
    w = window.window_table("hann", 1024, device=dev, dtype=torch.float32)
    frames = torch.rand(1, S, 2048, generator=g, device=dev) * 2 - 1
    w2 = window.window_table("hann", 2048, device=dev, dtype=torch.float32)
    cases = (("probe geometry", x["ext"], x["mask"], x["w"], x["frames"], x["w"], 1024, 512),
             ("nfft 1000 hop 160 pad 1024, 4990 of 5001", ext, mask, w, frames * mask[..., None],
              w2, 1000, 160))
    for what, e, m, ww, fr, wf, nfft, hop in cases:
        e64, m64, w64 = e.double(), m.double(), ww.double()
        bt = cuda_pwelch.segs_per_tile(m.shape[-1], 1)
        rec.check("pwfloor_loadonly", lambda: cp.pwfloor_loadonly(e, m, ww, nfft, hop, 1024),
                  cp.pwfloor_loadonly_plain(e64, m64, w64, nfft, hop, 1024, bt), what)
        rec.check("pwfloor_frameonly", lambda: cp.pwfloor_frameonly(e, m, ww, nfft, hop, 1024),
                  cp.pwfloor_frameonly_plain(e64, m64, w64, nfft, hop, 1024, bt), what)
        rec.check("pwfloor_noframe", lambda: cp.pwfloor_noframe(fr, m, wf),
                  cp.pwfloor_noframe_plain(fr.double(), m64, wf.double(), bt),
                  f"{what}, pad {fr.shape[-1]}")
        st_bt = cp.staged_segs_per_tile(m.shape[-1], 1, nfft, hop, 1024)
        k4 = cuda_pwelch.pwelch_power_partials(e, m, ww, nfft, hop, pad=1024)
        if st_bt != bt:
            raise AssertionError(f"staged tiles {st_bt} differ from K4's {bt}")
        rec.check("pwfloor_staged", lambda: cp.pwfloor_staged(e, m, ww, nfft, hop, 1024),
                  k4.double(), f"{what}, against K4")
        rec.check("pwfloor_staged", lambda: cp.pwfloor_staged(e, m, ww, nfft, hop, 1024),
                  cp.pwfloor_staged_plain(e64, m64, w64, nfft, hop, 1024, bt),
                  f"{what}, float64 plain")
        same = torch.equal(cp.pwfloor_staged(e, m, ww, nfft, hop, 1024), k4)
        log(f"  {'pwfloor_staged':22s} {what}: torch.equal to K4 at the same tiles: {same}")
        if not same:
            raise AssertionError(f"pwfloor_staged {what}: not equal to K4")
        del k4
    shape = "16384 segments, nfft = pad = 1024, hop 512"
    for name, (op, read, nbytes, flops) in pwfloor.ops(x).items():
        if name in ("full", "rfft"):
            continue  # K4 and K3: timed in phase 3
        e, m, ww, fr = x["ext"], x["mask"], x["w"], x["frames"]
        bt = cuda_pwelch.segs_per_tile(m.shape[-1], 1)
        plain = {
            "loadonly": lambda: cp.pwfloor_loadonly_plain(e, m, ww, 1024, 512, 1024, bt),
            "frameonly": lambda: cp.pwfloor_frameonly_plain(e, m, ww, 1024, 512, 1024, bt),
            "noframe": lambda: cp.pwfloor_noframe_plain(fr, m, ww, bt),
            "staged": lambda: cp.pwfloor_staged_plain(e, m, ww, 1024, 512, 1024, bt),
        }[name]
        # No one PyTorch call frames, windows, (transforms) and sums a tile.
        rec.time(f"pwfloor_{name}", shape, op, plain, None, nbytes, flops)


def probe_sessions(dev, sessions) -> dict[str, dict[str, int]]:
    """Each (label, probe module, the wrappers it launches) as one counted
    session: probe.run(dev) at its full shape, the launch counts zeroed
    just before it and read just after; raises where a wrapper outside the
    list launched, one in it did not, or a row is missing."""
    from godsp_tpu_torch.ops import reset_launch_counts

    steps: dict[str, dict[str, int]] = {}
    for label, probe, launched in sessions:
        torch.cuda.synchronize()
        reset_launch_counts()
        rows, wall = counted(label, lambda p=probe: p.run(dev, emit=log), steps)
        log(f"  {label}: {wall:.2f} s")
        for name, c in steps[label].items():
            if (c > 0) != (name in launched):
                raise AssertionError(f"{label}: {name} launched {c} times")
        if sorted(k for k in rows if k != "check") != sorted(probe.ROWS):
            raise AssertionError(f"{label} rows {sorted(rows)}")
    return steps


def phase_probe_run(dev) -> dict[str, dict[str, int]]:
    """probes.pwfloor at its full geometry as one counted session
    (phase 12): every twin, K4, K3 and K12 launched."""
    from godsp_tpu_torch.probes import pwfloor

    return probe_sessions(dev, ((PWFLOOR, pwfloor, (
        "pwfloor_loadonly", "pwfloor_frameonly", "pwfloor_noframe", "pwfloor_staged",
        "pwelch_power_partials", "rfft_pow2", "copy_split")),))


def toolkit_image(dev) -> torch.Tensor:
    """A seeded 2048 x 2048 float32 image on the card: a smooth field of
    three plane waves plus N(0, 0.1^2) noise."""
    g = torch.Generator(device=dev).manual_seed(13)
    yy, xx = torch.meshgrid(torch.arange(TK_IMAGE, device=dev, dtype=torch.float64),
                            torch.arange(TK_IMAGE, device=dev, dtype=torch.float64), indexing="ij")
    field = (torch.sin(2 * np.pi * xx / 317.0) * torch.cos(2 * np.pi * yy / 211.0)
             + 0.5 * torch.sin(2 * np.pi * (xx + yy) / 701.0))
    noise = torch.randn(TK_IMAGE, TK_IMAGE, generator=g, device=dev)
    return (field.float() + 0.1 * noise).contiguous()


def gauss_taps(n: int, sigma: float) -> np.ndarray:
    t = np.exp(-0.5 * ((np.arange(n) - (n - 1) / 2) / sigma) ** 2)
    return t / t.sum()


def host_float64(run):
    """run() with host data going to the CPU: the port's own float64 plain
    route on the host, the reference where scipy truncates (splines) or
    has no counterpart."""
    from godsp_tpu_torch import default_device, set_default_device

    old = default_device()
    set_default_device("cpu")
    try:
        return run()
    finally:
        set_default_device(old)


def wiener_bound_db(im: np.ndarray, size: int, pad_points: int) -> float:
    """The SNR wiener's float32 run must reach against float64.

    wiener's local variance v = s2 - m^2 (s2 and m the box means of im^2
    and im) cancels where the local mean is large beside the spread.  Each
    box mean comes from a forward and an inverse FFT over log2(pad_points)
    radix-2 levels, each level adding at most u = 2^-24 relative rms error
    in quadrature, so each carries eps = u sqrt(2 log2(pad_points)) times
    its magnitude.  Then |dv| <= eps (s2 + 2 m^2), and where v > noise
    the output m + (im - m)(1 - noise / v) moves by |im - m| noise / v^2
    |dv|; elsewhere it is m, off by eps |m|.  So 20 log10(rms(out) /
    rms(that error)), from the float64 moments on the host."""
    import scipy.signal as ss

    ones = np.ones((size, size))
    m = ss.correlate(im, ones, "same") / ones.size
    s2 = ss.correlate(im * im, ones, "same") / ones.size
    v = np.maximum(s2 - m * m, 0.0)
    noise = v.mean()
    out = ss.wiener(im, size)
    eps = 2.0 ** -24 * np.sqrt(2.0 * np.log2(pad_points))
    err = np.where(v > noise, np.abs(im - m) * noise / np.maximum(v, noise) ** 2
                   * eps * (s2 + 2 * m * m), eps * np.abs(m))
    return float(20.0 * np.log10(np.sqrt(np.mean(out**2)) / np.sqrt(np.mean(err**2))))


def phase_toolkit(dev, path: str) -> dict[str, dict[str, int]]:
    """The signal toolkit at full width, as one counted session (phase 13):
    the recording's samples and a 2048^2 image through savgol, wavelets,
    peaks, the 2-D filters and the splines; each result held against its
    float64 reference on the host."""
    import scipy.signal as ss

    from godsp_tpu_torch import models
    from godsp_tpu_torch.ops import launch_counts, reset_launch_counts

    decoded = read_decoded(path)
    n = decoded.size
    x = torch.from_numpy(decoded).to(dev)
    seg_n = FS * TK_SECONDS
    seg = x[:seg_n]
    image = toolkit_image(dev)
    gauss = np.outer(gauss_taps(TK_TAPS, 5.0), gauss_taps(TK_TAPS, 5.0))
    hrow, hcol = gauss_taps(TK_TAPS, 4.0), gauss_taps(TK_TAPS, 7.0)
    widths = np.arange(1, TK_WIDTHS + 1)
    peak_widths = np.arange(1, TK_PEAK_WIDTHS + 1)
    peak_kw = dict(height=0.75, distance=441, prominence=0.5, wlen=441)
    # float32 points, the card's working type, so both sides evaluate at them
    newx = np.linspace(-100.0, seg_n + 100.0, seg_n).astype(np.float32)

    def session(step):
        """The eighteen steps; step(label, fn) runs each and returns its result."""
        out = {
            SG_INTERP: step(SG_INTERP, lambda: models.savgol_filter(x, 101, 3)),
            SG_MIRROR: step(SG_MIRROR, lambda: models.savgol_filter(x, 101, 3, mode="mirror")),
            CWT: step(CWT, lambda: models.cwt(seg, models.ricker, widths)),
            PEAKS: step(PEAKS, lambda: models.find_peaks(x, **peak_kw)[0]),
            PEAKS_CWT: step(PEAKS_CWT, lambda: models.find_peaks_cwt(decoded[:FS], peak_widths)),
            CONV2: step(CONV2, lambda: models.convolve2d(image, gauss, "same")),
            CORR2: step(CORR2, lambda: models.correlate2d(image, gauss, "valid")),
            CONV2_SYMM: step(CONV2_SYMM, lambda: models.convolve2d(image, gauss, "same",
                                                                   boundary="symm")),
            WIENER2: step(WIENER2, lambda: models.wiener(image, 5)),
            MEDFILT2: step(MEDFILT2, lambda: models.medfilt2d(image, 5)),
            HILBERT2: step(HILBERT2, lambda: models.hilbert2(image)),
            SEPFIR: step(SEPFIR, lambda: models.sepfir2d(image, hrow, hcol)),
            CSPLINE2: step(CSPLINE2, lambda: models.cspline2d(image)),
            SPLINE_FILTER: step(SPLINE_FILTER, lambda: models.spline_filter(image, 5.0)),
            CSPLINE1: step(CSPLINE1, lambda: models.cspline1d(seg)),
        }
        out[CSPLINE1_EVAL] = step(CSPLINE1_EVAL, lambda: models.cspline1d_eval(out[CSPLINE1],
                                                                              newx))
        out[SYMIIR1] = step(SYMIIR1, lambda: models.symiirorder1(seg, 0.25, 0.5))
        out[SYMIIR2] = step(SYMIIR2, lambda: models.symiirorder2(seg, 0.5, np.pi / 8))
        return out

    # A first pass pays one-time costs (tables, allocator); the counted
    # session below is warm.
    t0 = time.perf_counter()
    session(lambda label, fn: fn())
    torch.cuda.synchronize()
    log(f"toolkit path: first pass {time.perf_counter() - t0:.3f} s")

    steps: dict[str, dict[str, int]] = {}
    walls: dict[str, float] = {}

    def step(label, fn):
        out, walls[label] = counted(label, fn, steps)
        return out

    reset_launch_counts()
    out = session(step)
    log(f"  launches in the toolkit session: {launch_counts()}")
    # savgol over the recording: pad 2^25, the large plan (K8 once a
    # transform, two forward and one inverse).  cwt: the signal and the
    # 64-row bank at 2^19 forward, the bank inverse (the large plan); so
    # find_peaks_cwt's 32-row bank at 2^16.  find_peaks is host work.
    # medfilt2d and cspline1d_eval are torch sorts and gathers.  A 2-D
    # convolution at 4096^2 is K1 over rows and columns of both
    # operands and K2 over both axes; wiener is two of them; hilbert2 a
    # 2048^2 fft2 and ifft2; sepfir2d's symmetric pad gives 2078 + 30:
    # 4096^2 again.  cspline2d is a DCT round trip a pass (K1, K2) over
    # 2048 points; spline_filter adds a 3 x 3 sepfir2d (pad 4096^2).  The
    # 1-D splines of 441,000 samples are Bluestein at 2^20 (the large plan),
    # once for the DCT's FFT and once for the inverse's.
    for label, want in TOOLKIT_LAUNCHES.items():
        expect_launches(label, steps, want)
    for label, wall in walls.items():
        if label in (SG_INTERP, SG_MIRROR, PEAKS):
            rate = f"{n / wall / 1e6:.3f} Msamples/s"
        elif label in (CWT, CSPLINE1, CSPLINE1_EVAL, SYMIIR1, SYMIIR2):
            rate = f"{seg_n / wall / 1e6:.3f} Msamples/s"
        elif label == PEAKS_CWT:
            rate = f"{FS / wall / 1e6:.3f} Msamples/s"
        else:
            rate = f"{TK_IMAGE * TK_IMAGE / wall / 1e6:.3f} Mpixels/s"
        log(f"  {label}: wall {wall:.4f} s, {rate}")

    # Checks, after the counts were read: float64 references on the host on
    # the same float32 inputs.
    x64 = decoded.astype(np.float64)
    s64 = x64[:seg_n]
    im64 = image.double().cpu().numpy()
    for label, mode in ((SG_INTERP, "interp"), (SG_MIRROR, "mirror")):
        check_db(f"{label} vs scipy float64", out[label], ss.savgol_filter(x64, 101, 3, mode=mode))
    cwt_ref = np.stack([np.convolve(s64, models.ricker(int(min(10 * w, seg_n)), w)[::-1], "same")
                        for w in widths])
    check_db(f"{CWT} vs float64 per-row np.convolve", out[CWT], cwt_ref)
    del cwt_ref
    want_peaks = ss.find_peaks(x64, **peak_kw)[0]
    if not np.array_equal(out[PEAKS], want_peaks):
        raise AssertionError(f"{PEAKS}: {out[PEAKS].size} peaks, scipy {want_peaks.size}")
    log(f"  {PEAKS}: {want_peaks.size} peaks, equal to scipy's")
    want_cwt = host_float64(lambda: models.find_peaks_cwt(s64[:FS], peak_widths))
    if not np.array_equal(out[PEAKS_CWT], want_cwt):
        raise AssertionError(f"{PEAKS_CWT}: {out[PEAKS_CWT].tolist()} against the float64 "
                             f"route's {want_cwt.tolist()}")
    log(f"  {PEAKS_CWT}: {want_cwt.size} peaks, equal to the float64 route's")
    check_db(f"{CONV2} vs scipy float64", out[CONV2], ss.convolve2d(im64, gauss, "same"))
    check_db(f"{CORR2} vs scipy float64", out[CORR2], ss.correlate2d(im64, gauss, "valid"))
    check_db(f"{CONV2_SYMM} vs scipy float64", out[CONV2_SYMM],
             ss.convolve2d(im64, gauss, "same", boundary="symm"))
    want = ss.wiener(im64, 5)
    bound = wiener_bound_db(im64, 5, 4096 * 4096)
    db = snr(out[WIENER2], want)
    log(f"  {WIENER2} vs scipy float64: {db:.2f} dB (its float32 bound {bound:.2f} dB)")
    if not db >= bound:
        raise AssertionError(f"{WIENER2}: {db:.2f} dB < its bound {bound:.2f} dB")
    if not np.array_equal(out[MEDFILT2].cpu().numpy(), ss.medfilt2d(image.cpu().numpy(), 5)):
        raise AssertionError(f"{MEDFILT2}: differs from scipy's on the same float32 values")
    log(f"  {MEDFILT2}: equal to scipy's on the same float32 values")
    check_db(f"{HILBERT2} vs scipy float64", out[HILBERT2], ss.hilbert2(im64))
    check_db(f"{SEPFIR} vs float64 plain route", out[SEPFIR],
             host_float64(lambda: models.sepfir2d(im64, hrow, hcol)))
    check_db(f"{CSPLINE2} vs float64 plain route", out[CSPLINE2],
             host_float64(lambda: models.cspline2d(im64)))
    check_db(f"{SPLINE_FILTER} vs float64 plain route", out[SPLINE_FILTER],
             host_float64(lambda: models.spline_filter(im64, 5.0)))
    check_db(f"{CSPLINE1} vs scipy float64", out[CSPLINE1], ss.cspline1d(s64))
    cj = out[CSPLINE1].double().cpu().numpy()
    check_db(f"{CSPLINE1_EVAL} vs scipy float64 (same coefficients)", out[CSPLINE1_EVAL],
             ss.cspline1d_eval(cj, newx.astype(np.float64)))
    check_db(f"{SYMIIR1} vs float64 plain route", out[SYMIIR1],
             host_float64(lambda: models.symiirorder1(s64, 0.25, 0.5)))
    check_db(f"{SYMIIR2} vs float64 plain route", out[SYMIIR2],
             host_float64(lambda: models.symiirorder2(s64, 0.5, np.pi / 8)))
    return steps


def phase_lane_kernels(rec: KernelRecord, dev) -> None:
    """K14b and K14c against their plain versions on the card at the probes'
    shape (16384 x 1024) and at a ragged one (1001 rows, not a multiple of
    any row tile, of 2048 points): fac_dft and gmm_concat against the
    float64 plain version (>= 120 dB; gmm_concat also torch.equal to K13),
    slicestore and concatstore torch.equal to their input; each timed at
    16384 x 1024 beside its plain version, bound and library call (copy_
    for the copies, torch.matmul of the complex64 slices with K13's G,
    TF32 off, for the DFTs)."""
    from godsp_tpu_torch.ops import cuda_metrics, cuda_probes, launch_counts
    from godsp_tpu_torch.probes._common import complex_matmul, lane_planes

    for b, n in ((LANE_B, LANE_N), (1001, 2048)):
        xr, xi = lane_planes(dev, b, n, seed=14)
        shape = f"{b} x {n}"
        want = cplx(cuda_metrics.gmm_floor_plain(xr.double(), xi.double()))
        rec.check("fac_dft", lambda: cplx(cuda_probes.fac_dft(xr, xi)), want, shape)
        rec.check("gmm_concat", lambda: cplx(cuda_probes.gmm_concat(xr, xi)), want, shape)
        k13 = cuda_metrics.gmm_floor(xr, xi)
        got = cuda_probes.gmm_concat(xr, xi)
        if not (torch.equal(got[0], k13[0]) and torch.equal(got[1], k13[1])):
            raise AssertionError(f"gmm_concat {shape}: not equal to K13's result")
        log(f"  {'gmm_concat':22s} {shape:34s} torch.equal to K13")
        del want, k13, got
        for name in ("slicestore", "concatstore"):
            before = launch_counts()[name]
            got = getattr(cuda_probes, name)(xr, xi)
            if launch_counts()[name] != before + 1:
                raise AssertionError(f"{name}: not one launch")
            if not (torch.equal(got[0], xr) and torch.equal(got[1], xi)):
                raise AssertionError(f"{name} {shape}: differs from its input")
            rec.err[name] = 0.0
            log(f"  {name:22s} {shape:34s} equal to its input (torch.equal)")
        if (b, n) != (LANE_B, LANE_N):
            continue
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
        matmul = complex_matmul(xr, xi)
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("lane yardstick: TF32 is on")
        pts = float(b * n)
        for name, plain, lib, ops in (
                ("fac_dft", cuda_probes.fac_dft_plain, matmul, 204.0),
                ("gmm_concat", cuda_metrics.gmm_floor_plain, matmul, 768.0),
                ("slicestore", cuda_metrics.copy_split_plain,
                 lambda: (yr.copy_(xr), yi.copy_(xi)), 0.0),
                ("concatstore", cuda_metrics.copy_split_plain,
                 lambda: (yr.copy_(xr), yi.copy_(xi)), 0.0)):
            fn = getattr(cuda_probes, name)
            rec.time(name, shape, lambda fn=fn: fn(xr, xi), lambda p=plain: p(xr, xi), lib,
                     16.0 * pts, ops * pts)
        del xr, xi, yr, yi, matmul


def phase_lane_probes(dev) -> dict[str, dict[str, int]]:
    """probes.facdft and probes.store at their full shape as two counted
    sessions (phase 14)."""
    from godsp_tpu_torch.probes import facdft, store

    return probe_sessions(dev, (
        (FACDFT, facdft, ("fac_dft", "gmm_floor", "copy_split")),
        (STORE, store, ("slicestore", "concatstore", "gmm_concat", "gmm_floor", "copy_split",
                         "i8_concat"))))


def phase_anatomy_kernels(rec: KernelRecord, dev) -> None:
    """K14d against its plain versions on the card at the probe's shape
    (16384 x 1024) and at a ragged one (1001 rows, not a multiple of any
    row tile, of 2048 points) through probes.anatomy2.check_numerics, one
    launch of each twin; bd_tf32's mma fragment maps with an identity and
    a cyclic-shift table; then each twin timed at 16384 x 1024 beside its
    plain version, bound and the library yardstick of probes.anatomy2.ops
    (none for half3 and anat_full), anat_full also beside the unfused
    route it is fused from (half3, the row as torch's elementwise calls,
    bd_hi; the kernels line's separate_route_ms).  anat_full is bd_hi's
    walk fed with each k-box and its partner n / 2 columns away, the
    rounds and the row made once a stage in shared memory, the split in
    registers."""
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.ops import launch_counts
    from godsp_tpu_torch.probes import anat_staged, anatomy2
    from godsp_tpu_torch.probes._common import TF32_FLOPS, lane_planes
    from godsp_tpu_torch.utils.metrics import FP32_FLOPS

    for b, n in ((LANE_B, LANE_N), (1001, 2048)):
        xr, xi = lane_planes(dev, b, n, seed=15)
        tw = anatomy2.tw_row(dev, n)
        shape = f"{b} x {n}"
        before = launch_counts()
        res = anatomy2.check_numerics(xr, xi, tw)  # raises where a twin falls short
        after = launch_counts()
        once = {name: after[name] - before[name] for name in ANATOMY_TWINS}
        if set(once.values()) != {1}:
            raise AssertionError(f"anatomy2.check_numerics {shape}: launches {once}")
        for name, err in res.pop("max_abs_err").items():
            rec.err[name] = max(rec.err.get(name, 0.0), err)
        log(f"  anatomy2.check_numerics {shape:22s} {res}, one launch a twin")
        eye = torch.eye(128, device=dev)
        for table, what, want in (
                (eye, "identity", [cp.round_tf32(v) for v in (xr, xi)]),
                (torch.roll(eye, 1, dims=1), "cyclic shift",
                 [torch.roll(cp.round_tf32(v).view(b, -1, 128), 1, dims=2).reshape(b, n)
                  for v in (xr, xi)])):
            got = cp.bd_tf32(xr, xi, table)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"bd_tf32 {shape}: the {what} table is not exact")
            log(f"  {'bd_tf32':22s} {shape:34s} {what} table: torch.equal")
        del got, want
        if (b, n) != (LANE_B, LANE_N):
            continue
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("anatomy yardstick: TF32 is on")
        lib = {name: pair[1] for name, pair in anatomy2.ops(xr, xi, tw).items()}
        pts = float(b * n)
        # bd_tf32, bd_hi and anat_full make their products on the tensor
        # cores: TF32 operations (512, 2304 a point) at TF32_FLOPS, expressed
        # at the float32 rate bound_ms divides by.  anat_full's 10 float32
        # operations a point (the rounds, the row) run on the CUDA cores
        # beside them and are the smaller time.
        tc = FP32_FLOPS / TF32_FLOPS
        for name, plain, library, flops in (
                ("half3", lambda: cp.half3_plain(xr, xi), None, 6.0 * pts),
                ("slice8_add", lambda: cp.add_one_plain(xr, xi), lib["slice8"], 2.0 * pts),
                ("reshape_add", lambda: cp.add_one_plain(xr, xi), lib["reshape"], 2.0 * pts),
                ("bd_tf32", lambda: cp.bd_tf32_plain(xr, xi, tf32=True), lib["bd1"],
                 512.0 * pts * tc),
                ("bd_hi", lambda: cp.bd_hi_plain(xr, xi), lib["bd_hi"], 2304.0 * pts * tc),
                ("anat_full", lambda: cp.anat_full_plain(xr, xi, tw), None,
                 max(10.0 * pts, 2304.0 * pts * tc))):
            fn = getattr(cp, name)
            args = (xr, xi, tw) if name == "anat_full" else (xr, xi)
            rec.time(name, shape, lambda fn=fn, args=args: fn(*args), plain, library,
                     16.0 * pts, flops)
        rec.times["anat_full"]["separate_route_ms"] = time_ms(
            lambda: anat_staged.unfused_route(xr, xi, tw))
        del xr, xi, lib


def phase_anatomy_probe(dev) -> dict[str, dict[str, int]]:
    """probes.anatomy2 at its full shape as one counted session (phase 16)."""
    from godsp_tpu_torch.probes import anatomy2

    return probe_sessions(dev, ((ANATOMY, anatomy2,
                                 ANATOMY_TWINS + ("copy_split", "fft_pow2")),))


def once(name: str, run):
    """run(), which must launch the wrapper `name` exactly once."""
    from godsp_tpu_torch.ops import launch_counts

    before = launch_counts()[name]
    out = run()
    if launch_counts()[name] != before + 1:
        raise AssertionError(f"{name}: not one launch")
    return out


def phase_dif_kernels(rec: KernelRecord, dev) -> None:
    """K14h and K14i (tools/probe_vdif.py's and tools/probe_sdif.py's
    butterfly networks, both bound by bytes on the H100) against their
    float64 plain versions on the card, one launch a check (phase 17):
    vdif (a warp a row through a cp.async buffer) at the probe's 16384 x
    1024 (n1 8, scale 1/sqrt(n)) and at a ragged 1001 x 512 (n1 4, not a
    multiple of a block's four rows), its digit order exact at both
    widths; sdif_peel (the stages in registers on K8's column tile) at
    2^24 as (1, 128, 131072) and at a ragged (3, 128, 1000) (not a
    multiple of a tile's 32 columns); each timed at the full shape beside
    its plain version, bound and library call (vdif: torch.fft.fft of the
    complex rows, norm="ortho"; sdif_peel: none, and K8 on the same planes
    as its separate_route_ms).  The redesigns' lines beside their first
    designs are phase 3's (phase_bd1_vdif_redesign,
    phase_noframe_sdif_redesign)."""
    from godsp_tpu_torch.ops import cuda_outer
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.probes import sdif, vdif
    from godsp_tpu_torch.probes._common import lane_planes

    for b, n in ((vdif.B, vdif.N), (1001, 512)):
        xr, xi = lane_planes(dev, b, n, seed=17)
        s = n ** -0.5
        shape = f"{b} x {n}"
        rec.check("vdif", lambda: cplx(once("vdif", lambda: cp.vdif(xr, xi, s))),
                  cplx(cp.vdif_plain(xr.double(), xi.double(), s)), shape)
        if not once("vdif", lambda: vdif.digit_order_exact(dev, n, s)):
            raise AssertionError(f"vdif {shape}: the digit order is not exact")
        log(f"  {'vdif':22s} {shape:34s} digit order exact (single exponentials)")
        if (b, n) == (vdif.B, vdif.N):
            z = torch.complex(xr, xi)
            pts = float(b * n)
            rec.time("vdif", shape, lambda: cp.vdif(xr, xi, s), lambda: cp.vdif_plain(xr, xi, s),
                     lambda: torch.fft.fft(z, norm="ortho"), 16.0 * pts,
                     vdif.OPS_PER_POINT["vdif"] * pts)
            del z
        del xr, xi
    for shape in ((1, sdif.D, sdif.M), (3, sdif.D, 1000)):
        xr, xi = (p.view(shape) for p in lane_planes(dev, shape[0] * shape[1], shape[2], seed=17))
        label = " x ".join(map(str, shape))
        rec.check("sdif_peel", lambda: cplx(once("sdif_peel", lambda: cp.sdif_peel(xr, xi))),
                  cplx(cp.sdif_peel_plain(xr.double(), xi.double())), label)
        if shape[0] == 1:
            # No one PyTorch call computes a twiddled column DFT; K8 computes
            # the same peel up to a row map (its separate_route_ms).
            pts = float(xr.numel())
            rec.time("sdif_peel", label, lambda: cp.sdif_peel(xr, xi),
                     lambda: cp.sdif_peel_plain(xr, xi), None, 16.0 * pts,
                     sdif.OPS_PER_POINT["sdif"] * pts)
            rec.times["sdif_peel"]["separate_route_ms"] = time_ms(
                lambda: cuda_outer.outer_dft_split(xr, xi, sdif.D, 1))
        del xr, xi


def phase_dif_probes(dev) -> dict[str, dict[str, int]]:
    """probes.vdif and probes.sdif at their full shapes as two counted
    sessions (phase 18)."""
    from godsp_tpu_torch.probes import sdif, vdif

    return probe_sessions(dev, (
        (VDIF, vdif, ("vdif", "copy_split", "fac_dft", "fft_pow2")),
        (SDIF, sdif, ("sdif_peel", "copy_split", "outer_dft_split"))))


def phase_lane_slice_kernels(rec: KernelRecord, dev) -> None:
    """K14e and K14f against their plain versions on the card (phase 19):
    at the probe's 16384 x 1024 and at the ragged 1001 x 1024 and 1001 x 512
    (not a multiple of a tile's 16 rows; n1 4 at 512), probes.r3's and
    probes.r4's check_numerics with their launches counted (ls_network and
    ls_full >= 120 dB against float64, gmm_tf32 >= 120 dB against its
    TF32-rounded float64 plain version, every ls_full setting of
    probes.r3.FULL_SETTINGS torch.equal to the default launch; lane_flip
    exact on the TPU probe's (8, 128) input and on the plane as rows of
    128); gmm_tf32 exact on identity and cyclic-shift tables; fft_pow2_rows
    >= 120 dB against K1's float64 plain version and torch.equal to K1 at
    1 .. 16 rows a block there and at every setting of the sweep's shapes
    (probes.r3.SWEEP); then each timed at 16384 x 1024 beside its plain
    version, bound and the library yardstick of probes.r3.ops (torch.fft.fft
    for fft_pow2_rows, timed at 16 rows a block, the widest setting the
    sweep gives n = 1024; torch.flip for lane_flip)."""
    from godsp_tpu_torch.ops import cuda_fft
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.ops import launch_counts
    from godsp_tpu_torch.probes import r3, r4
    from godsp_tpu_torch.probes._common import TF32_FLOPS, lane_planes
    from godsp_tpu_torch.probes._common import planes_equal as equal
    from godsp_tpu_torch.utils.metrics import FP32_FLOPS

    def fft_rows(xr, xi, shape, rpbs):
        want = cplx(cuda_fft.fft_pow2_plain(xr.double(), xi.double()))
        k1 = cuda_fft.fft_pow2(xr, xi)
        for r in rpbs:
            held = {}

            def run(r=r):
                held["y"] = once("fft_pow2_rows", lambda: cp.fft_pow2_rows(xr, xi, r))
                return cplx(held["y"])

            rec.check("fft_pow2_rows", run, want, f"{shape}, {r} rows a block")
            if not equal(held["y"], k1):
                raise AssertionError(f"fft_pow2_rows {shape}, {r} rows a block: differs from K1")
        log(f"  {'fft_pow2_rows':22s} {shape:34s} rows a block {rpbs}: torch.equal to K1")

    checked = {"ls_network": 1, "gmm_tf32": 1, "ls_full": len(r3.FULL_SETTINGS), "lane_flip": 2,
               "rfft_pow2": 1}
    eye = torch.eye(128, device=dev)
    for b, n in ((r3.B, r3.N), (1001, 1024), (1001, 512)):
        xr, xi = lane_planes(dev, b, n, seed=19)
        shape = f"{b} x {n}"
        before = launch_counts()
        res = [r3.check_numerics(xr, xi), r4.check_numerics(xr)]  # raise where a twin falls short
        after = launch_counts()
        got = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        if got != checked:
            raise AssertionError(f"r3/r4.check_numerics {shape}: launches {got}, not {checked}")
        for r in res:
            for name, err in r.pop("max_abs_err").items():
                rec.err[name] = max(rec.err.get(name, 0.0), err)
        log(f"  r3.check_numerics {shape:22s} {res[0]}")
        log(f"  r4.check_numerics {shape:22s} {res[1]}, launches {got}")
        rt = cp.round_tf32
        for roll, what in ((0, "identity"), (1, "cyclic shift")):
            table = torch.roll(eye, roll, dims=1).expand(n // 128, 3, 128, 128).contiguous()
            a, c, s_ = (torch.roll(rt(v).view(b, -1, 128), roll, dims=2).reshape(b, n)
                        for v in (xr, xi, xr + xi))
            if not equal(cp.gmm_tf32(xr, xi, table), (a - c, s_ - a - c)):
                raise AssertionError(f"gmm_tf32 {shape}: the {what} table is not exact")
        log(f"  {'gmm_tf32':22s} {shape:34s} identity and cyclic-shift tables: torch.equal")
        fft_rows(xr, xi, shape, (1, 2, 4, 8, 16))
        if (b, n) != (r3.B, r3.N):
            continue
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("lane-slice yardstick: TF32 is on")
        lib = {name: pair[1] for name, pair in r3.ops(xr, xi).items()}
        v = xr.view(-1, 128)
        pts = float(b * n)
        tc = FP32_FLOPS / TF32_FLOPS  # gmm_tf32's products run on the tensor cores
        # ls_full and K1 compute the row's DFT: 5 log2 n operations a point
        # (ls_full's method does 768 + 15).
        for name, kernel, plain, library, nbytes, flops in (
                ("ls_network", lambda: cp.ls_network(xr, xi), lambda: cp.ls_network_plain(xr, xi),
                 lib["network"], 16.0 * pts, r3.OPS_PER_POINT["network"] * pts),
                ("gmm_tf32", lambda: cp.gmm_tf32(xr, xi),
                 lambda: cp.gmm_tf32_plain(xr, xi, tf32=True), lib["gmm_default"], 16.0 * pts,
                 768.0 * pts * tc),
                ("ls_full", lambda: cp.ls_full(xr, xi), lambda: cp.ls_full_plain(xr, xi),
                 lib["full"], 16.0 * pts, r3.OPS_PER_POINT["full"] * pts),
                ("fft_pow2_rows", lambda: cp.fft_pow2_rows(xr, xi, 16),
                 lambda: cuda_fft.fft_pow2_plain(xr, xi), lib["fft1024"], 16.0 * pts,
                 r3.OPS_PER_POINT["fft1024"] * pts),
                ("lane_flip", lambda: cp.lane_flip(v), lambda: cp.lane_flip_plain(v),
                 lambda: torch.flip(v, (-1,)).mul_(2.0), 8.0 * pts, pts)):
            rec.time(name, shape, kernel, plain, library, nbytes, flops)
        del xr, xi, lib, v
    for (b, n), rpbs in r3.SWEEP.items():
        if (b, n) != (r3.B, r3.N):  # that shape's settings ran above
            xr, xi = lane_planes(dev, b, n, seed=19)
            fft_rows(xr, xi, f"{b} x {n}", rpbs)
            del xr, xi


def phase_lane_slice_probes(dev) -> dict[str, dict[str, int]]:
    """probes.r4 and probes.r3 at their full shapes as two counted sessions
    (phase 20)."""
    from godsp_tpu_torch.probes import r3, r4

    return probe_sessions(dev, (
        (R4, r4, ("lane_flip", "rfft_pow2", "copy_split", "fft_pow2_rows", "fft_pow2",
                  "fft_pow2_radix2")),
        (R3, r3, LANE_SLICE_TWINS + ("copy_split", "slicestore", "gmm_floor", "fft_pow2",
                                     "fft_pow2_rows", "fft_pow2_radix2"))))


def phase_int8_kernels(rec: KernelRecord, dev) -> None:
    """K14g against its plain versions on the card (phase 21): at the
    probe's 16384 x 1024 and at the ragged 1001 x 1024 and 1001 x 512 (not a
    multiple of a step's 16 rows; n1 4 at 512), probes.int8.check_numerics
    with its launches counted (i8_dot exact at (256, 128) @ (128, 128) and
    (1001, 128) @ (128, 384); i8mm torch.equal to its plain version; i8dec,
    i8full, i8_concat equal to theirs or >= 120 dB; i8full equal to
    i8_concat; i8full's dB against float64 printed) and its fragment maps
    (identity and cyclic-shift digit tables through i8mm and i8dec); then
    each timed at the full shape beside its plain version, bound (16 B a
    point, or the int8 operations over 1,979 TOPS expressed at the float32
    rate bound_ms divides by, or the float32 ones) and library call
    (torch._int_mm for i8_dot; K13's torch.matmul of the complex64 slices,
    TF32 off, for i8full and i8_concat; none for i8mm and i8dec).  i8full
    is the redesign (digit and product warps overlapped on named
    barriers), i8_concat the cluster redesign; their lines beside their
    first designs are phase 3's (phase_i8full_frameonly_redesign,
    phase_i8_tf32_redesign)."""
    from godsp_tpu_torch.ops import cuda_probes as cp
    from godsp_tpu_torch.ops import launch_counts
    from godsp_tpu_torch.probes import int8
    from godsp_tpu_torch.probes._common import INT8_OPS, lane_planes
    from godsp_tpu_torch.utils.metrics import FP32_FLOPS

    checked = {"i8_dot": 2, "i8mm": 1, "i8dec": 1, "i8full": 2, "i8_concat": 1}
    mapped = {"i8mm": 2, "i8dec": 2}
    tc = FP32_FLOPS / INT8_OPS  # the products run on the int8 tensor cores
    for b, n in ((int8.B, int8.N), (1001, 1024), (1001, 512)):
        xr, xi = lane_planes(dev, b, n, seed=21)
        shape = f"{b} x {n}"
        for what, run, want in (("check_numerics", int8.check_numerics, checked),
                                ("fragment_maps", int8.fragment_maps, mapped)):
            before = launch_counts()
            res = run(xr, xi)  # raises where a twin falls short
            after = launch_counts()
            got = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            if got != want:
                raise AssertionError(f"int8.{what} {shape}: launches {got}, not {want}")
            for name, err in res.pop("max_abs_err", {}).items():
                rec.err[name] = max(rec.err.get(name, 0.0), err)
            log(f"  int8.{what} {shape:22s} {res}, launches {got}")
        if (b, n) != (int8.B, int8.N):
            continue
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("int8 yardstick: TF32 is on")
        lib = {name: pair[1] for name, pair in int8.ops(xr, xi).items()}
        pts = float(b * n)
        for name, plain in (("i8mm", cp.i8mm_plain), ("i8dec", cp.i8dec_plain),
                            ("i8full", cp.i8full_plain), ("i8_concat", cp.i8full_plain)):
            flops = max(int8.OPS_PER_POINT[name], int8.INT8_PER_POINT[name] * tc) * pts
            fn = getattr(cp, name)
            rec.time(name, shape, lambda fn=fn: fn(xr, xi), lambda p=plain: p(xr, xi), lib[name],
                     16.0 * pts, flops)
        del xr, xi, lib
    m, k, n = int8.DOT_SHAPES[0]
    a, b_ = int8.dot_inputs(dev, m, k, n)
    rec.time("i8_dot", f"{m} x {k} @ {k} x {n}", lambda: cp.i8_dot(a, b_),
             lambda: cp.i8_dot_plain(a, b_), lambda: torch._int_mm(a, b_),
             float(m * k + k * n + 4 * m * n), 2.0 * m * k * n * tc)
    # Each alone: the profiler's events of i8_dot_kernel, and of every
    # device kernel torch._int_mm launches, a call.
    rec.device_time("i8_dot", "i8_dot_kernel", lambda: cp.i8_dot(a, b_))
    reps = 50
    # The library's GEMM kernel alone, its events averaged as i8_dot's are.
    lib_alone, rows = kernel_alone_ms("gemm", lambda: torch._int_mm(a, b_), reps)
    rec.times["i8_dot"]["library_device_ms"] = lib_alone
    own = rec.times["i8_dot"]["kernel_device_ms"]
    log(f"  i8_dot alone (profiler events) {m} x {k} @ {k} x {n}: i8_dot_kernel "
        f"{'not measured' if own is None else f'{own:.4f} ms'}, torch._int_mm "
        f"{'not measured' if lib_alone is None else f'{lib_alone:.4f} ms'} a call " +
        " ".join(f"[{e.key[:60]}]" for e in rows))


def phase_int8_probe(dev) -> dict[str, dict[str, int]]:
    """probes.int8 at its full shape as one counted session (phase 22)."""
    from godsp_tpu_torch.probes import int8

    return probe_sessions(dev, ((INT8, int8, INT8_TWINS + ("copy_split", "gmm_floor")),))


def main() -> int:
    smi = phase_card()
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import godsp_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = torch.device("cuda", 0)
    phase_build()
    rec = KernelRecord()
    phase_kernels(rec, dev)
    redesign_steps = phase_fft_redesign(rec, dev)
    phase_stft_kernels(rec, dev)
    phase_outer_kernel(rec, dev)
    phase_peel_rows_kernel(rec, dev)
    phase_csd_kernel(rec, dev)
    phase_halo_kernels(rec, dev)
    phase_metrics_kernels(rec, dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "recording.wav")
        stereo = os.path.join(tmp, "stereo.wav")
        t0 = time.perf_counter()
        n = write_recording(path, stereo)
        log(f"main path: wrote {n} samples ({os.path.getsize(path)} bytes) and their stereo "
            f"twin ({os.path.getsize(stereo)} bytes) in {time.perf_counter() - t0:.2f} s")
        _, steps = phase_main_path(dev, path)
        stft_steps = phase_stft_family(dev, path)
        fft_steps = phase_fft_surface(dev, path)
        welch_steps = phase_scipy_spectra(dev, path, stereo)
        mesh_steps = phase_mesh(dev, path, stereo)
        bench_steps = phase_bench(dev)
        rest_steps = phase_fft_rest(dev, path)
        filter_steps = phase_filtering(dev, path)
        toolkit_steps = phase_toolkit(dev, path)
    phase_probe_kernels(rec, dev)
    probe_steps = phase_probe_run(dev)
    phase_lane_kernels(rec, dev)
    lane_steps = phase_lane_probes(dev)
    t0 = time.perf_counter()
    phase_anatomy_kernels(rec, dev)
    anatomy_steps = phase_anatomy_probe(dev)
    log(f"phases 15-16 (K14d): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_dif_kernels(rec, dev)
    dif_steps = phase_dif_probes(dev)
    log(f"phases 17-18 (K14h, K14i): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_lane_slice_kernels(rec, dev)
    lane_slice_steps = phase_lane_slice_probes(dev)
    log(f"phases 19-20 (K14e, K14f): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_int8_kernels(rec, dev)
    int8_steps = phase_int8_probe(dev)
    log(f"phases 21-22 (K14g): {time.perf_counter() - t0:.1f} s")
    # Each wrapper's launches come from the counted sessions, each read
    # right after it ran.
    steps.update(redesign_steps)
    steps.update(stft_steps)
    steps.update(fft_steps)
    steps.update(welch_steps)
    steps.update(mesh_steps)
    steps.update(rest_steps)
    steps.update(bench_steps)
    steps.update(filter_steps)
    steps.update(probe_steps)
    steps.update(toolkit_steps)
    steps.update(lane_steps)
    steps.update(anatomy_steps)
    steps.update(dif_steps)
    steps.update(lane_slice_steps)
    steps.update(int8_steps)

    kernels = []
    for name in REPLACES:
        t = rec.times[name]
        launched_by = {label: c[name] for label, c in steps.items() if c[name]}
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=sum(launched_by.values()), max_abs_err=rec.err[name], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=t["shape"], launched_by=launched_by,
            **{k: t[k] for k in ("kernel_device_ms", "separate_route_ms", "library_device_ms")
               if k in t},
        ))
        if not launched_by:
            raise AssertionError(f"{name} was not launched by the main path")
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        log(f"time {name:22s} {t['shape']:40s} kernel {t['ms']:.4f} ms  plain(f32) "
            f"{t['plain_ms']:.4f} ms  bound {t['bound_ms']:.4f} ms ({t['bound_by']})  "
            f"library {lib}  [{smi}]")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
