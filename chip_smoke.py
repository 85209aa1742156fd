#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device and build: print the card's name and power limit, build the
     flash-attention kernels (forward, backward dq and dk/dv) from the
     sources and print ptxas's registers and spills for each kernel, switch
     TF32 and bf16 reduced-precision reductions off;
  2. kernel against its plain PyTorch version on the card, at Transformer-
     base attention shapes (B=8, T=1024, H=8, dh=64, ragged lengths), with
     q, k, v as strided slices of one fused projection (self-attention) and
     as dense tensors (cross-attention), bf16 and f32, causal off and on;
     times of the kernel, the plain version and torch's
     scaled_dot_product_attention (a yardstick only: the port never calls
     it; the kernels it ran on are named from the profiler) beside the
     least time the card could take;
  3. the slice: Transformer-base (32000/32000 vocab) with random weights from
     a seed, bf16 compute, the flash flag on, serving 16 requests with source
     and target lengths in 600-1024 through Inference.infer in two batches of
     8; every distribution finite and summing to 1, 18 kernel launches per
     batch, agreement with the dense attention path on the first batch;
  4. the backward kernels against the plain backward on the card, at the
     same shapes, layouts, dtypes and masks as phase 2: dq, dk and dv (f32
     within 1e-4, bf16 within the derived per-element bar of
     flash_attention_bwd_bar, whose worst |d|/bar is printed), the device
     kernel the bf16 dq launch ran (from the profiler), the time of each
     kernel beside its bound, the plain backward's time and the time of
     scaled_dot_product_attention's backward alone (a yardstick only); and
     two planted faults of the plain backward (ds left unrounded, the
     length mask dropped), each of which must exceed the bf16 bar somewhere
     in these cases;
  4a. the bf16 bar's sweep: seeds x causal off/on x fused/dense operands at
     phase 4's shapes, every gradient within the bar, the worst |d|/bar of
     dq, dk and dv printed;
  4b. edge shapes of the bf16 tensor-core kernels against the plain
     versions: the forward (O, lse) and the backward (dq, dk, dv) at
     T = 200 with dh = 40 (padded to 48 in shared memory), a length-0 row
     and a length that is not a multiple of 16, at dh = 64 and at dh = 128,
     fused and dense operands, causal off and on, at the bars of phases 2
     and 4;
  5. training: Transformer-base (32000/32000, bf16 compute, f32 masters) with
     random weights from a seed, through trainer.SGD(...).train with
     Momentum(0.05 / 1024, 0.9) on batches of 8 with source and target
     lengths in 600-1024 (one of each at 1024, so every slot pads to
     T = 1024): every
     cost finite, the cost falling over repeated steps on one batch, 18
     forward, 18 dq and 18 dk/dv launches per step, one step's gradients
     with flash against the dense path (f32 and bf16 compute), seconds per
     step, tokens per second and peak memory;
  6. torch.profiler over two training steps: the top device kernels by time,
     the device's busy share of the window, and the dq kernel, which must
     run as fa_bwd_dq_mma_kernel 18 times per step (this shows the main
     path's bf16 dq route; phase 4's lone launches are sometimes missing
     from the profiler's window);
  8. ResNet-50 training at bench.py's configuration (depth 50, 1000
     classes, 224x224x3, batch 128, bf16 compute over f32 masters,
     Momentum(0.01, 0.9): bench.py's rate 0.1 oscillates on the fixed
     batch; random images and labels from a seed) through
     trainer.SGD(...).train, with cuDNN autotuning switched on: one warm-up
     step, 4 timed steps on distinct batches (seconds per step, images/s,
     the convs' analytic FLOPs and their share of the bf16 peak, peak
     memory), 5 steps on one batch (the cost must fall), every batch-norm
     moving statistic moved and finite, and one step's gradients at B=2 on
     the card in f32 held to the CPU's f64 gradient no further than the
     CPU's own f32 gradient is (times 2);
  7. ResNet-50 serving from phase 8's parameters and state through
     Inference.infer: 256 images in two batches of 128, bf16, every
     distribution finite and summing to 1; two images in f32 on the card
     and on the CPU, probabilities and logits compared;
  9. torch.profiler over two ResNet-50 training steps: the top device
     kernels, the busy share, device time by origin (torch's kernels,
     memcpy, cuDNN and cuBLAS) and the layout-transform kernels per step
     beside the convs.  No flash kernel may launch in phases 8, 7, 9.
     Phase 8 also reads the first batch norm's sum |moving mean| in an
     EndPass handler (non-zero, and equal to the value after train
     returns), and takes one step on a batch with a NaN pixel, which the
     divergence sentinel must skip: health 0, and params, layer state and
     optimizer state torch.equal to before;
 10. the training spine at full width, on phase 5's Transformer-base
     configuration (bf16 over f32 masters, flash on, Momentum(0.05 / 1024,
     0.9)): SGD.train over 2 passes of 3 batches with save_dir and
     saving_period=1, an EndPass handler running trainer.test on a
     held-out batch and saving the parameter tar into a buffer; a
     Parameters.from_tar of the last buffer must serve the same batch
     bit-identically to the trained parameters; save_checkpoint after step
     2, and a trainer built from fresh parameters restores it (params,
     momentum and step counter equal to the first trainer's at step 2, bit
     for bit) and trains the remaining 4 batches, whose costs must equal
     the uninterrupted run's bit for bit (or, if a second uninterrupted run
     in this process shows the step is not bit-reproducible, lie within
     three times their spread); bytes and seconds of every save and
     restore, the flash launches over the phase, and seconds per step with
     the sentinel on and off beside phase 5's;
 10b. the eight optimizers on the card: 3 updates of the full
     Transformer-base parameter tree in f32 with gradients from a seeded
     generator, on the card and on the CPU from the same numbers; worst
     |d| / max|param| per leaf <= 1e-5;
 10c. dropout and error clipping on the card: an fc of width 2048 over
     8x1024 tokens with drop_rate 0.1 (bf16): kept share within 5 sigma of
     0.9, kept values equal the undropped ones / 0.9, the same seed gives
     the same mask and the next another, train=False leaves the output
     untouched; an error_clipping_threshold's clipped gradient on the card
     against the CPU's (f32, relative L2 <= 1e-5);
 11. attention-GRU NMT training at bench.py's bench_nmt configuration
     (seq2seq_cost with word and hidden width 512 and vocab 30000/30000,
     bf16 compute over f32 masters, Momentum(0.05, 0.9), bench_nmt's 4096
     pairs with lengths 8-50 drawn beta(2, 3) from RandomState(0)) through
     trainer.SGD(...).train over reader.bucketing.token_budget_batch at
     128 x 64 padded tokens, with the use_bucketing feeder: one warm-up
     step, 4 timed steps (costs, seconds per step, valid target tokens/s,
     peak memory), the decoder's lowering on each step (it fails unless
     every step took the fused attention-GRU core), the recurrences' steps
     run and skipped by the early exit, torch.profiler over two more steps
     (busy share, device kernels per step, top kernels), no flash launch
     over the phase; and one step's gradients in f32 at a small width,
     card against CPU and the fused core against the generic loop on the
     card (relative L2 over every leaf <= 1e-4);
 12. NMT generation at bench.py's bench_nmt_generate configuration (the
     same model in f32 with random weights from a seed, B = 64, beam 5,
     max_length 32, sources of 40 ids from RandomState(0)) through
     Seq2SeqGenerator.generate and generate_greedy on the card: seconds per
     call, top-beam tokens/s by bench.py's count, ms per sentence, and
     torch.profiler over one call of each (device kernels per decode step,
     busy share, top kernels); it fails unless every decoder step took the
     fused attention-GRU step.  At vocab 512, width 64 and 8 rows in f32:
     beam and greedy tokens card == CPU, beam scores within 1e-5 relative,
     and fused == generic stepping on the card;
 13. the ServingEngine at the same width (max_slots 16, block_steps 8,
     max_new_tokens 32, hbm_budget_mb 64: 682 blocks of 16 tokens x 1536
     f32 features) serving 64 requests of 4-30 source tokens drawn as
     bench_serving draws them, admitted as slots free, one preempted after
     the second dispatch and re-admitted, one cancelled after the third:
     requests/s, generated tokens/s, p50 and p99 per-token latency
     ((last token - admission) / tokens, from token_times), decode
     dispatches and shape variants, torch.profiler's busy share over a
     second run; that at the engine's row count a row's product does not
     depend on its position (and which other row counts round it alike);
     and every served request against reference_decode: where its tokens
     leave the one-shot path, the one-shot path's top-2 log-prob gap at
     that step must be below 1e-4 (the count of such requests and the
     largest |d| of the emitted tokens' log-probs over the matching
     prefixes are printed), and the engine's own claim, tokens and
     log-probs bit for bit, must hold.  No flash kernel may launch in
     phases 12 and 13;
 14. LSTM text classification at bench.py's bench_lstm_textcls width (the
     reference's benchmark/paddle/rnn network: embedding 30000 -> 128, two
     simple_lstm(512), last_seq, fc(2, softmax), classification cost; bf16
     over f32 masters, Adam(5e-4), reviews of 100 tokens from
     RandomState(0) in batches of 128) through trainer.SGD(...).train: one
     warm-up step, 4 timed steps on distinct batches (seconds per step,
     reviews/s, tokens/s, peak memory, every timestep run by the LSTM core),
     5 steps on one batch (the cost must fall), torch.profiler over two
     steps (busy share, device kernels per step and per timestep, top
     kernels, and the chain GEMMs, which must be 2 layers x 100 steps
     forward and as many backward), the early exit's steps on a ragged
     batch of bench.py's beta(2, 3) corpus (lengths 10-100), 256 ragged
     reviews served through paddle.infer in batches of 128 (every
     distribution finite and summing to 1), and one step's f32 cost and
     gradients card vs CPU at vocab 512, width 32, 4 ragged rows for a
     forward LSTM, a reverse one and lstmemory_group (relative L2 <= 1e-5);
 15. the CRF sequence tagger (models/sequence_tagging.py ner_crf_cost:
     vocab 30000, 23 IOB labels of 11 chunk types, word and hidden width 32,
     sparse_update=True, f32, Adam(2e-2)) through trainer.SGD(...).train
     with chunk_evaluator and crf_decoding as an extra layer, 200 fresh
     batches of 128 sentences from synthetic_tag_reader: the mean of the
     last 4 costs under half the first 4's, seconds per step, tokens/s,
     chunk F1, torch.profiler over two steps, then a fresh batch decoded by
     paddle.infer(field='id') above 0.9 tag accuracy; and at vocab 512 in
     f32, card vs CPU: the crf cost and gradients (relative L2 <= 1e-5,
     ragged rows with a length-1 sentence) and crf_decoding's paths equal,
     on random weights and on a constructed three-way tie (both take the
     first maximum).  No flash kernel may launch in phases 14 and 15;
 16. bench_lstm_textcls as bench.py runs it, through the v1 front end: a v1
     config (phase 14's network, widths through get_config_arg parsed from
     "hidden_size=512,lstm_num=2,batch_size=128") and a @provider over a
     pickle in the rnn benchmark's schema (512 reviews of 100 tokens from
     RandomState(0)), written to a temporary directory that is removed
     afterwards; parse_config, make_optimizer, make_provider_reader,
     DataFeeder(p.topology.data_types()) and SGD.train in bf16 over f32
     masters: one warm-up step and 4 timed steps (seconds per step,
     reviews/s, tokens/s, peak memory beside phase 14's, every timestep on
     the LSTM core), torch.profiler over two steps; make_batched_reader with
     use_bucketing and a 12800-token budget over 512 reviews of 10-100
     tokens drawn beta(2, 3) (no batch may pad past the budget; rungs and
     valid share printed); card against CPU in f32 at vocab 512, width 32,
     4 ragged rows: the v1-parsed network's cost and gradients, a nested
     batch (4 paragraphs of 1-5 sentences of 2-12 ids) through the feeder
     (its tensors equal on both sides), fc and mixed, and a
     sparse_binary_vector(512) slot through fc(32) as a multi-hot product
     and as the gather-sum of its padded ids (relative L2 <= 1e-5); and the
     pruning hook on the card: fc(2048 -> 512) with HookAttr("pruning",
     0.75) after 5 steps has exactly 0.75 of w0 at zero, at the smallest
     initial magnitudes.  No flash kernel may launch in phase 16.

The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launches on the main path (the timed training steps of
phase 5; the NMT paths of phases 11-13, the LSTM classifier of phases 14
and 16 and the tagger of phase 15 run none of them), errors and times.
Without a CUDA device, or without the paddle_tpu_torch package beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

B, T, H, DH = 8, 1024, 8, 64
LENGTHS = [1024, 1000, 617, 1, 512, 800, 1024, 333]
# kernel vs plain version: |dO| <= TOL_O + TOL_O_REL * |O| (O is rounded once
# to its dtype, so a bf16 value may land one step away), |dlse| <= TOL_LSE
TOL_O = {"bfloat16": 1e-3, "float32": 1e-4}
TOL_O_REL = {"bfloat16": 1e-2, "float32": 0.0}
TOL_LSE = {"bfloat16": 1e-4, "float32": 1e-4}  # f32 in both

# backward kernels vs plain backward: f32 |d| <= TOL_G32 (the f32 kernels
# round nothing); bf16 |d| <= fa.flash_attention_bwd_bar, per element: the
# rounding flips of ds and p that the two summation orders can cause, the
# f32 sum-order slack and the store's rounding, with no flat floor
TOL_G32 = 1e-4
BAR_SEEDS = (10, 11, 12, 13)  # the bf16 bar's sweep at phase 4's shapes
# per (query, key, head) the masks keep: operations of each kernel
OPS_PER_PAIR = {"fwd": 4 * DH, "dq": 6 * DH, "dkv": 8 * DH}

N_REQUESTS = 16
BATCH = 8
MIN_LEN = 600  # shortest training source or target
# bench.py's transformer_long_ctx trains with Momentum(0.05, 0.9); the cost is
# summed over each sample's tokens, and at that rate repeated steps diverge,
# so the smoke takes the same rate per token of the padded length
TRAIN_LR = 0.05 / T
TRAIN_BATCHES = 4  # distinct batches of the timed training run
FIXED_STEPS = 5  # repeated steps on one batch: the cost must fall
# one step's gradients, flash against dense: |dg| / |g_dense|, L2 over every
# leaf.  Per-leaf maxima are no bar at this size: a ReLU unit of the FFN
# whose pre-activation is within rounding of 0 flips between the paths and
# moves its bias gradient by one token's share (about 1% of a sum over ~8000
# tokens), even in f32.  f32: summation order and such flips, <= 1e-3.
# bf16: the dense path rounds scores and the whole softmax to bf16, where the
# kernels keep f32 and round only p and ds before their products, <= 5e-2.
GRAD_REL = {"float32": 1e-3, "bfloat16": 5e-2}
VOCAB = 32000
FEEDING = {"src_word": 0, "trg_word": 1, "trg_next": 2}


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=20, warmup=3) -> float:
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


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) per entry
    function of an nvcc -Xptxas -v log, names demangled by c++filt where the
    toolkit's host has it."""
    import re
    import shutil

    regs, spills, cur = {}, {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            spills[cur] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            regs[cur] = int(m.group(1))
    names = list(regs)
    shown = names
    if names and shutil.which("c++filt"):
        shown = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True).stdout.splitlines()
    return [(nice.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void "), regs[n],
             *spills.get(n, (0, 0))) for n, nice in zip(names, shown)]


def build_with_report(fa):
    """Build the kernels and return (ptxas_report of the build, seconds)."""
    import contextlib
    import io

    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        fa.build(verbose=True)
    return ptxas_report(log.getvalue()), time.perf_counter() - t0


def bwd_excess(torch, got, want, bars):
    """{gradient: (max(|d| - bar), worst |d| / bar, max |d|)} of kernel
    outputs `got` against `want`; the first <= 0 passes (a non-finite output
    counts as inf; where the bar is 0 only d = 0 passes)."""
    out = {}
    for name, x, r, bar in zip(("dq", "dk", "dv"), got, want, bars):
        d = (x.double() - r.double()).abs()
        bar = torch.as_tensor(bar, dtype=torch.float64, device=d.device)
        ratio = torch.where(bar > 0, d / bar, torch.where(d > 0, float("inf"), 0.0))
        finite = bool(torch.isfinite(x.float()).all())
        out[name] = ((d - bar).max().item() if finite else float("inf"),
                     ratio.max().item() if finite else float("inf"), d.max().item())
    return out


def device_kernels(torch, fn) -> str:
    """The device kernels a call of fn runs, by name and time per recorded
    launch, from torch.profiler over three calls ("not measured" when the
    profiler shows no device time; the record of a lone ctypes launch is
    sometimes missing from the window)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with record_function("call"):
                fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
           and e.key != "call"]  # the range's own device-side annotation
    if not dev:
        return "not measured"
    dev.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return "; ".join(f"{e.key[:90]} {e.self_device_time_total / e.count:.1f} us per launch "
                     f"({e.count} of 3 calls recorded)"
                     for e in dev[:4])


def attention_pairs(lengths, t, causal) -> int:
    """(query, key) pairs the masks leave valid: the work this data needs."""
    total = 0
    for n in lengths:
        n = min(max(n, 0), t)
        if causal:
            # query q sees keys 0..min(q, n-1)
            total += sum(min(q + 1, n) for q in range(t))
        else:
            total += t * n
    return total


def bound_ms(kernel, lengths, causal, elem_bytes, peak_flops):
    """(least ms, "operations" or "bytes") of one flash kernel: each input
    read once and each output written once (fwd: q, k, v -> O, lse; dq:
    q, k, v, dO, lse, delta -> dq; dkv: the same -> dk, dv), and
    OPS_PER_PAIR[kernel] * H operations per (query, key) pair the masks keep."""
    ops = OPS_PER_PAIR[kernel] * H * attention_pairs(lengths, T, causal)
    tile = B * T * H * DH * elem_bytes
    stats = B * H * T * 4  # one f32 [B, H, T] array
    nbytes = {
        "fwd": 4 * tile + stats,
        "dq": 5 * tile + 2 * stats,
        "dkv": 6 * tile + 2 * stats,
    }[kernel] + B * 4
    t_ops, t_bytes = ops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_mask(torch, lengths, causal):
    """[B, 1, T, T] boolean mask of the flash kernels' masks, for SDPA."""
    key_ok = torch.arange(T, device="cuda")[None, :] < lengths[:, None].long()
    mask = key_ok[:, None, None, :]
    if causal:
        mask = mask & torch.tril(torch.ones(T, T, dtype=torch.bool, device="cuda"))[None, None]
    return mask


def qkv_operands(torch, gen, dtype, layout):
    """q, k, v [B, T, H, dh] as the main path hands them to the kernel:
    "fused" are column slices of one [B, T, 3*H*dh] projection (self-
    attention's fused QKV GEMM, token stride 3*H*dh), "separate" are three
    dense tensors (cross-attention's projections)."""
    if layout == "fused":
        qkv = torch.randn((B, T, 3 * H * DH), generator=gen, device="cuda").to(dtype)
        return tuple(x.view(B, T, H, DH) for x in qkv.split(H * DH, dim=-1))
    return tuple(
        torch.randn((B, T, H, DH), generator=gen, device="cuda").to(dtype)
        for _ in range(3)
    )


def phase_kernel(torch, fa):
    """Kernel vs plain version on the card; returns the kernels-line row."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device="cuda")
    row = None
    worst = 0.0
    for layout in ("fused", "separate"):
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q, k, v = qkv_operands(torch, gen, dtype, layout)
            for causal in (False, True):
                o_k, lse_k = fa.flash_attention(q, k, v, lengths, causal, return_lse=True)
                o_r, lse_r = fa.flash_attention_reference(q, k, v, lengths, causal, return_lse=True)
                torch.cuda.synchronize()
                d_o = (o_k.float() - o_r.float()).abs()
                err_o = d_o.max().item()
                # O's bar is relative: one rounding of O to bf16 may differ
                excess_o = (d_o - TOL_O_REL[dtype_name] * o_r.float().abs()).max().item()
                err_l = (lse_k - lse_r).abs().max().item()
                finite = bool(torch.isfinite(o_k.float()).all() and torch.isfinite(lse_k).all())
                tol_o, tol_l = TOL_O[dtype_name], TOL_LSE[dtype_name]
                mask = attention_mask(torch, lengths, causal)
                qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
                ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, lengths, causal))
                plain = time_ms(torch, lambda: fa.flash_attention_reference(q, k, v, lengths, causal), iters=5)
                lib = time_ms(torch, lambda: sdpa(qh, kh, vh, attn_mask=mask))
                peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
                bnd, bound_by = bound_ms("fwd", LENGTHS, causal, q.element_size(), peak)
                say(f"kernel {layout} {dtype_name} causal={causal} strides {q.stride()}: "
                    f"max|dO|={err_o:.3e} (<= {tol_o} + {TOL_O_REL[dtype_name]}*|O|, "
                    f"worst excess {excess_o:.3e}) max|dlse|={err_l:.3e} (<= {tol_l}); "
                    f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
                    f"bound {bnd:.4f} ms ({bound_by})")
                if not finite or excess_o > tol_o or err_l > tol_l:
                    raise SystemExit(f"flash kernel disagrees with its plain version "
                                     f"({layout}, {dtype_name}, causal={causal})")
                worst = max(worst, err_o, err_l)
                if layout == "fused" and dtype == torch.bfloat16 and not causal:
                    row = {"ms": ms, "plain_ms": plain, "bound_ms": bnd,
                           "bound_by": bound_by, "library_ms": lib}
                    say("kernel: sdpa (bool mask, bf16) ran on: " + device_kernels(
                        torch, lambda: sdpa(qh, kh, vh, attn_mask=mask)))
    row["max_abs_err"] = worst
    return row


def make_requests(rng):
    reqs = []
    for _ in range(N_REQUESTS):
        ns, nt = rng.randint(MIN_LEN, T + 1, size=2)
        trg = rng.randint(2, VOCAB, size=nt)
        reqs.append((list(rng.randint(2, VOCAB, size=ns)), [0] + list(trg[:-1]), list(trg)))
    return reqs


def phase_slice(torch, P, fa, card):
    from paddle_tpu_torch.models.transformer import transformer_base

    P.init(seed=7, compute_dtype="bfloat16", use_flash_attention=True)
    _, probs = transformer_base(VOCAB, VOCAB)
    t0 = time.perf_counter()
    params = P.parameters.create(probs, seed=7)
    say(f"params: {sum(v.numel() for p in params.params.values() for v in p.values())} "
        f"on {params.params['dec_out']['w0'].device} in {time.perf_counter() - t0:.1f} s")
    inf = P.Inference(probs, params)
    reqs = make_requests(np.random.RandomState(0))
    inf.infer(reqs[:2], feeding=FEEDING, batch_size=BATCH)  # warm-up
    torch.cuda.synchronize()

    fa.flash_attention.launches = 0
    per_batch, results, batch_s = [], [], []
    t0 = time.perf_counter()
    for res in inf.iter_infer_field(field="value", input=reqs, feeding=FEEDING, batch_size=BATCH):
        # each batch ends in a host copy of its outputs, which waits for the card
        batch_s.append(time.perf_counter() - t0 - sum(batch_s))
        per_batch.append(fa.flash_attention.launches - sum(per_batch))
        results.append(res[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    say(f"slice: {len(results)} batches, kernel launches per batch {per_batch}, "
        f"seconds per batch {[round(x, 4) for x in batch_s]}")
    if per_batch != [18] * (N_REQUESTS // BATCH):
        raise SystemExit(f"expected 18 flash launches per batch, got {per_batch}")

    out = np.concatenate(results, axis=0)
    n_trg = sum(len(r[1]) for r in reqs)
    n_src = sum(len(r[0]) for r in reqs)
    if out.shape != (n_trg, VOCAB):
        raise SystemExit(f"output shape {out.shape} != {(n_trg, VOCAB)}")
    if not np.isfinite(out).all():
        raise SystemExit("non-finite probabilities")
    sums = out.sum(axis=1)
    say(f"slice: row sums in [{sums.min():.6f}, {sums.max():.6f}]")
    if np.abs(sums - 1.0).max() > 1e-2:
        raise SystemExit("a distribution does not sum to 1 within 1e-2")

    say(f"slice: {N_REQUESTS} requests ({n_src} source + {n_trg} target tokens) in "
        f"{wall:.4f} s: {N_REQUESTS / wall:.3f} requests/s, "
        f"{(n_src + n_trg) / wall:.1f} tokens/s on {card}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the first batch again through the dense attention path, in bf16 and
    # then (both paths) in f32 compute
    first = reqs[:BATCH]
    dense = _infer_with(P, inf, first, flash=False)
    compare("bf16 flash vs bf16 dense", results[0], dense, max_dp=2e-4)
    P.init(compute_dtype="float32")
    inf32 = P.Inference(probs, params)
    compare("f32 flash vs f32 dense", _infer_with(P, inf32, first, flash=True),
            _infer_with(P, inf32, first, flash=False), max_dp=1e-5)
    if fa.flash_attention.launches != launches + 18:
        raise SystemExit("the dense path launched the flash kernel")
    return launches


def _infer_with(P, inf, reqs, flash):
    P.flags.set_flag("use_flash_attention", flash)
    try:
        return inf.infer(reqs, feeding=FEEDING, batch_size=BATCH)
    finally:
        P.flags.set_flag("use_flash_attention", True)


def compare(name, a, b, max_dp, min_agree=0.99):
    """max |dp| and top-token agreement.  Random weights give flat
    distributions (top probability ~1e-3) whose bf16 values often tie at the
    top, and argmax then picks the first of the tied tokens: a position
    agrees when the top tokens are equal or one path's top token ties for
    the top in the other.  The strict argmax agreement is printed beside it."""
    rows = np.arange(len(a))
    aa, ba = a.argmax(axis=1), b.argmax(axis=1)
    strict = float((aa == ba).mean())
    tied = (a[rows, ba] == a.max(axis=1)) | (b[rows, aa] == b.max(axis=1))
    agree = float(((aa == ba) | tied).mean())
    dp = float(np.abs(a - b).max())
    say(f"slice {name} (first batch): max|dp|={dp:.3e} (<= {max_dp}), top-token "
        f"agreement {agree:.5f} (>= {min_agree}), strict argmax {strict:.5f}")
    if dp > max_dp or agree < min_agree:
        raise SystemExit(f"{name}: the paths disagree")


def launch_counts(fa):
    return (fa.flash_attention.launches, fa.flash_attention_bwd.dq_launches,
            fa.flash_attention_bwd.dkv_launches)


def reset_counts(fa):
    fa.flash_attention.launches = 0
    fa.flash_attention_bwd.dq_launches = 0
    fa.flash_attention_bwd.dkv_launches = 0


def bwd_case(torch, fa, gen, dtype, layout, causal, lengths):
    """Operands of one backward check at phase 4's shapes: (q, k, v, do,
    lse, delta, o) with lse and o from the forward kernel."""
    q, k, v = qkv_operands(torch, gen, dtype, layout)
    do = torch.randn((B, T, H, DH), generator=gen, device="cuda").to(dtype)
    o, lse = fa.flash_attention(q, k, v, lengths, causal, return_lse=True)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    return q, k, v, do, lse, delta, o


def fmt_excess(ex):
    return "; ".join(f"{n} max|d|={e[2]:.3e} worst |d|/bar {e[1]:.3f} excess {e[0]:+.3e}"
                     for n, e in ex.items())


# the planted faults of the plain backward that the bf16 bar must reject
FAULTS = {
    "ds unrounded": lambda fa, a, lengths, causal: fa.flash_attention_bwd_reference(
        *a, lengths, causal, round_ds=False),
    "length mask dropped": lambda fa, a, lengths, causal: fa.flash_attention_bwd_reference(
        *a, None, causal),
}


def phase_bwd_kernel(torch, fa):
    """Backward kernels vs the plain backward on the card; returns the
    kernels-line rows of dq and dk/dv (their times at the fused bf16
    non-causal case, the self-attention layout of the main path).  bf16 is
    held to the derived bar, which must also reject both planted faults."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(1)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device="cuda")
    rows, worst = {}, {"dq": 0.0, "dkv": 0.0}
    caught = {f: {"dq": 0, "dk": 0, "dv": 0} for f in FAULTS}
    for layout in ("fused", "separate"):
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            for causal in (False, True):
                q, k, v, do, lse, delta, o = bwd_case(torch, fa, gen, dtype, layout, causal, lengths)
                args = (q, k, v, lse, delta, do)
                got = fa.flash_attention_bwd(q, k, v, o, lse, delta, do, lengths, causal)
                want = fa.flash_attention_bwd_reference(*args, lengths, causal)
                bf16 = dtype == torch.bfloat16
                bars = (fa.flash_attention_bwd_bar(*args, lengths, causal) if bf16
                        else (TOL_G32,) * 3)
                torch.cuda.synchronize()
                ex = bwd_excess(torch, got, want, bars)
                if bf16:
                    for fault, plant in FAULTS.items():
                        wrong = plant(fa, args, lengths, causal)
                        for name, x, r, bar in zip(("dq", "dk", "dv"), got, wrong, bars):
                            over = ~((x.double() - r.double()).abs() <= bar)
                            caught[fault][name] += int(over.sum().item())
                        del wrong
                for name, e in ex.items():
                    if e[0] > 0:
                        raise SystemExit(f"backward kernel disagrees with the plain backward "
                                         f"({name}, {layout}, {dtype_name}, causal={causal})")
                    kn = "dq" if name == "dq" else "dkv"
                    worst[kn] = max(worst[kn], e[2])
                # each kernel alone, into preallocated outputs
                operands = (q, k, v, do, lse, delta, lengths)
                outs = tuple(torch.empty_like(x) for x in got)
                ms_dq = time_ms(torch, lambda: fa._launch_bwd("dq", operands, outs[:1], causal))
                ms_dkv = time_ms(torch, lambda: fa._launch_bwd("dkv", operands, outs[1:], causal))
                plain = time_ms(torch, lambda: fa.flash_attention_bwd_reference(
                    q, k, v, lse, delta, do, lengths, causal), iters=3)
                # SDPA's backward alone, over one retained forward graph
                mask = attention_mask(torch, lengths, causal)
                qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
                lib_out = sdpa(qh, kh, vh, attn_mask=mask)
                lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
                    lib_out, (qh, kh, vh), do.transpose(1, 2), retain_graph=True))
                main = layout == "fused" and bf16 and not causal
                if main:
                    ran = device_kernels(torch, lambda: fa._launch_bwd("dq", operands, outs[:1], causal))
                    say("bwd: the bf16 dq launch ran on: " + ran)
                    if ran != "not measured" and "fa_bwd_dq_mma_kernel" not in ran:
                        raise SystemExit("the bf16 dq launch did not run fa_bwd_dq_mma_kernel")
                    say("bwd: sdpa backward (bool mask, bf16) ran on: " + device_kernels(
                        torch, lambda: torch.autograd.grad(
                            lib_out, (qh, kh, vh), do.transpose(1, 2), retain_graph=True)))
                del lib_out
                peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
                bnd = {kn: bound_ms(kn, LENGTHS, causal, q.element_size(), peak)
                       for kn in ("dq", "dkv")}
                say(f"bwd {layout} {dtype_name} causal={causal}: {fmt_excess(ex)} "
                    f"(bar: {'derived bf16 bar' if bf16 else TOL_G32}); dq {ms_dq:.4f} ms (bound "
                    f"{bnd['dq'][0]:.4f}, {bnd['dq'][1]}), dkv {ms_dkv:.4f} ms (bound "
                    f"{bnd['dkv'][0]:.4f}, {bnd['dkv'][1]}), plain backward {plain:.4f} ms, "
                    f"sdpa backward {lib_bwd:.4f} ms")
                if main:
                    for kn, ms in (("dq", ms_dq), ("dkv", ms_dkv)):
                        rows[kn] = {"ms": ms, "plain_ms": plain, "bound_ms": bnd[kn][0],
                                    "bound_by": bnd[kn][1], "library_ms": lib_bwd}
    for fault, counts in caught.items():
        say(f"bwd planted fault '{fault}' in the plain backward: elements past the bf16 bar "
            f"over phase 4's bf16 cases: " + ", ".join(f"{n} {c}" for n, c in counts.items()))
        if not any(counts.values()):
            raise SystemExit(f"the bf16 bar let the planted fault '{fault}' through")
    for kn, r in rows.items():
        r["max_abs_err"] = worst[kn]
    return rows


def phase_bar_sweep(torch, fa):
    """The bf16 backward kernels against the plain backward under the derived
    bar over seeds x causal x operand layouts at phase 4's shapes; prints the
    worst |d| / bar of dq, dk and dv."""
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device="cuda")
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    for seed in BAR_SEEDS:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for layout in ("fused", "separate"):
            for causal in (False, True):
                q, k, v, do, lse, delta, o = bwd_case(
                    torch, fa, gen, torch.bfloat16, layout, causal, lengths)
                args = (q, k, v, lse, delta, do)
                got = fa.flash_attention_bwd(q, k, v, o, lse, delta, do, lengths, causal)
                ex = bwd_excess(torch, got, fa.flash_attention_bwd_reference(*args, lengths, causal),
                                fa.flash_attention_bwd_bar(*args, lengths, causal))
                for name, e in ex.items():
                    worst[name] = max(worst[name], e[1])
                    if e[0] > 0:
                        raise SystemExit(f"bar sweep: {name} past the bf16 bar (seed {seed}, "
                                         f"{layout}, causal={causal}): {fmt_excess(ex)}")
    say(f"bar sweep: seeds {list(BAR_SEEDS)} x causal off/on x fused/separate, bf16, phase 4's "
        f"shapes: worst |d|/bar " + ", ".join(f"{n} {w:.3f}" for n, w in worst.items())
        + " (<= 1 passes)")


# edge shapes of the bf16 tensor-core kernels: (B, T, H, dh, lengths)
EDGE_CASES = (
    (3, 200, 4, 40, [200, 77, 0]),
    (3, 200, 4, 64, [200, 77, 0]),
    (2, 256, 4, 128, [256, 131]),
)


def phase_edges(torch, fa):
    """bf16 forward and backward kernels against their plain versions at the
    edge shapes, both operand layouts, causal off and on; phase 2's O and
    lse bars and the derived bf16 backward bar.  The f32 kernels are the
    scalar ones of the earlier phases."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    dt, name = torch.bfloat16, "bfloat16"
    for b, t, h, dh, lens in EDGE_CASES:
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for layout in ("fused", "separate"):
            if layout == "fused":
                qkv = torch.randn((b, t, 3 * h * dh), generator=gen, device="cuda").to(dt)
                q, k, v = (x.view(b, t, h, dh) for x in qkv.split(h * dh, dim=-1))
            else:
                q, k, v = (torch.randn((b, t, h, dh), generator=gen, device="cuda").to(dt)
                           for _ in range(3))
            do = torch.randn((b, t, h, dh), generator=gen, device="cuda").to(dt)
            for causal in (False, True):
                o, lse = fa.flash_attention(q, k, v, lengths, causal, return_lse=True)
                o_r, lse_r = fa.flash_attention_reference(q, k, v, lengths, causal, return_lse=True)
                delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
                args = (q, k, v, lse, delta, do)
                got = fa.flash_attention_bwd(q, k, v, o, lse, delta, do, lengths, causal)
                want = fa.flash_attention_bwd_reference(*args, lengths, causal)
                bars = fa.flash_attention_bwd_bar(*args, lengths, causal)
                torch.cuda.synchronize()
                excess = {}
                for key, x, r, tol, rel in (
                        ("O", o, o_r, TOL_O[name], TOL_O_REL[name]),
                        ("lse", lse, lse_r, TOL_LSE[name], 0.0)):
                    d = (x.float() - r.float()).abs()
                    excess[key] = (d - rel * r.float().abs()).max().item() - tol
                    if not bool(torch.isfinite(x.float()).all()):
                        excess[key] = float("inf")
                ex = bwd_excess(torch, got, want, bars)
                excess.update({g: e[0] for g, e in ex.items()})
                zero = all(torch.count_nonzero(x[i]) == 0
                           for x in (o, *got) for i, n in enumerate(lens) if n == 0)
                say(f"edge B={b} T={t} H={h} dh={dh} lengths {lens} {layout} causal={causal}: "
                    + ", ".join(f"{key} {e:+.3e}" for key, e in excess.items())
                    + " (excess over the bar; <= 0 passes), worst |d|/bar "
                    + ", ".join(f"{g} {e[1]:.3f}" for g, e in ex.items())
                    + f", length-0 rows zero: {zero}")
                if max(excess.values()) > 0 or not zero:
                    raise SystemExit(f"bf16 kernels disagree with the plain versions at an "
                                     f"edge shape (dh={dh}, {layout}, causal={causal})")


def train_samples(rng, n):
    """n (src, trg, trg_next) samples with lengths in 600-1024; the first
    has a source and a target of length 1024, so a batch led by it pads
    every slot to T = 1024."""
    out = []
    for i in range(n):
        ns, nt = (T, T) if i == 0 else rng.randint(MIN_LEN, T + 1, size=2)
        trg = rng.randint(2, VOCAB, size=nt)
        out.append((list(rng.randint(2, VOCAB, size=ns)), [0] + list(trg[:-1]), list(trg)))
    return out


def run_steps(P, trainer, samples, on_event=None):
    trainer.train(P.batch(lambda: iter(samples), BATCH), feeding=FEEDING,
                  event_handler=on_event)


def grads_of(torch, net, params, batch, state=None):
    """(cost, {dotted name: gradient}) of the network's mean cost on `batch`
    in training mode (batch norm on batch statistics); the tree may nest (a
    recurrent group's parameters)."""
    from paddle_tpu_torch.utils.tree import leaf_paths, map_leaves

    leaves = map_leaves(lambda v: v.detach().requires_grad_(True), params)
    paths = list(leaf_paths(leaves))
    cost, _ = net.cost(leaves, batch, state=state, train=True)
    gs = torch.autograd.grad(cost, [v for _, v in paths], allow_unused=True)
    return cost.item(), {".".join(p): g for (p, _), g in zip(paths, gs) if g is not None}


def phase_train(torch, P, fa, card):
    """Transformer-base training through SGD.train; returns the launches of
    each kernel in the timed run and the trainer (for the profiler)."""
    from paddle_tpu_torch.models.transformer import transformer_base
    from paddle_tpu_torch.reader.feeder import DataFeeder

    P.init(seed=11, compute_dtype="bfloat16", use_flash_attention=True)
    cost, _ = transformer_base(VOCAB, VOCAB)
    params = P.parameters.create(cost, seed=11)
    trainer = P.trainer.SGD(
        cost, params, P.optimizer.Momentum(learning_rate=TRAIN_LR, momentum=0.9))
    rng = np.random.RandomState(1)
    warm = train_samples(rng, BATCH)
    timed = [s for _ in range(TRAIN_BATCHES) for s in train_samples(rng, BATCH)]
    run_steps(P, trainer, warm)  # first step: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts(fa)
    steps, clock = [], [0.0]

    def on_event(e):
        if isinstance(e, P.event.BeginIteration):
            torch.cuda.synchronize()
            clock[0] = time.perf_counter()
        elif isinstance(e, P.event.EndIteration):
            # the cost's host copy waits for the whole step, update included
            steps.append((time.perf_counter() - clock[0], launch_counts(fa), e.cost))

    run_steps(P, trainer, timed, on_event)
    launches = launch_counts(fa)
    per_step = [tuple(c - p for c, p in zip(cur[1], prev))
                for cur, prev in zip(steps, [(0, 0, 0)] + [s[1] for s in steps[:-1]])]
    costs = [s[2] for s in steps]
    secs = [s[0] for s in steps]
    say(f"train: {len(steps)} steps, costs {[round(c, 4) for c in costs]}, launches per step "
        f"(fwd, dq, dkv) {per_step}, seconds per step {[round(x, 4) for x in secs]}")
    if len(steps) != TRAIN_BATCHES or not all(np.isfinite(costs)):
        raise SystemExit("training gave a non-finite cost or a missing step")
    if per_step != [(18, 18, 18)] * TRAIN_BATCHES:
        raise SystemExit(f"expected 18/18/18 flash launches per step, got {per_step}")
    valid = sum(len(s[0]) + len(s[1]) for s in timed)
    mean_s = float(np.mean(secs))
    say(f"train: {mean_s:.4f} s per step (mean of {len(secs)}), "
        f"{valid / sum(secs):.1f} valid tokens/s ({2 * BATCH * T * len(secs) / sum(secs):.1f} "
        f"padded tokens/s), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"on {card}")

    fixed = train_samples(rng, BATCH)
    fixed_costs = []
    run_steps(P, trainer, fixed * FIXED_STEPS,
              lambda e: fixed_costs.append(e.cost) if isinstance(e, P.event.EndIteration) else None)
    say(f"train: {FIXED_STEPS} steps on one batch, costs {[round(c, 4) for c in fixed_costs]}")
    if not all(np.isfinite(fixed_costs)) or not fixed_costs[-1] < fixed_costs[0]:
        raise SystemExit("the cost did not fall over repeated steps on one batch")

    # one step's gradients, flash against dense, from the trained parameters
    for dtype_name in ("float32", "bfloat16"):
        net = P.CompiledNetwork(P.Topology(cost), compute_dtype=dtype_name)
        feeder = DataFeeder(net.topology.data_types(), FEEDING, device=trainer.device)
        batch = feeder(fixed)
        before = launch_counts(fa)
        c_f, g_f = grads_of(torch, net, trainer.parameters.params, batch)
        flash_launches = tuple(a - b for a, b in zip(launch_counts(fa), before))
        P.flags.set_flag("use_flash_attention", False)
        try:
            c_d, g_d = grads_of(torch, net, trainer.parameters.params, batch)
        finally:
            P.flags.set_flag("use_flash_attention", True)
        if flash_launches != (18, 18, 18) or launch_counts(fa) != tuple(
                b + f for b, f in zip(before, flash_launches)):
            raise SystemExit(f"{dtype_name} gradients: flash launches {flash_launches}, "
                             "or the dense path launched a flash kernel")
        diff2 = {n: ((g_f[n].float() - g_d[n].float()) ** 2).sum().item() for n in g_d}
        norm2 = {n: (g_d[n].float() ** 2).sum().item() for n in g_d}
        rel_l2 = (sum(diff2.values()) / sum(norm2.values())) ** 0.5
        leaf = max(g_d, key=lambda n: diff2[n] / max(norm2[n], 1e-30))
        say(f"train {dtype_name} gradients flash vs dense: cost {c_f:.6f} vs {c_d:.6f}; "
            f"|dg|/|g| over all {len(g_d)} leaves = {rel_l2:.3e} (<= "
            f"{GRAD_REL[dtype_name]}); worst leaf {leaf} "
            f"{(diff2[leaf] / max(norm2[leaf], 1e-30)) ** 0.5:.3e}")
        if set(g_f) != set(g_d) or not rel_l2 <= GRAD_REL[dtype_name]:
            raise SystemExit(f"{dtype_name} gradients: flash and dense disagree")
        del g_f, g_d
    return {"fwd": launches[0], "dq": launches[1], "dkv": launches[2]}, trainer, mean_s


def phase_profile(torch, P, trainer):
    """Top device kernels over two training steps from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    samples = [s for _ in range(2) for s in train_samples(np.random.RandomState(2), BATCH)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps(P, trainer, samples)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in dev)
    if total_us <= 0:
        raise SystemExit("profile: the profiler shows no device time, so the dq route "
                         "is not shown")
    say(f"profile: 2 steps in {wall:.4f} s (profiler on), device busy {total_us / 1e6:.4f} s "
        f"({total_us / 1e6 / wall:.3f} of the window); top device kernels per step:")
    for e in sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        say(f"  {e.self_device_time_total / 2e3:9.3f} ms  {e.count / 2:6.1f} calls  "
            f"{100 * e.self_device_time_total / total_us:5.1f}%  {e.key[:100]}")
    # fa_fwd_kernel / fa_fwd_mma_kernel, fa_bwd_dkv_kernel / fa_bwd_dkv_mma_kernel
    flash = {kn: sum(e.self_device_time_total for e in dev if f"fa_{kn}_" in e.key)
             for kn in ("fwd", "bwd_dq", "bwd_dkv")}
    say("profile: flash kernels per step " + ", ".join(
        f"{kn} {us / 2e3:.3f} ms ({100 * us / total_us:.1f}%)" for kn, us in flash.items()))
    dq = [e for e in dev if "fa_bwd_dq_" in e.key]
    for e in dq:
        say(f"profile: dq ran as {e.key[:90]}: {e.count / 2:.1f} calls and "
            f"{e.self_device_time_total / 2e3:.3f} ms per step")
    # the timed steps are bf16: every dq launch must be the tensor-core kernel
    if len(dq) != 1 or "fa_bwd_dq_mma_kernel<" not in dq[0].key or dq[0].count != 2 * 18:
        raise SystemExit("profile: the training steps' dq did not run as 18 launches per "
                         "step of fa_bwd_dq_mma_kernel")

# ResNet-50 at bench.py's configuration (bench.py:386-392): depth 50, 1000
# classes, 224x224x3, batch 128, bf16 compute over f32 masters, Momentum with
# momentum 0.9; random images and labels from a seed, as bench.py's.
# bench.py's rate 0.1, from this random init, drives the cost on distinct
# batches up (7.6 -> 8.7 in four steps) and makes it oscillate on the fixed
# batch (9.54 -> 11.03 over five steps in one of five runs), so the smoke
# takes 0.01; the work of a step, and so its time, does not depend on it
RN_DEPTH, RN_CLASSES, RN_IMG, RN_BATCH = 50, 1000, 224, 128
RN_LR = 0.01
RN_TIMED = 4  # distinct batches of the timed run, after one warm-up step
RN_FIXED = 5  # steps on one fixed batch: the cost must fall
RN_INFER = 256  # served images, in batches of RN_BATCH
RN_CHECK_B = 2  # batch of the card-against-CPU checks
# Card against CPU in f32 (TF32 off), through the same port code and
# weights: summation order only (cuDNN's autotuned algorithms against the
# CPU's convolutions).
# - One training step's gradients at B=2 are ill-conditioned: the pooled
#   gradient is constant over each image's last 8x8 map, and batch norm's
#   backward on batch statistics subtracts its mean, so f32 rounding is
#   amplified (the CPU's own f32 gradient lies 1.6e-3 to 2.2e-2, relative
#   L2, from its f64 gradient, trained and untrained).  So both f32
#   gradients are held to the CPU's f64 gradient of the same function: the
#   card's may be at most RN_GRAD_SLACK times as far from it as the CPU's
#   f32 one, and never needs to be nearer than RN_GRAD_FLOOR.
# - Served outputs (global statistics: batch norm is affine) are
#   well-conditioned: 1e-4 on the probabilities and 1e-3 of the largest
#   |logit| on the logits (the moving statistics of a few steps can
#   saturate the softmax, where the logits still show a disagreement).
RN_GRAD_SLACK = 2.0
RN_GRAD_FLOOR = 1e-5
RN_PROB_ABS = 1e-4
RN_LOGIT_REL = 1e-3
RN_FEEDING = {"image": 0, "label": 1}


def resnet_images(rng, n):
    """n (image, label) samples: flat CHW images from N(0, 1), as bench.py's."""
    imgs = rng.randn(n, 3 * RN_IMG * RN_IMG).astype(np.float32)
    labels = rng.randint(0, RN_CLASSES, size=n)
    return [(imgs[i], int(labels[i])) for i in range(n)]


def run_resnet(P, trainer, samples, on_event=None):
    trainer.train(P.batch(lambda: iter(samples), RN_BATCH), feeding=RN_FEEDING,
                  event_handler=on_event)


def conv_flops(topology) -> int:
    """Forward FLOPs per image of the topology's convs: 2 kh kw (cin/groups)
    cout out_h out_w each."""
    return sum(2 * a["filter_h"] * a["filter_w"] * (a["in_c"] // a["groups"]) * a["channels"]
               * a["out_h"] * a["out_w"]
               for a in (c.attrs for c in topology.layers.values() if c.type == "conv"))


def rel_l2(torch, got, want) -> float:
    """|got - want| / |want| over every leaf of two {name: tensor} dicts."""
    d2 = sum(((got[n].double().cpu() - want[n].double().cpu()) ** 2).sum().item() for n in want)
    n2 = sum((want[n].double().cpu() ** 2).sum().item() for n in want)
    return (d2 / n2) ** 0.5


def phase_resnet_train(torch, P, card):
    """Phase 8: ResNet-50 training through SGD.train; returns the trainer
    and the prediction layer."""
    from paddle_tpu_torch.models.resnet import resnet_cost
    from paddle_tpu_torch.reader.feeder import DataFeeder

    torch.backends.cudnn.benchmark = True
    say("resnet: torch.backends.cudnn.benchmark on from here on (autotuned conv algorithms)")
    P.init(seed=21, compute_dtype="bfloat16")
    cost, probs = resnet_cost(depth=RN_DEPTH, class_num=RN_CLASSES, img_size=RN_IMG)
    params = P.parameters.create(cost, seed=21)
    state0 = {l: {k: v.clone() for k, v in s.items()} for l, s in params.state.items()}
    trainer = P.trainer.SGD(cost, params, P.optimizer.Momentum(learning_rate=RN_LR, momentum=0.9))
    topo = trainer.topology
    step_flops = 3 * RN_BATCH * conv_flops(topo)
    say(f"resnet: ResNet-{RN_DEPTH} {RN_IMG}x{RN_IMG}x3, {RN_CLASSES} classes, batch {RN_BATCH}, "
        f"bf16 compute, Momentum({RN_LR}, 0.9), "
        f"{sum(v.numel() for p in params.params.values() for v in p.values())} "
        f"parameters, {sum(c.type == 'conv' for c in topo.layers.values())} convs, "
        f"{len(params.state)} batch norms; {step_flops:.6e} conv FLOPs per training step "
        f"(3 x forward)")
    rng = np.random.RandomState(5)
    t0 = time.perf_counter()
    run_resnet(P, trainer, resnet_images(rng, RN_BATCH))  # cuDNN autotuning, allocator
    torch.cuda.synchronize()
    say(f"resnet: warm-up step {time.perf_counter() - t0:.3f} s")
    timed = resnet_images(rng, RN_TIMED * RN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    steps, clock = [], [0.0]

    first_bn = next(n for n, c in topo.layers.items() if c.type == "batch_norm")
    end_pass_mean = []

    def on_event(e):
        if isinstance(e, P.event.BeginIteration):
            torch.cuda.synchronize()
            clock[0] = time.perf_counter()
        elif isinstance(e, P.event.EndIteration):
            # the cost's host copy waits for the whole step, update included
            steps.append((time.perf_counter() - clock[0], e.cost))
        elif isinstance(e, P.event.EndPass):
            end_pass_mean.append(trainer.parameters.state[first_bn]["mean"].abs().sum().item())

    run_resnet(P, trainer, timed, on_event)
    after = trainer.parameters.state[first_bn]["mean"].abs().sum().item()
    say(f"resnet train: sum |moving mean| of {first_bn} read in the EndPass handler "
        f"{end_pass_mean}, after train returned {after}")
    if len(end_pass_mean) != 1 or not end_pass_mean[0] > 0 or end_pass_mean[0] != after:
        raise SystemExit("resnet: EndPass did not see the trained batch-norm state")
    secs, costs = [s[0] for s in steps], [s[1] for s in steps]
    peak = torch.cuda.max_memory_allocated()
    say(f"resnet train: {len(steps)} steps, costs {[round(c, 4) for c in costs]}, seconds per "
        f"step {[round(x, 4) for x in secs]} (each includes feeding the batch from the host)")
    if len(steps) != RN_TIMED or not all(np.isfinite(costs)):
        raise SystemExit("resnet training gave a non-finite cost or a missing step")
    mean_s = float(np.mean(secs))
    say(f"resnet train: {mean_s:.4f} s per step (mean of {len(secs)}), "
        f"{RN_BATCH * len(secs) / sum(secs):.2f} images/s, conv FLOPs "
        f"{step_flops / mean_s / 1e12:.2f} TFLOP/s = {step_flops / mean_s / PEAK_BF16_FLOPS:.4f} of "
        f"the bf16 peak, peak memory {peak / 2**30:.2f} GiB on {card}")

    feeder = DataFeeder(topo.data_types(), RN_FEEDING, device=trainer.device)
    t0 = time.perf_counter()
    feeder(timed[:RN_BATCH])
    torch.cuda.synchronize()
    say(f"resnet train: feeding one batch from the host (numpy stack, copy to the card) "
        f"{time.perf_counter() - t0:.4f} s of each step")

    fixed = resnet_images(rng, RN_BATCH)
    fixed_costs = []
    run_resnet(P, trainer, fixed * RN_FIXED,
               lambda e: fixed_costs.append(e.cost) if isinstance(e, P.event.EndIteration) else None)
    say(f"resnet train: {RN_FIXED} steps on one batch, costs {[round(c, 4) for c in fixed_costs]}")
    if not all(np.isfinite(fixed_costs)) or not fixed_costs[-1] < fixed_costs[0]:
        raise SystemExit("resnet: the cost did not fall over repeated steps on one batch")

    phase_nan_step(torch, P, trainer)
    state = trainer.parameters.state
    still = [l for l in state0 for k in ("mean", "var") if torch.equal(state[l][k], state0[l][k])]
    finite = all(bool(torch.isfinite(v).all()) for s in state.values() for v in s.values())
    var_lo = min(s["var"].min().item() for s in state.values())
    say(f"resnet train: batch-norm state of {len(state)} layers after {1 + RN_TIMED + RN_FIXED} "
        f"steps: {len(still)} statistics unmoved, finite {finite}, smallest moving var {var_lo:.4e}")
    if still or not finite or set(state) != set(state0):
        raise SystemExit("resnet: a batch-norm moving statistic did not move or is not finite")

    # one step's gradients at B=2, card (f32) against CPU (f32, f64), from the
    # trained parameters and state
    net = P.CompiledNetwork(P.Topology(cost), compute_dtype="float32")
    check = resnet_images(np.random.RandomState(6), RN_CHECK_B)
    got = {}
    for where, dev, dtype in (("card f32", trainer.device, torch.float32),
                              ("CPU f32", torch.device("cpu"), torch.float32),
                              ("CPU f64", torch.device("cpu"), torch.float64)):
        batch = DataFeeder(net.topology.data_types(), RN_FEEDING, device=dev)(check)
        batch["image"] = batch["image"].with_data(batch["image"].data.to(dtype))
        cast = lambda tree: {l: {k: v.to(dev, dtype) for k, v in p.items()} for l, p in tree.items()}
        t0 = time.perf_counter()
        got[where] = grads_of(torch, net, cast(trainer.parameters.params), batch, cast(state))
        say(f"resnet gradients, {where}: cost {got[where][0]:.9f} in {time.perf_counter() - t0:.2f} s")
    ref = got["CPU f64"][1]
    e_card, e_cpu = (rel_l2(torch, got[w][1], ref) for w in ("card f32", "CPU f32"))
    bar = max(RN_GRAD_SLACK * e_cpu, RN_GRAD_FLOOR)
    say(f"resnet gradients B={RN_CHECK_B}, |dg|/|g| over all {len(ref)} leaves against the CPU's "
        f"f64: card f32 {e_card:.3e} (<= {bar:.3e} = max({RN_GRAD_SLACK} x CPU f32's, "
        f"{RN_GRAD_FLOOR})), CPU f32 {e_cpu:.3e}; card vs CPU f32 "
        f"{rel_l2(torch, got['card f32'][1], got['CPU f32'][1]):.3e}")
    if set(got["card f32"][1]) != set(ref) or not e_card <= bar:
        raise SystemExit("resnet: the card's gradients stray from the CPU's")
    return trainer, probs


def clone_tree(tree):
    """A copy of nested dicts and tuples of tensors (numbers pass)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(clone_tree(v) for v in tree)
    return tree.clone() if hasattr(tree, "clone") else tree


def trees_equal(torch, a, b) -> bool:
    """Bit equality of two nested dicts and tuples of tensors."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(trees_equal(torch, a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(trees_equal(torch, x, y) for x, y in zip(a, b))
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


def phase_nan_step(torch, P, trainer):
    """Phase 8: one step on a batch with a NaN pixel through the trainer's
    train step: the divergence sentinel must report health 0 and leave
    params, layer state and optimizer state torch.equal to before."""
    from paddle_tpu_torch.reader.feeder import DataFeeder

    samples = resnet_images(np.random.RandomState(9), RN_BATCH)
    samples[3][0][RN_IMG] = np.nan
    batch = DataFeeder(trainer.topology.data_types(), RN_FEEDING, device=trainer.device)(samples)
    params, state, opt = trainer.parameters.params, trainer.parameters.state, trainer._opt_state
    before = clone_tree((params, state, opt))
    step = P.trainer.make_train_step(trainer.network, trainer.optimizer)
    p2, s2, o2, m = step(params, state, opt, batch, 1)
    health = float(m["health"])
    same = trees_equal(torch, (p2, s2, o2), before)
    say(f"resnet sentinel: a batch with a NaN pixel: cost {float(m['cost'])}, grad_norm "
        f"{float(m['grad_norm'])}, health {health}; params, batch-norm state and momentum "
        f"(step {o2['step']}) torch.equal to before: {same}")
    if health != 0.0 or not same:
        raise SystemExit("resnet: the NaN step was not skipped with the state unchanged")


def phase_resnet_infer(torch, P, probs, trainer, card):
    """Phase 7: ResNet-50 serving through Inference.infer from the trained
    parameters and state (global statistics)."""
    from paddle_tpu_torch.core.device import tree_to
    from paddle_tpu_torch.reader.feeder import DataFeeder

    P.init(compute_dtype="bfloat16")
    inf = P.Inference(probs, trainer.parameters)
    images = [(x,) for x, _ in resnet_images(np.random.RandomState(7), RN_INFER + RN_BATCH)]
    inf.infer(images[RN_INFER:], batch_size=RN_BATCH)  # warm-up
    torch.cuda.synchronize()
    results, batch_s = [], []
    t0 = time.perf_counter()
    for res in inf.iter_infer_field(field="value", input=images[:RN_INFER], batch_size=RN_BATCH):
        # each batch ends in a host copy of its outputs, which waits for the card
        batch_s.append(time.perf_counter() - t0 - sum(batch_s))
        results.append(res[0])
    wall = time.perf_counter() - t0
    out = np.concatenate(results, axis=0)
    sums = out.sum(axis=1)
    say(f"resnet infer: {RN_INFER} images in {len(results)} batches of {RN_BATCH}, bf16, seconds "
        f"per batch {[round(x, 4) for x in batch_s]}, {RN_INFER / wall:.2f} images/s on {card}; "
        f"row sums in [{sums.min():.6f}, {sums.max():.6f}], top probability "
        f"{out.max(axis=1).mean():.4f} on average")
    if out.shape != (RN_INFER, RN_CLASSES) or not np.isfinite(out).all():
        raise SystemExit(f"resnet infer: output {out.shape} not finite or not "
                         f"{(RN_INFER, RN_CLASSES)}")
    if np.abs(sums - 1.0).max() > 1e-2:
        raise SystemExit("resnet infer: a distribution does not sum to 1 within 1e-2")

    P.init(compute_dtype="float32")
    two = images[:RN_CHECK_B]
    card_p = P.Inference(probs, trainer.parameters).infer(two, batch_size=RN_CHECK_B)
    cpu_p = P.Inference(probs, trainer.parameters, device="cpu").infer(two, batch_size=RN_CHECK_B)
    dp = float(np.abs(card_p - cpu_p).max())
    # the same forward's logits, on each device
    net = P.CompiledNetwork(P.Topology(probs), compute_dtype="float32")
    logits = []
    for dev in (trainer.device, torch.device("cpu")):
        batch = DataFeeder(net.topology.data_types(), {"image": 0}, device=dev)(two)
        with torch.inference_mode():
            outs, _ = net.apply(tree_to(trainer.parameters.params, dev), batch,
                                state=tree_to(trainer.parameters.state, dev), train=False)
        logits.append(outs[probs.name + "@logits"].data.cpu().double())
    dl = ((logits[0] - logits[1]).abs().max() / logits[1].abs().max()).item()
    say(f"resnet infer f32 B={RN_CHECK_B}, card vs CPU: max|dp| = {dp:.3e} (<= {RN_PROB_ABS}), "
        f"max|dlogit|/max|logit| = {dl:.3e} (<= {RN_LOGIT_REL}, largest |logit| "
        f"{logits[1].abs().max().item():.4e}), top classes {card_p.argmax(axis=1).tolist()} vs "
        f"{cpu_p.argmax(axis=1).tolist()}")
    if not dp <= RN_PROB_ABS or not dl <= RN_LOGIT_REL:
        raise SystemExit("resnet infer: card and CPU outputs disagree")
    P.init(compute_dtype="bfloat16")


# device kernels that only change a tensor's layout or dtype
LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw", "direct_copy")


def phase_resnet_profile(torch, P, trainer):
    """Phase 9: torch.profiler over two ResNet-50 training steps: the top
    device kernels, the busy share, and the layout-transform kernels per
    step beside the convs, which shows whether the convs run in NHWC."""
    from torch.profiler import ProfilerActivity, profile

    samples = resnet_images(np.random.RandomState(8), 2 * RN_BATCH)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_resnet(P, trainer, samples)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in dev)
    if total_us <= 0:
        raise SystemExit("resnet profile: the profiler shows no device time")
    say(f"resnet profile: 2 steps in {wall:.4f} s (profiler on), device busy {total_us / 1e6:.4f} s "
        f"({total_us / 1e6 / wall:.3f} of the window); top device kernels per step:")
    for e in sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        say(f"  {e.self_device_time_total / 2e3:9.3f} ms  {e.count / 2:6.1f} calls  "
            f"{100 * e.self_device_time_total / total_us:5.1f}%  {e.key[:100]}")
    ops = {e.key: e.count / 2 for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    say("resnet profile: conv ops per step: " + ", ".join(
        f"{k} {ops.get(k, 0):.1f}" for k in ("aten::cudnn_convolution", "aten::convolution_backward")))
    for pat in LAYOUT_KERNELS:
        hits = [e for e in dev if pat in e.key]
        say(f"resnet profile: '{pat}' kernels per step: {sum(e.count for e in hits) / 2:.1f} "
            f"launches, {sum(e.self_device_time_total for e in hits) / 2e3:.3f} ms "
            f"({100 * sum(e.self_device_time_total for e in hits) / total_us:.1f}% of device time)")
    groups = {"torch's own kernels (elementwise, reductions, copies)": lambda k: "at::native" in k,
              "memcpy and memset": lambda k: k.startswith(("Memcpy", "Memset")),
              "library kernels (cuDNN convs, cuBLAS)": lambda k: True}
    left = list(dev)
    for name, match in groups.items():
        hits = [e for e in left if match(e.key)]
        left = [e for e in left if not match(e.key)]
        us = sum(e.self_device_time_total for e in hits)
        say(f"resnet profile: {name}: {us / 2e3:.3f} ms per step ({100 * us / total_us:.1f}% of "
            f"device time), {sum(e.count for e in hits) / 2:.1f} launches")

# Phase 10: the training spine at full width, on phase 5's configuration.
SPINE_BATCHES, SPINE_PASSES = 3, 2  # distinct batches per pass, passes
SPINE_SAVE_STEP = 2  # save_checkpoint after this step
SPINE_SPREAD_SLACK = 3.0  # restored costs within this times two runs' spread
SENTINEL_ROUNDS = 10  # (off, on, on, off) rounds timing the sentinel's cost
# Phase 10b: each rule 3 updates of the full parameter tree in f32, card
# against CPU from the same numbers: elementwise arithmetic that may round
# differently in the last place (fused multiply-adds), far below 1e-5 of the
# leaf's largest |param|
OPT_UPDATES, OPT_REL = 3, 1e-5
OPT_RULES = {
    "Momentum": dict(learning_rate=0.01, momentum=0.9),
    "SparseMomentum": dict(learning_rate=0.01),
    "AdaGrad": dict(learning_rate=0.01),
    "AdaDelta": dict(learning_rate=1.0),
    "RMSProp": dict(learning_rate=1e-3),
    "DecayedAdaGrad": dict(learning_rate=1e-3),
    "Adam": dict(learning_rate=1e-3),
    "AdaMax": dict(learning_rate=2e-3),
}
# Phase 10c: dropout on an fc of width 2048 over 8 x 1024 tokens (bf16), and
# error clipping card against CPU in f32 (summation order only: relative L2
# of the gradients <= 1e-5; the clip must bind, moving them >= 1e-2)
DROP_RATE, DROP_IN, DROP_W = 0.1, 512, 2048
CLIP_T, CLIP_REL, CLIP_BINDS = 1e-3, 1e-5, 1e-2


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def phase_spine(torch, P, fa, card, phase5_s):
    """Phase 10; returns the trained parameter tree (for phase 10b)."""
    import io
    import tempfile

    from paddle_tpu_torch import checkpoint as ckpt
    from paddle_tpu_torch.models.transformer import transformer_base

    P.init(seed=31, compute_dtype="bfloat16", use_flash_attention=True)
    cost, probs = transformer_base(VOCAB, VOCAB)
    rng = np.random.RandomState(31)
    batches = [train_samples(rng, BATCH) for _ in range(SPINE_BATCHES)]
    held = train_samples(rng, BATCH)
    n_steps = SPINE_BATCHES * SPINE_PASSES

    def make_trainer(seed):
        return P.trainer.SGD(cost, P.parameters.create(cost, seed=seed),
                             P.optimizer.Momentum(learning_rate=TRAIN_LR, momentum=0.9))

    def run(trainer, batch_list, num_passes, log, on_extra=None, **kw):
        samples = [x for b in batch_list for x in b]
        clock = [0.0]

        def on_event(e):
            if isinstance(e, P.event.BeginIteration):
                torch.cuda.synchronize()
                clock[0] = time.perf_counter()
            elif isinstance(e, P.event.EndIteration):
                log.append((e.cost, time.perf_counter() - clock[0]))
            if on_extra is not None:
                on_extra(e)

        trainer.train(P.batch(lambda: iter(samples), BATCH), num_passes=num_passes,
                      feeding=FEEDING, event_handler=on_event, **kw)

    tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-spine-")
    reset_counts(fa)
    t_phase = time.perf_counter()
    # (a) the uninterrupted run, sentinel on (the default)
    trainer = make_trainer(31)
    man = ckpt.CheckpointManager(os.path.join(tmp.name, "ckpt"), max_to_keep=1)
    log_a, info, snap = [], {"test": [], "tar": []}, {}

    def on_extra(e):
        if isinstance(e, P.event.EndIteration) and len(log_a) == SPINE_SAVE_STEP:
            # the parameters and momentum are updated in place: the trainer
            # holds this step's values
            t0 = time.perf_counter()
            trainer.save_checkpoint(man)
            info["save"] = (dir_bytes(man.directory), time.perf_counter() - t0)
            snap["state"] = clone_tree((trainer.parameters.params, trainer._opt_state["m"]))
            snap["step"] = (trainer._opt_state["step"], trainer._step_count)
        elif isinstance(e, P.event.EndPass):
            t0 = time.perf_counter()
            res = trainer.test(P.batch(lambda: iter(held), BATCH), feeding=FEEDING)
            info["test"].append((e.pass_id, res.cost, time.perf_counter() - t0))
            buf = io.BytesIO()
            t0 = time.perf_counter()
            trainer.save_parameter_to_tar(buf)
            info["tar"].append((len(buf.getvalue()), time.perf_counter() - t0))
            info["last_tar"] = buf

    pass_dir = os.path.join(tmp.name, "passes")
    t0 = time.perf_counter()
    run(trainer, batches, SPINE_PASSES, log_a, on_extra, save_dir=pass_dir, saving_period=1)
    t_train = time.perf_counter() - t0
    costs_a = [c for c, _ in log_a]
    say(f"spine: SGD.train {SPINE_PASSES} passes of {SPINE_BATCHES} batches in {t_train:.2f} s "
        f"(saves and tests included): costs {costs_a}, seconds per step "
        f"{[round(x, 4) for _, x in log_a]}")
    say(f"spine: EndPass trainer.test on a held-out batch (pass, cost, s): {info['test']}; "
        f"parameter tar into a buffer (bytes, s): {info['tar']}")
    passes = sorted(os.listdir(pass_dir))
    say(f"spine: save_dir holds {passes}, {dir_bytes(pass_dir)} bytes "
        f"(params.tar and one v1 file per parameter in each)")
    if (len(costs_a) != n_steps or not all(np.isfinite(costs_a)) or len(info["test"]) != 2
            or not all(np.isfinite(c) for _, c, _ in info["test"])
            or passes != ["pass-00000", "pass-00001"]):
        raise SystemExit("spine: the run, its EndPass tests or its pass dirs are incomplete")

    # (b) a Parameters from the last tar serves bit-identically
    buf = info["last_tar"]
    buf.seek(0)
    t0 = time.perf_counter()
    loaded = P.parameters.Parameters.from_tar(buf)
    t_load = time.perf_counter() - t0
    out_mem = P.Inference(probs, trainer.parameters).infer(batches[0], feeding=FEEDING,
                                                           batch_size=BATCH)
    out_tar = P.Inference(probs, loaded).infer(batches[0], feeding=FEEDING, batch_size=BATCH)
    same = bool(np.array_equal(out_mem, out_tar))
    say(f"spine: Parameters.from_tar of the last tar ({len(buf.getvalue())} bytes, read in "
        f"{t_load:.3f} s): Inference of batch 0 {out_tar.shape}, bit-identical to the "
        f"trained in-memory parameters: {same}")
    if not same or not np.isfinite(out_mem).all():
        raise SystemExit("spine: the parameters loaded from the tar serve differently")

    # (c) a trainer from fresh parameters restores the step-2 checkpoint
    restored = make_trainer(77)
    t0 = time.perf_counter()
    if not restored.restore_checkpoint(man):
        raise SystemExit("spine: restore_checkpoint found no checkpoint")
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    equal = trees_equal(torch, (restored.parameters.params, restored._opt_state["m"]),
                        snap["state"])
    steps = (restored._opt_state["step"], restored._step_count)
    say(f"spine: save_checkpoint after step {SPINE_SAVE_STEP}: {info['save'][0]} bytes in "
        f"{info['save'][1]:.3f} s; restore_checkpoint into fresh parameters in {t_restore:.3f} s: "
        f"params and momentum bit-identical to the first trainer's at step {SPINE_SAVE_STEP}: "
        f"{equal}; optimizer step and step count {steps} (want {snap['step']})")
    if not equal or steps != snap["step"] or steps[0] != SPINE_SAVE_STEP:
        raise SystemExit("spine: the restored state differs from the saved one")
    del snap
    log_b = []
    rest = batches[SPINE_SAVE_STEP:] + batches * (SPINE_PASSES - 1)
    run(restored, rest, 1, log_b)
    costs_b = [c for c, _ in log_b]
    del restored
    # a second uninterrupted run, with the sentinel off: its costs give the
    # spread of two runs, its steps the time without the sentinel
    P.flags.set_flag("divergence_sentinel", False)
    try:
        plain = make_trainer(31)
    finally:
        P.flags.set_flag("divergence_sentinel", True)
    log_c = []
    run(plain, batches, SPINE_PASSES, log_c)
    costs_c = [c for c, _ in log_c]
    # the sentinel's cost: the train step with it on and off, in turns on
    # this trainer's state (off, on, on, off, ...), from batches fed before
    from paddle_tpu_torch.reader.feeder import DataFeeder

    feeder = DataFeeder(plain.topology.data_types(), FEEDING, device=plain.device)
    fed = [feeder(b) for b in batches]
    step_fns = {flag: P.trainer.make_train_step(plain.network, plain.optimizer, sentinel=flag)
                for flag in (False, True)}
    turns = {False: [], True: []}
    tree = (plain.parameters.params, plain.parameters.state, plain._opt_state)
    for i, flag in enumerate((False, True, True, False) * SENTINEL_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        *tree, m = step_fns[flag](*tree, fed[i % len(fed)])
        float(m["cost"])  # waits for the step, update included
        turns[flag].append(time.perf_counter() - t0)
    del plain, tree, fed
    tail_a, tail_c = costs_a[SPINE_SAVE_STEP:], costs_c[SPINE_SAVE_STEP:]
    spread = max(abs(a - c) for a, c in zip(tail_a, tail_c))
    diff = max(abs(a - b) for a, b in zip(tail_a, costs_b)) if len(costs_b) == len(tail_a) else None
    bitwise = costs_b == tail_a
    say(f"spine: restored trainer's costs over the remaining {len(costs_b)} batches {costs_b}; "
        f"uninterrupted {tail_a}; bit for bit: {bitwise}; max |d| {diff}; a second "
        f"uninterrupted run {tail_c}, spread {spread} (bar when not bit for bit: "
        f"{SPINE_SPREAD_SLACK} x spread)")
    if diff is None or not (bitwise or (spread > 0 and diff <= SPINE_SPREAD_SLACK * spread)):
        raise SystemExit("spine: the restored trainer does not continue like the uninterrupted one")

    # (d) the kernels were on the path, (e) the sentinel's cost per step
    counts = launch_counts(fa)
    n_train = len(log_a) + len(log_b) + len(log_c) + len(turns[False]) + len(turns[True])
    say(f"spine: flash launches (fwd, dq, dkv) over phase 10: {counts} for {n_train} training "
        f"steps (18 per step each), 2 tests and 2 served batches; phase {time.perf_counter() - t_phase:.1f} s")
    if counts[0] < 18 * n_train or counts[1] != 18 * n_train or counts[2] != 18 * n_train:
        raise SystemExit("spine: the flash kernels were not on the path of every step")
    on = float(np.mean([x for _, x in log_a[1:]]))
    off = float(np.mean([x for _, x in log_c[1:]]))
    say(f"spine: seconds per SGD.train step (mean of steps 2-{n_steps}, feeding included) "
        f"sentinel on {on:.4f} (first run), off {off:.4f} (third run) ({100 * (on / off - 1):+.1f}%); "
        f"phase 5 (sentinel on) {phase5_s:.4f}; on {card}")
    q_on, q_off = (np.percentile(turns[flag], [25, 50, 75]) for flag in (True, False))
    say(f"spine: the train step alone in turns (off, on, on, off) x {SENTINEL_ROUNDS}: sentinel on "
        f"{[round(x, 4) for x in turns[True]]}, off {[round(x, 4) for x in turns[False]]}; "
        f"quartiles on {[round(float(x), 4) for x in q_on]} s, off "
        f"{[round(float(x), 4) for x in q_off]} s; "
        f"medians {100 * (q_on[1] / q_off[1] - 1):+.1f}%")
    params = trainer.parameters.params
    tmp.cleanup()
    return params


def phase_optimizers(torch, P, params, card_dev):
    """Phase 10b: the eight rules on the full Transformer-base tree, card
    against CPU."""
    base = {l: {k: v.detach().float().cpu() for k, v in p.items()} for l, p in params.items()}
    n = sum(v.numel() for p in base.values() for v in p.values())
    gen = torch.Generator().manual_seed(53)
    grads = [{l: {k: torch.randn(v.shape, generator=gen) for k, v in p.items()}
              for l, p in base.items()} for _ in range(OPT_UPDATES)]
    to_card = lambda tree: {l: {k: v.to(card_dev) for k, v in p.items()} for l, p in tree.items()}  # noqa: E731
    worst_all = 0.0
    for name, kw in OPT_RULES.items():
        cpu_p, card_p = clone_tree(base), to_card(base)
        cpu_o, card_o = getattr(P.optimizer, name)(**kw), getattr(P.optimizer, name)(**kw)
        cpu_s, card_s = cpu_o.init(cpu_p), card_o.init(card_p)
        t0 = time.perf_counter()
        for g in grads:
            card_o.update(to_card(g), card_s, card_p)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        for g in grads:
            cpu_o.update(g, cpu_s, cpu_p)
        t_cpu = time.perf_counter() - t0
        worst, leaf = -1.0, None
        for l, p in cpu_p.items():
            for k, v in p.items():
                r = ((card_p[l][k].cpu() - v).abs().max() / v.abs().max().clamp(min=1e-30)).item()
                if not r <= worst:
                    worst, leaf = r, f"{l}.{k}"
        slots = card_o.slot_names()
        say(f"optimizers: {name}({kw}) slots {slots}: {OPT_UPDATES} updates of {n} f32 parameters, "
            f"card {t_card:.3f} s (the gradients' copy included), CPU {t_cpu:.3f} s; worst "
            f"|d| / max|param| per leaf {worst:.3e} at {leaf} (<= {OPT_REL})")
        if not worst <= OPT_REL or not card_s["step"] == cpu_s["step"] == OPT_UPDATES:
            raise SystemExit(f"optimizers: {name} on the card strays from the CPU")
        worst_all = max(worst_all, worst)
        del cpu_p, card_p, cpu_s, card_s
    say(f"optimizers: worst over the eight rules {worst_all:.3e} (<= {OPT_REL})")


def phase_dropout_clip(torch, P, card_dev):
    """Phase 10c: dropout statistics on the card, and error clipping card
    against CPU."""
    from paddle_tpu_torch.core.batch import SeqTensor

    L, A, dt = P.layer, P.activation, P.data_type
    P.init(seed=41, compute_dtype="bfloat16")
    x = L.data("spine_x", dt.dense_vector_sequence(DROP_IN))
    h = L.fc(x, size=DROP_W, act=A.Sigmoid(), name="spine_drop",
             layer_attr=P.attr.ExtraAttr(drop_rate=DROP_RATE))
    net = P.CompiledNetwork(P.Topology(h))
    params = net.init_params(41)
    gen = torch.Generator(device=card_dev).manual_seed(41)
    batch = {"spine_x": SeqTensor(
        torch.randn((BATCH, T, DROP_IN), generator=gen, device=card_dev),
        torch.full((BATCH,), T, dtype=torch.int32, device=card_dev))}
    keep = 1.0 - DROP_RATE
    with torch.no_grad():
        out = lambda train, rng: net.apply(params, batch, train=train, rng=rng)[0]["spine_drop"].data  # noqa: E731
        plain = out(False, None)
        a, a2, b, off = out(True, 5), out(True, 5), out(True, 6), out(False, 5)
        torch.cuda.synchronize()
        ms_plain = time_ms(torch, lambda: out(False, None), iters=10)
        ms_drop = time_ms(torch, lambda: out(True, 5), iters=10)
    mask = a != 0
    share = mask.float().mean().item()
    sigma = (keep * DROP_RATE / mask.numel()) ** 0.5
    scaled = torch.equal(a[mask], (plain / keep)[mask])
    same, other = torch.equal(a, a2), not torch.equal(mask, b != 0)
    untouched = torch.equal(off, plain) and bool((plain != 0).all())
    say(f"dropout: fc {DROP_IN}->{DROP_W} over {BATCH}x{T} tokens, {plain.dtype}, rate {DROP_RATE}: "
        f"kept share {share:.6f} ({abs(share - keep) / sigma:.2f} sigma from {keep}, bar 5); kept "
        f"values == undropped / {keep}: {scaled}; same seed same mask: {same}; next seed another "
        f"mask: {other}; train=False untouched: {untouched}; forward {ms_drop:.4f} ms with "
        f"dropout, {ms_plain:.4f} ms without")
    if not (abs(share - keep) <= 5 * sigma and scaled and same and other and untouched):
        raise SystemExit("dropout: a check failed on the card")

    P.init(seed=43, compute_dtype="float32")
    rng = np.random.RandomState(43)
    xs = rng.randn(64, 256).astype(np.float32)
    labels = rng.randint(0, 16, size=64)
    got = {}
    for clip in (CLIP_T, 0.0):
        cx = L.data("clip_x", dt.dense_vector(256))
        lab = L.data("clip_label", dt.integer_value(16))
        attr = P.attr.ExtraAttr(error_clipping_threshold=clip) if clip else None
        hh = L.fc(cx, size=256, act=A.Tanh(), layer_attr=attr, name="clip_h")
        pred = L.fc(hh, size=16, act=A.Softmax(), name="clip_pred")
        cnet = P.CompiledNetwork(P.Topology(L.classification_cost(pred, lab)))
        cpu_params = cnet.init_params(43, device="cpu")
        for where, dev in (("card", card_dev), ("CPU", torch.device("cpu"))):
            batch = {"clip_x": SeqTensor(torch.from_numpy(xs).to(dev)),
                     "clip_label": SeqTensor(torch.from_numpy(labels).to(dev))}
            tree = {l: {k: v.to(dev) for k, v in p.items()} for l, p in cpu_params.items()}
            got[where, clip] = grads_of(torch, cnet, tree, batch)[1]
    e = rel_l2(torch, got["card", CLIP_T], got["CPU", CLIP_T])
    binds = rel_l2(torch, got["CPU", CLIP_T], got["CPU", 0.0])
    say(f"error clip: threshold {CLIP_T}, f32: clipped gradients card vs CPU relative L2 "
        f"{e:.3e} (<= {CLIP_REL}); clipped vs unclipped (CPU) {binds:.3e} (>= {CLIP_BINDS})")
    if not e <= CLIP_REL or not binds >= CLIP_BINDS:
        raise SystemExit("error clip: the card's clipped gradient strays, or the clip did not bind")
    P.init(compute_dtype="bfloat16")


# Phase 11: attention NMT training at bench.py's bench_nmt configuration
# (bench.py:486-502): word and hidden width 512, source and target vocab
# 30000, bf16 compute over f32 masters, Momentum(0.05, 0.9), 4096 pairs with
# lengths 8-50 drawn beta(2, 3) from RandomState(0), token_budget_batch with a
# budget of 128 x ladder_len(50) = 8192 padded tokens (batches of 128 at rung
# 64, 256 at rung 32, 512 at rung 16), the feeder on the shape ladder
NMT_VOCAB, NMT_WIDTH, NMT_BATCH = 30000, 512, 128
NMT_PAIRS, NMT_MIN_LEN, NMT_MAX_LEN = 4096, 8, 50
NMT_LR = 0.05
NMT_TIMED, NMT_PROFILED = 4, 2  # timed steps after one warm-up; profiled steps
# card against CPU and fused against generic: one step's gradients in f32 at a
# small width (vocab, width, batch, longest length), relative L2 over every
# leaf: summation order only
NMT_SMALL = (512, 64, 8, 30)
NMT_GRAD_REL = 1e-4


def nmt_corpus(vocab, n, seed=0):
    """bench_nmt's corpus: (src, trg, trg_next) id lists with lengths
    NMT_MIN_LEN..NMT_MAX_LEN drawn beta(2, 3)."""
    rng = np.random.RandomState(seed)
    lens = (NMT_MIN_LEN + np.floor((NMT_MAX_LEN - NMT_MIN_LEN + 1)
                                   * rng.beta(2.0, 3.0, n))).astype(int)
    return [tuple([int(t) for t in rng.randint(1, vocab, size=int(n_))] for _ in range(3))
            for n_ in lens]


def nmt_counts():
    from paddle_tpu_torch.layers.recurrent_group import counters as group
    from paddle_tpu_torch.ops.rnn import counters as cores

    return group, cores


def phase_nmt(torch, P, fa, card):
    """Phase 11: attention NMT training through SGD.train over
    token_budget_batch at bench_nmt's configuration, its profile, and one
    step's gradients card vs CPU and fused vs generic in f32."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.core.batch import DEFAULT_LADDER, ladder_len
    from paddle_tpu_torch.core.device import tree_to
    from paddle_tpu_torch.models.seq2seq import seq2seq_cost
    from paddle_tpu_torch.reader.bucketing import token_budget_batch
    from paddle_tpu_torch.reader.feeder import DataFeeder
    from paddle_tpu_torch.utils.tree import leaves

    group, cores = nmt_counts()
    P.init(seed=51, compute_dtype="bfloat16", use_bucketing=True)
    cost, _ = seq2seq_cost(NMT_VOCAB, NMT_VOCAB, NMT_WIDTH, NMT_WIDTH)
    params = P.parameters.create(cost, seed=51)
    n_params = sum(v.numel() for v in leaves(params.params))
    trainer = P.trainer.SGD(cost, params, P.optimizer.Momentum(learning_rate=NMT_LR, momentum=0.9))
    budget = NMT_BATCH * ladder_len(NMT_MAX_LEN)
    batches = list(token_budget_batch(lambda: iter(nmt_corpus(NMT_VOCAB, NMT_PAIRS)),
                                      token_budget=budget, drop_last=True)())
    need = 1 + NMT_TIMED + NMT_PROFILED
    say(f"nmt: {n_params} parameters in {len(leaves(params.params))} leaves; {len(batches)} "
        f"batches of budget {budget} padded tokens from {NMT_PAIRS} pairs; steps: "
        + ", ".join(f"{len(b)}x{ladder_len(max(len(s[1]) for s in b))}" for b in batches[:need]))

    def train(batch_list, on_event=None):
        trainer.train(lambda: iter(batch_list), feeding=FEEDING, event_handler=on_event)

    reset_counts(fa)
    train(batches[:1])  # first step: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    group.clear()
    cores.clear()
    steps, clock = [], [0.0]

    def on_event(e):
        if isinstance(e, P.event.BeginIteration):
            torch.cuda.synchronize()
            clock[0] = time.perf_counter()
        elif isinstance(e, P.event.EndIteration):
            # the cost's host copy waits for the whole step, update included
            steps.append((time.perf_counter() - clock[0], e.cost))

    timed = batches[1:1 + NMT_TIMED]
    train(timed, on_event)
    secs, costs = [s[0] for s in steps], [s[1] for s in steps]
    valid = sum(len(s[2]) for b in timed for s in b)
    say(f"nmt: {len(steps)} timed steps at Momentum({NMT_LR}, 0.9), bf16: costs "
        f"{[round(c, 4) for c in costs]}, seconds per step {[round(x, 4) for x in secs]}")
    say(f"nmt: {float(np.mean(secs)):.4f} s per step (mean of {len(secs)}), "
        f"{valid / sum(secs):.1f} valid target tokens/s ({valid} tokens), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    say(f"nmt: decoder lowerings {dict(group)}; recurrence steps run/skipped by the early "
        f"exit: gru {cores['gru_steps']}/{cores['gru_skipped']}, attention-gru "
        f"{cores['attgru_steps']}/{cores['attgru_skipped']}")
    if len(steps) != NMT_TIMED or not all(np.isfinite(costs)):
        raise SystemExit("nmt: training gave a non-finite cost or a missing step")
    if group["fused"] != NMT_TIMED or group["generic"]:
        raise SystemExit("nmt: the decoder did not take the fused attention-GRU core on every step")

    prof_batches = batches[1 + NMT_TIMED:need]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(prof_batches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in dev)
    launches = sum(e.count for e in dev)
    if total_us <= 0:
        raise SystemExit("nmt profile: the profiler shows no device time")
    say(f"nmt profile: {NMT_PROFILED} steps in {wall:.4f} s (profiler on), device busy "
        f"{total_us / 1e6:.4f} s ({total_us / 1e6 / wall:.3f} of the window), "
        f"{launches / NMT_PROFILED:.0f} device kernels per step; top device kernels per step:")
    for e in sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        say(f"  {e.self_device_time_total / NMT_PROFILED / 1e3:9.3f} ms  "
            f"{e.count / NMT_PROFILED:7.1f} calls  {100 * e.self_device_time_total / total_us:5.1f}%  "
            f"{e.key[:100]}")
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("nmt: the NMT path launched a flash kernel")
    del trainer, params
    torch.cuda.empty_cache()

    # one step's gradients in f32 at a small width: card vs CPU, fused vs generic
    vocab, width, rows, max_len = NMT_SMALL
    P.init(seed=53, compute_dtype="float32", use_bucketing=True)
    small, _ = seq2seq_cost(vocab, vocab, width, width)
    net = P.CompiledNetwork(P.Topology(small), compute_dtype="float32")
    cpu_params = net.init_params(53, device="cpu")
    samples = [tuple(x[:max_len] for x in s) for s in nmt_corpus(vocab, rows, seed=53)]
    got = {}
    for where, dev_ in (("card", torch.device("cuda")), ("CPU", torch.device("cpu"))):
        batch = DataFeeder(net.topology.data_types(), FEEDING, ladder=DEFAULT_LADDER,
                           device=dev_)(samples)
        tree = tree_to(cpu_params, dev_)
        group.clear()
        got[where] = grads_of(torch, net, tree, batch)
        if group["fused"] != 1:
            raise SystemExit(f"nmt: the {where} gradient step did not take the fused core")
        if where == "card":
            P.flags.set_flag("fused_attention_gru", False)
            try:
                got["generic"] = grads_of(torch, net, tree, batch)
            finally:
                P.flags.set_flag("fused_attention_gru", True)
            if group["generic"] != 1:
                raise SystemExit("nmt: the generic loop did not run with the fused flag off")
    e_cpu = rel_l2(torch, got["card"][1], got["CPU"][1])
    e_gen = rel_l2(torch, got["card"][1], got["generic"][1])
    say(f"nmt f32 gradients at vocab {vocab}, width {width}, {rows} rows: cost card "
        f"{got['card'][0]:.6f} CPU {got['CPU'][0]:.6f} generic {got['generic'][0]:.6f}; "
        f"relative L2 over all {len(got['CPU'][1])} leaves: card vs CPU {e_cpu:.3e}, fused vs "
        f"generic (card) {e_gen:.3e} (<= {NMT_GRAD_REL})")
    if set(got["card"][1]) != set(got["CPU"][1]) or not (e_cpu <= NMT_GRAD_REL
                                                         and e_gen <= NMT_GRAD_REL):
        raise SystemExit("nmt: the card's gradients stray from the CPU's or the generic loop's")
    P.init(compute_dtype="bfloat16", use_bucketing=False)


# ---------------------------------------------------------------------------
# phases 12 and 13: NMT generation and serving
# ---------------------------------------------------------------------------

GEN_B, GEN_BEAM, GEN_MAXLEN, GEN_SRC = 64, 5, 32, 40  # bench_nmt_generate
GEN_TIMED = 4  # timed calls of each search, after one warm-up call
GEN_SMALL = (512, 64, 8)  # vocab, width, rows of the card-vs-CPU checks
GEN_SCORE_REL = 1e-5
SERVE_REQUESTS, SERVE_SLOTS, SERVE_K, SERVE_BUDGET_MB = 64, 16, 8, 64
NEAR_TIE = 1e-4  # a served token may leave the one-shot path's only where its top-2 gap is below


def profile_call(torch, fn):
    """(wall s, device busy s, device kernels, top kernels) of one call of fn
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in dev)
    if busy_us <= 0:
        raise SystemExit("profile: the profiler shows no device time")
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return wall, busy_us / 1e6, sum(e.count for e in dev), [
        f"{e.self_device_time_total / 1e3:8.3f} ms {e.count:6d} calls  {e.key[:90]}" for e in top]


def top_beam_tokens(seqs, eos):
    """bench_nmt_generate's count: top-beam tokens before the first EOS (the
    whole row when there is none)."""
    top = seqs[:, 0, :].cpu().numpy()
    eos_pos = np.where(top == eos, np.arange(top.shape[1])[None, :], top.shape[1])
    return int(eos_pos.min(axis=1).sum()) or top.size


def phase_generate(torch, P, fa, card):
    """Phase 12: beam and greedy generation at bench_nmt_generate's
    configuration through Seq2SeqGenerator on the card; card vs CPU and
    fused vs generic stepping at a small width."""
    from paddle_tpu_torch.core.batch import DEFAULT_LADDER, SeqTensor, set_host_lengths
    from paddle_tpu_torch.models import seq2seq as S
    from paddle_tpu_torch.reader.feeder import DataFeeder

    P.init(seed=61, compute_dtype="float32")
    cost, _ = S.seq2seq_cost(NMT_VOCAB, NMT_VOCAB, NMT_WIDTH, NMT_WIDTH)
    params = P.parameters.create(cost, seed=61)
    gen = S.Seq2SeqGenerator(params, NMT_VOCAB, NMT_VOCAB, word_dim=NMT_WIDTH,
                             hidden_dim=NMT_WIDTH, bos_id=0, eos_id=1, max_length=GEN_MAXLEN,
                             beam_size=GEN_BEAM)
    ids = np.random.RandomState(0).randint(2, NMT_VOCAB, size=(GEN_B, GEN_SRC)).astype(np.int32)
    lens = np.full((GEN_B,), GEN_SRC, np.int32)
    batch = {"src_word": SeqTensor(torch.from_numpy(ids).cuda(),
                                   set_host_lengths(torch.from_numpy(lens).cuda(), lens))}
    reset_counts(fa)
    S.counters.clear()
    out = {}
    for name, call in (("beam", lambda: gen.generate(batch)),
                       ("greedy", lambda: gen.generate_greedy(batch))):
        res = call()  # warm-up: cuBLAS handles and heuristics
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GEN_TIMED):
            res = call()
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / GEN_TIMED
        if name == "beam":
            n_tok = top_beam_tokens(res[0], gen.eos_id)
            if not torch.isfinite(res[1]).all() or not (res[1][:, :-1] >= res[1][:, 1:]).all():
                raise SystemExit("generate: scores not finite or not sorted best first")
        else:
            n_tok = int(res[1].sum()) or res[0].numel()
        wall, busy, kernels, top = profile_call(torch, call)
        out[name] = secs
        say(f"generate {name}: {secs:.4f} s per call (mean of {GEN_TIMED}), {n_tok / secs:.1f} "
            f"{'top-beam ' if name == 'beam' else ''}tokens/s ({n_tok} tokens), "
            f"{secs / GEN_B * 1e3:.4f} ms per sentence; profiled call {wall:.4f} s, device busy "
            f"{busy:.4f} s ({busy / wall:.3f} of the window), {kernels} device kernels "
            f"({kernels / GEN_MAXLEN:.1f} per decode step) on {card}")
        for line in top:
            say(f"  {line}")
    steps = (1 + GEN_TIMED + 1) * GEN_MAXLEN
    say(f"generate: decoder steps fused {S.counters['fused']}, generic {S.counters['generic']} "
        f"({steps} beam steps and up to {steps} greedy); flash launches {launch_counts(fa)}")
    if S.counters["generic"] or S.counters["fused"] <= steps:
        raise SystemExit("generate: generation did not take the fused attention-GRU step")
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("generate: the generation path launched a flash kernel")
    del gen, params
    torch.cuda.empty_cache()

    # card vs CPU, and fused vs generic on the card, at a small width in f32
    vocab, width, rows = GEN_SMALL
    small, _ = S.seq2seq_cost(vocab, vocab, width, width)
    cpu_params = P.parameters.create(small, seed=63, device="cpu")
    rng = np.random.RandomState(63)
    samples = [(rng.randint(2, vocab, size=n).tolist(),) for n in rng.randint(4, 40, size=rows)]
    got = {}
    for where in ("card", "CPU", "generic"):
        dev = "cpu" if where == "CPU" else "cuda"
        g = S.Seq2SeqGenerator(cpu_params, vocab, vocab, word_dim=width, hidden_dim=width,
                               bos_id=0, eos_id=1, max_length=GEN_MAXLEN, beam_size=GEN_BEAM,
                               device=dev)
        b = DataFeeder(g._enc_net.topology.data_types(), ladder=DEFAULT_LADDER, min_seq_len=1,
                       device=dev)(samples)
        P.flags.set_flag("fused_attention_gru", where != "generic")
        S.counters.clear()
        try:
            seqs, scores = g.generate(b)
            toks, lengths = g.generate_greedy(b, early_exit=False)
        finally:
            P.flags.set_flag("fused_attention_gru", True)
        if S.counters["fused" if where != "generic" else "generic"] != 2 * GEN_MAXLEN:
            raise SystemExit(f"generate: the {where} run took the other stepping")
        got[where] = [x.cpu() for x in (seqs, scores, toks, lengths)]
    rel = float(((got["card"][1] - got["CPU"][1]).abs() / got["CPU"][1].abs()).max())
    same = {k: all(torch.equal(a, b) for i, (a, b) in enumerate(zip(got["card"], got[k])) if i != 1)
            for k in ("CPU", "generic")}
    say(f"generate f32 at vocab {vocab}, width {width}, {rows} rows: beam and greedy tokens card "
        f"== CPU {same['CPU']}, fused == generic on the card {same['generic']}; beam scores card "
        f"vs CPU worst relative {rel:.3e} (<= {GEN_SCORE_REL}), fused vs generic "
        f"{float((got['card'][1] - got['generic'][1]).abs().max()):.3e} absolute")
    if not (same["CPU"] and same["generic"] and rel <= GEN_SCORE_REL):
        raise SystemExit("generate: the card's tokens or scores stray from the CPU's or the "
                         "generic stepping's")
    return out


def oneshot_trace(torch, eng, src, n):
    """The one-shot greedy path's chosen log-prob and top-2 gap at each of n
    steps for one request (teacher-forced on its own argmax, so the tokens
    are reference_decode's), through the same batch of the engine's rows."""
    from paddle_tpu_torch.core.batch import pad_batch_rows

    gen = eng._gen
    with torch.no_grad():
        statics, carry, b, gp = gen._prepare(pad_batch_rows(eng._feeder([(list(src),)]), eng.rows))
        step = gen._step_fn(statics, gp)
        ids = torch.full((b,), gen.bos_id, dtype=torch.int32, device=eng.device)
        toks, chosen, gaps = [], [], []
        for _ in range(n):
            logp, carry = step(ids, carry)
            top2 = torch.topk(logp[0], 2).values
            ids = torch.argmax(logp, dim=-1).to(torch.int32)
            toks.append(ids[0])
            chosen.append(top2[0])
            gaps.append(top2[0] - top2[1])
    toks = torch.stack(toks).tolist()
    n_ok = toks.index(gen.eos_id) if gen.eos_id in toks else n
    return toks[:n_ok], torch.stack(chosen).tolist(), torch.stack(gaps).tolist()


def drive_engine(eng, reqs, drills=False):
    """Admit as slots free and step until every request is served; with
    `drills`, preempt the newest request after the second dispatch (it is
    re-queued first) and cancel one after the third.  Returns (seconds,
    dispatches, preempted, cancelled)."""
    import collections

    queue = collections.deque(reqs)
    preempted = cancelled = None
    dispatches = 0
    t0 = time.perf_counter()
    while queue or eng.n_live:
        if queue and eng.n_free_slots:
            for r in eng.admit(list(queue)):
                queue.remove(r)
        eng.step()
        dispatches += 1
        if drills and dispatches == 2:
            preempted = eng.preempt()
            queue.appendleft(preempted)
        if drills and dispatches == 3:
            victim = next(r for r in eng.outstanding_requests() if r is not preempted)
            cancelled = eng.cancel_by_id(victim.req_id)
    return time.perf_counter() - t0, dispatches, preempted, cancelled


def phase_serve(torch, P, fa, card):
    """Phase 13: the ServingEngine at full width serving bench_serving's
    request mix, a preemption and a cancel, every request held to
    reference_decode under the near-tie rule."""
    from paddle_tpu_torch.models import seq2seq as S
    from paddle_tpu_torch.serving import Request, ServingEngine

    P.init(seed=61, compute_dtype="float32")
    cost, _ = S.seq2seq_cost(NMT_VOCAB, NMT_VOCAB, NMT_WIDTH, NMT_WIDTH)
    params = P.parameters.create(cost, seed=61)
    gen = S.Seq2SeqGenerator(params, NMT_VOCAB, NMT_VOCAB, word_dim=NMT_WIDTH,
                             hidden_dim=NMT_WIDTH, bos_id=0, eos_id=1, max_length=GEN_MAXLEN)
    eng = ServingEngine(gen, max_slots=SERVE_SLOTS, block_steps=SERVE_K,
                        max_new_tokens=GEN_MAXLEN, hbm_budget_mb=SERVE_BUDGET_MB)
    pages = eng.pages.summary()
    rng = np.random.RandomState(0)
    srcs = [rng.randint(2, NMT_VOCAB, size=rng.randint(4, 31)).tolist()
            for _ in range(SERVE_REQUESTS)]
    say(f"serve: {pages['n_blocks']} blocks of {pages['block_tokens']} tokens x "
        f"{pages['bytes_per_block']} bytes under {SERVE_BUDGET_MB} MB; decode bundle "
        f"{eng.weight_bytes} bytes; {SERVE_REQUESTS} requests of {min(map(len, srcs))}-"
        f"{max(map(len, srcs))} source tokens")
    # warm-up: both page rungs at every slot rung the run can reach
    for n in (16, 8, 4, 2):
        drive_engine(eng, [Request([2] * (5 + 20 * (i % 2))) for i in range(n)])
    eng.decode_shapes.clear()
    eng.prefill_shapes.clear()
    reset_counts(fa)
    reqs = [Request(s) for s in srcs]
    secs, dispatches, preempted, cancelled = drive_engine(eng, reqs, drills=True)
    served = [r for r in reqs if r is not cancelled]
    n_tok = sum(len(r.tokens) for r in served)
    tpots = sorted((r.token_times[-1] - r.t_admit) / len(r.tokens) for r in served if r.tokens)
    pct = lambda p: tpots[min(len(tpots) - 1, int(p * len(tpots)))]  # noqa: E731
    say(f"serve: {len(served)} requests in {secs:.4f} s: {len(served) / secs:.2f} requests/s, "
        f"{n_tok / secs:.1f} generated tokens/s ({n_tok} tokens); per-token latency p50 "
        f"{pct(0.5) * 1e3:.4f} ms, p99 {pct(0.99) * 1e3:.4f} ms; {dispatches} decode dispatches, "
        f"{len(eng.decode_shapes)} decode shape variants {sorted(eng.decode_shapes)}, "
        f"{len(eng.prefill_shapes)} prefill shapes; preempted {preempted.req_id}, cancelled "
        f"{cancelled.req_id} on {card}")
    if cancelled.tokens is not None or eng.pages.n_used or eng.n_free_slots != SERVE_SLOTS:
        raise SystemExit("serve: the cancel or the drain left pages or slots behind")
    wall, busy, kernels, top = profile_call(
        torch, lambda: drive_engine(eng, [Request(s) for s in srcs]))
    say(f"serve profile: the same {SERVE_REQUESTS} requests in {wall:.4f} s (profiler on), device "
        f"busy {busy:.4f} s ({busy / wall:.3f} of the window), {kernels} device kernels on "
        f"{card}; flash launches over the phase {launch_counts(fa)}")
    for line in top:
        say(f"  {line}")
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("serve: the serving path launched a flash kernel")

    # the decode's products at the engine's rows: a row's bits must not
    # depend on its position, and (for the record) which other row counts
    # would round it alike
    w = eng._w
    x_gen = torch.Generator(device=eng.device).manual_seed(0)
    moved, alike = [], {}
    for name in ("w_emb", "w1", "w_ctx", "w_c", "head_w"):
        wt = w[name]
        x = torch.randn((eng.rows, wt.shape[0]), generator=x_gen, device=eng.device)
        perm = torch.randperm(eng.rows, generator=x_gen, device=eng.device)
        full = x @ wt
        if not torch.equal(x[perm] @ wt, full[perm]):
            moved.append(name)
        alike[name] = [m for m in (1, 2, 4, 8) if torch.equal(x[:m] @ wt, full[:m])]
    say(f"serve: at M = {eng.rows} rows a row's product depends on its position for {moved}; "
        "the rows of x[:M] @ W equal to M = " + f"{eng.rows}'s at M = " + "; ".join(
            f"{n} {tuple(w[n].shape)}: {ms}" for n, ms in alike.items()))
    if moved:
        raise SystemExit("serve: a product's row depends on its position at a fixed M")

    diverged, worst_d, gaps = 0, 0.0, []
    for r in served:
        ref = eng.reference_decode(r.src_ids, GEN_MAXLEN)
        toks, chosen, gap = oneshot_trace(torch, eng, r.src_ids, GEN_MAXLEN)
        if toks != ref:
            raise SystemExit(f"serve: the one-shot trace of {r.req_id} is not reference_decode's")
        j = next((i for i, (a, b) in enumerate(zip(r.tokens, ref)) if a != b),
                 None if len(r.tokens) == len(ref) else min(len(r.tokens), len(ref)))
        n_match = len(r.tokens) if j is None else j
        worst_d = max([worst_d] + [abs(a - b) for a, b in zip(r.token_logprobs[:n_match],
                                                               chosen[:n_match])])
        if j is not None:
            diverged += 1
            gaps.append((r.req_id, j, gap[j]))
    say(f"serve vs reference_decode: {diverged} of {len(served)} requests diverged "
        f"{[(rid, j, f'{g:.3e}') for rid, j, g in gaps]}; largest |d| of the emitted tokens' "
        f"log-probs over the matching prefixes {worst_d:.3e}")
    if any(g >= NEAR_TIE for _, _, g in gaps):
        raise SystemExit(f"serve: a request left the one-shot path where its top-2 gap is >= "
                         f"{NEAR_TIE}")
    # the engine's own claim is stronger: every product at the one-shot
    # path's shapes gives each request its tokens and log-probs bit for bit
    if diverged or worst_d:
        raise SystemExit("serve: the engine is not bit-identical to reference_decode")
    return {"requests_per_s": len(served) / secs, "tokens_per_s": n_tok / secs}


# ---------------------------------------------------------------------------
# phases 14 and 15: LSTM text classification and the CRF tagger
# ---------------------------------------------------------------------------

# bench_lstm_textcls (bench.py:2013): the reference's benchmark/paddle/rnn
# network at hidden_size=512, lstm_num=2, vocab 30000, reviews of 100
# tokens, batch 128.  tests/configs/demo_text_lstm.py trains this family
# with Adam(2e-3).  At width 512, on a fixed batch, Adam overshoots once the
# cost nears 0.4, not alike from run to run: at 2e-3 the cost rose to 2-6
# after 3-5 steps, in bf16 and in f32; at 1e-3 it rose at step 5 in one run
# of two.  At 5e-4 it fell over 7 steps, so the phase takes Adam(5e-4)
TXT_VOCAB, TXT_EMB, TXT_HIDDEN, TXT_LAYERS = 30000, 128, 512, 2
TXT_B, TXT_T, TXT_LR = 128, 100, 5e-4
TXT_TIMED, TXT_FIXED, TXT_PROFILED = 4, 5, 2
TXT_SERVE = 256  # reviews served through paddle.infer, in batches of TXT_B
TXT_SMALL = (512, 32, 4)  # vocab, width, rows of the card-vs-CPU checks
TXT_GRAD_REL = 1e-5
# the CRF tagger (models/sequence_tagging.py, BASELINE config #4): CoNLL-2000's
# 11 chunk types in IOB (23 labels), vocab 30000, the function's own widths,
# Adam(2e-2) as tests/test_demos.py trains it
TAG_VOCAB, TAG_LABELS, TAG_TYPES, TAG_B, TAG_LR = 30000, 23, 11, 128, 2e-2
TAG_STEPS = 200  # fresh batches: every word id is seen ~5 times
TAG_ACC = 0.9
TAG_GRAD_REL = 1e-5


def text_lstm_cost(P, vocab, emb, hidden, layers):
    """benchmark/paddle/rnn/rnn.py through the v2 DSL: embedding -> `layers`
    x simple_lstm(hidden) -> last_seq -> fc(2, softmax) -> classification
    cost.  Returns (cost, probabilities)."""
    L = P.layer
    net = L.embedding(L.data("word", P.data_type.integer_value_sequence(vocab)), size=emb)
    for _ in range(layers):
        net = P.networks.simple_lstm(net, hidden)
    probs = L.fc(L.last_seq(net), size=2, act=P.activation.Softmax())
    label = L.data("label", P.data_type.integer_value(2))
    return L.classification_cost(input=probs, label=label), probs


def text_reviews(rng, n, vocab, ragged):
    """n (token ids, label) reviews from `rng`: TXT_T tokens each, or (ragged)
    10-100 tokens drawn beta(2, 3) as bench.py draws its variable-length
    corpus (bench.py:2089-2096)."""
    if ragged:
        lens = (10 + np.floor(91 * rng.beta(2.0, 3.0, size=n))).astype(int)
    else:
        lens = np.full(n, TXT_T)
    return [([int(t) for t in rng.randint(2, vocab, size=int(m))], int(rng.randint(0, 2)))
            for m in lens]


def addmm_counts(run) -> dict:
    """{input shapes: count} of the aten::addmm calls `run()` makes, from
    torch.profiler with shapes recorded (a window of its own: recording
    shapes slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        run()
    return {str(e.input_shapes[:3]): e.count
            for e in prof.key_averages(group_by_input_shape=True) if e.key == "aten::addmm"}


def small_grads_card_cpu(torch, P, cost, samples, feeding):
    """One step's f32 cost and gradients of `cost` on the card and on the
    CPU from the same parameters: (card, CPU) pairs of (cost, {name:
    gradient})."""
    from paddle_tpu_torch.core.device import tree_to
    from paddle_tpu_torch.reader.feeder import DataFeeder

    net = P.CompiledNetwork(P.Topology(cost), compute_dtype="float32")
    cpu_params = net.init_params(71, device="cpu")
    out = []
    for dev in (torch.device("cuda"), torch.device("cpu")):
        batch = DataFeeder(net.topology.data_types(), feeding, device=dev)(samples)
        out.append(grads_of(torch, net, tree_to(cpu_params, dev), batch))
    return out


def phase_text_lstm(torch, P, fa, card):
    """Phase 14: LSTM text classification at bench_lstm_textcls's width
    through SGD.train and paddle.infer, its profile, the early exit on a
    ragged batch and one step's f32 gradients card vs CPU."""
    from paddle_tpu_torch.ops.rnn import counters as cores
    from paddle_tpu_torch.utils.tree import leaves

    feeding = {"word": 0, "label": 1}
    P.init(seed=81, compute_dtype="bfloat16")
    cost, probs = text_lstm_cost(P, TXT_VOCAB, TXT_EMB, TXT_HIDDEN, TXT_LAYERS)
    params = P.parameters.create(cost, seed=81)
    trainer = P.trainer.SGD(cost, params, P.optimizer.Adam(learning_rate=TXT_LR))
    rng = np.random.RandomState(0)
    reviews = text_reviews(rng, TXT_B * (1 + TXT_TIMED + TXT_PROFILED), TXT_VOCAB, False)
    batches = [reviews[i * TXT_B:(i + 1) * TXT_B] for i in range(1 + TXT_TIMED + TXT_PROFILED)]
    say(f"text lstm: {sum(v.numel() for v in leaves(params.params))} parameters; batches of "
        f"{TXT_B} reviews x {TXT_T} tokens, bf16 over f32 masters, Adam({TXT_LR})")

    def train(batch_list, on_event=None):
        trainer.train(lambda: iter(batch_list), feeding=feeding, event_handler=on_event)

    reset_counts(fa)
    train(batches[:1])  # first step: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cores.clear()
    steps, clock = [], [0.0]

    def on_event(e):
        if isinstance(e, P.event.BeginIteration):
            torch.cuda.synchronize()
            clock[0] = time.perf_counter()
        elif isinstance(e, P.event.EndIteration):
            # the cost's host copy waits for the whole step, update included
            steps.append((time.perf_counter() - clock[0], e.cost))

    train(batches[1:1 + TXT_TIMED], on_event)
    secs, costs = [s[0] for s in steps], [s[1] for s in steps]
    mean_s = float(np.mean(secs))
    say(f"text lstm: {len(steps)} timed steps: costs {[round(c, 4) for c in costs]}, seconds per "
        f"step {[round(x, 4) for x in secs]}; {mean_s:.4f} s per step, {TXT_B / mean_s:.1f} "
        f"reviews/s, {TXT_B * TXT_T / mean_s:.1f} tokens/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    say(f"text lstm: LSTM steps run/skipped over the timed steps {cores['lstm_steps']}/"
        f"{cores['lstm_skipped']} ({TXT_LAYERS} layers x {TXT_T} steps x {TXT_TIMED})")
    if len(steps) != TXT_TIMED or not all(np.isfinite(costs)):
        raise SystemExit("text lstm: training gave a non-finite cost or a missing step")
    if cores["lstm_steps"] != TXT_LAYERS * TXT_T * TXT_TIMED:
        raise SystemExit("text lstm: the LSTM cores did not run every timestep")

    fixed = []
    trainer.train(lambda: iter([batches[1]] * TXT_FIXED), feeding=feeding,
                  event_handler=lambda e: fixed.append(e.cost)
                  if isinstance(e, P.event.EndIteration) else None)
    say(f"text lstm: {TXT_FIXED} steps on one batch: costs {[round(c, 4) for c in fixed]}")
    if not (np.isfinite(fixed).all() and fixed[-1] < fixed[0]):
        raise SystemExit("text lstm: the cost did not fall over repeated steps on one batch")

    wall, busy, kernels, top = profile_call(torch, lambda: train(batches[1 + TXT_TIMED:]))
    kernels /= TXT_PROFILED
    addmm = addmm_counts(lambda: train(batches[1:2]))
    h, g = TXT_HIDDEN, 4 * TXT_HIDDEN
    fwd_chain = addmm.get(str([[TXT_B, g], [TXT_B, h], [h, g]]), 0)
    bwd_chain = addmm.get(str([[TXT_B, h], [TXT_B, g], [g, h]]), 0)
    say(f"text lstm profile: {TXT_PROFILED} steps in {wall:.4f} s (profiler on), device busy "
        f"{busy:.4f} s ({busy / wall:.3f} of the window; {busy / TXT_PROFILED / mean_s:.3f} of a "
        f"timed step), {kernels:.0f} device kernels per step, {kernels / TXT_T:.1f} per "
        f"timestep (both layers, forward and backward); chain GEMMs in one step: forward "
        f"{fwd_chain}, backward {bwd_chain} (expected {TXT_LAYERS * TXT_T} each) on {card}; top "
        f"device kernels over the {TXT_PROFILED} steps:")
    for line in top:
        say(f"  {line}")
    if fwd_chain != TXT_LAYERS * TXT_T or bwd_chain != TXT_LAYERS * TXT_T:
        raise SystemExit(f"text lstm: chain GEMMs per step {fwd_chain}/{bwd_chain}, not "
                         f"{TXT_LAYERS * TXT_T} each")

    # the early exit on a ragged batch of bench.py's variable-length corpus
    ragged = text_reviews(np.random.RandomState(1), TXT_SERVE, TXT_VOCAB, True)
    cores.clear()
    train([ragged[:TXT_B]])
    longest = max(len(r[0]) for r in ragged[:TXT_B])
    say(f"text lstm: ragged batch (lengths {min(len(r[0]) for r in ragged[:TXT_B])}-{longest}, "
        f"mean {np.mean([len(r[0]) for r in ragged[:TXT_B]]):.1f}): LSTM steps run/skipped "
        f"{cores['lstm_steps']}/{cores['lstm_skipped']}")
    if cores["lstm_steps"] != TXT_LAYERS * longest:
        raise SystemExit("text lstm: the early exit did not run exactly the live steps")

    t0 = time.perf_counter()
    out = P.infer(probs, trainer.parameters, [(r[0],) for r in ragged], batch_size=TXT_B)
    wall = time.perf_counter() - t0
    sums = out.sum(axis=1)
    say(f"text lstm infer: {TXT_SERVE} ragged reviews in batches of {TXT_B}, bf16, in "
        f"{wall:.4f} s ({TXT_SERVE / wall:.1f} reviews/s) on {card}; row sums in "
        f"[{sums.min():.6f}, {sums.max():.6f}]")
    if out.shape != (TXT_SERVE, 2) or not np.isfinite(out).all() or np.abs(sums - 1).max() > 1e-2:
        raise SystemExit("text lstm infer: a distribution is not finite or does not sum to 1")
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("text lstm: the LSTM path launched a flash kernel")
    del trainer, params
    torch.cuda.empty_cache()

    # one step's f32 gradients at a small width, card vs CPU
    vocab, width, rows = TXT_SMALL
    P.init(seed=83, compute_dtype="float32")
    samples = text_reviews(np.random.RandomState(2), rows, vocab, True)
    samples = [(s[0][: 5 + 7 * i], s[1]) for i, s in enumerate(samples)]

    def small_net(kind):
        L = P.layer
        emb = L.embedding(L.data("word", P.data_type.integer_value_sequence(vocab)), size=width)
        if kind == "lstm_group":
            proj = L.fc(emb, size=4 * width, act=P.activation.Identity(), bias_attr=False)
            seq = P.networks.lstmemory_group(proj, size=width)
        else:
            seq = P.networks.simple_lstm(emb, width, reverse=kind == "reverse")
        probs_ = L.fc(L.last_seq(seq), size=2, act=P.activation.Softmax())
        return L.classification_cost(input=probs_,
                                     label=L.data("label", P.data_type.integer_value(2)))

    for kind in ("lstm", "reverse", "lstm_group"):
        (c_card, g_card), (c_cpu, g_cpu) = small_grads_card_cpu(
            torch, P, small_net(kind), samples, feeding)
        err = rel_l2(torch, g_card, g_cpu)
        say(f"text lstm f32 {kind} at vocab {vocab}, width {width}, {rows} rows (lengths "
            f"{[len(s[0]) for s in samples]}): cost card {c_card:.7f} CPU {c_cpu:.7f}; gradients "
            f"relative L2 over {len(g_cpu)} leaves {err:.3e} (<= {TXT_GRAD_REL})")
        if (set(g_card) != set(g_cpu) or abs(c_card - c_cpu) > TXT_GRAD_REL * abs(c_cpu)
                or not err <= TXT_GRAD_REL):
            raise SystemExit(f"text lstm: the card's {kind} gradients stray from the CPU's")
    P.init(compute_dtype="bfloat16")
    return {"s_per_step": mean_s}


def phase_tagger(torch, P, fa, card):
    """Phase 15: the CRF tagger (ner_crf_cost) trained through SGD.train with
    chunk_evaluator, decoded through paddle.infer(field='id'); its profile;
    crf costs, gradients and paths card vs CPU."""
    from paddle_tpu_torch.evaluator import chunk_evaluator
    from paddle_tpu_torch.models.sequence_tagging import ner_crf_cost, synthetic_tag_reader

    P.init(seed=91, compute_dtype="float32")
    cost, decode = ner_crf_cost(TAG_VOCAB, TAG_LABELS, sparse_update=True)
    label = cost.parents[1]
    trainer = P.trainer.SGD(
        cost, P.parameters.create(cost, seed=91), P.optimizer.Adam(learning_rate=TAG_LR),
        extra_layers=[decode], evaluators=[chunk_evaluator(decode, label, "IOB", TAG_TYPES,
                                                           name="chunk")])
    corpus = list(synthetic_tag_reader(TAG_VOCAB, TAG_LABELS, n=TAG_B * TAG_STEPS, seed=0)())
    reset_counts(fa)
    steps, clock = [], [0.0]

    def on_event(e):
        if isinstance(e, P.event.BeginIteration):
            torch.cuda.synchronize()
            clock[0] = time.perf_counter()
        elif isinstance(e, P.event.EndIteration):
            steps.append((time.perf_counter() - clock[0], e.cost, e.evaluator["chunk.F1"]))

    trainer.train(P.batch(lambda: iter(corpus), TAG_B), event_handler=on_event)
    secs = [s[0] for s in steps[1:]]  # the first step builds cuBLAS handles
    costs = [s[1] for s in steps]
    tokens = sum(len(w) for w, _ in corpus[TAG_B:])
    first, last = float(np.mean(costs[:4])), float(np.mean(costs[-4:]))
    say(f"tagger: {len(steps)} steps of {TAG_B} sentences (vocab {TAG_VOCAB}, {TAG_LABELS} "
        f"labels, f32, Adam({TAG_LR})): mean cost of the first 4 {first:.4f}, of the last 4 "
        f"{last:.4f}; {float(np.mean(secs)):.4f} s per step after the first, "
        f"{tokens / sum(secs):.1f} tokens/s; chunk F1 of the first and last step "
        f"{steps[0][2]:.4f}, {steps[-1][2]:.4f} on {card}")
    if not (np.isfinite(costs).all() and last < 0.5 * first):
        raise SystemExit("tagger: the mean of the last 4 costs is not under half the first 4's")

    wall, busy, kernels, top = profile_call(
        torch, lambda: trainer.train(P.batch(lambda: iter(corpus[:2 * TAG_B]), TAG_B)))
    say(f"tagger profile: 2 steps in {wall:.4f} s (profiler on), device busy {busy:.4f} s "
        f"({busy / wall:.3f} of the window; {busy / 2 / float(np.mean(secs)):.3f} of a timed "
        f"step), {kernels / 2:.0f} device kernels per step on {card}; top device kernels over "
        "the 2 steps:")
    for line in top:
        say(f"  {line}")

    fresh = list(synthetic_tag_reader(TAG_VOCAB, TAG_LABELS, n=TAG_B, seed=11)())
    t0 = time.perf_counter()
    ids = P.infer(output_layer=decode, parameters=trainer.parameters,
                  input=[(w,) for w, _ in fresh], field="id")
    wall = time.perf_counter() - t0
    want = np.concatenate([np.asarray(w) % TAG_LABELS for w, _ in fresh])
    acc = float((ids == want).mean()) if ids.shape == want.shape else 0.0
    say(f"tagger infer: {TAG_B} fresh sentences decoded by paddle.infer(field='id') in "
        f"{wall:.4f} s on {card}: {ids.shape[0]} tags, accuracy {acc:.4f} (> {TAG_ACC})")
    if not acc > TAG_ACC:
        raise SystemExit("tagger: the decoded tag accuracy is not above 0.9")
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("tagger: the tagger's path launched a flash kernel")
    del trainer
    torch.cuda.empty_cache()

    # crf costs, gradients and paths in f32, card vs CPU, on ragged rows
    # with a length-1 sentence, and a constructed Viterbi tie
    from paddle_tpu_torch.core.device import tree_to
    from paddle_tpu_torch.reader.feeder import DataFeeder

    P.init(seed=93, compute_dtype="float32")
    small_cost, small_decode = ner_crf_cost(512, TAG_LABELS)
    rows = list(synthetic_tag_reader(512, TAG_LABELS, n=8, seed=3)())
    rows[1] = (rows[1][0][:1], rows[1][1][:1])
    (c_card, g_card), (c_cpu, g_cpu) = small_grads_card_cpu(torch, P, small_cost, rows, None)
    err = rel_l2(torch, g_card, g_cpu)
    say(f"tagger f32 at vocab 512, 8 rows (lengths {[len(r[0]) for r in rows]}): crf cost card "
        f"{c_card:.7f} CPU {c_cpu:.7f}; gradients relative L2 over {len(g_cpu)} leaves "
        f"{err:.3e} (<= {TAG_GRAD_REL})")
    if abs(c_card - c_cpu) > TAG_GRAD_REL * abs(c_cpu) or not err <= TAG_GRAD_REL:
        raise SystemExit("tagger: the card's crf cost or gradients stray from the CPU's")
    net = P.CompiledNetwork(P.Topology([small_cost, small_decode]), compute_dtype="float32")
    cpu_params = net.init_params(95, device="cpu")
    tied = {k: dict(v) for k, v in cpu_params.items()}
    tied["crf_cost"]["w"] = torch.zeros_like(tied["crf_cost"]["w"])
    tied["crf_input"]["w0"] = torch.zeros_like(tied["crf_input"]["w0"])
    tied["crf_input"]["b"] = torch.zeros_like(tied["crf_input"]["b"]).index_fill_(
        0, torch.tensor([3, 7, 19]), 2.0)  # labels 3, 7 and 19 tie at every step
    paths = {}
    for name, tree in (("random", cpu_params), ("tie", tied)):
        for where, dev in (("card", torch.device("cuda")), ("CPU", torch.device("cpu"))):
            batch = DataFeeder(net.topology.data_types(), None, device=dev)(rows)
            with torch.inference_mode():
                outs, _ = net.apply(tree_to(tree, dev), batch, train=False)
            paths[name, where] = outs[small_decode.name].data.cpu()
        same = torch.equal(paths[name, "card"], paths[name, "CPU"])
        say(f"tagger crf_decoding {name}: card paths equal the CPU's: {same}")
        if not same:
            raise SystemExit(f"tagger: the card's Viterbi paths ({name}) differ from the CPU's")
    lengths = [len(r[0]) for r in rows]
    tie_rows = [paths["tie", "card"][i, :n].tolist() for i, n in enumerate(lengths)]
    if any(set(r) != {3} for r in tie_rows):
        raise SystemExit(f"tagger: the tie did not take the first maximum: {tie_rows}")
    P.init(compute_dtype="bfloat16")
    return {"s_per_step": float(np.mean(secs))}


# phase 16: bench_lstm_textcls as bench.py runs it, through the port's v1
# front end: a v1 config (the network of bench.py:2013-2020, widths through
# get_config_arg) and a @provider over a pickle in the rnn benchmark's
# schema, (token lists, labels)
V1_CONFIG = """
from paddle.trainer_config_helpers import *

vocab = get_config_arg("vocab", int, 30000)
hidden_size = get_config_arg("hidden_size", int, 128)
lstm_num = get_config_arg("lstm_num", int, 1)
batch_size = get_config_arg("batch_size", int, 128)
settings(batch_size=batch_size, learning_rate=5e-4, learning_method=AdamOptimizer())
define_py_data_sources2("train.list", None, module="provider", obj="process",
                        args={"vocab": vocab})
net = data_layer("data", vocab)
net = embedding_layer(input=net, size=128)
for i in range(lstm_num):
    net = simple_lstm(input=net, size=hidden_size)
net = last_seq(input=net)
net = fc_layer(input=net, size=2, act=SoftmaxActivation())
lab = data_layer("label", 2)
outputs(classification_cost(input=net, label=lab))
"""
V1_PROVIDER = """
import pickle
from paddle.trainer.PyDataProvider2 import *

@provider(input_types=[integer_value_sequence(30000), integer_value(2)], should_shuffle=False)
def process(settings, path, vocab=30000):
    with open(path, "rb") as f:
        x, y = pickle.load(f)
    for ids, label in zip(x, y):
        yield [int(t) % vocab for t in ids], int(label)
"""
V1_ARGS = "hidden_size=512,lstm_num=2,batch_size=128"
V1_REVIEWS = 512
V1_BUDGET = 12800  # bucketing_token_budget of the ragged corpus
V1_PRUNE = (2048, 512, 0.75, 5)  # fc in, out, sparsity ratio, steps
V1_TURNS = 4  # rounds of the in-turns v1 / v2 comparison


def v1_stage(d, name, reviews):
    """Write the reviews as the rnn benchmark's pickle `name` and point
    train.list at it."""
    import pickle

    with open(os.path.join(d, name), "wb") as f:
        pickle.dump(([r[0] for r in reviews], [r[1] for r in reviews]), f, protocol=2)
    with open(os.path.join(d, "train.list"), "w") as f:
        f.write(os.path.join(d, name) + "\n")


def phase_v1(torch, P, fa, card, lstm14):
    """Phase 16: bench_lstm_textcls through the v1 front end at full width
    (parse_config -> make_optimizer -> make_provider_reader -> DataFeeder ->
    SGD.train), token-budget bucketing through make_batched_reader, card
    against CPU for the v1-parsed network, a nested batch and a sparse slot,
    and the pruning hook."""
    import shutil
    import tempfile

    from paddle_tpu_torch import v1_compat
    from paddle_tpu_torch.core.batch import ladder_len
    from paddle_tpu_torch.ops.rnn import counters as cores
    from paddle_tpu_torch.reader import feeder as feeder_mod
    from paddle_tpu_torch.utils.tree import leaves

    d = tempfile.mkdtemp(prefix="v1_textcls_")
    try:
        with open(os.path.join(d, "textcls.py"), "w") as f:
            f.write(V1_CONFIG)
        with open(os.path.join(d, "provider.py"), "w") as f:
            f.write(V1_PROVIDER)
        v1_stage(d, "reviews.pkl", text_reviews(np.random.RandomState(0), V1_REVIEWS, TXT_VOCAB,
                                                False))
        reset_counts(fa)
        # the reference's init arguments: use_gpu=False does not move the port
        # off the card
        P.init(seed=91, compute_dtype="bfloat16", use_gpu=False, trainer_count=1)
        from paddle_tpu_torch.core.device import resolve_device

        if resolve_device(None).type != "cuda":
            raise SystemExit("v1: init(use_gpu=False) moved the port off the card")
        parsed = v1_compat.parse_config(os.path.join(d, "textcls.py"), V1_ARGS)
        st = parsed.settings
        opt = v1_compat.make_optimizer(st)
        types = parsed.topology.data_types()
        say(f"v1: parse_config(textcls.py, {V1_ARGS!r}): {len(parsed.topology.layers)} layers, "
            f"outputs {parsed.output_layers}, slots {[(n, t.kind.value, t.seq.name, t.dim) for n, t in types]}, "
            f"batch_size {st.batch_size}, {type(opt).__name__}({st.learning_rate})")
        if st.batch_size != TXT_B or type(opt).__name__ != "Adam" or st.learning_rate != TXT_LR:
            raise SystemExit("v1: the settings did not parse as written")
        reader = v1_compat.make_provider_reader(parsed, d)
        first = list(P.reader.firstn(reader, TXT_B)())
        fed = P.reader.DataFeeder(types, parsed.feeding)(first)
        say(f"v1: DataFeeder(p.topology.data_types()) on the first {TXT_B} reviews: "
            f"{ {k: (tuple(v.data.shape), str(v.data.device)) for k, v in fed.items()} }")
        params = P.parameters.create(parsed.topology.outputs, seed=91)
        trainer = P.trainer.SGD(parsed.topology, params, opt)
        batched = P.batch(reader, st.batch_size)
        trainer.train(P.batch(P.reader.firstn(reader, TXT_B), TXT_B),
                      feeding=parsed.feeding)  # warm-up step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cores.clear()
        steps, clock = [], [0.0]

        def on_event(e):
            if isinstance(e, P.event.BeginIteration):
                torch.cuda.synchronize()
                clock[0] = time.perf_counter()
            elif isinstance(e, P.event.EndIteration):
                steps.append((time.perf_counter() - clock[0], e.cost))

        trainer.train(batched, feeding=parsed.feeding, event_handler=on_event)
        secs, costs = [s[0] for s in steps], [s[1] for s in steps]
        mean_s = float(np.mean(secs))
        n_timed = V1_REVIEWS // TXT_B
        say(f"v1 text lstm: {sum(v.numel() for v in leaves(params.params))} parameters; "
            f"{len(steps)} timed steps: costs {[round(c, 4) for c in costs]}, seconds per step "
            f"{[round(x, 4) for x in secs]}; {mean_s:.4f} s per step, {TXT_B / mean_s:.1f} "
            f"reviews/s, {TXT_B * TXT_T / mean_s:.1f} tokens/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}; phase 14 (the same "
            f"network through the v2 DSL): {lstm14['s_per_step']:.4f} s per step, "
            f"{TXT_B / lstm14['s_per_step']:.1f} reviews/s, "
            f"{TXT_B * TXT_T / lstm14['s_per_step']:.1f} tokens/s")
        say(f"v1 text lstm: LSTM steps run/skipped over the timed steps {cores['lstm_steps']}/"
            f"{cores['lstm_skipped']} ({TXT_LAYERS} layers x {TXT_T} steps x {n_timed})")
        if len(steps) != n_timed or not all(np.isfinite(costs)):
            raise SystemExit("v1: training gave a non-finite cost or a missing step")
        if cores["lstm_steps"] != TXT_LAYERS * TXT_T * n_timed:
            raise SystemExit("v1: the LSTM cores did not run every timestep")
        two = list(P.reader.firstn(batched, 2)())  # read before the window opens
        wall, busy, kernels, _ = profile_call(
            torch, lambda: trainer.train(lambda: iter(two), feeding=parsed.feeding))
        say(f"v1 text lstm profile: 2 steps in {wall:.4f} s (profiler on), device busy "
            f"{busy:.4f} s ({busy / wall:.3f} of the window), {kernels / 2:.0f} device kernels "
            f"per step")
        v1_against_v2(torch, P, trainer, parsed.feeding, two)
        del trainer, params
        torch.cuda.empty_cache()

        # token-budget bucketing over a ragged corpus through make_batched_reader
        ragged = text_reviews(np.random.RandomState(3), V1_REVIEWS, TXT_VOCAB, True)
        v1_stage(d, "ragged.pkl", ragged)
        saved = {k: P.flags.get_flag(k) for k in ("use_bucketing", "bucketing_token_budget")}
        P.flags.set_flag("use_bucketing", True)
        P.flags.set_flag("bucketing_token_budget", V1_BUDGET)
        try:
            buckets = list(v1_compat.make_batched_reader(parsed, d, st.batch_size)())
        finally:
            for k, v in saved.items():
                P.flags.set_flag(k, v)
        rungs, valid, padded, worst = {}, 0, 0, 0
        for b in buckets:
            rung = ladder_len(max(8, max(len(s[0]) for s in b)))
            rungs[rung] = rungs.get(rung, 0) + 1
            valid += sum(len(s[0]) for s in b)
            padded += rung * len(b)
            worst = max(worst, rung * len(b))
        say(f"v1 bucketing (budget {V1_BUDGET} tokens, {V1_REVIEWS} reviews of 10-100 tokens "
            f"drawn beta(2, 3)): {len(buckets)} batches, {{rung: batches}} {dict(sorted(rungs.items()))}, "
            f"largest padded batch {worst} tokens, valid share {valid / padded:.4f}")
        if sum(len(b) for b in buckets) != V1_REVIEWS or worst > V1_BUDGET:
            raise SystemExit("v1: a bucketed batch padded past the token budget or lost a review")

        # card against CPU in f32 at a small width
        vocab, width, rows = TXT_SMALL
        P.init(seed=93, compute_dtype="float32")
        small = v1_compat.parse_config(os.path.join(d, "textcls.py"),
                                       f"vocab={vocab},hidden_size={width},lstm_num=2,batch_size={rows}")
        samples = text_reviews(np.random.RandomState(2), rows, vocab, True)
        samples = [(s[0][: 5 + 7 * i], s[1]) for i, s in enumerate(samples)]
        net = P.CompiledNetwork(small.topology, compute_dtype="float32")
        from paddle_tpu_torch.core.device import tree_to

        cpu_params = net.init_params(95, device="cpu")
        got = []
        for dev in (torch.device("cuda"), torch.device("cpu")):
            batch = P.reader.DataFeeder(small.topology.data_types(), small.feeding,
                                        device=dev)(samples)
            got.append(grads_of(torch, net, tree_to(cpu_params, dev), batch))
        (c_card, g_card), (c_cpu, g_cpu) = got
        err = rel_l2(torch, g_card, g_cpu)
        say(f"v1 f32 at vocab {vocab}, width {width}, {rows} rows (lengths "
            f"{[len(s[0]) for s in samples]}): cost card {c_card:.7f} CPU {c_cpu:.7f}; gradients "
            f"relative L2 over {len(g_cpu)} leaves {err:.3e} (<= {TXT_GRAD_REL})")
        if (set(g_card) != set(g_cpu) or abs(c_card - c_cpu) > TXT_GRAD_REL * abs(c_cpu)
                or not err <= TXT_GRAD_REL):
            raise SystemExit("v1: the card's gradients of the v1-parsed network stray from the CPU's")
        phase_v1_nested_sparse(torch, P, feeder_mod, vocab, width)
        phase_v1_prune(torch, P, card)
        if launch_counts(fa) != (0, 0, 0):
            raise SystemExit("v1: the v1 path launched a flash kernel")
        P.init(compute_dtype="bfloat16")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def v1_against_v2(torch, P, trainer, feeding, batches, rounds=V1_TURNS):
    """Seconds per step of the v1-parsed trainer and of phase 14's network
    built through the v2 DSL, in turns (v2, v1, v1, v2, then v1 first) on
    the same batches: the host's clock drifts between phases, so only steps
    taken in turns compare."""
    cost, _ = text_lstm_cost(P, TXT_VOCAB, TXT_EMB, TXT_HIDDEN, TXT_LAYERS)
    v2 = P.trainer.SGD(cost, P.parameters.create(cost, seed=91),
                       P.optimizer.Adam(learning_rate=TXT_LR))
    runs = {"v2": (v2, {"word": 0, "label": 1}), "v1": (trainer, feeding)}

    def step(name, batch):
        t, feed = runs[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train(lambda: iter([batch]), feeding=feed)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    step("v2", batches[0])  # v2's first step: allocator, handles
    times = {"v2": [], "v1": []}
    for r in range(rounds):
        order = ("v2", "v1", "v1", "v2") if r % 2 == 0 else ("v1", "v2", "v2", "v1")
        for i, name in enumerate(order):
            times[name].append(step(name, batches[(r + i) % len(batches)]))
    med = {k: float(np.median(v)) for k, v in times.items()}
    say(f"v1 against the v2 DSL in turns ({rounds} rounds, {len(times['v1'])} steps each, same "
        f"batches): median s per step v1 {med['v1']:.4f} v2 {med['v2']:.4f} (v1/v2 "
        f"{med['v1'] / med['v2']:.3f}); v1 {[round(x, 4) for x in times['v1']]}, v2 "
        f"{[round(x, 4) for x in times['v2']]}")
    del v2, runs


def _card_cpu(torch, P, out, feed, seed):
    """f32 outputs and gradients (of the sum of squares of the valid
    outputs) of `out`'s network on the card and on the CPU from the same
    parameters and samples: ((card out, grads), (CPU out, grads))."""
    from paddle_tpu_torch.core.device import tree_to
    from paddle_tpu_torch.utils.tree import leaf_paths, map_leaves

    net = P.CompiledNetwork(P.Topology(out), compute_dtype="float32")
    cpu_params = net.init_params(seed, device="cpu")
    res = []
    for dev in (torch.device("cuda"), torch.device("cpu")):
        batch = feed(dev)
        leaves_ = map_leaves(lambda v: v.detach().requires_grad_(True), tree_to(cpu_params, dev))
        outs, _ = net.apply(leaves_, batch, train=True)
        y = outs[out.name].masked_data()
        paths = list(leaf_paths(leaves_))
        gs = torch.autograd.grad((y.float() ** 2).sum(), [v for _, v in paths])
        res.append((y.detach().cpu(), {".".join(p): g for (p, _), g in zip(paths, gs)}, batch))
    return res


def phase_v1_nested_sparse(torch, P, feeder_mod, vocab, width):
    """A nested batch through the feeder, embedding, fc and mixed, and a
    sparse_binary slot through fc's multi-hot product and its gather-sum,
    card against CPU in f32."""
    L, dt, A = P.layer, P.data_type, P.activation
    rng = np.random.RandomState(5)
    paras = [([[int(t) for t in rng.randint(0, vocab, size=rng.randint(2, 13))]
               for _ in range(rng.randint(1, 6))],) for _ in range(4)]
    words = L.data("para", dt.integer_value_sub_sequence(vocab))
    h = L.fc(L.embedding(words, size=width), size=width, act=A.Tanh())
    out = L.mixed(size=width, input=[L.full_matrix_projection(h), L.identity_projection(h)],
                  act=A.Tanh())

    def feed(dev):
        return P.reader.DataFeeder([("para", dt.integer_value_sub_sequence(vocab))],
                                   device=dev)(paras)

    (y_card, g_card, b_card), (y_cpu, g_cpu, b_cpu) = _card_cpu(torch, P, out, feed, 97)
    same = all(torch.equal(getattr(b_card["para"], k).cpu(), getattr(b_cpu["para"], k))
               for k in ("data", "lengths", "sub_lengths"))
    err_y = rel_l2(torch, {"y": y_card}, {"y": y_cpu})
    err_g = rel_l2(torch, g_card, g_cpu)
    say(f"v1 nested: 4 paragraphs of {[len(p[0]) for p in paras]} sentences of 2-12 ids, fed "
        f"{tuple(b_card['para'].data.shape)} with sub-lengths "
        f"{b_card['para'].sub_lengths.cpu().tolist()}; feeder tensors card == CPU: {same}; "
        f"fc + mixed output relative L2 {err_y:.3e}, gradients {err_g:.3e} (<= {TXT_GRAD_REL})")
    if not (same and err_y <= TXT_GRAD_REL and err_g <= TXT_GRAD_REL and y_card.dim() == 4):
        raise SystemExit("v1: the nested batch strays between the card and the CPU")

    docs = [(sorted(rng.choice(vocab, size=rng.randint(3, 20), replace=False).tolist()),)
            for _ in range(16)]
    sparse = L.data("doc", dt.sparse_binary_vector(vocab))
    sfc = L.fc(sparse, size=width, act=A.Tanh())
    outs = {}
    saved = feeder_mod.SPARSE_IDS_THRESHOLD
    for form, threshold in (("multi-hot", saved), ("padded ids", vocab // 2)):
        feeder_mod.SPARSE_IDS_THRESHOLD = threshold
        try:
            def feed_s(dev):
                return P.reader.DataFeeder([("doc", dt.sparse_binary_vector(vocab))],
                                           device=dev)(docs)

            outs[form] = _card_cpu(torch, P, sfc, feed_s, 99)
        finally:
            feeder_mod.SPARSE_IDS_THRESHOLD = saved
    for form, ((y_card, g_card, b_card), (y_cpu, g_cpu, _)) in outs.items():
        err_y = rel_l2(torch, {"y": y_card}, {"y": y_cpu})
        err_g = rel_l2(torch, g_card, g_cpu)
        say(f"v1 sparse_binary_vector({vocab}) through fc({width}), {form} "
            f"{tuple(b_card['doc'].data.shape)}: output relative L2 card vs CPU {err_y:.3e}, "
            f"gradients {err_g:.3e} (<= {TXT_GRAD_REL})")
        if not (err_y <= TXT_GRAD_REL and err_g <= TXT_GRAD_REL):
            raise SystemExit(f"v1: the sparse slot's {form} path strays between card and CPU")
    forms = rel_l2(torch, {"y": outs["padded ids"][0][0]}, {"y": outs["multi-hot"][0][0]})
    say(f"v1 sparse: gather-sum against the multi-hot product on the card: relative L2 {forms:.3e}")
    if not outs["padded ids"][0][2]["doc"].sparse_ids or forms > TXT_GRAD_REL:
        raise SystemExit("v1: the gather-sum path did not run or disagrees with the product")


def phase_v1_prune(torch, P, card):
    """The pruning hook on the card: after the steps, exactly the ratio of
    w0 is zero, at the smallest initial magnitudes."""
    n_in, n_out, ratio, n_steps = V1_PRUNE
    L, dt, A = P.layer, P.data_type, P.activation
    x = L.data("x", dt.dense_vector(n_in))
    h = L.fc(x, size=n_out, act=A.Tanh(), name="pruned",
             param_attr=P.attr.ParamAttr(update_hooks=P.attr.HookAttr("pruning", ratio)))
    cost = L.classification_cost(input=L.fc(h, size=2, act=A.Softmax()),
                                 label=L.data("y", dt.integer_value(2)))
    params = P.parameters.create(cost, seed=101)
    w_init = params.params["pruned"]["w0"].detach().clone()
    trainer = P.trainer.SGD(cost, params, P.optimizer.Momentum(learning_rate=0.01, momentum=0.9))
    rng = np.random.RandomState(7)
    data = [(rng.randn(n_in).astype(np.float32), int(rng.randint(0, 2))) for _ in range(64 * n_steps)]
    trainer.train(P.batch(lambda: iter(data), 64), feeding={"x": 0, "y": 1})
    w = trainer.parameters.params["pruned"]["w0"]
    k = int(w.numel() * (1 - ratio))
    keep = torch.zeros(w.numel(), dtype=torch.bool, device=w.device)
    keep[torch.topk(w_init.abs().reshape(-1), k).indices] = True
    zero = (w == 0).reshape(-1)
    say(f"v1 pruning: fc({n_in} -> {n_out}) with HookAttr('pruning', {ratio}) after {n_steps} "
        f"steps on {card}: zero share {zero.float().mean().item():.6f}, zeros at the smallest "
        f"initial magnitudes: {bool(torch.equal(zero, ~keep))}")
    if zero.float().mean().item() != ratio or not torch.equal(zero, ~keep):
        raise SystemExit("v1: the pruning hook did not hold on the card")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import paddle_tpu_torch as P
        from paddle_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2

    start = time.perf_counter()
    card = card_line()
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    say("tf32 off for matmul and cudnn; bf16 reduced-precision reductions off")
    report, secs = build_with_report(fa)
    say(f"build: {', '.join(os.path.basename(x) for x in fa.SOURCES)} in {secs:.2f} s")
    for name, regs, st, ld in report:
        say(f"ptxas: {name}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    if not report:
        say("ptxas: the library was built before this run; no report")

    rows = {"fwd": phase_kernel(torch, fa)}
    phase_slice(torch, P, fa, card)
    rows.update(phase_bwd_kernel(torch, fa))
    phase_bar_sweep(torch, fa)
    phase_edges(torch, fa)
    launches, trainer, phase5_s = phase_train(torch, P, fa, card)
    phase_profile(torch, P, trainer)
    del trainer
    # the ResNet path runs no flash kernel: its counts stay 0 over phases 8, 7, 9
    reset_counts(fa)
    t0 = time.perf_counter()
    rn_trainer, rn_probs = phase_resnet_train(torch, P, card)
    phase_resnet_infer(torch, P, rn_probs, rn_trainer, card)
    phase_resnet_profile(torch, P, rn_trainer)
    say(f"resnet: phases 8, 7, 9 took {time.perf_counter() - t0:.1f} s; flash launches "
        f"(fwd, dq, dkv) over them: {launch_counts(fa)}")
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("the ResNet path launched a flash kernel")
    trainer_dev = rn_trainer.device
    del rn_trainer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spine_params = phase_spine(torch, P, fa, card, phase5_s)
    phase_optimizers(torch, P, spine_params, trainer_dev)
    del spine_params
    phase_dropout_clip(torch, P, trainer_dev)
    say(f"spine: phases 10, 10b, 10c took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_nmt(torch, P, fa, card)
    say(f"nmt: phase 11 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_generate(torch, P, fa, card)
    say(f"generate: phase 12 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_serve(torch, P, fa, card)
    say(f"serve: phase 13 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lstm14 = phase_text_lstm(torch, P, fa, card)
    say(f"text lstm: phase 14 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_tagger(torch, P, fa, card)
    say(f"tagger: phase 15 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_v1(torch, P, fa, card, lstm14)
    say(f"v1: phase 16 took {time.perf_counter() - t0:.1f} s")
    kernels = [
        {"name": name, "route": "cuda", "source": f"paddle_tpu_torch/csrc/{src}",
         "replaces": f"paddle_tpu/ops/pallas_attention.py:{line}",
         "launches": launches[kn],
         **{key: rows[kn][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for kn, name, src, line in (
            ("fwd", "flash_attention_fwd", "flash_attention_fwd.cu", 82),
            ("dq", "flash_attention_bwd_dq", "flash_attention_bwd.cu", 133),
            ("dkv", "flash_attention_bwd_dkv", "flash_attention_bwd.cu", 173),
        )
    ]
    say(f"chip_smoke: all phases in {time.perf_counter() - start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
