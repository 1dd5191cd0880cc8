#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH] [--baseline PATH]

Phases:
  1. build the CUDA kernels under mi_optimize_tpu_torch/csrc/ with nvcc
     (one nvcc per source, all at once) into build/torch_kernels/, and
     report ptxas's registers and spills of every batch_kernel,
     model_flat_kernel, model_flat_seg_kernel and mega4_kernel instance,
     of gemv16_kernel and of
     the fused MLP's tensor-core kernels from the build's own -Xptxas -v
     log, of every paged_split_kernel instance (the paged flash decode)
     and of every decode_split_kernel instance (the decode attention), of
     every tp_kernel instance (the batched kernel's mode (e)) and of the
     ring dequant matmul's ring_gemv_kernel, ring_mma_kernel and
     ring_chunk_kernel instances;
  2. hold each kernel against its plain PyTorch version on the card at the
     Llama-2-7B shapes of the paths below in bf16, and time both: the
     dequant matmul (the gemv16 kernel at M = 1, the tensor-core mma kernel
     at M = 128 and 2048, each also timed against the CUDA-core kernel on
     the same operands, which keeps the f32 inputs: M = 1 and 128 in f32),
     the per-layer decode kernel on the route 4-bit words take (the
     whole-model kernel's tensor-core layer loop at one layer: positions
     200 and 0, and 200 on a layer of the asymmetric grid, its bias tables
     streamed; the same bits on a second launch), the flat decode kernel
     (at position 200,
     at position 0 held by `hold_rows` over its first 2 layers and the
     lm_head, and on a planted 2-layer draft with its logits held to the
     off-peak scale; the same bits on a second launch), the whole-model
     kernel on an asymmetric grid (bias tables streamed; its 4-bit route,
     the tensor-core layer loop, at positions 200 and 0, the same bits on a
     second launch), the batched
     whole-model kernel at B = 8 (and B = 2 on the asymmetric grid, and B = 8
     with every slot at position 0: its GEMVs and barriers with next to no
     attention), in its
     paged mode on a pool that mirrors the B = 8 state (bitwise equal to the
     dense mode), in its chunk mode (8 tokens after a 256-row paged prefix;
     two slots of 4 tokens at prefixes 0 and 300), its terminal lm rows
     (mode d: C=5 after a 256-row prefix, dense and paged, and B = 8
     one-token rows; timed against the unfused route, the launch without
     them plus rms_norm and the dequant_matmul lm_head), the multi-token flat
     decode (kseg=5 after a 200-row history, on the 7B stack and on a planted
     2-layer draft; the same bits on a second launch and as 5
     model_decode_flat launches with the rows scattered between them; timed
     against 5 model_decode_flat launches), the
     paged flash decode of one layer (4 slots, pages of 16; one slot at
     its last row; a GQA group of 4; the same bits on a second launch), the decode
     attention of one layer (T=384 at pos 200, T=2048 at pos 2047, T=4096
     at pos 4095, and Mistral-7B's GQA groups of 4 at T=2048, pos 2047; new
     int8 rows and scales bit-equal, the same bits on a second launch,
     torch.sum over the same bytes beside it), the fused MLP (M = 1 on its "gemv"
     instance, 128 and 2048 on its "mma" instance, with the P1/P2 split of
     the latter's time from torch.profiler; also timed against the unfused
     route and against the first port's CUDA-core kernels on the same
     inputs) and the W4A8 integer product (M = 128:
     q, gate and down per group, gate per channel; M = 2048: q, down and the
     per-channel gate; bit-equal) on the unfused model; the whole-model
     kernels' gate (`hold_rows` in bf16 and f32 over the first 2 layers at
     full width; at full depth layer 0's rows, the scales and, in f32, the
     slots at positions >= 64);
     then the calibration rows (quant/, plain torch): one Llama-2-7B layer of
     bf16 fp weights from seed 0, Hessians from 16 x 512 tokens of the
     wikitext fixture; GPTQ int4 g128 affine with act-order on q_proj and
     down_proj on the card and on the CPU from the same H (`gptq_7b`: at
     least 99% of the codes equal, each row's first difference one code,
     scales within 1e-3 up to it; the card call again with TF32 allowed
     around it: the same codes), and RTN on the same weights (`rtn_7b`:
     words, scales and zeros bit-equal); on the same layer, from its 8192
     sampled tokens, absmean and absmax (the port's reducers) and its card
     Hessians, each on the card and on the CPU from the same inputs: AWQ
     int4 g128 on q_proj and down_proj (`awq_7b`: the ratio index equal or
     within 1e-4 of the CPU's minimum loss, at least 99% of the clip
     indices and of the codes equal, the same codes with TF32 allowed),
     SmoothQuant W8A8 on q_proj (`smoothquant_7b`: smooth scales within
     1e-6, 99.9% of the words equal, each within one), the W8A8 route at
     q_proj's and down_proj's shapes at M = 1, 128 and 2048 (`w8a8_7b`: its
     int32 sums equal to the plain version's on the card, outputs within
     1e-6; timed beside torch._int_mm alone and B1 on the RTN int4 linear of
     the same weights), FP8 E4M3 and E5M2 on q_proj (`fp8_7b`: native
     storage dequantized to the fake grid bit for bit, card == CPU), SpQR
     and QuIP on q_proj from the same H and the same U and V (`spqr_7b`,
     `quip_7b`: 99% of the codes equal, SpQR's outliers within 1%, QuIP's
     output error within 1%);
     the tensor-parallel kernels at Llama-2-7B's shard shapes over TP = 2
     ranks as threads of a LocalGroup: the batched kernel's mode (e)
     (csrc/model_fused_tp.cu, each rank 16 q heads, 16 kv heads, 5504 MLP
     columns, two launches a layer with the o_proj and down_proj partials
     summed between them; half 0's attention split over the live rows) on
     the dense B = 8 row's state, on the (b) row's pool (bitwise equal to
     the dense TP outputs) and with one slot at 510 and seven at 0, each rank
     held to its plain version over the first 2 layers by `hold_rows` and at
     full depth on layer 0's rows, x_out the same bits on both ranks, one
     rank's half-layer launch timed alone; and the overlapped ring dequant
     matmul (csrc/overlap.cu) on layer 0's o_proj at D = 2 and 4 and
     down_proj at D = 2, M = 8 (the split-K GEMV), 128 and 2048 (the tiled
     tensor-core product), every rank within RING_TOL of the plain version,
     one ring window timed alone beside the CUDA-core tiles;
  2b. the bf16 gate against three faults planted in the batched kernel's
     outputs (another slot's history, a row from position p - 1, a scale
     from amax / 128): it must reject each;
  3. serve the paths at Llama-2-7B width and depth (int4 g128 packed
     weights made on the card from seed 0, int8 KV cache), each with the
     launch counters set to 0 just before it and read just after:
     a. three requests through `generate` (per-layer decode kernel, every
        launch on its tensor-core route), then
        one 128-token prefill plus a 128-token `decode_loop_flat`
        (whole-model flat kernel);
     b. 24 requests through `ContinuousBatcher` (8 slots, max_len 512,
        prompts of 16-256 tokens, 32 or 64 new tokens: slots free at
        different steps and requests join mid-flight) on the batched
        whole-model kernel;
     c. a 128-token prefill plus 128 tokens of `decode_loop_model` on an
        asymmetric-grid model (the whole-model kernel's tensor-core layer
        loop with bias tables);
     d. the same 24 requests through `PagedMegaBatcher` (8 slots over a
        25-page pool, then 12 slots in waves of 8): the paged mode, tokens
        equal to the ContinuousBatcher's;
     e. 16 requests sharing a 256-token prefix plus one sampled twice,
        through `PagedMegaBatcher(prefix_cache=True)`: the hits' suffixes in
        the paged chunk mode;
     f. 8 requests through `PagedBatcher` (4 slots, f32 pool of 64 pages of
        16): the paged flash decode;
     g. a planted Llama-2-7B target (utils/planted.py: greedy decoding
        follows a fixed token map) with planted 2-layer drafts at 7B width
        through `speculative_generate`: k=4 (the flat draft, the chunk verify
        with its lm rows), k="auto" (it must reach k=8: the verify of 9 rows
        split in two launches), k=4 with a draft that disagrees on 30%; and
        decode_loop_flat on the same target for comparison;
     h-i. 12 planted requests (prompts 16-128, 32 new tokens) through a
        4-slot `SpeculativeBatcher` and `PagedSpeculativeBatcher`, k=3;
     j. 40 tokens of `decode_loop_flat_seg` (kseg=5) on the planted target
        and draft, against decode_loop_flat;
     k. `generate` on the planted target served unfused (separate q/k/v
        and gate/up, as quantization returns it; int8 cache): a 128-token
        prompt and 32 tokens through the decode attention and the fused MLP
        (no fused-model decode kernel may launch);
     l. `compute_ppl` on the random-weight model served unfused, 2 batches
        of 2048 tokens from a seed: the fused route (dequant matmul, fused
        MLP) against the dequantize-then-matmul route, within 1e-2;
     m. the W4A8 spec on every decoder linear with MI_W4A8_INT=1 (set in
        the phase, restored after): `generate` on the planted target (the
        integer product at the prefill), and `compute_ppl` on the
        random-weight model against the fake-quant route, within 1e-2;
     n. `quantize` an fp Llama-2-7B (bf16, seed 0, CALIB_LAYERS layers at
        full width) by GPTQ int4 g128 affine, act-order off, calibrated on
        32 x 512 wikitext tokens through `get_calibrate_loader`; its
        perplexity by `Benchmark.eval_ppl` (2 x 2048 wikitext test tokens,
        the fused route within 1e-2 of dequantize-then-matmul: dequant
        matmul, fused MLP); `fuse_for_serving` and 128 tokens of
        `decode_loop_model` (the whole-model kernel's bias-table route);
        RTN on the same fp model; on layer 0's and the last layer's
        calibration inputs GPTQ's output error at most RTN's on each of the
        seven linears;
     o. the north-star config (act-order on) on the first 2 layers of that
        fp model, served unfused: `generate` (dequant matmul through each
        linear's permutation, decode attention; no fused-model decode
        kernel and no fused MLP may launch) and `compute_ppl` (routes within
        1e-2);
     p. AWQ int4 g128 of the same fp model's first ALGO_LAYERS = 4 layers
        (CALIB), served unfused (every linear carries its smooth factor,
        which the fused kernels decline): `generate` (B1 gemv16, B6; no fused-model
        decode kernel, no fused MLP), `Benchmark.eval_ppl` (routes within
        1e-2), AWQ's and RTN's output errors on layer 0's and the last
        layer's calibration inputs (reported);
     q. SmoothQuant W8A8 (alpha 0.5, int8 per-channel weights, int8
        per-token activations) of the same 4 layers: `generate` through the
        W8A8 route (torch._int_mm; its call counter above 0) and B6, its
        perplexity within 1e-2 of the fake-quant route and 5% of the fp
        model's;
     r. ZeroQuant, FP8 E4M3 (native float8 weights), AWQ+GPTQ and
        SmoothQuant+GPTQ on the first 2 layers: perplexities finite, routes
        within 1e-2, ZeroQuant's 8-bit linears on B1's CUDA-core kernel;
     s. a checkpoint in the HF safetensors format written by the script
        (meta-llama/Llama-2-7b-hf's published config.json cut to
        CKPT_LAYERS = 3 layers; f16 weights from seed 0 at fp_llama's
        scales, two shards): `load_llama_from_hf` onto the card (f32 equal
        to what was written, bf16 equal to it rounded); `quantize` of the
        bf16 model by GPTQ int4 g128 affine calibrated on the C-Eval
        fixture, twice uninterrupted and once through a
        `CalibrationJournal` stopped after block 1 and resumed (words,
        scales and zeros equal); `save_model` / `load_model` (every array
        bit-equal, the wikitext PPL of one 2048-token batch equal);
        `Benchmark.eval_ceval` / `eval_cmmlu` (2 questions a subject, each
        prediction held against an unpadded forward where the top two
        letters are more than 2e-2 x max|logit| apart) and `eval_boss` (4
        QA questions); the same questions through `generate` with the int8
        cache (the decode attention), each step's logits within 5e-2 x
        max|logit| of the float32 cache's; after
        `fuse_for_serving`, `beam_search` (W=4, 32 tokens, a 150-token
        prompt; one paged launch a step) against `dense_beam` on the
        batched kernel's dense mode (a), W=1 against `PagedMegaBatcher`'s
        greedy tokens, and W=4 on the planted target (the planted chain);
        a `RunManifest` of its phases (beside `--report`, as
        path_s_manifest.json) and a `Memory` round trip of the embedding;
     t. tensor-parallel serving over TP = 2 ranks, each a gloo process on
        the one card (`tp_rank`): the planted target sharded by
        `shard_model` serves 8 requests (prompts 16-256, 32 or 64 new
        tokens) through ContinuousBatcher and PagedMegaBatcher (prefill
        through the row-parallel ring on its tensor-core "mma" route, one
        mode (e) step a token), tokens
        equal to the single-card batchers'; one model_step_batch_tp step of
        the random-weight model within TOL of the single-card step's logits;
        its walls are not TP speed (the ranks share the card and sum
        through host memory);
     u. latency (`eval/latency.py`): Benchmark.eval_latency on the served
        7B model at batch 1, 128 tokens, int8 cache (forward percentiles,
        the per-layer decode's tokens/s and roofline fraction,
        decode_loop_model's, and the whole-model kernel alone beside
        torch.sum over as many bytes), the unfused model's forward, and the
        flat kernel alone beside decode_loop_flat's step; every share of a
        roofline, of the HBM rate and of torch.sum's rate in (0, 100%], each
        kernel's time a token at most its step's;
     v. lm-eval (`eval/lmeval.py`): mc_taco, headqa and wikitext's rolling
        windows on the random-weight 7B model, gsm8k and squad2 (greedy and
        mixed requests) on the planted target, from raw files under
        build/path_v, on the fused route against fused=False: each
        loglikelihood within LL_TOL a continuation token, the same metrics
        (the perplexities within what LL_TOL allows) and greedy texts;
     w. the CLI twins (`mi_optimize_tpu_torch/cli/`) in-process with
        --device cuda on a 3-layer 7B-width checkpoint: benchmark_ppl's JSON
        equal to Benchmark.eval_ppl's, benchmark_latency's keys and byte
        counts, serve --slots 8's tokens equal to ContinuousBatcher's;
     every kernel must have launched on its path, no path but r may launch
     the CUDA-core dequant_matmul kernels (every other served linear is bf16
     int4), and every planted path's tokens must equal the planted chain
     exactly;
  4. check the outputs: tokens in range, logits finite, and on a small f32
     model the card's prefill logits and greedy tokens (generate, the flat
     loop, the batcher with a mid-flight join, decode_loop_model on an
     asymmetric grid, both paged batchers with waves and prefix caching, a
     planted pair through speculative_generate and decode_loop_flat_seg,
     an unfused model's generate and compute_ppl, int4 and W4A8) agree
     with the plain versions run on the CPU; these f32 paths are where the
     CUDA-core dequant_matmul kernels run, and their launches are counted;
     and a small f32 model quantized on the card and on the CPU: RTN's words
     equal, GPTQ (act-order) within `hold_codes` of the CPU's GPTQ from the
     card's own Hessians and its perplexity within 1e-3 (the CPU's own
     calibration is reported); the other nine algorithm configurations:
     every call's stats within 1e-5 of the CPU calibration's on the card's
     quantized states (1e-2 where the forwards quantize activations), then
     each linear on the CPU from the card's stats (RTN, SmoothQuant,
     ZeroQuant, FP8 bit-equal; AWQ, both combos, SpQR and QuIP 99% of the
     codes); and lm-eval's five tasks on a small f32 model, the card's
     metrics and greedy texts equal to the CPU's, each loglikelihood within
     1e-4;
  5. where the time goes: torch.profiler device time by kernel and the
     device busy share over a prefill, flat decode, per-layer decode, 16
     tokens of decode_loop_model on the asymmetric grid, 8 batcher steps
     and 8 paged batcher steps with 8 active slots, 8 PagedBatcher steps
     with 4 active slots (the paged flash decode), one
     k=4 speculative round on the planted 7B pair, 8 decode steps of the
     unfused planted model (after a 128-token prompt, T=512, and after a
     1920-token prompt, T=2048), one 2048-token perplexity batch and
     GPTQ on the seven linears of one 7B layer (`gptq_layer_7b`, one run,
     the profiler's raw events summed), and AWQ of the same layer from its
     four groups' stats (`awq_layer_7b`).

Earlier lines report each phase; the line before the last is a JSON object
with every kernel's launches, error, time, plain time, library time (torch's
own int4 product for the 4-bit dequant_matmul rows, scaled_dot_product_attention
over the pre-gathered pages for the paged flash decode and over the
pre-dequantized history for the decode attention, torch._int_mm for the
per-channel W4A8 row; none for the decode kernels and the fused MLP, since no
single PyTorch call computes a decoder stack, its lm rows or a quantized
SwiGLU MLP) and bound (model_decode_mega's launches count every
whole-model one-token launch, of either route; model_decode_mega4's those of
the 4-bit route; block_decode_mega's and block_decode_mega4's the same for
the per-layer decode);
the last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits with code 2 and prints no result. `--report PATH` also writes
the whole report (per-kernel bytes and flops, per-request latencies)
there as JSON. `--baseline PATH` reads such a report of another tree's run
in the same call (a parent commit's) and prints its kernel times, phase 5
device times, walls and busy shares and ptxas registers and spills beside
this run's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
INT8_OPS = 1979e12          # H100 SXM dense int8 tensor-core peak
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
TOL = 2e-2                  # max|kernel - plain| <= TOL * max|plain| in bf16
F32_TOL = 1e-3              # the same in float32 (sum orders differ)
SCALE_RTOL = 1e-3           # each int8 row scale within this of its own plain value
DEPTH_GATE_POS = 64         # slots at or past this position are held in float32 at full depth
SPIN_CYCLES = 4_000_000     # about 2 ms of device spin at the H100's clock


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    """(least ms the card could take, what bounds it)."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _bits_dtype(m) -> str:
    return "float" if m.group(1) == "f" else "bf16"


# (source, mangled-name pattern, label) of the kernels whose registers and
# spills phase 1 reports: every batch_kernel instance (model_fused.cu), every
# model_flat_kernel and model_flat_seg_kernel instance (model_flat.cu; their
# 4-bit instances run flat_gemv.cuh), every mega4_kernel instance (model_mega4.cu, over
# flat_gemv.cuh; BIAS=1 streams bias tables), gemv16_kernel
# (dequant_matmul.cu), the fused MLP's tensor-core kernels (mlp_fused.cu:
# the M <= 8 kernel, P1 and P2 above), the paged flash decode's
# paged_split_kernel (paged_attention.cu: q and pool dtypes, q heads an item)
# and the decode attention's decode_split_kernel (decode_attention.cu: q/k/v
# dtype, q heads an item, head widths)
PTXAS_KERNELS = (
    ("model_fused", r"batch_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d)ELb(\d)ELb(\d)E",
     lambda m: f"batch_kernel<{_bits_dtype(m)}, {m.group(2)}, {m.group(3)}, GEN={m.group(4)}, "
               f"LM={m.group(5)}>"),
    ("model_flat", r"model_flat_kernelI(f|13__nv_bfloat16)Li(\d)E",
     lambda m: f"model_flat_kernel<{_bits_dtype(m)}, {m.group(2)}>"),
    ("model_flat", r"model_flat_seg_kernelI(f|13__nv_bfloat16)Li(\d)E",
     lambda m: f"model_flat_seg_kernel<{_bits_dtype(m)}, {m.group(2)}>"),
    ("model_mega4", r"mega4_kernelI(f|13__nv_bfloat16)Lb([01])E",
     lambda m: f"mega4_kernel<{_bits_dtype(m)}, BIAS={m.group(2)}>"),
    ("dequant_matmul", r"gemv16_kernelILi(\d)E", lambda m: f"gemv16_kernel<{m.group(1)}>"),
    ("mlp_fused", r"mlp_gemv_mma_kernel", lambda m: "mlp_gemv_mma_kernel"),
    # (a bf16 pool after a bf16 q is mangled as a back-reference, S1_)
    ("paged_attention", r"paged_split_kernelI(f|13__nv_bfloat16)(f|13__nv_bfloat16|S1_)Li(\d)E",
     lambda m: f"paged_split_kernel<q {_bits_dtype(m)}, pool "
               f"{'float' if m.group(2) == 'f' else 'bf16'}, {m.group(3)} heads>"),
    ("decode_attention", r"decode_split_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d)ELb([01])E",
     lambda m: f"decode_split_kernel<{_bits_dtype(m)}, {m.group(2)} heads, " + (
         "D = 128 row groups>" if m.group(4) == "1" else f"D <= {128 * int(m.group(3))}>")),
    ("model_fused_tp", r"tp_kernelI(f|13__nv_bfloat16)Li(\d)ELb(\d)E",
     lambda m: f"tp_kernel<{_bits_dtype(m)}, {m.group(2)}, GEN={m.group(3)}>"),
    ("overlap", r"ring_chunk_kernelI(f|13__nv_bfloat16)Li(\d)E",
     lambda m: f"ring_chunk_kernel<{_bits_dtype(m)}, {m.group(2)}>"),
    ("overlap", r"ring_gemv_kernelILi(\d)E",
     lambda m: f"ring_gemv_kernel<{m.group(1)} row tile(s)>"),
    ("overlap", r"ring_mma_kernelI\w*?RingTileILi(\d+)E",
     lambda m: f"ring_mma_kernel<[{m.group(1)}, 128] tile>"),
    ("mlp_fused",
     r"mlp_mma_kernelINS_7MlpTileILi(\d+)ELi(\d)ELi(\d)ELi(\d)ELi\d+ELi\d+EEELb([01])E",
     lambda m: f"mlp_mma_kernel<{'P1' if m.group(5) == '1' else 'P2'}, [{m.group(1)}, 128] on "
               f"{m.group(2)} x {m.group(3)} warps, {m.group(4)} plane(s)>"))


def ptxas_rows(text: str, pattern: str, label) -> list:
    """The instances whose mangled name matches `pattern` in an nvcc log
    with ptxas's report: [{"instance": label(match), "registers",
    "spill_stores", "spill_loads", "stack"}] in the log's order."""
    import re

    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(pattern, m.group(1))
            cur = None
            if k:
                cur = {"instance": label(k), "spill_stores": 0, "spill_loads": 0, "stack": 0}
                rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


def ptxas_report() -> list:
    """Registers and spill bytes of each kernel instance of PTXAS_KERNELS,
    from ptxas's report of its source's build (`ptxas_rows`), logged one a
    line."""
    from mi_optimize_tpu_torch.ops import _build

    rows = []
    for source, pattern, label in PTXAS_KERNELS:
        found = ptxas_rows(_build.ptxas_log(source), pattern, label)
        if not found:
            raise AssertionError(f"ptxas reported no instance of {pattern} in {source}.cu")
        rows += found
    for r in rows:
        log(f"  ptxas: {r['instance']}: {r.get('registers')} registers, {r['spill_stores']} "
            f"bytes spill stores, {r['spill_loads']} bytes spill loads")
    return rows


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def time_ms(fn, reps: int, flush) -> float:
    """Mean device ms of fn() over reps runs, each after an L2 flush, timed
    with CUDA events around the call alone. A spin kernel keeps the card busy
    while the host enqueues the events and the call, so the host's wrapper
    time does not land between the events as device idle time."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def max_err(got, ref):
    """(max|got - ref|, max|ref|) in f32."""
    g, r = got.float(), ref.float()
    return float((g - r).abs().max()), float(r.abs().max())


def check_close(what, got, ref, tol=TOL, scale=None):
    """max|got - ref| within tol times `scale` (max|ref| by default)."""
    err, peak = max_err(got, ref)
    scale = peak if scale is None else scale
    ok = err <= tol * scale
    log(f"  {what}: max|diff| {err:.3e} vs bound {tol * scale:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return err


def check_token(what, tok, ref_tok, ref_logits, tol_abs):
    """The kernel's token equals the plain version's unless the plain top-2
    logit gap is below the tolerance."""
    import torch

    top2 = torch.topk(ref_logits.float().reshape(-1), 2).values
    gap = float(top2[0] - top2[1])
    same = int(tok) == int(ref_tok)
    log(f"  {what}: kernel {int(tok)} plain {int(ref_tok)} (top-2 gap {gap:.3e})")
    if not same and gap >= tol_abs:
        raise AssertionError(f"{what}: kernel token differs from the plain version's")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def tinygemm_operands(lin, st, bt):
    """A 4-bit linear in the layout of torch's own int4 product,
    torch._weight_int4pack_mm: (weight [N, K] packed by
    torch._convert_weight_to_int4pack, bf16 [K/g, N, 2] scales and zeros).
    That product dequantizes w = (q - 8)*scale + zero per group; ours is
    q*scale + bias on the same biased codes q, so zero = bias + 8*scale."""
    import torch

    from mi_optimize_tpu_torch.core.packing import unpack_words

    q = unpack_words(lin.packed, 4).t().contiguous()           # [N, K] codes 0..15
    w = torch._convert_weight_to_int4pack((q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8), 8)
    sz = torch.stack([st, bt + 8.0 * st], dim=-1).to(torch.bfloat16).contiguous()
    return w, sz


DM_ROWS = {"cuda_core": "dequant_matmul", "gemv16": "dequant_matmul_gemv16",
           "mma": "dequant_matmul_mma"}  # the kernels line's name of each route


def check_dequant_matmul(model, cfg, dev, flush, reps):
    """Every fused linear at M = 128 (prefill) and M = 1 (decode), and at
    M = 2048, the rows of one compute_ppl batch, the 4096->4096 shape of the
    unfused q/k/v/o projections (the same shape and kernel as o_proj) and
    the lm_head, in bf16: the kernel of the call's route (gemv16 at M <= 16,
    mma above), held within TOL of the plain version and to the same bits
    on a second launch, timed against the CUDA-core kernel on the same
    operands (`cuda_core_ms`). Also times torch's int4 product (the library
    yardstick) on the same x and the same 4-bit weights; it is held to the
    same tolerance against the plain version and used nowhere in the port.
    The CUDA-core kernels keep the f32 inputs: the o_proj at M = 1 and 128 in f32,
    within F32_TOL."""
    import torch

    from mi_optimize_tpu_torch.models.quant_linear import group_size
    from mi_optimize_tpu_torch.ops import dequant_matmul as dm

    blk = model.params["layers"][0]
    lins = {"qkv": blk["qkv_proj"], "o": blk["o_proj"], "gate_up": blk["gateup_proj"],
            "down": blk["down_proj"], "lm_head": model.params["lm_head"]}
    gen = torch.Generator(device=dev).manual_seed(1)
    lib_ops = {}
    rows = []
    cases = ([(M, name, torch.bfloat16) for M in (128, 1) for name in lins]
             + [(2048, "o", torch.bfloat16), (2048, "lm_head", torch.bfloat16),
                (128, "o", torch.float32), (1, "o", torch.float32)])
    for M, name, dt in cases:
        lin = lins[name]
        K, N, bits, g = lin.in_features, lin.out_features, lin.spec.wbit, group_size(lin)
        reps_m = reps if M < 2048 else max(2, reps // 4)
        st, bt = dm.kernel_tables(lin)
        x = torch.randn(M, K, generator=gen, device=dev).to(dt)
        kernel = dm.route(M, dt, bits, g)
        run = lambda: dm.packed_matmul(x, lin.packed, st, bt, bits, g)
        core = lambda: dm.packed_matmul(x, lin.packed, st, bt, bits, g, kernel="cuda_core")
        plain = lambda: dm.dequant_matmul_ref(x, lin.packed, st, bt, bits, g)
        y, y2, ref = run(), run(), plain()
        torch.cuda.synchronize()
        what = f"dequant_matmul ({kernel}) {name} M={M} [{K}->{N}] {str(dt)[6:]}"
        err = check_close(what, y, ref, TOL if dt == torch.bfloat16 else F32_TOL)
        if not torch.equal(y, y2):
            raise AssertionError(f"{what}: two launches on the same inputs differ")
        ms = time_ms(run, reps_m, flush)
        plain_ms = time_ms(plain, max(2, reps_m // 10), flush)
        core_ms = None
        if kernel != "cuda_core":
            check_close(f"  CUDA-core kernel {name} M={M}", core(), ref)
            core_ms = time_ms(core, reps_m, flush)
        lib_ms = lib_err = None
        if bits == 4 and g in (32, 64, 128, 256) and dt == torch.bfloat16:
            if name not in lib_ops:
                lib_ops[name] = tinygemm_operands(lin, st, bt)
            w4, sz = lib_ops[name]
            lib = lambda: torch._weight_int4pack_mm(x, w4, g, sz)
            lib_err = check_close(f"  torch._weight_int4pack_mm {name} M={M}", lib(), ref)
            lib_ms = time_ms(lib, reps_m, flush)
        nb, fl = nbytes(x, lin.packed, st, bt) + M * N * x.element_size(), 2.0 * M * N * K
        b_ms, b_by = bound(nb, fl, BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS)
        log(f"    kernel {ms:.4f} ms  CUDA-core kernel "
            f"{'-' if core_ms is None else f'{core_ms:.4f} ms'}  plain {plain_ms:.4f} ms  "
            f"library {'null' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound {b_ms:.4f} ms "
            f"({b_by}); same bits twice")
        rows.append(dict(name=DM_ROWS[kernel], shape=f"{name} M={M} K={K} N={N} "
                         f"{str(dt)[6:]}", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         cuda_core_ms=core_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         library_max_abs_err=lib_err, bytes=nb, flops=fl))
    return rows


def random_int8_cache(cfg, T, pos, dev, gen):
    """A per-layer int8 cache [1, T, Hkv, D] whose rows t < pos hold codes
    and absmax-like scales (rows past pos stay zero, as in a live cache)."""
    import torch

    shape = (1, T, cfg.num_kv_heads, cfg.head_dim)
    c = {}
    for f in ("k", "v"):
        q = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int32)
        q[:, pos:] = 0
        c[f] = q.to(torch.int8)
        s = torch.rand(shape[:3], generator=gen, device=dev) * 0.02 + 1e-3
        s[:, pos:] = 0
        c[f + "_scale"] = s
    return c


def decode_block_bytes(stack, cfg, pos):
    """Bytes one layer's decode must move: a one-layer stack's words, scale
    tables, norms and (an asymmetric grid) bias tables, the live history,
    x in and out and the new rows."""
    h, Hkv, D = cfg.hidden_size, cfg.num_kv_heads, cfg.head_dim
    cache = 2 * pos * Hkv * (D + 4)      # live int8 k/v rows and their f32 scales
    io = 2 * h * 2 + 2 * Hkv * (D + 4)   # x in, x out, the new rows and scales
    return stacked_bytes(stack) + cache + io


def decode_block_flops(cfg, pos):
    h, H, Hkv, D, I = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                       cfg.intermediate_size)
    lin = h * (H + 2 * Hkv) * D + H * D * h + h * 2 * I + I * h
    return 2.0 * lin + 4.0 * (pos + 1) * H * D


def check_block(model, cfg, dev, flush, reps, T=384, positions=(200, 0), label=""):
    """The per-layer decode kernel (B2) on layer 0 of a 7B model, on the
    route 4-bit words take ("mega4": the whole-model kernel's tensor-core
    layer loop at one layer, csrc/model_mega4.cu, on the block's one-layer
    view; an asymmetric grid streams its bias tables): at each position
    x_out and the dequantized new rows against its plain version, a second
    launch giving the same bits, and timed beside its plain version
    (position 0: the GEMVs and barriers with next to no attention). Its
    rows carry the name of the kernel they replace (`baseline_name`), so
    that a parent's report, which timed the CUDA-core block_decode_kernel
    on the same inputs, lines up with them. Bound: the view's words, tables
    and norms, the live history, x in and out and the new rows, read or
    written once."""
    import torch

    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.ops import block_fused as bf

    blk, name, rows = model.params["layers"][0], "block_decode_mega4", []
    if bf.block_route(blk["qkv_proj"].spec.wbit, torch.bfloat16) != "mega4":
        raise AssertionError("the 4-bit per-layer decode should take the mega4 route")
    for pos in positions:
        gen = torch.Generator(device=dev).manual_seed(2)
        cache = random_int8_cache(cfg, T, pos, dev, gen)
        x = (torch.randn(1, 1, cfg.hidden_size, generator=gen, device=dev)).to(torch.bfloat16)
        cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=dev))
        cos, sin = cos.reshape(-1), sin.reshape(-1)
        run = lambda: bf.block_decode_rows(blk, blk["mega"], x, cos, sin, cache, pos, cfg)
        plain = lambda: bf.block_decode_ref(blk, blk["mega"], x, cos, sin, cache, pos, cfg)
        before = bf.launches_mega4
        got, ref = run(), plain()
        torch.cuda.synchronize()
        if bf.launches_mega4 == before:
            raise AssertionError(f"{name} did not launch the mega4 kernel")
        err = check_close(f"{name} {label}x_out (T={T}, pos={pos})", got[0], ref[0])
        for i, sc, f in ((1, 3, "k"), (2, 4, "v")):
            check_close(f"{name} new {f} row (dequantized)",
                        got[i].float() * got[sc][:, None], ref[i].float() * ref[sc][:, None])
        if not all(torch.equal(u, v) for u, v in zip(got, run())):
            raise AssertionError(f"{name}: two launches on the same inputs differ")
        ms = time_ms(run, reps, flush)
        plain_ms = time_ms(plain, max(2, reps // 10), flush)
        view = bf.mega4_view(blk, blk["mega"], cfg, x.dtype)
        nb, fl = decode_block_bytes(view.stack, cfg, pos), decode_block_flops(cfg, pos)
        b_ms, b_by = bound(nb, fl)
        log(f"    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}); "
            f"same bits twice; bias tables streamed: "
            f"{sorted(k for k in view.stack if k.endswith('z'))}")
        rows.append(dict(name=name, shape=f"one layer {label}T={T} pos={pos}",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, bytes=nb, flops=fl, baseline_name="block_decode_mega"))
    return rows


# the flat stack's per-layer entries (the rest are the lm_head's and the final norm)
FLAT_LAYER_KEYS = ("qkv", "qs", "o", "os", "gu", "gus", "d", "ds", "n1", "n2")


def check_flat(model, fstack, fmeta, cfg, dev, flush, reps, T=384, pos=200, name="",
               gate="full", cut=2):
    """The flat kernel (B3) at full width over a random int8 history of pos
    rows, against its plain version; a second launch gives the same bits.
    Bound: the stack's weights and tables, the live history and the logits.

    gate="full": the logits within TOL of max|plain|, the token and the new
    k/v rows within TOL, at full depth.
    gate="cut" (position 0): attention returns the new v row itself, so a
    one-code flip at a rounding tie that the sum orders break differently
    moves the next layer's input directly, and over 32 layers in bf16 the
    logits, rows and scales drift as check_whole_model's x_out does (on
    these inputs the kernel's earlier CUDA-core GEMV failed the full-depth
    row check by 3%, a correct kernel). Held
    as that holds it (`hold_rows`): the first `cut` layers with the final
    norm and the lm_head, launched on their own (the same plan, so layer 0
    is the full launch's), give logits within TOL, the token, layer 0's rows
    one-code on at most 0.1% with every scale within SCALE_RTOL, the later
    layers' rows within one code and scales within TOL; at full depth the
    logits are finite, and their drift, the token and the rows' codes are
    reported.
    gate="planted" (a planted draft): its lm_head puts one logit near 80
    and the rest near 1, so the logits are held within TOL of the largest
    off-peak plain logit; its o_proj and down_proj are zero, so this row
    holds qkv, the rows and the lm_head, and times the launch."""
    import dataclasses

    import torch

    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.ops import model_flat as mf
    from mi_optimize_tpu_torch.serving.flatdecode import stack_cache_flat

    gen = torch.Generator(device=dev).manual_seed(3)
    cache = stack_cache_flat([random_int8_cache(cfg, T, pos, dev, gen)
                              for _ in range(cfg.num_layers)])
    x = llama.embed(model.params, torch.tensor([[7]], device=dev))
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=dev))
    cossin = torch.cat([cos.reshape(-1), sin.reshape(-1)])
    run = lambda st=fstack, ca=cache, c=cfg: mf.model_decode_flat(st, x, cossin, ca, pos, c, fmeta)
    plain = lambda st=fstack, ca=cache, c=cfg: mf.model_decode_flat_ref(st, x, cossin, ca, pos,
                                                                        c, fmeta)
    got, got2, ref = run(), run(), plain()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, got2)):
        raise AssertionError("model_decode_flat: two launches on the same inputs differ")
    what = f"model_decode_flat logits ({name}{cfg.num_layers} layers, T={T}, pos={pos})"
    L = cfg.num_layers
    rows = lambda o: (o[1], o[2][:, 0], o[2][:, 1], o[3][:, 0, 0], o[3][:, 1, 0])
    extra = {}
    if gate == "cut":
        if not bool(torch.isfinite(got[1]).all()):
            raise AssertionError(f"{what}: non-finite logits")
        e, peak = max_err(got[1], ref[1])
        extra["full_depth_logits_rel"] = e / peak
        log(f"  {what}, reported: max|diff| {e:.3e} = {e / peak:.2e} of max|plain|; token "
            f"kernel {int(got[0])} plain {int(ref[0])}")
        for i, f in ((1, "k"), (2, "v")):
            code_diff(f"model_decode_flat new {f} rows (bf16, all layers, reported)",
                      rows(got)[i], rows(ref)[i])
        c = dataclasses.replace(cfg, num_layers=cut)
        head = ({k: v[:cut] if k in FLAT_LAYER_KEYS else v for k, v in fstack.items()},
                {k: v[:cut] for k, v in cache.items()})
        hg, hr = run(*head, c), plain(*head, c)
        torch.cuda.synchronize()
        err, extra["codes"] = hold_rows("model_decode_flat", rows(hg), rows(hr), TOL,
                                        f"bf16, first {cut} layers and the lm_head", strict=1,
                                        out="logits")
        check_token(f"model_decode_flat token (first {cut} layers)", hg[0], hr[0], hr[1],
                    TOL * float(hr[1].abs().max()))
    else:
        scale = None
        if gate == "planted":
            off = ref[1].float().reshape(-1).clone()
            off[int(ref[0])] = 0
            scale = float(off.abs().max())
        err = check_close(what, got[1], ref[1], scale=scale)
        check_token("model_decode_flat token", got[0], ref[0], ref[1],
                    TOL * float(ref[1].abs().max()))
        check_close("model_decode_flat k/v rows (dequantized)",
                    got[2].float() * got[3].reshape(L, 2, -1, 1),
                    ref[2].float() * ref[3].reshape(L, 2, -1, 1))
    ms = time_ms(run, reps, flush)
    plain_ms = time_ms(plain, 2, flush)
    nb = nbytes(*fstack.values()) + L * 2 * pos * cfg.num_kv_heads * (
        cfg.head_dim + 4) + fmeta[-1] * 4
    fl = L * decode_block_flops(cfg, pos) + 2.0 * cfg.hidden_size * fmeta[-1]
    b_ms, b_by = bound(nb, fl)
    log(f"    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}); "
        "same bits twice")
    return [dict(name="model_decode_flat",
                 shape=f"{name}{L} layers + lm_head T={T} pos={pos}",
                 max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 bytes=nb, flops=fl, gate=gate, **extra)]


def code_diff(what, got, ref, first=0):
    """Int8 rows [L, ...] of a whole-model kernel (layers first, first + 1,
    ...) against the plain version's: (max code difference and share of
    codes that differ in layer `first`, the same over all layers), logged."""
    d = (got.int() - ref.int()).abs()
    st = (int(d[0].max()), float((d[0] > 0).float().mean()), int(d.max()),
          float((d > 0).float().mean()))
    log(f"  {what} int8 codes: layer {first} max|diff| {st[0]}, {st[1]:.2e} differ; "
        f"these layers max|diff| {st[2]}, {st[3]:.2e} differ")
    return st


def hold_rows(name, got, ref, tol, what, strict=None, out="x_out"):
    """The gate on a whole-model kernel's outputs (x_out, krows, vrows,
    kscales, vscales) against its plain version's: x_out within tol of
    max|plain|; over the first `strict` layers (all by default) the int8
    rows equal up to one-code flips on at most 0.1% of entries and every
    scale within SCALE_RTOL of its own plain value (a scale off by a factor
    127/128 is off by 7.9e-3); over the later layers, whose inputs carry
    the earlier layers' bf16 roundings, the rows within one code and the
    scales within tol of max|plain|. Raises AssertionError. Returns (x_out
    max|diff|, stats). `out` names the first output in the log."""
    err = check_close(f"{name} {out} ({what})", got[0], ref[0], tol)
    n = got[1].shape[0] if strict is None else strict
    stats = {}
    for i, f in ((1, "k"), (2, "v")):
        st = stats[f"{f}_codes"] = code_diff(f"{name} new {f} rows ({what}, layers < {n})",
                                             got[i][:n], ref[i][:n])
        if st[2] > 1 or st[3] > 1e-3:
            raise AssertionError(f"{name}: int8 {f} rows disagree with the plain version "
                                 f"({what}, layers < {n})")
        r = ref[i + 2][:n].float()
        rel = float(((got[i + 2][:n].float() - r).abs() / r.abs().clamp_min(1e-30)).max())
        stats[f"{f}_scales_rel"] = rel
        ok = rel <= SCALE_RTOL
        log(f"  {name} new {f} scales ({what}, layers < {n}): max relative diff {rel:.3e} "
            f"vs {SCALE_RTOL:.0e} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: {f} scales disagree with the plain version ({what})")
        if n < got[i].shape[0]:
            st = stats[f"{f}_codes_later"] = code_diff(
                f"{name} new {f} rows ({what}, layers {n}+)", got[i][n:], ref[i][n:], n)
            if st[2] > 1:
                raise AssertionError(f"{name}: int8 {f} rows of layers {n}+ disagree with the "
                                     f"plain version ({what})")
            check_close(f"{name} new {f} scales ({what}, layers {n}+)", got[i + 2][n:],
                        ref[i + 2][n:], tol)
    return err, stats


def check_whole_model(name, kernel, plain, stack, cache, x, cfg, positions, cut=2,
                      depth_gate=True):
    """A whole-model kernel (x_out, krows, vrows, kscales, vscales) against
    its plain version on the same inputs; kernel/plain(stack, cache, x, cfg).

    A flip of one int8 code (at a rounding tie that the sum orders break
    differently) moves that row by one code, and where the new row dominates
    attention (a slot at a low position) it moves the next layers' inputs;
    over depth, and wherever a bf16 rounding flips with it, deeper rows and
    x_out drift. So x_out at full depth in bf16 is chaotic and only
    reported. Held (`hold_rows`): over the first `cut` layers of the same
    stack at full width, x_out within TOL (bf16) or F32_TOL (float32);
    layer 0's rows (its inputs are the same up to the dot products' sum
    order; in float32 every layer's) one-code on at most 0.1% and every
    scale within SCALE_RTOL of its own; in bf16 the later layers' rows
    within one code, their scales within TOL; at full depth in bf16, layer
    0's rows and all scales within TOL of max|plain|. At full depth in
    float32, x_out of each slot at a position of DEPTH_GATE_POS or more is
    held within F32_TOL of max|plain|; the slots below are reported (as is
    check_mega_batch's second witness for them); with depth_gate=False every
    row's full-depth drift is reported only. `planted_faults` shows that the bf16 gate over `cut`
    layers fails on a wrong history, a wrong row and a wrong scale. Returns
    (bf16 x_out max|diff| over `cut` layers, stats, (kernel, plain) outputs
    in float32 at full depth)."""
    import dataclasses

    import torch

    def run(st, ca, xx, c):
        got, ref = kernel(st, ca, xx, c), plain(st, ca, xx, c)
        torch.cuda.synchronize()
        return got, ref

    c = dataclasses.replace(cfg, num_layers=cut)
    head = ({k: v[:cut] for k, v in stack.items()}, {k: v[:cut] for k, v in cache.items()})
    stats = {}
    got, ref = run(*head, x.to(torch.bfloat16), c)
    err, stats[f"bf16_{cut}_layers"] = hold_rows(name, got, ref, TOL,
                                                 f"bf16, first {cut} layers", strict=1)
    got, ref = run(stack, cache, x.to(torch.bfloat16), cfg)
    e, scale = max_err(got[0], ref[0])
    stats["bf16_full_depth_x_out_rel"] = e / scale
    log(f"  {name} x_out (bf16, all {cfg.num_layers} layers, reported): max|diff| {e:.3e} "
        f"= {e / scale:.2e} of max|plain|")
    for i, f in ((1, "k"), (2, "v")):
        st = stats[f"bf16_{f}_codes"] = code_diff(f"{name} new {f} rows (bf16)", got[i], ref[i])
        if st[0] > 1 or st[1] > 1e-3:
            raise AssertionError(f"{name}: layer-0 int8 rows disagree with the plain version")
        check_close(f"{name} new {f} scales (bf16)", got[i + 2], ref[i + 2])
    got, ref = run(stack, cache, x.float(), cfg)
    full = (got, ref)
    e, scale = max_err(got[0], ref[0])
    stats["f32_full_depth_x_out_rel"] = e / scale
    log(f"  {name} x_out (f32, all {cfg.num_layers} layers): max|diff| {e:.3e} "
        f"= {e / scale:.2e} of max|plain|")
    by_slot = ((got[0].float() - ref[0].float()).reshape(len(positions), -1).abs().amax(dim=1)
               / scale).tolist()
    stats["f32_full_depth_x_out_rel_by_slot"] = by_slot
    held = [b for b, p in enumerate(positions) if p >= DEPTH_GATE_POS and depth_gate]
    ok = all(by_slot[b] <= F32_TOL for b in held)
    log(f"  {name} x_out (f32, all layers) by slot at positions {list(positions)}: "
        f"{', '.join(f'{v:.1e}' for v in by_slot)} of max|plain|; "
        + (f"held within {F32_TOL:.0e} at positions >= {DEPTH_GATE_POS} -> "
           f"{'ok' if ok else 'FAIL'}" if depth_gate else "reported"))
    if not ok:
        raise AssertionError(f"{name}: float32 x_out at full depth disagrees with the plain "
                             "version")
    for i, f in ((1, "k"), (2, "v")):
        stats[f"f32_full_depth_{f}_codes"] = code_diff(
            f"{name} new {f} rows (f32, all layers, reported)", got[i], ref[i])
    got, ref = run(*head, x.float(), c)
    stats[f"f32_{cut}_layers"] = hold_rows(name, got, ref, F32_TOL,
                                           f"f32, first {cut} layers")[1]
    return err, stats, full


def planted_faults(model, stack, meta, cfg, dev, positions, T=512, cut=2):
    """check_whole_model's bf16 gate (`hold_rows` over the first `cut`
    layers) on the batched kernel's outputs at check_mega_batch's state (the
    same seed), first as they are (they must pass), then with three faults
    planted in them, each of which it must reject:
      (i) the kernel reads another slot's history: two slots swap caches in
          the kernel's copy only, the two with the shortest histories (the
          one at position 0 has none: the other reads an empty one) and the
          two with the longest;
      (ii) one new k row is wrong: slot s's head-0 row in layer 0 is its
          history row at position p - 1 (codes and scale);
      (iii) one scale is wrong: slot s's head-0 k scale in layer 0 is amax /
          128 instead of amax / 127 (its codes unchanged).
    A fault the gate lets through fails the run. Returns the report."""
    import dataclasses

    import torch

    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.ops import model_fused as mf

    B = len(positions)
    gen = torch.Generator(device=dev).manual_seed(8 + B)   # check_mega_batch's state
    cache = random_slot_cache(cfg, positions, T, dev, gen)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device=dev)
    x = llama.embed(model.params, toks).to(torch.bfloat16)
    cos, sin = llama.rope_tables(cfg, torch.tensor(positions, device=dev)[:, None])
    cos, sin = cos.reshape(B, -1), sin.reshape(B, -1)
    c = dataclasses.replace(cfg, num_layers=cut)
    st = {k: v[:cut] for k, v in stack.items()}
    ca = {k: v[:cut].clone() for k, v in cache.items()}
    del cache
    kernel = lambda cc: mf.model_decode_mega_batch(st, x, cos, sin, cc, positions, c, meta)
    got = kernel(ca)
    ref = mf.model_decode_mega_batch_ref(st, x, cos, sin, ca, positions, c, meta)
    torch.cuda.synchronize()
    name = "model_decode_mega_batch"
    log(f"  B={B} at positions {positions}, first {cut} layers, bf16: as computed")
    hold_rows(name, got, ref, TOL, f"bf16, first {cut} layers", strict=1)
    order = sorted(range(B), key=lambda b: positions[b])
    s = next(i for i, p in enumerate(positions) if p >= 2 * DEPTH_GATE_POS)
    p = positions[s]

    def swapped(a, b):
        sw = {f: t.clone() for f, t in ca.items()}
        for t in sw.values():
            t[:, [a, b]] = t[:, [b, a]]
        return lambda: kernel(sw)

    def row_from_history():
        out = [t.clone() for t in got]
        out[1][0, s, 0] = ca["k"][0, s, 0, p - 1]
        out[3][0, s, 0] = ca["k_scale"][0, s, 0, p - 1]
        return out

    def scale_128():
        out = [t.clone() for t in got]
        out[3][0, s, 0] = out[3][0, s, 0] * (127.0 / 128.0)
        return out

    report = {}
    faults = [(f"other_slot_history_{a}_{b}", f"(i) slots {a} and {b} (positions "
               f"{positions[a]}, {positions[b]}) read each other's history", swapped(a, b))
              for a, b in (order[:2], order[-2:])]
    for key, what, make in faults + [
            ("row_from_position_p_minus_1", f"(ii) slot {s}'s layer-0 head-0 k row is its row "
             f"at position {p - 1}", row_from_history),
            ("scale_amax_over_128", f"(iii) slot {s}'s layer-0 head-0 k scale is amax / 128",
             scale_128)]:
        log(f"  planted fault {what}:")
        bad = make()
        torch.cuda.synchronize()
        try:
            hold_rows(name, bad, ref, TOL, f"bf16, first {cut} layers", strict=1)
        except AssertionError as e:
            report[key] = f"rejected: {e}"
            log(f"    -> rejected ({e})")
            continue
        raise AssertionError(f"the bf16 gate let planted fault {what} through")
    return report


def stacked_bytes(stack) -> int:
    return nbytes(*stack.values())


def kv_history_bytes(cfg, positions) -> int:
    """Live int8 k/v history and its f32 scales the kernels read, over all
    layers, for tokens at these positions."""
    return cfg.num_layers * 2 * sum(positions) * cfg.num_kv_heads * (cfg.head_dim + 4)


def check_mega(model, stack, meta, cfg, dev, flush, reps, T=384, positions=(200, 0)):
    """The one-token whole-model kernel (B4) on an asymmetric-grid model, on
    the route 4-bit words take ("mega4": the tensor-core layer loop of
    csrc/model_mega4.cu, the bias tables streamed): at each position held by
    check_whole_model's gates, a second launch giving the same bits, and
    timed beside its plain version (position 0: the GEMVs and barriers with
    next to no attention). Its rows carry the name of the kernel they
    replace (`baseline_name`), so that a parent's report, which timed the
    CUDA-core mega_kernel on the same inputs, lines up with them. Bound: the stack's
    words and tables, the live history, x in and out and the new rows, read
    or written once."""
    import torch

    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.ops import model_fused as mf

    L, h = cfg.num_layers, cfg.hidden_size
    if mf.mega_route(meta) != "mega4":
        raise AssertionError("the 4-bit whole-model decode should take the mega4 route")
    name, rows = "model_decode_mega4", []
    for pos in positions:
        gen = torch.Generator(device=dev).manual_seed(7)
        per_layer = [random_int8_cache(cfg, T, pos, dev, gen) for _ in range(L)]
        cache = {f: torch.stack([c[f][0] for c in per_layer]) for f in per_layer[0]}
        del per_layer
        x = llama.embed(model.params, torch.tensor([[11]], device=dev))
        cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=dev))
        cos, sin = cos.reshape(-1), sin.reshape(-1)
        run = lambda st, ca, xx, c: mf.model_decode_mega(st, xx, cos, sin, ca, pos, c, meta)
        plain = lambda st, ca, xx, c: mf.model_decode_mega_ref(st, xx, cos, sin, ca, pos, c, meta)
        log(f"  {name}: asymmetric, {L} layers, T={T}, pos={pos}")
        before = mf.launches_mega4
        err, stats, _ = check_whole_model(name, run, plain, stack, cache, x, cfg, [pos])
        a, b = run(stack, cache, x, cfg), run(stack, cache, x, cfg)
        torch.cuda.synchronize()
        if mf.launches_mega4 == before:
            raise AssertionError(f"{name} did not launch the mega4 kernel")
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise AssertionError(f"{name}: two launches on the same inputs differ")
        ms = time_ms(lambda: run(stack, cache, x, cfg), reps, flush)
        plain_ms = time_ms(lambda: plain(stack, cache, x, cfg), 2, flush)
        nb = (stacked_bytes(stack) + kv_history_bytes(cfg, [pos])
              + 2 * h * 2 + L * 2 * cfg.num_kv_heads * (cfg.head_dim + 4))
        fl = L * decode_block_flops(cfg, pos)
        b_ms, b_by = bound(nb, fl)
        log(f"    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}); "
            f"same bits twice; bias tables streamed: "
            f"{sorted(k for k in stack if k.endswith('z'))}")
        rows.append(dict(name=name, shape=f"{L} layers asymmetric T={T} pos={pos}",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, bytes=nb, flops=fl, codes=stats,
                         baseline_name="model_decode_mega"))
    return rows


def random_slot_cache(cfg, positions, T, dev, gen):
    """A head-transposed slot cache [L, S, Hkv, T(, D)] whose slot s holds
    int8 codes and absmax-like scales in its rows t < positions[s] (the rest
    stay zero, as in a live cache)."""
    import torch

    L, S = cfg.num_layers, len(positions)
    cache = {}
    for f in ("k", "v"):
        q = torch.randint(-127, 128, (L, S, cfg.num_kv_heads, T, cfg.head_dim), generator=gen,
                          device=dev, dtype=torch.int32)
        s = torch.rand((L, S, cfg.num_kv_heads, T), generator=gen, device=dev) * 0.02 + 1e-3
        for b, p in enumerate(positions):
            q[:, b, :, p:] = 0
            s[:, b, :, p:] = 0
        cache[f], cache[f + "_scale"] = q.to(torch.int8), s
        del q
    return cache


def mirror_pool(cache, gen, n_pages=None, P=128):
    """The slot cache's P-row blocks on the pages of a pool ([L, n_pages, Hkv,
    P(, D)], page 0 scratch), in a random order from `gen`; the table [S,
    T/P]. Returns (pool, table)."""
    import torch

    L, S, Hkv, T = cache["k"].shape[:4]
    nt = T // P
    n_pages = n_pages or 1 + S * nt
    dev = cache["k"].device
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    table = perm[:S * nt].reshape(S, nt).to(torch.int32)
    pool = {f: torch.zeros((L, n_pages, Hkv, P) + c.shape[4:], dtype=c.dtype, device=dev)
            for f, c in cache.items()}
    for f, c in cache.items():
        blocks = c.reshape(L, S, Hkv, nt, P, *c.shape[4:]).transpose(2, 3)  # [L,S,nt,Hkv,P..]
        pool[f][:, table.reshape(-1).long()] = blocks.reshape(L, S * nt, Hkv, P, *c.shape[4:])
    return pool, table.cpu()


def batch_row(name, shape, kernel, plain, stack, cache, x, cfg, flush, reps, history,
              positions, **extra):
    """Time a batched whole-model launch and its plain version and give its
    bound: the layers' stack, the live history (`history`: rows a slot
    reads from its cache) and each row's activations and new k/v rows."""
    L, h, B = cfg.num_layers, cfg.hidden_size, len(positions)
    ms = time_ms(lambda: kernel(stack, cache, x, cfg), reps, flush)
    plain_ms = time_ms(lambda: plain(stack, cache, x, cfg), 2, flush)
    nb = (stacked_bytes(stack) + kv_history_bytes(cfg, history)
          + B * (2 * h * 2 + L * 2 * cfg.num_kv_heads * (cfg.head_dim + 4)))
    fl = L * sum(decode_block_flops(cfg, p) for p in positions)
    b_ms, b_by = bound(nb, fl)
    log(f"    kernel {ms:.4f} ms ({ms / B:.4f} ms a row)  plain {plain_ms:.4f} ms  "
        f"bound {b_ms:.4f} ms ({b_by})")
    return [dict(name=name, shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by=b_by, bytes=nb, flops=fl, **extra)]


def check_mega_batch(model, stack, meta, cfg, dev, flush, reps, positions, T=512, label=""):
    """The batched whole-model kernel: B slots at their own positions over
    the head-transposed cache. `stack` holds the decoder layers only (no
    lm_head): the bound counts the bytes the kernel reads.

    A second witness, reported, for the slots below DEPTH_GATE_POS in
    float32 at full depth: the one-token kernel on that slot's inputs. It
    drifts from the plain version as the batched kernel does, but not by the
    same amount: one int8 code that the two kernels' sum orders round to
    different sides of a tie in layer 0 moves a low slot's every later layer
    (at position 17 the batched kernel's drift was 3.2x the one-token
    kernel's). Both slots are held by check_whole_model over the first
    layers in bf16 and float32, and `planted_faults` rejects a slot that
    reads another's history."""
    import torch

    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.ops import model_fused as mf

    L, B = cfg.num_layers, len(positions)
    gen = torch.Generator(device=dev).manual_seed(8 + B)
    cache = random_slot_cache(cfg, positions, T, dev, gen)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device=dev)
    x = llama.embed(model.params, toks)
    cos, sin = llama.rope_tables(cfg, torch.tensor(positions, device=dev)[:, None])
    cos, sin = cos.reshape(B, -1), sin.reshape(B, -1)
    log(f"  model_decode_mega_batch: {label}B={B}, {L} layers, T={T}, positions {positions}")
    kernel = lambda st, ca, xx, c: mf.model_decode_mega_batch(st, xx, cos, sin, ca, positions,
                                                               c, meta)
    plain = lambda st, ca, xx, c: mf.model_decode_mega_batch_ref(st, xx, cos, sin, ca,
                                                                  positions, c, meta)
    err, stats, full = check_whole_model("model_decode_mega_batch", kernel, plain, stack, cache,
                                         x, cfg, positions)
    scale = float(full[1][0].float().abs().max())
    for b, p in enumerate(positions):
        if p >= DEPTH_GATE_POS:
            continue
        one = mf.model_decode_mega(stack, x[b:b + 1].float(), cos[b], sin[b],
                                   {f: t[:, b].transpose(1, 2).contiguous()
                                    for f, t in cache.items()}, p, cfg, meta)
        torch.cuda.synchronize()
        e_one = max_err(one[0][0], full[1][0][b])[0] / scale
        e_bat = max_err(full[0][0][b], full[1][0][b])[0] / scale
        e_two = max_err(one[0][0], full[0][0][b])[0] / scale
        codes = [code_diff(f"  slot {b}: model_decode_mega vs the batched kernel, {f} rows "
                           "(f32, all layers)", one[i], full[0][i][:, b])
                 for i, f in ((1, "k"), (2, "v"))]
        stats[f"f32_full_depth_witness_slot_{b}"] = dict(
            position=p, one_token_vs_plain=e_one, batched_vs_plain=e_bat,
            one_token_vs_batched=e_two, codes_one_token_vs_batched=codes)
        log(f"  slot {b} at position {p} (f32, all layers, reported): x_out of "
            f"model_decode_mega vs plain {e_one:.2e}, batched vs plain {e_bat:.2e}, "
            f"model_decode_mega vs batched {e_two:.2e} of max|plain|")
    return batch_row("model_decode_mega_batch", f"{label}B={B} {L} layers T={T} positions "
                     f"{positions}", kernel, plain, stack, cache, x, cfg, flush, reps, positions,
                     positions, max_abs_err=err, codes=stats)


def check_mega_batch_paged(model, stack, meta, cfg, dev, flush, reps, positions, T=512):
    """The batched kernel's paged mode (b): the dense row's state mirrored
    into a pool of 1 + B*T/128 pages in a random order. Its outputs must be
    bitwise equal to the dense kernel's on the same state (only the history
    addresses differ), and it is held to its plain version as the dense row
    is (the dense row's second witness then covers its low slots too)."""
    import torch

    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.ops import model_fused as mf

    L, B = cfg.num_layers, len(positions)
    gen = torch.Generator(device=dev).manual_seed(8 + B)   # the dense row's state
    cache = random_slot_cache(cfg, positions, T, dev, gen)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device=dev)
    pool, table = mirror_pool(cache, torch.Generator(device=dev).manual_seed(12))
    x = llama.embed(model.params, toks)
    cos, sin = llama.rope_tables(cfg, torch.tensor(positions, device=dev)[:, None])
    cos, sin = cos.reshape(B, -1), sin.reshape(B, -1)
    log(f"  model_decode_mega_batch paged: B={B}, {L} layers, {T // 128} pages of 128 a slot "
        f"in a pool of {pool['k'].shape[1]}, positions {positions}")
    dense = mf.model_decode_mega_batch(stack, x, cos, sin, cache, positions, cfg, meta)
    paged = mf.model_decode_mega_batch(stack, x, cos, sin, pool, positions, cfg, meta,
                                       table=table)
    torch.cuda.synchronize()
    same = all(torch.equal(d, p) for d, p in zip(dense, paged))
    log(f"  paged vs dense kernel on the mirrored state: x_out, rows and scales "
        f"{'bitwise equal -> ok' if same else 'DIFFER -> FAIL'}")
    if not same:
        raise AssertionError("model_decode_mega_batch: the paged mode differs from the dense one")
    del cache, dense, paged
    kernel = lambda st, ca, xx, c: mf.model_decode_mega_batch(st, xx, cos, sin, ca, positions, c,
                                                               meta, table=table)
    plain = lambda st, ca, xx, c: mf.model_decode_mega_batch_ref(st, xx, cos, sin, ca,
                                                                  positions, c, meta, table)
    err, stats, _ = check_whole_model("model_decode_mega_batch paged", kernel, plain, stack,
                                      pool, x, cfg, positions)
    return batch_row("model_decode_mega_batch_paged", f"B={B} {L} layers pages of 128 "
                     f"positions {positions}", kernel, plain, stack, pool, x, cfg, flush, reps,
                     positions, positions, max_abs_err=err, codes=stats,
                     bitwise_equal_dense=same)


def check_mega_batch_chunk(model, stack, meta, cfg, dev, flush, reps, prefixes, C, paged,
                           T=512):
    """The batched kernel's chunk mode (c), over a dense slot cache or (with
    the paged mode) a pool: C consecutive tokens a slot after its prefix,
    held to the plain version with the dense row's rules (bf16 within TOL,
    float32 over the first 2 layers within F32_TOL); the full-depth float32
    drift of every row is reported."""
    import torch

    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.ops import model_fused as mf

    L, S = cfg.num_layers, len(prefixes)
    B = S * C
    gen = torch.Generator(device=dev).manual_seed(20 + B)
    cache = random_slot_cache(cfg, prefixes, T, dev, gen)
    table = None
    if paged:
        cache, table = mirror_pool(cache, gen)
    positions = [p + i for p in prefixes for i in range(C)]
    x = llama.embed(model.params, torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                                                device=dev))
    cos, sin = llama.rope_tables(cfg, torch.tensor(positions, device=dev)[:, None])
    cos, sin = cos.reshape(B, -1), sin.reshape(B, -1)
    what = f"{'paged' if paged else 'dense'} C={C}, {S} slot(s) at prefixes {prefixes}"
    log(f"  model_decode_mega_batch chunk: {what}, {L} layers, T={T}")
    kernel = lambda st, ca, xx, c: mf.model_decode_mega_batch(
        st, xx, cos, sin, ca, positions, c, meta, table=table, chunk=C)
    plain = lambda st, ca, xx, c: mf.model_decode_mega_batch_ref(
        st, xx, cos, sin, ca, positions, c, meta, table, C)
    err, stats, _ = check_whole_model("model_decode_mega_batch chunk", kernel, plain, stack,
                                      cache, x, cfg, positions, depth_gate=False)
    return batch_row("model_decode_mega_batch_chunk", f"{what} {L} layers", kernel, plain,
                     stack, cache, x, cfg, flush, reps, prefixes, positions, max_abs_err=err,
                     codes=stats)


def check_mega_batch_lm(model, stack, meta, lm, lm_meta, cfg, dev, flush, reps, prefixes, C,
                        paged, T=512):
    """The batched kernel's terminal lm rows (mode d) with the mode they ride
    on: C tokens a slot after `prefixes` (C = 1: one-token rows), dense or
    paged. The base outputs must be bitwise equal to the same launch without
    the lm rows; the logits within TOL of the plain version's; each row's
    token equal to the plain version's unless its top-2 gap is below the
    tolerance. Timed against the unfused route: the same launch without the
    lm rows, then rms_norm and the M=B dequant_matmul lm_head (no single
    PyTorch call computes either). Bound: the layers' stack, the lm_head's
    words and scales, the live history, each row's input, new rows, logits
    and token."""
    import torch

    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.ops import model_fused as mf

    L, S, h, V = cfg.num_layers, len(prefixes), cfg.hidden_size, lm_meta[2]
    B = S * C
    gen = torch.Generator(device=dev).manual_seed(30 + B)
    cache = random_slot_cache(cfg, prefixes, T, dev, gen)
    table = None
    if paged:
        cache, table = mirror_pool(cache, gen)
    positions = [p + i for p in prefixes for i in range(C)]
    x = llama.embed(model.params, torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                                                device=dev))
    cos, sin = llama.rope_tables(cfg, torch.tensor(positions, device=dev)[:, None])
    cos, sin = cos.reshape(B, -1), sin.reshape(B, -1)
    what = (f"{'paged' if paged else 'dense'} C={C}, {S} slot(s) at prefixes {prefixes}"
            if C > 1 else f"{'paged' if paged else 'dense'} B={B} at positions {positions}")
    log(f"  model_decode_mega_batch lm rows: {what}, {L} layers, T={T}, V={V}")
    args = (stack, x, cos, sin, cache, positions, cfg, meta)
    run = lambda: mf.model_decode_mega_batch(*args, table=table, chunk=C, lm=lm, lm_meta=lm_meta)
    base = lambda: mf.model_decode_mega_batch(*args, table=table, chunk=C)
    plain = lambda: mf.model_decode_mega_batch_ref(*args, table, C, lm, lm_meta)

    def unfused():
        hh = llama.rms_norm(base()[0], model.params["final_norm"], cfg.rms_eps)
        return llama.unembed(model.params, cfg, hh)[:, 0]

    got, without, ref = run(), base(), plain()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got[:5], without))
    log(f"  lm rows: x_out, rows and scales {'bitwise equal' if same else 'DIFFER'} to the "
        f"launch without them -> {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("model_decode_mega_batch: the lm rows changed the base outputs")
    err = check_close("lm rows logits (bf16)", got[5], ref[5])
    tol = TOL * float(ref[5].abs().max())
    for r in range(B):
        check_token(f"lm rows row {r} token", got[6][r], ref[6][r], ref[5][r], tol)
    check_close("unfused route logits (bf16)", unfused(), ref[5])
    ms = time_ms(run, reps, flush)
    unfused_ms = time_ms(unfused, reps, flush)
    plain_ms = time_ms(plain, 2, flush)
    live = list(prefixes) if C > 1 else positions
    lin = model.params["lm_head"]
    nb = (stacked_bytes(stack) + nbytes(lm["ue"], lm["ues"], lm["fnorm"])
          + kv_history_bytes(cfg, live)
          + B * (2 * h * 2 + L * 2 * cfg.num_kv_heads * (cfg.head_dim + 4) + V * 4 + 4))
    fl = L * sum(decode_block_flops(cfg, p) for p in positions) + 2.0 * B * h * V
    b_ms, b_by = bound(nb, fl)
    log(f"    kernel {ms:.4f} ms  unfused route {unfused_ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"bound {b_ms:.4f} ms ({b_by}); lm_head {lin.out_features}x{lin.in_features}")
    return [dict(name="model_decode_mega_batch_lm", shape=f"{what} {L} layers + lm rows",
                 max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 unfused_ms=unfused_ms, bytes=nb, flops=fl)]


# ---------------------------------------------------------------------------
# phase 2: the tensor-parallel kernels (B5(e), B11), ranks as threads
# ---------------------------------------------------------------------------

TP = 2                      # tensor-parallel ranks of the 7B rows (g128 shards at tp = 2 only)
RING_TOL = 1e-4             # B11: each rank's f32 output within this x max|plain| (sum orders)


def tp_half_bytes(st, cfg_l, meta, positions, half, l=0):
    """Bytes one rank's half-layer launch must move: its shard's words and
    tables of the half's two linears, the norm, the f32 residual in (and the
    reduced partial, half 1), the residual and partial out, and in half 0
    its kv heads' live history and new rows."""
    keys = (("qkv", "qs", "qz", "o", "os", "oz", "n1") if half == 0 else
            ("gu", "gus", "guz", "d", "ds", "dz", "n2"))
    B, h = len(positions), cfg_l.hidden_size
    nb = sum(st[k][l].numel() * st[k].element_size() for k in keys if k in st)
    nb += B * h * 4 * (3 if half == 0 else 4)
    if half == 0:
        nb += (kv_history_bytes(dataclasses.replace(cfg_l, num_layers=1), positions)
               + B * 2 * cfg_l.num_kv_heads * (cfg_l.head_dim + 4))
    return nb


def tp_half_flops(cfg_l, positions, half):
    h, D = cfg_l.hidden_size, cfg_l.head_dim
    H, Hkv, I = cfg_l.num_heads, cfg_l.num_kv_heads, cfg_l.intermediate_size
    B = len(positions)
    if half == 1:
        return 2 * B * h * 2 * I + 2 * B * I * h
    return (2 * B * h * (H + 2 * Hkv) * D + 2 * B * H * D * h
            + sum(4 * D * H * (p + 1) for p in positions))


def check_mega_batch_tp(model, stack, meta, cfg, dev, flush, reps, positions, T=512, paged=False,
                        cut=2):
    """B5(e): the batched kernel's tensor-parallel mode at Llama-2-7B width
    over TP = 2 ranks (each rank 16 q heads, 16 kv heads, 5504 MLP columns),
    the ranks as threads of a LocalGroup on the one card: each rank launches
    its kernel on its shard, and the o_proj and down_proj partials are summed
    between the half-layers (a copy on the card where NCCL would sum them
    between cards). The dense row's state of check_mega_batch (B = 8), or
    with `paged` its state mirrored into a page pool (the (b) row's pool;
    the paged outputs bitwise equal to the dense TP outputs).

    Held: each rank's x_out over the first `cut` layers in bf16 within TOL
    of its plain version's (the same ranks and reductions on the plain
    path), its rows by `hold_rows` (layer 0 strict: one-code flips on at most
    0.1%, scales within SCALE_RTOL); at full depth layer 0's rows again and
    the scales within TOL; x_out the same bits on both ranks (every rank
    adds the same sums). Reported: x_out at full depth against the plain
    version and against the single-card batched kernel. Timed: one rank's
    launch alone, half 0 and half 1 of layer 0, beside the plain half."""
    import torch

    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.ops import model_fused as mf
    from mi_optimize_tpu_torch.ops.block_fused import layer_attn_ref, layer_mlp_ref
    from mi_optimize_tpu_torch.parallel import LocalGroup
    from mi_optimize_tpu_torch.parallel.sharding import cache_shard
    from mi_optimize_tpu_torch.serving.megadecode import stack_serving_tp

    name = "model_decode_mega_batch_tp"
    mode = "paged" if paged else "dense"
    L, B, h = cfg.num_layers, len(positions), cfg.hidden_size
    gen = torch.Generator(device=dev).manual_seed(8 + B)   # the dense row's state
    cache = random_slot_cache(cfg, positions, T, dev, gen)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device=dev)
    x = llama.embed(model.params, toks)
    cos, sin = llama.rope_tables(cfg, torch.tensor(positions, device=dev)[:, None])
    cos, sin = cos.reshape(B, -1), sin.reshape(B, -1)
    shards = [stack_serving_tp(model, TP, r) for r in range(TP)]
    if any(s is None or s[1] != meta for s in shards):
        raise AssertionError("the 7B model should shard over 2 ranks with the same meta")
    cfg_l = shards[0][2]
    dense_caches = [cache_shard(cache, r, TP) for r in range(TP)]
    table = None
    if paged:
        pool, table = mirror_pool(cache, torch.Generator(device=dev).manual_seed(12))
        caches = [cache_shard(pool, r, TP) for r in range(TP)]
        del pool
    else:
        caches = dense_caches
    log(f"  {name}: {mode}, TP={TP} ranks as threads, each {cfg_l.num_heads} q heads, "
        f"{cfg_l.num_kv_heads} kv heads, {cfg_l.intermediate_size} MLP columns; B={B}, "
        f"{L} layers, positions {positions}")

    def run(stacks, cs, c, xx, plain=False, tbl=table):
        def rank(g):
            st, ca = stacks[g.rank], cs[g.rank]
            if plain:
                return mf.model_decode_mega_batch_ref(st, xx, cos, sin, ca, positions,
                                                      mf.tp_config(st, ca, c, meta), meta, tbl,
                                                      group=g)
            return mf.model_decode_mega_batch(st, xx, cos, sin, ca, positions, c, meta,
                                              table=tbl, tp=TP, group=g)
        out = LocalGroup(TP).run(rank)
        torch.cuda.synchronize()
        return out

    stacks = [s[0] for s in shards]
    before = mf.launches_tp
    got = run(stacks, caches, cfg, x)
    if x.is_cuda and mf.launches_tp - before != 2 * L * TP:
        raise AssertionError(f"{name}: {mf.launches_tp - before} launches, expected {2 * L * TP}")
    same = torch.equal(got[0][0], got[1][0])
    log(f"  {name}: x_out of the two ranks {'the same bits -> ok' if same else 'DIFFER -> FAIL'}")
    if not same:
        raise AssertionError(f"{name}: the ranks' x_out differ")
    extra = {}
    if paged:
        dense = run(stacks, dense_caches, cfg, x, tbl=None)
        bitwise = all(torch.equal(a, b) for r in range(TP) for a, b in zip(got[r], dense[r]))
        log(f"  {name} paged vs dense on the mirrored state: "
            f"{'bitwise equal -> ok' if bitwise else 'DIFFER -> FAIL'}")
        if not bitwise:
            raise AssertionError(f"{name}: the paged mode differs from the dense one")
        extra["bitwise_equal_dense"] = bitwise
        del dense
    else:
        single = mf.model_decode_mega_batch(stack, x, cos, sin, cache, positions, cfg, meta)
        torch.cuda.synchronize()
        e, s = max_err(got[0][0], single[0])
        extra["x_out_vs_single_card_rel"] = e / s
        log(f"  {name} x_out (bf16, all {L} layers, reported) against the single-card batched "
            f"kernel: max|diff| {e:.3e} = {e / s:.2e} of max")
        del single
    del cache
    ref = run(stacks, caches, cfg, x, plain=True)
    e, s = max_err(got[0][0], ref[0][0])
    extra["bf16_full_depth_x_out_rel"] = e / s
    log(f"  {name} x_out (bf16, all {L} layers, reported): max|diff| {e:.3e} = {e / s:.2e} of "
        f"max|plain|")
    for r in range(TP):
        for i, f in ((1, "k"), (2, "v")):
            st = extra[f"rank{r}_bf16_{f}_codes"] = code_diff(
                f"{name} rank {r} new {f} rows (bf16)", got[r][i], ref[r][i])
            if st[0] > 1 or st[1] > 1e-3:
                raise AssertionError(f"{name}: rank {r}'s layer-0 int8 rows disagree")
            check_close(f"{name} rank {r} new {f} scales (bf16)", got[r][i + 2], ref[r][i + 2])
    del got, ref
    c2 = dataclasses.replace(cfg, num_layers=cut)
    head = [{k: v[:cut] for k, v in st.items()} for st in stacks]
    chead = [{k: v[:cut] for k, v in ca.items()} for ca in caches]
    got, ref = run(head, chead, c2, x), run(head, chead, c2, x, plain=True)
    err = 0.0
    for r in range(TP):
        e_r, extra[f"rank{r}_bf16_{cut}_layers"] = hold_rows(
            f"{name} rank {r}", got[r], ref[r], TOL, f"bf16, first {cut} layers", strict=1)
        err = max(err, e_r)
    del got, ref, head, chead

    # one rank's launch alone: half 0 and half 1 of layer 0, beside the plain half
    st0, c0 = stacks[0], caches[0]
    prep = mf.tp_prepare(st0, x, cos, sin, c0, positions, cfg_l, meta, table)
    x32 = x.reshape(B, h).float().contiguous()
    res0, part0 = (t.clone() for t in mf.tp_launch(prep, 0, 0, x32, None))
    lin, tabs = mf._layer(st0, meta, 0)
    tbl = None if table is None else torch.as_tensor(table)
    hist = [mf._history(c0, 0, b, tbl, p) for b, p in enumerate(positions)]
    cf, sf = cos.float(), sin.float()
    halves = (
        ("q/k/v, attention, o_proj partial", lambda: mf.tp_launch(prep, 0, 0, x32, None),
         lambda: layer_attn_ref(x32, x.dtype, lin, tabs, st0["n1"][0], cf, sf, hist, positions,
                                cfg_l)),
        ("gate/up, down_proj partial", lambda: mf.tp_launch(prep, 0, 1, res0, part0),
         lambda: layer_mlp_ref(res0 + part0, x.dtype, lin, tabs, st0["n2"][0], cfg_l)))
    rows = []
    for half, (what, kern, plain) in enumerate(halves):
        ms = time_ms(kern, reps, flush)
        plain_ms = time_ms(plain, 2, flush)
        nb, fl = tp_half_bytes(st0, cfg_l, meta, positions, half), tp_half_flops(cfg_l, positions,
                                                                              half)
        b_ms, b_by = bound(nb, fl)
        log(f"    rank 0 half {half} ({what}) alone: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"bound {b_ms:.4f} ms ({b_by}, {nb / 1e6:.1f} MB)")
        rows.append(dict(name=name, shape=f"rank 0 of {TP}, half {half} of layer 0 ({what}), "
                         f"{mode} B={B} positions {positions}", max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=nb, flops=fl,
                         codes=extra))
    return rows


def check_ring(model, cfg, dev, flush, reps):
    """B11: the overlapped row-parallel dequant matmul on the 7B layer 0's
    own int4 g128 words: o_proj (4096 -> 4096) at D = 2 and 4, down_proj
    (11008 -> 4096) at D = 2, each at M = 8 (the "gemv" route), 128 (inside
    path t's prompts of 16-256 tokens) and 2048 rows (the "mma" route) of
    bf16 x; the D ranks as threads of a LocalGroup (the ring's transfers
    copies on the card). Held: every rank's f32 output within RING_TOL of
    the plain version's (the sum over the ranks of ring_chunk_ref over its K
    slice). Timed: one ring window alone (rank 0's first window of step 1,
    with the received partial as its addend), beside its plain version and
    beside the CUDA-core tiles on the same inputs (route "cuda_core");
    bound: the window's x slice, words, scale and zero tables, addend and
    output, read or written once, and its multiply-adds at the bf16 tensor
    peak (x and the codes are exact bf16 operands, so the same f32 sums run
    on the tensor cores; f32 x would take the f32 peak)."""
    import torch

    from mi_optimize_tpu_torch.models.quant_linear import group_size
    from mi_optimize_tpu_torch.ops.dequant_matmul import zero_tables
    from mi_optimize_tpu_torch.parallel import LocalGroup
    from mi_optimize_tpu_torch.parallel import overlap

    blk = model.params["layers"][0]
    gen = torch.Generator(device=dev).manual_seed(19)
    rows = []
    for lname, D in (("o_proj", 2), ("o_proj", 4), ("down_proj", 2)):
        lin = blk[lname]
        K, N, g = lin.in_features, lin.out_features, group_size(lin)
        st, zt = zero_tables(lin)
        kl = K // D
        nc = N // D
        w = nc // overlap.PARTS
        shard = [(lin.packed[r * kl // 8:(r + 1) * kl // 8], st[r * kl // g:(r + 1) * kl // g],
                  zt[r * kl // g:(r + 1) * kl // g]) for r in range(D)]
        for M in (8, 128, 2048):
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            xs = [x[:, r * kl:(r + 1) * kl].contiguous() for r in range(D)]
            route = overlap.ring_route(M, x.dtype, 4, g, w)
            before = (overlap.launches, getattr(overlap, f"launches_{route}"))
            got = LocalGroup(D).run(lambda g_: overlap.ring_matmul(
                xs[g_.rank], *shard[g_.rank], g_, bits=4, group=g))
            torch.cuda.synchronize()
            n = D * D * overlap.PARTS
            if x.is_cuda and (overlap.launches - before[0],
                              getattr(overlap, f"launches_{route}") - before[1]) != (n, n):
                raise AssertionError(f"ring_chunk: {overlap.launches - before[0]} launches, "
                                     f"expected {n} on the {route!r} route")
            plain = sum(overlap.ring_chunk_ref(xs[r], *shard[r], None, 4, g, 0, N)
                        for r in range(D))
            err = max(max_err(y, plain)[0] for y in got)
            what = f"{lname} {K}->{N} D={D} M={M}"
            check_close(f"ring_chunk {what} ({route}, every rank, f32)", torch.stack(got),
                        plain.expand(D, M, N), RING_TOL)
            add = torch.randn(M, w, generator=gen, device=dev)
            c = 1 % D  # rank 0's chunk at step 0; step 1's window adds the received partial
            args = (xs[0], *shard[0], add, 4, g, c * nc, w)
            ref = overlap.ring_chunk_ref(*args)
            core_err = max_err(overlap.ring_chunk(*args, route="cuda_core"), ref)
            ms = time_ms(lambda: overlap.ring_chunk(*args), reps, flush)
            core_ms = time_ms(lambda: overlap.ring_chunk(*args, route="cuda_core"), reps, flush)
            plain_ms = time_ms(lambda: overlap.ring_chunk_ref(*args), 2, flush)
            nb = M * kl * 2 + (kl // 8) * w * 4 + 2 * (kl // g) * w * 4 + 2 * M * w * 4
            fl = 2 * M * kl * w
            b_ms, b_by = bound(nb, fl, BF16_FLOPS)
            log(f"    window [{M}, {w}] of K {kl} alone ({route}): kernel {ms:.4f} ms  the CUDA-core "
                f"tiles {core_ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms "
                f"({b_by}); rank outputs within {err / float(plain.abs().max()):.2e} of "
                f"max|plain| (the CUDA-core tiles' window {core_err[0] / core_err[1]:.2e})")
            rows.append(dict(name="ring_chunk", shape=f"{what}: window [{M}, {w}] over K {kl}",
                             max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, bytes=nb, flops=fl, cuda_core_ms=core_ms,
                             codes={"route": route, "rel_err": err / float(plain.abs().max()),
                                    "cuda_core_window_rel_err": core_err[0] / core_err[1]}))
            del x, xs, got, plain
    return rows


def check_flat_seg(name, model, fstack, fmeta, cfg, dev, flush, reps, kseg=5, T=384, pos0=200):
    """The multi-token flat decode (B10): kseg greedy tokens in one launch on
    the flat stack, over a random int8 history of pos0 rows. A second launch
    gives the same bits, and with 4-bit words (the tensor-core layer loop)
    so do kseg launches of model_decode_flat with each token's rows
    scattered into a copy of the cache before the next. Token t is held to
    the plain version's (equal unless the plain top-2 gap is below the
    tolerance; after such a flip the later tokens are no longer comparable
    and only reported), and the dequantized k/v rows of the comparable
    tokens within TOL. Timed against kseg launches of model_decode_flat on
    the same tokens (the per-token route). Bound: kseg x the flat kernel's
    bytes."""
    import torch

    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.ops import model_flat as mfl
    from mi_optimize_tpu_torch.ops import model_flat_seg as mfs
    from mi_optimize_tpu_torch.serving.flatdecode import stack_cache_flat

    gen = torch.Generator(device=dev).manual_seed(40 + cfg.num_layers)
    cache = stack_cache_flat([random_int8_cache(cfg, T, pos0, dev, gen)
                              for _ in range(cfg.num_layers)])
    x = llama.embed(model.params, torch.tensor([[7]], device=dev))
    cos, sin = llama.rope_tables(cfg, pos0 + torch.arange(kseg, device=dev))
    cossin = torch.cat([cos, sin], -1)
    emb = model.params["embed"]
    args = (fstack, emb, x, cossin, cache, pos0, cfg, fmeta, kseg)
    log(f"  model_decode_flat_seg: {name}, {cfg.num_layers} layers + lm_head, kseg={kseg}, "
        f"T={T}, pos0={pos0}")
    got, got2 = mfs.model_decode_flat_seg(*args), mfs.model_decode_flat_seg(*args)
    ref = mfs.model_decode_flat_seg_ref(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, got2)):
        raise AssertionError("model_decode_flat_seg: two launches on the same inputs differ")
    if fmeta[0] == 4:
        work = {f: cache[f].clone() for f in cache}
        xc, chain = x, ([], [], [])
        for t in range(kseg):
            tok, _, kv, sc = mfl.model_decode_flat(fstack, xc, cossin[t], work, pos0 + t, cfg,
                                                   fmeta)
            work["kv"][:, pos0 + t], work["kv_scale"][:, pos0 + t] = kv, sc[:, :, 0]
            for c, v in zip(chain, (tok, kv, sc[:, :, 0])):
                c.append(v)
            xc = emb[tok.long()].reshape(x.shape)
        if not all(torch.equal(g, torch.cat(c) if i == 0 else torch.stack(c))
                   for i, (g, c) in enumerate(zip(got, chain))):
            raise AssertionError(f"model_decode_flat_seg: not the bits of {kseg} "
                                 "model_decode_flat launches")
        del work
        log(f"    the same bits twice, and those of {kseg} model_decode_flat launches")
    # the plain version's logits of each token, for the tolerance of its gap
    work = {f: cache[f].clone() for f in cache}
    xr, n_ok = x, 0
    err = 0.0
    for t in range(kseg):
        _, logits, kv, sc = mfl.model_decode_flat_ref(fstack, xr, cossin[t], work, pos0 + t, cfg,
                                                      fmeta)
        check_token(f"model_decode_flat_seg token {t}", got[0][t], ref[0][t], logits,
                    TOL * float(logits.abs().max()))
        err = max(err, check_close(f"model_decode_flat_seg token {t} k/v rows (dequantized)",
                                   got[1][t].float() * got[2][t][..., None],
                                   ref[1][t].float() * ref[2][t][..., None]))
        n_ok += 1
        if int(got[0][t]) != int(ref[0][t]):
            log(f"  tokens after {t} follow different inputs: reported only")
            break
        work["kv"][:, pos0 + t], work["kv_scale"][:, pos0 + t] = kv, sc[:, :, 0]
        xr = emb[ref[0][t].long()].reshape(x.shape)
    toks = [int(t) for t in ref[0].tolist()]

    def per_token():
        xx = x
        for t in range(kseg):
            tok, _, _, _ = mfl.model_decode_flat(fstack, xx, cossin[t], cache, pos0 + t, cfg,
                                                 fmeta)
            xx = emb[toks[t]:toks[t] + 1][None]

    ms = time_ms(lambda: mfs.model_decode_flat_seg(*args), reps, flush)
    per_token_ms = time_ms(per_token, reps, flush)
    plain_ms = time_ms(lambda: mfs.model_decode_flat_seg_ref(*args), 1, flush)
    flat_nb = nbytes(*(v for k, v in fstack.items())) + cfg.num_layers * 2 * pos0 * \
        cfg.num_kv_heads * (cfg.head_dim + 4) + fmeta[-1] * 4
    nb = kseg * flat_nb
    fl = kseg * (cfg.num_layers * decode_block_flops(cfg, pos0) + 2.0 * cfg.hidden_size * fmeta[-1])
    b_ms, b_by = bound(nb, fl)
    log(f"    kernel {ms:.4f} ms ({ms / kseg:.4f} ms a token)  {kseg} x model_decode_flat "
        f"{per_token_ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}); "
        f"{n_ok} of {kseg} tokens compared")
    return [dict(name="model_decode_flat_seg", shape=f"{name}, {cfg.num_layers} layers + lm_head "
                 f"kseg={kseg} T={T} pos0={pos0}", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=b_ms, bound_by=b_by, per_token_flat_ms=per_token_ms, bytes=nb,
                 flops=fl)]


def check_paged_attention(cfg, dev, flush, reps, positions=(37, 200, 333, 511), P=16, pps=32):
    """The paged flash decode (B8) at one layer of `cfg` as PagedBatcher
    calls it: q in bf16 over an f32 pool, and in float32 (held within 1e-4
    of max|plain|); the same bits on a second launch. The library yardstick
    is F.scaled_dot_product_attention with a boolean mask over the pool
    already gathered into [B, H, T, D] (the gather is not timed); the port
    never calls it. The bound counts the live rows' k and v once, for every
    q head of their kv head."""
    import torch
    import torch.nn.functional as F

    from mi_optimize_tpu_torch.ops import paged_attention as pa

    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, T = len(positions), P * pps
    n_pages = 1 + B * pps
    gen = torch.Generator(device=dev).manual_seed(14)
    q32 = torch.randn(B, H * D, generator=gen, device=dev)
    pk = torch.randn(n_pages, P, Hkv, D, generator=gen, device=dev)
    pv = torch.randn(n_pages, P, Hkv, D, generator=gen, device=dev)
    table = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:B * pps] + 1).reshape(
        B, pps).int().cpu()
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=D, page_size=P)
    heads = f"H={H}" if Hkv == H else f"H={H} Hkv={Hkv}"
    log(f"  paged_flash_attention: B={B}, {heads}, D={D}, pages of {P}, {pps} a slot, "
        f"positions {list(positions)}, f32 pool")
    check_close("paged_flash_attention (f32 q)",
                pa.paged_flash_attention(q32, pk, pv, table, positions, **kw),
                pa.paged_flash_attention_ref(q32, pk, pv, table, positions, **kw), 1e-4)
    q = q32.to(torch.bfloat16)
    # as paged_decode_step calls it: table and positions checked and copied once a step
    tdev, pdev = (t.to(dev) for t in pa.check_table(table, positions, B, n_pages, P))
    run = lambda: pa.paged_flash_attention(q, pk, pv, tdev, pdev, **kw)
    plain = lambda: pa.paged_flash_attention_ref(q, pk, pv, table, positions, **kw)
    got, ref = run(), plain()
    torch.cuda.synchronize()
    err = check_close("paged_flash_attention (bf16 q)", got, ref)
    if not torch.equal(got, run()):
        raise AssertionError("paged_flash_attention: a second launch gave other bits")
    log("  paged_flash_attention: the same bits on a second launch")
    # the library yardstick on the pre-gathered view
    reps_h = H // Hkv
    pages = table.to(dev).long()
    kv_view = [pp[pages].reshape(B, T, Hkv, D).repeat_interleave(reps_h, 2).transpose(1, 2)
               .contiguous() for pp in (pk, pv)]
    mask = (torch.arange(T, device=dev)[None, :] <= torch.tensor(positions, device=dev)[:, None])
    mask = mask[:, None, None, :]
    qv = q32.reshape(B, H, 1, D)
    lib = lambda: F.scaled_dot_product_attention(qv, *kv_view, attn_mask=mask)
    lib_err = check_close("  F.scaled_dot_product_attention (pre-gathered, f32)",
                          lib().reshape(B, H * D),
                          pa.paged_flash_attention_ref(q32, pk, pv, table, positions, **kw), 1e-4)
    ms = time_ms(run, reps, flush)
    plain_ms = time_ms(plain, max(2, reps // 10), flush)
    lib_ms = time_ms(lib, reps, flush)
    live = sum(p + 1 for p in positions)
    nb = live * Hkv * D * 4 * 2 + 2 * B * H * D * 2 + table.numel() * 4
    fl = 4.0 * live * H * D
    b_ms, b_by = bound(nb, fl)
    log(f"    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library {lib_ms:.4f} ms "
        f"(pre-gathered SDPA)  bound {b_ms:.4f} ms ({b_by})")
    return [dict(name="paged_flash_attention", shape=f"B={B} {heads} P={P} pps={pps} positions "
                 f"{list(positions)} bf16 q, f32 pool", max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                 library_max_abs_err=lib_err, bytes=nb, flops=fl)]


def check_decode_attention(cfg, dev, flush, reps, cases=((384, 200), (2048, 2047))):
    """The decode attention (B6) at one layer of `cfg`: bf16 q/k/v rows over
    an int8 cache whose rows t < pos are live, at each (T, pos) of `cases`.
    The new row's codes and scales must be bit-equal to the plain version's;
    the f32 output is held within F32_TOL of max|plain|; a second launch over
    a fresh copy of the cache must give the same bits (output and cache).
    The library yardstick is F.scaled_dot_product_attention over the history
    already dequantized to f32 (the new row included), as the paged flash
    decode's row has it. Beside the kernel, `torch.sum` over a tensor of the
    row's bytes after the same L2 flush: the floor of a plain read of those
    bytes under this timing."""
    import torch
    import torch.nn.functional as F

    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.ops import decode_attention as da

    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    heads = f"H={H}" if Hkv == H else f"H={H} Hkv={Hkv}"
    gen = torch.Generator(device=dev).manual_seed(12)
    rows = []
    for T, pos in cases:
        q, k, v = (torch.randn(1, n * D, generator=gen, device=dev).to(torch.bfloat16)
                   for n in (H, Hkv, Hkv))
        c = random_int8_cache(cfg, T, pos, dev, gen)
        cache = [c[f][0] for f in ("k", "v", "k_scale", "v_scale")]
        cos, sin = (t.reshape(-1) for t in llama.rope_tables(cfg, torch.tensor([pos],
                                                                               device=dev)))
        kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=D, max_len=T)
        mine = [t.clone() for t in cache]
        plain_c = [t.clone() for t in cache]
        again = [t.clone() for t in cache]
        run = lambda: da.fused_decode_attention(q, k, v, cos, sin, *mine, pos, **kw)[0]
        plain = lambda: da.fused_decode_attention_ref(q, k, v, cos, sin, *plain_c, pos, **kw)[0]
        got, ref = run(), plain()
        torch.cuda.synchronize()
        what = f"decode_attention {heads} T={T} pos={pos}"
        same = [bool(torch.equal(a, b)) for a, b in zip(mine, plain_c)]
        log(f"  {what}: new k/v codes and scales bit-equal: {same}")
        if not all(same):
            raise AssertionError(f"{what}: codes or scales differ from the plain version's")
        err = check_close(what, got, ref, F32_TOL)
        got2 = da.fused_decode_attention(q, k, v, cos, sin, *again, pos, **kw)[0]
        if not (torch.equal(got, got2) and all(torch.equal(a, b) for a, b in zip(mine, again))):
            raise AssertionError(f"{what}: a second launch gave other bits")
        log(f"  {what}: the same bits on a second launch")
        n = pos + 1
        kd = (mine[0][:n].float() * mine[2][:n, :, None]).transpose(0, 1)[None].contiguous()
        vd = (mine[1][:n].float() * mine[3][:n, :, None]).transpose(0, 1)[None].contiguous()
        if H != Hkv:
            kd, vd = (t.repeat_interleave(H // Hkv, 1) for t in (kd, vd))
        qr = da._rope_rows(q.reshape(H, D).float(), cos, sin).reshape(1, H, 1, D)
        lib = lambda: F.scaled_dot_product_attention(qr, kd, vd)
        lib_err = check_close("  F.scaled_dot_product_attention (pre-dequantized, f32)",
                              lib().reshape(1, H * D), ref, F32_TOL)
        nb = n * Hkv * D * 2 + n * Hkv * 4 * 2 + nbytes(q, k, v) + H * D * 4
        flat = torch.zeros(-(-nb // 4), dtype=torch.float32, device=dev)
        ms = time_ms(run, reps, flush)
        plain_ms = time_ms(plain, max(2, reps // 10), flush)
        lib_ms = time_ms(lib, reps, flush)
        sum_ms = time_ms(lambda: flat.sum(), reps, flush)
        del kd, vd, flat
        fl = 4.0 * n * H * D
        b_ms, b_by = bound(nb, fl)
        log(f"    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library {lib_ms:.4f} ms "
            f"(pre-dequantized SDPA)  torch.sum over the same bytes {sum_ms:.4f} ms  bound "
            f"{b_ms:.4f} ms ({b_by}), {nb / 1e6:.3f} MB")
        shape = f"H={H} Hkv={Hkv} D={D} T={T} pos={pos} bf16 rows, int8 cache"
        rows.append(dict(name="decode_attention", shape=shape, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         library_max_abs_err=lib_err, sum_ms=sum_ms, bytes=nb, flops=fl,
                         codes="bit-equal"))
    return rows


def mlp_bytes(lins, M, dtype_bytes=2) -> int:
    """Bytes the fused MLP must move: the packed words and the (scale, zero)
    tables of gate, up and down, x and y."""
    from mi_optimize_tpu_torch.ops.dequant_matmul import zero_tables

    K = lins[0].in_features
    return (sum(nbytes(l.packed, *zero_tables(l)) for l in lins)
            + M * K * dtype_bytes * 2)


def kernel_ms_by_name(run, reps=3) -> dict:
    """Device ms a call of `run` spends in each kernel, by name: torch.profiler
    over `reps` calls (warm L2), divided by reps."""
    import torch

    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def check_mlp_fused(blk, cfg, dev, flush, reps, Ms=(1, 128, 2048)):
    """The fused MLP (B7) on the unfused 7B model's layer 0, bf16 x, held
    within TOL of max|plain| and timed against its plain version and
    against the unfused route (gate and up through dequant_matmul, SiLU *
    up, down through dequant_matmul) and against PR 5's CUDA-core kernels on
    the same inputs (`kernel="cuda_core"`: the parent's B7). Prints the instance each M takes
    and, for the two-launch "mma" route, the split of its time between P1
    (gate/up) and P2 (down) from torch.profiler. No single PyTorch call
    computes it: library_ms is null."""
    import torch

    from mi_optimize_tpu_torch.models.quant_linear import group_size
    from mi_optimize_tpu_torch.ops import mlp_fused as mf
    from mi_optimize_tpu_torch.ops.coop_plan import sm_count
    from mi_optimize_tpu_torch.ops.dequant_matmul import dequant_matmul, kernel_tables, zero_tables

    lins = (blk["gate_proj"], blk["up_proj"], blk["down_proj"])
    if not mf.mlp_supported(*lins, cfg.hidden_size, cfg.intermediate_size):
        raise AssertionError("the 7B MLP should meet the fused MLP's routing predicate")
    tabs = [t for l in lins for t in (l.packed, *zero_tables(l))]
    K, I = cfg.hidden_size, cfg.intermediate_size
    gk, ik = group_size(lins[0]), group_size(lins[2])
    kw = dict(bits=4, k_group=gk, i_group=ik, qmin=0, inter=I, hidden=K)
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = []
    for M in Ms:
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        run = lambda: mf.mlp_apply_fused(x, *lins, cfg)
        plain = lambda: mf.fused_mlp_ref(x, *tabs, **kw)
        unfused = lambda: dequant_matmul(torch.nn.functional.silu(dequant_matmul(x, lins[0]))
                                         * dequant_matmul(x, lins[1]), lins[2])
        r = mf.route(M, x.dtype, 4, gk, ik)
        if r == "gemv":
            s1, s2 = mf.gemv_plans(M, K, I, K, gk, ik, mf.COOP_PER_SM * sm_count(dev))
            inst = (f"gemv: one cooperative mlp_gemv_mma_kernel, {s1} splits of K in P1, "
                    f"{s2} of I in P2")
        elif r == "mma":
            big, splits = mf.mma_plan(M, K, I, ik, sm_count(dev))
            inst = (f"mma: P1 + P2 mlp_mma_kernel, [{mf.MMA_TILES[big][0]}, 128] tiles, "
                    f"{splits} split(s) of I in P2")
        else:
            raise AssertionError(f"the bf16 int4 MLP took the {r} route")
        before = getattr(mf, mf.COUNTERS[r])
        got, ref = run(), plain()
        torch.cuda.synchronize()
        if getattr(mf, mf.COUNTERS[r]) != before + 1:
            raise AssertionError(f"mlp_fused M={M} did not launch its {r} kernels")
        err = check_close(f"mlp_fused M={M} ({inst})", got, ref)
        check_close(f"  unfused route M={M}", unfused(), ref)
        ms = time_ms(run, reps, flush)
        plain_ms = time_ms(plain, max(2, reps // 10), flush)
        unfused_ms = time_ms(unfused, reps, flush)
        biases = tuple(kernel_tables(l)[1] for l in lins)
        cuda_core = lambda: mf.fused_mlp(x, *tabs, **kw, biases=biases, kernel="cuda_core")
        check_close(f"  the CUDA-core kernels (PR 5's) M={M}", cuda_core(), ref)
        cuda_core_ms = time_ms(cuda_core, max(2, reps // 2), flush)
        by_name = kernel_ms_by_name(run)
        phases = {"P1": sum(v for k, v in by_name.items() if "mlp_mma_kernel" in k and
                            "true>" in k),
                  "P2": sum(v for k, v in by_name.items() if "mlp_mma_kernel" in k and
                            "false>" in k)} if r == "mma" else None
        nb = mlp_bytes(lins, M)
        fl = 2.0 * M * I * (2 * K + K)
        b_ms, b_by = bound(nb, fl)
        log(f"    kernel {ms:.4f} ms  PR 5's CUDA-core kernels {cuda_core_ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  unfused route {unfused_ms:.4f} ms  library none  bound "
            f"{b_ms:.4f} ms ({b_by}), {nb / 1e6:.2f} MB, {fl / 1e9:.2f} GFLOP")
        log("    profiler (warm L2): " + (f"P1 {phases['P1']:.4f} ms, P2 {phases['P2']:.4f} ms"
                                          if phases else
                                          f"{sum(by_name.values()):.4f} ms in one launch"))
        rows.append(dict(name="mlp_fused", shape=f"M={M} K={K} I={I} int4 g128 bf16",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, unfused_ms=unfused_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None, bytes=nb, flops=fl,
                         instance=inst, phase_ms=phases, cuda_core_ms=cuda_core_ms))
    return rows


def per_channel_linear(out_f, in_f, dev, seed):
    """A packed int4 per-channel linear (symmetric grid) made on the card."""
    import torch

    from mi_optimize_tpu_torch.core import packing, qparams
    from mi_optimize_tpu_torch.core.qparams import qrange
    from mi_optimize_tpu_torch.models.quant_linear import QuantizedLinear, QuantSpec

    w = torch.randn(out_f, in_f, generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev) * in_f ** -0.5
    fake, scale, zero = qparams.quantize_dequantize(w, 4, "per_channel")
    ints = qparams.quantize_to_int(fake, scale, zero, 4, "per_channel")
    return QuantizedLinear(spec=QuantSpec(wbit=4, w_qtype="per_channel", w_packed=True),
                           out_features=out_f, in_features=in_f,
                           packed=packing.pack_weight_device(ints, 4, qrange(4, True)),
                           w_scale=scale, w_zero=zero)


def check_w4a8(blk, cfg, dev, flush, reps):
    """The W4A8 integer product (B9) at M = 128 on the unfused 7B model's q,
    gate and down projections (per group, g128) and on a per-channel gate,
    and at M = 2048 (one compute_ppl batch) on q, down and the per-channel
    gate: held bit for bit to the plain version (both sum each group
    exactly, the plain version in float64, and add the scaled group sums in
    order). The library yardstick, for the per-channel rows only (one group:
    one integer product), is torch._int_mm on the weights pre-unpacked to
    int8 (q - z), then the scales."""
    import torch

    from mi_optimize_tpu_torch.core.packing import unpack_words
    from mi_optimize_tpu_torch.models.quant_linear import group_size
    from mi_optimize_tpu_torch.ops import w4a8_matmul as w4
    from mi_optimize_tpu_torch.ops.dequant_matmul import zero_tables

    gen = torch.Generator(device=dev).manual_seed(14)
    cases = [(128, "q_proj", blk["q_proj"]), (128, "gate_proj", blk["gate_proj"]),
             (128, "down_proj", blk["down_proj"]),
             (128, "gate_proj per_channel", per_channel_linear(cfg.intermediate_size,
                                                               cfg.hidden_size, dev, 15)),
             (2048, "q_proj", blk["q_proj"]), (2048, "down_proj", blk["down_proj"])]
    cases.append((2048, "gate_proj per_channel", cases[3][2]))
    rows = []
    for M, name, lin in cases:
        K, N = lin.in_features, lin.out_features
        g = group_size(lin) if lin.spec.w_qtype == "per_group" else -1
        st, zt = zero_tables(lin)
        x = torch.randn(M, K, generator=gen, device=dev)
        xi, _ = w4.quantize_activations(x, "per_token")
        kw = dict(bits=4, groupsize=g, qmin=0)
        run = lambda: w4.w4a8_matmul_int(xi, lin.packed, st, zt, **kw)
        plain = lambda: w4.w4a8_matmul_int_ref(xi, lin.packed, st, zt, **kw)
        got, ref = run(), plain()
        torch.cuda.synchronize()
        what = f"w4a8_matmul {name} M={M} [{K}->{N}]"
        err = check_close(what, got, ref, 1e-5)
        same = torch.equal(got, ref)
        log(f"    bit-equal to the plain version: {same} -> {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"{what}: the integer product is not bit-equal to its plain "
                                 "version")
        lib_ms = lib_err = None
        if g < 0:
            # [K, N] int8 in column-major order, the layout of cuBLASLt's int8 product
            w8 = (unpack_words(lin.packed, 4) - zt.to(torch.int32)).to(torch.int8).t()
            w8 = w8.contiguous().t()
            lib = lambda: torch._int_mm(xi, w8).float() * st
            lib_err = check_close("  torch._int_mm then the scales", lib(), ref, 1e-5)
            lib_ms = time_ms(lib, reps, flush)
        ms = time_ms(run, reps, flush)
        plain_ms = time_ms(plain, max(2, reps // 10), flush)
        nb = nbytes(xi, lin.packed, st, zt) + M * N * 4
        fl = 2.0 * M * N * K
        b_ms, b_by = bound(nb, fl, INT8_OPS)
        log(f"    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound {b_ms:.4f} ms ({b_by})")
        rows.append(dict(name="w4a8_matmul", shape=f"{name} M={M} K={K} N={N} "
                         f"{'g128' if g > 0 else 'per_channel'}", max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         library_max_abs_err=lib_err, bytes=nb, flops=fl, codes="bit-equal"))
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path at full width and depth
# ---------------------------------------------------------------------------

def serve_main_path(model, fstack, fmeta, cfg, dev, n_flat=128):
    import torch

    from mi_optimize_tpu_torch.serving import engine
    from mi_optimize_tpu_torch.serving.flatdecode import decode_loop_flat, stack_cache_flat

    res = {"requests": []}
    gen = torch.Generator().manual_seed(4)
    for S in (17, 64, 128):
        prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=gen).numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.generate(model, prompt, max_new_tokens=16, cache_dtype=torch.int8)
        dt = time.perf_counter() - t0
        new = out[0, S:]
        if out.shape != (1, S + 16) or not ((new >= 0) & (new < cfg.vocab_size)).all():
            raise AssertionError(f"generate returned {out.shape} / out-of-range tokens")
        log(f"  request prompt={S} new=16: {dt * 1e3:.1f} ms, tokens {new.tolist()}")
        res["requests"].append({"prompt": S, "new": 16, "ms": dt * 1e3,
                                "tokens": new.tolist()})

    S = 128
    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=gen).to(dev)
    total = -(-(S + n_flat + 4) // 128) * 128
    cache = engine.init_cache(cfg, 1, total, torch.int8, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = engine.prefill(model.params, cfg, prompt, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(logits).all()) or logits.shape != (1, cfg.vocab_size):
        raise AssertionError("prefill logits are not finite / of the expected shape")
    tok = torch.argmax(logits, -1)[:, None]
    fcache = stack_cache_flat(cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, _ = decode_loop_flat(model.params, fstack, fmeta, cfg, tok, fcache, S, n_flat)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    if toks.shape != (1, n_flat) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("decode_loop_flat returned out-of-range tokens")
    # the same prefill's per-layer cache through engine.decode_loop: one
    # block_decode_mega launch per layer and the lm_head through dequant_matmul
    n_blk = 32
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    btoks, _ = engine.decode_loop(model.params, cfg, tok, cache, S, n_blk)
    torch.cuda.synchronize()
    blk_s = time.perf_counter() - t0
    k = min(n_blk, n_flat)
    same = int((btoks[0, :k] == toks[0, :k]).cumprod(0).sum())
    res.update(prefill_tokens=S, prefill_ms=prefill_ms, flat_tokens=n_flat,
               flat_ms_per_token=dec_s * 1e3 / n_flat, flat_tokens_per_s=n_flat / dec_s,
               flat_first_tokens=toks[0, :16].tolist(), block_tokens=n_blk,
               block_ms_per_token=blk_s * 1e3 / n_blk, block_tokens_per_s=n_blk / blk_s,
               block_flat_common_prefix=same)
    log(f"  prefill {S} tokens: {prefill_ms:.1f} ms")
    log(f"  decode_loop_flat {n_flat} tokens: {dec_s * 1e3 / n_flat:.3f} ms/token, "
        f"{n_flat / dec_s:.1f} tokens/s")
    log(f"  decode_loop (block_decode_mega) {n_blk} tokens: {blk_s * 1e3 / n_blk:.3f} "
        f"ms/token, {n_blk / blk_s:.1f} tokens/s; greedy tokens agree with the flat "
        f"path on the first {same}")
    return res


def serve_batcher(model, cfg, n_req=24, n_slots=8, max_len=512, n_compare=2, make=None,
                  name="ContinuousBatcher"):
    """n_req requests arrive at once; prompt lengths uniform in 16-256 (seed
    9), 32 or 64 new tokens in turn, so slots free at different steps and
    the queue's requests join between steps while others decode. Latency of
    a request = its last token's time since the burst arrived. Steps are
    host-timed; each ends in the device-to-host copy of the new tokens.
    `make` builds the batcher (default: the dense ContinuousBatcher)."""
    import numpy as np
    import torch

    from mi_optimize_tpu_torch.serving.batching import ContinuousBatcher

    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)) for n in rng.integers(16, 257, n_req)]
    new = [32 if i % 2 == 0 else 64 for i in range(n_req)]
    if make is None:
        b = ContinuousBatcher(model, n_slots=n_slots, max_len=max_len, cache_dtype=torch.int8)
        if b._mega is None:
            raise AssertionError("the batcher did not take the batched whole-model kernel")
    else:
        b = make()
    pending, reqs, admitted, finished = list(range(n_req)), {}, {}, {}
    full_ms, n_steps, joins_mid_flight = [], 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while pending or any(r is not None for r in b.slot_req):
        while pending and None in b.slot_req:
            i = pending[0]
            admitted[i] = time.perf_counter() - t0
            rid = b.add_request(prompts[i], max_new_tokens=new[i])
            if rid is None:  # the page pool cannot take it yet
                break
            pending.pop(0)
            joins_mid_flight += n_steps > 0 and sum(r is not None for r in b.slot_req) > 1
            reqs[i] = next(r for r in b.slot_req if r is not None and r.rid == rid)
        full = all(r is not None for r in b.slot_req)
        ts = time.perf_counter()
        b.step()
        if full:
            full_ms.append((time.perf_counter() - ts) * 1e3)
        n_steps += 1
        for i, r in reqs.items():
            if r.done and i not in finished:
                finished[i] = time.perf_counter() - t0
    wall = time.perf_counter() - t0
    for i, r in reqs.items():
        if len(r.tokens) != new[i] or not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {i}: {len(r.tokens)} tokens, expected {new[i]} "
                                 "in range")
    n_tok = sum(len(r.tokens) for r in reqs.values())
    lat = [finished[i] * 1e3 for i in range(n_req)]
    res = dict(requests=n_req, slots=n_slots, max_len=max_len, tokens=n_tok, wall_s=wall,
               tokens_per_s=n_tok / wall, steps=n_steps, steps_at_full=len(full_ms),
               ms_per_step_full=float(np.mean(full_ms)) if full_ms else None,
               ms_per_step_full_median=float(np.median(full_ms)) if full_ms else None,
               joins_mid_flight=int(joins_mid_flight),
               prompt_lens=[len(p) for p in prompts], new_tokens=new,
               admitted_ms=[admitted[i] * 1e3 for i in range(n_req)], latency_ms=lat,
               request_tokens=[reqs[i].tokens for i in range(n_req)],
               compare=[(prompts[i], reqs[i].tokens) for i in range(n_compare)])
    log(f"  {name}: {n_req} requests, {n_tok} tokens in {wall:.3f} s -> "
        f"{n_tok / wall:.1f} tokens/s; {n_steps} steps, {len(full_ms)} at {n_slots} active "
        f"slots: {res['ms_per_step_full']:.3f} ms a step (median "
        f"{res['ms_per_step_full_median']:.3f}); {joins_mid_flight} mid-flight joins")
    log(f"  request latency ms (since the burst arrived): "
        f"{', '.join(f'{x:.0f}' for x in lat)}")
    return res


def same_tokens(what, got, ref):
    """Gate: every request's greedy tokens equal the dense batcher's."""
    bad = [i for i, (g, r) in enumerate(zip(got, ref)) if g != r]
    log(f"  {what}: tokens of {len(ref) - len(bad)} of {len(ref)} requests equal the "
        f"ContinuousBatcher's -> {'ok' if not bad else 'FAIL'}")
    if bad or len(got) != len(ref):
        raise AssertionError(f"{what}: requests {bad} differ from the ContinuousBatcher's")


def serve_prefix_cache(model, cfg, n_req=16, n_slots=8, max_len=512, shared=256, new=32):
    """n_req requests that share a 256-token prefix (two full pages, seed 15)
    plus a suffix of 1-40 tokens, 32 new tokens each, then one request
    sampled twice in parallel (n=2, temperature 0.8, seed 0), through a
    PagedMegaBatcher with prefix caching and, for the greedy agreement,
    without. The first request prefills; later ones map the cached pages and
    run their suffix through the paged chunk kernel. add_request wall time
    (time to the first token) is kept apart for hits and misses."""
    import numpy as np
    import torch

    from mi_optimize_tpu_torch.serving.paged import PagedMegaBatcher

    rng = np.random.default_rng(15)
    pre = rng.integers(0, cfg.vocab_size, (shared,))
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab_size, (int(n),))])
               for n in rng.integers(1, 41, n_req + 1)]

    def run(cache):
        b = PagedMegaBatcher(model, n_slots=n_slots, max_len=max_len, prefix_cache=cache)
        pending, reqs, ttft = list(range(n_req + 1)), {}, {"hit": [], "miss": []}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while pending or any(r is not None for r in b.slot_req):
            while pending and None in b.slot_req:
                i = pending[0]
                hits = b.pc_hit_tokens
                ta = time.perf_counter()
                if i < n_req:
                    rid = b.add_request(prompts[i], max_new_tokens=new)
                else:
                    rid = b.add_request(prompts[i], max_new_tokens=new, n=2, temperature=0.8,
                                        seed=0)
                if rid is None:
                    break
                ttft["hit" if b.pc_hit_tokens > hits else "miss"].append(
                    (time.perf_counter() - ta) * 1e3)
                pending.pop(0)
                for r in rid if isinstance(rid, list) else [rid]:
                    reqs[(i, r)] = next(q for q in b.slot_req if q is not None and q.rid == r)
            b.step()
        wall = time.perf_counter() - t0
        toks = {k: r.tokens for k, r in reqs.items()}
        if any(len(t) != new or not all(0 <= x < cfg.vocab_size for x in t)
               for t in toks.values()):
            raise AssertionError("prefix cache: a request returned wrong or out-of-range tokens")
        n_tok = sum(len(t) for t in toks.values())
        return dict(tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
                    stats=b.prefix_cache_stats(), ttft_ms=ttft,
                    request_tokens={f"{i}/{r}": t for (i, r), t in toks.items()})

    on, off = run(True), run(False)
    if on["stats"]["hit_tokens"] < (n_req - 1) * shared:
        raise AssertionError("prefix cache: the shared pages were not hit")
    greedy = [f"{i}/{i}" for i in range(n_req)]
    agree = [int(np.cumprod(np.asarray(on["request_tokens"][k]) ==
                            np.asarray(off["request_tokens"][k])).sum()) for k in greedy]
    sampled = [t for k, t in on["request_tokens"].items() if k.startswith(f"{n_req}/")]
    ttft = {k: (float(np.mean(v)) if v else None) for k, v in on["ttft_ms"].items()}
    log(f"  prefix cache: stats {on['stats']}; {on['tokens']} tokens in {on['wall_s']:.3f} s -> "
        f"{on['tokens_per_s']:.1f} tokens/s (no cache: {off['tokens_per_s']:.1f}); time to the "
        f"first token: hits {ttft['hit']:.1f} ms ({len(on['ttft_ms']['hit'])}), misses "
        f"{ttft['miss']:.1f} ms ({len(on['ttft_ms']['miss'])}); no cache: misses "
        f"{np.mean(off['ttft_ms']['miss']):.1f} ms")
    log(f"  greedy tokens with the cache equal to those without on the first: "
        f"{', '.join(str(a) for a in agree)} of {new} (reported); the n=2 request's two "
        f"samples share their first {int(np.cumprod(np.equal(*sampled)).sum())} tokens")
    return dict(cache=on, no_cache=off, greedy_agreement=agree, ttft_mean_ms=ttft)


def serve_paged_batcher(model, cfg, n_req=8, n_slots=4, new=32, n_compare=2):
    """n_req requests (prompts uniform in 16-200 tokens, seed 16, 32 new
    tokens) through a PagedBatcher of n_slots slots over an f32 pool of 64
    pages of 16 tokens, 32 a slot: one launch chain a layer a step, the
    attention through the paged flash decode. Steps are host-timed."""
    import numpy as np
    import torch

    from mi_optimize_tpu_torch.serving import engine
    from mi_optimize_tpu_torch.serving.paged import PagedBatcher

    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)) for n in rng.integers(16, 201, n_req)]
    b = PagedBatcher(model, n_slots=n_slots, page_size=16, n_pages=64, pages_per_slot=32)
    pool_gb = sum(nbytes(k, v) for k, v in b.layers) / 1e9
    pending, reqs, full_ms = list(range(n_req)), {}, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while pending or any(r is not None for r in b.slot_req):
        while pending and None in b.slot_req:
            rid = b.add_request(prompts[pending[0]], max_new_tokens=new)
            if rid is None:
                break
            reqs[pending.pop(0)] = next(r for r in b.slot_req if r is not None and r.rid == rid)
        full = all(r is not None for r in b.slot_req)
        ts = time.perf_counter()
        b.step()
        if full:
            full_ms.append((time.perf_counter() - ts) * 1e3)
    wall = time.perf_counter() - t0
    toks = [reqs[i].tokens for i in range(n_req)]
    if any(len(t) != new or not all(0 <= x < cfg.vocab_size for x in t) for t in toks):
        raise AssertionError("PagedBatcher returned wrong or out-of-range tokens")
    agree = []
    for i in range(n_compare):
        out = engine.generate(model, prompts[i][None], max_new_tokens=new,
                              cache_dtype=torch.float32)[0, len(prompts[i]):]
        agree.append(int(np.cumprod(np.asarray(toks[i]) == out).sum()))
    n_tok = sum(len(t) for t in toks)
    res = dict(requests=n_req, slots=n_slots, pool_gb=pool_gb, tokens=n_tok, wall_s=wall,
               tokens_per_s=n_tok / wall, steps_at_full=len(full_ms),
               ms_per_step_full=float(np.mean(full_ms)), generate_agreement=agree,
               prompt_lens=[len(p) for p in prompts])
    log(f"  PagedBatcher: {n_req} requests, {n_tok} tokens in {wall:.3f} s -> "
        f"{n_tok / wall:.1f} tokens/s; {len(full_ms)} steps at {n_slots} active slots: "
        f"{res['ms_per_step_full']:.3f} ms a step; f32 pool {pool_gb:.2f} GB; greedy tokens "
        f"equal to engine.generate's (f32 cache) on the first {agree} of {new} (reported)")
    return res


class w4a8_route:
    """MI_W4A8_INT=1 inside the block, restored after it."""

    def __enter__(self):
        self.old = os.environ.get("MI_W4A8_INT")
        os.environ["MI_W4A8_INT"] = "1"

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("MI_W4A8_INT", None)
        else:
            os.environ["MI_W4A8_INT"] = self.old


def serve_generate_unfused(model, m_t, cfg, dev, S=128, n=32, name="generate_unfused"):
    """engine.generate on a planted unfused model (separate q/k/v and
    gate/up, no fuse_for_serving) with the int8 cache: an S-token prompt and
    n new tokens, gated on the planted chain; host-timed, with the decode
    ms/token from a second run of 1 new token."""
    import numpy as np
    import torch

    from mi_optimize_tpu_torch.serving import engine

    prompt = np.random.default_rng(31).integers(0, cfg.vocab_size, (1, S))
    walls = {}
    for k in (n, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = engine.generate(model, prompt, max_new_tokens=k, cache_dtype=torch.int8)
        walls[k] = (time.perf_counter() - t0) * 1e3
        gate_chain(f"{name}, {k} new tokens", toks[0, S:].tolist(),
                   planted_chain(m_t, int(prompt[0, -1]), k))
    decode = (walls[n] - walls[1]) / (n - 1)
    log(f"  {name}: {S}-token prompt + {n} tokens in {walls[n]:.1f} ms; prefill and first "
        f"token {walls[1]:.1f} ms; decode {decode:.3f} ms/token")
    return dict(prompt=S, tokens=n, ms=walls[n], first_token_ms=walls[1],
                decode_ms_per_token=decode)


def ppl_batches(cfg, n=2, S=2048, seed=41):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (1, S)) for _ in range(n)]


def timed_ppl(model, batches, fused):
    import torch

    from mi_optimize_tpu_torch.eval.ppl import compute_ppl

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ppl = compute_ppl(model, batches, fused=fused)
    return ppl, (time.perf_counter() - t0) * 1e3 / len(batches)


def serve_ppl_unfused(model, cfg, tol=1e-2):
    """compute_ppl on the random-weight unfused 7B model over 2 batches of
    2048 tokens from a seed: the fused route (dequant_matmul and the fused
    MLP) against the reference's dequantize-then-matmul route (fused=False),
    gated at `tol` relative (bf16 activations through 32 layers, rounded at
    other places on the two routes)."""
    batches = ppl_batches(cfg)
    ppl, ms = timed_ppl(model, batches, True)
    ppl_ref, ms_ref = timed_ppl(model, batches, False)
    rel = abs(ppl - ppl_ref) / ppl_ref
    log(f"  compute_ppl, 2 x 2048 tokens: fused {ppl:.4f} ({ms:.1f} ms/batch), dequantize-then-"
        f"matmul {ppl_ref:.4f} ({ms_ref:.1f} ms/batch): relative difference {rel:.3e} vs {tol} "
        f"-> {'ok' if rel <= tol else 'FAIL'}")
    if not (rel <= tol and ppl > 1.0):
        raise AssertionError("compute_ppl: the fused route disagrees with the unfused one")
    return dict(ppl=ppl, ms_per_batch=ms, ppl_unfused_route=ppl_ref,
                unfused_route_ms_per_batch=ms_ref, rel_diff=rel)


def serve_w4a8(ptarget, m_t, rmodel, cfg, tol=1e-2):
    """The W4A8 spec on every decoder linear (the lm_head keeps its
    weight-only spec) with MI_W4A8_INT=1: generate on the planted target
    (the integer product at the 128-token prefill, gated on the chain),
    then compute_ppl on the random-weight model with the variable set (the
    integer product) against unset (the fake-quant route), gated at `tol`
    relative."""
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import with_w4a8

    pw = Model(config=cfg, params=with_w4a8(ptarget.params))
    rw = Model(config=cfg, params=with_w4a8(rmodel.params))
    batches = ppl_batches(cfg)
    with w4a8_route():
        res = serve_generate_unfused(pw, m_t, cfg, None, name="generate W4A8")
        ppl, ms = timed_ppl(rw, batches, True)
    ppl_fq, ms_fq = timed_ppl(rw, batches, True)
    rel = abs(ppl - ppl_fq) / ppl_fq
    log(f"  compute_ppl W4A8, 2 x 2048 tokens: integer product {ppl:.4f} ({ms:.1f} ms/batch), "
        f"fake-quant route {ppl_fq:.4f} ({ms_fq:.1f} ms/batch): relative difference {rel:.3e} "
        f"vs {tol} -> {'ok' if rel <= tol else 'FAIL'}")
    if not (rel <= tol and ppl > 1.0):
        raise AssertionError("compute_ppl W4A8: the integer product disagrees with fake-quant")
    return dict(generate=res, ppl=ppl, ms_per_batch=ms, ppl_fake_quant=ppl_fq,
                fake_quant_ms_per_batch=ms_fq, rel_diff=rel)


def compare_with_generate(model, compare):
    """For (prompt, batcher tokens) pairs: how many leading greedy tokens
    engine.generate (the per-layer path) gives the same. Reported, not
    gated: the two paths round in bf16 at different places."""
    import numpy as np
    import torch

    from mi_optimize_tpu_torch.serving import engine

    agree = []
    for prompt, toks in compare:
        out = engine.generate(model, prompt[None], max_new_tokens=len(toks),
                              cache_dtype=torch.int8)[0, len(prompt):]
        agree.append([int(np.cumprod(np.asarray(toks) == out).sum()), len(toks)])
    log(f"  batcher's greedy tokens equal to engine.generate's on the first: "
        f"{', '.join(f'{a} of {n}' for a, n in agree)}")
    return agree


def dense_beam(model, prompt, W, max_new, lp=1.0, eos=None, max_len=256):
    """The reference of serving.beam.beam_search (a copy of the JAX
    package's tests/test_beam.py::_dense_beam on the port): the same scoring
    and selection over the full [W, V] log-softmax in float64, each step one
    launch of the batched kernel's dense mode (a) over a [L, W, Hkv, T, D]
    cache, the reorder a gather of the parents' slot slabs in place of the
    page tables. Returns [(new tokens, normalized score)], best first."""
    import numpy as np
    import torch

    from mi_optimize_tpu_torch.serving.engine import init_cache, prefill
    from mi_optimize_tpu_torch.serving.megadecode import (model_step_batch,
                                                         stack_cache_batched, stack_serving)

    def _log_softmax(x):
        z = x.astype(np.float64) - x.max(axis=-1, keepdims=True)
        return z - np.log(np.exp(z).sum(axis=-1, keepdims=True))

    def _norm(score, length, lp):
        return score / max(length, 1) ** lp

    cfg = model.config
    dev = model.params["embed"].device
    stack, meta = stack_serving(model)
    prompt = np.asarray(prompt).reshape(-1)
    S = len(prompt)
    one = init_cache(cfg, 1, max_len, torch.int8, device=dev)
    logits0, one = prefill(model.params, cfg, torch.as_tensor(prompt[None, :], device=dev), one)
    cache = {f: v.repeat_interleave(W, dim=1) for f, v in stack_cache_batched(one).items()}

    logp0 = _log_softmax(logits0[0].to(torch.float32).cpu().numpy())
    first = np.argsort(-logp0, kind="stable")[:W]
    beams = [[int(t)] for t in first]
    scores = np.array([logp0[t] for t in first])
    last = np.array([int(t) for t in first])
    positions = np.full(W, S, np.int64)
    alive = [eos is None or beams[w][-1] != eos for w in range(W)]
    finished = []
    for w in range(W):
        if not alive[w]:
            finished.append((beams[w], _norm(scores[w], 1, lp)))

    while any(alive) and len(beams[0]) < max_new:
        live = [w for w in range(W) if alive[w]]
        with torch.no_grad():
            logits, cache = model_step_batch(model.params, stack, meta, cfg,
                                             torch.as_tensor(last[:, None], device=dev), cache,
                                             positions)
        logp = _log_softmax(logits.to(torch.float32).cpu().numpy())
        V = logp.shape[1]
        cand = np.full((W, V), -np.inf)
        cand[live] = scores[live, None] + logp[live]
        order = np.argsort(-cand.reshape(-1), kind="stable")[:2 * W]
        nlen = len(beams[live[0]]) + 1
        new_parent, new_tok, new_score = [], [], []
        for idx in order:
            p_, t_ = int(idx // V), int(idx % V)
            if eos is not None and t_ == eos:
                if len(finished) < 2 * W:
                    finished.append((beams[p_] + [t_], _norm(cand[p_, t_], nlen, lp)))
                continue
            new_parent.append(p_)
            new_tok.append(t_)
            new_score.append(cand[p_, t_])
            if len(new_parent) == len(live):
                break
        gather = torch.as_tensor(new_parent + [0] * (W - len(new_parent)), device=dev)
        cache = {f: v[:, gather] for f, v in cache.items()}
        nb, ns = [], np.full(W, -np.inf)
        nl, npos = np.zeros(W, np.int64), np.zeros(W, np.int64)
        old_pos = positions.copy()
        for i, (p_, t_, s_) in enumerate(zip(new_parent, new_tok, new_score)):
            nb.append(beams[p_] + [t_])
            ns[i] = s_
            nl[i] = t_
            npos[i] = old_pos[p_] + 1
        beams = nb + [[]] * (W - len(nb))
        scores, last, positions = ns, nl, npos
        alive = [i < len(new_parent) for i in range(W)]
        if npos.max() >= max_len - 1:
            break

    for w in range(W):
        if alive[w]:
            finished.append((beams[w], _norm(scores[w], len(beams[w]), lp)))
    finished.sort(key=lambda x: -x[1])
    return finished[:W]


def planted_chain(m, t, n):
    out = []
    for _ in range(n):
        t = int(m[t])
        out.append(t)
    return out


def gate_chain(what, got, want):
    """Gate: the tokens equal the planted chain exactly."""
    got = [int(t) for t in got]
    n = next((i for i, (g, w) in enumerate(zip(got, want)) if g != w), min(len(got), len(want)))
    log(f"  {what}: {n} of {len(want)} tokens follow the planted chain -> "
        f"{'ok' if got == want else 'FAIL'}")
    if got != want:
        raise AssertionError(f"{what}: tokens leave the planted chain at {n}")


def serve_flat_reference(target, m_t, cfg, dev, prompt, n, kseg=None):
    """A prefill and n tokens of decode_loop_flat (or, with kseg,
    decode_loop_flat_seg) on a planted model, host-timed from the prefill
    on; the tokens gated on the planted chain. Returns (ms per new token,
    ms of the decode loop alone per token)."""
    import torch

    from mi_optimize_tpu_torch.serving import engine
    from mi_optimize_tpu_torch.serving.flatdecode import (decode_loop_flat, decode_loop_flat_seg,
                                                         stack_cache_flat, stack_flat)

    fstack, fmeta = stack_flat(target)
    S = prompt.shape[1]
    total = -(-(S + n + (kseg or 0) + 4) // 128) * 128
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = engine.prefill(target.params, cfg, torch.as_tensor(prompt, device=dev),
                                   engine.init_cache(cfg, 1, total, torch.int8, device=dev))
    tok = torch.argmax(logits, -1)[:, None]
    fcache = stack_cache_flat(cache)
    del cache
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if kseg:
        toks, _ = decode_loop_flat_seg(target.params, fstack, fmeta, cfg, tok, fcache, S, n - 1,
                                       kseg=kseg)
    else:
        toks, _ = decode_loop_flat(target.params, fstack, fmeta, cfg, tok, fcache, S, n - 1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    got = [int(tok)] + toks[0, :n - 1].tolist()
    gate_chain(f"{'decode_loop_flat_seg' if kseg else 'decode_loop_flat'} "
               f"({cfg.num_layers} layers)", got, planted_chain(m_t, int(prompt[0, -1]), n))
    return (t2 - t0) * 1e3 / n, (t2 - t1) * 1e3 / (n - 1)


def serve_speculative(target, draft, m_t, cfg, dev, k, n, prompt, name, need_k8=False):
    """speculative_generate on the planted 7B target with a planted draft:
    the tokens gated on the target's chain; with need_k8 (k="auto") the
    adaptive pick must reach k = 8, the verify of 9 rows split in two
    launches. Host-timed from the prefills on, ms per new token."""
    import torch

    from mi_optimize_tpu_torch.serving.speculative import speculative_generate

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, stats = speculative_generate(target, draft, prompt, max_new_tokens=n, k=k,
                                       cache_dtype=torch.int8)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    S = prompt.shape[1]
    gate_chain(f"speculative_generate {name}", toks[0, S:].tolist(),
               planted_chain(m_t, int(prompt[0, -1]), n))
    if not stats.get("scan_segments"):
        raise AssertionError(f"speculative_generate {name} did not take the scan-flat route")
    if need_k8 and 8 not in stats.get("adaptive_k", []):
        raise AssertionError(f"speculative_generate {name}: k never reached 8 "
                             f"({stats.get('adaptive_k')})")
    log(f"  speculative_generate {name}: {n} tokens in {dt * 1e3:.1f} ms -> "
        f"{dt * 1e3 / n:.3f} ms/token (prefills included), accept rate "
        f"{stats['accept_rate']:.3f}, {stats['target_calls']} verify rounds, "
        f"{stats['draft_calls']} draft steps" + (f", k history {stats['adaptive_k']}"
                                                 if "adaptive_k" in stats else ""))
    return dict(tokens=n, ms=dt * 1e3, ms_per_token=dt * 1e3 / n, stats=stats)


def serve_spec_batcher(make, name, m_t, cfg, n_req=12, new=32):
    """n_req planted requests (prompts uniform in 16-128 tokens, seed 22,
    `new` tokens each) through a speculative batcher, all queued at once;
    every request's tokens gated on the target's chain."""
    import numpy as np
    import torch

    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)) for n in rng.integers(16, 129, n_req)]
    b = make()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = b.run_all(list(prompts), max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [i for i in range(n_req) if got[i] != planted_chain(m_t, int(prompts[i][-1]), new)]
    n_tok = sum(len(t) for t in got.values())
    acc = b.accepted / max(b.proposed, 1)
    log(f"  {name}: {n_req} requests, {n_tok} tokens in {wall:.3f} s -> {n_tok / wall:.1f} "
        f"tokens/s; {b.rounds} rounds, accept rate {acc:.3f}; tokens of {n_req - len(bad)} of "
        f"{n_req} requests follow the planted chain -> {'ok' if not bad else 'FAIL'}")
    if bad:
        raise AssertionError(f"{name}: requests {bad} leave the planted chain")
    return dict(requests=n_req, tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
                rounds=b.rounds, accept_rate=acc, prompt_lens=[len(p) for p in prompts])


def serve_model_loop(model, stack, meta, cfg, dev, S=128, n=128):
    """A 128-token prefill, then n tokens of decode_loop_model: one
    whole-model launch per token (bias tables streamed on this grid), the
    lm_head through dequant_matmul."""
    import torch

    from mi_optimize_tpu_torch.serving import engine
    from mi_optimize_tpu_torch.serving.megadecode import decode_loop_model, stack_cache

    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=torch.Generator().manual_seed(10))
    total = -(-(S + n + 4) // 128) * 128
    cache = engine.init_cache(cfg, 1, total, torch.int8, device=dev)
    logits, cache = engine.prefill(model.params, cfg, prompt.to(dev), cache)
    tok = torch.argmax(logits, -1)[:, None]
    scache = stack_cache(cache)
    del cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, _ = decode_loop_model(model.params, stack, meta, cfg, tok, scache, S, n)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if toks.shape != (1, n) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("decode_loop_model returned out-of-range tokens")
    log(f"  decode_loop_model (asymmetric grid) {n} tokens after a {S}-token prefill: "
        f"{dt * 1e3 / n:.3f} ms/token, {n / dt:.1f} tokens/s")
    return dict(prefill_tokens=S, tokens=n, ms_per_token=dt * 1e3 / n, tokens_per_s=n / dt,
                first_tokens=toks[0, :16].tolist())


# ---------------------------------------------------------------------------
# calibration: quantize (GPTQ, RTN) an fp Llama-2-7B made on the card
# ---------------------------------------------------------------------------

# path n's calibration set, as QuantConfig.from_dict's calibrate_config; the
# datasets layer loads it from data/wikitext (the train split falls back to
# validation)
CALIB = {"name": "wikitext2", "split": "train", "nsamples": 32, "seqlen": 512}
CALIB_LAYERS = 4            # path n's depth: at 32 layers the phase took over 150 s, at 8 60 s
                            # on a slow host (PERF.md §4): 4 keeps the script's time
ALGO_LAYERS = 4             # paths p and q: at 8 layers the other algorithms took over 200 s
GPTQ_AFFINE = {"algo": "gptq", "wbit": "int4", "w_qtype": "per_group", "w_groupsize": 128,
               "w_qscheme": "affine", "blocksize": 128, "percdamp": 0.01}
RTN_AFFINE = {"algo": "rtn", "wbit": "int4", "w_qtype": "per_group", "w_groupsize": 128,
              "w_has_zero": True}
LINEAR_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
LEAD = {"q_proj": "q_proj", "k_proj": "q_proj", "v_proj": "q_proj", "o_proj": "o_proj",
        "gate_proj": "gate_proj", "up_proj": "gate_proj", "down_proj": "down_proj"}
CODE_SHARE = 0.99           # GPTQ card vs CPU: codes equal; each row's first difference one
CODE_SCALE_RTOL = 1e-3      # ... and scales within this up to each row's first differing code
# the card's Hessians against the CPU's from the same inputs, relative in the
# Frobenius norm: bf16 forwards (a 7B layer) differ in an element's last bit,
# 2^-8 of it; f32 forwards in about 1e-7
HESS_BF16_RTOL = 1e-3
HESS_F32_RTOL = 1e-5


def fp_llama(cfg, dev):
    """The fp Llama made on the card from seed 0 in bf16 (llama.init_params)."""
    import torch

    from mi_optimize_tpu_torch.models.llama import init_params
    from mi_optimize_tpu_torch.models.model import Model

    gen = torch.Generator(device=dev).manual_seed(0)
    return Model(config=cfg, params=init_params(cfg, gen, dtype=torch.bfloat16, device=dev))


def fp_block_pass(params, cfg, batches, dev):
    """For each block in turn, (layer, block, inputs): the inputs are the
    embedding of each calibration batch, then the fp blocks' outputs (what
    calibration feeds a block with block_sequential off)."""
    import torch

    from mi_optimize_tpu_torch.models import llama

    S = batches[0].shape[-1]
    cos, sin = llama.rope_tables(cfg, torch.arange(S, device=dev))
    mask = llama.causal_mask(S, dev)
    xs = [params["embed"][torch.as_tensor(b, device=dev)] for b in batches]
    for i, blk in enumerate(params["layers"]):
        yield i, blk, xs, (cos, sin, mask)
        if i + 1 < len(params["layers"]):
            with torch.no_grad():
                xs = [llama.block_apply(blk, x, cos, sin, mask, cfg, fused=False)[0] for x in xs]


def block_captures(blk, xs, rope, cfg):
    """Each batch's captured inputs of the fp block's linears."""
    import torch

    from mi_optimize_tpu_torch.models import llama

    for x in xs:
        with torch.no_grad():
            yield llama.block_apply(blk, x, *rope, cfg, capture=True, fused=False)[2]


def layer_hessians(blk, xs, rope, cfg):
    """H = (2/n)·ΣX^TX of each group's input, by the port's reducers."""
    from mi_optimize_tpu_torch.quant.base import finalize_hessian, init_stats, update_stats_device

    leads = sorted(set(LEAD.values()))
    stats = {n: init_stats(("xtx",), blk[n].in_features, xs[0].device) for n in leads}
    for caps in block_captures(blk, xs, rope, cfg):
        for n in leads:
            stats[n] = update_stats_device(("xtx",), stats[n], caps[n])
    return {n: finalize_hessian(s) for n, s in stats.items()}


def fro_rel(got, want):
    """‖got − want‖_F / ‖want‖_F, in float64."""
    return float((got.double() - want.double()).norm() / want.double().norm())


def gptq_grid(Q, s, z, perm, g=128):
    """The integer grid of GPTQ's fake-quantized Q [out, in] in its group
    (act-order) column order."""
    import torch

    Qp = Q if perm is None else Q[:, perm]
    out_f = Qp.shape[0]
    return torch.round(Qp.reshape(out_f, -1, g) / s[:, :, None] + z[:, :, None]).reshape(out_f, -1)


def hold_codes(what, got, want, s_got=None, s_want=None, g=128):
    """GPTQ's rule between two runs: at least CODE_SHARE of the codes equal;
    in each row, every code before its first difference equal, that first
    difference one code (a rounding tie that the two runs' last bits put on
    either side: GPTQ's error feedback carries it into the row's later
    columns and groups, by more than one code at times), and the scales
    within CODE_SCALE_RTOL up to it. Returns (share, largest difference,
    scale rel)."""
    import torch

    diff = (got.double() - want.double()).abs()
    share, worst = float((diff == 0).double().mean()), float(diff.max())
    # each row's first difference (argmax finds the first nonzero entry)
    first = float(diff.gather(1, torch.argmax((diff != 0).to(torch.int8), dim=1)[:, None]).max())
    srel = 0.0
    if s_got is not None:
        same = (diff == 0).reshape(diff.shape[0], -1, g).all(-1).cumprod(-1).bool()
        if bool(same.any()):
            srel = float(((s_got - s_want).abs() / s_want)[same].max())
    rows = float((diff != 0).any(1).double().mean())
    ok = share >= CODE_SHARE and first <= 1 and srel <= CODE_SCALE_RTOL
    log(f"  {what}: {share:.6f} of codes equal (rule >= {CODE_SHARE}); {rows:.4%} of rows "
        f"differ, each first by {first:.0f} (<= 1), then by up to {worst:.0f}; scales "
        f"{srel:.2e} relative up to each row's first difference (<= {CODE_SCALE_RTOL}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: GPTQ's codes on the card disagree with the CPU's")
    return share, worst, srel


def timed_s(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_calibration_7b(cfg, dev):
    """Rows gptq_7b and rtn_7b: one Llama-2-7B layer at full width (bf16 fp
    weights from seed 0 on the card), Hessians from 16 x 512 tokens of the
    wikitext fixture (ByteTokenizer), held against the CPU's Hessians from
    the same inputs (the layer's forwards and reductions on the CPU in bf16)
    within HESS_BF16_RTOL. GPTQ int4 g128 affine with act-order on q_proj
    and down_proj on the card and on the CPU from the same H (copied over),
    held by `hold_codes`; the card call again with TF32 allowed around
    it (restored after): the same codes; RTN int4 g128 affine on the same
    weights: words, scales and zeros bit-equal card vs CPU. Returns (rows,
    the layer, its Hessians, its inputs and rope tables, for the other
    algorithms' rows and phase 5)."""
    import torch

    from mi_optimize_tpu_torch.datasets.calibration import get_wikitext2
    from mi_optimize_tpu_torch.datasets.tokenizer import ByteTokenizer
    from mi_optimize_tpu_torch.quant.config import QuantConfig
    from mi_optimize_tpu_torch.quant.gptq import gptq_quantize_matrix
    from mi_optimize_tpu_torch.quant.rtn import RTNAlgo

    c1 = dataclasses.replace(cfg, num_layers=1)
    fp = fp_llama(c1, dev)
    batches = get_wikitext2(ByteTokenizer(), split="train", nsamples=16, seqlen=512, seed=0)
    _, blk, xs, rope = next(fp_block_pass(fp.params, c1, batches, dev))
    H, h_s = timed_s(lambda: layer_hessians(blk, xs, rope, c1))
    t0 = time.perf_counter()
    H_cpu = layer_hessians(_to(blk, "cpu"), [x.cpu() for x in xs], _to(list(rope), "cpu"), c1)
    hc_s = time.perf_counter() - t0
    hess = {n: fro_rel(H[n].cpu(), H_cpu[n]) for n in H}
    ok = max(hess.values()) <= HESS_BF16_RTOL
    log(f"  Hessians of layer 0's four groups from 16 x 512 tokens: card {h_s:.2f} s, CPU "
        f"{hc_s:.2f} s; card vs CPU relative (Frobenius) " +
        ", ".join(f"{n} {r:.2e}" for n, r in hess.items()) +
        f" (<= {HESS_BF16_RTOL}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("gptq_7b: the card's Hessians disagree with the CPU's")
    del H_cpu
    kw = dict(bits=4, groupsize=128, actorder=True, symmetric=False, percdamp=0.01)
    rtn = RTNAlgo(QuantConfig(**RTN_AFFINE))
    rows = []
    for name in ("q_proj", "down_proj"):
        W, h = blk[name].weight, H[LEAD[name]]
        shape = f"{name} {W.shape[1]}->{W.shape[0]}"
        (Qg, sg, zg, pg), card_s = timed_s(lambda: gptq_quantize_matrix(W, h, **kw))
        t0 = time.perf_counter()
        Qc, sc, zc, pc = gptq_quantize_matrix(W.cpu(), h.cpu(), **kw)
        cpu_s = time.perf_counter() - t0
        if not torch.equal(pg.cpu(), pc):
            raise AssertionError(f"gptq_7b {shape}: the act-order permutation differs")
        got = gptq_grid(Qg, sg, zg, pg).cpu()
        share, worst, srel = hold_codes(f"gptq_7b {shape}, card vs CPU", got,
                                        gptq_grid(Qc, sc, zc, pc), sg.cpu(), sc)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            (Qt, st, zt, pt), tf32_s = timed_s(lambda: gptq_quantize_matrix(W, h, **kw))
            kept = torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        same_tf32 = torch.equal(gptq_grid(Qt, st, zt, pt).cpu(), got) and torch.equal(st, sg)
        log(f"  gptq_7b {shape}: card {card_s:.3f} s ({tf32_s:.3f} s with TF32 allowed around "
            f"it: {'the same codes and scales' if same_tf32 else 'DIFFERENT codes'}), CPU "
            f"{cpu_s:.3f} s")
        if not same_tf32 or not kept:
            raise AssertionError(f"gptq_7b {shape}: TF32 moved GPTQ's codes or was not restored")
        rows.append(dict(name="gptq_7b", shape=shape, card_s=card_s, cpu_s=cpu_s,
                         card_tf32_s=tf32_s, codes_equal=share, max_code_diff=worst,
                         scale_rel=srel, hessian_rel=hess[LEAD[name]],
                         hessian_card_s=h_s, hessian_cpu_s=hc_s))
        del Qg, Qc, Qt
        lin = blk[name]
        qg, rcard_s = timed_s(lambda: rtn.quantize_linear(lin, {}))
        t0 = time.perf_counter()
        qc = rtn.quantize_linear(_to(lin, "cpu"), {})
        rcpu_s = time.perf_counter() - t0
        same = all(torch.equal(getattr(qg, f).cpu(), getattr(qc, f))
                   for f in ("packed", "w_scale", "w_zero"))
        log(f"  rtn_7b {shape}: words, scales and zeros card vs CPU "
            f"{'bit-equal' if same else 'DIFFERENT'}; card {rcard_s * 1e3:.1f} ms, CPU "
            f"{rcpu_s * 1e3:.1f} ms")
        if not same:
            raise AssertionError(f"rtn_7b {shape}: the card's RTN differs from the CPU's")
        rows.append(dict(name="rtn_7b", shape=shape, card_s=rcard_s, cpu_s=rcpu_s,
                         bit_equal=True))
    return rows, (blk, H, xs, rope)


class algo_calls:
    """While active: the seconds inside `cls.quantize_linear` (GPTQAlgo's
    when cls is None; synchronized), and with keep=True every call's (fp
    linear, stats, result) in call order (layer by layer, GROUP_ORDER).
    Given `results`, each call returns the next of them in place of running
    the algorithm."""

    def __init__(self, keep=False, results=None, cls=None):
        self.keep, self.results, self.calls, self.s = keep, results, [], 0.0
        self.cls = cls

    def __enter__(self):
        if self.cls is None:
            from mi_optimize_tpu_torch.quant.gptq import GPTQAlgo

            self.cls = GPTQAlgo
        self.orig = self.cls.quantize_linear

        def spy(algo, lin, stats):
            if self.results is not None:
                out, s = self.results[len(self.calls)], 0.0
            else:
                out, s = timed_s(lambda: self.orig(algo, lin, stats))
            self.s += s
            if self.keep:
                self.calls.append((lin, dict(stats), out))
            return out

        self.cls.quantize_linear = spy
        return self

    def __exit__(self, *exc):
        self.cls.quantize_linear = self.orig


def output_errors(fp_blk, qblks, xs, rope, cfg):
    """{model: {linear: ‖X(Ŵ−W)ᵀ‖²}} over the batches, X the fp block's
    captured input of each linear, Ŵ the quantized model's effective weights
    (divided by the smooth factor where there is one)."""
    import torch

    from mi_optimize_tpu_torch.models.quant_linear import dequant_weight

    def effective(lin):  # a smoothed linear computes (x / s) @ dq(W·s)^T
        w = dequant_weight(lin).float()
        return w if lin.smooth_factor is None else w / lin.smooth_factor.float()[None, :]

    D = {k: {n: effective(b[n]) - fp_blk[n].weight.float() for n in LINEAR_NAMES}
         for k, b in qblks.items()}
    err = {k: {n: 0.0 for n in LINEAR_NAMES} for k in qblks}
    for caps in block_captures(fp_blk, xs, rope, cfg):
        for n in LINEAR_NAMES:
            X = caps[n].float().reshape(-1, caps[n].shape[-1])
            for k in qblks:
                err[k][n] += float((X @ D[k][n].t()).double().square().sum())
    return err


def serve_calibrated(fp, cfg, dev):
    """Path n: quantize the fp model (GPTQ int4 g128 affine, act-order off;
    calibration CALIB through get_calibrate_loader), then: its perplexity on
    2 x 2048 tokens of the wikitext test fixture through Benchmark.eval_ppl,
    the fused route (dequant_matmul, fused MLP) against the
    dequantize-then-matmul route within 1e-2; fuse_for_serving, a 128-token
    prefill and 128 tokens of decode_loop_model (the whole-model kernel's
    bias-table route); the same fp model quantized by RTN (dataless); and the
    gate: on layer 0's and the last layer's calibration inputs, GPTQ's output
    error ‖X(Ŵ−W)ᵀ‖² at most RTN's on each of the seven linears."""
    import torch

    from mi_optimize_tpu_torch.datasets.calibration import get_calibrate_loader
    from mi_optimize_tpu_torch.datasets.tokenizer import ByteTokenizer
    from mi_optimize_tpu_torch.eval.benchmark import Benchmark
    from mi_optimize_tpu_torch.quant import QuantConfig, quantize
    from mi_optimize_tpu_torch.serving.flatdecode import stack_flat
    from mi_optimize_tpu_torch.serving.megadecode import stack_serving
    from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving

    tok, L = ByteTokenizer(), cfg.num_layers
    qcfg = QuantConfig.from_dict(dict(GPTQ_AFFINE, actorder=False, calibrate_config=CALIB))
    with algo_calls() as gt:
        qm, calib_s = timed_s(lambda: quantize(fp, qcfg, tokenizer=tok, device=dev))
    log(f"  quantize (GPTQ int4 g128 affine, {CALIB['nsamples']} x {CALIB['seqlen']} wikitext "
        f"tokens, {L} layers): {calib_s:.1f} s, {calib_s / L:.3f} s a layer, of which GPTQ's "
        f"column loops {gt.s / L:.3f} s and the calibration forwards and stats "
        f"{(calib_s - gt.s) / L:.3f} s")
    res = dict(layers=L, calib_s=calib_s, s_per_layer=calib_s / L, gptq_s_per_layer=gt.s / L)
    ppl = {}
    for fused in (True, False):
        ppl[fused], ppl_s = timed_s(lambda: Benchmark(fused=fused, device=dev).eval_ppl(
            qm, tok, ["wikitext2"], seqlen=2048, nsamples=2)["wikitext2"])
        res["eval_ppl_s" if fused else "eval_ppl_unfused_route_s"] = ppl_s
    rel = abs(ppl[True] - ppl[False]) / ppl[False]
    log(f"  Benchmark.eval_ppl wikitext2, 2 x 2048 tokens: fused {ppl[True]:.4f}, "
        f"dequantize-then-matmul {ppl[False]:.4f}: relative difference {rel:.3e} vs 1e-2 -> "
        f"{'ok' if rel <= 1e-2 else 'FAIL'}")
    if not (rel <= 1e-2 and ppl[True] > 1.0):
        raise AssertionError("path n: the fused route's perplexity disagrees")
    res.update(ppl=ppl[True], ppl_unfused_route=ppl[False], ppl_rel_diff=rel)
    sm = fuse_for_serving(qm)
    st = stack_serving(sm)
    if st is None or stack_flat(sm, st) is not None:
        raise AssertionError("path n: the calibrated model should take the bias-table route")
    res["decode"] = serve_model_loop(sm, st[0], st[1], cfg, dev)
    del sm, st
    rm, rtn_s = timed_s(lambda: quantize(fp, QuantConfig.from_dict(RTN_AFFINE), device=dev))
    log(f"  quantize (RTN int4 g128 affine, dataless): {rtn_s:.2f} s")
    res["rtn_s"] = rtn_s
    batches = get_calibrate_loader(tok, qcfg.calibrate)
    gate = {}
    for i, blk, xs, rope in fp_block_pass(fp.params, cfg, batches, dev):
        if i not in (0, L - 1):
            continue
        errs = output_errors(blk, {"gptq": qm.params["layers"][i], "rtn": rm.params["layers"][i]},
                             xs, rope, cfg)
        gate[i] = {n: [errs["gptq"][n], errs["rtn"][n]] for n in LINEAR_NAMES}
        log(f"  layer {i}, GPTQ/RTN output error ‖X(Ŵ−W)ᵀ‖² on its calibration inputs: " +
            ", ".join(f"{n} {g / r:.3f}" for n, (g, r) in gate[i].items()))
        bad = [n for n, (g, r) in gate[i].items() if not g <= r]
        if bad:
            raise AssertionError(f"path n, layer {i}: GPTQ's output error exceeds RTN's on {bad}")
    res["output_error_gptq_rtn"] = gate
    return res


def serve_actorder(fp, cfg, dev, S=128, n=32):
    """Path o: the north-star config (GPTQ int4 g128 affine, act-order on:
    every linear keeps its permutation) on the first 2 layers of the fp
    model, served unfused: generate with an S-token prompt and n new tokens
    (the decode attention, dequant_matmul through each linear's gather; the
    fused MLP declines permuted linears), and compute_ppl's fused route
    within 1e-2 of the dequantize-then-matmul route on 2 x 2048 tokens of the
    wikitext test fixture."""
    import numpy as np
    import torch

    from mi_optimize_tpu_torch.datasets.calibration import get_wikitext2
    from mi_optimize_tpu_torch.datasets.tokenizer import ByteTokenizer
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.quant import QuantConfig, quantize
    from mi_optimize_tpu_torch.serving import engine

    c2 = dataclasses.replace(cfg, num_layers=2)
    fp2 = Model(config=c2, params=dict(fp.params, layers=fp.params["layers"][:2]))
    tok = ByteTokenizer()
    qcfg = QuantConfig.from_dict(dict(GPTQ_AFFINE, actorder=True, calibrate_config=CALIB))
    qm, calib_s = timed_s(lambda: quantize(fp2, qcfg, tokenizer=tok, device=dev))
    if any(b[k].perm is None for b in qm.params["layers"] for k in LINEAR_NAMES):
        raise AssertionError("path o: an act-order linear lost its permutation")
    log(f"  quantize (GPTQ int4 g128 affine, act-order, 2 layers): {calib_s:.1f} s")
    prompt = np.random.default_rng(33).integers(0, cfg.vocab_size, (1, S))
    walls = {}
    for k in (n, 1):
        toks, walls[k] = timed_s(lambda: engine.generate(qm, prompt, max_new_tokens=k,
                                                         cache_dtype=torch.int8))
        new = toks[0, S:]
        if new.shape[0] != k or not bool(((new >= 0) & (new < cfg.vocab_size)).all()):
            raise AssertionError("path o: generate returned out-of-range tokens")
    decode = (walls[n] - walls[1]) * 1e3 / (n - 1)
    log(f"  generate, {S}-token prompt + {n} tokens: {walls[n] * 1e3:.1f} ms; decode "
        f"{decode:.3f} ms/token; first tokens {toks[0, S:S + 8].tolist()}")
    batches = get_wikitext2(tok, split="test", nsamples=2, seqlen=2048)
    ppl, ms = timed_ppl(qm, batches, True)
    ppl_ref, ms_ref = timed_ppl(qm, batches, False)
    rel = abs(ppl - ppl_ref) / ppl_ref
    log(f"  compute_ppl, 2 x 2048 wikitext tokens: fused {ppl:.4f} ({ms:.1f} ms/batch), "
        f"dequantize-then-matmul {ppl_ref:.4f} ({ms_ref:.1f} ms/batch): relative difference "
        f"{rel:.3e} vs 1e-2 -> {'ok' if rel <= 1e-2 else 'FAIL'}")
    if not (rel <= 1e-2 and ppl > 1.0):
        raise AssertionError("path o: the fused route's perplexity disagrees")
    return dict(calib_s=calib_s, generate_ms=walls[n] * 1e3, decode_ms_per_token=decode,
                ppl=ppl, ppl_unfused_route=ppl_ref, ppl_rel_diff=rel, ms_per_batch=ms)


def small_calibration_check(dev):
    """A small f32 model quantized on the card and on the CPU from the same
    4 x 128 wikitext calibration tokens. RTN int4 g128 affine: words equal,
    the two models' CPU perplexities (2 x 256 test tokens) within 1e-3
    relative. GPTQ int4 g128 affine with act-order: the card's Hessians of
    every call within HESS_F32_RTOL of the CPU driver's on the same
    quantized states (its GPTQ calls given the card's results); every
    linear of the card's model against GPTQ on the CPU from the card's own
    Hessians (copied over), by `hold_codes` in natural column order, and
    that replayed model's CPU perplexity within 1e-3 of the card model's.
    The CPU's own calibration of GPTQ is reported, not held: its Hessians come
    from the CPU's forwards, which round apart from the card's in the last
    bits, and GPTQ on these rank-deficient Hessians (ByteTokenizer's few
    distinct ids) turns that into other codes at rounding ties and carries
    them on (on one CPU, 1 against 8 threads: 61% of layer 1's down_proj
    codes equal, perplexities 2e-3 apart)."""
    import torch

    from mi_optimize_tpu_torch.core import packing
    from mi_optimize_tpu_torch.core.qparams import qrange
    from mi_optimize_tpu_torch.datasets.calibration import get_wikitext2
    from mi_optimize_tpu_torch.datasets.tokenizer import ByteTokenizer
    from mi_optimize_tpu_torch.eval.ppl import compute_ppl
    from mi_optimize_tpu_torch.models.llama import GROUP_ORDER, LlamaConfig, init_params
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.quant import QuantConfig, quantize
    from mi_optimize_tpu_torch.quant.gptq import GPTQAlgo

    cfg = LlamaConfig(vocab_size=320, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512)
    cpu = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    gen = torch.Generator().manual_seed(7)
    for blk in cpu["layers"]:
        for k in ("input_norm", "post_norm"):
            blk[k] = 1.0 + 0.1 * torch.randn(cfg.hidden_size, generator=gen)
    tok = ByteTokenizer()
    calib = get_wikitext2(tok, split="train", nsamples=4, seqlen=128, seed=0)
    test = get_wikitext2(tok, split="test", nsamples=2, seqlen=256)

    def natural(lin):
        s = lin.spec
        q = packing.unpack_weight(lin.packed.cpu(), s.wbit, qrange(s.wbit, s.w_unsigned),
                                  lin.in_features)
        return (q if lin.perm is None else q[:, torch.argsort(lin.perm.cpu())]).reshape(-1)

    def ppl(params):
        return compute_ppl(Model(config=cfg, params=_to(params, "cpu")), test)

    def codes(params):
        return torch.cat([natural(b[n]) for b in params["layers"] for n in LINEAR_NAMES])

    res = {}
    for what, qd in (("RTN", RTN_AFFINE), ("GPTQ act-order", dict(GPTQ_AFFINE, actorder=True))):
        qcfg = QuantConfig(**qd)
        qc = quantize(Model(config=cfg, params=cpu), qcfg, calib_data=calib, device="cpu")
        with algo_calls(keep=True) as rec:
            qg = quantize(Model(config=cfg, params=_to(cpu, dev)), qcfg, calib_data=calib,
                          device=dev)
        p_card, p_cpu = ppl(qg.params), ppl(qc.params)
        a, b = codes(qg.params), codes(qc.params)
        share, rel = float((a == b).double().mean()), abs(p_card - p_cpu) / p_cpu
        res[what] = dict(ppl_card=p_card, ppl_cpu=p_cpu, codes_equal_cpu_calibration=share)
        if what == "RTN":
            log(f"  small f32 model, RTN: words card vs CPU {'equal' if share == 1 else 'DIFFER'}; "
                f"CPU perplexity of the card-quantized model {p_card:.6f}, of the CPU-quantized "
                f"one {p_cpu:.6f} (relative {rel:.2e} vs 1e-3)")
            if share != 1 or not rel <= 1e-3:
                raise AssertionError("small model, RTN: the card's quantization disagrees")
            continue
        algo, names = GPTQAlgo(qcfg), [n for g in GROUP_ORDER for n in g]
        replay = [dict(b) for b in qg.params["layers"]]
        got, want = [], []
        for k, (lin, st, out) in enumerate(rec.calls):
            rep = algo.quantize_linear(_to(lin, "cpu"), _to(st, "cpu"))
            replay[k // len(names)][names[k % len(names)]] = rep
            got.append(natural(out))
            want.append(natural(rep))
        if len(rec.calls) != len(names) * cfg.num_layers:
            raise AssertionError("small GPTQ model: a linear was not quantized by GPTQ")
        # the card's calibration forwards and Hessian reductions: the CPU's
        # driver, each of its GPTQ calls given the card's result, walks the
        # card's quantized states and must see the card's stats
        with algo_calls(keep=True, results=[_to(c[2], "cpu") for c in rec.calls]) as cpu_rec:
            quantize(Model(config=cfg, params=cpu), qcfg, calib_data=calib, device="cpu")
        pairs = [(c[1], d[1]) for c, d in zip(rec.calls, cpu_rec.calls)]
        hess = max(fro_rel(st["xtx"].cpu(), cst["xtx"]) for st, cst in pairs)
        ok = (len(cpu_rec.calls) == len(rec.calls) and hess <= HESS_F32_RTOL
              and all(int(st["nsamples"]) == int(cst["nsamples"]) for st, cst in pairs))
        log(f"  small f32 model, GPTQ: the Hessians of the card's calibration against the CPU "
            f"driver's on the card's quantized states, all {len(pairs)} calls: largest relative "
            f"(Frobenius) {hess:.2e} (<= {HESS_F32_RTOL}), nsamples equal -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("small model, GPTQ: the card's calibration stats disagree")
        res[what].update(hessian_rel=hess)
        hold_codes("small GPTQ model, every linear against the CPU's GPTQ from the card's "
                   "Hessians", torch.cat(got)[None], torch.cat(want)[None])
        p_rep = ppl(dict(qg.params, layers=replay))
        rel_rep = abs(p_card - p_rep) / p_rep
        log(f"  small f32 model, GPTQ: CPU perplexity of the card-quantized model {p_card:.6f}, "
            f"of its CPU replay {p_rep:.6f} (relative {rel_rep:.2e} vs 1e-3); the CPU's own "
            f"calibration (reported): {share:.5f} of codes equal, perplexity {p_cpu:.6f} "
            f"(relative {rel:.2e})")
        res[what].update(ppl_replay=p_rep)
        if not rel_rep <= 1e-3:
            raise AssertionError("small model, GPTQ: the card's quantization disagrees")
    return res


def gptq_layer_window(state):
    """Phase 5's gptq_layer_7b: GPTQ int4 g128 affine with act-order on the
    seven linears of one Llama-2-7B layer from its four Hessians (phase 2's)."""
    from mi_optimize_tpu_torch.quant.gptq import gptq_quantize_matrix

    blk, H = state[:2]
    kw = dict(bits=4, groupsize=128, actorder=True, symmetric=False, percdamp=0.01)
    return lambda: [gptq_quantize_matrix(blk[n].weight, H[LEAD[n]], **kw) for n in LINEAR_NAMES]


# ---------------------------------------------------------------------------
# the other algorithms (quant/awq*, smoothquant, zeroquant, fp8, spqr*, quip*,
# combos) and the W8A8 route (ops/int8_matmul: torch._int_mm)
# ---------------------------------------------------------------------------

AWQ_G128 = {"algo": "awq", "wbit": "int4", "w_groupsize": 128, "n_grid": 20, "max_shrink": 0.5}
# SmoothQuant and ZeroQuant store their signed grid signed (w_unsign=False):
# with the config default the reference clamps the negative codes to 0
SQ_W8A8 = {"algo": "smoothquant", "wbit": "int8", "abit": "int8", "w_qtype": "per_channel",
           "a_qtype": "per_token", "alpha": 0.5, "w_unsign": False}
ZQ_W8A8 = {"algo": "zeroquant", "wbit": "int8", "abit": "int8", "w_groupsize": 128,
           "w_unsign": False}
FP8_E4M3 = {"algo": "fp8", "wbit": "int8", "abit": "int8", "fp8_format": "e4m3"}
AWQ_GPTQ = {"algo": "awq+gptq", "wbit": "int4", "w_qtype": "per_group", "w_groupsize": 128,
            "w_has_zero": True}
SQ_GPTQ = {"algo": "smoothquant+gptq", "wbit": "int8", "abit": "int8", "w_qtype": "per_channel",
           "a_qtype": "per_token", "w_has_zero": True, "alpha": 0.5}
SPQR_G16 = {"algo": "spqr", "wbit": "int4", "w_groupsize": 16, "outlier_relative_threshold": 0.2,
            "qq_scale_bits": 3, "qq_groupsize": 16}
QUIP_B = {"algo": "quip", "wbit": "int4", "qfn": "b"}
ALGO_SHARE = 0.99           # card vs CPU from the same stats: codes (and AWQ's clip indices)
AWQ_LOSS_RTOL = 1e-4        # AWQ: another ratio only within this of the CPU's minimum loss
W8A8_RTOL = 1e-6


def layer_stats(blk, xs, rope, cfg, kinds=("inputs", "absmean", "absmax")):
    """The port's reducers over the fp block's captured inputs: {lead linear:
    stats} of its four groups (sampled inputs on the host)."""
    from mi_optimize_tpu_torch.quant.base import init_stats, update_stats_device, update_stats_host

    leads = sorted(set(LEAD.values()))
    dev_kinds = tuple(k for k in kinds if k != "inputs")
    stats = {n: init_stats(kinds, blk[n].in_features, xs[0].device) for n in leads}
    for caps in block_captures(blk, xs, rope, cfg):
        for n in leads:
            st = stats[n]
            dev = update_stats_device(dev_kinds, {k: v for k, v in st.items() if k != "inputs"},
                                      caps[n])
            stats[n] = dict(update_stats_host(kinds, st, caps[n]), **dev)
    return stats


def lin_codes(lin):
    """The integer grid [out, in] of a packed linear, on the CPU."""
    from mi_optimize_tpu_torch.core import packing
    from mi_optimize_tpu_torch.core.qparams import qrange

    s = lin.spec
    return packing.unpack_weight(lin.packed.cpu(), s.wbit, qrange(s.wbit, s.w_unsigned),
                                 lin.in_features)


def share_equal(a, b):
    return float((a == b).double().mean())


def awq_parts(lin, stats, qcfg):
    """AWQ of one linear, with the ratio losses and the ratio and clip
    indices its searches chose."""
    from unittest import mock

    from mi_optimize_tpu_torch.quant import awq_impl

    rec = {"idx": []}
    sl, fe = awq_impl.scale_losses, awq_impl._first_within_eps

    def losses(*a, **k):
        out = sl(*a, **k)
        rec["losses"] = out[0]
        return out

    def first(errs, *a, **k):
        idx = fe(errs, *a, **k)
        rec["idx"].append(idx)
        return idx

    with mock.patch.object(awq_impl, "scale_losses", losses), \
            mock.patch.object(awq_impl, "_first_within_eps", first):
        out = awq_impl.awq_quantize_linear(qcfg, lin, stats)
    return out, rec["losses"], int(rec["idx"][0]), rec["idx"][1]


def check_awq_7b(blk, stats, dev):
    """Row awq_7b: AWQ int4 g128 on q_proj and down_proj, on the card and on
    the CPU from the same sampled inputs and absmean sums (copied over). The
    ratio index equal, or the card's within AWQ_LOSS_RTOL of the CPU's
    minimum loss as the CPU evaluates it; at least ALGO_SHARE of the
    [oc, group] clip indices and of the codes equal; the card call again with
    TF32 allowed around it: the same codes."""
    import torch

    from mi_optimize_tpu_torch.quant.config import QuantConfig

    qcfg = QuantConfig(**AWQ_G128)
    rows = []
    for name in ("q_proj", "down_proj"):
        lin, st = blk[name], stats[LEAD[name]]
        shape = f"{name} {lin.in_features}->{lin.out_features}"
        (qg, lg, rg, cg), card_s = timed_s(lambda: awq_parts(lin, st, qcfg))
        t0 = time.perf_counter()
        qc, lc, rc, cc = awq_parts(_to(lin, "cpu"), _to(st, "cpu"), qcfg)
        cpu_s = time.perf_counter() - t0
        lmin = float(lc.min())
        ratio_rel = (float(lc[rg]) - lmin) / lmin
        clip_eq = share_equal(cg.cpu(), cc)
        codes = lin_codes(qg)
        code_eq = share_equal(codes, lin_codes(qc))
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            (qt, _, _, _), tf32_s = timed_s(lambda: awq_parts(lin, st, qcfg))
            kept = torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        same_tf32 = torch.equal(lin_codes(qt), codes)
        ok = ((rg == rc or ratio_rel <= AWQ_LOSS_RTOL) and clip_eq >= ALGO_SHARE
              and code_eq >= ALGO_SHARE and same_tf32 and kept)
        log(f"  awq_7b {shape}: ratio index card {rg}, CPU {rc} (the card's {ratio_rel:.2e} "
            f"above the CPU's minimum loss); clip indices {clip_eq:.6f} equal, codes "
            f"{code_eq:.6f} (>= {ALGO_SHARE}); TF32 allowed: "
            f"{'the same codes' if same_tf32 else 'DIFFERENT codes'}; card {card_s:.3f} s "
            f"({tf32_s:.3f} s with TF32 allowed), CPU {cpu_s:.3f} s -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"awq_7b {shape}: the card's AWQ disagrees with the CPU's")
        rows.append(dict(name="awq_7b", shape=shape, card_s=card_s, cpu_s=cpu_s,
                         card_tf32_s=tf32_s, ratio_card=rg, ratio_cpu=rc, ratio_rel=ratio_rel,
                         clip_equal=clip_eq, codes_equal=code_eq))
    return rows


def check_smoothquant_7b(blk, stats, dev):
    """Row smoothquant_7b: SmoothQuant W8A8 on q_proj, card against CPU from
    the same absmax: smooth scales within 1e-6 relative, at least 99.9% of
    the int8 words equal, each off by at most one. Returns (rows, the card's
    linear)."""
    import torch

    from mi_optimize_tpu_torch.quant.config import QuantConfig
    from mi_optimize_tpu_torch.quant.smoothquant import SmoothQuantAlgo

    algo = SmoothQuantAlgo(QuantConfig(**SQ_W8A8))
    lin, st = blk["q_proj"], {"absmax": stats["q_proj"]["absmax"]}
    qg, card_s = timed_s(lambda: algo.quantize_linear(lin, st))
    t0 = time.perf_counter()
    qc = algo.quantize_linear(_to(lin, "cpu"), _to(st, "cpu"))
    cpu_s = time.perf_counter() - t0
    srel = float(((qg.smooth_factor.cpu() - qc.smooth_factor).abs() / qc.smooth_factor).max())
    a, b = lin_codes(qg), lin_codes(qc)
    eq, worst = share_equal(a, b), int((a - b).abs().max())
    ok = srel <= 1e-6 and eq >= 0.999 and worst <= 1
    log(f"  smoothquant_7b q_proj: smooth scales card vs CPU {srel:.2e} relative (<= 1e-6); "
        f"int8 words {eq:.6f} equal (>= 0.999), at most {worst} apart (<= 1); card "
        f"{card_s * 1e3:.1f} ms, CPU {cpu_s * 1e3:.1f} ms -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("smoothquant_7b: the card's SmoothQuant disagrees with the CPU's")
    return [dict(name="smoothquant_7b", shape="q_proj 4096->4096", card_s=card_s, cpu_s=cpu_s,
                 smooth_rel=srel, words_equal=eq, max_word_diff=worst)], qg


def check_w8a8_7b(blk, stats, rtn_lins, dev, flush, reps):
    """Row w8a8_7b: the W8A8 route (ops/int8_matmul: activations on the
    dynamic int8 grid, the int32 product by torch._int_mm) on SmoothQuant
    W8A8 linears of q_proj's and down_proj's shapes at M = 1, 128 and 2048,
    against its plain version on the card (the sums in float64): the int32
    accumulators equal and the outputs within W8A8_RTOL; timed beside
    torch._int_mm alone on the pre-quantized operands and B1 (gemv16 at
    M = 1, mma above) on the RTN int4 g128 linear of the same weights."""
    import torch

    from mi_optimize_tpu_torch.ops import dequant_matmul as dm
    from mi_optimize_tpu_torch.ops import int8_matmul as i8
    from mi_optimize_tpu_torch.ops.w4a8_matmul import quantize_activations
    from mi_optimize_tpu_torch.quant.config import QuantConfig
    from mi_optimize_tpu_torch.quant.smoothquant import SmoothQuantAlgo

    algo = SmoothQuantAlgo(QuantConfig(**SQ_W8A8))
    gen = torch.Generator(device=dev).manual_seed(17)
    rows = []
    for name in ("q_proj", "down_proj"):
        lin = algo.quantize_linear(blk[name], {"absmax": stats[LEAD[name]]["absmax"]})
        N, K = lin.out_features, lin.in_features
        wi8 = i8.weight_int8(lin)
        sw = lin.w_scale.reshape(1, -1)
        for M in (1, 128, 2048):
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            xi, sx = quantize_activations(x.float(), "per_token")
            acc = i8.w8a8_matmul_int(xi, wi8)
            ref = i8.w8a8_matmul_ref(xi, wi8)
            y = i8.w8a8_matmul(x.float(), lin)
            y_ref = ref.float() * sx * sw
            err = float((y - y_ref).abs().max())
            same_acc = torch.equal(acc, ref)
            ok = same_acc and err <= W8A8_RTOL * float(y_ref.abs().max())

            def plain():
                xi_p, sx_p = quantize_activations(x.float(), "per_token")
                return (i8.w8a8_matmul_ref(xi_p, i8.weight_int8(lin)).float() * sx_p
                        * sw).to(x.dtype)

            ms = time_ms(lambda: i8.w8a8_matmul(x, lin), reps, flush)
            plain_ms = time_ms(plain, max(2, reps // 5), flush)
            int_mm_ms = time_ms(lambda: i8.w8a8_matmul_int(xi, wi8), reps, flush)
            b1_route = dm.route(M, torch.bfloat16, 4, 128)
            b1_ms = time_ms(lambda: dm.dequant_matmul(x, rtn_lins[name]), reps, flush)
            nb = nbytes(x, lin.packed, lin.w_scale) + M * N * 2
            b_ms, b_by = bound(nb, 2.0 * M * N * K, INT8_OPS)
            log(f"  w8a8_7b {name} M={M} K={K} N={N}: int32 sums card vs plain "
                f"{'equal' if same_acc else 'DIFFERENT'}, outputs {err:.3e} (<= {W8A8_RTOL} of "
                f"max); route {ms:.4f} ms, torch._int_mm alone {int_mm_ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, B1 {b1_route} on the int4 g128 linear {b1_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"w8a8_7b {name} M={M}: the route disagrees with its plain "
                                     "version")
            rows.append(dict(name="w8a8_7b", shape=f"{name} M={M} K={K} N={N}", ms=ms,
                             plain_ms=plain_ms, int_mm_ms=int_mm_ms, b1_route=b1_route,
                             b1_int4_ms=b1_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err))
    return rows


def check_fp8_7b(blk, dev):
    """Row fp8_7b: FP8 E4M3 and E5M2 on q_proj: the native float8 weights
    dequantize to the float32 fake grid bit for bit on the card, and the
    card's fake-quantized weights, scales and native bytes are the CPU's."""
    import torch

    from mi_optimize_tpu_torch.models.quant_linear import dequant_weight
    from mi_optimize_tpu_torch.quant.config import QuantConfig
    from mi_optimize_tpu_torch.quant.fp8 import FP8Algo, fp8_quantize_value

    rows = []
    lin = blk["q_proj"]
    for fmt in ("e4m3", "e5m2"):
        kw = dict(FP8_E4M3, fp8_format=fmt)
        out = {}
        for pack in (True, False):
            algo = FP8Algo(QuantConfig(**kw, pack=pack))
            out[pack], card_s = timed_s(lambda: algo.quantize_linear(lin, {}))
            out[pack, "cpu"] = algo.quantize_linear(_to(lin, "cpu"), {})
        # the fake grid in float32 (pack=False rounds it to the bf16 linear's dtype)
        grid = fp8_quantize_value(lin.weight.float(), out[True].w_scale, fmt)
        native = torch.equal(dequant_weight(out[True]), grid)
        same = (torch.equal(out[False].weight.cpu(), out[False, "cpu"].weight)
                and torch.equal(out[False].w_scale.cpu(), out[False, "cpu"].w_scale)
                and torch.equal(out[True].weight.cpu().view(torch.uint8),
                                out[True, "cpu"].weight.view(torch.uint8)))
        ok = native and same and out[True].weight.dtype == (
            torch.float8_e4m3fn if fmt == "e4m3" else torch.float8_e5m2)
        log(f"  fp8_7b {fmt} q_proj: native {out[True].weight.dtype} dequantized to the fake "
            f"grid {'bit for bit' if native else 'DIFFERENTLY'}; card vs CPU "
            f"{'bit-equal' if same else 'DIFFERENT'}; card {card_s * 1e3:.1f} ms -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fp8_7b {fmt}: the card's FP8 disagrees")
        rows.append(dict(name="fp8_7b", shape=f"{fmt} q_proj 4096->4096", card_s=card_s,
                         native_exact=native, card_cpu_equal=same))
    return rows


def spqr_codes(Q, s, z, g=16, bits=4, qq_bits=3, qq_g=16):
    """(codes on SpQR's double-quantized grid, outlier mask) of its Q."""
    import torch

    from mi_optimize_tpu_torch.quant.spqr_impl import _double_quant

    Q, s, z = Q.cpu(), s.cpu(), z.cpu()
    o, c = Q.shape
    qs = torch.stack([_double_quant(s[:, k], qq_bits, qq_g) for k in range(s.shape[1])], 1)
    qz = torch.stack([_double_quant(z[:, k], qq_bits, qq_g) for k in range(s.shape[1])], 1)
    Qg = Q.reshape(o, -1, g)
    codes = torch.clamp(torch.round(Qg / torch.clamp(qs, min=1e-9)[:, :, None] + qz[:, :, None]),
                        0, 2 ** bits - 1)
    out = ((codes - qz[:, :, None]) * qs[:, :, None] - Qg).abs() > 1e-5 * qs[:, :, None].abs()
    return codes.reshape(o, c), out.reshape(o, c)


def check_spqr_quip_7b(blk, H, stats, dev):
    """Rows spqr_7b and quip_7b on q_proj from the same Hessian (phase 2's
    card H, copied to the CPU) and, for QuIP, the same U and V (drawn once on
    the host): at least ALGO_SHARE of the codes equal; SpQR's outlier count
    within 1% of the CPU's; QuIP's output error ‖X(Ŵ−W)ᵀ‖² on the sampled
    calibration inputs within 1% of the CPU's."""
    from unittest import mock

    import numpy as np
    import torch

    from mi_optimize_tpu_torch.quant import quip_impl
    from mi_optimize_tpu_torch.quant.spqr_impl import spqr_quantize_matrix

    W, h = blk["q_proj"].weight, H["q_proj"]
    kw = dict(bits=4, blocksize=128, groupsize=16, qq_bits=3, qq_groupsize=16,
              rel_threshold=0.2)
    (Qg, sg, zg, ng), card_s = timed_s(lambda: spqr_quantize_matrix(W, h, **kw))
    t0 = time.perf_counter()
    Qc, sc, zc, nc = spqr_quantize_matrix(W.cpu(), h.cpu(), **kw)
    cpu_s = time.perf_counter() - t0
    (cg, og), (cc, oc) = spqr_codes(Qg, sg, zg), spqr_codes(Qc, sc, zc)
    eq, n_g, n_c = share_equal(cg, cc), float(ng), float(nc)
    ok = eq >= ALGO_SHARE and abs(n_g - n_c) <= 0.01 * n_c
    log(f"  spqr_7b q_proj (int4 g16, 3-bit qparams in 16s): codes {eq:.6f} equal (>= "
        f"{ALGO_SHARE}); outliers card {n_g:.0f}, CPU {n_c:.0f} (within 1%), positions "
        f"{share_equal(og, oc):.6f} equal; card {card_s:.2f} s, CPU {cpu_s:.2f} s -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("spqr_7b: the card's SpQR disagrees with the CPU's")
    rows = [dict(name="spqr_7b", shape="q_proj 4096->4096", card_s=card_s, cpu_s=cpu_s,
                 codes_equal=eq, outliers_card=n_g, outliers_cpu=n_c)]
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    U = quip_impl.rand_ortho_butterfly(rng, W.shape[0])
    V = quip_impl.rand_ortho_butterfly(rng, W.shape[1])
    uv_s = time.perf_counter() - t0
    codes, orig = [], quip_impl.round_ldl_gptqequiv

    def spy(w, Hh, nbits, blocksize=128):
        out = orig(w, Hh, nbits, blocksize=blocksize)
        codes.append(out.cpu())
        return out

    with mock.patch.object(quip_impl, "round_ldl_gptqequiv", spy):
        Wg, qcard_s = timed_s(lambda: quip_impl.quip_quantize_matrix(W, h, bits=4, U=U, V=V))
        t0 = time.perf_counter()
        Wc = quip_impl.quip_quantize_matrix(W.cpu(), h.cpu(), bits=4, U=U, V=V)
        qcpu_s = time.perf_counter() - t0
    X = torch.cat([a.to(dev) for a in stats["q_proj"]["inputs"]])
    Wf = W.float()
    errs = [float((X @ (Wq.to(dev) - Wf).t()).double().square().sum()) for Wq in (Wg, Wc)]
    eq = share_equal(codes[0], codes[1])
    rel = abs(errs[0] - errs[1]) / errs[1]
    ok = eq >= ALGO_SHARE and rel <= 0.01
    log(f"  quip_7b q_proj (int4, qfn b): codes {eq:.6f} equal (>= {ALGO_SHARE}); output error "
        f"card {errs[0]:.6e}, CPU {errs[1]:.6e} ({rel:.2e} relative, <= 1e-2); U and V "
        f"{uv_s:.2f} s on the host; card {qcard_s:.2f} s, CPU {qcpu_s:.2f} s -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("quip_7b: the card's QuIP disagrees with the CPU's")
    rows.append(dict(name="quip_7b", shape="q_proj 4096->4096", card_s=qcard_s, cpu_s=qcpu_s,
                     uv_host_s=uv_s, codes_equal=eq, output_error_card=errs[0],
                     output_error_cpu=errs[1]))
    return rows


def check_algorithms_7b(cfg, state, dev, flush):
    """Phase 2's rows of the other algorithms on the layer and inputs of
    check_calibration_7b (its card Hessians for SpQR and QuIP): awq_7b,
    smoothquant_7b, w8a8_7b, fp8_7b, spqr_7b and quip_7b. Returns (rows, the
    layer's stats for phase 5's awq_layer_7b)."""
    from mi_optimize_tpu_torch.quant.config import QuantConfig
    from mi_optimize_tpu_torch.quant.rtn import RTNAlgo

    blk, H, xs, rope = state
    c1 = dataclasses.replace(cfg, num_layers=1)
    stats, st_s = timed_s(lambda: layer_stats(blk, xs, rope, c1))
    log(f"  the layer's AWQ and SmoothQuant stats (8192 sampled tokens, absmean, absmax of its "
        f"four groups' inputs): {st_s:.2f} s")
    rows = check_awq_7b(blk, stats, dev)
    sq_rows, _ = check_smoothquant_7b(blk, stats, dev)
    rows += sq_rows
    rtn = RTNAlgo(QuantConfig(**RTN_AFFINE))
    rtn_lins = {n: rtn.quantize_linear(blk[n], {}) for n in ("q_proj", "down_proj")}
    rows += check_w8a8_7b(blk, stats, rtn_lins, dev, flush, reps=20)
    del rtn_lins
    rows += check_fp8_7b(blk, dev)
    rows += check_spqr_quip_7b(blk, H, stats, dev)
    return rows, stats


def awq_layer_window(state, stats):
    """Phase 5's awq_layer_7b: AWQ int4 g128 of one Llama-2-7B layer's seven
    linears from its four groups' stats (phase 2's)."""
    from mi_optimize_tpu_torch.quant.awq_impl import awq_quantize_linear
    from mi_optimize_tpu_torch.quant.config import QuantConfig

    blk, qcfg = state[0], QuantConfig(**AWQ_G128)
    return lambda: [awq_quantize_linear(qcfg, blk[n], stats[LEAD[n]]) for n in LINEAR_NAMES]


FUSED_DECODE = ("block_decode_mega", "model_decode_flat", "model_decode_mega",
                "model_decode_mega_batch", "mlp_fused")


def served_generate(qm, cfg, what, S=128, n=32):
    """generate on a quantized model served unfused: an S-token prompt and n
    new tokens (and 1, for the decode ms/token); tokens in range."""
    import numpy as np
    import torch

    from mi_optimize_tpu_torch.serving import engine

    prompt = np.random.default_rng(37).integers(0, cfg.vocab_size, (1, S))
    walls = {}
    for k in (n, 1):
        toks, walls[k] = timed_s(lambda: engine.generate(qm, prompt, max_new_tokens=k,
                                                         cache_dtype=torch.int8))
        new = toks[0, S:]
        if new.shape[0] != k or not bool(((new >= 0) & (new < cfg.vocab_size)).all()):
            raise AssertionError(f"{what}: generate returned out-of-range tokens")
    decode = (walls[n] - walls[1]) * 1e3 / (n - 1)
    log(f"  {what} generate, {S}-token prompt + {n} tokens: {walls[n] * 1e3:.1f} ms; decode "
        f"{decode:.3f} ms/token; first tokens {toks[0, S:S + 8].tolist()}")
    return dict(generate_ms=walls[n] * 1e3, decode_ms_per_token=decode)


def eval_routes(qm, tok, dev, what, tol=1e-2):
    """Benchmark.eval_ppl on 2 x 2048 wikitext test tokens by the fused route
    and by dequantize-then-matmul (fused=False): finite, within `tol`."""
    from mi_optimize_tpu_torch.eval.benchmark import Benchmark

    ppl, secs = {}, {}
    for fused in (True, False):
        ppl[fused], secs[fused] = timed_s(lambda: Benchmark(fused=fused, device=dev).eval_ppl(
            qm, tok, ["wikitext2"], seqlen=2048, nsamples=2)["wikitext2"])
    rel = abs(ppl[True] - ppl[False]) / ppl[False]
    ok = rel <= tol and 1.0 < ppl[True] < float("inf")
    log(f"  {what} Benchmark.eval_ppl wikitext2, 2 x 2048 tokens: fused {ppl[True]:.4f} "
        f"({secs[True]:.2f} s), dequantize-then-matmul {ppl[False]:.4f}: relative difference "
        f"{rel:.3e} vs {tol} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the fused route's perplexity disagrees")
    return dict(ppl=ppl[True], ppl_unfused_route=ppl[False], ppl_rel_diff=rel,
                eval_ppl_s=secs[True])


def no_fused_decode(what, counts):
    bad = [k for k in FUSED_DECODE if counts[k]]
    if bad:
        raise AssertionError(f"{what} launched {bad}: smooth-factor models are served unfused")


def serve_awq(fp, cfg, dev):
    """Path p: AWQ int4 g128 of the fp model (calibration CALIB through
    get_calibrate_loader); generate (B1 gemv16 and B6; no fused-model decode
    kernel and no fused MLP: every linear carries its smooth factor);
    Benchmark.eval_ppl, the fused route (B1 mma) within 1e-2 of
    dequantize-then-matmul; and, reported, AWQ's and RTN's (int4 g128
    affine) output errors ‖X(Ŵ−W)ᵀ‖² on layer 0's and the last layer's
    calibration inputs."""
    from mi_optimize_tpu_torch.datasets.calibration import get_calibrate_loader
    from mi_optimize_tpu_torch.datasets.tokenizer import ByteTokenizer
    from mi_optimize_tpu_torch.quant import QuantConfig, quantize

    tok, L = ByteTokenizer(), cfg.num_layers
    qcfg = QuantConfig.from_dict(dict(AWQ_G128, calibrate_config=CALIB))
    qm, calib_s = timed_s(lambda: quantize(fp, qcfg, tokenizer=tok, device=dev))
    log(f"  quantize (AWQ int4 g128, {CALIB['nsamples']} x {CALIB['seqlen']} wikitext tokens, "
        f"{L} layers): {calib_s:.1f} s, {calib_s / L:.3f} s a layer")
    res = dict(layers=L, calib_s=calib_s, s_per_layer=calib_s / L)
    res.update(served_generate(qm, cfg, "AWQ"))
    res.update(eval_routes(qm, tok, dev, "AWQ"))
    rm = quantize(fp, QuantConfig.from_dict(RTN_AFFINE), device=dev)
    batches = get_calibrate_loader(tok, qcfg.calibrate)
    errs = {}
    for i, blk, xs, rope in fp_block_pass(fp.params, cfg, batches, dev):
        if i not in (0, L - 1):
            continue
        e = output_errors(blk, {"awq": qm.params["layers"][i], "rtn": rm.params["layers"][i]},
                          xs, rope, cfg)
        errs[i] = {n: [e["awq"][n], e["rtn"][n]] for n in LINEAR_NAMES}
        log(f"  layer {i}, AWQ/RTN output error ‖X(Ŵ−W)ᵀ‖² on its calibration inputs "
            f"(reported): " + ", ".join(f"{n} {a / r:.3f}" for n, (a, r) in errs[i].items()))
    res["output_error_awq_rtn"] = errs
    return res


def serve_smoothquant(fp, cfg, dev):
    """Path q: SmoothQuant W8A8 (alpha 0.5, int8 per-channel weights, int8
    dynamic per-token activations) of the fp model: generate (the W8A8 route,
    B6); Benchmark.eval_ppl: the W8A8 route within 1e-2 of the fake-quant
    route (fused=False) and within 5% of the fp model's perplexity."""
    from mi_optimize_tpu_torch.datasets.tokenizer import ByteTokenizer
    from mi_optimize_tpu_torch.eval.benchmark import Benchmark
    from mi_optimize_tpu_torch.quant import QuantConfig, quantize

    tok, L = ByteTokenizer(), cfg.num_layers
    qcfg = QuantConfig.from_dict(dict(SQ_W8A8, calibrate_config=CALIB))
    qm, calib_s = timed_s(lambda: quantize(fp, qcfg, tokenizer=tok, device=dev))
    log(f"  quantize (SmoothQuant W8A8, {L} layers): {calib_s:.1f} s, {calib_s / L:.3f} s a layer")
    res = dict(layers=L, calib_s=calib_s, s_per_layer=calib_s / L)
    fp_ppl = Benchmark(device=dev).eval_ppl(fp, tok, ["wikitext2"], seqlen=2048,
                                            nsamples=2)["wikitext2"]
    res.update(served_generate(qm, cfg, "SmoothQuant W8A8"))
    res.update(eval_routes(qm, tok, dev, "SmoothQuant W8A8 (route: torch._int_mm)"))
    rel = abs(res["ppl"] - fp_ppl) / fp_ppl
    log(f"  SmoothQuant W8A8 perplexity {res['ppl']:.4f} against the fp model's {fp_ppl:.4f}: "
        f"{rel:.3e} relative (<= 0.05) -> {'ok' if rel <= 0.05 else 'FAIL'}")
    if not rel <= 0.05:
        raise AssertionError("path q: the W8A8 model's perplexity is off the fp model's")
    res.update(fp_ppl=fp_ppl, fp_rel=rel)
    return res


def serve_other_algos(fp, cfg, dev):
    """Path r: ZeroQuant (int8 g128, int8 per-token), FP8 E4M3 (native
    storage), AWQ+GPTQ (int4 g128) and SmoothQuant+GPTQ (int8 per channel,
    int8 per-token) on the first 2 layers of the fp model; each perplexity
    finite, the fused route within 1e-2 of dequantize-then-matmul; FP8's
    weights float8_e4m3fn."""
    import torch

    from mi_optimize_tpu_torch.datasets.tokenizer import ByteTokenizer
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.ops import dequant_matmul
    from mi_optimize_tpu_torch.quant import QuantConfig, quantize

    c2 = dataclasses.replace(cfg, num_layers=2)
    fp2 = Model(config=c2, params=dict(fp.params, layers=fp.params["layers"][:2]))
    tok, res = ByteTokenizer(), {}
    for name, qd in (("zeroquant", ZQ_W8A8), ("fp8", dict(FP8_E4M3, pack=True)),
                     ("awq+gptq", AWQ_GPTQ), ("smoothquant+gptq", SQ_GPTQ)):
        qcfg = QuantConfig.from_dict(dict(qd, calibrate_config=CALIB))
        qm, calib_s = timed_s(lambda: quantize(fp2, qcfg, tokenizer=tok, device=dev))
        log(f"  quantize ({name}, 2 layers): {calib_s:.1f} s")
        if name == "fp8" and qm.params["layers"][0]["q_proj"].weight.dtype != torch.float8_e4m3fn:
            raise AssertionError("path r: FP8's stored weights are not float8_e4m3fn")
        before = dequant_matmul.launches
        res[name] = dict(calib_s=calib_s, **eval_routes(qm, tok, dev, name))
        if name == "zeroquant" and dequant_matmul.launches == before:
            raise AssertionError("path r: ZeroQuant's 8-bit linears launched no CUDA-core "
                                 "dequant_matmul kernel")
    return res


# ---------------------------------------------------------------------------
# path s: a Llama-2-7B-shaped HF checkpoint on disk -> load -> calibrate on
# C-Eval with an interrupted and resumed journal -> save / reload -> PPL,
# C-Eval, CMMLU, BOSS -> beam search
# ---------------------------------------------------------------------------

# meta-llama/Llama-2-7b-hf's published config.json, cut to CKPT_LAYERS layers
LLAMA2_7B_HF = {"architectures": ["LlamaForCausalLM"], "bos_token_id": 1, "eos_token_id": 2,
                "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02,
                "intermediate_size": 11008, "max_position_embeddings": 4096,
                "model_type": "llama", "num_attention_heads": 32, "num_hidden_layers": 32,
                "num_key_value_heads": 32, "pretraining_tp": 1, "rms_norm_eps": 1e-05,
                "rope_scaling": None, "tie_word_embeddings": False, "torch_dtype": "float16",
                "use_cache": True, "vocab_size": 32000}
CKPT_LAYERS = 3             # path s's depth: three GPTQ passes of 4.5-7.5 s a layer (PERF.md
                            # §4); the interrupted pass stops after block 1 of 3
CEVAL_CALIB = {"name": "ceval", "nsamples": 1, "seqlen": 2048}   # one question a subject
MCQA_TIE = 2e-2             # MCQA predictions held where the top two letters are this x max|logit| apart
INT8_TOL = 5e-2             # int8-cache logits held within this x max|logit| of the float32 cache's
INT8_NEW = 16               # tokens a BOSS question that path s decodes with the int8 cache
BEAM_W, BEAM_NEW, BEAM_PROMPT, BEAM_LEN = 4, 32, 150, 256


def write_safetensors(path, tensors):
    """A .safetensors file of `tensors` ({name: CPU tensor}, f32/f16/bf16):
    the 8-byte header length, the JSON header padded with spaces to 8
    bytes, then the raw little-endian buffers in header order."""
    import json as _json

    import torch

    names = sorted(tensors)
    header, off = {"__metadata__": {"format": "pt"}}, 0
    st = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"}
    for n in names:
        t = tensors[n]
        header[n] = {"dtype": st[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + t.numel() * t.element_size()]}
        off += t.numel() * t.element_size()
    h = _json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little") + h)
        for n in names:
            t = tensors[n].contiguous()
            f.write(t.view(torch.uint8).reshape(-1).numpy().tobytes())


def write_hf_checkpoint(root, hf_cfg, dev, seed=0, shards=2):
    """config.json and `shards` .safetensors files of f16 weights drawn on
    the card from `seed` at fp_llama's scales (linears N(0, 1/fan-in), the
    embedding N(0, 0.02^2), norms 1). Returns {name: f16 tensor on dev}."""
    import torch

    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=1)
    h, inter, V = hf_cfg["hidden_size"], hf_cfg["intermediate_size"], hf_cfg["vocab_size"]
    q = hf_cfg["num_attention_heads"] * (h // hf_cfg["num_attention_heads"])
    kv = hf_cfg["num_key_value_heads"] * (h // hf_cfg["num_attention_heads"])
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape, scale=None):
        x = torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32)
        return (x * (shape[1] ** -0.5 if scale is None else scale)).to(torch.float16)

    t = {"model.embed_tokens.weight": w(V, h, scale=0.02),
         "model.norm.weight": torch.ones(h, dtype=torch.float16, device=dev),
         "lm_head.weight": w(V, h)}
    for i in range(hf_cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        t.update({f"{p}.input_layernorm.weight": torch.ones(h, dtype=torch.float16, device=dev),
                  f"{p}.post_attention_layernorm.weight": torch.ones(h, dtype=torch.float16,
                                                                     device=dev),
                  f"{p}.self_attn.q_proj.weight": w(q, h), f"{p}.self_attn.k_proj.weight": w(kv, h),
                  f"{p}.self_attn.v_proj.weight": w(kv, h), f"{p}.self_attn.o_proj.weight": w(h, q),
                  f"{p}.mlp.gate_proj.weight": w(inter, h), f"{p}.mlp.up_proj.weight": w(inter, h),
                  f"{p}.mlp.down_proj.weight": w(h, inter)})
    names = sorted(t)
    for s in range(shards):
        write_safetensors(os.path.join(root, f"model-{s + 1:05d}-of-{shards:05d}.safetensors"),
                          {n: t[n].cpu() for n in names[s::shards]})
    return t


def hf_tensors(params):
    """The loaded model's tensors under their HF names (untied llama)."""
    out = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"],
           "lm_head.weight": params["lm_head"].weight}
    for i, blk in enumerate(params["layers"]):
        p = f"model.layers.{i}"
        out[f"{p}.input_layernorm.weight"] = blk["input_norm"]
        out[f"{p}.post_attention_layernorm.weight"] = blk["post_norm"]
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out[f"{p}.self_attn.{n}.weight"] = blk[n].weight
        for n in ("gate_proj", "up_proj", "down_proj"):
            out[f"{p}.mlp.{n}.weight"] = blk[n].weight
    return out


def tree_tensors(params):
    """{path: tensor} of every tensor of a params tree (QuantizedLinear
    fields under path.field)."""
    import torch

    out = {}

    def walk(node, key):
        if isinstance(node, torch.Tensor):
            out[key] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                if k != "mega":
                    walk(v, f"{key}.{k}" if key else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{key}.{i}")
        elif dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                if f.init:
                    walk(getattr(node, f.name), f"{key}.{f.name}")
    walk(params, "")
    return out


def bit_diffs(got, want):
    """{path: entries whose bits differ} over two params trees (a path
    missing on one side, or of another dtype or shape, counts as -1)."""
    import torch

    g, w = tree_tensors(got), tree_tensors(want)
    out = {}
    for k in sorted(set(g) | set(w)):
        a, b = g.get(k), w.get(k)
        if a is None or b is None or a.dtype != b.dtype or a.shape != b.shape:
            out[k] = -1
            continue
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        n = int((a.reshape(-1).view(bits) != b.reshape(-1).view(bits)).sum()) if a.numel() else 0
        if n:
            out[k] = n
    return out


def mcqa_gate(calls, params, cfg, letters, fused):
    """Each recorded C-Eval / CMMLU prediction (the padded bucket's letter
    logits at L-1) against the argmax over the letter logits of an unpadded
    forward of the same prompt, wherever that forward's top two letters are
    more than MCQA_TIE x max|logit| apart. Returns (held, near-ties)."""
    import torch

    from mi_optimize_tpu_torch.models import llama

    held = ties = 0
    for ids, last, row in calls:
        with torch.no_grad():
            ref = llama.forward(params, cfg, ids[:, :last + 1], fused=fused)[0, last]
        ref = ref.to(torch.float32)
        lt = ref[letters]
        top2 = torch.topk(lt, 2).values
        if float(top2[0] - top2[1]) <= MCQA_TIE * float(ref.abs().max()):
            ties += 1
            continue
        held += 1
        if int(torch.argmax(row[letters])) != int(torch.argmax(lt)):
            raise AssertionError("path s: an MCQA prediction of the padded bucket differs from "
                                 "the unpadded forward's")
    return held, ties


def int8_gate(model, prompts, n_new):
    """Greedy decoding with the int8 cache (engine.generate: on an unfused
    model on the card, the decode attention) held against the float32 cache
    on the same prompts: each step's int8 and float32 logits, taken by
    decode_step fed the int8 route's tokens, must be within INT8_TOL x
    max|logit| of each other, and the int8 ones' argmax must be generate's
    token. Returns (steps, the largest difference over max|logit|, steps
    whose float32 argmax is the int8 token)."""
    import torch

    from mi_optimize_tpu_torch.serving import engine

    params, cfg = model.params, model.config
    dev = params["embed"].device
    steps = same = 0
    worst = 0.0
    for ids in prompts:
        S = ids.shape[1]
        max_len = -(-(S + n_new) // 128) * 128
        toks = engine.generate(model, ids, max_new_tokens=n_new, max_len=max_len,
                               cache_dtype=torch.int8)[0, S:]
        x = torch.as_tensor(ids, device=dev)
        l8, c8 = engine.prefill(params, cfg, x, engine.init_cache(cfg, 1, max_len, torch.int8,
                                                                  device=dev))
        l32, c32 = engine.prefill(params, cfg, x, engine.init_cache(cfg, 1, max_len,
                                                                    torch.float32, device=dev))
        for i, t in enumerate(toks):
            a, b = l8[0].to(torch.float32), l32[0].to(torch.float32)
            if int(torch.argmax(a)) != int(t):
                raise AssertionError("path s: generate's int8-cache token differs from "
                                     "decode_step's argmax")
            worst = max(worst, float((a - b).abs().max() / b.abs().max()))
            same += int(torch.argmax(b)) == int(t)
            steps += 1
            if i + 1 < len(toks):
                tok = torch.tensor([[int(t)]], device=dev)
                l8, c8 = engine.decode_step(params, cfg, tok, c8, S + i)
                l32, c32 = engine.decode_step(params, cfg, tok, c32, S + i)
    if worst > INT8_TOL:
        raise AssertionError(f"path s: the int8-cache logits are {worst:.3g} x max|logit| from "
                             f"the float32 cache's (limit {INT8_TOL})")
    return steps, worst, same


def serve_checkpoint(hf_cfg, dev, target, m_t, root, manifest_path=None):
    """Path s: write a checkpoint in the HF safetensors format (hf_cfg, f16,
    two shards), load it onto the card (f32: every tensor equal to what was
    written; bf16: equal to it rounded), quantize the bf16 model by GPTQ
    int4 g128 affine calibrated on the C-Eval fixture (CEVAL_CALIB through
    get_calibrate_loader: one question a subject, of their own lengths) twice
    uninterrupted and once through a CalibrationJournal that stops the pass
    after block 1 and a second call that resumes it (its words, scales and
    zeros equal to the two uninterrupted passes' wherever those agree),
    save_model / load_model (every array bit-equal; the wikitext PPL of one
    2048-token batch equal), Benchmark.eval_ceval / eval_cmmlu (2 questions
    a subject; each prediction held against an unpadded forward by
    mcqa_gate) and eval_boss (4 QA questions), the same questions through
    generate with the int8 cache (the decode attention) held against the
    float32 cache by int8_gate, then after fuse_for_serving beam_search (W = BEAM_W,
    BEAM_NEW tokens, a BEAM_PROMPT-token prompt: one full page and a tail)
    against dense_beam on mode (a) (the same hypotheses, scores within
    1e-5), W = 1 against PagedMegaBatcher's greedy tokens, and W = BEAM_W
    on the planted target (its top hypothesis the planted chain); a
    RunManifest of the phases and a Memory round trip of the embedding
    (card, host, disk, card) bit-equal. Accuracies are of random weights."""
    import shutil

    import numpy as np
    import torch

    from mi_optimize_tpu_torch.datasets.boss import get_testdata_boss, get_zeroshot_prompt
    from mi_optimize_tpu_torch.datasets.calibration import get_calibrate_loader
    from mi_optimize_tpu_torch.datasets.tokenizer import ByteTokenizer, encode_ids
    from mi_optimize_tpu_torch.eval import mcqa
    from mi_optimize_tpu_torch.eval.benchmark import Benchmark
    from mi_optimize_tpu_torch.export import CalibrationJournal, load_model, save_model
    from mi_optimize_tpu_torch.memory import Memory
    from mi_optimize_tpu_torch.models.loader import load_llama_from_hf
    from mi_optimize_tpu_torch.quant import QuantConfig, quantize
    from mi_optimize_tpu_torch.serving.beam import beam_search
    from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
    from mi_optimize_tpu_torch.serving.paged import PagedMegaBatcher
    from mi_optimize_tpu_torch.utils import RunManifest

    tok, res = ByteTokenizer(), {}
    qcfg = QuantConfig.from_dict(dict(GPTQ_AFFINE, actorder=False, calibrate_config=CEVAL_CALIB))
    man = RunManifest("path_s", config=qcfg)
    ck, qdir, jdir = (os.path.join(root, d) for d in ("hf", "quantized", "journal"))
    shutil.rmtree(root, ignore_errors=True)

    def timed(name, fn):
        with man.phase(name):
            out, s = timed_s(fn)
        res[f"{name}_s"] = s
        return out

    written = timed("write", lambda: write_hf_checkpoint(ck, hf_cfg, dev))
    nbytes_ck = sum(os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck))
    res["checkpoint_bytes"] = nbytes_ck
    log(f"  wrote {len(written)} f16 tensors, {nbytes_ck / 1e9:.3f} GB in 2 shards: "
        f"{res['write_s']:.1f} s")
    m32 = timed("load", lambda: load_llama_from_hf(ck, dtype=torch.float32))
    bad = [n for n, t in hf_tensors(m32.params).items()
           if t.dtype != torch.float32 or t.device.type != torch.device(dev).type
           or not torch.equal(t, written[n].float())]
    cfg = m32.config
    log(f"  load_llama_from_hf (f32, on the card, warm page cache): {res['load_s']:.2f} s; "
        f"{len(written) - len(bad)} of {len(written)} tensors equal to what was written -> "
        f"{'ok' if not bad else 'FAIL'}")
    if bad or cfg.num_layers != hf_cfg["num_hidden_layers"] or cfg.max_seq_len != 4096:
        raise AssertionError(f"path s: the loaded checkpoint differs from the written one: {bad[:4]}")
    del m32
    fp = timed("load_bf16", lambda: load_llama_from_hf(ck, dtype=torch.bfloat16))
    bad = [n for n, t in hf_tensors(fp.params).items()
           if not torch.equal(t, written[n].to(torch.bfloat16))]
    if bad:
        raise AssertionError(f"path s: the bf16 load differs from the written values: {bad[:4]}")
    del written
    torch.cuda.empty_cache()

    batches = get_calibrate_loader(tok, qcfg.calibrate)
    lens = [b.shape[1] for b in batches]
    log(f"  C-Eval calibration set: {len(batches)} questions of {min(lens)}-{max(lens)} tokens "
        f"({sum(lens)} in all)")
    res["calib_len_range"] = [min(lens), max(lens)]
    res["calib_questions"], res["calib_tokens"] = len(batches), sum(lens)
    qa = timed("calibrate", lambda: quantize(fp, qcfg, tokenizer=tok, device=dev))
    qb = timed("calibrate_again", lambda: quantize(fp, qcfg, tokenizer=tok, device=dev))

    class Interrupted(Exception):
        pass

    class StopAfter1(CalibrationJournal):
        def save_block(self, i, blk, xs=None):
            super().save_block(i, blk, xs=xs)
            if i == 1:
                raise Interrupted

    def interrupted():
        try:
            quantize(fp, qcfg, tokenizer=tok, journal=StopAfter1(jdir), device=dev)
        except Interrupted:
            return CalibrationJournal(jdir).last_completed()
        raise AssertionError("path s: the interrupted pass ran to its end")

    stopped = timed("interrupted", interrupted)
    qr = timed("resume", lambda: quantize(fp, qcfg, tokenizer=tok,
                                          journal=CalibrationJournal(jdir), device=dev))
    ab = bit_diffs(qa.params["layers"], qb.params["layers"])
    if any(v < 0 for v in ab.values()):
        raise AssertionError(f"path s: two uninterrupted passes differ in layout: {ab}")
    held = {}
    ta, tb, trs = (tree_tensors(q.params["layers"]) for q in (qa, qb, qr))
    for k, a in ta.items():
        same = a == tb[k] if k in ab else torch.ones_like(a, dtype=torch.bool)
        if trs[k].dtype != a.dtype or not torch.equal(trs[k][same], a[same]):
            held[k] = int((trs[k][same] != a[same]).sum()) if trs[k].dtype == a.dtype else -1
    L = cfg.num_layers
    log(f"  quantize GPTQ int4 g128 on C-Eval, {L} layers: {res['calibrate_s']:.1f} s and "
        f"{res['calibrate_again_s']:.1f} s uninterrupted ({res['calibrate_s'] / L:.2f} s a layer; "
        f"{sum(ab.values())} entries of the two passes differ, in {len(ab)} arrays); stopped "
        f"after block {stopped} in {res['interrupted_s']:.1f} s, resumed in {res['resume_s']:.1f} "
        f"s: words, scales and zeros equal to the uninterrupted passes' -> "
        f"{'ok' if not held else 'FAIL'}")
    if stopped != 1 or held:
        raise AssertionError(f"path s: the resumed pass differs: {held}")
    res.update(uninterrupted_diff_entries=sum(ab.values()), stopped_after=stopped)
    del qb, qr, fp
    torch.cuda.empty_cache()

    timed("save", lambda: save_model(qa, qdir))
    nbytes_q = sum(os.path.getsize(os.path.join(qdir, f)) for f in os.listdir(qdir))
    res["saved_bytes"] = nbytes_q
    rm = timed("reload", lambda: load_model(qdir))
    diff = bit_diffs(rm.params, qa.params)
    log(f"  save_model {res['save_s']:.1f} s ({nbytes_q / 1e9:.3f} GB), load_model "
        f"{res['reload_s']:.2f} s: {len(tree_tensors(rm.params))} arrays, bit-equal -> "
        f"{'ok' if not diff and rm.config == cfg else 'FAIL'}")
    if diff or rm.config != cfg or rm.params["embed"].device.type != torch.device(dev).type:
        raise AssertionError(f"path s: the reloaded model differs: {diff}")
    bench = Benchmark(fused=True, device=dev)
    ppl = {}
    with man.phase("ppl"):
        for name, m in (("in_memory", qa), ("reloaded", rm)):
            ppl[name] = bench.eval_ppl(m, tok, ["wikitext2"], seqlen=2048, nsamples=1)["wikitext2"]
    log(f"  Benchmark.eval_ppl wikitext2, 1 x 2048 tokens: in memory {ppl['in_memory']!r}, "
        f"reloaded {ppl['reloaded']!r} -> {'ok' if ppl['in_memory'] == ppl['reloaded'] else 'FAIL'}")
    if ppl["in_memory"] != ppl["reloaded"] or not np.isfinite(ppl["reloaded"]):
        raise AssertionError("path s: the reloaded model's perplexity differs")
    res["ppl"] = ppl["reloaded"]
    man.metric("ppl_wikitext2_2048", ppl["reloaded"])
    del qa
    torch.cuda.empty_cache()

    calls = []
    last_logits = mcqa._last_logits

    def recording(params, c, ids, last_idx, fused=True):
        out = last_logits(params, c, ids, last_idx, fused)
        calls.append((ids, int(last_idx[0]), out[0].to(torch.float32)))
        return out

    mcqa._last_logits = recording
    try:
        with man.phase("eval"):
            t0 = time.perf_counter()
            ce = bench.eval_ceval(rm, tok, max_questions=2)
            cm = bench.eval_cmmlu(rm, tok, max_questions=2)
            mcqa_s = time.perf_counter() - t0
            bo, boss_s = timed_s(lambda: bench.eval_boss(rm, tok, max_questions=4))
    finally:
        mcqa._last_logits = last_logits
    with man.phase("int8_decode"):
        boss_ids = [encode_ids(tok, get_zeroshot_prompt("QuestionAnswering") + q)
                    for q in get_testdata_boss("QuestionAnswering", "advqa")[0][:4]]
        (i8_steps, i8_err, i8_same), i8_s = timed_s(
            lambda: int8_gate(rm, boss_ids, INT8_NEW))
    gated, ties = mcqa_gate(calls, rm.params, cfg, mcqa._letter_ids(tok), True)
    acc = {b: sum(c["correct"] for c in r["categories"].values())
           / max(sum(c["total"] for c in r["categories"].values()), 1)
           for b, r in (("ceval", ce), ("cmmlu", cm))}
    log(f"  C-Eval {len(ce['subjects'])} subjects, CMMLU {len(cm['subjects'])}, 2 questions a "
        f"subject: accuracy {acc['ceval']:.3f} and {acc['cmmlu']:.3f} (random weights: 0.25 "
        f"expected) in {mcqa_s:.1f} s; {gated} of {len(calls)} predictions held against an "
        f"unpadded forward, {ties} near-ties left out -> ok; BOSS QA advqa, 4 questions: "
        f"{bo} in {boss_s:.1f} s")
    log(f"  the same 4 questions, {INT8_NEW} tokens each through generate with the int8 cache "
        f"(decode attention): {i8_steps} steps' logits within {i8_err:.4g} x max|logit| of the "
        f"float32 cache's (limit {INT8_TOL}), {i8_same} of {i8_steps} argmaxes the same, in "
        f"{i8_s:.1f} s -> ok")
    res.update(ceval_acc=acc["ceval"], cmmlu_acc=acc["cmmlu"], mcqa_s=mcqa_s, boss=bo,
               boss_s=boss_s, mcqa_questions=len(calls), mcqa_held=gated, mcqa_ties=ties,
               int8_steps=i8_steps, int8_max_rel_err=i8_err, int8_same_argmax=i8_same,
               int8_s=i8_s)
    man.metric("ceval_acc", acc["ceval"])
    man.metric("cmmlu_acc", acc["cmmlu"])
    man.metric("boss_qa", bo)

    sm = fuse_for_serving(rm)
    del rm
    prompt = np.random.default_rng(47).integers(0, cfg.vocab_size, (BEAM_PROMPT,))
    with man.phase("beam"):
        got, beam_s = timed_s(lambda: beam_search(sm, prompt, beam_width=BEAM_W,
                                                  max_new_tokens=BEAM_NEW, max_len=BEAM_LEN))
        ref, dense_s = timed_s(lambda: dense_beam(sm, prompt, BEAM_W, BEAM_NEW, max_len=BEAM_LEN))
    ok = len(got) == len(ref) == BEAM_W and all(
        g[0] == r[0] and abs(g[1] - r[1]) <= 1e-5 * abs(r[1]) for g, r in zip(got, ref))
    log(f"  beam_search W={BEAM_W}, {BEAM_NEW} tokens after {BEAM_PROMPT}: {beam_s:.2f} s "
        f"({beam_s / BEAM_NEW * 1e3:.1f} ms a step), the dense reference on mode (a) "
        f"{dense_s:.2f} s; hypotheses equal, scores within 1e-5 -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"path s: beam_search differs from the dense reference: {got} {ref}")
    one = beam_search(sm, prompt, beam_width=1, max_new_tokens=BEAM_NEW, max_len=BEAM_LEN)
    greedy = list(PagedMegaBatcher(sm, n_slots=1, max_len=BEAM_LEN, page_size=128, n_pages=4)
                  .run_all([prompt], max_new_tokens=BEAM_NEW).values())[0]
    log(f"  beam_search W=1: {BEAM_NEW} tokens equal to PagedMegaBatcher's greedy ones (one "
        f"slot) -> {'ok' if one[0][0] == list(greedy) else 'FAIL'}")
    if one[0][0] != list(greedy):
        raise AssertionError("path s: beam_search W=1 differs from greedy decoding")
    pp = np.random.default_rng(48).integers(0, cfg.vocab_size, (BEAM_PROMPT,))
    planted = beam_search(target, pp, beam_width=BEAM_W, max_new_tokens=BEAM_NEW,
                          max_len=BEAM_LEN)
    gate_chain(f"beam_search W={BEAM_W} on the planted target, top hypothesis", planted[0][0],
               planted_chain(m_t, int(pp[-1]), BEAM_NEW))
    res.update(beam_s=beam_s, beam_ms_per_step=beam_s / BEAM_NEW * 1e3, dense_beam_s=dense_s,
               beam=[[list(map(int, t)), float(s)] for t, s in got])

    emb = sm.params["embed"]
    mem = Memory(emb, spill_dir=root)
    trail = [mem.desc]
    for where in ("host", "disk", "device"):
        mem.to(where)
        trail.append(mem.desc)
    back = mem.value
    if not (back.device == emb.device and back.dtype == emb.dtype
            and torch.equal(back.view(torch.int16), emb.view(torch.int16))):
        raise AssertionError("path s: the Memory round trip of the embedding changed its bits")
    log(f"  Memory round trip of the embedding ({tuple(emb.shape)} {emb.dtype}): "
        f"{' -> '.join(trail)}, bit-equal -> ok")
    res["manifest"] = man.data
    if manifest_path:
        man.save(manifest_path)
    log("  phases (s): " + ", ".join(f"{k} {v}" for k, v in man.data["phases"].items()))
    shutil.rmtree(root, ignore_errors=True)
    return res


# stats of calibration forwards that quantize activations (SmoothQuant's
# per-token int8 grid): a code at a rounding tie moves a step, 1/127 of its
# row's absmax, where the two devices' last bits differ
ACT_STATS_RTOL = 1e-2
# (name, config, the rule card vs CPU from the same stats: "exact" words,
# scales and zeros; "codes" the codes, or the weights where unpacked; "ldl"
# QuIP's codes in the rotated domain, where one flipped code moves every
# weight of its row and column after the inverse rotation)
SMALL_ALGOS = (
    ("RTN", RTN_AFFINE, "exact"), ("SmoothQuant", SQ_W8A8, "exact"),
    ("ZeroQuant", ZQ_W8A8, "exact"), ("FP8", dict(FP8_E4M3, pack=True), "exact"),
    ("AWQ", AWQ_G128, "codes"), ("AWQ+GPTQ", AWQ_GPTQ, "codes"),
    ("SmoothQuant+GPTQ", SQ_GPTQ, "codes"), ("SpQR", SPQR_G16, "codes"),
    ("QuIP", QUIP_B, "ldl"))


def _stats_rel(a, b):
    """The largest relative (Frobenius) difference over two calls' stats;
    counts must be equal."""
    import torch

    worst = 0.0
    for k in b:
        if k in ("nsamples", "ntokens"):
            if float(a[k]) != float(b[k]):
                return float("inf")
            continue
        x, y = (torch.cat(a[k]), torch.cat(b[k])) if k == "inputs" else (a[k], b[k])
        worst = max(worst, fro_rel(x.cpu(), y.cpu()) if float(y.norm()) else float(x.norm()))
    return worst


def _same_linear(got, want, rule):
    """(share of equal codes or weights, bit-equal words, scales and zeros)
    of two linears of one algorithm."""
    import torch

    if got.packed is not None:
        a, b = lin_codes(got), lin_codes(want)
    else:
        a, b = got.weight.cpu().float(), want.weight.cpu().float()
        if rule == "codes":  # unpacked (SpQR, QuIP): weights equal within 1e-5 of the max
            a = torch.where((a - b).abs() <= 1e-5 * b.abs().max(), b, a)
    exact = all(torch.equal(getattr(got, f).cpu().view(torch.uint8), getattr(want, f).cpu().view(
        torch.uint8)) for f in ("packed", "weight", "w_scale", "w_zero")
        if getattr(want, f) is not None)
    return share_equal(a, b), exact


def small_algorithms_check(dev):
    """The other nine algorithm configurations on the small f32 model of
    `small_calibration_check`, quantized on the card: every calibration call's
    stats within HESS_F32_RTOL (relative, Frobenius; counts equal; where the
    forwards quantize activations, ACT_STATS_RTOL) of the CPU calibration's
    on the card's quantized states (its calls given the card's results);
    then each linear on the CPU from the card's stats: RTN, SmoothQuant,
    ZeroQuant and FP8 bit-equal (words or float8 bytes, scales, zeros);
    AWQ, AWQ+GPTQ, SmoothQuant+GPTQ, SpQR and QuIP at least ALGO_SHARE of
    the codes (of the weights where unpacked; QuIP's LDL codes) equal."""
    import torch

    from mi_optimize_tpu_torch.datasets.calibration import get_wikitext2
    from mi_optimize_tpu_torch.datasets.tokenizer import ByteTokenizer
    from mi_optimize_tpu_torch.models.llama import LlamaConfig, init_params
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.quant import QuantConfig, get_algo, quantize, quip_impl

    cfg = LlamaConfig(vocab_size=320, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512)
    cpu = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    calib = get_wikitext2(ByteTokenizer(), split="train", nsamples=4, seqlen=128, seed=0)
    res = {}
    for name, qd, rule in SMALL_ALGOS:
        qcfg = QuantConfig(**qd)
        algo = get_algo(qcfg.algo, qcfg)
        ldl, orig_ldl = [], quip_impl.round_ldl_gptqequiv

        def spy(w, Hh, nbits, blocksize=128):
            out = orig_ldl(w, Hh, nbits, blocksize=blocksize)
            ldl.append(out.cpu())
            return out

        quip_impl.round_ldl_gptqequiv = spy
        try:
            with algo_calls(keep=True, cls=type(algo)) as rec:
                quantize(Model(config=cfg, params=_to(cpu, dev)), qcfg, calib_data=calib,
                         device=dev)
            with algo_calls(keep=True, cls=type(algo),
                            results=[_to(c[2], "cpu") for c in rec.calls]) as cpu_rec:
                quantize(Model(config=cfg, params=cpu), qcfg, calib_data=calib, device="cpu")
            n_card, shares, exact = len(ldl), [], True
            for lin, st, out in rec.calls:
                share, same = _same_linear(
                    out, algo.quantize_linear(_to(lin, "cpu"), _to(st, "cpu")), rule)
                shares.append(share)
                exact = exact and same
        finally:
            quip_impl.round_ldl_gptqequiv = orig_ldl
        n = len(LINEAR_NAMES) * cfg.num_layers
        stats_rel = max((_stats_rel(c[1], d[1]) for c, d in zip(rec.calls, cpu_rec.calls)),
                        default=0.0)
        if rule == "ldl":  # the card's codes, then the CPU replay's, call by call
            shares = [share_equal(a, b) for a, b in zip(ldl[:n_card], ldl[n_card:])]
            if len(ldl) != 2 * n:
                raise AssertionError("small model, QuIP: its LDL rounding was not called")
        low = min(shares)
        rtol = ACT_STATS_RTOL if qcfg.quantize_acts and qcfg.algo != "fp8" else HESS_F32_RTOL
        ok = (len(rec.calls) == len(cpu_rec.calls) == n and stats_rel <= rtol
              and (exact if rule == "exact" else low >= ALGO_SHARE))
        log(f"  small f32 model, {name}: stats of all {len(rec.calls)} calls card vs the CPU "
            f"calibration's {stats_rel:.2e} (<= {rtol}); each linear on the CPU from the "
            f"card's stats: " + (f"words, scales and zeros {'bit-equal' if exact else 'DIFFER'}"
                                 if rule == "exact" else
                                 f"at least {low:.6f} of the codes equal (>= {ALGO_SHARE})") +
            f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"small model, {name}: the card's quantization disagrees")
        res[name] = dict(stats_rel=stats_rel, min_codes_equal=low, bit_equal=exact)
    return res

# ---------------------------------------------------------------------------
# phase 5: where the time goes on the main path
# ---------------------------------------------------------------------------

def device_ms_by_name(prof, raw):
    """Device time (ms) of each kernel and copy name in a finished
    torch.profiler run. raw=True sums the Kineto events themselves, which
    skips the profiler's event tree (minutes to build for the few hundred
    thousand launches of a GPTQ layer)."""
    import torch

    by_name = {}
    if raw:
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_async():
                by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e6
        return by_name
    for e in prof.key_averages():
        # device-side events only: a CPU op's device time repeats its kernels'
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total / 1e3
    return by_name


def profile_window(name, fn, n_tok, reps=3, raw=False):
    """One window of profile_windows: the wall (best of `reps` after a
    warm-up; reps=1: one run, no warm-up), the device time by kernel from
    torch.profiler and the busy share."""
    import torch

    if reps > 1:
        fn()
        torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = min(walls)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = device_ms_by_name(prof, raw)
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    busy = f"{dev_ms / wall:.3f}" if dev_ms else "not measured"
    unit = ("step" if "_step_" in name else "round" if "round" in name
            else "layer" if "layer_" in name else "token")
    log(f"  {name}: wall {wall:.3f} ms ({wall / n_tok:.3f} ms/{unit}), device "
        f"{dev_ms:.3f} ms, busy share {busy}")
    for k, v in top:
        log(f"      {v:9.3f} ms  {k[:90]}")
    return {"wall_ms": wall, "wall_ms_per_token": wall / n_tok, "device_ms": dev_ms or None,
            "busy_share": dev_ms / wall if dev_ms else None,
            "top_kernels_ms": [[k, v] for k, v in top]}


def profile_windows(model, fstack, fmeta, cfg, dev, extra=None):
    """For a 128-token prefill, 16 tokens of decode_loop_flat, 8 tokens of
    engine.decode_loop, 8 ContinuousBatcher steps and 8 PagedMegaBatcher steps
    with 8 active slots, 8 PagedBatcher steps with 4 active slots, and the
    `extra` windows {name: (fn, units)}:
    the host wall time of the window (unprofiled, best of 3, ending in a
    synchronize), the device time of every kernel and copy from
    torch.profiler summed by name, and the busy share = summed device time /
    wall time (one stream: kernels do not overlap). The busy share is None
    when the profiler saw no device time."""
    import numpy as np
    import torch

    from mi_optimize_tpu_torch.serving import engine
    from mi_optimize_tpu_torch.serving.batching import ContinuousBatcher
    from mi_optimize_tpu_torch.serving.flatdecode import decode_loop_flat, stack_cache_flat
    from mi_optimize_tpu_torch.serving.paged import PagedBatcher, PagedMegaBatcher

    S, T = 128, 512
    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=torch.Generator().manual_seed(6))
    prompt = prompt.to(dev)

    def prefill():
        return engine.prefill(model.params, cfg, prompt,
                              engine.init_cache(cfg, 1, T, torch.int8, device=dev))

    logits, cache = prefill()
    tok = torch.argmax(logits, -1)[:, None]
    fcache = stack_cache_flat(cache)
    windows = {
        "prefill_128": (prefill, 1),
        "decode_loop_flat_16": (lambda: decode_loop_flat(model.params, fstack, fmeta, cfg, tok,
                                                         fcache, S, 16), 16),
        "decode_loop_block_8": (lambda: engine.decode_loop(model.params, cfg, tok, cache, S, 8),
                                8),
    }
    # 8 slots that stay active through the window's 5 runs of 8 steps each
    batcher = ContinuousBatcher(model, n_slots=8, max_len=T, cache_dtype=torch.int8)
    rng = np.random.default_rng(11)
    for n in rng.integers(16, 257, 8):
        batcher.add_request(rng.integers(0, cfg.vocab_size, (int(n),)), max_new_tokens=64)
    windows["batcher_step_8"] = (lambda: [batcher.step() for _ in range(8)], 8)
    # the same for the paged batcher (8 slots over the page pool)
    paged = PagedMegaBatcher(model, n_slots=8, max_len=T)
    for n in rng.integers(16, 257, 8):
        paged.add_request(rng.integers(0, cfg.vocab_size, (int(n),)), max_new_tokens=64)
    windows["paged_step_8"] = (lambda: [paged.step() for _ in range(8)], 8)
    # PagedBatcher (the paged flash decode's path) with 4 active slots over an
    # f32 pool of pages of 16
    pbatch = PagedBatcher(model, n_slots=4, page_size=16, n_pages=1 + 4 * 32, pages_per_slot=32)
    for n in rng.integers(16, 201, 4):
        pbatch.add_request(rng.integers(0, cfg.vocab_size, (int(n),)), max_new_tokens=96)
    windows["paged_batcher_step_4"] = (lambda: [pbatch.step() for _ in range(8)], 8)
    windows.update(extra or {})
    out = {}
    for name, (fn, n_tok, *opt) in windows.items():
        out[name] = profile_window(name, fn, n_tok, **(opt[0] if opt else {}))
        if not all(r is not None for b in (batcher, paged, pbatch) for r in b.slot_req):
            raise AssertionError("a batcher slot freed during the profile window")
    return out


# ---------------------------------------------------------------------------
# phase 4: a small f32 model on the card against the plain versions on the CPU
# ---------------------------------------------------------------------------

def small_reference_check(dev):
    import numpy as np
    import torch

    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
    from mi_optimize_tpu_torch.serving import engine
    from mi_optimize_tpu_torch.serving.flatdecode import (decode_loop_flat, stack_cache_flat,
                                                         stack_flat)
    from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving

    cfg = LlamaConfig(vocab_size=128, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512)
    cpu = build_quantized_llama(cfg, dtype=torch.float32, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(5)
    for blk in cpu["layers"]:  # non-unit norms, as the repository's tests use
        for k in ("input_norm", "post_norm"):
            blk[k] = 1.0 + 0.1 * torch.randn(cfg.hidden_size, generator=gen)
    models = {}
    for d in ("cpu", dev):
        p = cpu if d == "cpu" else _to(cpu, dev)
        models[d] = fuse_for_serving(Model(config=cfg, params=p))
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 19))
    out = {}
    for d, m in models.items():
        toks = engine.generate(m, prompt, max_new_tokens=5, cache_dtype=torch.int8)
        cache = engine.init_cache(cfg, 1, 256, torch.int8, device=d)
        logits, cache = engine.prefill(m.params, cfg, torch.as_tensor(prompt, device=d), cache)
        fstack, fmeta = stack_flat(m)
        tok = torch.argmax(logits, -1)[:, None]
        ftoks, _ = decode_loop_flat(m.params, fstack, fmeta, cfg, tok, stack_cache_flat(cache),
                                    prompt.shape[1], 5)
        out[d] = (toks, logits.cpu(), ftoks.cpu().numpy())
    err, scale = max_err(out[dev][1], out["cpu"][1])
    log(f"  small f32 model: prefill logits max|diff| {err:.3e} (max|ref| {scale:.3e}); "
        f"generate {out[dev][0][0, 19:].tolist()} vs CPU {out['cpu'][0][0, 19:].tolist()}; "
        f"flat {out[dev][2][0].tolist()} vs CPU {out['cpu'][2][0].tolist()}")
    if err > 1e-3 * max(scale, 1.0):
        raise AssertionError("small model: prefill logits on the card disagree with the CPU")
    if (out[dev][0] != out["cpu"][0]).any() or (out[dev][2] != out["cpu"][2]).any():
        raise AssertionError("small model: greedy tokens on the card differ from the CPU")


def small_serving_check(dev):
    """ContinuousBatcher on the batched kernel (use_megakernel=True; a
    request joins while another decodes) and decode_loop_model on an
    asymmetric grid, on the card and with the plain versions on the CPU:
    greedy tokens must be equal."""
    import numpy as np
    import torch

    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
    from mi_optimize_tpu_torch.serving import engine
    from mi_optimize_tpu_torch.serving.batching import ContinuousBatcher
    from mi_optimize_tpu_torch.serving.megadecode import decode_loop_model, stack_cache
    from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving

    cfg = LlamaConfig(vocab_size=128, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (13, 40, 9)]
    got = {}
    for symmetric in (True, False):
        cpu = build_quantized_llama(cfg, dtype=torch.float32, seed=6, device="cpu",
                                    symmetric=symmetric)
        gen = torch.Generator().manual_seed(6)
        for blk in cpu["layers"]:
            for k in ("input_norm", "post_norm"):
                blk[k] = 1.0 + 0.1 * torch.randn(cfg.hidden_size, generator=gen)
        for d in ("cpu", dev):
            m = fuse_for_serving(Model(config=cfg, params=cpu if d == "cpu" else _to(cpu, dev)))
            b = ContinuousBatcher(m, n_slots=2, max_len=256, cache_dtype=torch.int8,
                                  use_megakernel=True)
            reqs = [b.add_request(prompts[0], max_new_tokens=4),
                    b.add_request(prompts[1], max_new_tokens=9)]
            by_rid = {r.rid: r for r in b.slot_req}
            while any(r is not None for r in b.slot_req):
                b.step()
                if len(reqs) == 2 and None in b.slot_req:
                    reqs.append(b.add_request(prompts[2], max_new_tokens=6))
                    by_rid[reqs[2]] = next(r for r in b.slot_req if r and r.rid == reqs[2])
            res = [by_rid[r].tokens for r in reqs]
            if not symmetric:
                stack, meta = b._mega
                ids = torch.as_tensor(prompts[1][None], device=d)
                logits, cache = engine.prefill(m.params, cfg, ids, engine.init_cache(
                    cfg, 1, 256, torch.int8, device=d))
                toks, _ = decode_loop_model(m.params, stack, meta, cfg,
                                            torch.argmax(logits, -1)[:, None], stack_cache(cache),
                                            len(prompts[1]), 8)
                res.append(toks[0].tolist())
            got[(symmetric, d)] = res
        log(f"  small f32 model ({'symmetric' if symmetric else 'asymmetric'}): batcher "
            f"{got[(symmetric, dev)][:3]} vs CPU {got[(symmetric, 'cpu')][:3]}"
            + ("" if symmetric else f"; decode_loop_model {got[(symmetric, dev)][3]} vs CPU "
               f"{got[(symmetric, 'cpu')][3]}"))
        if got[(symmetric, dev)] != got[(symmetric, "cpu")]:
            raise AssertionError("small model: batcher / decode_loop_model tokens on the card "
                                 "differ from the CPU")


def small_paged_check(dev):
    """PagedMegaBatcher (3 slots in waves of 2, prefix caching on prompts that
    share a page) and PagedBatcher (pages of 16: the paged flash decode) on
    the card and with the plain versions on the CPU: greedy tokens equal."""
    import numpy as np
    import torch

    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
    from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
    from mi_optimize_tpu_torch.serving.paged import PagedBatcher, PagedMegaBatcher

    cfg = LlamaConfig(vocab_size=128, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512)
    cpu = build_quantized_llama(cfg, dtype=torch.float32, seed=7, device="cpu")
    gen = torch.Generator().manual_seed(7)
    for blk in cpu["layers"]:
        for k in ("input_norm", "post_norm"):
            blk[k] = 1.0 + 0.1 * torch.randn(cfg.hidden_size, generator=gen)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab_size, (128,))
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, (n,))]) for n in (6, 19)]
    prompts.append(rng.integers(0, cfg.vocab_size, (33,)))
    got = {}
    for d in ("cpu", dev):
        m = fuse_for_serving(Model(config=cfg, params=cpu if d == "cpu" else _to(cpu, dev)))
        pm = PagedMegaBatcher(m, n_slots=3, max_len=256, wave_slots=2, prefix_cache=True)
        mega = pm.run_all(list(prompts), max_new_tokens=7)
        pb = PagedBatcher(m, n_slots=2, page_size=16, n_pages=32, pages_per_slot=8)
        rids = [pb.add_request(prompts[2], max_new_tokens=6),
                pb.add_request(prompts[0][-50:], max_new_tokens=4)]
        reqs = [next(s for s in pb.slot_req if s.rid == r) for r in rids]
        while any(s is not None for s in pb.slot_req):
            pb.step()
        got[d] = (mega, [r.tokens for r in reqs], pm.prefix_cache_stats())
    log(f"  small f32 model: PagedMegaBatcher {got[dev][0]} vs CPU {got['cpu'][0]} "
        f"(prefix cache {got[dev][2]}); PagedBatcher {got[dev][1]} vs CPU {got['cpu'][1]}")
    if got[dev] != got["cpu"] or got[dev][2]["hit_tokens"] != 128:
        raise AssertionError("small model: paged batcher tokens on the card differ from the CPU")


def small_spec_check(dev):
    """A small float32 planted pair (2-layer target, 1-layer draft whose map
    disagrees on 30%) on the card and with the plain versions on the CPU:
    speculative_generate's scan-flat route at k = 3 (the fused lm rows) and
    k = "auto" (the split verify at k = 8), and decode_loop_flat_seg on the
    draft: tokens and stats equal."""
    import numpy as np
    import torch

    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.serving import engine
    from mi_optimize_tpu_torch.serving.flatdecode import (decode_loop_flat_seg, stack_cache_flat,
                                                         stack_flat)
    from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
    from mi_optimize_tpu_torch.serving.speculative import speculative_generate
    from mi_optimize_tpu_torch.utils.planted import planted_pair

    cfg = LlamaConfig(vocab_size=128, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512)
    t, d, _, _ = planted_pair(cfg, draft_layers=1, disagree_frac=0.3, dtype=torch.float32,
                              device="cpu")
    prompt = np.array([[9, 77]])
    got = {}
    for dv in ("cpu", dev):
        tm, dm = (fuse_for_serving(Model(config=m.config, params=m.params if dv == "cpu"
                                         else _to(m.params, dv))) for m in (t, d))
        res = [speculative_generate(tm, dm, prompt, max_new_tokens=n, k=k,
                                    cache_dtype=torch.int8, draft_megakernel=True)
               for k, n in ((3, 24), ("auto", 60))]
        res = [(o.tolist(), st) for o, st in res]
        fstack, fmeta = stack_flat(dm)
        log_, cache = engine.prefill(dm.params, dm.config, torch.as_tensor(prompt, device=dv),
                                     engine.init_cache(dm.config, 1, 128, torch.int8, device=dv))
        seg, _ = decode_loop_flat_seg(dm.params, fstack, fmeta, dm.config,
                                      torch.argmax(log_, -1)[:, None], stack_cache_flat(cache), 2,
                                      12, kseg=5)
        got[dv] = res + [seg.cpu().tolist()]
    log(f"  small f32 planted pair: speculative_generate k=3 {got[dev][0][1]}, k=auto "
        f"{got[dev][1][1].get('adaptive_k')}; tokens and stats "
        f"{'equal' if got[dev] == got['cpu'] else 'DIFFER'} to the CPU's; decode_loop_flat_seg "
        f"{got[dev][2][0][:6]}... vs CPU {got['cpu'][2][0][:6]}...")
    if got[dev] != got["cpu"]:
        raise AssertionError("small planted pair: speculative paths on the card differ from the "
                             "CPU")


def small_spec_batchers_check(dev):
    """Both speculative batchers on random float32 weights, where the tokens
    and the accept stats depend on attention over every cache: a 2-layer
    target and its first layer as the draft, 4 slots, k = 3, prompts of
    110-135 tokens (the rows cross the 128-row page); the dense batcher with
    and without the fused lm rows, the paged one in verify waves of 2 and 3
    slots with them, and the paged one with the target as its own draft. On
    the card and with the plain versions on the CPU: tokens and stats
    equal."""
    import dataclasses

    import numpy as np
    import torch

    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
    from mi_optimize_tpu_torch.serving.batching import SpeculativeBatcher
    from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
    from mi_optimize_tpu_torch.serving.paged import PagedSpeculativeBatcher

    cfg = LlamaConfig(vocab_size=256, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512)
    cpu = build_quantized_llama(cfg, dtype=torch.float32, seed=8, device="cpu")
    gen = torch.Generator().manual_seed(8)
    for blk in cpu["layers"]:
        for k in ("input_norm", "post_norm"):
            blk[k] = 1.0 + 0.1 * torch.randn(cfg.hidden_size, generator=gen)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)) for n in rng.integers(110, 136, 6)]
    kw = dict(k=3, n_slots=4, max_len=256)
    dkw = dict(kw, cache_dtype=torch.int8, use_megakernel=True, use_draft_megakernel=True)
    makes = {
        "dense": lambda t, d: SpeculativeBatcher(t, d, **dkw),
        "dense-lm": lambda t, d: SpeculativeBatcher(t, d, fused_lm=True, **dkw),
        "paged-lm": lambda t, d: PagedSpeculativeBatcher(t, d, fused_lm=True, **kw),
        "paged-wave3-lm": lambda t, d: PagedSpeculativeBatcher(t, d, verify_wave_slots=3,
                                                               fused_lm=True, **kw),
        "paged-self": lambda t, d: PagedSpeculativeBatcher(t, t, **kw)}
    got = {}
    for d in ("cpu", dev):
        # _to makes new linears, so the draft's stack does not rebind the target's
        tm = fuse_for_serving(Model(config=cfg, params=_to(cpu, d)))
        dm = fuse_for_serving(Model(config=dataclasses.replace(cfg, num_layers=1),
                                    params=_to({**cpu, "layers": cpu["layers"][:1]}, d)))
        got[d] = {}
        for key, make in makes.items():
            b = make(tm, dm)
            got[d][key] = (b.run_all(list(prompts), max_new_tokens=12), b.rounds, b.proposed,
                           b.accepted)
    runs = got[dev]
    same = all(r[0] == runs["dense"][0] for r in runs.values())
    log(f"  small f32 random pair: speculative batchers (rounds, proposed, accepted) "
        + ", ".join(f"{k} {r[1:]}" for k, r in runs.items())
        + f"; tokens {'equal' if same else 'DIFFER'} across the five and "
        f"{'equal' if got[dev] == got['cpu'] else 'DIFFER'} to the CPU's")
    if got[dev] != got["cpu"] or not same:
        raise AssertionError("small random pair: speculative batchers on the card differ from "
                             "the CPU or from each other")
    if not 0 < runs["dense"][3] < runs["dense"][2] or runs["paged-self"][2] != runs["paged-self"][3]:
        raise AssertionError("small random pair: unexpected accept counts")


def small_unfused_check(dev):
    """An unfused small f32 model (separate q/k/v and gate/up), int4 and
    with the W4A8 spec (MI_W4A8_INT=1): generate with the int8 cache (a
    40-token prompt, 6 new tokens) and compute_ppl (2 batches of 2 x 64
    tokens), on the card (decode attention, fused MLP, W4A8 integer product)
    and on the CPU with the same branches forced through the plain versions.
    Tokens equal; perplexity within 1e-4 relative (W4A8: 1e-3, an int8
    activation code at a rounding boundary flips with the sums' order)."""
    import numpy as np
    import torch

    from mi_optimize_tpu_torch.eval.ppl import compute_ppl
    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama, with_w4a8
    from mi_optimize_tpu_torch.serving import engine

    cfg = LlamaConfig(vocab_size=160, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512)
    base = build_quantized_llama(cfg, dtype=torch.float32, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for blk in base["layers"]:
        for k in ("input_norm", "post_norm"):
            blk[k] = 1.0 + 0.1 * torch.randn(cfg.hidden_size, generator=gen)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 40))
    batches = [np.random.default_rng(6 + i).integers(0, cfg.vocab_size, (2, 64))
               for i in range(2)]
    branches = llama.kernel_branches
    with w4a8_route():
        for spec, p, tol in (("int4", base, 1e-4), ("W4A8", with_w4a8(base), 1e-3)):
            out = {}
            for d in (dev, "cpu"):
                m = Model(config=cfg, params=p if d == "cpu" else _to(p, dev))
                llama.kernel_branches = (lambda x: True) if d == "cpu" else branches
                try:
                    out[d] = (engine.generate(m, prompt, max_new_tokens=6,
                                              cache_dtype=torch.int8), compute_ppl(m, batches))
                finally:
                    llama.kernel_branches = branches
            rel = abs(out[dev][1] - out["cpu"][1]) / out["cpu"][1]
            log(f"  small unfused f32 model, {spec}: generate {out[dev][0][0, 40:].tolist()} vs "
                f"CPU {out['cpu'][0][0, 40:].tolist()}; PPL {out[dev][1]:.6f} vs CPU "
                f"{out['cpu'][1]:.6f} (relative {rel:.2e}, tolerance {tol})")
            if (out[dev][0] != out["cpu"][0]).any() or not rel <= tol:
                raise AssertionError(f"small unfused model ({spec}): the card disagrees with "
                                     "the CPU")


def model_loop_window(model, stack, meta, cfg, dev, S=128, T=512, n=16):
    """Path c's loop for phase 5: n tokens of decode_loop_model after an
    S-token prefill, on the asymmetric-grid model (one B4 launch and the
    lm_head through dequant_matmul a token)."""
    import torch

    from mi_optimize_tpu_torch.serving import engine
    from mi_optimize_tpu_torch.serving.megadecode import decode_loop_model, stack_cache

    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=torch.Generator().manual_seed(6))
    logits, cache = engine.prefill(model.params, cfg, prompt.to(dev),
                                   engine.init_cache(cfg, 1, T, torch.int8, device=dev))
    tok = torch.argmax(logits, -1)[:, None]
    scache = stack_cache(cache)
    return lambda: decode_loop_model(model.params, stack, meta, cfg, tok, scache, S, n)


def spec_round_window(target, draft, cfg, dev, k=4, S=128, T=512):
    """A window of one scan-flat speculative round (k draft proposals on the
    flat kernel plus the ingest step, one C = k+1 verify with the fused lm
    rows) after an S-token prompt on both models; each call redoes the same
    round over the same cache rows."""
    import torch

    from mi_optimize_tpu_torch.serving import engine
    from mi_optimize_tpu_torch.serving.flatdecode import stack_cache_flat, stack_flat
    from mi_optimize_tpu_torch.serving.megadecode import (stack_cache_batched, stack_lm,
                                                          stack_serving)
    from mi_optimize_tpu_torch.serving.speculative import _spec_scan_flat

    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=torch.Generator().manual_seed(23))
    prompt = prompt.to(dev)
    tstack, tmeta = stack_serving(target)
    dstack, dmeta = stack_flat(draft)
    tlm, tlm_meta = stack_lm(target, tmeta)
    logits, tc = engine.prefill(target.params, cfg, prompt,
                                engine.init_cache(cfg, 1, T, torch.int8, device=dev))
    _, dc = engine.prefill(draft.params, draft.config, prompt,
                           engine.init_cache(draft.config, 1, T, torch.int8, device=dev))
    tcc, dcc = stack_cache_batched(tc), stack_cache_flat(dc)
    del tc, dc
    first = int(torch.argmax(logits, -1)[0])
    return lambda: _spec_scan_flat(target.params, draft.params, tstack, dstack, tmeta, dmeta, cfg,
                                   draft.config, tcc, dcc, first, S, k, 1, tlm, tlm_meta)


def unfused_decode_window(model, cfg, dev, S=128, T=512, n=8):
    """A window of n decode steps (engine.decode_loop) on an unfused model
    after an S-token prompt: the decode attention and the fused MLP; each
    call redoes the same steps over the same cache rows."""
    import torch

    from mi_optimize_tpu_torch.serving import engine

    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=torch.Generator().manual_seed(24))
    logits, cache = engine.prefill(model.params, cfg, prompt.to(dev),
                                   engine.init_cache(cfg, 1, T, torch.int8, device=dev))
    tok = torch.argmax(logits, -1)[:, None]
    return lambda: engine.decode_loop(model.params, cfg, tok, cache, S, n)


def ppl_window(model, cfg, dev, S=2048):
    """A window of one perplexity batch (1 x S tokens) through the fused route."""
    import torch

    from mi_optimize_tpu_torch.eval.ppl import batch_loss

    ids = torch.as_tensor(ppl_batches(cfg, 1, S, seed=42)[0], device=dev)
    return lambda: batch_loss(model, ids)


# ---------------------------------------------------------------------------
# path t: tensor-parallel serving, TP ranks as gloo processes on the one card
# ---------------------------------------------------------------------------

TP_REQUESTS = 8             # path t's requests: all in flight at once in 8 slots


def mega_batcher(model, n_slots=8, max_len=512):
    """An int8 ContinuousBatcher on the batched whole-model kernel."""
    import torch

    from mi_optimize_tpu_torch.serving.batching import ContinuousBatcher

    b = ContinuousBatcher(model, n_slots=n_slots, max_len=max_len, cache_dtype=torch.int8,
                          use_megakernel=True)
    if b._mega is None:
        raise AssertionError("the batcher did not take the batched whole-model kernel")
    return b


def tp_rank(rank, world, positions, T=512, cfg=None, dev="cuda"):
    """One rank of path t, in a gloo process of its own on the card
    (`parallel.launch.spawn`): the planted Llama-2-7B target sharded over
    the process group (`shard_model`) serves TP_REQUESTS requests through
    ContinuousBatcher (prefill through the row-parallel ring, B11; one
    mode (e) step a token, B5(e)) and through PagedMegaBatcher; then one
    model_step_batch_tp step of the random-weight model (seed 0) from the
    dense batched row's state. Returns the tokens, the logits, the walls and
    this process's launch counts. cfg defaults to Llama-2-7B; dev="cpu"
    rehearses the path on the CPU's plain versions (the card's timing and
    memory calls stubbed)."""
    import torch
    import torch.distributed as dist

    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
    from mi_optimize_tpu_torch.parallel import shard_model
    from mi_optimize_tpu_torch.parallel.sharding import cache_shard
    from mi_optimize_tpu_torch.serving.megadecode import model_step_batch_tp, stack_serving_tp
    from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
    from mi_optimize_tpu_torch.serving.paged import PagedMegaBatcher
    from mi_optimize_tpu_torch.utils.planted import build_planted_llama, planted_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev == "cpu":
        torch.cuda.synchronize = torch.cuda.empty_cache = lambda *a: None
        torch.cuda.max_memory_allocated = lambda *a: 0
    g, cfg = dist.group.WORLD, cfg or LlamaConfig.llama2_7b()
    out = {}
    target = fuse_for_serving(Model(config=cfg, params=build_planted_llama(
        cfg, planted_map(cfg.vocab_size), device=dev)))
    sm = shard_model(target, g)
    del target
    torch.cuda.empty_cache()
    out["dense"] = serve_batcher(sm, sm.config, n_req=TP_REQUESTS,
                                 name=f"rank {rank}: TP ContinuousBatcher",
                                 make=lambda: mega_batcher(sm))
    out["paged"] = serve_batcher(
        sm, sm.config, n_req=TP_REQUESTS, name=f"rank {rank}: TP PagedMegaBatcher",
        make=lambda: PagedMegaBatcher(sm, n_slots=8, max_len=512))
    del sm
    torch.cuda.empty_cache()
    model = fuse_for_serving(Model(config=cfg, params=build_quantized_llama(
        cfg, bits=4, groupsize=128, dtype=torch.bfloat16, seed=0, device=dev, symmetric=True)))
    st, meta, _ = stack_serving_tp(model, world, rank)
    B = len(positions)
    gen = torch.Generator(device=dev).manual_seed(8 + B)   # the dense batched row's state
    cache = random_slot_cache(cfg, positions, T, dev, gen)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device=dev)
    mine = cache_shard(cache, rank, world)
    del cache
    t0 = time.perf_counter()
    logits, _ = model_step_batch_tp(model.params, st, meta, cfg, toks, mine, positions, g)
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    out["logits"] = logits.float().cpu()
    out["launches"] = {k: getattr(m, a) for k, (m, a) in counters().items()}
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def serve_tp(model, stack, meta, target, cfg, dev, positions):
    """Path t: tensor-parallel serving at Llama-2-7B width and depth over
    TP = 2 ranks, each a gloo process on the one card (gloo's collectives
    take the card's tensors through host memory; two NCCL ranks cannot
    share a card). The ranks' tokens through the TP ContinuousBatcher and
    PagedMegaBatcher must equal the single-card batchers' on the same planted
    target and prompts; the TP step's logits on the random-weight model
    within TOL of max|logit| of the single-card model_step_batch's from the
    same state. The walls are not TP speed: the two ranks share one card
    and sum their partials through host memory. The ranks' launch counts are
    added to this process's counters, which run_path reads."""
    import torch

    from mi_optimize_tpu_torch.parallel import launch
    from mi_optimize_tpu_torch.serving.megadecode import model_step_batch
    from mi_optimize_tpu_torch.serving.paged import PagedMegaBatcher

    ref = {"dense": serve_batcher(target, cfg, n_req=TP_REQUESTS,
                                  name="single-card ContinuousBatcher (planted)",
                                  make=lambda: mega_batcher(target)),
           "paged": serve_batcher(target, cfg, n_req=TP_REQUESTS,
                                  name="single-card PagedMegaBatcher (planted)",
                                  make=lambda: PagedMegaBatcher(target, n_slots=8, max_len=512))}
    same_tokens("single-card PagedMegaBatcher (planted)", ref["paged"]["request_tokens"],
                ref["dense"]["request_tokens"])
    B = len(positions)
    gen = torch.Generator(device=dev).manual_seed(8 + B)
    cache = random_slot_cache(cfg, positions, 512, dev, gen)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device=dev)
    want, _ = model_step_batch(model.params, stack, meta, cfg, toks, cache, positions)
    want = want.float().cpu()
    del cache
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = launch.spawn("chip_smoke:tp_rank", TP, backend="gloo", timeout=600, threads=4,
                       positions=positions, cfg=cfg, dev=str(dev))
    wall = time.perf_counter() - t0
    for r, got in enumerate(res):
        for mode in ("dense", "paged"):
            same_tokens(f"TP rank {r} {mode}", got[mode]["request_tokens"],
                        ref["dense"]["request_tokens"])
        check_close(f"TP rank {r} model_step_batch_tp logits (bf16, random weights)",
                    got["logits"], want)
    for k, (m, a) in counters().items():
        setattr(m, a, getattr(m, a) + sum(got["launches"][k] for got in res))
    out = {"ranks": TP, "backend": "gloo", "spawn_wall_s": wall,
           "rank_peak_mem_gib": [got["peak_mem_gib"] for got in res],
           "step_ms_random_weights": [got["step_ms"] for got in res],
           "single_card": {m: {k: ref[m][k] for k in ("tokens_per_s", "ms_per_step_full")}
                           for m in ref}}
    for mode in ("dense", "paged"):
        out[mode] = [{k: got[mode][k] for k in ("tokens_per_s", "ms_per_step_full", "wall_s")}
                     for got in res]
    log(f"  path t: {TP} gloo ranks on one card, {wall:.1f} s with the ranks' start-up; "
        f"TP ContinuousBatcher {out['dense'][0]['tokens_per_s']:.1f} tokens/s a rank "
        f"(single card {ref['dense']['tokens_per_s']:.1f}); not TP speed: the ranks share the "
        "card and sum through host memory")
    return out


# ---------------------------------------------------------------------------
# path u: the latency benchmark (eval/latency.py) at Llama-2-7B width and depth
# ---------------------------------------------------------------------------

LAT_TOKENS = 64             # decode tokens a timed loop (decode_throughput's default)


def serve_latency(model, fstack, fmeta, rmodel, cfg, dev, smi):
    """Path u: Benchmark.eval_latency on the served model (batch 1, 128
    tokens, the int8 cache): forward_latency (10 + 30 forwards, B1),
    decode_throughput (engine.decode_loop: B2 a layer; `megakernel_path`:
    decode_loop_model, B4; `kernels`: B4 alone beside torch.sum over its
    bytes), forward_latency of the unfused model as quantization returns it
    (B1 and the fused MLP, B7), and kernel_breakdown of the flat kernel (B3)
    beside decode_loop_flat's step from the same 128-token prefill. Gates:
    every roofline, HBM and torch.sum share in (0, 100%], each kernel's ms a
    token at most its step's."""
    import numpy as np
    import torch

    from mi_optimize_tpu_torch.eval.benchmark import Benchmark
    from mi_optimize_tpu_torch.eval.latency import forward_latency, kernel_breakdown
    from mi_optimize_tpu_torch.serving import engine
    from mi_optimize_tpu_torch.serving.flatdecode import decode_loop_flat, stack_cache_flat

    res = Benchmark(device=dev).eval_latency(model, batch=1, seqlen=128, cache_dtype=torch.int8)
    dec = res["decode"]
    if "megakernel_path" not in dec or "kernels" not in dec:
        raise AssertionError("path u: decode_throughput took no whole-model kernel path")
    res["forward_unfused"] = forward_latency(rmodel, batch=1, seqlen=128, device=dev)
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 128)),
                          device=dev)
    logits, cache = engine.prefill(model.params, cfg, ids,
                                   engine.init_cache(cfg, 1, 256, torch.int8, device=dev))
    tok = torch.argmax(logits, -1)[:, None]
    fcache = stack_cache_flat(cache)
    loop = lambda: decode_loop_flat(model.params, fstack, fmeta, cfg, tok, fcache, 128, LAT_TOKENS)
    loop()
    step_s = timed_s(loop)[1] / LAT_TOKENS
    res["flat"] = {"step_ms": step_s * 1e3, "kernels": kernel_breakdown(
        model, tok, 128, None, step_s, n=LAT_TOKENS, flat_meta=(fstack, fmeta), flat_cache=fcache)}
    shares = {"per-layer decode of the roofline": 100 * dec["roofline_frac"],
              "decode_loop_model of the roofline": 100 * dec["megakernel_path"]["roofline_frac"]}
    for name, kb in (("B4", dec["kernels"]), ("B3", res["flat"]["kernels"])):
        mk = kb["megakernel"]
        shares.update({f"{name} of the nominal HBM rate": mk["pct_of_nominal_hbm"],
                       f"{name} of torch.sum's rate": mk["pct_of_torch_sum"],
                       f"{name} of its step": mk["pct_of_step"]})
    res["shares_pct"] = shares
    fw, fu, mp = res["forward"], res["forward_unfused"], dec["megakernel_path"]
    b4, b3 = dec["kernels"], res["flat"]["kernels"]
    log(f"  path u ({smi}): forward 1 x 128 served {fw['avg_ms']:.3f} ms (p50 {fw['p50_ms']:.3f}, "
        f"p90 {fw['p90_ms']:.3f}), unfused {fu['avg_ms']:.3f} ms (p50 {fu['p50_ms']:.3f}); "
        f"decode per layer {dec['tokens_per_s_per_chip']:.2f} tokens/s ({dec['step_ms']:.3f} ms, "
        f"sol {dec['sol_step_ms']:.3f} ms, roofline {dec['roofline_frac']:.4f}); "
        f"decode_loop_model {mp['tokens_per_s_per_chip']:.2f} tokens/s ({mp['step_ms']:.3f} ms, "
        f"roofline {mp['roofline_frac']:.4f}); B4 alone {b4['megakernel']['ms_per_token']:.4f} "
        f"ms ({b4['megakernel']['gbps']:.1f} GB/s, {b4['megakernel']['pct_of_nominal_hbm']:.1f}% "
        f"of {b4['nominal_hbm_gbps']:.0f}, {b4['megakernel']['pct_of_torch_sum']:.1f}% of "
        f"torch.sum's {b4['torch_sum_gbps']:.1f}); decode_loop_flat {res['flat']['step_ms']:.3f} "
        f"ms a token, B3 alone {b3['megakernel']['ms_per_token']:.4f} ms "
        f"({b3['megakernel']['gbps']:.1f} GB/s, {b3['megakernel']['pct_of_nominal_hbm']:.1f}%, "
        f"{b3['megakernel']['pct_of_torch_sum']:.1f}% of torch.sum's {b3['torch_sum_gbps']:.1f})")
    bad = {k: v for k, v in shares.items() if not 0 < v <= 100}
    if bad:
        raise AssertionError(f"path u: a share outside (0, 100%] (a timer or byte count fault): "
                             f"{bad}")
    return res


# ---------------------------------------------------------------------------
# path v: the lm-eval adapter (eval/lmeval.py) at Llama-2-7B width and depth
# ---------------------------------------------------------------------------

# raw files of four offline builders (datasets/lmdatasets.py), a few docs each
LMEVAL_RAW = {
    "mc_taco/dev_3783.tsv": "He ate his lunch.\tHow long did it take?\t20 minutes\tyes\tEvent "
                            "Duration\nHe ate his lunch.\tHow long did it take?\t3 years\tno\t"
                            "Event Duration\nShe went home.\tWhen did she leave?\tat night\t"
                            "yes\tTemporal Ordering\n",
    "headqa_es/test_HEAD.json": json.dumps({"exams": {"e1": {
        "name": "Exam", "year": "2016", "category": "medicine", "data": [
            {"qid": "1", "qtext": "Which organ pumps blood?", "ra": "2", "answers": [
                {"aid": 1, "atext": "the liver"}, {"aid": 2, "atext": "the heart"},
                {"aid": 3, "atext": "the lung"}]},
            {"qid": "2", "qtext": "What carries oxygen?", "ra": "1", "answers": [
                {"aid": 1, "atext": "red blood cells"}, {"aid": 2, "atext": "bones"}]}]}}}),
    "gsm8k/test.jsonl": "".join(json.dumps({"question": q, "answer": a}) + "\n" for q, a in (
        ("Tom has 3 apples and buys 4 more. How many apples does he have?", "3+4=7\n#### 7"),
        ("A box holds 6 eggs. How many eggs are in 2 boxes?", "6*2=12\n#### 12"))),
    "squad2/dev-v2.0.json": json.dumps({"data": [{"title": "Paris", "paragraphs": [{
        "context": "Paris is the capital of France.",
        "qas": [{"id": "q1", "question": "What is the capital of France?",
                 "answers": [{"text": "Paris", "answer_start": 0}]},
                {"id": "q2", "question": "What is the capital of Mars?", "answers": [],
                 "is_impossible": True}]}]}]}),
}
LL_TASKS = ("mc_taco", "headqa", "wikitext")    # loglikelihood, multiple choice, rolling
GEN_TASKS = ("gsm8k", "squad2")                 # greedy_until, mixed
LMEVAL_NEW = 16             # greedy_until's tokens a request (the harness's 256 at full cost)
LL_TOL = 5e-2               # bf16 7B: |fused - unfused| loglikelihood, a continuation token


def lmeval_runs(runs, data_root):
    """{label: (evaluate_tasks' result, [(continuation length, loglikelihood,
    greedy flag)], [greedy_until texts])} of each (label, call) in `runs`,
    with MI_TPU_DATA_DIR at `data_root` holding LMEVAL_RAW (and restored
    after); greedy_until decodes LMEVAL_NEW tokens a request."""
    from mi_optimize_tpu_torch.eval import lmeval

    for rel, text in LMEVAL_RAW.items():
        os.makedirs(os.path.dirname(os.path.join(data_root, "lmeval", rel)), exist_ok=True)
        with open(os.path.join(data_root, "lmeval", rel), "w", encoding="utf-8") as f:
            f.write(text)
    seen = {"ll": [], "txt": []}
    ll_tokens, greedy_until = lmeval.LMEvalModel._ll_tokens, lmeval.LMEvalModel.greedy_until

    def ll_rec(self, ctx, cont):
        out = ll_tokens(self, ctx, cont)
        seen["ll"].append((len(cont), out[0], out[1]))
        return out

    def txt_rec(self, reqs):
        out = greedy_until(self, reqs, LMEVAL_NEW)
        seen["txt"].extend(out)
        return out

    old = os.environ.get("MI_TPU_DATA_DIR")
    os.environ["MI_TPU_DATA_DIR"] = data_root
    lmeval.LMEvalModel._ll_tokens, lmeval.LMEvalModel.greedy_until = ll_rec, txt_rec
    out = {}
    try:
        for label, call in runs:
            seen["ll"], seen["txt"] = [], []
            out[label] = (call(), seen["ll"], seen["txt"])
    finally:
        lmeval.LMEvalModel._ll_tokens, lmeval.LMEvalModel.greedy_until = ll_tokens, greedy_until
        if old is None:
            os.environ.pop("MI_TPU_DATA_DIR")
        else:
            os.environ["MI_TPU_DATA_DIR"] = old
    return out


def ppl_tols(ll_tol, docs):
    """What a loglikelihood tolerance of ll_tol a token allows the rolling
    task's metrics (PerplexityTask: word and byte perplexity, the exp of the
    mean NLL a word or a byte; a ByteTokenizer token is a byte): |log g -
    log w| for the perplexities, |g - w| for bits_per_byte."""
    import math

    per_word = max(len(d["text"].encode("utf-8")) / max(len(d["text"].split()), 1)
                   for d in docs)
    return {"word_perplexity": ll_tol * per_word, "byte_perplexity": ll_tol,
            "bits_per_byte": ll_tol / math.log(2)}


def same_metrics(what, got, want, tols=None):
    """Every task's metrics equal; those in `tols` (the perplexities,
    continuous in the loglikelihoods; `ppl_tols`) within theirs."""
    import math

    for task, m in want.items():
        for k, v in m.items():
            g = got[task][k]
            if tols and k in tols:
                d = abs(g - v) if k == "bits_per_byte" else abs(math.log(g) - math.log(v))
                close = d <= tols[k]
            else:
                close = g == v
            if not close:
                raise AssertionError(f"{what}: {task} {k} {g!r} against {v!r}")


def serve_lmeval(model, target, cfg, dev):
    """Path v: evaluate_tasks at Llama-2-7B width and depth from raw files
    under build/path_v: the loglikelihood tasks (mc_taco, headqa's
    multiple choice, wikitext's rolling windows; 2 docs each) on the
    random-weight served model, the greedy_until and mixed tasks (gsm8k,
    squad2; one doc, LMEVAL_NEW tokens a request) on the planted target
    (its greedy chain far above bf16 noise). Each on the fused route (B1
    on the card) and the fused=False route (dequantize, then a dense
    product). Gates: each loglikelihood within LL_TOL a continuation token,
    the same metrics (the perplexities within what LL_TOL allows them,
    `ppl_tols`), the same greedy_until texts."""
    import shutil

    from mi_optimize_tpu_torch.datasets.tokenizer import ByteTokenizer
    from mi_optimize_tpu_torch.eval.lmeval import TASK_REGISTRY, evaluate_tasks

    root = os.path.join(HERE, "build", "path_v")
    tok = ByteTokenizer()
    runs = []
    for fused in (True, False):
        runs.append((f"ll_{fused}", lambda f=fused: evaluate_tasks(model, tok, LL_TASKS, fused=f,
                                                                   max_docs=2)))
        runs.append((f"gen_{fused}", lambda f=fused: evaluate_tasks(
            target, tok, GEN_TASKS, fused=f, max_docs=1)))
    t0 = time.perf_counter()
    out = lmeval_runs(runs, root)
    wall = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    worst, flips = 0.0, 0
    for kind in ("ll", "gen"):
        (_, gll, gtxt), (_, wll, wtxt) = out[f"{kind}_True"], out[f"{kind}_False"]
        if len(gll) != len(wll) or gtxt != wtxt:
            raise AssertionError(f"path v: the fused route's requests or texts differ: {gtxt} "
                                 f"{wtxt}")
        for (n, g, gf), (_, w, wf) in zip(gll, wll):
            worst = max(worst, abs(g - w) / n)
            flips += gf != wf
    res = {"metrics": {k: v[0] for k, v in out.items()}, "loglikelihoods": len(
        out["ll_True"][1]) + len(out["gen_True"][1]), "greedy_texts": len(out["gen_True"][2]),
        "max_ll_diff_per_token": worst, "greedy_flag_flips": flips, "wall_s": wall}
    log(f"  path v: {res['loglikelihoods']} loglikelihood requests, fused against fused=False "
        f"at most {worst:.4g} a continuation token apart (limit {LL_TOL}), {flips} greedy flags "
        f"apart; {res['greedy_texts']} greedy_until texts equal; metrics {out['ll_True'][0]} "
        f"{out['gen_True'][0]}; {wall:.1f} s")
    if worst > LL_TOL:
        raise AssertionError(f"path v: a loglikelihood {worst:.4g} a token from fused=False's")
    tols = ppl_tols(LL_TOL, TASK_REGISTRY["wikitext"]().docs()[:2])
    for kind in ("ll", "gen"):
        same_metrics(f"path v ({kind} tasks, fused against fused=False)", out[f"{kind}_True"][0],
                     out[f"{kind}_False"][0], tols)
    return res


def small_lmeval_check(dev):
    """evaluate_tasks on a small f32 model (2 layers, h=512, int4 g128,
    V=300) on the card and with the plain versions on the CPU: mc_taco,
    headqa, wikitext, gsm8k and squad2 from LMEVAL_RAW; the same metrics,
    each loglikelihood within 1e-4, the same greedy_until texts."""
    import numpy as np
    import torch

    from mi_optimize_tpu_torch.datasets.tokenizer import ByteTokenizer
    from mi_optimize_tpu_torch.eval.lmeval import TASK_REGISTRY, evaluate_tasks
    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama

    cfg = LlamaConfig(vocab_size=300, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512)
    cpu = build_quantized_llama(cfg, dtype=torch.float32, seed=6, device="cpu")
    tasks = LL_TASKS + GEN_TASKS
    runs = [(d, lambda d=d: evaluate_tasks(Model(config=cfg, params=cpu if d == "cpu" else
                                                 _to(cpu, d)), ByteTokenizer(), tasks,
                                           max_docs=2))
            for d in ("cpu", dev)]
    out = lmeval_runs(runs, os.path.join(HERE, "build", "small_lmeval"))
    (got, gll, gtxt), (want, wll, wtxt) = out[dev], out["cpu"]
    same_metrics("small model's lm-eval, card against the CPU", got, want,
                 ppl_tols(1e-5, TASK_REGISTRY["wikitext"]().docs()[:2]))
    err = max(abs(g - w) for (_, g, _), (_, w, _) in zip(gll, wll))
    log(f"  small f32 model, lm-eval {', '.join(tasks)}: {len(gll)} loglikelihoods within "
        f"{err:.3g} of the CPU's, {len(gtxt)} greedy_until texts "
        f"{'equal' if gtxt == wtxt else 'DIFFERENT'}; metrics equal")
    if len(gll) != len(wll) or not np.isfinite(err) or err > 1e-4 or gtxt != wtxt:
        raise AssertionError("small model: lm-eval on the card differs from the CPU")


# ---------------------------------------------------------------------------
# path w: the CLI twins (mi_optimize_tpu_torch/cli/) in-process on the card
# ---------------------------------------------------------------------------

CLI_LAYERS = 3              # path w's checkpoint: Llama-2-7B width, 3 layers
CLI_PROMPTS = ["The capital of France is", "Once upon a time", "def main():",
               "In 1905, Einstein", "A quantized model", "Tokens per second",
               "The H100 has", "Hello", "Why is the sky blue?", "1, 2, 3, 5, 8,",
               "Translate to French: cat", "Summarize: the port"]


def serve_clis(cfg, dev):
    """Path w: a CLI_LAYERS-layer Llama-2-7B-shaped int4 g128 checkpoint
    (random weights, seed 3) written by save_model under build/path_w, then
    cli.benchmark_ppl (wikitext2, 4 x 2048 tokens), cli.benchmark_latency
    and cli.serve --slots 8 (12 prompts, 16 tokens) in-process with
    --device cuda, their printed output captured. Gates: benchmark_ppl's
    JSON equals Benchmark.eval_ppl on the reloaded model; benchmark_latency
    has eval_latency's keys, weight_bytes = model_weight_bytes and a roofline
    fraction in (0, 1]; serve's tokens equal ContinuousBatcher's (8 slots,
    int8 cache, the tokenizer's eos) on the reloaded model."""
    import contextlib
    import io
    import shutil

    import torch

    from mi_optimize_tpu_torch.cli import benchmark_latency, benchmark_ppl, serve
    from mi_optimize_tpu_torch.datasets.tokenizer import ByteTokenizer
    from mi_optimize_tpu_torch.eval.benchmark import Benchmark
    from mi_optimize_tpu_torch.eval.latency import model_weight_bytes
    from mi_optimize_tpu_torch.export import load_model, save_model
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
    from mi_optimize_tpu_torch.serving.batching import ContinuousBatcher
    from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving

    root = os.path.join(HERE, "build", "path_w")
    shutil.rmtree(root, ignore_errors=True)
    ckpt, prompts = os.path.join(root, "ckpt"), os.path.join(root, "prompts.txt")
    wcfg = dataclasses.replace(cfg, num_layers=CLI_LAYERS)
    save_model(Model(config=wcfg, params=build_quantized_llama(
        wcfg, bits=4, groupsize=128, dtype=torch.bfloat16, seed=3, device=dev)), ckpt)
    with open(prompts, "w") as f:
        f.write("\n".join(CLI_PROMPTS) + "\n")
    q = ["--quantized-model", ckpt, "--device", dev]
    printed, res = io.StringIO(), {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        res["ppl"], res["ppl_s"] = timed_s(lambda: benchmark_ppl.main(q + ["--nsamples", "4"]))
        res["latency"], res["latency_s"] = timed_s(lambda: benchmark_latency.main(q))
        res["serve"], res["serve_s"] = timed_s(lambda: serve.main(
            q + ["--prompts", prompts, "--slots", "8", "--max-len", "512",
                 "--max-new-tokens", "16"]))
    res["cli_s"] = time.perf_counter() - t0
    tok, qm = ByteTokenizer(), load_model(ckpt, device=dev)
    want_ppl = Benchmark(device=dev).eval_ppl(qm, tok, "wikitext2", seqlen=2048, nsamples=4)
    lat, dec = res["latency"], res["latency"]["decode"]
    b = ContinuousBatcher(fuse_for_serving(qm), n_slots=8, max_len=512, cache_dtype=torch.int8)
    if b._mega is None and torch.device(dev).type == "cuda":
        raise AssertionError("path w: the reference batcher did not take the batched kernel")
    reqs, pending = {}, list(enumerate(CLI_PROMPTS))
    while pending or any(r is not None for r in b.slot_req):
        while pending:
            rid = b.add_request(tok(pending[0][1])["input_ids"], max_new_tokens=16,
                                eos_token_id=tok.eos_token_id)
            if rid is None:
                break
            reqs[str(pending.pop(0)[0])] = next(r for r in b.slot_req if r and r.rid == rid)
        b.step()
    want_serve = {k: r.tokens for k, r in reqs.items()}
    shutil.rmtree(root, ignore_errors=True)
    log(f"  path w: benchmark_ppl {res['ppl']} in {res['ppl_s']:.1f} s (library "
        f"{want_ppl}); benchmark_latency forward {lat['forward']['avg_ms']:.3f} ms, decode "
        f"{dec['tokens_per_s_per_chip']:.2f} tokens/s, roofline {dec['roofline_frac']:.4f} in "
        f"{res['latency_s']:.1f} s; serve --slots 8: {res['serve']['tokens']} tokens of "
        f"{len(CLI_PROMPTS)} requests in {res['serve']['seconds']:.2f} s, "
        f"{'equal' if res['serve']['requests'] == want_serve else 'DIFFERENT'} to "
        f"ContinuousBatcher's; {len(printed.getvalue())} bytes printed")
    if res["ppl"] != want_ppl:
        raise AssertionError(f"path w: benchmark_ppl {res['ppl']} against eval_ppl {want_ppl}")
    if set(lat) != {"forward", "decode"} or dec["weight_bytes"] != model_weight_bytes(qm) \
            or not 0 < dec["roofline_frac"] <= 1:
        raise AssertionError(f"path w: benchmark_latency's result is off: {lat}")
    if res["serve"]["requests"] != want_serve:
        raise AssertionError("path w: serve's tokens differ from ContinuousBatcher's")
    return res


def _to(tree, dev):
    import dataclasses

    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _to(getattr(tree, f.name), dev) for f in dataclasses.fields(tree)
            if f.init and isinstance(getattr(tree, f.name), torch.Tensor)})
    return tree


KERNELS = {
    "dequant_matmul": ("mi_optimize_tpu_torch/csrc/dequant_matmul.cu",
                       "mi_optimize_tpu/ops/dequant_matmul.py:93"),
    "dequant_matmul_gemv16": ("mi_optimize_tpu_torch/csrc/dequant_matmul.cu",
                              "mi_optimize_tpu/ops/dequant_matmul.py:93"),
    "dequant_matmul_mma": ("mi_optimize_tpu_torch/csrc/dequant_matmul.cu",
                           "mi_optimize_tpu/ops/dequant_matmul.py:93"),
    "block_decode_mega": ("mi_optimize_tpu_torch/csrc/block_fused.cu",
                          "mi_optimize_tpu/ops/block_fused.py:328"),
    "block_decode_mega4": ("mi_optimize_tpu_torch/csrc/model_mega4.cu",
                           "mi_optimize_tpu/ops/block_fused.py:328"),
    "model_decode_flat": ("mi_optimize_tpu_torch/csrc/model_flat.cu",
                          "mi_optimize_tpu/ops/model_flat.py:149"),
    "model_decode_mega": ("mi_optimize_tpu_torch/csrc/model_fused.cu",
                          "mi_optimize_tpu/ops/model_fused.py:99"),
    "model_decode_mega4": ("mi_optimize_tpu_torch/csrc/model_mega4.cu",
                           "mi_optimize_tpu/ops/model_fused.py:99"),
    "model_decode_mega_batch": ("mi_optimize_tpu_torch/csrc/model_fused.cu",
                                "mi_optimize_tpu/ops/model_fused.py:594"),
    "model_decode_mega_batch_paged": ("mi_optimize_tpu_torch/csrc/model_fused.cu",
                                      "mi_optimize_tpu/ops/model_fused.py:594"),
    "model_decode_mega_batch_chunk": ("mi_optimize_tpu_torch/csrc/model_fused.cu",
                                      "mi_optimize_tpu/ops/model_fused.py:594"),
    "paged_flash_attention": ("mi_optimize_tpu_torch/csrc/paged_attention.cu",
                              "mi_optimize_tpu/ops/paged_attention.py:35"),
    "model_decode_mega_batch_lm": ("mi_optimize_tpu_torch/csrc/model_fused.cu",
                                   "mi_optimize_tpu/ops/model_fused.py:999"),
    "model_decode_flat_seg": ("mi_optimize_tpu_torch/csrc/model_flat.cu",
                              "mi_optimize_tpu/ops/model_flat_seg.py:57"),
    "decode_attention": ("mi_optimize_tpu_torch/csrc/decode_attention.cu",
                         "mi_optimize_tpu/ops/decode_attention.py:37"),
    "mlp_fused": ("mi_optimize_tpu_torch/csrc/mlp_fused.cu", "mi_optimize_tpu/ops/mlp_fused.py:44"),
    "mlp_fused_gemv": ("mi_optimize_tpu_torch/csrc/mlp_fused.cu",
                       "mi_optimize_tpu/ops/mlp_fused.py:44"),
    "mlp_fused_mma": ("mi_optimize_tpu_torch/csrc/mlp_fused.cu",
                      "mi_optimize_tpu/ops/mlp_fused.py:44"),
    "mlp_fused_cuda_core": ("mi_optimize_tpu_torch/csrc/mlp_fused.cu",
                            "mi_optimize_tpu/ops/mlp_fused.py:44"),
    "w4a8_matmul": ("mi_optimize_tpu_torch/csrc/w4a8_matmul.cu",
                    "mi_optimize_tpu/ops/w4a8_matmul.py:49"),
    "model_decode_mega_batch_tp": ("mi_optimize_tpu_torch/csrc/model_fused_tp.cu",
                                   "mi_optimize_tpu/ops/model_fused.py:594"),
    "ring_chunk": ("mi_optimize_tpu_torch/csrc/overlap.cu",
                   "mi_optimize_tpu/parallel/overlap.py:57"),
}


def counters():
    """(module, attribute) of each kernel's launch counter."""
    from mi_optimize_tpu_torch.ops import (block_fused, decode_attention, dequant_matmul,
                                           int8_matmul, mlp_fused, model_flat, model_flat_seg,
                                           model_fused, paged_attention, w4a8_matmul)
    from mi_optimize_tpu_torch.parallel import overlap

    return {"dequant_matmul": (dequant_matmul, "launches"),
            "dequant_matmul_gemv16": (dequant_matmul, "launches_gemv16"),
            "dequant_matmul_mma": (dequant_matmul, "launches_mma"),
            "block_decode_mega": (block_fused, "launches"),
            "block_decode_mega4": (block_fused, "launches_mega4"),
            "model_decode_flat": (model_flat, "launches"),
            "model_decode_mega": (model_fused, "launches"),
            "model_decode_mega4": (model_fused, "launches_mega4"),
            "model_decode_mega_batch": (model_fused, "launches_batch"),
            "model_decode_mega_batch_paged": (model_fused, "launches_paged"),
            "model_decode_mega_batch_chunk": (model_fused, "launches_chunk"),
            "paged_flash_attention": (paged_attention, "launches"),
            "model_decode_mega_batch_lm": (model_fused, "launches_lm"),
            "model_decode_flat_seg": (model_flat_seg, "launches"),
            "decode_attention": (decode_attention, "launches"),
            "mlp_fused": (mlp_fused, "launches"),
            "mlp_fused_gemv": (mlp_fused, "launches_gemv"),
            "mlp_fused_mma": (mlp_fused, "launches_mma"),
            "mlp_fused_cuda_core": (mlp_fused, "launches_cuda_core"),
            "w4a8_matmul": (w4a8_matmul, "launches"),
            "model_decode_mega_batch_tp": (model_fused, "launches_tp"),
            "ring_chunk": (overlap, "launches"),
            "ring_chunk_gemv": (overlap, "launches_gemv"),
            "ring_chunk_mma": (overlap, "launches_mma"),
            "ring_chunk_cuda_core": (overlap, "launches_cuda_core"),
            # the W8A8 route's torch._int_mm calls (a library call, not a kernel row)
            "w8a8_int_mm": (int8_matmul, "launches")}


def run_path(name, needs, fn, cuda_core=False):
    """Drive one path with every launch counter at 0 just before it and read
    just after; fail unless each kernel in `needs` launched, and, unless
    `cuda_core` (a path with 8-bit linears), if the CUDA-core dequant_matmul or
    mlp_fused kernels launched (every other served linear is bf16 int4: the
    tensor-core kernels' inputs). Returns (the path's result with its peak
    memory, its counts)."""
    import torch

    cs = counters()
    for m, attr in cs.values():
        setattr(m, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    res = fn()
    counts = {k: getattr(m, attr) for k, (m, attr) in cs.items()}
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["launches"] = counts
    log(f"  {name}: peak memory {res['peak_mem_gib']:.2f} GiB; launches {counts}")
    missing = [k for k in needs if counts[k] == 0]
    if missing:
        raise AssertionError(f"{name} launched no {missing} kernel")
    if not cuda_core and (counts["dequant_matmul"] or counts["mlp_fused_cuda_core"]):
        raise AssertionError(f"{name} took the CUDA-core dequant_matmul or mlp_fused kernels "
                             "for bf16 int4 linears")
    return res, counts


def compare_baseline(report, path) -> dict:
    """This run's kernel rows (by name, else the name of the kernel a row
    replaced where it gives one, and shape), phase 5 windows and ptxas
    instances beside those of the report at `path` (another tree's run in the
    same call), logged one a line: {"kernels": [[name, shape, ms, its ms]],
    "profile": [[window, device ms, its device ms, wall ms, its wall ms, busy
    share, its busy share]], "ptxas": [[instance,
    registers, spill stores, its registers, its spill stores]]}."""
    with open(path) as f:
        base = json.load(f)
    log(f"comparison with {path} (same call)")
    out = {"kernels": [], "profile": [], "ptxas": []}
    theirs = {(k["name"], k["shape"]): k["ms"] for k in base.get("kernels", [])}
    for k in report["kernels"]:
        b = theirs.get((k["name"], k["shape"]), theirs.get((k.get("baseline_name"), k["shape"])))
        if b is not None:
            out["kernels"].append([k["name"], k["shape"], k["ms"], b])
            log(f"  {k['name']} {k['shape']}: {k['ms']:.4f} ms, baseline {b:.4f} ms "
                f"({b / k['ms']:.3f}x, {100 * (k['ms'] / b - 1):+.1f}%)")
    for w, v in report.get("profile", {}).items():
        bw = base.get("profile", {}).get(w, {})
        b = bw.get("device_ms")
        if b and v.get("device_ms"):
            out["profile"].append([w, v["device_ms"], b, v["wall_ms"], bw["wall_ms"],
                                   v["busy_share"], bw["busy_share"]])
            log(f"  phase 5 {w}: device {v['device_ms']:.3f} ms, baseline {b:.3f} ms "
                f"({b / v['device_ms']:.3f}x); wall {v['wall_ms']:.3f} ms, baseline "
                f"{bw['wall_ms']:.3f} ms; busy share {v['busy_share']:.3f}, baseline "
                f"{bw['busy_share']:.3f}")
    theirs = {r["instance"]: r for r in base.get("ptxas", [])}
    for r in report.get("ptxas", []):
        b = theirs.get(r["instance"])
        if b is not None:
            out["ptxas"].append([r["instance"], r.get("registers"), r["spill_stores"],
                                 b.get("registers"), b["spill_stores"]])
            same = (r.get("registers"), r["spill_stores"], r["spill_loads"]) == (
                b.get("registers"), b["spill_stores"], b["spill_loads"])
            log(f"  ptxas {r['instance']}: {r.get('registers')} registers, {r['spill_stores']}/"
                f"{r['spill_loads']} bytes spilled; baseline {b.get('registers')}, "
                f"{b['spill_stores']}/{b['spill_loads']} ({'same' if same else 'DIFFERENT'})")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description="Drive the port's main path on one GPU.")
    ap.add_argument("--report", help="also write the whole report as JSON to this path")
    ap.add_argument("--baseline", help="a report (--report) of another tree's run in the same "
                    "call: print its kernel times, phase 5 device times and registers beside "
                    "this run's")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "mi_optimize_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout of the repository "
              "(mi_optimize_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
    from mi_optimize_tpu_torch.ops import _build
    from mi_optimize_tpu_torch.serving.batching import SpeculativeBatcher
    from mi_optimize_tpu_torch.serving.flatdecode import stack_flat
    from mi_optimize_tpu_torch.serving.megadecode import stack_lm, stack_serving
    from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
    from mi_optimize_tpu_torch.serving.paged import PagedSpeculativeBatcher
    from mi_optimize_tpu_torch.utils.planted import build_planted_llama, planted_map, planted_pair

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    smi = nvidia_smi_line()
    log(f"gpu: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    report = {"gpu": smi, "device": torch.cuda.get_device_name(0)}
    t_run, report["phase_at_s"] = time.perf_counter(), {}

    def phase(name, what):  # a phase's header, with its start in seconds into the run
        report["phase_at_s"][name] = time.perf_counter() - t_run
        log(f"phase {name}: {what} (at {report['phase_at_s'][name]:.1f} s)")

    phase("1", "build")
    t0 = time.perf_counter()
    _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"  built {', '.join(_build.SOURCES)} in {report['build_s']:.1f} s")
    report["ptxas"] = ptxas_report()

    cfg = LlamaConfig.llama2_7b()

    def build(symmetric, seed):
        return fuse_for_serving(Model(config=cfg, params=build_quantized_llama(
            cfg, bits=4, groupsize=128, dtype=torch.bfloat16, seed=seed, device=dev,
            symmetric=symmetric)))

    def unfused(c=cfg, seed=0):
        """The random-weight model as quantization returns it: separate
        q/k/v and gate/up, no fuse_for_serving."""
        return Model(config=c, params=build_quantized_llama(
            c, bits=4, groupsize=128, dtype=torch.bfloat16, seed=seed, device=dev))

    def asymmetric():
        """The asymmetric-grid model (a zero per group, as GPTQ's default
        grid): the flat kernel refuses it, the whole-model kernel streams its
        bias tables. Built when needed and dropped after, so that each path's
        peak memory holds one model."""
        amodel = build(False, 1)
        st = stack_serving(amodel)
        if stack_flat(amodel, st) is not None or st is None or any(z is not None
                                                                   for z in st[1][5:]):
            raise AssertionError("the asymmetric model should take the bias-table route only")
        return amodel, st[0], st[1]

    t0 = time.perf_counter()
    model = build(True, 0)
    fl = stack_flat(model)
    if fl is None:
        raise AssertionError("the synthetic model does not meet the flat kernel's contract")
    fstack, fmeta = fl
    torch.cuda.synchronize()
    log(f"  Llama-2-7B int4 g128 model built and stacked in {time.perf_counter() - t0:.1f} s")
    # planted models (utils/planted.py): a Llama-2-7B target whose greedy
    # chain follows a fixed token map, a 2-layer draft at the same width with
    # the same map, and one whose map disagrees on 30% of the vocabulary
    t0 = time.perf_counter()
    target, draft, m_t, _ = planted_pair(cfg, draft_layers=2, device=dev)
    dcfg = draft.config
    draft3 = Model(config=dcfg, params=build_planted_llama(
        dcfg, planted_map(cfg.vocab_size, disagree_frac=0.3), device=dev))
    target, draft, draft3 = (fuse_for_serving(m) for m in (target, draft, draft3))
    dfl = stack_flat(draft)
    if stack_flat(target) is None or dfl is None:
        raise AssertionError("the planted models do not meet the flat kernel's contract")
    torch.cuda.synchronize()
    log(f"  planted Llama-2-7B target and two 2-layer drafts built in "
        f"{time.perf_counter() - t0:.1f} s")

    phase("2", "kernels against their plain versions (bf16, Llama-2-7B shapes)")
    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev)
    rows = check_dequant_matmul(model, cfg, dev, flush, reps=20)
    rows += check_block(model, cfg, dev, flush, reps=20)
    rows += check_flat(model, fstack, fmeta, cfg, dev, flush, reps=5)
    rows += check_flat(model, fstack, fmeta, cfg, dev, flush, reps=5, pos=0, gate="cut")
    rows += check_flat(draft, *dfl, dcfg, dev, flush, reps=20, name="planted 2-layer draft, ",
                       gate="planted")
    sstack, smeta = stack_serving(model)  # the layers' stack the flat one extends, not a copy
    dense_positions = [0, 17, 64, 127, 128, 200, 383, 510]
    rows += check_mega_batch(model, sstack, smeta, cfg, dev, flush, 5, dense_positions)
    rows += check_mega_batch(model, sstack, smeta, cfg, dev, flush, 5, [0] * 8,
                             label="every slot at position 0, ")
    phase("2b", "the batched kernel's bf16 gate against three planted faults")
    report["planted_faults"] = planted_faults(model, sstack, smeta, cfg, dev, dense_positions)
    rows += check_mega_batch_paged(model, sstack, smeta, cfg, dev, flush, 5, dense_positions)
    rows += check_mega_batch_chunk(model, sstack, smeta, cfg, dev, flush, 5, [256], 8, True)
    rows += check_mega_batch_chunk(model, sstack, smeta, cfg, dev, flush, 5, [0, 300], 4, False)
    lm, lm_meta = stack_lm(model, smeta)
    for prefixes, C, paged in (([256], 5, False), ([256], 5, True), (dense_positions, 1, False)):
        rows += check_mega_batch_lm(model, sstack, smeta, lm, lm_meta, cfg, dev, flush, 5,
                                    prefixes, C, paged)
    # the tensor-parallel kernels at the 7B shard shapes: B5(e) dense and paged, B11
    rows += check_mega_batch_tp(model, sstack, smeta, cfg, dev, flush, 5, dense_positions)
    rows += check_mega_batch_tp(model, sstack, smeta, cfg, dev, flush, 5, dense_positions,
                                paged=True)
    rows += check_mega_batch_tp(model, sstack, smeta, cfg, dev, flush, 5, [510] + [0] * 7)
    rows += check_ring(model, cfg, dev, flush, 5)
    torch.cuda.empty_cache()
    rows += check_flat_seg("random weights", model, fstack, fmeta, cfg, dev, flush, 5)
    rows += check_flat_seg("planted 2-layer draft", draft, *dfl, dcfg, dev, flush, 20)
    rows += check_paged_attention(cfg, dev, flush, reps=20)
    rows += check_paged_attention(cfg, dev, flush, reps=20, positions=(511,))
    rows += check_paged_attention(dataclasses.replace(cfg, num_kv_heads=cfg.num_heads // 4), dev,
                                  flush, reps=20)
    del sstack, smeta, lm
    amodel, astack, ameta = asymmetric()
    rows += check_mega(amodel, astack, ameta, cfg, dev, flush, reps=5)
    rows += check_block(amodel, cfg, dev, flush, reps=20, positions=(200,), label="asymmetric ")
    rows += check_mega_batch(amodel, astack, ameta, cfg, dev, flush, 5, [77, 300],
                             label="asymmetric ")
    del amodel, astack, ameta
    torch.cuda.empty_cache()
    # the unfused model's kernels: decode attention, fused MLP, W4A8 integer
    # product, on layer 0 of the unfused random-weight model (seed 0)
    rows += check_decode_attention(cfg, dev, flush, reps=20,
                                   cases=((384, 200), (2048, 2047), (4096, 4095)))
    rows += check_decode_attention(dataclasses.replace(cfg, num_kv_heads=cfg.num_heads // 4),
                                   dev, flush, reps=20, cases=((2048, 2047),))
    ublk = unfused(dataclasses.replace(cfg, num_layers=1)).params["layers"][0]
    rows += check_mlp_fused(ublk, cfg, dev, flush, reps=5)
    rows += check_w4a8(ublk, cfg, dev, flush, reps=5)
    del ublk
    torch.cuda.empty_cache()
    # calibration on one fp layer: GPTQ and RTN, card against CPU
    report["calibration_rows"], calib_layer = check_calibration_7b(cfg, dev)
    torch.cuda.empty_cache()
    # the other algorithms and the W8A8 route on the same layer, card against CPU
    new_s = {}  # the seconds of the other algorithms' rows, paths p-r, phase 4, window
    (report["algorithm_rows"], calib_stats), new_s["phase 2 rows"] = timed_s(
        lambda: check_algorithms_7b(cfg, calib_layer, dev, flush))
    torch.cuda.empty_cache()

    phase("3", "serving at Llama-2-7B width and depth (int4 g128, bf16, int8 KV cache)")
    counts = {k: 0 for k in counters()}

    def tally(c):
        for k, n in c.items():
            counts[k] += n

    log(" a. generate + decode_loop_flat")
    report["main_path"], c = run_path(
        "generate + decode_loop_flat", ("dequant_matmul_gemv16", "dequant_matmul_mma",
                                        "block_decode_mega", "block_decode_mega4",
                                        "model_decode_flat"),
        lambda: serve_main_path(model, fstack, fmeta, cfg, dev))
    tally(c)
    if c["block_decode_mega"] != c["block_decode_mega4"]:
        raise AssertionError("a 4-bit block_decode_mega launch took the CUDA-core kernel")
    w_bytes = nbytes(*fstack.values())
    report["main_path"]["decode_bound_ms_per_token"] = w_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  weights read per flat token {w_bytes / 1e9:.3f} GB -> bound "
        f"{report['main_path']['decode_bound_ms_per_token']:.3f} ms/token")
    log(" b. ContinuousBatcher, 8 slots, 24 requests")
    report["batcher"], c = run_path("ContinuousBatcher", ("dequant_matmul_gemv16",
                                                          "dequant_matmul_mma",
                                                          "model_decode_mega_batch"),
                                    lambda: serve_batcher(model, cfg))
    tally(c)
    report["batcher"]["generate_agreement"] = compare_with_generate(
        model, report["batcher"].pop("compare"))
    log(" d. PagedMegaBatcher, the same 24 requests: 8 slots over 25 pages, then 12 slots in "
        "waves of 8")
    from mi_optimize_tpu_torch.serving.paged import PagedMegaBatcher

    for key, slots, pages in (("paged", 8, 25), ("paged_12", 12, None)):
        name = f"PagedMegaBatcher ({slots} slots)"
        make = lambda: PagedMegaBatcher(model, n_slots=slots, max_len=512, n_pages=pages)
        report[key], c = run_path(
            name, ("dequant_matmul_gemv16", "dequant_matmul_mma",
                   "model_decode_mega_batch_paged"),
            lambda: serve_batcher(model, cfg, n_slots=slots, name=name, make=make))
        tally(c)
        report[key].pop("compare")
        same_tokens(name, report[key]["request_tokens"], report["batcher"]["request_tokens"])
    log(f"  peak memory: PagedMegaBatcher {report['paged']['peak_mem_gib']:.2f} GiB (8 slots, 25 "
        f"pages), {report['paged_12']['peak_mem_gib']:.2f} GiB (12 slots, 49 pages) against the "
        f"ContinuousBatcher's {report['batcher']['peak_mem_gib']:.2f} GiB")
    log(" e. prefix caching: 16 requests sharing a 256-token prefix, and one sampled twice")
    report["prefix_cache"], c = run_path(
        "PagedMegaBatcher prefix cache", ("dequant_matmul_mma", "model_decode_mega_batch_paged",
                                          "model_decode_mega_batch_chunk"),
        lambda: serve_prefix_cache(model, cfg))
    tally(c)
    log(" f. PagedBatcher: 8 requests over 4 slots, f32 pool of 64 pages of 16")
    report["paged_batcher"], c = run_path(
        "PagedBatcher", ("dequant_matmul_mma", "paged_flash_attention"),
        lambda: serve_paged_batcher(model, cfg))
    tally(c)
    log(" c. decode_loop_model on the asymmetric grid")
    amodel, astack, ameta = asymmetric()
    report["model_loop"], c = run_path(
        "decode_loop_model", ("dequant_matmul_mma", "model_decode_mega", "model_decode_mega4"),
        lambda: serve_model_loop(amodel, astack, ameta, cfg, dev))
    tally(c)
    del amodel, astack, ameta
    torch.cuda.empty_cache()
    import numpy as np

    prompt = np.random.default_rng(21).integers(0, cfg.vocab_size, (1, 32))
    log(" g. speculative_generate: planted Llama-2-7B target, planted 2-layer drafts")
    serve_speculative(target, draft, m_t, cfg, dev, 4, 8, prompt, "warm-up")
    for key, drf, k, n, name, needs in (
            ("spec_k4", draft, 4, 64, "k=4", ()),
            ("spec_auto", draft, "auto", 160, "k=auto", ("model_decode_mega_batch_paged",)),
            ("spec_k4_disagree", draft3, 4, 64, "k=4, draft disagreeing on 30%", ())):
        report[key], c = run_path(
            f"speculative_generate {name}", ("dequant_matmul_mma", "model_decode_flat",
                                            "model_decode_mega_batch_chunk",
                                            "model_decode_mega_batch_lm") + needs,
            lambda: serve_speculative(target, drf, m_t, cfg, dev, k, n, prompt, name,
                                      need_k8=k == "auto"))
        tally(c)
    report["spec_flat_reference"], c = run_path(
        "decode_loop_flat (planted target)", ("model_decode_flat",),
        lambda: dict(zip(("ms_per_token", "decode_ms_per_token"),
                         serve_flat_reference(target, m_t, cfg, dev, prompt, 64))))
    tally(c)
    log(f"  planted 7B, 64 tokens, ms/token with the prefills: speculative k=4 "
        f"{report['spec_k4']['ms_per_token']:.3f} (accept "
        f"{report['spec_k4']['stats']['accept_rate']:.3f}), k=4 with the 30% draft "
        f"{report['spec_k4_disagree']['ms_per_token']:.3f} (accept "
        f"{report['spec_k4_disagree']['stats']['accept_rate']:.3f}), decode_loop_flat "
        f"{report['spec_flat_reference']['ms_per_token']:.3f}")
    log(" h-i. speculative batchers: 12 planted requests, 4 slots, k=3, the 30% draft")
    for key, name, make, needs in (
            ("spec_batcher", "SpeculativeBatcher (4 slots, k=3, fused lm rows)",
             lambda: SpeculativeBatcher(target, draft3, k=3, n_slots=4, max_len=512,
                                        cache_dtype=torch.int8, fused_lm=True), ()),
            ("paged_spec_batcher", "PagedSpeculativeBatcher (4 slots, k=3, fused lm rows)",
             lambda: PagedSpeculativeBatcher(target, draft3, k=3, n_slots=4, max_len=512,
                                             fused_lm=True), ())):
        report[key], c = run_path(
            name, ("dequant_matmul_mma", "model_decode_mega_batch",
                   "model_decode_mega_batch_chunk",
                   "model_decode_mega_batch_lm") + needs,
            lambda: serve_spec_batcher(make, name, m_t, cfg))
        tally(c)
    log(" j. decode_loop_flat_seg, kseg=5, 40 tokens, on the planted target and draft")

    def flat_seg_paths():
        res = {}
        for name, m in (("target", target), ("draft", draft)):
            seg = serve_flat_reference(m, m_t, m.config, dev, prompt, 40, kseg=5)
            flat = serve_flat_reference(m, m_t, m.config, dev, prompt, 40)
            res[name] = dict(seg_ms_per_token=seg[1], flat_ms_per_token=flat[1])
            log(f"  {name} ({m.config.num_layers} layers): decode_loop_flat_seg {seg[1]:.3f} "
                f"ms/token against decode_loop_flat {flat[1]:.3f} (decode loops alone)")
        return res

    report["flat_seg"], c = run_path("decode_loop_flat_seg", ("model_decode_flat_seg",
                                                             "model_decode_flat"), flat_seg_paths)
    tally(c)
    log(" k. generate on the unfused planted Llama-2-7B, int8 cache: 128-token prompt, 32 tokens")
    ptarget = Model(config=cfg, params=build_planted_llama(cfg, m_t, device=dev))
    report["generate_unfused"], c = run_path(
        "generate_unfused", ("dequant_matmul_gemv16", "dequant_matmul_mma", "decode_attention",
                             "mlp_fused", "mlp_fused_gemv", "mlp_fused_mma"),
        lambda: serve_generate_unfused(ptarget, m_t, cfg, dev))
    tally(c)
    if c["block_decode_mega"] or c["model_decode_flat"]:
        raise AssertionError("generate_unfused launched a fused-model decode kernel")
    log(" l. compute_ppl on the unfused random-weight Llama-2-7B, 2 x 2048 tokens")
    rmodel = unfused()
    report["ppl_unfused"], c = run_path("ppl_unfused", ("dequant_matmul_mma", "mlp_fused",
                                                        "mlp_fused_mma"),
                                        lambda: serve_ppl_unfused(rmodel, cfg))
    tally(c)
    log(" m. the W4A8 spec on every decoder linear, MI_W4A8_INT=1")
    report["w4a8_unfused"], c = run_path(
        "w4a8_unfused", ("dequant_matmul_gemv16", "dequant_matmul_mma", "decode_attention",
                         "w4a8_matmul"),
        lambda: serve_w4a8(ptarget, m_t, rmodel, cfg))
    tally(c)
    log(f" n. quantize an fp Llama-2-7B (bf16, seed 0, {CALIB_LAYERS} layers) by GPTQ on "
        "wikitext, then serve it and measure its perplexity")
    fp = fp_llama(dataclasses.replace(cfg, num_layers=CALIB_LAYERS), dev)
    report["calibrated"], c = run_path(
        "quantize + eval_ppl + decode_loop_model", ("dequant_matmul_mma", "mlp_fused",
                                                    "mlp_fused_mma", "model_decode_mega",
                                                    "model_decode_mega4"),
        lambda: serve_calibrated(fp, fp.config, dev))
    tally(c)
    log(" o. the north-star config (act-order) on the first 2 layers, served unfused")
    report["calibrated_actorder"], c = run_path(
        "quantize act-order + generate + compute_ppl", ("dequant_matmul_gemv16",
                                                        "dequant_matmul_mma", "decode_attention"),
        lambda: serve_actorder(fp, cfg, dev))
    tally(c)
    if c["block_decode_mega"] or c["model_decode_flat"] or c["model_decode_mega"] \
            or c["mlp_fused"]:
        raise AssertionError("path o launched a fused-model decode kernel or the fused MLP on "
                             "permuted linears")
    t_algos = time.perf_counter()
    fpa = Model(config=dataclasses.replace(cfg, num_layers=ALGO_LAYERS),
                params=dict(fp.params, layers=fp.params["layers"][:ALGO_LAYERS]))
    log(f" p. AWQ int4 g128 of the fp Llama-2-7B's first {ALGO_LAYERS} layers, served unfused")
    report["awq"], c = run_path(
        "AWQ: quantize + generate + eval_ppl", ("dequant_matmul_gemv16", "dequant_matmul_mma",
                                                "decode_attention"),
        lambda: serve_awq(fpa, fpa.config, dev))
    tally(c)
    no_fused_decode("path p", c)
    log(f" q. SmoothQuant W8A8 of the same {ALGO_LAYERS} layers, served unfused")
    report["smoothquant_w8a8"], c = run_path(
        "SmoothQuant W8A8: quantize + generate + eval_ppl", ("decode_attention", "w8a8_int_mm"),
        lambda: serve_smoothquant(fpa, fpa.config, dev))
    tally(c)
    no_fused_decode("path q", c)
    log(" r. ZeroQuant, FP8, AWQ+GPTQ and SmoothQuant+GPTQ on the first 2 layers")
    report["other_algorithms"], c = run_path(
        "ZeroQuant, FP8, AWQ+GPTQ, SmoothQuant+GPTQ: quantize + eval_ppl",
        ("dequant_matmul", "dequant_matmul_mma"), lambda: serve_other_algos(fp, cfg, dev),
        cuda_core=True)
    tally(c)
    new_s["paths p-r"] = time.perf_counter() - t_algos
    log(f" s. a Llama-2-7B-shaped HF checkpoint ({CKPT_LAYERS} layers): load, calibrate on C-Eval "
        "(interrupted and resumed), save, reload, PPL, C-Eval, CMMLU, BOSS, beam search")
    t_s = time.perf_counter()
    manifest = (os.path.join(os.path.dirname(os.path.abspath(args.report)), "path_s_manifest.json")
                if args.report else None)
    report["checkpoint"], c = run_path(
        "checkpoint: load + calibrate + resume + save + reload + evaluate + beam",
        ("dequant_matmul_gemv16", "dequant_matmul_mma", "mlp_fused", "decode_attention",
         "model_decode_mega_batch", "model_decode_mega_batch_paged"),
        lambda: serve_checkpoint(dict(LLAMA2_7B_HF, num_hidden_layers=CKPT_LAYERS), dev, target,
                                 m_t, os.path.join(HERE, "build", "path_s"), manifest))
    tally(c)
    report["checkpoint"]["wall_s"] = time.perf_counter() - t_s
    log(f"  path s: {report['checkpoint']['wall_s']:.1f} s, peak memory "
        f"{report['checkpoint']['peak_mem_gib']:.2f} GiB")
    del fp, fpa
    torch.cuda.empty_cache()
    log(" t. tensor-parallel serving: 2 gloo ranks on the one card, the planted target's 8 "
        "requests through the TP ContinuousBatcher and PagedMegaBatcher, one TP step of the "
        "random-weight model")
    t_t = time.perf_counter()
    sstack, smeta = stack_serving(model)
    report["tp_serving"], c = run_path(
        "tensor-parallel serving (2 gloo ranks)", ("model_decode_mega_batch_tp", "ring_chunk",
                                                   "ring_chunk_mma", "dequant_matmul_mma"),
        lambda: serve_tp(model, sstack, smeta, target, cfg, dev, dense_positions))
    if c["ring_chunk_cuda_core"]:
        raise AssertionError("path t took the CUDA-core ring tiles for bf16 int4 windows")
    tally(c)
    del sstack, smeta
    report["tp_serving"]["wall_s"] = time.perf_counter() - t_t
    log(f"  path t: {report['tp_serving']['wall_s']:.1f} s")
    new_parts = {}  # this slice's paths' seconds
    log(" u. latency: Benchmark.eval_latency (batch 1, 128 tokens, int8 cache) on the served "
        "model, the unfused model's forward, the flat kernel alone")
    t_u = time.perf_counter()
    report["latency"], c = run_path(
        "latency", ("dequant_matmul_gemv16", "dequant_matmul_mma", "block_decode_mega4",
                    "model_decode_mega4", "mlp_fused", "model_decode_flat"),
        lambda: serve_latency(model, fstack, fmeta, rmodel, cfg, dev, smi))
    tally(c)
    new_parts["path u"] = time.perf_counter() - t_u
    log(" v. lm-eval: loglikelihood, rolling, greedy_until and mixed tasks, fused against "
        "fused=False")
    t_v = time.perf_counter()
    report["lmeval"], c = run_path("lm-eval", ("dequant_matmul_gemv16", "dequant_matmul_mma"),
                                   lambda: serve_lmeval(model, target, cfg, dev))
    tally(c)
    new_parts["path v"] = time.perf_counter() - t_v
    log(f" w. the CLI twins on a {CLI_LAYERS}-layer checkpoint: benchmark_ppl, benchmark_latency, "
        "serve --slots 8")
    t_w = time.perf_counter()
    report["clis"], c = run_path("CLI twins", ("dequant_matmul_mma", "mlp_fused",
                                               "model_decode_mega_batch"),
                                 lambda: serve_clis(cfg, dev))
    tally(c)
    new_parts["path w"] = time.perf_counter() - t_w
    log(f"  launches over the served paths: {counts}")

    phase("4", "small f32 model on the card vs the plain versions on the CPU")
    cs = counters()
    core, mcore = cs["dequant_matmul"], cs["mlp_fused_cuda_core"]
    setattr(core[0], core[1], 0)
    setattr(mcore[0], mcore[1], 0)
    small_reference_check(dev)
    small_serving_check(dev)
    small_paged_check(dev)
    small_spec_check(dev)
    small_spec_batchers_check(dev)
    small_unfused_check(dev)
    t_small = time.perf_counter()
    small_lmeval_check(dev)
    new_parts["phase 4 small lm-eval"] = time.perf_counter() - t_small
    report["small_calibration"] = small_calibration_check(dev)
    report["small_algorithms"], new_s["phase 4 small algorithms"] = timed_s(
        lambda: small_algorithms_check(dev))
    # the CUDA-core dequant_matmul kernels serve the f32 models and path r's 8-bit
    # linears: their launches are these paths' (the bf16 int4 paths must launch none)
    counts["dequant_matmul"] += getattr(*core)
    counts["mlp_fused_cuda_core"] += getattr(*mcore)
    log(f"  CUDA-core dequant_matmul kernels (f32 x, path r's 8-bit words): "
        f"{counts['dequant_matmul']} launches; "
        f"CUDA-core mlp_fused kernels: {counts['mlp_fused_cuda_core']}")
    if not counts["dequant_matmul"]:
        raise AssertionError("the f32 paths launched no CUDA-core dequant_matmul kernel")

    phase("5", "where the time goes (torch.profiler, Llama-2-7B, T=512)")
    amodel, astack, ameta = asymmetric()
    report["profile"] = profile_windows(
        model, fstack, fmeta, cfg, dev,
        extra={"decode_loop_model_16": (model_loop_window(amodel, astack, ameta, cfg, dev), 16),
               "spec_round": (spec_round_window(target, draft, cfg, dev), 1),
               "generate_unfused_8": (unfused_decode_window(ptarget, cfg, dev), 8),
               "generate_unfused_long_8": (unfused_decode_window(ptarget, cfg, dev, S=1920,
                                                                 T=2048), 8),
               "ppl_2048": (ppl_window(rmodel, cfg, dev), 2048),
               "gptq_layer_7b": (gptq_layer_window(calib_layer), 1, dict(reps=1, raw=True)),
               "awq_layer_7b": (awq_layer_window(calib_layer, calib_stats), 1,
                                dict(reps=1, raw=True))})
    del amodel, astack, ameta
    new_s["awq_layer_7b window"] = report["profile"]["awq_layer_7b"]["wall_ms"] * 2e-3
    report["algorithm_parts_s"] = dict(new_s, total=sum(new_s.values()))
    log("  the other algorithms' parts: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in report["algorithm_parts_s"].items()))
    report["new_parts_s"] = dict(new_parts, total=sum(new_parts.values()))
    log("  new_parts_s: " + ", ".join(f"{k} {v:.1f} s" for k, v in report["new_parts_s"].items()))

    kernels = []
    for r in rows:
        src, rep = KERNELS[r["name"]]
        kernels.append({"name": r["name"], "shape": r["shape"], "route": "cuda",
                        "source": src, "replaces": rep, "launches": counts[r["name"]],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r.get("library_ms")})
    report["kernels"] = [dict(k, bytes=r["bytes"], flops=r["flops"],
                              library_max_abs_err=r.get("library_max_abs_err"),
                              codes=r.get("codes"), cuda_core_ms=r.get("cuda_core_ms"),
                              baseline_name=r.get("baseline_name"))
                         for k, r in zip(kernels, rows)]
    report["run_s"] = time.perf_counter() - t_run
    log(f"run: {report['run_s']:.1f} s from the build's start")
    if args.baseline:
        report["baseline"] = compare_baseline(report, args.baseline)
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    log(f"gpu: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
