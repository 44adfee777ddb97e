#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

  python3 chip_smoke.py            # from the root of a checkout, one card

Phases, each printing one JSON line (any failure raises and exits non-zero):
  1. device   — the card (``nvidia-smi`` name and power limit, printed raw too);
  2. build    — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``;
  3. kernels  — each kernel against its plain PyTorch version on the card, at
                the llama2-7b main-path shapes, with times and bounds, on a
                Timer that reads a buffer twice the L2's size before each
                run (clean L2) and beside an empty kernel's time on it
                (``launch_floor_ms``); the router at every main-path shape
                (D 4096 and 2560 at T 2048, 453 and 4, bf16 and fp32, each
                launched twice bit for bit and, above 16 rows, its first
                16 rows held bit for bit against a call on those rows
                alone, timed beside the two-call torch composite);
                (dense and int4 fused linear and flash in bf16 and
                fp32 activations, the int4 matmul at the lm head; the
                dense fused linear's two bf16 kernels, the tensor-core tile
                at M 2048 and the split-K stream at M 4, each launched
                twice bit for bit, Σy² held against the plain version on
                the operand the route feeds, its fp32 inputs on the SIMT
                kernel; flash attention's two bf16 kernels, the tensor-core
                tile at prefill (4 × 512) and the cluster split-KV walk at
                decode (B 4 against 544 rows), each launched twice bit for
                bit and also held against the mirror that rounds P as the
                route does, its fp32 inputs on the SIMT kernel; the int4
                fused linear's two kernels, the s8 tensor-core tile at M
                2048, 512 and 256 and the split-K code stream at M 4, and
                the int4 matmul's stream at the lm head (M 4; its tile at
                M 2048 for the record), in bf16 and fp32 activations, each
                launched twice bit for bit, held bit for bit against the
                plain version summed in the route's order (GLU outputs
                within one ulp plus the activation's difference) and
                against the exact dequantized weights, timed beside the
                bf16 dense route at the same shape; paged
                attention in bf16, int8 and int4 pages over a 512-token
                history of a keep-0.5 gate log, bf16 q on the cluster
                split walk (launched twice bit for bit; timed beside the
                SIMT kernel on the same bf16 inputs and beside flash's
                split-KV walk over the same admitted rows laid out
                contiguously, the yardstick), fp32 q on the SIMT kernel);
                then ragged shapes
                off the tile multiples (the router at D 300, 301 and 4100,
                T 1, 16, 17 and 2049, and x at an address that allows 1 or
                2 elements a load), empty paged histories, padded
                K-groups, odd N, non-pow2 scales and .5 ties, flash pad rows
                and splits without a valid key included (at dh 256 too:
                prefills of 1000, 300 and 1100 tokens with kv_len below
                Tk, pad rows and a linear-cache decode past W under window
                1024, gemma3's G 2), paged G 8, 16 and
                32, head groups that do not divide Hkv, fewer admitted
                entries than blocks, all of them in one block's slice, two
                windows and rounds of listed rows, each flash, int4 and
                paged case on the route its plan picks, and the C entries'
                refusals of
                plans off their source (not timed); the SSD chunk scan at
                the mamba2-2.7b shapes (x [4, 512, 80, 64] and [1, 512, 80,
                64], B/C [B, 512, 1, 128], chunk 128; y and the final
                state): bf16 on the tensor-core route (timed beside the
                SIMT kernel on the same bf16 inputs, and held also against
                the mirror of its three-term bf16 split, tightly on inputs
                whose cumsums are exact), fp32 on the SIMT kernel, each
                launched twice bit for bit, with byte and operation
                bounds; and at ragged ones (T off the chunk, T <
                chunk, T = 1, dt = 0 rows, G > 1, N 16), every bf16 case on
                the tensor-core route and every fp32 case on the SIMT
                kernel, and the C entries' refusals of plans off the
                source;
  4. parity   — llama2-7b smoke in fp32 through the port on cuda (kernels)
                and on cpu (plain versions): gates, logits, tokens of the
                lock-step engine, of teacher-forced paged decode steps and
                of the continuous engine over the paged store; once with
                dense weights and once with int4 weights (group 64);
                exact launch counts of the cuda ``ServeEngine`` run, per
                route (int4: its prefill on the s8 tile, its decode steps
                on the split-K stream);
  5. serve    — full-width llama2-7b in bf16 at LLAMA_LAYERS of its 32
                layers (the depth of phases 5-17; random seeded weights,
                neutral router bias) served by ``ServeEngine.generate``:
                batch 4 x
                prompt 512 + 32 new tokens, greedy; exact launch counts
                (the dense fused linear and flash attention per route too:
                prefill on the tensor-core tiles, decode steps on the
                split-K stream and the split-KV walk);
  6. continuous — the same weights served by ``ContinuousBatchingEngine``
                (4 slots, max_len 544, 8 requests of 128-512 prompt tokens +
                32 greedy tokens) four times: dense pool, paged bf16, int8
                and int4 pages; then 4 requests of 16-token prompts in
                paged bf16 pages, in the default pool and in one too small
                for all four (it must preempt; tokens unchanged); exact
                launch counts per prefill and per decode step (paged
                attention per route: its bf16 steps on the split walk),
                page conservation, finite logits;
  7. witness  — the same weights upcast to fp32: the continuous engine in the
                dense pool and in fp32 pages (paged attention on the SIMT
                kernel) gives identical tokens on 4 phase-6 requests;
                teacher-forced dense and paged decode in fp32 agree
                (gates, logits), and bf16 paged flips no more
                gates against fp32 than bf16 dense does (within 2x + 1 %);
                the fp32 copy is freed after it;
  8. int4     — the phase-5 weights quantized on the card by the port's
                ``quantize_params`` (group 128, pow2 scales: every linear of
                every layer and the lm head), served lock-step (batch 4 x
                512 + 32) and by the continuous engine (the phase-6
                requests) in the dense pool and in paged bf16 pages: exact
                launch counts (4·L int4 fused linears and one int4 matmul
                per forward, by route, no dense fused linear), finite
                logits, weight
                bytes and peak memory; the share of tokens equal to the
                bf16 runs is reported, not checked; the llama2-7b weights
                are freed after it;
  9. parity_mamba — mamba2-2.7b smoke in fp32 through the port on cuda and
                on cpu: gates (the per-layer SSM gate log, smallest router
                margin checked), logits, keep statistics (sums within 1e-6,
                counts exact), lock-step and continuous dense-pool tokens;
                exact launch counts of the cuda runs (every SSD scan on the
                SIMT kernel);
 10. mamba    — full-width mamba2-2.7b in bf16 (random seeded weights,
                neutral router bias) served by ``ServeEngine.generate``
                (batch 4 x prompt 512 + 32) and by the continuous engine (4
                slots, 8 requests of 114-512 prompt tokens + 32, dense pool,
                exact-length prefill): exact launch counts (64 SSD scans per
                prefill, all on the tensor-core route, and none per decode
                step, 64 router passes per forward, no attention or fused
                linear), finite logits,
                weight bytes, peak memory; a paged mamba engine must raise;
 11. fused    — the continuous engine at ``decode_steps`` 8 (device-resident
                epochs: on the card a CUDA graph of one decode iteration,
                replayed) on the weights of phases 6, 8 and 10: the dense
                pool, paged bf16 and int8 pages (phase 6's requests), int4
                weights on the dense pool (phase 8's) and mamba2-2.7b on
                the dense pool (phase 10's), each giving bit for bit the
                tokens of its single-step run; phase 6's 4 short requests
                in its tight paged pool (epochs must shrink); a run at
                temperature 0.8 (tokens in the vocabulary); exact launch
                counts of the prefills and the eager warm-up iterations, at
                most one capture for the dense pool and one per block-table
                width for the paged store, every iteration past a capture's
                eager warm-up a replay; after each run one more epoch of
                its graph traced by torch.profiler a replay a session,
                each replay's port kernels counted by name equal to the
                capture delta (a trace short of it, as a lossy trace
                is, retaken at most twice); no host sync in a dense
                run's deferred prefills (``set_sync_debug_mode``); page
                conservation, finite logits (its lines are emitted after
                phase 10);
 12. chunked  — chunked (resumable) prefill, run while phase 6's bf16
                weights (and for its witness phase 7's fp32 copy, and
                phase 8's int4 weights) are resident, its line emitted
                after phase 11's: (a) flash attention at one chunk's
                geometry (C 128 at t0 0, 128 and 384 over a 640-row
                staging cache with kv_len t0 + 128, and a final chunk of 71
                real columns at t0 512, bf16 on the tensor-core tile; C 8,
                (d)'s chunk, at t0 0, 8 and 536 over a 544-row staging
                cache, and a final chunk of 3 real columns at t0 528, bf16
                on the split-KV walk), and each in fp32 on the SIMT kernel,
                against the plain version with
                phase 3's tolerances, launched twice bit for bit, the final
                chunk's real rows bit for bit a call without its pads,
                timed beside SDPA with a boolean mask of the same keys; the
                dense fused linear and the router at M = T = 128 against
                their plain versions; (b) the fp32 witness: phase 7's 4
                requests at chunk 128 against phase 7's chunk-0 runs, dense
                and fp32 pages: tokens bit for bit, each request's gate
                logs and the KV accounting identical; (c) phase 6's 8
                requests at chunk 128: the dense pool, bf16, int8 and int4
                pages, fused 8-step epochs (dense and paged bf16) under
                step_tokens 160 (no chunk deferred) and 136 (chunks
                deferred), and phase 8's int4 weights on the dense pool:
                exact launch counts, per chunk 1 router pass, 4·L fused
                linears on the tile (int4: the s8 tile), 32 flash tiles and
                nothing on the decode routes, prefill_chunks = Σ⌈T0/128⌉,
                chunks interleaved with resident decode steps, pages
                conserved, finite logits, peak memory; the share of tokens
                equal to the chunk-0 runs reported, not checked; (d) phase
                6's 4 short requests in its tight pool at chunk 8: every
                request finishes and every page comes back, aborts and
                preemptions reported (the engine's ``prefill_aborts`` and
                ``preemptions``); (e) a chunked mamba2-2.7b engine
                raises ``ConfigError`` (checked in phase 10).
 13. prefix   — the prefix cache on phase 6's bf16 weights (and for its
                witness phase 7's fp32 copy), its line emitted after phase
                12's: one request with a 1024-token shared system prompt
                and its own 32-128-token tail publishes, then 8 more run
                on the same engine (7 fresh tails, the 8th the first
                prompt again: a suffix of at most 16 tokens), 4 slots,
                max_len 1280, pages and blocks of 16; single-step
                monolithic in bf16, int8 and int4 pages, fused 8-step
                epochs and chunk 128 in bf16 pages, each beside the same
                runs with the cache off: hits and saved tokens as worked
                out on the host, a copy on write taken, exact launch counts
                (a warm suffix of ≤ 16 rows on the split-K stream and the
                split-KV walk, wider ones on the tiles, no SIMT launch in
                bf16), pages conserved with the records' pins after every
                run, pages_peak lower with the cache; a tight pool where
                records are evicted and no resident is preempted while an
                unpinned record is left; the fp32 witness (4 requests over
                a 256-token prefix, monolithic and chunk 128): warm ≡ cold
                tokens, gate logs and KV accounting bit for bit; warm and
                cold prefill_s, times to first token and the share of
                bf16 tokens equal to cold reported, not checked.
 14. speculative — self-speculative decoding (``spec_k`` 4) on phase 6's
                bf16 weights (and for its witness phase 7's fp32 copy, and
                phase 8's int4 weights), its line emitted after phase 13's:
                (a) phase 6's 8 requests, 4 slots, 32 greedy tokens, draft
                keep unset, on the dense pool and on bf16, int8 and int4
                pages, and on the dense pool with int4 weights; (b) a
                draft_keep 0.5 run on the dense pool; (c) the fp32 witness
                (phase 7's 4 requests, dense and fp32 pages, spec_k 1 and
                4): tokens, each request's gate logs and the KV accounting
                bit for bit the plain engine's, rolled-back entries in a
                paged run.  Checked in every run: windows ran, accepted ≤
                drafted, drafted = Σ γ × active slots, each verify
                window's launches exactly those of a chunk forward of
                slots·(γ + 1) rows at the routes ``plan`` gives them (every
                column unembedded: int4, the lm head's rows through the
                int4 matmul), the draft graphs bounded like phase 11's
                (one for the dense pool, one per block-table width), every
                draft iteration past a capture's warm-up a replay, the
                capture deltas × replays (derived) equal to the replayed
                iterations' launches, no bf16 SIMT launch, finite draft and
                verify logits, pages conserved with none in use; reported:
                acceptance, window ms, tok/s beside phase 6's (8's) plain
                run and the share of tokens equal to it.
 15. lifecycle — observability and the request lifecycle on phase 6's bf16
                weights (and for (d) phase 7's fp32 copy), its line
                emitted after phase 14's: (a) phase 6's 8 requests with
                tracing off, on, on, off (on: a ``Tracer`` saving to a
                temporary file), on the dense pool single-step and on bf16
                pages in fused 8-step epochs: tokens, per-route launch counts,
                captures and replays bit for bit equal, every registry
                counter equal to its ``ServeStats`` field, the trace
                balanced on every track (``tools/trace_summary.py``) with
                no span open; tok/s on beside off, the trace's share of a
                step in plan / prefill / dispatch / sync / bookkeep and
                ``profile_decode.py``'s idle share of the loop (PERF.md
                §5) reported; (b) two handles' ``tokens()`` consumed in
                turn, then ``run()``: the plain run's tokens; (c) bf16
                pages, fused epochs, prefix cache, chunk 32, phase 13's
                traffic: a resident cancelled after its 4th streamed
                token, a request with ``deadline_s`` 0, a warm admission
                whose deadline fires in flight, a 9th submission shed at
                ``max_queue_depth`` 8; ``max_preemptions`` 0 in phase 6's
                tight pool (partial tokens a prefix of phase 6's, the
                others phase 6's); finish reasons, partial tokens, every
                page free but the records' and no record pinned after
                each run; (d) fp32, dense and fp32 pages: one of the
                witness's 4 requests cancelled after its 2nd streamed
                token, the other 3 bit for bit the witness's tokens.
                Phase 4 also holds the cpu and cuda paged engines'
                registries (count-valued metrics) and a streamed
                request's tokens equal.
 16. faults   — faults, the watchdog and crash-consistent snapshots on
                phase 6's bf16 weights (and for (e) phase 7's fp32 copy),
                its line emitted after phase 15's: (a) 4 of phase 6's
                requests, +16 tokens, in all six run loops (dense and
                paged, single-step, fused 8-step epochs, spec_k 4): clean,
                2 dispatch errors, a 0.05 s stall under a Watchdog without
                a hard timeout and, paged, an OOM hiding every free page:
                every fault fired, each robustness counter equal to its
                ServeStats field and its trace instants, slots and pages
                back, tokens bit for bit the clean run's (OOM: the share
                reported), a single-step run's launches the clean run's
                on each route but for whole decode steps, each counted
                exactly; the paged spec loop's bf16 retries come after
                its last admission, and one more run with two retries
                amid them is reported (equal share; the first differing
                token's windows, routes and flash split), not held ((e)
                holds it in fp32); (b) each loop killed at a boundary
                after its snapshot, a fresh engine ``resume()``s it:
                tokens bit for
                bit the clean run's, one resume, nothing leaked; fused
                dense at temperature 0.8 killed and resumed: the
                uninterrupted run's tokens (the generator restored);
                snapshot bytes and seconds, resume seconds; (c) the
                launcher as three processes (paged bf16, fused epochs):
                clean and killed (exit code 3), both started beside (a)
                and (b), then resumed: the clean process's results;
                (d) a 0.5 s stall against the watchdog's 0.25 s timeout
                raises HungDispatch with the flushed trace's path; (e)
                fp32 pages: an OOM single-step and in fused epochs, each
                preempting, two retries amid a spec_k 4 run's admissions,
                and a fused run killed and resumed: tokens, gate logs and
                KV accounting bit for bit the clean run's.
 17. gather   — gather-mode routing and qwen3-8b, its line emitted after
                phase 16's: (a) flash over the C gathered rows of a seeded
                score (sorted, with gaps) over all T keys, B 4, T 512 (C
                384) and 453 (C 344), bf16 on the tile and fp32 on the
                SIMT kernel, timed beside SDPA with a boolean mask and
                masked flash over all T rows; the four llama linears at M
                1536 beside ``torch.matmul``; qwen3-8b's flash (tile and
                split-KV walk) and paged split walk at G 4 (phase 3's
                checks); (b) CPU ≡ CUDA in gather mode on llama2-7b smoke
                and qwen3-8b smoke with 2 kv heads, fp32: selected
                indices, gate logs, logits, lock-step and dense-pool
                tokens, exact launches (a C-th / (C+1)-th score pair
                closer than GATHER_MARGIN reported, not failed); (c) phase
                6's bf16 weights in gather mode: lock-step 4 × 512 + 32,
                the dense pool single-step and in fused 8-step epochs (the
                same tokens), phase 8's int4 weights lock-step and dense,
                exact launches per route (a prefill's first wqkv at B·T
                rows, the other 4·L − 1 linears at B·C, flash at G·C rows),
                masked and gather prefills timed in turns, the paged,
                chunked, bucketed and speculative refusals; (d) in
                ``witness()``, fp32 at phase 5's depth, keep 1.0 and every
                gate 1: gather ≡ masked (gates, tokens, logits ≤ 1e-4·max);
                (e) after the llama weights are freed, qwen3-8b at full
                width in bf16 (seed-0 weights, neutral router bias):
                lock-step, the dense pool single-step and fused, bf16
                pages, and (c)'s gather runs; exact launches, G 4 routes,
                pages conserved.
 18. gemma3   — gemma3-12b (5 sliding-window LOCAL layers to a global one,
                window 1024, head dim 256, GeGLU, qk-norm, tied
                embeddings), its line emitted after phase 17's, run after
                the qwen3 weights are freed: (a) the GELU epilogue on
                every fused-linear route at gemma3's widths (its four
                linears and gu's up half without the GLU, dense bf16 at M
                2048 on the tile and M 4 on the split-K stream, gu fp32 on
                the SIMT kernel, int4 codes on the s8 tile and the code
                stream in bf16 and fp32 activations) and flash attention
                at dh 256 (prefill 2 × 1536 at window 0 and 1024 on the
                tile, decode of 4 slots over a LOCAL ring of 1024 keys
                with ragged t, two below W, and over a 1600-row global
                cache on the split-KV walk, each in fp32 on the SIMT
                kernel), phase 3's checks, timed beside the plain version
                and ``torch.matmul`` or SDPA; (b) full width in bf16
                (seed-0 weights, neutral router bias, ~23.5 GB):
                lock-step 2 × 1536 + 32 (rings from the prompt), the dense
                pool single-step and in fused 8-step epochs (prompts of
                1000, 1020, 1536 and 300 tokens + 64: decode crosses the
                slot wrap at t = 1024; the same tokens in both loops), the
                weights quantized on the card lock-step 2 × 1536 + 8
                (GeGLU on the s8 tile and the code stream); exact launches
                per route, finite logits, prefill_s, tok/s, peak memory;
                (c) the fp32 witness at full widths cut to 6 layers (W
                1024): CPU ≡ CUDA over a 1100-token prompt and 4 forced
                steps (logits ≤ 1e-4·max, argmax) and the dense pool on
                prompts of 1020 and 1060 tokens + 8 (tokens, exactly), the
                cuda runs taking the cpu runs' router decisions after
                each of their own was held to it (a difference allowed
                only where that decision's cpu margin is below
                GATHER_MARGIN, and counted); (d) the paged, chunked,
                bucketed, speculative and prefix-cache engines refuse it
                with the reference's errors.
 19. stablelm_deepseek — stablelm-3b (LayerNorm: every routed block on
                the reference's unfused path, the plain router product,
                (μ, σ²) and ``x @ w`` or the int4 matmul; head dim 80;
                partial rotary 0.25) and deepseek-coder-33b (56 query heads
                over 8 kv heads: G 7; d 7168, d_ff 19200, ~66.7 GB of
                bf16), its line emitted after phase 18's, run after the
                gemma3 weights are freed: (a) flash at dh 80 (prefill 4 ×
                512 on the tile, decode over 544 keys on the split-KV walk,
                fp32 on the SIMT kernel, a chunk's geometry), paged at dh 80
                in bf16, int8 and int4 pages (kv-heads in groups of 4: the
                odd ones' int4 rows 8-byte aligned), flash and paged at
                G 7, ragged dh 80 and G 7 cases (``FLASH_RAGGED_19``,
                ``PAGED_RAGGED_19``), the int4 matmul (tile M 2048, stream
                M 4) at stablelm's four linears beside bf16
                ``torch.matmul``, the fused linear's four routes at
                deepseek's four linears, phase 3's checks; (b) stablelm at
                full width in bf16, STABLE_LAYERS of its 32 layers:
                lock-step 4 × 512 + 32, phase 6's
                traffic in the dense pool single-step and fused, bf16
                pages single-step and fused, int8 and int4 pages, chunk
                128, spec_k 4, phase 13's traffic with the prefix cache on
                and off, gather lock-step, int4 weights lock-step and
                fused: exact launches per route, finite logits, pages
                conserved, prefill_s, tok/s, peak memory; (c) the fp32
                witness at full widths cut to 4 layers: CPU ≡ CUDA over a
                300-token prompt and 4 forced steps, and the dense and
                paged pools' tokens, with ``GateReplay``; (d)
                deepseek-coder-33b at full width, bf16 lock-step and the
                dense pool single-step and fused, then the int4 tree built
                layer by layer as drawn lock-step and fused: exact launches
                per route, peak memory under the card's.
 20. moe      — grok-1-314b (8 experts top 2, GeGLU; 48 query heads over 8
                kv heads: G 6; d 6144, d_ff 32768, vocab 131072) and
                arctic-480b (128 experts top 2, SwiGLU, a dense residual
                MLP of d_ff 4864; G 7; d 7168), one model at a time after
                phase 19's weights are freed, full widths at a cut depth
                (neither fits the card whole): (a) flash at G 6 (prefill 4
                × 512 on the tile, decode over 544 keys on the split-KV
                walk, fp32 on the SIMT kernel, beside SDPA's GQA mode),
                paged attention at G 6 in bf16, int8 and int4 pages, the
                ragged G 6 / G 7 cases (``FLASH_RAGGED_20``,
                ``PAGED_RAGGED_20``), the fused linear's routes at grok's
                wqkv and wo, the int4 matmul at grok's head (M 4) and at
                arctic's residual MLP (M 2048, M 4), phase 3's checks;
                (b) grok at 4 layers (~42.6 GB bf16): lock-step 4 × 512 +
                32, phase 6's traffic shape in the dense pool single-step
                and fused (the same tokens), bf16 pages fused, then the
                int4 tree built layer by layer as drawn (the experts and
                their router stay bf16) lock-step and fused; (c) arctic at
                2 layers (~55.4 GB): lock-step, the dense pool fused, int8
                pages fused (G 7 on the paged split walk), int4 lock-step
                (its residual MLP on the int4 tile and stream); every run
                with exact launches per route (a router pass per attention
                block, two fused linears a layer), finite logits, pages
                conserved, each MoE call's ``moe_drop_frac`` beside the
                host's count from its choices (``MoeWatch``), prefill_s,
                tok/s, peak memory under the card's; (d) the fp32 CPU ≡
                CUDA witness at full widths, grok at 2 layers and arctic
                at 1 (its expert count cut only where the host's
                MemAvailable cannot hold it, and recorded): 2 × 64 tokens
                and 4 forced steps, the dense pool on prompts of 40 and 64
                + 8, ``GateReplay`` over the router decisions and the
                expert choices, logits ≤ 1e-4·max, argmax, tokens.
Then the ``kernels`` summary line (``launches`` summed over the main-path
runs of phases 5, 6, 8, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19 and 20 (their
fp32 witness runs included; not phase 16's subprocesses),
each counted from 0 by the wrappers, which a graph replay does not pass
through: phase 11's, 12's and 14's replayed launches stand in their own lines,
derived, and in no sum; for the paged SIMT route, which only fp32 serving
takes, over phase 7's and phase 12's fp32 paged runs, and for the SSD
scan's SIMT route over phase 9's fp32 cuda runs, all counted from 0 too;
the dense fused linear
as its two bf16 kernels, ``fused_linear_wgmma`` and ``fused_linear_splitk``,
the int4 fused linear as ``fused_linear_int4_tc`` and
``fused_linear_int4_stream``, the int4 matmul as ``int4_matmul_tc`` (on
stablelm-3b's int4 prefills since phase 19) and ``int4_matmul_stream``,
and flash attention as
``flash_attention_wgmma`` and ``flash_attention_splitkv``, and paged
attention as ``paged_attention_split`` and ``paged_attention_simt``, and
the SSD scan as ``ssd_scan_tc`` and ``ssd_scan_simt``, by the route
counters; the times summed over phase 3's shapes and phase 18's, 19's
and 20's shapes of the same routes), and last the contract
line ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
LOG_DIR = os.path.join(ROOT, "build")          # listed in .gitignore

# Published H100 SXM peaks (NVIDIA data sheet): device memory rate and the
# dense bf16 and int8 tensor-core rates.  bound_ms = max(bytes / rate,
# ops / rate); the int4 kernels' products are int8 operations.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12     # float32 outside the tensor cores (the SIMT routes)

# Tolerances (kernel vs plain version on the same inputs).
TOL_F32 = 1e-4        # x max|ref|: fp32 sums in another order over K ≤ 11008
TOL_BF16 = 2.0 ** -7  # x max|ref|: two bf16 ulps at the maximum
TOL_SQ = 1e-5         # relative, Σy² and mean_sq (fp32 outputs)
TOL_SQ_EXACT = 2.0 ** -8  # relative, the tile's Σy² against the exact plain
#                       version: its operand is bf16(x · gamma), rounded once
#                       (9x the worst measured, 4.5e-4)
TOL_LOGITS = 1e-4     # x max|logits|, phase 4 (fp32 model)
TOL_BFP = 0.05        # x max|oracle|: int4 kernels against the exact
#                       dequant (8-bit activation mantissas per group)
TOL_FLASH_MIRROR = 2.0 ** -9  # x max|mirror|, past one bf16 ulp of each
#                       element: flash's bf16 routes against the mirror that
#                       rounds P as they do (the ulp is the output's own
#                       rounding; the rest covers P values that the fp32
#                       sum order moves across a bf16 rounding boundary)
TOL_GELU = 2.0 ** -20   # x |y|: the kernels' GELU (tanhf, FMA-contracted
#                       cube) against ref.act's at each pre-activation y:
#                       8 fp32 eps, for tanhf's 2 ulps and the cube's and
#                       product's roundings (the CPU's tanh against JAX's:
#                       1.5 eps, tests/test_torch_gelu.py)
TOL_SPLIT = 2.0 ** -19  # x max|mirror|: the SSD scan's tensor-core route
#                       against ref.ssd_scan_split on inputs whose cumsums
#                       are exact in any order (ssd_exact_inputs); the
#                       mirror without the split's lo term is off by ~2^-18
LOG2E = 1.4426950408889634
MIN_MARGIN = 1e-3     # phase 4: no router decision this close to its tie
PARITY_SEED = 6   # its margins clear MIN_MARGIN (checked every run)
MAMBA_SEEDS = 8   # phase 9 takes the first seed whose cpu margins clear
#                   MIN_MARGIN (the draws depend on the torch version)
TOL_KEEP = 1e-6   # keep-fraction sums, cpu against cuda (phase 9)

TPU_KERNELS = {
    "router_stats": "src/repro/kernels/fused_router_rmsnorm.py:55",
    "int4_matmul_tc": "src/repro/kernels/int4_matmul.py:66",
    "fused_linear_wgmma": "src/repro/kernels/fused_linear.py:135",
    "fused_linear_splitk": "src/repro/kernels/fused_linear.py:135",
    "fused_linear_int4_tc": "src/repro/kernels/fused_linear.py:93",
    "fused_linear_int4_stream": "src/repro/kernels/fused_linear.py:93",
    "int4_matmul_stream": "src/repro/kernels/int4_matmul.py:66",
    "flash_attention_wgmma": "src/repro/kernels/flash_attention.py:74",
    "flash_attention_splitkv": "src/repro/kernels/flash_attention.py:74",
    "paged_attention_split": "src/repro/kernels/paged_attention.py:99",
    "paged_attention_simt": "src/repro/kernels/paged_attention.py:99",
    "ssd_scan_tc": "src/repro/kernels/ssd_scan.py:67",
    "ssd_scan_simt": "src/repro/kernels/ssd_scan.py:67",
}
SOURCES = {
    "router_stats": "src/repro_torch/kernels/csrc/router_stats.cu",
    "int4_matmul_tc": "src/repro_torch/kernels/csrc/fused_linear_int4.cu",
    "fused_linear_wgmma": "src/repro_torch/kernels/csrc/fused_linear.cu",
    "fused_linear_splitk": "src/repro_torch/kernels/csrc/fused_linear.cu",
    "fused_linear_int4_tc":
        "src/repro_torch/kernels/csrc/fused_linear_int4.cu",
    "fused_linear_int4_stream":
        "src/repro_torch/kernels/csrc/fused_linear_int4.cu",
    "int4_matmul_stream": "src/repro_torch/kernels/csrc/fused_linear_int4.cu",
    "flash_attention_wgmma":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_splitkv":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "paged_attention_split":
        "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_attention_simt":
        "src/repro_torch/kernels/csrc/paged_attention.cu",
    "ssd_scan_tc": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "ssd_scan_simt": "src/repro_torch/kernels/csrc/ssd_scan.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def bound_ms(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Timer:
    """Median CUDA-event time of one call on the device, on a clean L2.

    Before each run the Timer reads a buffer twice the L2's size, filled
    once at construction: whatever the previous run left dirty in L2 is
    written back during that read, before the start event, so a kernel
    that streams its inputs pays for its own bytes only (a flush that
    writes would leave its dirty lines for the timed kernel to evict).
    A ~2 ms device
    sleep precedes the start event, so the host has enqueued the call
    before the card reaches it and the events time device work, not
    Python and ctypes launch overhead."""

    SLEEP_CYCLES = 4_000_000
    FLUSH_BYTES = 100 << 20        # twice the H100's 50 MB L2

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush = torch.ones(self.FLUSH_BYTES // 4, device=dev)

    def __call__(self, fn, iters: int = 7, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.sum()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(self.SLEEP_CYCLES)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def launch_floor_ms(torch, timer) -> float:
    """An empty kernel (``torch.cuda._sleep(0)``) under ``timer``: the
    least time any launch shows on this yardstick."""
    return timer(lambda: torch.cuda._sleep(0))


def max_err(torch, out, ref):
    d = (out.float() - ref.float()).abs().max().item()
    return d, ref.float().abs().max().item()


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions at the main-path shapes
# ---------------------------------------------------------------------------

ROUTER_T = (2048, 453, 4)   # lock-step prefill B·T0 = 4·512; the longest
#                             continuous prefill; decode B = 4
ROUTER_ALONE = 16           # router_call reruns a call's first rows alone


def router_call(torch, x, w, what):
    """One router pass on the plan ``plan`` makes against the plain
    version: logits within TOL_F32·max|ref|, mean_sq within TOL_SQ
    (relative), one launch counted, a second launch bit for bit the same,
    and above 16 rows its first 16 rows bit for bit the same as a call on
    those rows alone (a block a row): a row's results do not depend on
    the rows a block or on the other rows.  Returns the error record."""
    from repro_torch.kernels import fused_router_rmsnorm as frr, ref
    T, D = x.shape
    p = frr.plan(T, D, x.dtype, x.data_ptr())
    before = frr.launches
    lo, ms = frr.router_stats_cuda(x, w)
    require(frr.launches == before + 1,
            f"{what}: {frr.launches - before} launches counted, want 1")
    lo2, ms2 = frr.router_stats_cuda(x, w)
    lr, mr = ref.router_stats_ref(x, w)
    torch.cuda.synchronize()
    e, m = max_err(torch, lo, lr)
    require(e <= TOL_F32 * m, f"{what}: logits {e} > {TOL_F32}·{m}")
    sq_rel = ((ms - mr).abs() / mr.abs()).max().item() if T else 0.0
    require(sq_rel <= TOL_SQ, f"{what}: mean_sq rel err {sq_rel}")
    require(torch.equal(lo, lo2) and torch.equal(ms, ms2),
            f"{what}: a second launch differs")
    rec = {"rows": p.rows, "vec": p.vec, "max_abs_err": e, "max_ref": m,
           "mean_sq_rel_err": sq_rel, "repeat_bit_identical": True}
    if T > ROUTER_ALONE:
        lo3, ms3 = frr.router_stats_cuda(x[:ROUTER_ALONE], w)
        torch.cuda.synchronize()
        require(torch.equal(lo[:ROUTER_ALONE], lo3)
                and torch.equal(ms[:ROUTER_ALONE], ms3),
                f"{what}: the first {ROUTER_ALONE} rows differ alone")
        rec["rows_alone_bit_identical"] = True
    return rec


def check_router(torch, dev, timer, cfgs, floor):
    """The router at every main-path shape: D of each config (llama2-7b
    4096, mamba2-2.7b 2560; in phase 20 grok-1-314b 6144, arctic-480b
    7168) at T 2048, 453 and 4, bf16 and fp32, each
    checked by ``router_call``.  The bf16 kernel is timed beside the plain
    version and beside the two-call torch composite (``x.float() @ w`` and
    ``x.float().square().mean(-1)``: two calls, not one, so not
    ``library_ms``); each record carries the bound and ``floor``, the
    empty kernel's time on the same Timer.  Returns the shape records."""
    from repro_torch.kernels import fused_router_rmsnorm as frr, ref
    g = torch.Generator(device=dev).manual_seed(11)
    shapes = []
    for cfg in cfgs:
        D = cfg.d_model
        w = torch.randn((D, 2), generator=g, device=dev) * 0.02
        for T in ROUTER_T:
            x = torch.randn((T, D), generator=g, device=dev).to(
                torch.bfloat16)
            rel = {}
            for dt in (torch.bfloat16, torch.float32):
                rel[str(dt).split(".")[-1]] = router_call(
                    torch, x.to(dt), w, f"router {cfg.name} T={T} {dt}")
            p = frr.plan(T, D, x.dtype, x.data_ptr())
            ms_k = timer(lambda: frr.router_stats_cuda(x, w))
            b, by = bound_ms(T * D * 2 + D * 2 * 4 + T * 3 * 4, 6.0 * T * D)
            shapes.append({
                "shape": f"x[{T},{D}] bf16 ({cfg.name})", "ms": ms_k,
                "plain_ms": timer(lambda: ref.router_stats_ref(x, w)),
                "library_ms": None,
                "torch_two_calls_ms": timer(
                    lambda: (x.float() @ w, x.float().square().mean(-1))),
                "torch_two_calls_note": "two calls, not one",
                "bound_ms": b, "bound_by": by,
                "launch_floor_ms": floor, "plan": dataclasses.asdict(p),
                "errors": rel})
    return shapes


def linear_shapes(cfg):
    """The four linears of a block: name, K, N, glu, norm prologue,
    gate/residual/Σy² epilogue."""
    D, ai, ki, Fd = (cfg.d_model, cfg.attn_inner_dim, cfg.kv_inner_dim,
                     cfg.d_ff)
    return [("wqkv", D, ai + 2 * ki, False, True, False),
            ("wo", ai, D, False, False, True),
            ("gu", D, 2 * Fd, True, True, False),
            ("down", Fd, D, False, False, True)]


def int4_weight(torch, dev, g, K, N, G, pow2=True):
    """A bf16 weight [K, N] (std 1/sqrt(K)) quantized on the card by the
    port's ``quantize_rtn``: (codes, scale, the exact dequantized fp32
    weight [K, N], the bf16 weight)."""
    from repro_torch.quant import dequantize, quantize_rtn
    w = (torch.randn((K, N), generator=g, device=dev)
         / math.sqrt(K)).to(torch.bfloat16)
    codes, scale = quantize_rtn(w, G, pow2)
    return codes, scale, dequantize(codes, scale, K), w


def linear_inputs(torch, dev, g, M, K, F, glu, pro, epi, act=None):
    """bf16 activation and the optional prologue/epilogue tensors of one
    fused-linear call (mean_sq and gate_mul in fp32); ``act`` the
    epilogue's activation (default: silu with the GLU, none without)."""
    bf = torch.bfloat16
    x = torch.randn((M, K), generator=g, device=dev).to(bf)
    kw = {"glu": glu, "act": act if act is not None
          else ("silu" if glu else None)}
    if pro:
        kw["mean_sq"] = (x.float() ** 2).mean(-1)
        kw["gamma"] = (1 + 0.1 * torch.randn((K,), generator=g,
                                             device=dev)).to(bf)
    if epi:
        kw["residual"] = torch.randn((M, F), generator=g, device=dev).to(bf)
        kw["gate_mul"] = (torch.rand((M,), generator=g, device=dev)
                          > 0.5).float()
        kw["emit_sq"] = True
    return x, kw


def _cast(torch, kw, dt):
    """kw with its bf16 tensors cast to dt, and the ref's keyword names."""
    cast = {k: (v.to(dt) if isinstance(v, torch.Tensor)
                and v.dtype == torch.bfloat16 else v) for k, v in kw.items()}
    return cast, {("act_name" if k == "act" else k): v
                  for k, v in cast.items()}


def fused_linear_mirror(torch, x, w, **rkw):
    """The plain version on the operand the tensor-core tile feeds its
    wgmma: with the norm prologue, bf16(x · gamma) (one rounding of a
    bf16 product, as the kernel rounds it), the per-row 1/sqrt(mean_sq +
    eps) still applied in fp32 (gamma 1 below); without it, x itself."""
    from repro_torch.kernels import ref
    gamma = rkw.get("gamma")
    if gamma is not None:
        x = (x.float() * gamma.float()).to(torch.bfloat16)
        rkw = dict(rkw, gamma=torch.ones_like(gamma))
    return ref.fused_linear_ref(x, w, **rkw)


def fused_linear_call(torch, x, w, kw, what):
    """One dense fused-linear call on its route against the plain version:
    out within tol·max|ref| (TOL_BF16 in bf16, TOL_F32 in fp32); Σy² within
    TOL_SQ (relative) of the plain version on the operand the route feeds
    (the tile's bf16(x · gamma); exact on the split-K stream and the SIMT
    kernel) and within TOL_SQ_EXACT of the exact plain version; the
    route ``plan`` picks and only its counter moved; in bf16 a second
    launch on the same inputs bit for bit.  Returns the error record."""
    from repro_torch.kernels import fused_linear as fl, ops, ref
    M, K = x.shape
    F = w.shape[1] // 2 if kw["glu"] else w.shape[1]
    tol = TOL_BF16 if x.dtype == torch.bfloat16 else TOL_F32
    route = fl.plan(M, K, F, kw["glu"], x.dtype).route
    rkw = {("act_name" if k == "act" else k): v for k, v in kw.items()}
    before = ops.kernel_launches()
    out, sq = fl.fused_linear_cuda(x, w, **kw)
    after = ops.kernel_launches()
    moved = {r for r in ("wgmma", "splitk", "simt")
             if after[f"fused_linear_{r}"] != before[f"fused_linear_{r}"]}
    require(moved == {route} and after[f"fused_linear_{route}"]
            == before[f"fused_linear_{route}"] + 1,
            f"{what}: routes {moved}, want {route}")
    ro, rsq = ref.fused_linear_ref(x, w, **rkw)
    torch.cuda.synchronize()
    e, m = max_err(torch, out, ro)
    require(e <= tol * m, f"{what}: {e} > {tol}·{m}")
    rec = {"route": route, "max_abs_err": e, "max_ref": m}
    if sq is not None:
        msq = fused_linear_mirror(torch, x, w, **rkw)[1] \
            if route == "wgmma" else rsq
        sr = ((sq - msq).abs() / msq.abs()).max().item()
        require(sr <= TOL_SQ, f"{what}: Σy² rel err {sr} > {TOL_SQ}")
        rec["sq_rel_err"] = sr
        se = ((sq - rsq).abs() / rsq.abs()).max().item()
        require(se <= TOL_SQ_EXACT, f"{what}: Σy² rel err {se} against the "
                f"exact plain version > {TOL_SQ_EXACT}")
        rec["sq_rel_err_exact"] = se
    if x.dtype == torch.bfloat16:
        out2, sq2 = fl.fused_linear_cuda(x, w, **kw)
        require(torch.equal(out, out2) and (sq is None or torch.equal(
            sq, sq2)), f"{what}: a second launch differs")
        rec["repeat_bit_identical"] = True
    return rec


def check_fused_linear(torch, dev, timer, cfg, names=None):
    """The dense fused linear at the four linears of a llama2-7b block (or
    those of ``names``): bf16
    at M 2048 on the tensor-core tile and at M 4 on the split-K stream,
    each timed beside its plain version and ``torch.matmul``; the same
    inputs in fp32 on the SIMT kernel (the parity route), checked and
    timed too.  Returns the shape records by bf16 route."""
    from repro_torch.kernels import fused_linear as fl, ref
    g = torch.Generator(device=dev).manual_seed(12)
    shapes = {"wgmma": [], "splitk": []}
    for M in (2048, 4):
        for name, K, N, glu, pro, epi in linear_shapes(cfg):
            if names is not None and name not in names:
                continue
            F = N // 2 if glu else N
            w = (torch.randn((K, N), generator=g, device=dev)
                 / math.sqrt(K)).to(torch.bfloat16)
            x, kw = linear_inputs(torch, dev, g, M, K, F, glu, pro, epi)
            what = f"fused_linear {name} M={M}"
            rec = fused_linear_call(torch, x, w, kw, f"{what} bf16")
            f32, _ = _cast(torch, kw, torch.float32)
            xf, wf = x.float(), w.float()
            simt = fused_linear_call(torch, xf, wf, f32, f"{what} fp32")
            ms_s = timer(lambda: fl.fused_linear_cuda(xf, wf, **f32))
            del xf, wf
            _, rkw = _cast(torch, kw, torch.bfloat16)
            ms_k = timer(lambda: fl.fused_linear_cuda(x, w, **kw))
            ms_p = timer(lambda: ref.fused_linear_ref(x, w, **rkw))
            ms_l = timer(lambda: torch.matmul(x, w))
            nbytes = (M * K + K * N + M * F) * 2 + (
                (K * 2 + M * 4) if pro else 0) + (
                (M * F * 2 + M * 8) if epi else 0)
            b, by = bound_ms(nbytes, 2.0 * M * K * N)
            # the fp32 inputs: 4-byte elements, fp32 operations
            b32, by32 = bound_ms((M * K + K * N + M * F) * 4 + (
                (K * 4 + M * 4) if pro else 0) + (
                (M * F * 4 + M * 8) if epi else 0), 2.0 * M * K * N,
                FP32_OPS_PER_S)
            shapes[rec["route"]].append({
                "shape": f"{name} M={M} K={K} N={N}", "route": rec["route"],
                "ms": ms_k, "plain_ms": ms_p, "library_ms": ms_l,
                "bound_ms": b, "bound_by": by,
                "tol": f"bf16 {TOL_BF16}·max|ref|; Σy² {TOL_SQ} rel against "
                       "the plain version on the operand the route feeds "
                       "(the tile: bf16(x·gamma), rsqrt after the product)",
                "errors": {"bfloat16": rec}, "simt_f32_ms": ms_s,
                "simt_f32_bound_ms": b32, "simt_f32_bound_by": by32,
                "simt_f32_errors": dict(simt, tol=f"{TOL_F32}·max|ref|")})
            del x, w, kw
    return shapes


def int4_ulp(torch, x):
    """One ulp of x's dtype (bf16 or fp32) at each |x|; 0 at 0."""
    bits = 7 if x.dtype == torch.bfloat16 else 23
    e = torch.frexp(x.float().abs())[1]
    return torch.where(x == 0, torch.zeros_like(x.float()),
                       torch.ldexp(torch.ones_like(x.float()), e - 1 - bits))


def int4_mirror_check(torch, out, ro, x, codes, scale, rkw, split, what):
    """The int4 kernels against the plain version summed in the route's
    order of the fp32 group terms (``split``: the stream's groups per
    split; None on the tile).  Every value before the activation is equal
    bit for bit, so without an activation the output is; with one each
    output lies within one ulp of its dtype plus the activation's
    difference (silu: the kernel's y / (1 + expf(-y)) against ``F.silu``;
    gelu: TOL_GELU·|y|), times |up| with the GLU.  Returns (bit-identical
    share, largest excess over that bound as a share of max|ref|)."""
    from repro_torch.kernels import ref
    if rkw.get("act_name") is None:
        require(torch.equal(out, ro), f"{what}: not bit for bit with the "
                "plain version in the route's order")
        return 1.0, 0.0
    xf = x.float()
    if rkw.get("mean_sq") is not None:
        xf = ref.rms_prologue(xf, rkw["mean_sq"], rkw["gamma"],
                              rkw.get("eps", 1e-5))
    y = ref.bfp_matmul_f32(xf, codes, scale, split)
    if rkw.get("glu"):
        f = y.shape[1] // 2
        yg, yu = y[:, :f], y[:, f:]
    else:
        yg, yu = y, torch.ones_like(y)
    if rkw["act_name"] == "gelu":
        act_diff = TOL_GELU * yg.abs()
    else:
        act_diff = ((yg / (1.0 + torch.exp(-yg)))
                    - ref.act(yg, "silu")).abs()
    bound = int4_ulp(torch, ro) + act_diff * yu.abs()
    d = (out.float() - ro.float()).abs()
    excess = (d - bound).max().item()
    require(excess <= 0.0, f"{what}: {excess} past one ulp plus the "
            "activation's difference")
    return ((out == ro).float().mean().item(),
            max(excess, 0.0) / ro.float().abs().max().item())


def int4_call(torch, x, codes, scale, kw, what, matmul=False):
    """One int4 fused-linear (or, with ``matmul``, int4-matmul) call on its
    route against the plain version in the route's order
    (``int4_mirror_check``); Σy² within TOL_SQ (relative); the route
    ``plan_int4`` picks and only its counter moved; a second launch on the
    same inputs bit for bit.  Returns (the error record, the plan)."""
    from repro_torch.kernels import fused_linear as fl, ops, ref
    from repro_torch.kernels import int4_matmul as im
    M, K = x.shape
    N, C = codes.shape[1], scale.shape[0]
    glu = kw.get("glu", False)
    p = fl.plan_int4(M, K, N // 2 if glu else N, codes.shape[0] // C, C,
                     glu, x.dtype)
    split = p.group_split or None
    name = "int4_matmul" if matmul else "fused_linear_int4"
    rkw = {("act_name" if k == "act" else k): v for k, v in kw.items()}

    def run():
        if matmul:
            return im.int4_matmul_cuda(x, codes, scale), None
        return fl.fused_linear_int4_cuda(x, codes, scale, **kw)

    before = ops.kernel_launches()
    out, sq = run()
    after = ops.kernel_launches()
    moved = {r for r in ("tc", "stream")
             if after[f"{name}_{r}"] != before[f"{name}_{r}"]}
    require(moved == {p.route} and after[name] == before[name] + 1
            and after[f"{name}_{p.route}"] == before[f"{name}_{p.route}"] + 1,
            f"{what}: routes {moved}, want {p.route}")
    if matmul:
        ro, rsq = ref.bfp_matmul_ref(x, codes, scale, split), None
    else:
        ro, rsq = ref.fused_linear_ref(x, w_codes=codes, scale=scale,
                                       split_groups=split, **rkw)
    torch.cuda.synchronize()
    same, excess = int4_mirror_check(torch, out, ro, x, codes, scale, rkw,
                                     split, what)
    e, m = max_err(torch, out, ro)
    rec = {"route": p.route, "max_abs_err": e, "max_ref": m,
           "bit_identical_share": same, "excess_over_ulp": excess}
    if sq is not None:
        sr = ((sq - rsq).abs() / rsq.abs()).max().item()
        require(sr <= TOL_SQ, f"{what}: Σy² rel err {sr} > {TOL_SQ}")
        rec["sq_rel_err"] = sr
    out2, sq2 = run()
    require(torch.equal(out, out2) and (sq is None or torch.equal(sq, sq2)),
            f"{what}: a second launch differs")
    rec["repeat_bit_identical"] = True
    return rec, p


INT4_TOL = ("the plain version summed in the route's order: bit for bit "
            "without an activation, else one ulp + the activation's "
            f"difference; Σy² {TOL_SQ} rel; exact dequant {TOL_BFP}·max")


def check_fused_linear_int4(torch, dev, timer, cfg, Ms=(2048, 512, 256, 4),
                            names=None):
    """The int4-BFP fused linear at the four linears of a llama2-7b block
    (or those of ``names``):
    M 2048 (lock-step prefill), 512 and 256 (the continuous buckets) on the
    tensor-core tile and M 4 (decode) on the split-K stream, in bf16 and
    fp32 activations, against the plain version in the route's order and,
    for the record, the exact-dequant oracle; timed beside the plain
    version and the bf16 dense route at the same shape.  Returns the
    shape records by route."""
    from repro_torch.kernels import fused_linear as fl, ref
    G = cfg.quant.group_size
    g = torch.Generator(device=dev).manual_seed(17)
    shapes = {"tc": [], "stream": []}
    for M in Ms:
        for name, K, N, glu, pro, epi in linear_shapes(cfg):
            if names is not None and name not in names:
                continue
            F = N // 2 if glu else N
            codes, scale, w_exact, w = int4_weight(torch, dev, g, K, N, G)
            x, kw = linear_inputs(torch, dev, g, M, K, F, glu, pro, epi)
            errs = {}
            for dt in (torch.bfloat16, torch.float32):
                cast, rcast = _cast(torch, kw, dt)
                what = f"fused_linear_int4 {name} M={M} {dt}"
                rec, p = int4_call(torch, x.to(dt), codes, scale, cast, what)
                out, _ = fl.fused_linear_int4_cuda(x.to(dt), codes, scale,
                                                   **cast)
                eo, _ = ref.fused_linear_ref(x.to(dt), w_exact.to(dt),
                                             **rcast)
                torch.cuda.synchronize()
                ee, em = max_err(torch, out, eo)
                require(ee <= TOL_BFP * em, f"{what}: {ee} from the exact "
                        f"dequant > {TOL_BFP}·{em}")
                rec.update(exact_dequant_err=ee, exact_dequant_max=em)
                errs[str(dt).split(".")[-1]] = rec
                del out, eo
            _, rkw = _cast(torch, kw, torch.bfloat16)
            split = p.group_split or None
            ms_k = timer(lambda: fl.fused_linear_int4_cuda(x, codes, scale,
                                                           **kw))
            ms_p = timer(lambda: ref.fused_linear_ref(
                x, w_codes=codes, scale=scale, split_groups=split, **rkw))
            ms_d = timer(lambda: fl.fused_linear_cuda(x, w, **kw))
            Kw, C = codes.shape[0], scale.shape[0]
            nbytes = (M * K + M * F) * 2 + Kw * N + C * N * 4 + (
                (K * 2 + M * 4) if pro else 0) + (
                (M * F * 2 + M * 8) if epi else 0)
            b, by = bound_ms(nbytes, 2.0 * M * Kw * N, INT8_OPS_PER_S)
            shapes[p.route].append({
                "shape": f"{name} M={M} K={K} N={N} G={G}", "route": p.route,
                "plan": dataclasses.asdict(p), "ms": ms_k, "plain_ms": ms_p,
                "library_ms": None, "bound_ms": b, "bound_by": by,
                "bytes": nbytes, "bf16_dense_ms": ms_d,
                "bf16_dense_route": fl.plan(M, K, F, glu,
                                            torch.bfloat16).route,
                "tol": INT4_TOL, "errors": errs})
            del x, kw, codes, scale, w_exact, w
    return shapes


def check_int4_matmul(torch, dev, timer, cfg, Ms=(4, 2048)):
    """The int4 matmul at the lm head (K 4096, N 32000): M 4 (the main
    path's batch) on the split-K stream and, for the record, M 2048 on the
    tensor-core tile (``Ms``), in bf16 and fp32 activations, against the
    plain
    version in the route's order and the exact-dequant oracle; timed
    beside the plain version and the bf16 dense route at the same shape.
    Returns the shape records by route."""
    from repro_torch.kernels import fused_linear as fl, int4_matmul as im
    from repro_torch.kernels import ref
    K, N, G = cfg.d_model, cfg.vocab_size, cfg.quant.group_size
    g = torch.Generator(device=dev).manual_seed(18)
    codes, scale, w_exact, w = int4_weight(torch, dev, g, K, N, G)
    shapes = {"tc": [], "stream": []}
    for M in Ms:
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        errs = {}
        for dt in (torch.bfloat16, torch.float32):
            what = f"int4_matmul M={M} {dt}"
            rec, p = int4_call(torch, x.to(dt), codes, scale, {}, what,
                               matmul=True)
            out = im.int4_matmul_cuda(x.to(dt), codes, scale)
            eo = ref.int4_matmul_ref(x.to(dt), codes, scale)
            torch.cuda.synchronize()
            ee, em = max_err(torch, out, eo)
            require(ee <= TOL_BFP * em, f"{what}: {ee} from the exact "
                    f"dequant > {TOL_BFP}·{em}")
            rec.update(exact_dequant_err=ee, exact_dequant_max=em)
            errs[str(dt).split(".")[-1]] = rec
            del out, eo
        split = p.group_split or None
        ms_k = timer(lambda: im.int4_matmul_cuda(x, codes, scale))
        ms_p = timer(lambda: ref.bfp_matmul_ref(x, codes, scale, split))
        ms_d = timer(lambda: fl.fused_linear_cuda(x, w))
        Kw, C = codes.shape[0], scale.shape[0]
        nbytes = (M * K + M * N) * 2 + Kw * N + C * N * 4
        b, by = bound_ms(nbytes, 2.0 * M * Kw * N, INT8_OPS_PER_S)
        shapes[p.route].append({
            "shape": f"lm_head M={M} K={K} N={N} G={G}", "route": p.route,
            "plan": dataclasses.asdict(p), "ms": ms_k, "plain_ms": ms_p,
            "library_ms": None, "bound_ms": b, "bound_by": by,
            "bytes": nbytes, "bf16_dense_ms": ms_d,
            "bf16_dense_route": fl.plan(M, K, N, False,
                                        torch.bfloat16).route,
            "tol": INT4_TOL, "errors": errs})
        del x
    return shapes


def bf16_ulp(torch, x):
    """One bf16 ulp at each |x|, 2^(floor(log2|x|) - 7); 0 at 0."""
    e = torch.frexp(x.abs())[1]
    return torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), e - 8))


def flash_mirror(torch, q, k, v, q_positions, kv_valid_len=None, *,
                 causal=True, window=0, scale):
    """The plain version with P rounded where the bf16 routes round it:
    scores scaled in fp32 by fp32(scale)·fp32(log2 e), p = exp2(s - M)
    against the row's integer maximum M = ceil(max s), rounded once to bf16
    for the product with V, l = Σ p in fp32 (unrounded); rows without a
    valid key 0.  Returns the fp32 output [B, Tq, Hq, dh] (not rounded)."""
    from repro_torch.kernels import flash_attention as fa
    B, Tq, Hq, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qp, kp, vp = fa.pack_qkv(q, k, v)
    pos, kv_len = fa.pack_positions(q_positions, kv_valid_len, B, Hkv, G, Tk)
    c = (torch.tensor(scale, dtype=torch.float32)
         * torch.tensor(LOG2E, dtype=torch.float32)).to(q.device)
    s = torch.einsum("brd,bkd->brk", qp.float(), kp.float()) * c
    kv = torch.arange(Tk, device=q.device)[None, None]
    qpos = pos[:, :, None]
    mask = kv < kv_len[:, None, None]
    if causal:
        mask = mask & (kv <= qpos)
    if window:
        mask = mask & (kv > qpos - window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.exp2(s - torch.ceil(s.amax(-1, keepdim=True)))
    o = torch.einsum("brk,bkd->brd", p.to(torch.bfloat16).float(),
                     vp.float()) / p.sum(-1, keepdim=True).clamp_min(1e-20)
    o = torch.where(mask.any(-1, keepdim=True), o, torch.zeros_like(o))
    return (o.reshape(B, Hkv, G, Tq, dh).permute(0, 3, 1, 2, 4)
            .reshape(B, Tq, Hq, dh))


def flash_call(torch, q, k, v, qpos, kvl, what, **kw):
    """One flash-attention call on its route against the plain version:
    out within tol·max|ref| (TOL_BF16 in bf16, TOL_F32 in fp32); in bf16
    also within one bf16 ulp of each element plus TOL_FLASH_MIRROR·max of
    the mirror (``flash_mirror``: P rounded as the route rounds it), and
    a second launch on the same inputs bit for bit; the route ``plan``
    picks and only its counter moved.  Returns the error record."""
    from repro_torch.kernels import flash_attention as fa, ops
    B, Tq, Hq, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    bf = q.dtype == torch.bfloat16
    tol = TOL_BF16 if bf else TOL_F32
    route = fa.plan(B * Hkv, Hq // Hkv * Tq, Tk, dh, q.dtype).route
    before = ops.kernel_launches()
    out = fa.flash_attention_cuda(q, k, v, qpos, kvl, **kw)
    after = ops.kernel_launches()
    moved = {r for r in ("wgmma", "splitkv", "simt")
             if after[f"flash_attention_{r}"]
             != before[f"flash_attention_{r}"]}
    require(moved == {route} and after[f"flash_attention_{route}"]
            == before[f"flash_attention_{route}"] + 1,
            f"{what}: routes {moved}, want {route}")
    ro = fa.flash_attention_plain(q, k, v, qpos, kvl, **kw)
    torch.cuda.synchronize()
    e, m = max_err(torch, out, ro)
    require(e <= tol * m, f"{what}: {e} > {tol}·{m}")
    rec = {"route": route, "max_abs_err": e, "max_ref": m}
    if bf:
        mo = flash_mirror(torch, q, k, v, qpos, kvl, **kw)
        mm = mo.abs().max().item()
        d = (out.float() - mo).abs()
        excess = (d - bf16_ulp(torch, mo)).max().item()
        require(excess <= TOL_FLASH_MIRROR * mm, f"{what}: {excess} past one "
                f"bf16 ulp of the mirror > {TOL_FLASH_MIRROR}·{mm}")
        out2 = fa.flash_attention_cuda(q, k, v, qpos, kvl, **kw)
        require(torch.equal(out, out2), f"{what}: a second launch differs")
        rec.update(mirror_max_abs_err=d.max().item(), mirror_max=mm,
                   mirror_excess_over_ulp=excess,
                   mirror_equal_share=(out == mo.to(torch.bfloat16))
                   .float().mean().item(),
                   repeat_bit_identical=True)
    return rec


def check_flash(torch, dev, timer, cfg):
    """Flash attention at a config's main-path shapes (llama2-7b; qwen3-8b's
    G = 4 in phase 17; stablelm-3b's dh 80 and deepseek-coder-33b's G 7 in
    phase 19): prefill (4 × 512, causal) on the tensor-core tile
    and decode (B 4 against a 544-row cache, kv_len 544) on the split-KV
    walk in bf16, each timed beside its plain version and SDPA (its GQA
    mode where G > 1); the same inputs in fp32 on the SIMT kernel (the
    parity route), checked and timed too, beside SDPA on the fp32 inputs
    (TF32 off).  Returns the shape records by
    bf16 route."""
    import torch.nn.functional as Fn
    from repro_torch.kernels import flash_attention as fa
    B, H, dh = 4, cfg.num_heads, cfg.resolved_head_dim
    Hkv = cfg.num_kv_heads
    g = torch.Generator(device=dev).manual_seed(13)
    scale = 1.0 / math.sqrt(dh)
    shapes = {"wgmma": [], "splitkv": []}
    for label, Tq, Tk, t_last in (("prefill", 512, 512, None),
                                  ("decode", 1, 544, 543)):
        bf = torch.bfloat16
        q = torch.randn((B, Tq, H, dh), generator=g, device=dev).to(bf)
        k = torch.randn((B, Tk, Hkv, dh), generator=g, device=dev).to(bf)
        v = torch.randn((B, Tk, Hkv, dh), generator=g, device=dev).to(bf)
        if t_last is None:       # as the model's prefill: an expanded arange
            qpos = torch.arange(Tq, dtype=torch.int32,
                                device=dev)[None].expand(B, Tq)
            kvl = None
        else:
            qpos = torch.full((B, 1), t_last, dtype=torch.int32, device=dev)
            kvl = torch.full((B,), t_last + 1, dtype=torch.int32, device=dev)
        errs = {}
        for dt in (bf, torch.float32):
            a = [t.to(dt) for t in (q, k, v)]
            errs[str(dt).split(".")[-1]] = flash_call(
                torch, *a, qpos, kvl, f"flash {label} {dt}", scale=scale)
        route = errs["bfloat16"]["route"]
        qf, kf, vf = (t.float() for t in (q, k, v))
        ms_s = timer(lambda: fa.flash_attention_cuda(qf, kf, vf, qpos, kvl,
                                                     scale=scale))
        qft, kft, vft = (t.transpose(1, 2) for t in (qf, kf, vf))
        ms_sl = timer(lambda: Fn.scaled_dot_product_attention(
            qft, kft, vft, is_causal=t_last is None, enable_gqa=H != Hkv))
        del qf, kf, vf, qft, kft, vft
        ms_k = timer(lambda: fa.flash_attention_cuda(q, k, v, qpos, kvl,
                                                     scale=scale))
        ms_p = timer(lambda: fa.flash_attention_plain(q, k, v, qpos, kvl,
                                                      scale=scale))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms_l = timer(lambda: Fn.scaled_dot_product_attention(
            qt, kt, vt, is_causal=t_last is None, enable_gqa=H != Hkv))
        if t_last is None:
            pairs = B * H * Tq * (Tq + 1) // 2          # causal (q, key) pairs
            keys = Tk
        else:
            pairs = B * H * (t_last + 1)
            keys = t_last + 1
        nbytes = (2 * B * Tq * H * dh + 2 * B * keys * Hkv * dh) * 2
        b, by = bound_ms(nbytes, 4.0 * pairs * dh)
        b32, by32 = bound_ms(2 * nbytes, 4.0 * pairs * dh, FP32_OPS_PER_S)
        shapes[route].append({
            "shape": f"{label} B={B} Tq={Tq} Tk={Tk} H={H} dh={dh}",
            "route": route, "ms": ms_k, "plain_ms": ms_p, "library_ms": ms_l,
            "bound_ms": b, "bound_by": by,
            "tol": f"bf16 {TOL_BF16}·max|ref|, and one bf16 ulp + "
                   f"{TOL_FLASH_MIRROR}·max of the mirror (P rounded as the "
                   f"route rounds it); fp32 {TOL_F32}·max|ref|",
            "errors": {"bfloat16": errs["bfloat16"]}, "simt_f32_ms": ms_s,
            "simt_f32_library_ms": ms_sl,
            "simt_f32_bound_ms": b32, "simt_f32_bound_by": by32,
            "simt_f32_errors": dict(errs["float32"],
                                    tol=f"{TOL_F32}·max|ref|")})
        del q, k, v, qt, kt, vt
    return shapes


def paged_call(torch, a, qpos, kw, kd, scale, what):
    """One paged-attention call on its route against the plain version:
    out within tol·max|ref| (TOL_BF16 for bf16 q, TOL_F32 for fp32 q); the
    route ``plan`` picks and only its counter moved; for bf16 q a second
    launch on the same inputs bit for bit.  Returns the error record."""
    from repro_torch.kernels import ops, paged_attention as pa, ref
    q, kp, _, bt, eff = a[:5]
    bf = q.dtype == torch.bfloat16
    tol = TOL_BF16 if bf else TOL_F32
    route = pa.plan(q.shape[0], kp.shape[2], q.shape[2] // kp.shape[2],
                    q.shape[3], eff.shape[1], kd, q.dtype).route
    before = ops.kernel_launches()
    out = pa.paged_attention_cuda(*a, qpos, scale=scale, kv_dtype=kd, **kw)
    after = ops.kernel_launches()
    moved = {r for r in ("split", "simt") if after[f"paged_attention_{r}"]
             != before[f"paged_attention_{r}"]}
    require(moved == {route} and after[f"paged_attention_{route}"]
            == before[f"paged_attention_{route}"] + 1,
            f"{what}: routes {moved}, want {route}")
    ro = ref.paged_attention_ref(*a, q_positions=qpos, softmax_scale=scale,
                                 kv_dtype=kd, **kw)
    torch.cuda.synchronize()
    e, m = max_err(torch, out, ro)
    require(e <= tol * m, f"{what}: {e} > {tol}·{m}")
    rec = {"route": route, "max_abs_err": e, "max_ref": m}
    if bf:
        out2 = pa.paged_attention_cuda(*a, qpos, scale=scale, kv_dtype=kd,
                                       **kw)
        require(torch.equal(out, out2), f"{what}: a second launch differs")
        rec["repeat_bit_identical"] = True
    return rec


def paged_bytes(kd, q_bytes, rows, B, Hq, Hkv, dh, J, ps):
    """Bytes a paged call must move: the admitted rows' payload (and fp32
    scales) for every kv-head, the in-flight tokens (q's type), the eff_pos row
    and block table, q in and out, q_positions."""
    from repro_torch.kernels import paged_attention as pa
    row = pa.row_bytes(kd, dh) + (4 if kd else 0)
    return (rows * Hkv * 2 * row + B * Hkv * dh * 2 * q_bytes + B * J * ps * 4
            + B * J * 4 + 2 * B * Hq * dh * q_bytes + B * 4)


def paged_history(torch, np, dev, cfg, kv_dtypes, B=4, T=512, ps=16,
                  J=1024, layer=16, keep=0.5):
    """B slots' T-token entry streams in one store per payload type, packed
    by the port's own ``pack_prefill`` from a keep-0.5 gate log over every
    layer (random K/V rows), block tables over a shuffled pool of B·J pages,
    and the effective positions of a middle layer from the port's history
    functions.  Returns (stores, block_table [B, J], eff_pos [B, J·ps],
    fill per slot)."""
    from repro_torch.kvcache import history, paged
    L, Hkv, dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    g = torch.Generator(device=dev).manual_seed(15)
    rng = np.random.default_rng(15)
    P = B * J
    bt = torch.as_tensor(rng.permutation(P).reshape(B, J).astype(np.int32),
                         device=dev)
    stores = {kd: paged.init_store(cfg, P, ps, kv_dtype=kd, device=dev)
              for kd in kv_dtypes}
    fill = []
    for b in range(B):
        gates = (torch.rand((L, T), generator=g, device=dev) < keep).float()
        cache = [{n: torch.randn((1, T, Hkv, dh), generator=g,
                                 device=dev).to(torch.bfloat16)
                  for n in ("k", "v")} for _ in range(L)]
        for kd, st in stores.items():
            paged.pack_prefill(st, cache, gates, T, bt[b], cfg, kv_dtype=kd)
        fill.append(int(history.fresh_mask(gates, True).sum()))
        del cache
    view = paged.gather_view(stores[kv_dtypes[0]], bt, with_kv=False)
    E = J * ps
    in_fill = (torch.arange(E, device=dev)[None]
               < torch.tensor(fill, device=dev)[:, None])
    eff = history.effective_positions(view["pos"], view["l0"], view["l1"],
                                      in_fill, layer)
    return stores, bt, eff, fill


def check_paged(torch, np, dev, timer, cfg, B=4, T=512, ps=16, J=1024,
                layer=16):
    """Paged decode attention at the full-width decode shape: B 4, 32 heads,
    dh 128, page 16, a 1024-page walk over 512-token histories, in bf16,
    int8 and int4 pages: bf16 q on the split walk (timed; beside it the
    SIMT kernel on the same bf16 inputs, the route bf16 decode took before
    the split walk, and the dense pool's split-KV walk over the same
    admitted rows laid out contiguously, the yardstick), fp32 q on the
    SIMT kernel (int8 and int4 pages; timed).  Returns the shape records
    by route."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa, ref
    from repro_torch.kvcache import paged
    Hq, dh, Hkv = cfg.num_heads, cfg.resolved_head_dim, cfg.num_kv_heads
    kinds = (None, "int8", "int4")
    stores, bt, eff, fill = paged_history(torch, np, dev, cfg, kinds, B=B,
                                          T=T, ps=ps, J=J, layer=layer)
    g = torch.Generator(device=dev).manual_seed(16)
    bf = torch.bfloat16
    q = torch.randn((B, 1, Hq, dh), generator=g, device=dev).to(bf)
    kt = torch.randn((B, 1, Hkv, dh), generator=g, device=dev).to(bf)
    vt = torch.randn((B, 1, Hkv, dh), generator=g, device=dev).to(bf)
    qpos = torch.full((B, 1), T, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(dh)
    hist_rows = int((eff <= T).sum().item())
    require(hist_rows == B * T, f"layer {layer} admits {hist_rows} entries, "
            f"not one per token ({B * T})")
    # the yardstick: the admitted bf16 rows gathered in order, then the
    # in-flight token, as the dense pool holds them (kv_len T + 1)
    st = stores[None]
    rows = paged.gather_view(st, bt)          # [B, J·ps, ...]
    order = torch.argsort(torch.where(eff <= T, eff, T + 1), dim=1,
                          stable=True)[:, :T]
    idx = order[..., None, None].expand(B, T, Hkv, dh)
    kd_ = torch.cat([rows["k"].gather(1, idx), kt], 1).contiguous()
    vd_ = torch.cat([rows["v"].gather(1, idx), vt], 1).contiguous()
    kvl = torch.full((B,), T + 1, dtype=torch.int32, device=dev)
    ms_y = timer(lambda: fa.flash_attention_cuda(q, kd_, vd_, qpos, kvl,
                                                 scale=scale))
    y_route = fa.plan(B * Hkv, Hq // Hkv, T + 1, dh, q.dtype).route
    del rows, kd_, vd_, idx
    shapes = {"split": [], "simt": []}
    for kd in kinds:
        st = stores[kd]
        kw = {} if kd is None else {"k_scales": st["k_scales"],
                                    "v_scales": st["v_scales"]}
        pages = (st["k_pages"], st["v_pages"], bt, eff)
        label = f"B={B} H={Hq} dh={dh} ps={ps} J={J} T={T} layer={layer}"
        a = (q, *pages, kt, vt)
        p = pa.plan(B, Hkv, Hq // Hkv, dh, J * ps, kd, q.dtype)
        simt_bf16 = pa.plan(B, Hkv, Hq // Hkv, dh, J * ps, kd, torch.float32)
        err = paged_call(torch, a, qpos, kw, kd, scale,
                         f"paged {kd or 'bf16'} bf16")
        ms_k = timer(lambda: pa.paged_attention_cuda(
            *a, qpos, scale=scale, kv_dtype=kd, **kw))
        ms_s = timer(lambda: pa.run_plan(simt_bf16, *a, qpos, scale=scale,
                                         kv_dtype=kd, **kw))
        ms_p = timer(lambda: ref.paged_attention_ref(
            *a, q_positions=qpos, softmax_scale=scale, kv_dtype=kd, **kw))
        nbytes = paged_bytes(kd, 2, hist_rows, B, Hq, Hkv, dh, J, ps)
        b, by = bound_ms(nbytes, 4.0 * (hist_rows + B) * Hq * dh)
        shapes["split"].append({
            "shape": f"paged {kd or 'bf16'} pages, bf16 q, {label}",
            "plan": dataclasses.asdict(p), "ms": ms_k, "plain_ms": ms_p,
            "library_ms": None, "bound_ms": b, "bound_by": by,
            "bytes": nbytes, "simt_bf16_ms": ms_s,
            "yardstick_flash_splitkv_ms": ms_y, "yardstick_route": y_route,
            "admitted_rows": hist_rows + B, "entries_walked": B * J * ps,
            "fill": fill, "tpu_walk_bytes": B * J * ps * Hkv * 2 * (
                pa.row_bytes(kd, dh) + (4 if kd else 0)),
            "tol": f"{TOL_BF16}·max|ref|", "errors": {"bfloat16": err}})
        if kd is None:
            continue            # native pages are bf16: q must match
        a32 = (q.float(), *pages, kt.float(), vt.float())
        err = paged_call(torch, a32, qpos, kw, kd, scale,
                         f"paged {kd} fp32")
        ms_k = timer(lambda: pa.paged_attention_cuda(
            *a32, qpos, scale=scale, kv_dtype=kd, **kw))
        ms_p = timer(lambda: ref.paged_attention_ref(
            *a32, q_positions=qpos, softmax_scale=scale, kv_dtype=kd, **kw))
        nbytes = paged_bytes(kd, 4, hist_rows, B, Hq, Hkv, dh, J, ps)
        b, by = bound_ms(nbytes, 4.0 * (hist_rows + B) * Hq * dh,
                         FP32_OPS_PER_S)
        shapes["simt"].append({
            "shape": f"paged {kd} pages, fp32 q, {label}",
            "plan": dataclasses.asdict(simt_bf16), "ms": ms_k,
            "plain_ms": ms_p, "library_ms": None, "bound_ms": b,
            "bound_by": by, "bytes": nbytes,
            "tol": f"{TOL_F32}·max|ref|", "errors": {"float32": err}})
    del stores
    return shapes


def ssd_inputs(torch, dev, g, B, T, H, P, N, G, dt):
    """SSD scan inputs: x, B, C ~ N(0, 1) in ``dt``; dt (softplus'd) in
    (0, 0.1) with every third token skipped (dt = 0, as the routing gate
    leaves it); A_log = log(linspace(1, 16)) as the model's init."""
    x = torch.randn((B, T, H, P), generator=g, device=dev).to(dt)
    d = torch.rand((B, T, H), generator=g, device=dev) * 0.1
    d[:, 1::3] = 0.0
    A = torch.log(torch.linspace(1.0, 16.0, H, device=dev))
    Bm = torch.randn((B, T, G, N), generator=g, device=dev).to(dt)
    Cm = torch.randn((B, T, G, N), generator=g, device=dev).to(dt)
    return x, d, A, Bm, Cm


def ssd_exact_inputs(torch, dev, g, B, T, H, P, N, G):
    """bf16 SSD scan inputs whose chunk cumsums are exact in any order: x,
    B, C ~ N(0, 1); A_log = 0 (A = -1); dt on a 2^-10 grid in [0, 0.1),
    every third token 0.  exp(cum_i - cum_j) then has the same argument on
    the card as in the plain versions, so the tensor-core route differs
    from ``ref.ssd_scan_split`` only by its sum order and its exp; on
    ``ssd_inputs`` the fp32 cumsum's order alone moves y by ~4e-6·max,
    as much as the split's lo term."""
    x = torch.randn((B, T, H, P), generator=g, device=dev).bfloat16()
    d = torch.randint(0, 103, (B, T, H), generator=g, device=dev) / 1024.0
    d[:, 1::3] = 0.0
    A = torch.zeros(H, device=dev)
    Bm = torch.randn((B, T, G, N), generator=g, device=dev).bfloat16()
    Cm = torch.randn((B, T, G, N), generator=g, device=dev).bfloat16()
    return x, d, A, Bm, Cm


def ssd_errors(torch, args, chunk, what, split_tol=TOL_F32):
    """The kernel's y and final state, on the route ``ss.plan`` picks,
    against the plain version's, each within TOL_F32 · max|ref| (fp32
    outputs of fp32 math on the same inputs; the tensor-core route splits
    its fp32 operands into three bf16 terms, exact to fp32); on the
    tensor-core route also against ``ref.ssd_scan_split``, which rounds
    the operands as the route does, within ``split_tol`` · max|mirror|; a
    second launch must repeat both bit for bit.  Returns {"route",
    "max_abs_err", "max_ref", "state_*", "split_*"}."""
    from repro_torch.kernels import ref, ssd_scan as ss
    x, Bm = args[0], args[3]
    route = ss.plan(*x.shape, Bm.shape[-1], Bm.shape[-2], chunk,
                    x.dtype).route
    y, st = ss.ssd_scan_cuda(*args, chunk)
    y2, st2 = ss.ssd_scan_cuda(*args, chunk)
    yr, sr = ref.ssd_scan_ref(*args, chunk)
    torch.cuda.synchronize()
    require(torch.equal(y, y2) and torch.equal(st, st2),
            f"ssd_scan {route} {what}: a second launch differs")
    e, m = max_err(torch, y, yr)
    es, ms = max_err(torch, st, sr)
    out = {"route": route, "max_abs_err": e, "max_ref": m,
           "state_max_abs_err": es, "state_max_ref": ms,
           "second_launch_identical": True}
    if route == "tc":
        ym, sm = ref.ssd_scan_split(*args, chunk)
        e2, m2 = max_err(torch, y, ym)
        es2, ms2 = max_err(torch, st, sm)
        out.update(split_max_abs_err=e2, split_max_ref=m2,
                   split_state_max_abs_err=es2, split_state_max_ref=ms2,
                   split_tol=split_tol)
    require(e <= TOL_F32 * m, f"ssd_scan y {what}: {e} > {TOL_F32}·{m}")
    require(es <= TOL_F32 * ms, f"ssd_scan state {what}: {es} > "
            f"{TOL_F32}·{ms}")
    if route == "tc":
        require(e2 <= split_tol * m2 and es2 <= split_tol * ms2,
                f"ssd_scan {what} against its split mirror: y {e2} of {m2}, "
                f"state {es2} of {ms2}, limit {split_tol}·max")
    return out


def ssd_work(B, T, H, P, N, G, chunk, esize, splits=1):
    """(bytes, operations) one scan needs: each input read once and each
    output written once; the chunk products over the real tokens (causal
    pairs of each chunk: C·B and the intra-chunk y; C·state and the state
    update per token), the products with an fp32 operand ``splits`` times
    (1: the scan's own work, what the bound counts; 3: the tensor-core
    route's three bf16 terms; C·B is bf16 × bf16 either way)."""
    Q = min(chunk, T)
    ops = 0
    for t0 in range(0, T, Q):
        L = min(Q, T - t0)
        pairs = L * (L + 1) // 2
        ops += 2 * pairs * N + splits * (2 * pairs * P + 4 * L * N * P)
    nbytes = (B * T * H * P * esize + B * T * H * 4 + H * 4
              + 2 * B * T * G * N * esize + B * T * H * P * 4
              + B * H * P * N * 4)
    return nbytes, float(B * H * ops)


def check_ssd(torch, dev, timer, cfg):
    """The SSD chunk scan at the mamba2-2.7b main-path shapes: lock-step
    prefill (B 4 × T 512) and one continuous prefill (B 1 × T 512), y and
    the final state.  bf16 inputs on the tensor-core route (timed; beside
    it the SIMT kernel on the same bf16 inputs, through ``run_plan``), fp32
    inputs on the SIMT kernel (timed), each launched twice bit for bit.
    The tensor-core route is held also against ``ref.ssd_scan_split``:
    within TOL_F32 on these inputs and within TOL_SPLIT on
    ``ssd_exact_inputs`` of the same shape.  Each record carries both
    bounds: bytes, and the scan's operations, each product counted once,
    at the route's rate (bf16 tensor cores; the SIMT kernel's fp32), and
    beside them the tensor-core route's operations with its three split
    terms counted (``tc_split_ops``, not a bound).  Returns the shape
    records by route."""
    from repro_torch.kernels import ref, ssd_scan as ss
    H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    G, Q = cfg.ssm_groups, cfg.ssm_chunk
    g = torch.Generator(device=dev).manual_seed(19)
    shapes = {"tc": [], "simt": []}
    for B, T in ((4, 512), (1, 512)):
        label = f"B={B} T={T} H={H} P={P} N={N} G={G} Q={Q}"
        tol = f"y and state {TOL_F32}·max|ref| (fp32 outputs)"
        args = ssd_inputs(torch, dev, g, B, T, H, P, N, G, torch.bfloat16)
        p = ss.plan(B, T, H, P, N, G, Q, torch.bfloat16)
        simt_bf16 = ss.plan(B, T, H, P, N, G, Q, torch.float32)
        require(p.route == "tc" and simt_bf16.route == "simt",
                f"ssd_scan {label}: plans {p.route}/{simt_bf16.route}")
        err = ssd_errors(torch, args, Q, f"{label} bf16")
        exact = ssd_errors(torch, ssd_exact_inputs(torch, dev, g, B, T, H, P,
                                                   N, G), Q,
                           f"{label} bf16 exact cumsums", TOL_SPLIT)
        ms_k = timer(lambda: ss.ssd_scan_cuda(*args, Q))
        ms_s = timer(lambda: ss.run_plan(simt_bf16, *args, Q))
        ms_p = timer(lambda: ref.ssd_scan_ref(*args, Q))
        nbytes, ops = ssd_work(B, T, H, P, N, G, Q, 2)
        b, by = bound_ms(nbytes, ops)
        shapes["tc"].append({
            "shape": f"{label} bf16", "plan": dataclasses.asdict(p),
            "ms": ms_k, "plain_ms": ms_p, "library_ms": None,
            "bound_ms": b, "bound_by": by,
            "bound_ops_ms": ops / BF16_OPS_PER_S * 1e3,
            "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bytes": nbytes, "ops": ops,
            "tc_split_ops": ssd_work(B, T, H, P, N, G, Q, 2, splits=3)[1],
            "simt_bf16_ms": ms_s, "tol": tol, "errors": {"bfloat16": err},
            "exact_cumsums": exact})
        a32 = (args[0].float(),) + args[1:3] + tuple(m.float()
                                                     for m in args[3:])
        del args
        err = ssd_errors(torch, a32, Q, f"{label} fp32")
        ms_k = timer(lambda: ss.ssd_scan_cuda(*a32, Q))
        ms_p = timer(lambda: ref.ssd_scan_ref(*a32, Q))
        nbytes, ops = ssd_work(B, T, H, P, N, G, Q, 4)
        b, by = bound_ms(nbytes, ops, FP32_OPS_PER_S)
        shapes["simt"].append({
            "shape": f"{label} fp32", "plan": dataclasses.asdict(simt_bf16),
            "ms": ms_k, "plain_ms": ms_p, "library_ms": None,
            "bound_ms": b, "bound_by": by,
            "bound_ops_ms": ops / FP32_OPS_PER_S * 1e3,
            "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bytes": nbytes, "ops": ops, "tol": tol,
            "errors": {"float32": err}})
        del a32
    return shapes


# SSD scan off the main shapes: B, T, H, P, N, G, chunk (T off the chunk,
# T < chunk with G = 2, T = 1, G = 3 with two heads per group at chunk 64,
# one token past a chunk at full width)
SSD_RAGGED = ((2, 300, 8, 64, 128, 1, 128), (1, 37, 8, 64, 128, 2, 128),
              (3, 1, 4, 64, 128, 1, 128), (2, 200, 6, 32, 16, 3, 64),
              (1, 129, 80, 64, 128, 1, 128))


def check_ragged(torch, dev):
    """Shapes off the main path's tile multiples (ragged M, K, F, Tq, Tk,
    G > 1, a window), against the plain versions, not timed."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_linear as fl
    g = torch.Generator(device=dev).manual_seed(14)
    worst, dense, flash, int4, paged_recs, ssd = {}, {}, {}, {}, {}, {}
    router = {}

    def note(name, e, m, tol):
        require(e <= tol * m, f"ragged {name}: {e} > {tol}·{m}")
        worst[name] = max(worst.get(name, 0.0), e / m)

    for dt, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        dname = str(dt).split(".")[-1]
        for T, D, off in ROUTER_RAGGED:
            # off: x starts that many elements into its buffer (None: a
            # view one row into a buffer of odd D, one more row)
            w = torch.randn((D, 2), generator=g, device=dev)
            n = (T + 1) * D if off is None else T * D + off
            buf = torch.randn((n,), generator=g, device=dev).to(dt)
            x = buf[D if off is None else off:].view(T, D)
            r = router_call(torch, x, w, f"ragged router T={T} D={D} "
                            f"off={off} {dname}")
            note("router_stats", r["max_abs_err"], r["max_ref"], TOL_F32)
            router[f"T={T} D={D} off={off} {dname}"] = r
        for M, K, F, glu in ((37, 200, 70, True), (5, 300, 130, False),
                             (130, 40, 200, False)):
            N = 2 * F if glu else F
            x = torch.randn((M, K), generator=g, device=dev).to(dt)
            w = (torch.randn((K, N), generator=g, device=dev) * 0.05).to(dt)
            kw = dict(mean_sq=(x.float() ** 2).mean(-1),
                      gamma=(1 + 0.1 * torch.randn((K,), generator=g,
                                                   device=dev)).to(dt),
                      glu=glu, act="silu" if glu else None,
                      residual=torch.randn(
                          (M, F), generator=g, device=dev).to(dt),
                      gate_mul=(torch.rand((M,), generator=g, device=dev)
                                > 0.5).float(), emit_sq=True)
            r = fused_linear_call(torch, x, w, kw, f"ragged fused_linear "
                                  f"M={M} K={K} F={F} {dname}")
            note("fused_linear", r["max_abs_err"], r["max_ref"], tol)
            dense[f"M={M} K={K} F={F} {dname}"] = r
        for case in INT4_RAGGED:
            r = ragged_int4(torch, dev, g, dt, *case)
            note("fused_linear_int4", r["max_abs_err"], r["max_ref"], tol)
            int4[f"M={case[0]} K={case[1]} F={case[2]} G={case[4]} "
                 f"{dname}"] = r
        for M, K, N, G, pow2 in ((1, 200, 33, 64, True),
                                 (17, 256, 130, 128, False),
                                 (3, 38, 7, 128, True)):
            codes, scale, _, _ = int4_weight(torch, dev, g, K, N, G, pow2)
            x = bfp_ties(torch, dev, g, M, K, dt)
            r, _ = int4_call(torch, x, codes, scale, {}, f"ragged "
                             f"int4_matmul M={M} K={K} N={N} {dname}",
                             matmul=True)
            note("int4_matmul", r["max_abs_err"], r["max_ref"], tol)
            int4[f"matmul M={M} K={K} N={N} G={G} {dname}"] = r
        for case in FLASH_RAGGED:
            B, Tq, Tk, Hq, Hkv, dh, window, kind = case
            args = flash_ragged_inputs(torch, dev, g, dt, B, Tq, Tk, Hq, Hkv,
                                       dh, kind)
            r = flash_call(torch, *args, f"ragged flash {case} {dname}",
                              window=window, scale=1.0 / math.sqrt(dh))
            note("flash_attention", r["max_abs_err"], r["max_ref"], tol)
            flash[f"{kind} B={B} Tq={Tq} Tk={Tk} Hq={Hq} Hkv={Hkv} dh={dh} "
                  f"window={window} {dname}"] = r
        for case in PAGED_RAGGED:
            for kd in (None, "int8", "int4"):
                r = ragged_paged(torch, dev, g, dt, kd, *case)
                note("paged_attention", r["max_abs_err"], r["max_ref"], tol)
                paged_recs[f"{case} {kd} {dname}"] = r
        for B, T, H, P, N, G, chunk in SSD_RAGGED:
            r = ssd_errors(torch, ssd_inputs(torch, dev, g, B, T, H, P, N,
                                             G, dt), chunk,
                           f"ragged B={B} T={T} G={G} {dt}")
            note("ssd_scan", r["max_abs_err"], r["max_ref"], TOL_F32)
            note("ssd_scan_state", r["state_max_abs_err"],
                 r["state_max_ref"], TOL_F32)
            ssd[f"B={B} T={T} H={H} P={P} N={N} G={G} Q={chunk} "
                f"{dname}"] = r
    torch.cuda.synchronize()
    routes = {(k.split()[-1], r["rows"], r["vec"]) for k, r in router.items()}
    require(routes == {(d, rv, v) for d in ("bfloat16", "float32")
                       for rv, v in ((4, 2), (1, 2), (1, 1))},
            f"ragged router cases took (rows, vec) {sorted(routes)}")
    routes = {(k.split()[-1], r["route"]) for k, r in flash.items()}
    require(routes == {("bfloat16", "wgmma"), ("bfloat16", "splitkv"),
                       ("float32", "simt")},
            f"ragged flash cases took the routes {sorted(routes)}")
    routes = {(k.split()[-1], r["route"]) for k, r in int4.items()}
    require(routes == {(d, r) for d in ("bfloat16", "float32")
                       for r in ("tc", "stream")},
            f"ragged int4 cases took the routes {sorted(routes)}")
    routes = {(k.split()[-1], r["route"]) for k, r in paged_recs.items()}
    require(routes == {("bfloat16", "split"), ("bfloat16", "simt"),
                       ("float32", "simt")},
            f"ragged paged cases took the routes {sorted(routes)}")
    routes = {(k.split()[-1], r["route"]) for k, r in ssd.items()}
    require(routes == {("bfloat16", "tc"), ("float32", "simt")},
            f"ragged ssd cases took the routes {sorted(routes)}")
    return {"phase": "ragged", "max_err_over_max_ref": worst,
            "router_stats": router,
            "router_stats_refusals": router_refusals(torch, dev),
            "fused_linear": dense,
            "fused_linear_refusals": fused_linear_refusals(torch, dev),
            "int4": int4, "int4_refusals": int4_refusals(torch, dev),
            "flash_attention": flash,
            "flash_attention_refusals": flash_refusals(torch, dev),
            "paged_attention": paged_recs,
            "paged_attention_refusals": paged_refusals(torch, dev),
            "ssd_scan": ssd, "ssd_scan_refusals": ssd_refusals(torch, dev)}


# router_stats off the main shapes: T, D and x's offset in its buffer in
# elements (None: one row into a buffer of odd D).  T 1 to 37 take a block
# a row, 2049 blocks of 4 rows (rows off a multiple of the block's; past
# the grid's cap); T 17 and above also rerun their first 16 rows alone;
# D 300, 4096 and 4100 take lanes of 2 elements, D 301 (odd) of 1;
# offsets of 1 and 2 elements make x's address take 1 and 2.
ROUTER_RAGGED = ((1, 300, 0), (16, 300, 0), (17, 300, 0), (37, 300, 0),
                 (2049, 300, 0), (1, 4100, 0), (16, 4100, 0),
                 (17, 4100, 0), (2049, 4100, 0), (1, 4096, 0),
                 (17, 4096, 0), (3, 301, None), (20, 301, None),
                 (4, 4096, 1), (20, 4096, 1), (4, 4096, 2), (20, 4096, 2))


def router_refusals(torch, dev):
    """The router's C entries refuse a plan that disagrees with the
    source: a grid, thread count or shared-memory size other than the
    plan's, a vector width the kernel has no instantiation of or to which
    x's address is not aligned, or rows a block past its 16 warps; it
    returns cudaErrorInvalidValue and the wrapper raises, at a block a row
    and at blocks of 4 rows and in both element types."""
    from repro_torch.kernels import fused_router_rmsnorm as frr
    refused = {}
    rep = dataclasses.replace
    D = 4096
    w = torch.zeros((D, 2), device=dev)
    for dt in (torch.bfloat16, torch.float32):
        buf = torch.zeros((2048 * D + 1,), dtype=dt, device=dev)
        for T in (2048, 4):
            x = buf[:T * D].view(T, D)
            p = frr.plan(T, D, dt, x.data_ptr())
            bad = {"grid": rep(p, grid=p.grid + 1),
                   "threads": rep(p, threads=p.threads + 32),
                   "smem": rep(p, smem=p.smem + 16),
                   "vec4": rep(p, vec=4), "vec3": rep(p, vec=3),
                   "rows": rep(p, rows=8, grid=-(-T // 8),
                               threads=p.threads * 8 // p.rows,
                               smem=p.smem * 8 // p.rows)}
            for what, bp in bad.items():
                try:
                    frr.run_plan(bp, x, w)
                except RuntimeError as e:
                    refused[f"T={T} {what} {dt}"] = str(e)
                    continue
                raise RuntimeError(f"router_stats T={T}: a plan with "
                                   f"{what} off the source was not refused")
            xm = buf[1:1 + T * D].view(T, D)      # 2 or 4 bytes off
            try:
                frr.run_plan(p, xm, w)
            except RuntimeError as e:
                refused[f"T={T} misaligned {dt}"] = str(e)
                continue
            raise RuntimeError(f"router_stats T={T}: a {p.vec}-element "
                               "vector at a misaligned x was not refused")
    torch.cuda.synchronize()
    return refused


# flash attention off the main shapes: B, Tq, Tk, Hq, Hkv, dh, window and
# the positions (``flash_ragged_inputs``).  bf16 takes the tensor-core tile
# for the first three (G 2; dh 32 with a window; pad rows and Tk off the
# 128-key tile) and the split-KV walk for the next three (G 4; kv_len 3
# of 544, so whole splits see no valid key; R 16 causal).  Then dh 256 at
# gemma3-12b's G 2 (16 over 8 heads), off its 64-key and 64-row tiles:
# the dense pool's prefills of 1000 tokens (a LOCAL layer, window 1024)
# and 300 (a global one) with kv_len below Tk, 1100 tokens with the
# window cutting keys, pad rows under the window on the tile; on the split
# walk a linear cache past W at window 1024 (the decode of a LOCAL layer
# whose prompt was ≤ W) and kv_len 3 of 1024.  fp32 takes the SIMT kernel
# for all.
FLASH_RAGGED = ((2, 24, 24, 4, 2, 64, 0, "prefill"),
                (1, 37, 37, 4, 4, 32, 8, "prefill"),
                (2, 40, 70, 8, 4, 128, 0, "tail"),
                (3, 1, 50, 8, 2, 128, 0, "decode"),
                (2, 1, 544, 4, 4, 128, 0, "short"),
                (2, 16, 16, 2, 2, 64, 0, "prefill"),
                (2, 1000, 1000, 16, 8, 256, 1024, "prefill"),
                (1, 300, 300, 16, 8, 256, 0, "prefill"),
                (2, 1100, 1100, 4, 2, 256, 1024, "prefill"),
                (2, 40, 1100, 16, 8, 256, 1024, "tail"),
                (3, 1, 1100, 16, 8, 256, 1024, "decode"),
                (2, 1, 1024, 16, 8, 256, 0, "short"))


def flash_ragged_inputs(torch, dev, g, dt, B, Tq, Tk, Hq, Hkv, dh, kind):
    """q, k, v ~ N(0, 1) in dt and int32 positions: "prefill" 0..Tq-1 with
    kv_len Tk - 3b; "tail" the last Tq of Tk with kv_len Tk - 9b and batch
    1's last 5 rows pads (-1); "decode" at kv_len - 1, kv_len Tk - 3b;
    "short" decode with kv_len 3 (then 300)."""
    rnd = lambda *sh: torch.randn(sh, generator=g, device=dev).to(dt)  # noqa
    q, k, v = rnd(B, Tq, Hq, dh), rnd(B, Tk, Hkv, dh), rnd(B, Tk, Hkv, dh)
    step = {"prefill": 3, "tail": 9, "decode": 3}.get(kind, 0)
    kvl = torch.tensor([Tk - step * b for b in range(B)], dtype=torch.int32,
                       device=dev)
    if kind == "short":
        kvl = torch.tensor([3, 300][:B], dtype=torch.int32, device=dev)
    ar = torch.arange(Tq, dtype=torch.int32, device=dev)[None]
    if kind == "prefill":
        qpos = ar.expand(B, Tq)
    elif kind == "tail":
        qpos = (ar + Tk - Tq).repeat(B, 1)
        qpos[1, -5:] = -1
    else:
        qpos = kvl[:, None] - 1
    return q, k, v, qpos, kvl


def flash_refusals(torch, dev):
    """Flash attention's C entries refuse a plan that disagrees with the
    source: a key tile, grid, split or shared-memory size it has no
    instantiation of, or the SIMT route for bf16, returns
    cudaErrorInvalidValue and the wrapper raises, on every route."""
    from repro_torch.kernels import flash_attention as fa
    refused = {}
    B, Hkv, dh, Tk = 2, 2, 64, 100
    for Tq, dt in ((40, torch.bfloat16), (1, torch.bfloat16),
                   (40, torch.float32)):
        q = torch.zeros((B, Tq, Hkv, dh), dtype=dt, device=dev)
        k = torch.zeros((B, Tk, Hkv, dh), dtype=dt, device=dev)
        qpos = torch.full((B, Tq), Tk - 1, dtype=torch.int32, device=dev)
        p = fa.plan(B * Hkv, Tq, Tk, dh, dt)
        bad = {"tile_k": dataclasses.replace(p, tile_k=p.tile_k // 2),
               "grid": dataclasses.replace(p, grid=(p.grid[0] + 1,
                                                     p.grid[1])),
               "smem": dataclasses.replace(p, smem=p.smem + 16)}
        if p.route == "splitkv":
            bad["splits"] = dataclasses.replace(
                p, splits=p.splits + 1, grid=(p.splits + 1, p.grid[1]))
        if dt == torch.bfloat16:
            bad["simt"] = fa.plan(B * Hkv, Tq, Tk, dh, torch.float32)
        for what, bp in bad.items():
            try:
                fa.run_plan(bp, q, k, k, qpos, None, causal=True, window=0,
                            scale=0.125)
            except RuntimeError as e:
                refused[f"{p.route} {what}"] = str(e)
                continue
            raise RuntimeError(f"flash_attention {p.route}: a plan with "
                               f"{what} off the source was not refused")
    torch.cuda.synchronize()
    return refused


def fused_linear_refusals(torch, dev):
    """The dense fused linear's C entries refuse a plan that disagrees with
    the source: one entry of Σy² or split-K scratch short of what the grid
    writes, or a tile width the source has no instantiation of, returns
    cudaErrorInvalidValue and the wrapper raises, on every route."""
    from repro_torch.kernels import fused_linear as fl
    refused = {}
    for M, dt in ((4, torch.bfloat16), (37, torch.bfloat16),
                  (37, torch.float32)):
        K, F = 64, 136
        p = fl.plan(M, K, F, False, dt)
        x = torch.zeros((M, K), dtype=dt, device=dev)
        w = torch.zeros((K, F), dtype=dt, device=dev)
        bad = {"tile_n": dataclasses.replace(p, tile_n=p.tile_n // 2)}
        if p.route == "splitk":
            bad["part"] = dataclasses.replace(p, part=p.part - 1)
        else:
            bad["sq_part"] = dataclasses.replace(p, sq_part=p.sq_part - 1)
        for what, q in bad.items():
            try:
                fl.run_plan(q, x, w, mean_sq=None, gamma=None, eps=1e-5,
                            glu=False, act=None, residual=None,
                            gate_mul=None, emit_sq=True)
            except RuntimeError as e:
                refused[f"{p.route} {what}"] = str(e)
                continue
            raise RuntimeError(f"fused_linear {p.route}: a plan with {what} "
                               "off the source was not refused")
    torch.cuda.synchronize()
    return refused


# int4 fused linear off the main shapes: M, K, F, glu, group, pow2 scales,
# norm prologue, gate/residual/Σy² epilogue (K 200 and 38 leave a padded
# last group; G 38 leaves a part-filled 32-bit word; F 131 and 97 are odd)
INT4_RAGGED = ((1, 200, 70, True, 64, True, True, True),
               (3, 200, 131, False, 64, False, False, True),
               (17, 300, 97, False, 32, True, True, False),
               (17, 38, 64, True, 128, False, True, False),
               (5, 256, 64, False, 128, True, False, False))


def bfp_ties(torch, dev, g, M, K, dt):
    """An activation that stresses the BFP conversion: values (2j+1)/256
    with a ±1 per row and 128-group, so x·2^7/2^e ends in .5 (bf16 holds
    them exactly), and an all-zero group in row 0 where K allows."""
    j = torch.randint(-128, 128, (M, K), generator=g, device=dev)
    x = (2 * j + 1).float() / 256
    x[:, ::128] = 1.0
    if K > 128:
        x[0, 128:256] = 0.0
    return x.to(dt)


def ragged_int4(torch, dev, g, dt, M, K, F, glu, G, pow2, pro, epi):
    """One int4 fused-linear call off the main shapes on the route
    ``plan_int4`` picks, against the plain version in the route's order
    (``int4_call``)."""
    N = 2 * F if glu else F
    codes, scale, _, _ = int4_weight(torch, dev, g, K, N, G, pow2)
    _, kw = linear_inputs(torch, dev, g, M, K, F, glu, pro, epi)
    x = bfp_ties(torch, dev, g, M, K, dt)
    if pro:
        kw["mean_sq"] = 0.5 + torch.rand((M,), generator=g, device=dev)
    cast, _ = _cast(torch, kw, dt)
    return int4_call(torch, x, codes, scale, cast, f"ragged "
                     f"fused_linear_int4 M={M} K={K} F={F} G={G} {dt}")[0]


def int4_refusals(torch, dev):
    """The int4 C entries refuse a plan that disagrees with the source: a
    tile, group split, split count or grid it has no instantiation of, or
    one entry of mantissa, step or Σy² scratch short of what the grid
    writes, returns cudaErrorInvalidValue and the wrapper raises, on both
    routes."""
    from repro_torch.kernels import fused_linear as fl
    refused = {}
    K, F, G = 256, 128, 128
    codes = torch.zeros((K, F), dtype=torch.int8, device=dev)
    scale = torch.ones((K // G, F), dtype=torch.float32, device=dev)
    for M in (37, 4):
        x = torch.zeros((M, K), dtype=torch.bfloat16, device=dev)
        p = fl.plan_int4(M, K, F, G, K // G, False, torch.bfloat16)
        rep = dataclasses.replace
        bad = {"tile_m": rep(p, tile_m=p.tile_m // 2),
               "tile_n": rep(p, tile_n=p.tile_n // 2),
               "grid": rep(p, grid=(p.grid[0] + 1, p.grid[1])),
               "sq_part": rep(p, sq_part=p.sq_part - 1)}
        if p.route == "tc":
            bad.update(group_split=rep(p, group_split=1),
                       mant=rep(p, mant=p.mant - 1),
                       steps=rep(p, steps=p.steps - 1))
        else:
            bad.update(group_split=rep(p, group_split=p.group_split + 1),
                       splits=rep(p, splits=p.splits + 1))
        for what, q in bad.items():
            try:
                fl.run_plan_int4(q, x, codes, scale, emit_sq=True)
            except RuntimeError as e:
                refused[f"{p.route} {what}"] = str(e)
                continue
            raise RuntimeError(f"int4 {p.route}: a plan with {what} off "
                               "the source was not refused")
    torch.cuda.synchronize()
    return refused


# paged attention off the main shape: B, Hkv, G, dh, ps, J and the history
# (``ragged_paged``).  bf16 q takes the split walk for all but the last (G
# 32, the SIMT kernel); among them G 8 and 16, Hkv 6 over head groups of 4
# and Hkv 3 over groups of 2 (a short last group), 3 admitted entries over
# 8 blocks (n < S), every admitted entry in the first block's slice, an
# empty history, and a 40960-entry row, two windows of 8 slices of 4096
# (~24600 admitted, rounds of 1024 listed rows); fp32 q takes the SIMT
# kernel for all.
PAGED_RAGGED = ((3, 2, 2, 64, 16, 5, "random"), (2, 1, 4, 32, 8, 7, "random"),
                (2, 2, 4, 64, 4, 3, "empty"), (1, 3, 1, 32, 5, 9, "random"),
                (2, 2, 8, 128, 16, 40, "random"),
                (2, 1, 16, 64, 16, 64, "random"),
                (16, 6, 2, 64, 16, 128, "random"),
                (16, 3, 1, 32, 16, 128, "random"),
                (1, 2, 1, 128, 16, 128, "few"),
                (2, 4, 1, 128, 16, 128, "front"),
                (1, 1, 4, 64, 16, 2560, "random"),
                (1, 1, 32, 64, 8, 5, "random"))


def ragged_history(torch, dev, g, B, E, kind, qp):
    """Effective positions [B, E] below qp: "random" 40 % masked; "empty"
    all masked; "few" 3 admitted entries in all; "front" only among the
    first 200 entries (40 % masked there)."""
    from repro_torch.kvcache import history
    masked = history.MASKED_POS
    eff = torch.randint(0, qp, (B, E), generator=g, device=dev,
                        dtype=torch.int32)
    if kind == "random":
        eff[torch.rand((B, E), generator=g, device=dev) < 0.4] = masked
    elif kind == "empty":
        eff.fill_(masked)
    elif kind == "few":
        keep = torch.randperm(B * E, generator=g, device=dev)[:3]
        flat = torch.full((B * E,), masked, dtype=torch.int32, device=dev)
        flat[keep] = eff.reshape(-1)[keep]
        eff = flat.reshape(B, E)
    elif kind == "front":
        eff[torch.rand((B, E), generator=g, device=dev) < 0.4] = masked
        eff[:, 200:] = masked
    return eff


def ragged_paged(torch, dev, g, dt, kd, B, Hkv, G, dh, ps, J, kind, P=64,
                 qp=20):
    """One paged-attention call off the main shapes on its route against
    its plain version (``paged_call``): random pages and block tables
    (all-zero for an empty history), effective positions as
    ``ragged_history`` makes them."""
    from repro_torch.kvcache import paged
    rnd = lambda *sh: torch.randn(sh, generator=g, device=dev)   # noqa
    q, kt, vt = rnd(B, 1, G * Hkv, dh), rnd(B, 1, Hkv, dh), rnd(B, 1, Hkv, dh)
    kp, vp = rnd(P, ps, Hkv, dh), rnd(P, ps, Hkv, dh)
    kw = {}
    if kd is None:
        kp, vp = kp.to(dt), vp.to(dt)
    else:
        kp, vp, ks, vs = paged.quantize_entries(kp, vp, kd)
        kw = {"k_scales": ks, "v_scales": vs}
    if kind == "empty":
        bt = torch.zeros((B, J), dtype=torch.int32, device=dev)
    else:
        bt = torch.randint(0, P, (B, J), generator=g, device=dev,
                           dtype=torch.int32)
    eff = ragged_history(torch, dev, g, B, J * ps, kind, qp)
    qpos = torch.full((B, 1), qp, dtype=torch.int32, device=dev)
    a = (q.to(dt), kp, vp, bt, eff, kt.to(dt), vt.to(dt))
    rec = paged_call(torch, a, qpos, kw, kd, 1.0 / math.sqrt(dh),
                     f"ragged paged B={B} Hkv={Hkv} G={G} dh={dh} ps={ps} "
                     f"J={J} {kind} {kd} {dt}")
    rec["admitted"] = int((eff <= qp).sum().item())
    return rec


def paged_refusals(torch, dev):
    """Paged attention's C entries refuse a plan that disagrees with the
    source: more kv-heads per block than warps, a tile, ring depth, split,
    grid or shared-memory size it has no instantiation of, rows the SIMT
    kernel does not take, or the split walk for fp32 q, returns
    cudaErrorInvalidValue and the wrapper raises, on both routes."""
    from repro_torch.kernels import paged_attention as pa
    refused = {}
    B, Hkv, G, dh, ps, J, P = 2, 4, 2, 64, 16, 32, 8
    kp = torch.zeros((P, ps, Hkv, dh), dtype=torch.bfloat16, device=dev)
    bt = torch.zeros((B, J), dtype=torch.int32, device=dev)
    eff = torch.zeros((B, J * ps), dtype=torch.int32, device=dev)
    tok = torch.zeros((B, 1, Hkv, dh), dtype=torch.bfloat16, device=dev)
    qpos = torch.ones((B, 1), dtype=torch.int32, device=dev)
    rep = dataclasses.replace
    for dt in (torch.bfloat16, torch.float32):
        q = torch.zeros((B, 1, Hkv * G, dh), dtype=dt, device=dev)
        pages = kp.to(dt)
        p = pa.plan(B, Hkv, G, dh, J * ps, None, dt)
        bad = {"tile": rep(p, tile=p.tile * 2),
               "grid": rep(p, grid=(p.grid[0] + 1, p.grid[1])),
               "smem": rep(p, smem=p.smem + 16)}
        if p.route == "split":
            bad.update(
                heads=rep(p, heads=2 * pa.SPLIT_WARPS,
                          tile=pa.SPLIT_SUB // 2,
                          grid=(p.grid[0],
                                B * -(-Hkv // (2 * pa.SPLIT_WARPS)))),
                stages=rep(p, stages=pa.SPLIT_MAX_STAGES + 1,
                           smem=pa.split_smem(None, p.heads, dh,
                                              pa.SPLIT_MAX_STAGES + 1)),
                splits=rep(p, splits=pa.SPLIT_MAX_S + 1,
                           grid=(pa.SPLIT_MAX_S + 1, p.grid[1])),
                rows=rep(p, rows=8))
        else:
            bad.update(rows=rep(p, rows=2, grid=(p.grid[0], -(-G // 2))),
                       split=pa.plan(B, Hkv, G, dh, J * ps, None,
                                     torch.bfloat16))
        for what, bp in bad.items():
            try:
                pa.run_plan(bp, q, pages, pages, bt, eff, tok.to(dt),
                            tok.to(dt), qpos, scale=0.125)
            except RuntimeError as e:
                refused[f"{p.route} {what}"] = str(e)
                continue
            raise RuntimeError(f"paged_attention {p.route}: a plan with "
                               f"{what} off the source was not refused")
    torch.cuda.synchronize()
    return refused


def ssd_refusals(torch, dev):
    """The SSD scan's C entries refuse a plan that disagrees with the
    source: a P slice it has no instantiation of or that does not divide
    P, a grid, thread count, stage count or shared-memory size other than
    the plan's, the SIMT kernel with a P split, or the tensor-core route
    for fp32 inputs, returns cudaErrorInvalidValue and the wrapper raises,
    on both routes."""
    from repro_torch.kernels import ssd_scan as ss
    refused = {}
    B, T, H, P, N, G, Q = 2, 40, 4, 64, 128, 1, 32
    rep = dataclasses.replace
    for dt in (torch.bfloat16, torch.float32):
        args = (torch.zeros((B, T, H, P), dtype=dt, device=dev),
                torch.zeros((B, T, H), device=dev), torch.zeros(H, device=dev),
                torch.zeros((B, T, G, N), dtype=dt, device=dev),
                torch.zeros((B, T, G, N), dtype=dt, device=dev))
        p = ss.plan(B, T, H, P, N, G, Q, dt)
        bad = {"grid": rep(p, grid=(p.grid[0] + 1, p.grid[1])),
               "threads": rep(p, threads=128),
               "stages": rep(p, stages=p.stages + 1),
               "smem": rep(p, smem=p.smem + 16)}
        if p.route == "tc":
            bad.update(
                pb16=rep(p, pb=16, grid=(B * H, 4), smem=ss.tc_smem(Q, N, 16)),
                pb32=rep(p, pb=32, grid=(B * H, 2), smem=ss.tc_smem(Q, N, 32)),
                pb128=rep(p, pb=128, grid=(B * H, 1),
                          smem=ss.tc_smem(Q, N, 128)))
        else:
            bad.update(pb=rep(p, pb=P // 2, grid=(B * H, 2)),
                       tc=ss.plan(B, T, H, P, N, G, Q, torch.bfloat16))
        for what, bp in bad.items():
            try:
                ss.run_plan(bp, *args, Q)
            except RuntimeError as e:
                refused[f"{p.route} {what}"] = str(e)
                continue
            raise RuntimeError(f"ssd_scan {p.route}: a plan with {what} off "
                               "the source was not refused")
    torch.cuda.synchronize()
    return refused


# ---------------------------------------------------------------------------
# Phase 4: CPU (plain versions) ≡ CUDA (kernels) on llama2-7b smoke, fp32
# ---------------------------------------------------------------------------

def _forced_run(model, toks, forced):
    import torch
    T = toks.shape[1]
    steps = forced.shape[1]
    lg, cache, st = model.prefill(toks, pad_to=T + steps)
    logits, gates = [lg.float().cpu()], [st["attn_gate"].cpu()]
    for s in range(steps):
        lg, cache, st = model.decode_step(cache, forced[:, s:s + 1], T + s)
        logits.append(lg.float().cpu())
        gates.append(st["attn_gate"].cpu())
    return logits, gates


def _forced_paged(model, prompts, forced, ps=8, num_pages=32,
                  cap_tokens=64):
    """Prefill each prompt into a paged store (the port's pack_prefill),
    then teacher-forced paged decode steps.  Returns (logits, gate logs)."""
    import torch
    from repro_torch.kvcache import paged
    cfg, dev = model.cfg, model.device
    nA, S = cfg.num_layers, len(prompts)
    store = paged.init_store(cfg, num_pages, ps, device=dev)
    alloc = paged.PageAllocator(num_pages, ps, S,
                                slot_entry_capacity=cap_tokens * nA)
    logits, gates = [], []
    for i, p in enumerate(prompts):
        lg, cache, st = model.prefill(torch.as_tensor(p[None]))
        g = st["attn_gate"][:, 0]
        gates.append(g.cpu())
        logits.append(lg.float().cpu())
        n = paged.prefill_entry_count(g.cpu().numpy(), len(p), True)
        require(alloc.ensure(i, n + nA), "parity store too small")
        paged.pack_prefill(store, cache, g, len(p),
                           torch.as_tensor(alloc.block_table[i], device=dev),
                           cfg)
        alloc.append(i, n, nA * len(p))
    t = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    for s in range(forced.shape[1]):
        for i in range(S):
            require(alloc.ensure(i, int(alloc.fill[i]) + nA),
                    "parity store too small")
        lg, store, st = model.paged_decode_step(
            store, forced[:, s:s + 1], t, torch.as_tensor(alloc.block_table),
            torch.as_tensor(alloc.fill))
        g = st["attn_gate"].cpu()
        gates.append(g)
        logits.append(lg.float().cpu())
        for i in range(S):
            alloc.append(i, int(1 + g[1:, i].sum()), nA)
        t = t + 1
    return logits, gates


def _paged_engine(model, prompts, new):
    """The paged continuous engine on ``prompts``, its first request's
    tokens streamed (``RequestHandle.tokens()``) before ``run()`` drains
    the rest.  Returns (results, stats, registry, streamed tokens)."""
    from repro_torch.serve.engine import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, max_slots=2, max_len=48,
                                   kv_mode="paged", page_size=8)
    hs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    streamed = [int(t) for t, _ in hs[0].tokens()]
    out = eng.run()
    eng.allocator.check_conservation()
    require(eng.allocator.free_pages == eng.num_pages, "pages leaked")
    return ([out["results"][int(h)] for h in hs], out["stats"],
            out["metrics"], streamed)


def parity(torch, np, dev, int4=False):
    """CPU ≡ CUDA on the fp32 smoke model; with ``int4`` every linear and
    the lm head hold int4 codes (group 64, so the smoke widths make
    several groups; the 4096-element floor lets every smoke linear in)."""
    from repro_torch.configs import get_config
    from repro_torch.core import routing
    from repro_torch.kernels import ops
    from repro_torch.models.model import LanguageModel, init_params
    from repro_torch.quant import quantize_params
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(get_config("llama2-7b").smoke(),
                              dtype="float32")
    params = routing.neutral_router_bias(
        init_params(cfg, torch.Generator().manual_seed(PARITY_SEED), "cpu"))
    for blk in params["blocks"]:            # routers at unit scale, so no
        for sub in blk.values():            # gate sits near the strict-`>`
            sub["router"]["w"] = sub["router"]["w"] * 50.0   # tie
    if int4:
        params = quantize_params(params, 64, True, min_size=1 << 12)
    rng = np.random.default_rng(PARITY_SEED)
    m_cpu = LanguageModel(cfg, params, device="cpu")
    m_gpu = LanguageModel(cfg, params, device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 24)))
    forced = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 3)))

    margins = []
    orig = routing.gate_from_logits

    def recording(logits):
        margins.append((logits[..., 1] - logits[..., 0]).abs().min().item())
        return orig(logits)

    routing.gate_from_logits = recording
    try:
        lc, gc = _forced_run(m_cpu, toks, forced)
    finally:
        routing.gate_from_logits = orig
    require(min(margins) >= MIN_MARGIN,
            f"gate margin {min(margins)} < {MIN_MARGIN}: pick another seed")
    lg, gg = _forced_run(m_gpu, toks, forced)
    for a, b in zip(gc, gg):
        require(torch.equal(a, b), "gate log differs between cpu and cuda")
    worst = 0.0
    for a, b in zip(lc, lg):
        d = (a - b).abs().max().item() / a.abs().max().item()
        worst = max(worst, d)
        require(d <= TOL_LOGITS, f"logits differ: {d} > {TOL_LOGITS}")
        require(torch.equal(a.argmax(-1), b.argmax(-1)),
                "greedy tokens differ between cpu and cuda")
    prompts = rng.integers(0, cfg.vocab_size, (2, 24))
    oc = ServeEngine(m_cpu, max_len=32).generate(prompts, 8)
    ops.reset_kernel_launches()
    og = ServeEngine(m_gpu, max_len=32).generate(prompts, 8)
    launches = ops.kernel_launches()
    expected = expected_launches(m_gpu, [prompts.shape], 8, prompts.shape[0])
    require(launches == expected, f"parity launches {launches} != expected "
            f"{expected}")
    require(np.array_equal(oc["tokens"], og["tokens"]),
            "ServeEngine tokens differ between cpu and cuda")
    require(oc["stats"].kv_saved_fraction == og["stats"].kv_saved_fraction,
            "kv_saved_fraction differs between cpu and cuda")
    gates = torch.cat([g.flatten() for g in gc])
    lock_margin = min(margins)

    # the paged path: teacher-forced paged decode steps, then the
    # continuous engine over the paged store, mixed prompt lengths
    ppr = [rng.integers(0, cfg.vocab_size, (n,)) for n in (9, 16, 5, 21)]
    pforced = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 3)))
    margins.clear()
    routing.gate_from_logits = recording
    try:
        plc, pgc = _forced_paged(m_cpu, ppr[:2], pforced)
        rc, sc, mc, stc = _paged_engine(m_cpu, ppr, 6)
    finally:
        routing.gate_from_logits = orig
    require(min(margins) >= MIN_MARGIN,
            f"paged gate margin {min(margins)} < {MIN_MARGIN}")
    plg, pgg = _forced_paged(m_gpu, ppr[:2], pforced)
    for a, b in zip(pgc, pgg):
        require(torch.equal(a, b), "paged gate log differs (cpu/cuda)")
    pworst = 0.0
    for a, b in zip(plc, plg):
        d = (a - b).abs().max().item() / a.abs().max().item()
        pworst = max(pworst, d)
        require(d <= TOL_LOGITS, f"paged logits differ: {d} > {TOL_LOGITS}")
        require(torch.equal(a.argmax(-1), b.argmax(-1)),
                "paged greedy tokens differ between cpu and cuda")
    rg, sg, mg, stg = _paged_engine(m_gpu, ppr, 6)
    require(count_metrics(mc) == count_metrics(mg),
            "paged engine registries differ between cpu and cuda")
    require(stc == stg == rc[0].tokens.tolist(),
            "streamed tokens differ between cpu and cuda or from run()")
    for a, b in zip(rc, rg):
        require(np.array_equal(a.tokens, b.tokens)
                and (a.kv_stored, a.kv_dense) == (b.kv_stored, b.kv_dense),
                "paged engine tokens or gate accounting differ (cpu/cuda)")
    for f in ("kv_entries_stored", "kv_entries_dense", "history_hit_rate",
              "history_hits_per_layer", "pages_peak", "attn_keep_frac"):
        require(getattr(sc, f) == getattr(sg, f),
                f"paged engine {f} differs between cpu and cuda")
    return {"phase": "parity_int4" if int4 else "parity", "config": cfg.name,
            "dtype": cfg.dtype, "int4_weights": int4,
            "gates_identical": True, "logits_max_rel_diff": worst,
            "tol": TOL_LOGITS, "greedy_tokens_identical": True,
            "serve_tokens_identical": True, "serve_launches": launches,
            "min_gate_margin": lock_margin,
            "gate_ones_frac": gates.mean().item(),
            "kv_saved_fraction": og["stats"].kv_saved_fraction,
            "paged_gates_identical": True,
            "paged_min_gate_margin": min(margins),
            "paged_logits_max_rel_diff": pworst,
            "paged_engine_tokens_identical": True,
            "paged_engine_registry_identical": True,
            "paged_engine_streamed_tokens": len(stg),
            "paged_kv_entries_saved_fraction": sg.kv_entries_saved_fraction,
            "paged_history_hit_rate": sg.history_hit_rate}


# ---------------------------------------------------------------------------
# Phase 5: full-width llama2-7b served by the lock-step engine
# ---------------------------------------------------------------------------

# The depth at which phases 5-17 serve llama2-7b (full widths; 16 of its 32
# layers) and phase 19 stablelm-3b (16 of 32): their eager loops are
# host-bound, so the whole script's time follows the host's speed, and at
# full depth a slow host took past the script's 1200 s.
LLAMA_LAYERS = 16
STABLE_LAYERS = 16


def full_width_model(torch, dev):
    """llama2-7b at its published widths in bf16, cut to LLAMA_LAYERS
    layers, seed-0 random weights, router biases zeroed so routing really
    skips."""
    from repro_torch.configs import get_config
    from repro_torch.core.routing import neutral_router_bias
    from repro_torch.models.model import LanguageModel
    cfg = dataclasses.replace(get_config("llama2-7b"),
                              num_layers=LLAMA_LAYERS)
    t = time.perf_counter()
    model = LanguageModel(cfg, device=dev, seed=0)
    model = LanguageModel(cfg, neutral_router_bias(model.params()),
                          device=dev)
    torch.cuda.synchronize(dev)
    return model, time.perf_counter() - t


def expected_launches(model, prefills, n_st: int, step_rows: int,
                      paged: bool = False):
    """Exact kernel launches of one prefill per entry of ``prefills`` (its
    tokens' shape (B, T), or (B, C, Tk) for a chunk of C tokens over a
    staging cache of Tk rows) and n_st decode steps of ``step_rows`` rows: one
    router_stats per forward (later blocks take Σy² from the epilogue), four
    fused linears per layer (the int4 kernel for int4 weights), the lm head
    through the int4 matmul for int4 weights (else a plain matmul), and
    one attention per layer: flash, or paged attention for a paged step.
    A LayerNorm stack (stablelm-3b) runs the unfused path: no router_stats
    and no fused linear (bf16 linears are plain matmuls), and with int4
    weights its four linears a layer go through the int4 matmul, by
    route as the lm head's.  The dense fused linears also by route, as ``fl.plan`` picks it from a
    forward's rows and the dtype: bf16 prefills above SPLITKV_MAX_M rows on
    the tensor-core tile, decode steps (and prefills of at most that many
    rows) on the split-K stream, fp32 on the SIMT kernel.  Flash attention
    by route too, as ``fa.plan`` picks it from the packed rows G·T of one
    (batch, kv-head) and the dtype: bf16 prefills above SPLITKV_MAX_R rows
    on the tensor-core tile, decode steps (G rows) and shorter prefills on
    the split-KV walk, fp32 on the SIMT kernel.  The int4 fused linears
    and the lm head by route too, as ``fl.plan_int4`` picks it from a
    forward's rows (the lm head's: its batch): above INT4_STREAM_MAX_M on
    the tensor-core tile, else on the split-K stream.  Paged attention by
    route too, as ``pa.plan`` picks it from the dtype and G: bf16 on the
    split walk, fp32 on the SIMT kernel.  A Mamba stack: one
    router_stats per layer and forward (no block emits the Σy² carry), one
    SSD scan per layer and prefill (decode steps run the plain
    recurrence), nothing else; the scans by route too, as ``ss.plan``
    picks it from the prefill's shape and the dtype: bf16 on the
    tensor-core route, fp32 on the SIMT kernel.  Gather mode (an exact
    prefill (B, T) with C = ``capacity(T, keep_prob)``): the first layer's
    wqkv projects all B·T rows (the dense KV base case), the other 4·L − 1
    linears the B·C gathered rows, and flash packs G·C rows over T keys;
    decode steps are masked in either mode.  An MoE FFN (grok-1-314b,
    arctic-480b) runs on the unfused branch: no fused linear of its own
    (its experts are ``torch.bmm``) and no Σy² carry, so the next
    attention block launches router_stats itself (a router pass per
    attention block after an MoE one), two fused linears a layer (wqkv,
    wo); Arctic's dense residual MLP is two plain matmuls, or with int4
    weights two int4 matmuls a layer at the FFN's rows."""
    from repro_torch.core import routing
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_linear as fl
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import layers, transformer
    cfg = model.cfg
    L, n_pf = cfg.num_layers, len(prefills)
    fwd = n_pf + n_st
    routes = {f"fused_linear_{r}": 0 for r in ("wgmma", "splitk", "simt")}
    routes.update({f"flash_attention_{r}": 0
                   for r in ("wgmma", "splitkv", "simt")})
    routes.update({f"{k}_{r}": 0 for k in ("fused_linear_int4", "int4_matmul")
                   for r in ("tc", "stream")})
    routes.update({f"paged_attention_{r}": 0 for r in ("split", "simt")})
    routes.update({f"ssd_scan_{r}": 0 for r in ("tc", "simt")})
    dt, D = layers.torch_dtype(cfg), cfg.d_model
    if transformer.is_ssm_stack(cfg):
        for b, t in prefills:          # exact-length prefills, no chunks
            routes["ssd_scan_" + ss.plan(
                b, t, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                cfg.ssm_groups, cfg.ssm_chunk, dt).route] += L
        return {"router_stats": L * fwd, "fused_linear": 0,
                "fused_linear_int4": 0, "int4_matmul": 0,
                "flash_attention": 0, "paged_attention": 0,
                "ssd_scan": L * n_pf, **routes}
    from repro_torch.quant import int4_head, int4_linears
    p = model.params()
    int4, head4 = int4_linears(p), int4_head(p)
    fuse = layers.fuse_norm_linear(cfg)
    Hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    G = cfg.num_heads // Hkv
    gather = transformer.is_gather(cfg)
    moe = [cfg.is_moe_layer(i) for i in range(L)]
    n_lin = 4 * L - 2 * sum(moe)        # an MoE FFN runs no fused linear
    routers = 1 + sum(moe[:-1])         # no carry after an MoE block
    n_res = 2 * sum(moe) if cfg.dense_residual and int4 else 0

    def prefill_forward(e):     # ({rows: linears}, batch, R, keys, FFN rows)
        b, t = e[0], e[1]
        c = routing.capacity(t, cfg.skip.keep_prob) \
            if gather and len(e) == 2 else t
        if c == t:
            return {b * t: n_lin}, b, G * t, e[-1], b * t
        return {b * t: 1, b * c: n_lin - 1}, b, G * c, e[-1], b * c

    forwards = [prefill_forward(e) for e in prefills]
    forwards += [({step_rows: n_lin}, step_rows, G, MAX_LEN,
                  step_rows)] * n_st
    if int4:
        lin = model.params()["blocks"][0]["mixer"]["inner"]["wo"]
        lm = model.params()["lm_head"] if head4 else lin
        C = lm["scale"].shape[0]
        Kw, V = lm["w_int"].shape

        def int4_route(rows):      # the route is the rows' alone
            return fl.plan_int4(rows, D, V, Kw // C, C, False, dt).route

    lin4 = "fused_linear_int4" if fuse else "int4_matmul"
    for i, (rows, b, R, Tk, ffn_rows) in enumerate(forwards):
        for m, n in rows.items():
            if int4:
                routes[f"{lin4}_" + int4_route(m)] += n
            elif fuse:
                routes["fused_linear_" + fl.plan(m, D, D, False,
                                                 dt).route] += n
        if n_res:
            routes["int4_matmul_" + int4_route(ffn_rows)] += n_res
        if head4:
            routes["int4_matmul_" + int4_route(b)] += 1
        if i < n_pf or not paged:
            routes["flash_attention_" + fa.plan(b * Hkv, R, Tk, dh,
                                                dt).route] += L
        else:       # the route takes q's dtype and G alone
            routes["paged_attention_" + pa.plan(b, Hkv, G, dh, Tk, None,
                                                dt).route] += L
    return {"router_stats": routers * fwd if fuse else 0, "ssd_scan": 0,
            "fused_linear": n_lin * fwd if fuse and not int4 else 0,
            "fused_linear_int4": n_lin * fwd if fuse and int4 else 0,
            "int4_matmul": (fwd if head4 else 0) + n_res * fwd + (
                4 * L * fwd if int4 and not fuse else 0),
            "flash_attention": L * (n_pf if paged else fwd),
            "paged_attention": L * n_st if paged else 0, **routes}


def serve_full_width(torch, np, dev, model, init_s, phase="serve", B=4,
                     T0=512, new=32):
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeEngine
    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats(dev)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T0))
    eng = ServeEngine(model, max_len=T0 + new)

    ops.reset_kernel_launches()
    out = eng.generate(prompts, new)
    launches = ops.kernel_launches()
    s = out["stats"]
    expected = expected_launches(model, [(B, T0)], new, B)
    require(launches == expected,
            f"kernel launches {launches} != expected {expected}")
    require(0.0 < s.attn_keep_frac < 1.0,
            f"keep fraction {s.attn_keep_frac} not strictly inside (0, 1)")
    # logits of the same weights on the served tokens: finite everywhere
    with torch.no_grad():
        toks = torch.as_tensor(np.concatenate(
            [prompts, out["tokens"][:, :1]], axis=1), device=dev)
        lg, cache, _ = model.prefill(toks[:, :T0], pad_to=T0 + 1)
        lg2, _, _ = model.decode_step(cache, toks[:, T0:], T0)
        finite = bool(torch.isfinite(lg).all() and torch.isfinite(lg2).all())
    require(finite, "non-finite logits at full width")
    return {"phase": phase, "config": cfg.name, "dtype": cfg.dtype,
            "batch": B, "prompt_len": T0, "new_tokens": new,
            "init_s": init_s, "prefill_s": s.prefill_s,
            "decode_s": s.decode_s, "decode_tok_per_s": s.decode_tok_per_s,
            "decode_only_tok_per_s": (s.decode_tokens - B) / s.decode_s,
            "decode_steps_per_s": new / s.decode_s,
            "attn_keep_frac": s.attn_keep_frac,
            "kv_saved_fraction": s.kv_saved_fraction,
            "kv_saved_analytic": s.kv_saved_analytic,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "launches": launches, "logits_finite": finite,
            "sample_tokens": out["tokens"][0, :8].tolist()}, launches, \
        out["tokens"]


# ---------------------------------------------------------------------------
# Phase 6: full-width llama2-7b served by the continuous-batching engine
# ---------------------------------------------------------------------------

SLOTS, MAX_LEN, PAGE = 4, 544, 16


class FiniteLogits:
    """Wraps the engine's sampler so every logits tensor it samples from is
    checked finite on the device (no extra host sync)."""

    def __init__(self, torch, dev):
        from repro_torch.serve import engine
        self.torch, self.dev, self.engine = torch, dev, engine
        self.orig = engine.sample

    def __enter__(self):
        def checked(logits, generator=None, temperature=0.0):
            # in place: a CUDA graph of a decode iteration captures this
            # write, so every replay adds its logits to the same flag
            self.all &= self.torch.isfinite(logits).all()
            return self.orig(logits, generator, temperature)
        self.engine.sample = checked
        return self

    def __exit__(self, *exc):
        self.engine.sample = self.orig

    def reset(self):
        self.all = self.torch.ones((), dtype=self.torch.bool, device=self.dev)


def serve_continuous(torch, dev, model, finite, label, prompts, new,
                     log=None, trace=True, max_len=MAX_LEN, **kw):
    """One ContinuousBatchingEngine run (4 slots, max_len 544, page 16) with
    exact launch counts (each prefill and each prefill chunk by its shape),
    every request completed, finite logits and, paged,
    page conservation with no page in use at the end.  ``log`` (a dict)
    receives each request's prompt gate log [L, T0] and decode gate
    columns (``gates``: {uid: (prompt, [L] per step)}); ``trace=False`` leaves out a fused run's traced epoch
    (phase 12's fused runs: phase 11 traces the same decode iteration).
    With
    ``decode_steps``
    > 1 (fused epochs, CUDA graphs): the wrappers count the prefills' and
    the eager warm-up iterations' launches (exact, as in single-step runs),
    at most one capture for the dense pool and one per block-table width
    ``j_step`` can take for the paged store, every iteration past a
    capture's warm-up a replay, the capture deltas × replays (derived)
    equal to the replayed iterations' expected launches, on the dense pool
    no host sync in the deferred prefills, and after the run one more
    epoch of the run's last graph traced a replay at a time: each
    replay's port kernels, counted by name in its device trace, must
    equal its capture delta (``trace_epoch``).  Returns (record,
    per-request tokens, the wrappers' launches)."""
    from repro_torch.kvcache import paged
    from repro_torch.models import layers, ssm, transformer
    from repro_torch.serve.engine import ContinuousBatchingEngine
    cfg, L = model.cfg, model.cfg.num_layers
    eng = ContinuousBatchingEngine(model, max_slots=SLOTS, max_len=max_len,
                                   page_size=PAGE, **kw)
    uids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    seen = {}
    if eng.decode_steps > 1:
        # a preemption storm (the reference's youngest-other policy can
        # evict two residents in turn forever) fails here, not at the limit
        epochs, process = [0], eng._process_epoch

        def guarded(*a, **k):
            epochs[0] += 1
            require(epochs[0] <= 4 * new * len(prompts),
                    f"{label}: {epochs[0]} epochs, no end in sight")
            return process(*a, **k)

        eng._process_epoch = guarded
        if eng.kv_mode == "dense":
            eng._prefill_work_dense = unsynced_prefill(
                torch, eng._prefill_work_dense, seen)
    if log is not None:
        watch_engine(eng, log)
    finite.reset()
    if eng.spec_k:
        name = spec_watch(torch, model, eng, finite, seen)
    try:
        out, rows, launches, wall, derived = counted_run(
            torch, dev, model, eng, label, seen)
    finally:
        if eng.spec_k:
            delattr(model, name)
    s = out["stats"]
    n_pf, n_st = s.prefill_chunks, s.decode_iterations
    paged_run = eng.kv_mode == "paged"
    graph_rec = {}
    if derived is not None:
        graph_rec = {"graph_launches_derived": derived}
        if eng.kv_mode == "dense" and eng.decode_steps > 1:
            require(seen.get("deferred", 0) >= 1 and not seen["syncs"],
                    f"{label}: {seen.get('syncs')} host syncs in "
                    f"{seen.get('deferred')} deferred prefills")
            graph_rec.update(deferred_prefills=seen["deferred"],
                             deferred_prefill_syncs=seen["syncs"])
    res = [out["results"][u] for u in uids]
    require(s.requests_completed == len(prompts) and all(
        r.finish_reason == "length" and r.decode_tokens == new
        for r in res), f"{label}: not every request completed")
    require(bool(finite.all.item()), f"{label}: non-finite logits")
    esize = torch.empty((), dtype=layers.torch_dtype(cfg)).element_size()
    if transformer.is_ssm_stack(cfg):       # conv histories + fp32 state
        dense_bytes = SLOTS * L * (
            (cfg.ssm_conv - 1) * ssm.conv_dim(cfg) * esize
            + cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4)
    else:       # a LOCAL layer's ring: min(W, max_len) rows
        rows = sum(min(cfg.window_size, max_len)
                   if cfg.block_kind(i) == "local" and cfg.window_size
                   else max_len for i in range(L))
        dense_bytes = (SLOTS * rows * 2 * cfg.num_kv_heads
                       * cfg.resolved_head_dim * esize)
    # decode_tokens counts each request's first token, which prefill made
    rec = {"run": label, "dtype": cfg.dtype, "requests": len(prompts),
           "prefill_s": s.prefill_s, "prefill_tokens": s.prefill_tokens,
           "prefills": n_pf, "prefill_chunk": eng.prefill_chunk,
           "step_tokens": eng.step_tokens,
           "prefill_aborts": s.prefill_aborts,
           "prefill_deferrals": s.prefill_deferrals,
           "interleaved_steps": s.interleaved_steps, "decode_steps": n_st,
           "decode_dispatches": s.decode_dispatches,
           "steps_per_dispatch": eng.decode_steps,
           "graphs_captured": s.compiles, "graph_replays": s.graph_replays,
           "epoch_shrinks": s.epoch_shrinks, "host_s": s.host_s,
           "device_s": s.device_s, "decode_s": s.decode_s,
           "decode_tok_per_s": s.decode_tok_per_s,
           "decode_only_tok_per_s": (s.decode_tokens - n_pf) / s.decode_s,
           "decode_steps_per_s": n_st / s.decode_s,
           "wall_s": wall, "attn_keep_frac": s.attn_keep_frac,
           "kv_saved_fraction": s.kv_saved_fraction,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "dense_pool_bytes": dense_bytes, "launches": launches,
           **graph_rec}
    if paged_run:
        alloc = eng.allocator
        alloc.check_conservation()
        require(alloc.free_pages == eng.num_pages
                and alloc.stats.pages_in_use == 0,
                f"{label}: pages in use at the end")
        require(0.0 < s.kv_entries_saved_fraction < 1.0,
                f"{label}: kv_entries_saved_fraction "
                f"{s.kv_entries_saved_fraction}")
        page_bytes = PAGE * paged.entry_bytes(cfg, kw.get("kv_dtype"))
        rec.update(pages_peak=s.pages_peak, pages_total=s.pages_total,
                   page_bytes=page_bytes,
                   peak_page_bytes=s.pages_peak * page_bytes,
                   peak_over_dense=s.pages_peak * page_bytes / dense_bytes,
                   kv_entries_saved_fraction=s.kv_entries_saved_fraction,
                   kv_entries_stored=s.kv_entries_stored,
                   kv_entries_dense=s.kv_entries_dense,
                   history_hit_rate=s.history_hit_rate,
                   history_hits_per_layer=s.history_hits_per_layer,
                   preemptions=s.preemptions)
    if eng.decode_steps > 1:
        if trace:
            rec["traced_epoch"] = trace_epoch(torch, dev, label, seen["ep"],
                                              eng.decode_steps)
    if eng.spec_k:
        rec.update(spec_record(cfg, eng, s, seen["windows"], launches,
                               label))
    return rec, [r.tokens for r in res], launches


def counted_run(torch, dev, model, eng, label, seen, on_chunk=None):
    """``eng.run()`` with the wrappers' launches counted from 0 and the
    shape of each prefill (B, T) and chunk (B, C, staging rows) it runs
    recorded (``on_chunk`` sees each chunk's): one prefill seen for each
    counted; a fused run's captures bounded (one for the dense pool, one
    per block-table width for the paged store), every iteration past a
    capture's warm-up a replay, and the capture deltas × replays (derived;
    ``seen["ep"]`` gets the run's DecodeEpoch) equal to the replayed
    iterations' expected launches; the launches equal to the prefills' and
    the eagerly run decode iterations' (single-step: all of them; fused:
    each capture's warm-up).  Returns (the run's output, the shapes, the
    launches, wall seconds, the derived launches or None single-step)."""
    from repro_torch.kernels import ops
    if eng.decode_steps > 1:
        launch_epoch = eng._launch_epoch

        def kept(rs, ep, n):               # the run's DecodeEpoch
            seen["ep"] = ep
            return launch_epoch(rs, ep, n)

        eng._launch_epoch = kept
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    rows, prefill, chunk = [], model.prefill, model.prefill_chunk

    def recorded(toks, *a, **k):
        rows.append(tuple(toks.shape))
        return prefill(toks, *a, **k)

    def recorded_chunk(cache, toks, *a, **k):
        rows.append(tuple(toks.shape) + (cache[0]["k"].shape[1],))
        if on_chunk is not None:
            on_chunk(rows[-1])
        return chunk(cache, toks, *a, **k)

    model.prefill, model.prefill_chunk = recorded, recorded_chunk
    ops.reset_kernel_launches()
    t = time.perf_counter()
    try:
        out = eng.run()
    finally:
        del model.prefill, model.prefill_chunk
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t
    launches = ops.kernel_launches()
    s = out["stats"]
    n_st = s.decode_iterations
    require(len(rows) == s.prefill_chunks, f"{label}: {len(rows)} "
            f"prefills seen, {s.prefill_chunks} counted")
    paged_run, derived = eng.kv_mode == "paged", None
    if eng.spec_k:
        # speculative: each capture's eager warm-up and every verify
        # window, held one by one at the route its rows give
        wins = seen["windows"]
        drafted = sum(w["gamma"] for w in wins)
        cap = (len(table_widths(eng.allocator.pages_per_slot))
               if paged_run else 1)
        require((1 if drafted else 0) <= s.compiles <= cap,
                f"{label}: {s.compiles} draft graphs captured, want "
                f"{'1' if drafted else '0'}..{cap}")
        require(s.graph_replays == drafted - s.compiles,
                f"{label}: {s.graph_replays} replays of {drafted} draft "
                f"iterations and {s.compiles} captures")
        derived = seen["ep"].graph_launches() if drafted else {}
        want = expected_launches(model, [], s.graph_replays, SLOTS,
                                 paged_run)
        require(not drafted or derived == want, f"{label}: capture deltas "
                f"× replays {derived} != the replayed draft iterations' "
                f"{want}")
        expected = expected_launches(model, rows, s.compiles, SLOTS,
                                     paged_run)
        for i, w in enumerate(wins):
            want = verify_expected(model, *w["rows"], w["key_rows"])
            require(w["launches"] == want, f"{label}: verify window {i} "
                    f"of {w['rows']} over {w['key_rows']} key rows launched "
                    f"{w['launches']}, want {want}")
            _add(expected, want)
        require(launches == expected, f"{label}: kernel launches "
                f"{launches} != expected {expected}")
        return out, rows, launches, wall, derived
    if eng.decode_steps > 1:
        cap = (len(table_widths(eng.allocator.pages_per_slot))
               if paged_run else 1)
        require(1 <= s.compiles <= cap, f"{label}: {s.compiles} graphs "
                f"captured, want 1..{cap}")
        require(s.graph_replays == n_st - s.compiles,
                f"{label}: {s.graph_replays} replays of {n_st} iterations "
                f"and {s.compiles} captures (an iteration ran eagerly)")
        derived = seen["ep"].graph_launches()
        want = expected_launches(model, [], s.graph_replays, SLOTS,
                                 paged_run)
        require(derived == want, f"{label}: capture deltas × replays "
                f"{derived} != the replayed iterations' {want}")
        n_eager = s.compiles          # each capture's eager warm-up
    else:
        require(s.compiles == s.graph_replays == 0 and n_st == s.
                decode_dispatches, f"{label}: single-step run captured")
        n_eager = n_st
    expected = expected_launches(model, rows, n_eager, SLOTS, paged_run)
    require(launches == expected, f"{label}: kernel launches "
            f"{launches} != expected {expected}")
    return out, rows, launches, wall, derived


def watch_engine(eng, log):
    """Wrap ``eng`` so that ``log`` receives each request's prompt gate log
    [L, T0] and per decode step its gate column [L] (``gates``: {uid:
    [prompt, [columns]]})."""
    import numpy as np
    gates = log.setdefault("gates", {})
    account, advance = eng._account_prefill, eng._advance_slot

    def accounted(rs, st):
        g = st.pf_gates
        if g is not None:
            g = g.float().cpu().numpy() if hasattr(g, "cpu") else g
            gates.setdefault(st.req.uid, [None, []])[0] = np.asarray(
                g, np.float32)[:, :st.req.prompt_len]
        return account(rs, st)

    def advanced(rs, st, tok, g, *a):
        if g is not None:
            gates.setdefault(st.req.uid, [None, []])[1].append(
                np.asarray(g, np.float32).copy())
        return advance(rs, st, tok, g, *a)

    eng._account_prefill, eng._advance_slot = accounted, advanced


def token_agreement(np, a, b):
    """Share of equal tokens over requests, and per request the index of
    the first token that differs (len = none)."""
    eq = [x == y for x, y in zip(a, b)]
    return (float(np.concatenate(eq).mean()),
            [int(np.argmin(e)) if not e.all() else len(e) for e in eq])


def continuous_full_width(torch, np, dev, model):
    """8 requests (prompts of 128-512 tokens, seeded; 32 greedy tokens each)
    over 4 slots, max_len 544, in the dense pool, paged bf16 pages and
    paged int8 pages; then 4 short requests in paged bf16 pages twice, in
    the default pool and in one too small for all four residents, where
    preemption must leave every token unchanged."""
    from repro_torch.kvcache import paged
    cfg, new = model.cfg, 32
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 513, 8)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in lens]
    runs, tokens, total = [], {}, {}
    # the tight pool holds 10/7 of one request's worst case (every token
    # fresh at every layer); four residents at keep ≈ 0.5 need about twice
    # that (4 × (1 + 31 · 0.5) / 32 ≈ 2.06) before their 32 tokens are done
    short = [rng.integers(0, cfg.vocab_size, (16,)).astype(np.int32)
             for _ in range(4)]
    worst = -(-(16 + new - 1) * cfg.num_layers // PAGE)
    with FiniteLogits(torch, dev) as finite:
        for label, plist, kw in (
                ("dense", prompts, dict(kv_mode="dense")),
                ("paged_bf16", prompts, dict(kv_mode="paged")),
                ("paged_int8", prompts, dict(kv_mode="paged",
                                             kv_dtype="int8")),
                ("paged_int4", prompts, dict(kv_mode="paged",
                                             kv_dtype="int4")),
                ("short_paged_bf16", short, dict(kv_mode="paged")),
                ("short_paged_bf16_tight", short,
                 dict(kv_mode="paged", num_pages=worst * 10 // 7))):
            rec, toks, launches = serve_continuous(
                torch, dev, model, finite, label, plist, new, **kw)
            tokens[label] = toks
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            runs.append(rec)
    by = {r["run"]: r for r in runs}
    p0 = by["short_paged_bf16"]["preemptions"]
    p1 = by["short_paged_bf16_tight"]["preemptions"]
    require(p0 == 0 and p1 >= 1, f"preemptions {p0} (default pool), {p1} "
            "(tight pool): want 0 and >= 1")
    require(all(np.array_equal(a, b) for a, b in zip(
        tokens["short_paged_bf16"], tokens["short_paged_bf16_tight"])),
        "preemption changed the tokens of a request")
    # bf16 sums in another order flip near-tie gates and argmaxes of the
    # random model (phase 7 holds this against fp32): the share of equal
    # tokens and, per request, the first index that differs (32 = none)
    same, first = {}, {}
    for label in ("paged_bf16", "paged_int8", "paged_int4"):
        same[label], first[label] = token_agreement(
            np, tokens[label], tokens["dense"])
    return {"phase": "continuous", "config": cfg.name, "dtype": cfg.dtype,
            "slots": SLOTS, "max_len": MAX_LEN, "page_size": PAGE,
            "prompt_lens": lens.tolist(), "new_tokens": new, "runs": runs,
            "tokens_identical_to_dense": same,
            "first_divergence": first,
            "preempted_tokens_identical": True}, total, prompts, tokens, \
        (short, worst * 10 // 7)


# ---------------------------------------------------------------------------
# Phase 11: device-resident decode epochs (CUDA graphs of one iteration)
# ---------------------------------------------------------------------------

def table_widths(pages_per_slot: int) -> set:
    """The block-table widths the paged fused loop can load: power-of-two
    buckets of the live chain, clamped to pages_per_slot."""
    return {min(1 << k, pages_per_slot)
            for k in range(pages_per_slot.bit_length() + 1)}


def unsynced_prefill(torch, work, seen):
    """``ContinuousBatchingEngine._prefill_work_dense`` with its deferred
    calls (a fused dense run's prefills and prefill chunks: nothing read
    back, the first token left on the device) watched by
    ``torch.cuda.set_sync_debug_mode``: ``seen["syncs"]`` counts the host
    syncs they make, which would wait on the epoch in flight."""
    seen.setdefault("syncs", 0)

    def watched(rs, unit, pool, defer=False):
        if not defer:
            return work(rs, unit, pool)
        seen["deferred"] = seen.get("deferred", 0) + 1
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return work(rs, unit, pool, defer=True)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                seen["syncs"] += sum(
                    "called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)

    return watched


def trace_epoch(torch, dev, label, ep, n):
    """One more epoch of ``n`` replays of the run's last graph once the run
    is over (its times untouched; the slots are all finished, so nothing
    escapes), each replay in a torch.profiler session of its own: the
    port's kernels in a replay's device trace, counted by name, must equal
    the capture delta (``ops.DEVICE_KERNELS``), and no wrapper may launch.
    A trace can lose records: the first ones of a session (up to 228 of
    256 lead kernels of 1000 cycles; hence a lead of longer throwaway
    kernels) and, on a loaded host, a run of them in the middle of a long
    one (31 of an 8-replay epoch's 2312 port kernels, once).  A replay whose trace falls short of the delta and exceeds it
    nowhere is traced again, at most TRACE_ATTEMPTS times, and every short
    trace is reported; a count above the delta, or a replay short in
    every attempt, fails.  Returns the accepted traces' summed counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch.profile_decode import _kernel_times
    require(ep.captured(), f"{label}: the run's last width has no graph")
    before, t = ops.kernel_launches(), time.perf_counter()
    total, short, lead_min = {}, [], TRACE_LEAD_KERNELS
    for i in range(n):
        for attempt in range(TRACE_ATTEMPTS):
            g0 = ep.graph_launches()
            torch.cuda.synchronize(dev)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(TRACE_LEAD_KERNELS):
                    torch.cuda._sleep(TRACE_LEAD_CYCLES)
                ep.run(1)
                torch.cuda.synchronize(dev)
            replayed = {k: v - g0.get(k, 0)
                        for k, v in ep.graph_launches().items()}
            want = {k: v for k, v in ops.device_kernel_launches(
                replayed).items() if v}
            got, events, lead = {}, 0, 0
            for name, (_, cnt) in _kernel_times(prof).items():
                events += cnt
                lead += cnt if "spin_kernel" in name else 0
                kern = ops.device_kernel(name)
                if kern is not None:
                    got[kern] = got.get(kern, 0) + cnt
            if want and got == want:
                break
            over = [k for k in got if got[k] > want.get(k, 0)]
            if not want or over or attempt == TRACE_ATTEMPTS - 1:
                seq = sorted((e.time_range.start, e.name[:40])
                             for e in prof.events()
                             if e.device_type == DeviceType.CUDA)
                raise RuntimeError(
                    f"{label}: replay {i}'s traced kernels {got} != its "
                    f"capture delta {want} (attempt {attempt + 1} of "
                    f"{TRACE_ATTEMPTS}; {events} device kernels traced; "
                    f"first {seq[:4]}, last {seq[-4:]}; earlier short "
                    f"traces {short})")
            short.append({"replay": i, "traced": got, "events": events,
                          "lead_kernels_traced": lead})
        _add(total, got)
        lead_min = min(lead_min, lead)
    require(ops.kernel_launches() == before,
            f"{label}: a wrapper launched inside a replayed epoch")
    return {"replays": n, "device_kernels": total,
            "lead_kernels_traced_min": lead_min, "short_traces": short,
            "seconds": time.perf_counter() - t}


FUSED_STEPS = 8
TRACE_LEAD_KERNELS = 256   # trace_epoch's throwaway kernels a session
TRACE_LEAD_CYCLES = 10000  # the spin of each (~5 µs at 1.98 GHz)
TRACE_ATTEMPTS = 3         # trace_epoch's sessions a replay at most
FUSED_TEMPERATURE = 0.8


def serve_fused(torch, np, dev, model, specs):
    """Continuous runs at ``decode_steps`` FUSED_STEPS through
    ``serve_continuous`` (exact wrapper launches, captures bounded, no
    eager iteration past a warm-up, one replayed epoch traced against its
    capture delta, pages conserved, finite logits).  ``specs``: (label,
    prompts, the single-step run's tokens or None, engine kwargs).  Where tokens are given the fused run
    must equal them bit for bit (the same kernels on the same rows: a
    graph replays its launches); a run with ``num_pages`` must shrink an
    epoch; one at a temperature must give tokens in the vocabulary.
    Returns (records, the wrappers' launches)."""
    runs, total = [], {}
    vocab = model.cfg.vocab_size
    with FiniteLogits(torch, dev) as finite:
        for label, plist, want, kw in specs:
            rec, toks, launches = serve_continuous(
                torch, dev, model, finite, label, plist, 32,
                decode_steps=FUSED_STEPS, **kw)
            if want is not None:
                same = token_agreement(np, toks, want)
                require(same[0] == 1.0, f"{label}: fused tokens differ from "
                        f"the single-step run's (share equal, first "
                        f"divergence): {same}")
                rec["tokens_identical_to_single_step"] = True
            if "num_pages" in kw:
                require(rec["epoch_shrinks"] >= 1,
                        f"{label}: the tight pool shrank no epoch")
            if kw.get("temperature"):
                flat = np.concatenate(toks)
                require(bool(((flat >= 0) & (flat < vocab)).all()),
                        f"{label}: a sampled token outside the vocabulary")
                rec["temperature"] = kw["temperature"]
                rec["distinct_tokens"] = int(np.unique(flat).size)
            _add(total, launches)
            runs.append(rec)
    return runs, total


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v



# ---------------------------------------------------------------------------
# Phase 12: chunked (resumable) prefill
# ---------------------------------------------------------------------------

CHUNK = 128
CHUNK_CAP = -(-MAX_LEN // CHUNK) * CHUNK   # the staging cache's rows: 640
CHUNK_T0 = (0, 128, 384)   # chunk starts held on flash's tile
CHUNK_LAST = (512, 71)     # a final chunk: its start and its real columns
# (d)'s chunk 8: llama2-7b's G = 1 packs R = 8 rows, which take the split-KV
# walk, over a staging cache of 544 rows; the chunk starts (t0, real
# columns) held there, the last a right-padded final chunk
CHUNK_SPLIT = 8
CHUNK_SPLIT_CAP = -(-MAX_LEN // CHUNK_SPLIT) * CHUNK_SPLIT
CHUNK_SPLIT_T0 = ((0, 8), (8, 8), (536, 8), (528, 3))


def chunk_flash(torch, dev, timer, cfg, floor):
    """Flash attention at the chunk geometry: q of one request's C
    columns at positions t0..t0 + C - 1 over a staging cache with kv_len
    t0 + C.  C = 128 over 640 rows (the tensor-core tile) for each t0 of
    CHUNK_T0 and a final chunk (t0 512, kv_len 640 = the cache's rows, 71
    real columns); C = 8 over 544 rows (the split-KV walk, as (d)'s chunks
    take it) for each (t0, real) of CHUNK_SPLIT_T0.  Each in bf16 on its
    route and fp32 on the SIMT kernel against the plain version
    (``flash_call``: phase 3's tolerances, the mirror, a second launch bit
    for bit); a final chunk's real rows equal, bit for bit, a call on
    those rows alone (kv_len t0 + real: its pad columns are inert).  Timed
    beside the plain version and SDPA with a boolean mask of the same
    keys; bound: the bytes of q, out and keys [0, kv_len), and 4·dh
    operations per (row, valid key) pair."""
    import torch.nn.functional as Fn
    from repro_torch.kernels import flash_attention as fa
    B, H, dh = 1, cfg.num_heads, cfg.resolved_head_dim
    Hkv = cfg.num_kv_heads
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(15)
    scale = 1.0 / math.sqrt(dh)
    k_all = torch.randn((B, CHUNK_CAP, Hkv, dh), generator=g,
                        device=dev).to(bf)
    v_all = torch.randn((B, CHUNK_CAP, Hkv, dh), generator=g,
                        device=dev).to(bf)
    cases = ([(CHUNK, CHUNK_CAP, t, CHUNK, "wgmma") for t in CHUNK_T0]
             + [(CHUNK, CHUNK_CAP) + CHUNK_LAST + ("wgmma",)]
             + [(CHUNK_SPLIT, CHUNK_SPLIT_CAP, t, real, "splitkv")
                for t, real in CHUNK_SPLIT_T0])
    out = []
    for C, cap, t0, real, want in cases:
        k, v = (x[:, :cap].contiguous() for x in (k_all, v_all))
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        keys = torch.arange(cap, device=dev)
        q = torch.randn((B, C, H, dh), generator=g, device=dev).to(bf)
        qpos = (t0 + torch.arange(C, dtype=torch.int32, device=dev))[None]
        kvl = torch.full((B,), t0 + C, dtype=torch.int32, device=dev)
        what = f"flash chunk C={C} t0={t0} kv_len={t0 + C}"
        errs = {}
        for dt in (bf, torch.float32):
            a = [t.to(dt) for t in (q, k, v)]
            errs[str(dt).split(".")[-1]] = flash_call(
                torch, *a, qpos, kvl, f"{what} {dt}", scale=scale)
        require(errs["bfloat16"]["route"] == want,
                f"{what}: route {errs['bfloat16']['route']}, want {want}")
        rec = {"shape": f"B={B} C={C} t0={t0} Tk={cap} "
                        f"kv_len={t0 + C} H={H} dh={dh}",
               "real_columns": real}
        if real < C:
            full = fa.flash_attention_cuda(q, k, v, qpos, kvl, scale=scale)
            alone = fa.flash_attention_cuda(
                q[:, :real], k, v, qpos[:, :real],
                torch.full((B,), t0 + real, dtype=torch.int32, device=dev),
                scale=scale)
            require(torch.equal(full[:, :real], alone),
                    f"{what}: the real rows differ from a call without the "
                    "pad columns")
            rec["real_rows_bit_identical_alone"] = True
        mask = ((keys[None, :] <= qpos[0, :, None])
                & (keys[None, :] < t0 + C))
        qt = q.transpose(1, 2)
        ms_k = timer(lambda: fa.flash_attention_cuda(q, k, v, qpos, kvl,
                                                     scale=scale))
        ms_p = timer(lambda: fa.flash_attention_plain(q, k, v, qpos, kvl,
                                                      scale=scale))
        ms_l = timer(lambda: Fn.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        pairs = B * H * (C * t0 + C * (C + 1) // 2)
        nbytes = (2 * B * C * H * dh + 2 * B * (t0 + C) * Hkv * dh) * 2
        b, by = bound_ms(nbytes, 4.0 * pairs * dh)
        rec.update(route=want, ms=ms_k, plain_ms=ms_p, library_ms=ms_l,
                   library="SDPA, boolean mask of the same keys",
                   bound_ms=b, bound_by=by, launch_floor_ms=floor,
                   errors=errs)
        out.append(rec)
    return out


def linears_at(torch, dev, timer, cfg, M, g):
    """The dense fused linear's four linears of a block at M rows: bf16 on
    the tensor-core tile and fp32 on the SIMT kernel against the plain
    version (``fused_linear_call``), the bf16 call timed beside its plain
    version and ``torch.matmul`` of the same shape, with phase 3's
    bounds."""
    from repro_torch.kernels import fused_linear as fl, ref
    linears = []
    for name, K, N, glu, pro, epi in linear_shapes(cfg):
        F = N // 2 if glu else N
        w = (torch.randn((K, N), generator=g, device=dev)
             / math.sqrt(K)).to(torch.bfloat16)
        x, kw = linear_inputs(torch, dev, g, M, K, F, glu, pro, epi)
        what = f"fused_linear {name} M={M}"
        rec = fused_linear_call(torch, x, w, kw, f"{what} bf16")
        require(rec["route"] == "wgmma", f"{what}: route {rec['route']}")
        f32, _ = _cast(torch, kw, torch.float32)
        simt = fused_linear_call(torch, x.float(), w.float(), f32,
                                 f"{what} fp32")
        _, rkw = _cast(torch, kw, torch.bfloat16)
        b, by = bound_ms((M * K + K * N + M * F) * 2 + (
            (K * 2 + M * 4) if pro else 0) + (
            (M * F * 2 + M * 8) if epi else 0), 2.0 * M * K * N)
        linears.append({
            "shape": f"{name} M={M} K={K} N={N}", "route": rec["route"],
            "ms": timer(lambda: fl.fused_linear_cuda(x, w, **kw)),
            "plain_ms": timer(lambda: ref.fused_linear_ref(x, w, **rkw)),
            "library_ms": timer(lambda: torch.matmul(x, w)),
            "bound_ms": b, "bound_by": by,
            "errors": {"bfloat16": rec, "float32": simt}})
        del x, w, kw
    return linears


def chunk_kernels(torch, dev, timer, cfg, floor):
    """(a) The kernels at one chunk's geometry: flash (``chunk_flash``),
    the dense fused linear's four linears at M = 128 (bf16 on the
    tensor-core tile, fp32 on the SIMT kernel, ``fused_linear_call``) and
    the router at T = 128 (``router_call``), each also timed beside its
    plain version (the linears beside ``torch.matmul``), with phase 3's
    bounds."""
    from repro_torch.kernels import fused_router_rmsnorm as frr, ref
    g = torch.Generator(device=dev).manual_seed(16)
    M = CHUNK
    linears = linears_at(torch, dev, timer, cfg, M, g)
    D = cfg.d_model
    w = torch.randn((D, 2), generator=g, device=dev) * 0.02
    x = torch.randn((M, D), generator=g, device=dev).to(torch.bfloat16)
    errs = {str(dt).split(".")[-1]: router_call(
        torch, x.to(dt), w, f"router T={M} {dt}")
        for dt in (torch.bfloat16, torch.float32)}
    b, by = bound_ms(M * D * 2 + D * 2 * 4 + M * 3 * 4, 6.0 * M * D)
    router = {"shape": f"x[{M},{D}] bf16",
              "plan": dataclasses.asdict(frr.plan(M, D, x.dtype,
                                                  x.data_ptr())),
              "ms": timer(lambda: frr.router_stats_cuda(x, w)),
              "plain_ms": timer(lambda: ref.router_stats_ref(x, w)),
              "bound_ms": b, "bound_by": by, "errors": errs}
    return {"launch_floor_ms": floor,
            "flash": chunk_flash(torch, dev, timer, cfg, floor),
            "fused_linear": linears, "router": router}


def check_chunk_run(model, rec, prompts):
    """A chunked run's own checks beside ``serve_continuous``'s: per chunk
    of 128 the plans give 1 router pass, 4·L fused linears on the tile
    (int4 weights: the s8 tile; the lm head's one row on the stream), L
    flash tiles and nothing on the decode routes (fp32: the SIMT kernels); ``prefill_chunks`` =
    Σ⌈T0/128⌉; prefills interleaved with resident decode steps; no abort
    and no preemption."""
    from repro_torch.quant import int4_head, int4_linears
    L = model.cfg.num_layers
    per = expected_launches(model, [(1, CHUNK, CHUNK_CAP)], 0, SLOTS)
    route = "simt" if model.cfg.dtype == "float32" else "wgmma"
    lin = ("fused_linear_int4_tc" if int4_linears(model.params())
           else f"fused_linear_{route}")
    want = {"router_stats": 1, lin: 4 * L, f"flash_attention_{route}": L,
            "int4_matmul_stream": 1 if int4_head(model.params()) else 0}
    moved = {k: v for k, v in per.items() if v and k not in (
        "fused_linear", "fused_linear_int4", "int4_matmul",
        "flash_attention")}
    want = {k: v for k, v in want.items() if v}
    require(moved == want, f"{rec['run']}: launches per chunk {moved}, "
            f"want {want}")
    n_chunks = sum(-(-len(p) // CHUNK) for p in prompts)
    require(rec["prefills"] == n_chunks, f"{rec['run']}: {rec['prefills']} "
            f"prefill chunks, want {n_chunks}")
    require(rec["interleaved_steps"] > 0,
            f"{rec['run']}: no chunk ran beside a resident")
    require(rec["prefill_aborts"] == 0 and rec.get("preemptions", 0) == 0,
            f"{rec['run']}: aborted or preempted in a roomy pool")
    rec["launches_per_chunk"] = moved


def chunked_full_width(torch, np, dev, model, prompts, tokens, short, tight):
    """(c) Phase 6's 8 requests at chunk 128 on its bf16 weights: the dense
    pool and bf16, int8 and int4 pages, then fused 8-step epochs (dense
    and paged bf16) under step_tokens 160 (3 residents × 8 + 128: no chunk
    deferred) and 136 (chunks deferred); each run's launches exact
    (``serve_continuous``) and checked per chunk (``check_chunk_run``),
    its share of tokens equal to the chunk-0 run reported, not checked.
    (d) Phase 6's 4 short requests in its tight paged pool at chunk 8:
    every request finishes and every page comes back; aborts and
    preemptions reported.  Returns (records, the wrappers' launches)."""
    runs, total = [], {}
    specs = [(f"chunk{CHUNK}_dense", "dense", dict(kv_mode="dense")),
             (f"chunk{CHUNK}_paged_bf16", "paged_bf16",
              dict(kv_mode="paged")),
             (f"chunk{CHUNK}_paged_int8", "paged_int8",
              dict(kv_mode="paged", kv_dtype="int8")),
             (f"chunk{CHUNK}_paged_int4", "paged_int4",
              dict(kv_mode="paged", kv_dtype="int4"))]
    for budget in SLOTS * FUSED_STEPS + CHUNK, 136:
        specs += [(f"chunk{CHUNK}_fused_dense_st{budget}", "dense",
                   dict(kv_mode="dense", step_tokens=budget)),
                  (f"chunk{CHUNK}_fused_paged_bf16_st{budget}", "paged_bf16",
                   dict(kv_mode="paged", step_tokens=budget))]
    with FiniteLogits(torch, dev) as finite:
        for label, ref_label, kw in specs:
            if "fused" in label:
                kw = dict(kw, decode_steps=FUSED_STEPS)
            rec, toks, launches = serve_continuous(
                torch, dev, model, finite, label, prompts, 32, trace=False,
                prefill_chunk=CHUNK, **kw)
            check_chunk_run(model, rec, prompts)
            if "step_tokens" in kw:
                roomy = kw["step_tokens"] >= ((SLOTS - 1) * FUSED_STEPS
                                              + CHUNK)
                require((rec["prefill_deferrals"] == 0) == roomy,
                        f"{label}: {rec['prefill_deferrals']} deferrals")
            rec["tokens_equal_to_chunk0"] = token_agreement(
                np, toks, tokens[ref_label])
            _add(total, launches)
            runs.append(rec)
        rec, toks, launches = serve_continuous(
            torch, dev, model, finite,
            f"chunk{CHUNK_SPLIT}_short_paged_bf16_tight", short, 32,
            kv_mode="paged", num_pages=tight, prefill_chunk=CHUNK_SPLIT)
        rec["tokens_equal_to_chunk0"] = token_agreement(
            np, toks, tokens["short_paged_bf16"])
        _add(total, launches)
    return runs, rec, total


def chunk_witness(torch, np, dev, m32, reqs, new, tokens, logs):
    """(b) The fp32 witness: phase 7's 4 requests on its fp32 weights at
    chunk 128, in the dense pool and in fp32 pages, against phase 7's
    chunk-0 runs: tokens bit for bit, each request's prompt gate log and
    decode gate columns identical, the same KV accounting (per request
    and, paged, the store's entries stored and dense, history hit rates).
    Returns (records, the wrappers' launches, seconds)."""
    runs, total, t = [], {}, time.perf_counter()
    with FiniteLogits(torch, dev) as finite:
        for label in ("fp32_dense", "fp32_paged"):
            log = {}
            rec, toks, launches = serve_continuous(
                torch, dev, m32, finite, f"chunk{CHUNK}_{label}", reqs, new,
                log=log, kv_mode=label.split("_")[1], prefill_chunk=CHUNK)
            check_chunk_run(m32, rec, reqs)
            require(all(np.array_equal(a, b) for a, b in zip(
                toks, tokens[label])), f"{label}: chunk {CHUNK} tokens "
                "differ from chunk 0")
            ref = logs[label]
            for uid, (pg, cols) in ref["log"]["gates"].items():
                pg2, cols2 = log["gates"][uid]
                require(np.array_equal(pg, pg2) and len(cols) == len(cols2)
                        and all(np.array_equal(a, b)
                                for a, b in zip(cols, cols2)),
                        f"{label}: request {uid}'s gate log differs at "
                        f"chunk {CHUNK}")
            keys = ["kv_saved_fraction", "attn_keep_frac"] + (
                ["kv_entries_stored", "kv_entries_dense", "history_hit_rate",
                 "history_hits_per_layer", "kv_entries_saved_fraction"]
                if label == "fp32_paged" else [])
            diff = {k: (ref["rec"][k], rec[k]) for k in keys
                    if ref["rec"][k] != rec[k]}
            require(not diff, f"{label}: KV accounting differs at chunk "
                    f"{CHUNK}: {diff}")
            rec.update(tokens_identical_to_chunk0=True,
                       gate_logs_identical_to_chunk0=True,
                       kv_accounting_identical_to_chunk0=keys)
            _add(total, launches)
            runs.append(rec)
    return runs, total, time.perf_counter() - t


# ---------------------------------------------------------------------------
# Phase 13: the prefix cache (warm admissions over shared prompt pages)
# ---------------------------------------------------------------------------

PREFIX_LEN = 1024          # the shared system prompt's tokens
PREFIX_TAILS = (32, 128)   # each request's own tail: its least, most tokens
PREFIX_REQUESTS = 8
PREFIX_MAX_LEN = 1280
PREFIX_BLOCK = 16
PREFIX_NEW = 32
PREFIX_WITNESS_LEN = 256   # the fp32 witness's shared prefix
PREFIX_MARGIN = 64         # the tight pool's pages past one worst case


def prefix_traffic(np, vocab):
    """A chat or agent service with one long system prompt: a 1024-token
    preamble (seeded) shared by every request, each with its own tail of
    32-128 tokens.  Returns (the publisher's prompt, the 8 requests'): the
    first 7 have fresh tails, the 8th repeats the publisher's prompt (a
    regenerate), so its warm suffix is at most a block of 16 tokens and
    takes the decode routes."""
    rng = np.random.default_rng(13)
    head = rng.integers(0, vocab, (PREFIX_LEN,)).astype(np.int32)

    def one():
        n = int(rng.integers(PREFIX_TAILS[0], PREFIX_TAILS[1] + 1))
        return np.concatenate([head, rng.integers(0, vocab, (n,)).astype(
            np.int32)])

    first = one()
    return first, [one() for _ in range(PREFIX_REQUESTS - 1)] + [first]


def prefix_expected(earlier, prompts, block=PREFIX_BLOCK):
    """The tokens each of ``prompts`` finds published, worked out on the
    host: every prompt prefilled before it (``earlier``, then the ones
    ahead of it in the queue) published each ``block``-token boundary of
    its prompt, and a lookup takes the longest boundary below the
    prompt's length.  Returns [Ts] (0 = cold)."""
    published = {tuple(p[:ts].tolist()) for p in earlier
                 for ts in range(block, len(p) + 1, block)}
    out = []
    for p in prompts:
        top = (len(p) - 1) // block * block
        out.append(next((ts for ts in range(top, 0, -block)
                         if tuple(p[:ts].tolist()) in published), 0))
        published |= {tuple(p[:ts].tolist())
                      for ts in range(block, len(p) + 1, block)}
    return out


def free_engine(torch, eng):
    """Drop an engine's stashed store now: the wrappers a run installs on
    the engine refer back to it, so only the cycle collector frees it."""
    eng._store = None
    gc.collect()
    torch.cuda.empty_cache()


def prefix_engine(model, **kw):
    from repro_torch.serve.engine import ContinuousBatchingEngine
    return ContinuousBatchingEngine(
        model, kv_mode="paged", max_slots=SLOTS, page_size=PAGE,
        prefix_block=PREFIX_BLOCK, **{"max_len": PREFIX_MAX_LEN, **kw})


def prefix_run(torch, np, dev, model, finite, eng, label, prompts, new,
               log=None):
    """One ``run()`` of ``prompts`` on ``eng`` (a paged engine, its prefix
    cache on or off, possibly holding records of earlier runs), its
    launches and graphs held by ``counted_run`` (a warm suffix is a chunk
    forward at its dispatch width over the staging cache); each warm
    forward on the routes its width gives (bf16: ≤ 16 rows on the split-K
    stream and the split-KV walk, wider on the tiles; fp32 on the SIMT
    kernels) and, in bf16, no SIMT launch at all; every request complete;
    finite logits; the allocator conserved with the records' pins and
    free + pinned pages = the pool.  Returns (record, tokens, results, the
    wrappers' launches)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_linear as fl
    from repro_torch.models import layers
    cfg, L = model.cfg, model.cfg.num_layers
    G = cfg.num_heads // cfg.num_kv_heads
    bf16 = cfg.dtype != "float32"
    fuse = layers.fuse_norm_linear(cfg)     # else bf16 plain matmuls
    uids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    seen, warm = {}, []
    if eng.prefix is not None:
        work_warm = eng._prefill_work_warm

        def warm_work(rs, work, store, reuse):
            w = eng._warm_pending[work.slot]
            if work.is_first:
                warm.append({"uid": work.req.uid, "tokens": w.rec.length,
                             "entries": w.rec.entries,
                             "cow": w.copy is not None, "rows": []})
            seen["warm"] = warm[-1]
            try:
                return work_warm(rs, work, store, reuse)
            finally:
                seen.pop("warm")
        eng._prefill_work_warm = warm_work
    if log is not None:
        watch_engine(eng, log)
    finite.reset()

    def warm_rows(shape):
        if "warm" in seen:
            seen["warm"]["rows"].append(shape)

    out, rows, launches, wall, _ = counted_run(torch, dev, model, eng, label,
                                               seen, warm_rows)
    s = out["stats"]
    for w in warm:
        for r in w["rows"]:
            per = expected_launches(model, [r], 0, SLOTS)
            route = ("simt" if not bf16 else
                     "wgmma" if r[1] > fl.SPLITK_MAX_M else "splitk")
            flash = ("simt" if not bf16 else
                     "wgmma" if G * r[1] > fa.SPLITKV_MAX_R else "splitkv")
            want = {f"flash_attention_{flash}": L}
            if fuse:
                want.update({"router_stats": 1,
                             f"fused_linear_{route}": 4 * L})
            moved = {k: v for k, v in per.items() if v and "_" in k
                     and k not in ("fused_linear", "flash_attention")}
            require(moved == want, f"{label}: a warm forward of {r[1]} "
                    f"rows launches {moved}, want {want}")
    if bf16:
        simt = {k: v for k, v in launches.items() if k.endswith("_simt")
                and v}
        require(not simt, f"{label}: bf16 launches on SIMT routes {simt}")
    res = [out["results"][u] for u in uids]
    require(s.requests_completed == len(prompts) and all(
        r.finish_reason == "length" and r.decode_tokens == new
        for r in res), f"{label}: not every request completed")
    require(bool(finite.all.item()), f"{label}: non-finite logits")
    alloc = eng.allocator
    pins = eng.prefix.page_pins() if eng.prefix is not None else {}
    alloc.check_conservation(pins)
    require(alloc.free_pages + len(pins) == eng.num_pages,
            f"{label}: {alloc.free_pages} free + {len(pins)} pinned pages "
            f"of {eng.num_pages}")
    rec = {"run": label, "dtype": cfg.dtype, "kv_dtype": eng.kv_dtype,
           "prefix_cache": eng.prefix is not None,
           "prefill_chunk": eng.prefill_chunk,
           "steps_per_dispatch": eng.decode_steps, "requests": len(prompts),
           "prefill_s": s.prefill_s, "prefill_tokens": s.prefill_tokens,
           "prefills": s.prefill_chunks, "decode_s": s.decode_s,
           "decode_steps": s.decode_iterations, "wall_s": wall,
           "ttft_s": [r.ttft_s for r in res],
           "mean_ttft_s": sum(r.ttft_s for r in res) / len(res),
           "prefix_hits": s.prefix_hits, "prefix_misses": s.prefix_misses,
           "prefix_tokens_saved": s.prefix_tokens_saved,
           "prefix_records": s.prefix_records,
           "warm": [{k: v for k, v in w.items()} for w in warm],
           "cow_copies": sum(w["cow"] for w in warm),
           "pages_peak": s.pages_peak, "pages_total": s.pages_total,
           "pinned_pages": len(pins), "preemptions": s.preemptions,
           "kv_entries_stored": s.kv_entries_stored,
           "kv_entries_dense": s.kv_entries_dense,
           "history_hit_rate": s.history_hit_rate,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "launches": launches}
    return rec, [r.tokens for r in res], res, launches


def prefix_pair(torch, np, dev, model, finite, label, first, prompts, kw,
                total):
    """One configuration with the cache on, fed the publisher's run and
    then the 8 requests, beside the same 8 requests with the cache off:
    hits and saved tokens as worked out on the host (every admission
    warm), at least as many records as the publisher's boundaries,
    pages_peak lower with the cache.  Returns the record."""
    eng = prefix_engine(model, prefix_cache=True, **kw)
    p1, _, _, l1 = prefix_run(torch, np, dev, model, finite, eng,
                              f"{label}_publish", [first], PREFIX_NEW)
    w2, wt, _, l2 = prefix_run(torch, np, dev, model, finite, eng,
                               f"{label}_warm", prompts, PREFIX_NEW)
    free_engine(torch, eng)
    eng = prefix_engine(model, prefix_cache=False, **kw)
    c2, ct, _, l3 = prefix_run(torch, np, dev, model, finite, eng,
                               f"{label}_cold", prompts, PREFIX_NEW)
    free_engine(torch, eng)
    for launches in (l1, l2, l3):
        _add(total, launches)
    want = prefix_expected([first], prompts)
    require(p1["prefix_hits"] == 0 and p1["prefix_misses"] == 1
            and p1["prefix_records"] >= len(first) // PREFIX_BLOCK,
            f"{label}: publisher's run {p1}")
    require(w2["prefix_hits"] == sum(1 for t in want if t)
            == len(prompts) and w2["prefix_misses"] == 0
            and w2["prefix_tokens_saved"] == sum(want),
            f"{label}: {w2['prefix_hits']} hits saving "
            f"{w2['prefix_tokens_saved']} tokens, want {want}")
    require([w["tokens"] for w in w2["warm"]] == want,
            f"{label}: warm admissions {w2['warm']}, want {want}")
    require(w2["pages_peak"] < c2["pages_peak"], f"{label}: pages_peak "
            f"{w2['pages_peak']} with the cache, {c2['pages_peak']} without")
    return {"run": label, "warm": w2, "cold": c2, "publish": p1,
            "expected_warm_tokens": want,
            "prefill_s_warm_over_cold": w2["prefill_s"] / c2["prefill_s"],
            "mean_ttft_warm_over_cold": w2["mean_ttft_s"]
            / c2["mean_ttft_s"],
            "tokens_equal_to_cold": token_agreement(np, wt, ct)}


def prefix_tight(torch, np, dev, model, finite, first, prompts, pins,
                 total):
    """The 8 requests in a pool one worst case (and ``PREFIX_MARGIN``
    pages) past the publisher's pinned pages: records must be evicted,
    and no resident may be preempted while an unpinned record is left;
    every request completes and every page comes back (free + pinned =
    pool, then none once the records are cleared)."""
    worst = max(-(-max(min(PREFIX_MAX_LEN, len(p) + PREFIX_NEW - 1),
                       len(p) + 1) * model.cfg.num_layers // PAGE)
                for p in [first] + prompts)
    pool = worst + pins + PREFIX_MARGIN
    eng = prefix_engine(model, prefix_cache=True, num_pages=pool)
    events = []
    evict, preempt = eng.prefix.evict_one, eng._preempt_youngest

    def evicted():
        freed = evict()
        if freed is not None:
            events.append(("evict", freed))
        return freed

    def preempted(rs, exclude):
        idle = sum(1 for r in eng.prefix._records.values() if not r.in_use)
        events.append(("preempt", idle))
        return preempt(rs, exclude)

    eng.prefix.evict_one, eng._preempt_youngest = evicted, preempted
    r1, _, _, l1 = prefix_run(torch, np, dev, model, finite, eng,
                              "prefix_tight_publish", [first], PREFIX_NEW)
    r2, toks, _, l2 = prefix_run(torch, np, dev, model, finite, eng,
                                 "prefix_tight", prompts, PREFIX_NEW)
    _add(total, l1)
    _add(total, l2)
    n_evict = sum(1 for e in events if e[0] == "evict")
    late = [e for e in events if e[0] == "preempt" and e[1]]
    require(n_evict >= 1, f"prefix_tight: no record evicted in a pool of "
            f"{pool} pages")
    require(not late, f"prefix_tight: residents preempted while "
            f"{late} unpinned records were left")
    eng.prefix.clear()
    eng.allocator.check_conservation()
    require(eng.allocator.free_pages == pool,
            "prefix_tight: pages in use once the records are cleared")
    free_engine(torch, eng)
    return {"run": "prefix_tight", "pool_pages": pool,
            "worst_case_pages": worst, "publisher_pins": pins,
            "publish": r1, "run8": r2, "records_evicted": n_evict,
            "preemptions": r2["preemptions"],
            "events": [e[0] for e in events][:64]}, toks


def prefix_full_width(torch, np, dev, model):
    """Phase 13's bf16 part on phase 6's weights: each configuration with
    and without the cache (``prefix_pair``), then the tight pool.
    Returns (record, the wrappers' launches)."""
    from repro_torch.kernels import fused_linear as fl
    gc.collect()            # earlier phases' engines: a clean memory peak
    torch.cuda.empty_cache()
    t = time.perf_counter()
    first, prompts = prefix_traffic(np, model.cfg.vocab_size)
    total, runs = {}, []
    specs = [("prefix_bf16", {}), ("prefix_int8", dict(kv_dtype="int8")),
             ("prefix_int4", dict(kv_dtype="int4")),
             ("prefix_fused_bf16", dict(decode_steps=FUSED_STEPS)),
             (f"prefix_chunk{CHUNK}_bf16", dict(prefill_chunk=CHUNK))]
    with FiniteLogits(torch, dev) as finite:
        for label, kw in specs:
            runs.append(prefix_pair(torch, np, dev, model, finite, label,
                                    first, prompts, kw, total))
        tight, toks = prefix_tight(torch, np, dev, model, finite, first,
                                   prompts, runs[0]["publish"]["pinned_pages"],
                                   total)
    torch.cuda.empty_cache()
    cows = sum(r["warm"]["cow_copies"] for r in runs)
    require(cows >= 1, "no warm admission took the copy on write")
    widths = [r[1] for run in runs for w in run["warm"]["warm"]
              for r in w["rows"]]
    require(min(widths) <= fl.SPLITK_MAX_M < max(widths),
            f"warm forwards of {sorted(set(widths))} rows: want both "
            f"routes")
    return {"prefix_len": PREFIX_LEN, "tails": PREFIX_TAILS,
            "layers": model.cfg.num_layers,
            "requests": PREFIX_REQUESTS, "max_len": PREFIX_MAX_LEN,
            "block": PREFIX_BLOCK, "new_tokens": PREFIX_NEW,
            "prompt_lens": [len(first)] + [len(p) for p in prompts],
            "runs": runs, "tight": tight, "cow_copies": cows,
            "warm_widths": sorted(set(widths)),
            "seconds": time.perf_counter() - t}, total


def prefix_witness(torch, np, dev, m32):
    """Phase 13's fp32 witness on phase 7's fp32 weights: 4 requests
    sharing a 256-token prefix in fp32 pages, single-step, monolithic and
    at chunk 128, the cache on against the cache off: tokens bit for bit,
    each request's gate log (the warm ones' stitched from the record and
    the suffix) and decode gate columns identical, each request's KV
    accounting and the history hit rates identical, and the stored and
    dense entry counts short by exactly the warm admissions' shared
    entries.  Returns (record, the wrappers' launches, seconds)."""
    t = time.perf_counter()
    rng = np.random.default_rng(14)
    head = rng.integers(0, m32.cfg.vocab_size, (PREFIX_WITNESS_LEN,))
    reqs = [np.concatenate([head, rng.integers(
        0, m32.cfg.vocab_size, (int(n),))]).astype(np.int32)
        for n in rng.integers(16, 65, SLOTS)]
    want = prefix_expected([], reqs)
    nA = m32.cfg.num_layers
    total, runs = {}, []
    with FiniteLogits(torch, dev) as finite:
        for chunk in (0, CHUNK):
            out = {}
            for on in (True, False):
                eng = prefix_engine(m32, prefix_cache=on, max_len=MAX_LEN,
                                    prefill_chunk=chunk)
                log = {}
                rec, toks, res, launches = prefix_run(
                    torch, np, dev, m32, finite, eng,
                    f"prefix_fp32_chunk{chunk}_{'warm' if on else 'cold'}",
                    reqs, PREFIX_NEW, log=log)
                _add(total, launches)
                out[on] = (rec, toks, res, log)
                free_engine(torch, eng)
            (w, wt, wr, wl), (c, ct, cr, cl) = out[True], out[False]
            label = f"prefix_fp32_chunk{chunk}"
            require(w["prefix_hits"] == sum(1 for x in want if x)
                    and w["prefix_tokens_saved"] == sum(want),
                    f"{label}: hits {w['prefix_hits']}, saved "
                    f"{w['prefix_tokens_saved']}, want {want}")
            require(all(np.array_equal(a, b) for a, b in zip(wt, ct)),
                    f"{label}: warm tokens differ from cold")
            for uid, (pg, cols) in cl["gates"].items():
                pg2, cols2 = wl["gates"][uid]
                require(np.array_equal(pg, pg2) and len(cols) == len(cols2)
                        and all(np.array_equal(a, b)
                                for a, b in zip(cols, cols2)),
                        f"{label}: request {uid}'s gate log differs warm")
            require([(r.kv_stored, r.kv_dense) for r in wr]
                    == [(r.kv_stored, r.kv_dense) for r in cr]
                    and w["history_hit_rate"] == c["history_hit_rate"],
                    f"{label}: KV accounting differs warm")
            shared = sum(x["entries"] for x in w["warm"])
            require(c["kv_entries_stored"] - w["kv_entries_stored"] == shared
                    and c["kv_entries_dense"] - w["kv_entries_dense"]
                    == nA * w["prefix_tokens_saved"],
                    f"{label}: entries stored {w['kv_entries_stored']} / "
                    f"{c['kv_entries_stored']}, dense "
                    f"{w['kv_entries_dense']} / {c['kv_entries_dense']}, "
                    f"shared {shared}")
            runs.append({"run": label, "warm": w, "cold": c,
                         "tokens_identical": True,
                         "gate_logs_identical": True,
                         "kv_accounting_identical": True,
                         "shared_entries": shared})
    return {"prefix_len": PREFIX_WITNESS_LEN, "requests": len(reqs),
            "expected_warm_tokens": want, "runs": runs}, total, \
        time.perf_counter() - t


# ---------------------------------------------------------------------------
# Phase 14: self-speculative decoding (draft graphs, verify windows, commit)
# ---------------------------------------------------------------------------

SPEC_K = 4
SPEC_KEEP = 0.5      # (b)'s draft_keep: router skip biases raised by 2.0


def verify_expected(model, S, C, Tk):
    """Exact launches of one verify window: a chunk forward of C columns
    for S slots over Tk key rows (the dense pool's rows, or the paged
    staging cache's), with every column unembedded (int4 weights: the lm
    head's S·C rows through the int4 matmul, where a prefill takes S)."""
    from repro_torch.quant import int4_head
    want = expected_launches(model, [(S, C, Tk)], 0, SLOTS)
    if int4_head(model.params()):
        from repro_torch.kernels import fused_linear as fl
        from repro_torch.models import layers
        cfg, lm = model.cfg, model.params()["lm_head"]
        n_grp = lm["scale"].shape[0]
        Kw, V = lm["w_int"].shape

        def route(rows):
            return fl.plan_int4(rows, cfg.d_model, V, Kw // n_grp, n_grp,
                                False, layers.torch_dtype(cfg)).route

        want["int4_matmul_" + route(S)] -= 1
        want["int4_matmul_" + route(S * C)] += 1
    return want


def spec_watch(torch, model, eng, finite, seen):
    """Wrap a speculative engine: ``seen["ep"]`` gets its draft epoch,
    ``seen["windows"]`` per window γ, the active slots, the verify's rows
    (S, C), its key rows and the wrappers' launches it made; the verify
    logits join the finite flag.  Returns the model attribute to delete
    after the run (the verify wrapper)."""
    from repro_torch.kernels import ops
    windows = seen["windows"] = []
    epoch, draft = eng._draft_epoch, eng._draft

    def kept(kv, rs, paged):
        seen["ep"] = epoch(kv, rs, paged)
        return seen["ep"]

    def drafted(rs, ep, feed, feed_dev, pos_dev, act, gamma, **k):
        windows.append({"gamma": gamma, "active": int(act.sum())})
        return draft(rs, ep, feed, feed_dev, pos_dev, act, gamma, **k)

    eng._draft_epoch, eng._draft = kept, drafted
    paged_run = eng.kv_mode == "paged"
    name = "paged_verify_chunk" if paged_run else "verify_chunk"
    verify = getattr(model, name)

    def counted(kv, toks, *a, **k):
        before = ops.kernel_launches()
        out = verify(kv, toks, *a, **k)
        after = ops.kernel_launches()
        finite.all &= torch.isfinite(out[0]).all()
        w = windows[-1]
        w["rows"] = tuple(toks.shape)
        w["key_rows"] = k["cap"] if paged_run else kv[0]["k"].shape[1]
        w["launches"] = {x: after[x] - before[x] for x in after}
        return out

    setattr(model, name, counted)
    return name


def spec_record(cfg, eng, s, windows, launches, label):
    """A speculative run's checks and figures: windows ran, accepted ≤
    drafted, drafted = Σ γ × active slots over the windows, no bf16 SIMT
    launch; the acceptance rate, window wall ms, the verify rows' routes."""
    from repro_torch.kernels import fused_linear as fl
    drafted = sum(w["gamma"] * w["active"] for w in windows)
    require(s.spec_windows == len(windows) > 0,
            f"{label}: {s.spec_windows} windows counted, {len(windows)} seen")
    require(s.spec_tokens_accepted <= s.spec_tokens_drafted == drafted,
            f"{label}: accepted {s.spec_tokens_accepted}, drafted "
            f"{s.spec_tokens_drafted}, Σ γ × active {drafted}")
    if cfg.dtype != "float32":
        simt = {k: v for k, v in launches.items() if k.endswith("_simt")
                and v}
        require(not simt, f"{label}: bf16 launches on SIMT routes {simt}")
    rows = sorted({w["rows"][0] * w["rows"][1] for w in windows})
    return {"spec_k": eng.spec_k, "draft_keep": eng.draft_keep,
            "spec_windows": s.spec_windows,
            "spec_tokens_drafted": s.spec_tokens_drafted,
            "spec_tokens_accepted": s.spec_tokens_accepted,
            "spec_acceptance_rate": s.spec_acceptance_rate,
            "spec_entries_rolled_back": s.spec_entries_rolled_back,
            "window_ms": 1e3 * s.decode_s / s.spec_windows,
            "gammas": [w["gamma"] for w in windows],
            "verify_rows": rows,
            "verify_on_tile": [m for m in rows if m > fl.SPLITK_MAX_M],
            "verify_on_stream": [m for m in rows if m <= fl.SPLITK_MAX_M]}


def spec_beside(np, rec, toks, plain_rec, plain_toks):
    """A speculative run's figures beside the plain run of the same
    requests on the same weights in this process (reported)."""
    same, first = token_agreement(np, toks, plain_toks)
    rec.update(plain_decode_tok_per_s=plain_rec["decode_tok_per_s"],
               speedup_decode_tok_per_s=(rec["decode_tok_per_s"]
                                         / plain_rec["decode_tok_per_s"]),
               tokens_equal_to_plain=same, first_divergence=first)
    return rec


SPEC_T0 = (130, 261, 392, 539)   # a window's per-slot positions (Tk 544)


def spec_kernels(torch, dev, timer, cfg, floor):
    """The kernels at a verify window's geometries, each timed beside its
    plain version and, where there is one, the library call: the dense
    fused linear's four linears at M = 20 (4 slots × γ 4 + 1: the
    tensor-core tile) and M = 8 and 16 (γ 1 and 3: the split-K stream);
    flash's split-KV walk at R = 5 (4 slots, 5 columns at per-slot
    positions SPEC_T0 over 544 rows, beside SDPA with a boolean mask of the
    same keys); the int4 lm head at M = 20 on the s8 tile.  Then the fp32
    SIMT rows' library calls on the same Timer: ``torch.matmul`` in fp32
    (TF32 off) beside the SIMT fused linear at M 2048 and 4, and fp32 SDPA
    beside the SIMT flash at the 4 × 512 prefill and the B 4 decode."""
    import torch.nn.functional as Fn
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_linear as fl, int4_matmul as im
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(27)
    linears, simt = [], []
    for M, want in ((20, "wgmma"), (8, "splitk"), (16, "splitk")):
        for name, K, N, glu, pro, epi in linear_shapes(cfg):
            F = N // 2 if glu else N
            w = (torch.randn((K, N), generator=g, device=dev)
                 / math.sqrt(K)).to(torch.bfloat16)
            x, kw = linear_inputs(torch, dev, g, M, K, F, glu, pro, epi)
            what = f"fused_linear {name} M={M}"
            rec = fused_linear_call(torch, x, w, kw, f"{what} bf16")
            require(rec["route"] == want, f"{what}: route {rec['route']}")
            _, rkw = _cast(torch, kw, torch.bfloat16)
            b, by = bound_ms((M * K + K * N + M * F) * 2 + (
                (K * 2 + M * 4) if pro else 0) + (
                (M * F * 2 + M * 8) if epi else 0), 2.0 * M * K * N)
            linears.append({
                "shape": f"{name} M={M} K={K} N={N}", "route": want,
                "ms": timer(lambda: fl.fused_linear_cuda(x, w, **kw)),
                "plain_ms": timer(lambda: ref.fused_linear_ref(x, w,
                                                               **rkw)),
                "library_ms": timer(lambda: torch.matmul(x, w)),
                "bound_ms": b, "bound_by": by, "errors": {"bfloat16": rec}})
            del x, w, kw
    for M in (2048, 4):
        for name, K, N, glu, pro, epi in linear_shapes(cfg):
            F = N // 2 if glu else N
            w = torch.randn((K, N), generator=g, device=dev) / math.sqrt(K)
            x, kw = linear_inputs(torch, dev, g, M, K, F, glu, pro, epi)
            f32, _ = _cast(torch, kw, torch.float32)
            x = x.float()
            b, by = bound_ms((M * K + K * N + M * F) * 4, 2.0 * M * K * N,
                             FP32_OPS_PER_S)
            simt.append({
                "shape": f"fused_linear {name} M={M} K={K} N={N} fp32",
                "ms": timer(lambda: fl.fused_linear_cuda(x, w, **f32)),
                "library_ms": timer(lambda: torch.matmul(x, w)),
                "library": "torch.matmul fp32 (TF32 off)",
                "bound_ms": b, "bound_by": by})
            del x, w, kw, f32
    B, H, dh = SLOTS, cfg.num_heads, cfg.resolved_head_dim
    Hkv, C, Tk = cfg.num_kv_heads, SPEC_K + 1, MAX_LEN
    scale = 1.0 / math.sqrt(dh)
    bf = torch.bfloat16
    q = torch.randn((B, C, H, dh), generator=g, device=dev).to(bf)
    k = torch.randn((B, Tk, Hkv, dh), generator=g, device=dev).to(bf)
    v = torch.randn((B, Tk, Hkv, dh), generator=g, device=dev).to(bf)
    t0 = torch.as_tensor(SPEC_T0, dtype=torch.int32, device=dev)
    qpos = t0[:, None] + torch.arange(C, dtype=torch.int32, device=dev)
    kvl = t0 + C
    what = f"flash verify window B={B} C={C} Tk={Tk}"
    errs = {str(dt).split(".")[-1]: flash_call(
        torch, *[t.to(dt) for t in (q, k, v)], qpos, kvl, f"{what} {dt}",
        scale=scale) for dt in (bf, torch.float32)}
    require(errs["bfloat16"]["route"] == "splitkv",
            f"{what}: route {errs['bfloat16']['route']}")
    keys = torch.arange(Tk, device=dev)
    mask = ((keys[None, None, :] <= qpos[:, :, None])
            & (keys[None, None, :] < kvl[:, None, None]))[:, None]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = H * sum(C * t + C * (C + 1) // 2 for t in SPEC_T0)
    nbytes = (2 * B * C * H * dh + 2 * sum(t + C for t in SPEC_T0)
              * Hkv * dh) * 2
    b, by = bound_ms(nbytes, 4.0 * pairs * dh)
    flash = {"shape": f"B={B} C={C} t0={list(SPEC_T0)} Tk={Tk} H={H} "
                      f"dh={dh}", "route": "splitkv",
             "ms": timer(lambda: fa.flash_attention_cuda(q, k, v, qpos, kvl,
                                                         scale=scale)),
             "plain_ms": timer(lambda: fa.flash_attention_plain(
                 q, k, v, qpos, kvl, scale=scale)),
             "library_ms": timer(lambda: Fn.scaled_dot_product_attention(
                 qt, kt, vt, attn_mask=mask)),
             "library": "SDPA, boolean mask of the same keys",
             "bound_ms": b, "bound_by": by, "errors": errs}
    for label, Tq, t_last in (("prefill", 512, None), ("decode", 1, 543)):
        qf = torch.randn((B, Tq, H, dh), generator=g, device=dev)
        kf = torch.randn((B, Tk if t_last else Tq, Hkv, dh), generator=g,
                         device=dev)
        vf = torch.randn_like(kf)
        if t_last is None:
            pos = torch.arange(Tq, dtype=torch.int32,
                               device=dev)[None].expand(B, Tq)
            kl = None
        else:
            pos = torch.full((B, 1), t_last, dtype=torch.int32, device=dev)
            kl = torch.full((B,), t_last + 1, dtype=torch.int32, device=dev)
        n_keys = t_last + 1 if t_last else Tq
        pairs = B * H * (n_keys if t_last else Tq * (Tq + 1) // 2)
        b, by = bound_ms((2 * B * Tq * H * dh + 2 * B * n_keys * Hkv * dh)
                         * 4, 4.0 * pairs * dh, FP32_OPS_PER_S)
        qt, kt, vt = (t.transpose(1, 2) for t in (qf, kf, vf))
        kt, vt = kt[:, :, :n_keys], vt[:, :, :n_keys]
        simt.append({
            "shape": f"flash {label} B={B} Tq={Tq} Tk={kf.shape[1]} fp32",
            "ms": timer(lambda: fa.flash_attention_cuda(qf, kf, vf, pos, kl,
                                                        scale=scale)),
            "library_ms": timer(lambda: Fn.scaled_dot_product_attention(
                qt, kt, vt, is_causal=t_last is None)),
            "library": "SDPA fp32", "bound_ms": b, "bound_by": by})
        del qf, kf, vf, qt, kt, vt
    K, N, G = cfg.d_model, cfg.vocab_size, cfg.quant.group_size
    codes, sc, _, w = int4_weight(torch, dev, g, K, N, G)
    M = SLOTS * (SPEC_K + 1)
    x = torch.randn((M, K), generator=g, device=dev).to(bf)
    rec, p = int4_call(torch, x, codes, sc, {}, f"int4_matmul M={M}",
                       matmul=True)
    require(p.route == "tc", f"int4 lm head M={M}: route {p.route}")
    Kw, Cg = codes.shape[0], sc.shape[0]
    b, by = bound_ms(M * K * 2 + Kw * N + Cg * N * 4 + M * N * 2,
                     2.0 * M * Kw * N, INT8_OPS_PER_S)
    split = p.group_split or None
    head = {"shape": f"lm head M={M} K={K} N={N} G={G}", "route": p.route,
            "ms": timer(lambda: im.int4_matmul_cuda(x, codes, sc)),
            "plain_ms": timer(lambda: ref.bfp_matmul_ref(x, codes, sc,
                                                         split)),
            "library_ms": None,
            "bf16_dense_ms": timer(lambda: torch.matmul(x, w)),
            "bound_ms": b, "bound_by": by, "errors": {"bfloat16": rec}}
    return {"launch_floor_ms": floor, "fused_linear": linears,
            "flash": flash, "int4_lm_head": head, "fp32_library": simt}


def spec_full_width(torch, np, dev, model, prompts, plain):
    """(a) phase 6's 8 requests at spec_k 4 (draft_keep unset) on the
    dense pool and on bf16, int8 and int4 pages, and (b) a draft_keep 0.5
    run on the dense pool; each beside phase 6's plain run (``plain``:
    label -> (record, tokens)).  Returns (records, the wrappers' launches,
    the draft graphs' derived launches)."""
    total, derived, runs = {}, {}, []
    with FiniteLogits(torch, dev) as finite:
        for label, ref, kw in (
                ("spec_dense", "dense", dict(kv_mode="dense")),
                ("spec_paged_bf16", "paged_bf16", dict(kv_mode="paged")),
                ("spec_paged_int8", "paged_int8",
                 dict(kv_mode="paged", kv_dtype="int8")),
                ("spec_paged_int4", "paged_int4",
                 dict(kv_mode="paged", kv_dtype="int4")),
                (f"spec_dense_keep{SPEC_KEEP}", "dense",
                 dict(kv_mode="dense", draft_keep=SPEC_KEEP))):
            rec, toks, launches = serve_continuous(
                torch, dev, model, finite, label, prompts, 32,
                spec_k=SPEC_K, **kw)
            runs.append(spec_beside(np, rec, toks, *plain[ref]))
            _add(total, launches)
            _add(derived, rec["graph_launches_derived"])
    return runs, total, derived


def spec_witness(torch, np, dev, m32, reqs, new, tokens, logs):
    """(c) The fp32 witness: phase 7's 4 requests on its fp32 weights at
    spec_k 1 and 4, in the dense pool and in fp32 pages, against phase 7's
    plain runs: tokens bit for bit, each request's prompt gate log and
    decode gate columns identical, the same KV accounting (entries stored
    and dense, history hit rates); rolled-back entries in at least one
    paged run.  Returns (records, the wrappers' launches, derived
    launches, seconds)."""
    runs, total, derived, t = [], {}, {}, time.perf_counter()
    with FiniteLogits(torch, dev) as finite:
        for k in (1, SPEC_K):
            for label in ("fp32_dense", "fp32_paged"):
                log = {}
                rec, toks, launches = serve_continuous(
                    torch, dev, m32, finite, f"spec{k}_{label}", reqs, new,
                    log=log, kv_mode=label.split("_")[1], spec_k=k)
                require(all(np.array_equal(a, b) for a, b in zip(
                    toks, tokens[label])), f"spec{k}_{label}: tokens differ "
                    "from the plain engine's")
                ref = logs[label]
                for uid, (pg, cols) in ref["log"]["gates"].items():
                    pg2, cols2 = log["gates"][uid]
                    require(np.array_equal(pg, pg2)
                            and len(cols) == len(cols2)
                            and all(np.array_equal(a, b)
                                    for a, b in zip(cols, cols2)),
                            f"spec{k}_{label}: request {uid}'s gate log "
                            "differs from the plain engine's")
                keys = ["kv_saved_fraction", "attn_keep_frac"] + (
                    ["kv_entries_stored", "kv_entries_dense",
                     "history_hit_rate", "history_hits_per_layer",
                     "kv_entries_saved_fraction"]
                    if label == "fp32_paged" else [])
                diff = {x: (ref["rec"][x], rec[x]) for x in keys
                        if ref["rec"][x] != rec[x]}
                require(not diff, f"spec{k}_{label}: KV accounting differs "
                        f"from the plain engine's: {diff}")
                rec.update(tokens_identical_to_plain=True,
                           gate_logs_identical_to_plain=True,
                           kv_accounting_identical_to_plain=keys)
                _add(total, launches)
                _add(derived, rec["graph_launches_derived"])
                runs.append(rec)
    require(any(r["spec_entries_rolled_back"] > 0 for r in runs
                if "paged" in r["run"]), "no paged fp32 run rolled back")
    return runs, total, derived, time.perf_counter() - t


# ---------------------------------------------------------------------------
# Phase 7: the bf16 divergence of paged from dense, held against fp32
# ---------------------------------------------------------------------------

def _upcast(torch, tree):
    if isinstance(tree, dict):
        return {k: _upcast(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_upcast(torch, v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def _forced_distance(torch, ref, other):
    """Teacher-forced run ``other`` against ``ref`` (both as _forced_run
    returns them): the share of gate decisions that differ (prefill, decode
    steps), the largest logits difference over max|ref|, and the share of
    equal argmaxes."""
    (rl, rg), (ol, og) = ref, other
    rel = max((a - b).abs().max().item() / a.abs().max().item()
              for a, b in zip(rl, ol))
    agree = sum((a.argmax(-1) == b.argmax(-1)).sum().item()
                for a, b in zip(rl, ol)) / sum(a.shape[0] for a in rl)
    dec = (torch.cat([g.flatten() for g in rg[1:]])
           != torch.cat([g.flatten() for g in og[1:]])).float().mean().item()
    pf = (rg[0] != og[0]).float().mean().item()
    return {"gate_mismatch_prefill": pf, "gate_mismatch_decode": dec,
            "logits_max_rel_diff": rel, "argmax_agree": agree}


def _forced_paged_aligned(model, prompts, forced):
    """_forced_paged at full width with its prefill outputs stacked as
    _forced_run returns them (equal prompt lengths)."""
    import torch
    S, T, steps = len(prompts), len(prompts[0]), forced.shape[1]
    per_slot = -(-(T + steps + 1) * model.cfg.num_layers // PAGE)
    logits, gates = _forced_paged(model, prompts, forced, ps=PAGE,
                                  num_pages=S * per_slot,
                                  cap_tokens=T + steps + 1)
    return ([torch.cat(logits[:S])] + logits[S:],
            [torch.stack(gates[:S], 1)] + gates[S:])


def witness(torch, np, dev, model, prompts, bf16_tokens):
    """The same weights in fp32 (the bf16 weights upcast, so only the
    arithmetic differs): the continuous engine in the dense pool and in
    fp32 pages on the first 4 phase-6 requests must give identical tokens
    (and, at chunk 128, phase 12's ``chunk_witness`` on the same copy, and
    phase 13's ``prefix_witness``);
    teacher-forced decode steps (2 prompts × 256 tokens, 16 forced tokens)
    of the dense and the paged path in fp32 must give identical gates and
    logits within 1e-4·max; and the bf16 paged path may flip at most twice
    (+ 1 %) as many decode gates against fp32 as the bf16 dense path does."""
    from repro_torch.core import routing
    from repro_torch.models.model import LanguageModel
    cfg32 = dataclasses.replace(model.cfg, dtype="float32")
    m32 = LanguageModel(cfg32, _upcast(torch, model.params()), device=dev)
    new, reqs = 32, prompts[:SLOTS]
    runs, tokens, logs = [], {}, {}
    with FiniteLogits(torch, dev) as finite:
        for label, kw in (("fp32_dense", dict(kv_mode="dense")),
                          ("fp32_paged", dict(kv_mode="paged"))):
            log = {}
            rec, toks, launches = serve_continuous(torch, dev, m32, finite,
                                                   label, reqs, new, log=log,
                                                   **kw)
            runs.append(rec)
            tokens[label] = toks
            logs[label] = {"rec": rec, "log": log}
    require(all(np.array_equal(a, b) for a, b in zip(
        tokens["fp32_dense"], tokens["fp32_paged"])),
        "fp32 paged tokens differ from fp32 dense at full width")
    agree = {run: token_agreement(np, bf16_tokens[run][:SLOTS],
                                  tokens["fp32_dense"])
             for run in ("dense", "paged_bf16", "paged_int8", "paged_int4")}

    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(0, cfg32.vocab_size, (2, 256)),
                           device=dev)
    forced = torch.as_tensor(rng.integers(0, cfg32.vocab_size, (2, 16)),
                             device=dev)
    margins = []
    orig = routing.gate_from_logits

    def recording(logits):
        margins.append((logits[..., 1] - logits[..., 0]).abs().min().item())
        return orig(logits)

    routing.gate_from_logits = recording
    try:
        ref = _forced_run(m32, toks, forced)
    finally:
        routing.gate_from_logits = orig
    dist = {"fp32_paged": _forced_distance(
        torch, ref, _forced_paged_aligned(m32, list(toks), forced))}
    chunk = chunk_witness(torch, np, dev, m32, reqs, new, tokens, logs)
    prefix = prefix_witness(torch, np, dev, m32)
    spec = spec_witness(torch, np, dev, m32, reqs, new, tokens, logs)
    life = lifecycle_witness(torch, np, dev, m32, reqs, new, tokens)
    fault = faults_witness(torch, np, dev, m32, reqs, new, tokens, logs)
    gather = gather_witness(torch, np, dev, m32)
    del m32
    torch.cuda.empty_cache()
    dist["bf16_dense"] = _forced_distance(
        torch, ref, _forced_run(model, toks, forced))
    dist["bf16_paged"] = _forced_distance(
        torch, ref, _forced_paged_aligned(model, list(toks), forced))
    fp = dist["fp32_paged"]
    require(fp["gate_mismatch_prefill"] == 0.0
            and fp["gate_mismatch_decode"] == 0.0,
            f"fp32 paged gates differ from fp32 dense: {fp}")
    require(fp["logits_max_rel_diff"] <= TOL_LOGITS and fp["argmax_agree"]
            == 1.0, f"fp32 paged logits differ from fp32 dense: {fp}")
    # a paged-only fault at bf16 (a wrong row, scale or cast) would flip
    # far more gates than bf16 rounding does on the dense path
    bd, bp = dist["bf16_dense"], dist["bf16_paged"]
    require(bp["gate_mismatch_decode"]
            <= 2 * bd["gate_mismatch_decode"] + 0.01,
            f"bf16 paged stands farther from fp32 than bf16 dense: {dist}")
    return {"phase": "witness", "config": cfg32.name, "requests": len(reqs),
            "new_tokens": new, "runs": runs,
            "fp32_paged_tokens_identical_to_fp32_dense": True,
            "phase6_tokens_vs_fp32_dense": agree,
            "forced": {"prompts": 2, "prompt_len": 256, "steps": 16,
                       "min_gate_margin_fp32": min(margins),
                       "vs_fp32_dense": dist}}, launches, chunk, prefix, \
        spec, life, fault, gather


# ---------------------------------------------------------------------------
# Phase 8: full-width llama2-7b with int4-BFP weights
# ---------------------------------------------------------------------------

def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def serve_int4(torch, np, dev, model, lock_tokens, cont_tokens, prompts,
               on_weights=None):
    """The phase-5 bf16 weights quantized on the card by the port's
    ``quantize_params`` at llama2-7b's QuantConfig (group 128, pow2 scales:
    every linear of every layer and the lm head), served lock-step (batch
    4 × 512 + 32) and by the continuous engine (the phase-6 requests) in
    the dense pool and in paged bf16 pages, with exact launch counts and
    finite logits.  The share of tokens equal to the bf16 runs is reported
    only: random weights make it no check.  ``on_weights`` (phase 17's
    gather runs) is called with the int4 model before it is freed; its
    result is returned last."""
    from repro_torch.models.model import LanguageModel
    from repro_torch.quant import int4_head, int4_linears, quantize_params
    cfg, L = model.cfg, model.cfg.num_layers
    t = time.perf_counter()
    m4 = LanguageModel(cfg, quantize_params(
        model.params(), cfg.quant.group_size, cfg.quant.pow2_scales),
        device=dev)
    torch.cuda.synchronize(dev)
    quant_s = time.perf_counter() - t
    p4 = m4.params()
    n_int4 = sum("w_int" in sub["inner"][lin] for blk in p4["blocks"]
                 for sub in blk.values() for lin in sub["inner"])
    require(n_int4 == 4 * L and int4_linears(p4) and int4_head(p4),
            f"{n_int4} int4 linears of {4 * L}, lm head int4: "
            f"{int4_head(p4)}")
    lock, launches, toks = serve_full_width(torch, np, dev, m4, quant_s,
                                            phase="int4_serve")
    total = dict(launches)
    same = {"lock_step": token_agreement(np, list(toks), list(lock_tokens))}
    runs, int4_tokens = [lock], {}
    with FiniteLogits(torch, dev) as finite:
        for label, ref_label, kw in (
                ("int4_dense", "dense", dict(kv_mode="dense")),
                ("int4_paged_bf16", "paged_bf16", dict(kv_mode="paged"))):
            rec, toks, launches = serve_continuous(
                torch, dev, m4, finite, label, prompts, 32, **kw)
            runs.append(rec)
            same[label] = token_agreement(np, toks, cont_tokens[ref_label])
            int4_tokens[label] = toks
            for k, v in launches.items():
                total[k] += v
    fused, fused_launches = serve_fused(torch, np, dev, m4, [
        ("fused_int4_dense", prompts, int4_tokens["int4_dense"],
         dict(kv_mode="dense"))])
    with FiniteLogits(torch, dev) as finite:   # phase 12: int4 at chunk 128
        crec, ctoks, claunch = serve_continuous(
            torch, dev, m4, finite, f"chunk{CHUNK}_int4_dense", prompts, 32,
            kv_mode="dense", prefill_chunk=CHUNK)
    check_chunk_run(m4, crec, prompts)
    crec["tokens_equal_to_chunk0"] = token_agreement(
        np, ctoks, int4_tokens["int4_dense"])
    with FiniteLogits(torch, dev) as finite:   # phase 14: int4 weights
        srec, stoks, slaunch = serve_continuous(
            torch, dev, m4, finite, "spec_int4_dense", prompts, 32,
            kv_mode="dense", spec_k=SPEC_K)
    spec_beside(np, srec, stoks, runs[1], int4_tokens["int4_dense"])
    hooked = on_weights(m4) if on_weights is not None else None
    rec = {"phase": "int4", "config": cfg.name, "dtype": cfg.dtype,
           "group_size": cfg.quant.group_size,
           "pow2_scales": cfg.quant.pow2_scales, "int4_linears": n_int4,
           "lm_head_int4": True, "quantize_s": quant_s,
           "weight_bytes": _tree_bytes(p4),
           "bf16_weight_bytes": _tree_bytes(model.params()),
           "runs": runs, "tokens_equal_to_bf16": same}
    del m4, p4
    torch.cuda.empty_cache()
    return rec, total, (fused, fused_launches), (crec, claunch), \
        (srec, slaunch), hooked


# ---------------------------------------------------------------------------
# Phase 9: CPU (plain versions) ≡ CUDA (kernels) on mamba2-2.7b smoke, fp32
# ---------------------------------------------------------------------------

def _mamba_forced(model, toks, forced):
    """Prefill + teacher-forced decode steps: per forward the logits, the
    SSM gate log [L, B(, T)] and the keep statistics (Σ keep, n_routed)."""
    T = toks.shape[1]
    lg, cache, st = model.prefill(toks)
    out = [(lg.float().cpu(), st["ssm_gate"].cpu(),
            st["keep_frac_sum"].item(), st["n_routed"].item())]
    for s in range(forced.shape[1]):
        lg, cache, st = model.decode_step(cache, forced[:, s:s + 1], T + s)
        out.append((lg.float().cpu(), st["ssm_gate"].cpu(),
                    st["keep_frac_sum"].item(), st["n_routed"].item()))
    return out


def _mamba_engines(model, prompts, cont_prompts, new):
    """Lock-step tokens and stats, then the continuous engine over the
    dense pool (2 slots, so slots are reused) with mixed prompt lengths."""
    from repro_torch.serve.engine import ContinuousBatchingEngine, ServeEngine
    lock = ServeEngine(model, max_len=prompts.shape[1] + new).generate(
        prompts, new)
    eng = ContinuousBatchingEngine(model, max_slots=2, max_len=48)
    uids = [eng.submit(p, max_new_tokens=new) for p in cont_prompts]
    out = eng.run()
    return lock, [out["results"][u].tokens for u in uids], out["stats"]


def _mamba_cpu(torch, np, cfg, seed):
    """The smoke model from ``seed`` (routers at unit scale, zero bias) and
    its inputs, run on the cpu with every router margin recorded.  Returns
    (params, inputs, cpu results, smallest margin)."""
    from repro_torch.core import routing
    from repro_torch.kernels import ops
    from repro_torch.models.model import LanguageModel, init_params
    params = routing.neutral_router_bias(
        init_params(cfg, torch.Generator().manual_seed(seed), "cpu"))
    for blk in params["blocks"]:            # routers at unit scale: no gate
        r = blk["mixer"]["router"]          # near the strict-`>` tie
        r["w"] = r["w"] * 50.0
    rng = np.random.default_rng(seed)
    inputs = (torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 21))),
              torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 4))),
              rng.integers(0, cfg.vocab_size, (2, 19)),
              [rng.integers(0, cfg.vocab_size, (n,)) for n in (9, 16, 5, 21)])
    m_cpu = LanguageModel(cfg, params, device="cpu")
    margins = []
    orig = routing.gate_from_logits

    def recording(logits):
        margins.append((logits[..., 1] - logits[..., 0]).abs().min().item())
        return orig(logits)

    routing.gate_from_logits = recording
    try:
        res = (_mamba_forced(m_cpu, *inputs[:2]),
               _mamba_engines(m_cpu, inputs[2], inputs[3], 8))
    finally:
        routing.gate_from_logits = orig
    return params, inputs, res, min(margins)


def parity_mamba(torch, np, dev):
    """CPU ≡ CUDA on the fp32 mamba2-2.7b smoke model (2 layers, chunk 8,
    so the prompts span several chunks and the last one is ragged), with
    exact launch counts of the cuda runs (every SSD scan on the SIMT
    kernel).  Returns (record, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import LanguageModel
    cfg = dataclasses.replace(get_config("mamba2-2.7b").smoke(),
                              dtype="float32")
    tried = {}
    for seed in range(MAMBA_SEEDS):
        params, inputs, (fc, (lc, cc, sc)), margin = _mamba_cpu(
            torch, np, cfg, seed)
        tried[seed] = margin
        if margin >= MIN_MARGIN:
            break
    require(margin >= MIN_MARGIN, f"mamba gate margins {tried} all below "
            f"{MIN_MARGIN}")
    toks, forced, prompts, cont = inputs
    m_gpu = LanguageModel(cfg, params, device=dev)
    rows, steps, prefill, decode = [], [], m_gpu.prefill, m_gpu.decode_step

    def recorded(toks, *a, **k):      # the shape of each prefill it runs
        rows.append(tuple(toks.shape))
        return prefill(toks, *a, **k)

    def stepped(*a, **k):
        steps.append(1)
        return decode(*a, **k)

    m_gpu.prefill, m_gpu.decode_step = recorded, stepped
    ops.reset_kernel_launches()
    fg = _mamba_forced(m_gpu, toks, forced)
    worst = keep_diff = 0.0
    for (la, ga, ka, na), (lb, gb, kb, nb) in zip(fc, fg):
        require(torch.equal(ga, gb), "mamba gate log differs (cpu/cuda)")
        d = (la - lb).abs().max().item() / la.abs().max().item()
        worst = max(worst, d)
        require(d <= TOL_LOGITS, f"mamba logits differ: {d} > {TOL_LOGITS}")
        require(torch.equal(la.argmax(-1), lb.argmax(-1)),
                "mamba greedy tokens differ between cpu and cuda")
        keep_diff = max(keep_diff, abs(ka - kb))
        require(abs(ka - kb) <= TOL_KEEP and na == nb,
                f"mamba keep statistics differ: {ka} vs {kb}, {na} vs {nb}")
    lg, cg, sg = _mamba_engines(m_gpu, prompts, cont, 8)
    torch.cuda.synchronize(dev)
    launches = ops.kernel_launches()
    del m_gpu.prefill, m_gpu.decode_step
    expected = expected_launches(m_gpu, rows, len(steps), 0)
    require(launches == expected and launches["ssd_scan_tc"] == 0,
            f"mamba parity launches {launches} != expected {expected}")
    require(np.array_equal(lc["tokens"], lg["tokens"]),
            "mamba ServeEngine tokens differ between cpu and cuda")
    lk = abs(lc["stats"].attn_keep_frac - lg["stats"].attn_keep_frac)
    require(lk <= TOL_KEEP, f"mamba lock-step keep fraction differs: {lk}")
    require(all(np.array_equal(a, b) for a, b in zip(cc, cg)),
            "mamba continuous tokens differ between cpu and cuda")
    for f in ("prefill_tokens", "decode_tokens", "decode_dispatches",
              "prefill_chunks", "requests_completed"):
        require(getattr(sc, f) == getattr(sg, f),
                f"mamba continuous {f} differs between cpu and cuda")
    require(abs(sc.attn_keep_frac - sg.attn_keep_frac) <= TOL_KEEP,
            "mamba continuous keep fraction differs between cpu and cuda")
    gates = torch.cat([f[1].flatten() for f in fc])
    return {"phase": "parity_mamba", "config": cfg.name, "dtype": cfg.dtype,
            "seed": seed, "margins_tried": tried, "gates_identical": True,
            "gate_decisions": gates.numel(),
            "gate_ones_frac": gates.mean().item(),
            "decode_keep_frac": [f[2] / f[3] for f in fc[1:]],
            "min_gate_margin": margin, "margin_floor": MIN_MARGIN,
            "logits_max_rel_diff": worst, "tol": TOL_LOGITS,
            "keep_stats_max_abs_diff": max(keep_diff, lk),
            "keep_tol": TOL_KEEP, "greedy_tokens_identical": True,
            "serve_tokens_identical": True,
            "continuous_tokens_identical": True,
            "serve_keep_frac": lg["stats"].attn_keep_frac,
            "prefills": len(rows), "decode_steps": len(steps),
            "launches": launches}, launches


# ---------------------------------------------------------------------------
# Phase 10: full-width mamba2-2.7b, lock-step and continuous (dense pool)
# ---------------------------------------------------------------------------

def serve_mamba(torch, np, dev):
    """mamba2-2.7b at its published widths in bf16, seed-0 random weights,
    router biases zeroed: lock-step batch 4 × 512 + 32 and the continuous
    engine on 8 requests of 114-512 prompt tokens + 32 over 4 slots, with
    exact launch counts; a paged mamba engine must raise."""
    from repro_torch.configs import get_config
    from repro_torch.core.routing import neutral_router_bias
    from repro_torch.models.model import LanguageModel
    from repro_torch.serve.engine import ContinuousBatchingEngine
    cfg = get_config("mamba2-2.7b")
    t = time.perf_counter()
    model = LanguageModel(cfg, device=dev, seed=0)
    model = LanguageModel(cfg, neutral_router_bias(model.params()),
                          device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t
    lock, launches, _ = serve_full_width(torch, np, dev, model, init_s,
                                         phase="mamba_serve")
    total = dict(launches)
    rng = np.random.default_rng(0)
    lens = rng.integers(114, 513, 8)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in lens]
    with FiniteLogits(torch, dev) as finite:
        cont, cont_tokens, launches = serve_continuous(
            torch, dev, model, finite, "mamba_dense", prompts, 32,
            kv_mode="dense")
    for k, v in launches.items():
        total[k] += v
    fused = serve_fused(torch, np, dev, model, [
        ("fused_mamba_dense", prompts, cont_tokens, dict(kv_mode="dense"))])
    try:
        ContinuousBatchingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                                 kv_mode="paged")
        paged_raises = False
    except ValueError:
        paged_raises = True
    require(paged_raises, "a paged mamba engine did not raise")
    from repro_torch.serve.errors import ConfigError
    try:                                   # phase 12 (e)
        ContinuousBatchingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                                 prefill_chunk=CHUNK)
        chunk_raises = False
    except ConfigError:
        chunk_raises = True
    require(chunk_raises, "a chunked mamba engine did not raise")
    p = model.params()
    rec = {"phase": "mamba", "config": cfg.name, "dtype": cfg.dtype,
           "layers": cfg.num_layers, "weight_bytes": _tree_bytes(p),
           "params": sum(t.numel() for t in model.parameters()),
           "prompt_lens": lens.tolist(), "runs": [lock, cont],
           "paged_raises": True, "chunked_raises": True}
    del model, p
    torch.cuda.empty_cache()
    return rec, total, fused


# ---------------------------------------------------------------------------
# Phase 15: observability and the request lifecycle
# ---------------------------------------------------------------------------

LIFE_CHUNK = 32   # (c)'s chunk: a warm suffix of 32-128 tokens spans 1-4
#                   iterations, so one can expire in flight
# profile_decode.py's idle share of the same loop, for the trace's split
# to stand beside (PERF.md §5, H100 80GB HBM3 at 700 W: the eager llama
# bf16 decode step, PR 24); the paged fused loop was not profiled
PROFILED_IDLE = {"traced_dense": 0.81, "traced_fused_paged_bf16": None}
TRACE_PHASES = ("plan", "prefill", "dispatch", "sync", "bookkeep")
# each registry counter's ServeStats field
COUNTER_FIELDS = {
    "prefill_tokens_total": "prefill_tokens",
    "decode_tokens_total": "decode_tokens",
    "prefill_seconds_total": "prefill_s",
    "decode_seconds_total": "decode_s",
    "prefill_chunks_total": "prefill_chunks",
    "interleaved_steps_total": "interleaved_steps",
    "requests_completed_total": "requests_completed",
    "decode_dispatches_total": "decode_dispatches",
    "device_seconds_total": "device_s",
    "host_seconds_total": "host_s",
    "preemptions_total": "preemptions",
    "compiles_total": "compiles",
    "epoch_shrinks_total": "epoch_shrinks",
    "requests_cancelled_total": "requests_cancelled",
    "deadline_exceeded_total": "deadline_exceeded",
    "requests_shed_total": "requests_shed",
    "preempt_budget_exhausted_total": "preempt_budget_exhausted",
    "prefix_hits_total": "prefix_hits",
    "prefix_misses_total": "prefix_misses",
    "prefix_tokens_saved_total": "prefix_tokens_saved",
    "faults_injected_total": "faults_injected",
    "dispatch_retries_total": "dispatch_retries",
    "watchdog_strikes_total": "watchdog_strikes",
    "snapshots_total": "snapshots",
    "resumes_total": "resumes",
    "spec_windows_total": "spec_windows",
    "spec_tokens_drafted_total": "spec_tokens_drafted",
    "spec_tokens_accepted_total": "spec_tokens_accepted",
    "spec_entries_rolled_back_total": "spec_entries_rolled_back"}


def count_metrics(m):
    """A registry's count-valued part: every counter, gauge and series,
    each histogram's count; time-valued metrics (``*_seconds*``) reduced
    to their presence and ``compiles_total`` (CUDA graphs captured) left
    out."""
    out = {}
    for kind, fams in m.snapshot().items():
        view = out[kind] = {}
        for name, children in fams.items():
            if name == "compiles_total":
                continue
            timed = "_seconds" in name
            if kind == "histograms":
                view[name] = {k: (h["count"] if timed else h)
                              for k, h in children.items()}
            else:
                view[name] = None if timed else children
    return out


def check_counters(out, label):
    """Every counter of the run's registry equals its ServeStats field; with
    no preemption (which drops a victim's decode accounting with its
    state) the measured KV entries equal the per-request sums."""
    s, results = out["stats"], out["results"].values()
    for name, children in out["metrics"].snapshot()["counters"].items():
        v = children[""]
        if name in COUNTER_FIELDS:
            want = getattr(s, COUNTER_FIELDS[name])
        elif name in ("kv_entries_dense_measured_total",
                      "kv_entries_stored_measured_total"):
            if s.preemptions:
                continue
            field = "kv_dense" if "dense" in name else "kv_stored"
            want = sum(getattr(r, field) for r in results)
        else:
            require(False, f"{label}: counter {name} has no ServeStats "
                    "field")
        require(v == want, f"{label}: counter {name} {v} != its "
                f"ServeStats field {want}")


def life_engine(model, tracer=None, **kw):
    from repro_torch.serve.engine import ContinuousBatchingEngine
    return ContinuousBatchingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                                    page_size=PAGE, trace=tracer, **kw)


def life_run(torch, dev, eng, prompts, new):
    """Submit ``prompts`` and ``run()`` with the wrappers' counts from 0.
    Returns (output, uids, launches, wall seconds)."""
    from repro_torch.kernels import ops
    uids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    torch.cuda.synchronize(dev)
    ops.reset_kernel_launches()
    t = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize(dev)
    return out, uids, ops.kernel_launches(), time.perf_counter() - t


def pages_back(eng, label) -> int:
    """Every page is on the free list but those the prefix records hold,
    and no record is pinned.  Returns the pinned pages."""
    alloc = eng.allocator
    pins = eng.prefix.page_pins() if eng.prefix is not None else {}
    alloc.check_conservation(pins)
    require(alloc.free_pages == eng.num_pages - len(pins),
            f"{label}: pages in use at the end")
    if eng.prefix is not None:
        require(not eng._warm_pending and not any(
            r.in_use for r in eng.prefix._records.values()),
            f"{label}: a prefix record is still pinned")
    return len(pins)


TRACE_ORDER = (False, True, True, False)   # (a)'s runs: tracing off/on


def traced_pair(torch, np, dev, model, label, prompts, new, tmpdir, total,
                **kw):
    """(a): one configuration run four times, tracing off, on, on, off (on:
    a ``Tracer`` saving to a temporary file), so host drift falls on both
    sides: tokens, the wrappers' launches per route, captures and replays
    bit for bit equal; each run's counters equal its ServeStats fields,
    pages back; each trace balanced on every track
    (``tools/trace_summary.py``), no span left open.  Returns the record
    and the tokens."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import trace_summary
    from repro_torch.obs import Tracer
    runs = []
    for i, on in enumerate(TRACE_ORDER):
        tracer = Tracer(path=os.path.join(tmpdir, f"{label}{i}.json")) \
            if on else None
        eng = life_engine(model, tracer, **kw)
        out, uids, launches, wall = life_run(torch, dev, eng, prompts, new)
        s = out["stats"]
        check_counters(out, label)
        require(s.requests_completed == len(prompts),
                f"{label}: not every request completed")
        if eng.kv_mode == "paged":
            pages_back(eng, label)
        run = {"on": on, "tokens": [out["results"][u].tokens for u in uids],
               "launches": launches, "graphs": (s.compiles, s.graph_replays),
               "tok_per_s": s.decode_tok_per_s, "wall_s": wall}
        _add(total, launches)
        if on:
            require(tracer.open_spans() == {},
                    f"{label}: spans left open {tracer.open_spans()}")
            events = trace_summary.load_events(str(tracer.path))
            trace_summary.pair_spans(events)       # raises if unbalanced
            summ = trace_summary.summarize(events)
            step = summ["step_wall_us"]
            run.update(events=len(events), steps=summ["n_steps"],
                       shares={p: summ["phase_us"].get(p, 0.0) / step
                               for p in TRACE_PHASES})
        runs.append(run)
        free_engine(torch, eng)
    first = runs[0]
    for r in runs[1:]:
        require(all(np.array_equal(a, b) for a, b in zip(first["tokens"],
                                                         r["tokens"])),
                f"{label}: tracing changed the tokens")
        require(r["launches"] == first["launches"] and r["graphs"]
                == first["graphs"], f"{label}: tracing changed the launches "
                f"{first['launches']} {first['graphs']} -> {r['launches']} "
                f"{r['graphs']}")
    traced = [r for r in runs if r["on"]]
    return {"run": label, "order_on": list(TRACE_ORDER),
            "decode_tok_per_s": [r["tok_per_s"] for r in runs],
            "wall_s": [r["wall_s"] for r in runs],
            "on_over_off": (sum(r["tok_per_s"] for r in traced)
                            / sum(r["tok_per_s"] for r in runs
                                  if not r["on"])),
            "graphs_captured": first["graphs"][0],
            "trace_events": [r["events"] for r in traced],
            "trace_steps": traced[0]["steps"],
            "step_shares": [r["shares"] for r in traced],
            "profile_decode_idle_share": PROFILED_IDLE[label],
            "launches": first["launches"]}, first["tokens"]


def stream_interleaved(torch, np, dev, model, prompts, new, plain, total):
    """(b): two handles' ``tokens()`` consumed a token at a time in turn,
    then ``run()`` drains the rest: every request's tokens equal the plain
    run's, and each stream holds its request's tokens, each index once."""
    from repro_torch.kernels import ops
    eng = life_engine(model, kv_mode="dense")
    hs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    pair = (hs[1], hs[5])
    got = {int(h): [] for h in pair}
    ops.reset_kernel_launches()
    live = [(h, h.tokens()) for h in pair]
    while live:
        for h, it in list(live):
            try:
                got[int(h)].append(int(next(it)[0]))
            except StopIteration:
                live.remove((h, it))
    out = eng.run()
    torch.cuda.synchronize(dev)
    _add(total, ops.kernel_launches())
    toks = [out["results"][int(h)].tokens for h in hs]
    require(all(np.array_equal(a, b) for a, b in zip(toks, plain)),
            "streamed run's tokens differ from the plain run's")
    for h in pair:
        require(got[int(h)] == out["results"][int(h)].tokens.tolist(),
                f"request {int(h)}: streamed tokens differ from its result")
    return {"handles": [int(h) for h in pair],
            "streamed": {int(h): len(v) for h, v in got.items()},
            "tokens_identical_to_plain": True}


def lifecycle_prefix(torch, np, dev, model, total):
    """(c) on bf16 pages in fused epochs with the prefix cache on, chunk
    LIFE_CHUNK, phase 13's traffic: the publisher's run, then its 8
    requests with ``max_queue_depth`` 8: the 4th submitted with deadline 0,
    a 9th submission shed, the 1st cancelled after its 4th streamed token,
    and a warm admission with a tail past one chunk whose deadline is made
    to fire in flight (shortened to what it has waited once its first
    suffix chunk ran).  Finish reasons and partial tokens checked; after
    each run every page is free but the records', and none is pinned."""
    from repro_torch.serve.errors import AdmissionRejected
    first, prompts = prefix_traffic(np, model.cfg.vocab_size)
    eng = prefix_engine(model, prefix_cache=True, decode_steps=FUSED_STEPS,
                        prefill_chunk=LIFE_CHUNK,
                        max_queue_depth=PREFIX_REQUESTS)
    out, _, launches, _ = life_run(torch, dev, eng, [first], PREFIX_NEW)
    _add(total, launches)
    pages_back(eng, "life_publish")
    w = max(i for i, p in enumerate(prompts[:-1])
            if len(p) - PREFIX_LEN > LIFE_CHUNK)
    require(w not in (0, 3), f"no warm tail past a chunk but request {w}")
    hs = [eng.submit(p, max_new_tokens=PREFIX_NEW,
                     deadline_s=0.0 if i == 3 else
                     3600.0 if i == w else None)
          for i, p in enumerate(prompts)]
    try:
        eng.submit(first, max_new_tokens=PREFIX_NEW)
        shed = None
    except AdmissionRejected as e:
        shed = e.reason
    require(shed == "queue_depth", f"the 9th submission was not shed: "
            f"{shed}")
    from repro_torch.kernels import ops
    torch.cuda.synchronize(dev)
    ops.reset_kernel_launches()
    it = hs[0].tokens()
    seen = [int(next(it)[0]) for _ in range(4)]
    eng.cancel(hs[0])

    def in_flight():
        pf = eng.scheduler.prefilling
        return (pf is not None and pf.req.uid == int(hs[w])
                and pf.slot in eng._warm_pending and pf.done > PREFIX_LEN)

    for _ in range(256):
        if in_flight():
            break
        require(eng._pump(), "the warm admission never went in flight")
    require(in_flight(), "the warm admission never went in flight")
    pf = eng.scheduler.prefilling
    pinned = sum(r.in_use for r in eng.prefix._records.values())
    pf.req.deadline_s = time.perf_counter() - pf.req.submit_s
    out = eng.run()
    torch.cuda.synchronize(dev)
    _add(total, ops.kernel_launches())
    s, res = out["stats"], out["results"]
    reasons = [res[int(h)].finish_reason for h in hs]
    a = res[int(hs[0])].tokens.tolist()
    require(reasons[0] == "cancelled" and 4 <= len(a) < PREFIX_NEW
            and a[:4] == seen, f"cancelled request: {reasons[0]}, "
            f"{len(a)} tokens, streamed {seen} vs {a[:4]}")
    for i in (3, w):
        require(reasons[i] == "deadline" and not len(res[int(hs[i])].tokens),
                f"request {i}: {reasons[i]}, want a deadline, no tokens")
    rest = [i for i in range(len(hs)) if i not in (0, 3, w)]
    require(all(reasons[i] == "length" and len(res[int(hs[i])].tokens)
                == PREFIX_NEW for i in rest), f"survivors: {reasons}")
    require((s.requests_cancelled, s.deadline_exceeded, s.requests_shed)
            == (1, 2, 1), f"lifecycle counters {s.requests_cancelled}, "
            f"{s.deadline_exceeded}, {s.requests_shed}")
    check_counters(out, "life_prefix")
    pins = pages_back(eng, "life_prefix")
    rec = {"reasons": reasons, "cancelled_tokens": len(a),
           "warm_expired": w, "warm_pins_at_expiry": pinned,
           "shed": shed, "prefix_hits": s.prefix_hits,
           "pinned_pages_after": pins, "epoch_shrinks": s.epoch_shrinks}
    free_engine(torch, eng)
    return rec


def budget_run(torch, np, dev, model, short, tight, want, total):
    """(c) ``max_preemptions`` 0 in phase 6's tight pool: a request evicted
    once finishes "preempt_budget" with its partial tokens, a prefix of
    its phase-6 tokens; the others give phase 6's tokens; pages back."""
    eng = life_engine(model, kv_mode="paged", num_pages=tight,
                      max_preemptions=0)
    out, uids, launches, _ = life_run(torch, dev, eng, short, 32)
    _add(total, launches)
    s = out["stats"]
    spent = 0
    for u, full in zip(uids, want):
        r = out["results"][u]
        toks = r.tokens.tolist()
        if r.finish_reason == "preempt_budget":
            spent += 1
            require(len(toks) < 32 and toks == full.tolist()[:len(toks)],
                    f"request {u}: partial tokens are not a prefix")
        else:
            require(r.finish_reason == "length" and toks == full.tolist(),
                    f"request {u}: {r.finish_reason}, tokens differ")
    require(spent >= 1 and s.preempt_budget_exhausted == spent
            == s.preemptions, f"preempt budget: {spent} finished, "
            f"{s.preempt_budget_exhausted} counted, {s.preemptions} "
            "preemptions")
    check_counters(out, "life_budget")
    pages_back(eng, "life_budget")
    free_engine(torch, eng)
    return {"pool_pages": tight, "preempt_budget": spent,
            "reasons": [out["results"][u].finish_reason for u in uids]}


def lifecycle_full_width(torch, np, dev, model, prompts, tokens, short,
                         tight):
    """Phase 15's bf16 part on phase 6's weights: (a) tracing on beside
    off, dense single-step and bf16 pages in fused epochs; (b) streaming;
    (c) the lifecycle levers.  Returns (record, the wrappers' launches)."""
    import shutil
    import tempfile
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    total = {}
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        dense, plain = traced_pair(torch, np, dev, model, "traced_dense",
                                   prompts, 32, tmpdir, total,
                                   kv_mode="dense")
        fused, _ = traced_pair(torch, np, dev, model,
                               "traced_fused_paged_bf16", prompts, 32,
                               tmpdir, total, kv_mode="paged",
                               decode_steps=FUSED_STEPS)
    finally:
        shutil.rmtree(tmpdir)
    require(all(np.array_equal(a, b) for a, b in zip(plain,
                                                     tokens["dense"])),
            "traced_dense: tokens differ from phase 6's dense run")
    stream = stream_interleaved(torch, np, dev, model, prompts, 32, plain,
                                total)
    life = lifecycle_prefix(torch, np, dev, model, total)
    budget = budget_run(torch, np, dev, model, short, tight,
                        tokens["short_paged_bf16"], total)
    return {"traced": [dense, fused], "streaming": stream,
            "lifecycle": life, "preempt_budget": budget,
            "seconds": time.perf_counter() - t}, total


def lifecycle_witness(torch, np, dev, m32, reqs, new, tokens):
    """(d) on phase 7's fp32 weights: one of the witness's 4 requests
    cancelled after its 2nd streamed token, dense and in fp32 pages: the
    other 3 give the witness's uncancelled tokens bit for bit, the
    cancelled one a prefix of its own.  Returns (record, launches)."""
    from repro_torch.kernels import ops
    rec, total = {}, {}
    for label, kw in (("fp32_dense", dict(kv_mode="dense")),
                      ("fp32_paged", dict(kv_mode="paged"))):
        eng = life_engine(m32, **kw)
        hs = [eng.submit(p, max_new_tokens=new) for p in reqs]
        torch.cuda.synchronize(dev)
        ops.reset_kernel_launches()
        it = hs[1].tokens()
        seen = [int(next(it)[0]) for _ in range(2)]
        eng.cancel(hs[1])
        out = eng.run()
        torch.cuda.synchronize(dev)
        _add(total, ops.kernel_launches())
        res = [out["results"][int(h)] for h in hs]
        want = [t.tolist() for t in tokens[label]]
        part = res[1].tokens.tolist()
        require(res[1].finish_reason == "cancelled" and 2 <= len(part)
                < new and part == want[1][:len(part)] and part[:2] == seen,
                f"{label}: the cancelled request gave {len(part)} tokens, "
                f"{res[1].finish_reason}")
        require(all(res[i].tokens.tolist() == want[i] for i in (0, 2, 3)),
                f"{label}: a survivor's tokens differ from the witness's")
        if eng.kv_mode == "paged":
            pages_back(eng, label)
        free_engine(torch, eng)
        rec[label] = {"cancelled_tokens": len(part),
                      "survivors_identical": True}
    return rec, total


# ---------------------------------------------------------------------------
# Phase 16: faults, the watchdog and crash-consistent snapshots
# ---------------------------------------------------------------------------

FAULT_REQUESTS, FAULT_NEW = 4, 16   # (a)-(b): 4 of phase 6's requests, +16
FAULT_STALL_S = 0.05       # (a)'s stall, under a watchdog without a timeout
HUNG_STALL_S, HUNG_TIMEOUT_S = 0.5, 0.25      # (d)
FAULT_LOOPS = (
    ("dense", dict(kv_mode="dense")),
    ("dense_fused", dict(kv_mode="dense", decode_steps=FUSED_STEPS)),
    ("dense_spec", dict(kv_mode="dense", spec_k=SPEC_K)),
    ("paged", dict(kv_mode="paged")),
    ("paged_fused", dict(kv_mode="paged", decode_steps=FUSED_STEPS)),
    ("paged_spec", dict(kv_mode="paged", spec_k=SPEC_K)),
)
# each robustness counter: its ServeStats field and its trace instant
ROBUST = {"faults_injected_total": ("faults_injected", "fault"),
          "watchdog_strikes_total": ("watchdog_strikes", "watchdog"),
          "snapshots_total": ("snapshots", "snapshot"),
          "resumes_total": ("resumes", "resume")}
# (c): the launcher's paged fused run, killed at boundary PROC_KILL_AT
PROC_ARGS = ("--arch", "llama2-7b", "--num-layers", str(LLAMA_LAYERS),
             "--device", "cuda", "--continuous", "--paged-kv",
             "--decode-steps", str(FUSED_STEPS), "--batch", str(SLOTS),
             "--prompt-len", "128", "--new-tokens", "16")
PROC_KILL_AT, PROC_SNAPSHOT_EVERY = 4, 2
# (a)'s OOM: a paged loop admits one prompt an iteration, so by iteration 2
# two residents stand, and one can be preempted for the other.  A fused
# epoch's or a window's headroom spans many steps, so one hide forces a
# shrink or a preemption; a single step's worst case is L entries, one page
# at 16 layers, so a resident may still hold that much slack: the
# single-step loop hides every free page for OOM_WINDOW iterations
OOM_STEP = 2
OOM_WINDOW = 4


def oom_steps(kw) -> tuple:
    """The iterations (a)'s OOM hides every free page at, for a paged
    loop of engine levers ``kw``."""
    if kw.get("decode_steps", 1) > 1 or kw.get("spec_k"):
        return (OOM_STEP,)
    return tuple(range(OOM_STEP, OOM_STEP + OOM_WINDOW))


def fault_steps(kw) -> tuple:
    """Iterations (d, s) a loop's faults fire at: a fused epoch or a window
    covers several tokens, so those loops run fewer iterations.  A paged
    loop admits one prompt an iteration, so a retry before the last
    admission moves it against the residents' progress: in single-step
    decode that shifts whole steps (counted exactly), but in speculation
    it reshapes the windows (γ, so the verify's rows and routes), and
    bf16 routes round differently (ROADMAP queue 3); the paged spec loop's
    bf16 faults fire after its last admission, and (e) holds a retry
    amid admissions there in fp32."""
    if kw.get("decode_steps", 1) > 1:
        return 0, 1
    if kw.get("spec_k"):
        return ((FAULT_REQUESTS, FAULT_REQUESTS + 1)
                if kw["kv_mode"] == "paged" else (1, 2))
    return 2, 5


def instants(events) -> dict:
    out = {}
    for e in events:
        if e.get("ph") == "i":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def span_seconds(events, name) -> list:
    """Durations of the engine track's ``name`` spans, in seconds."""
    out, opened = [], []
    for e in events:
        if e.get("name") != name or e.get("tid") != 0:
            continue
        if e["ph"] == "B":
            opened.append(e["ts"])
        elif e["ph"] == "E":
            out.append((e["ts"] - opened.pop()) * 1e-6)
    return out


def robust_counters(m, stats, events, label) -> dict:
    """Each robustness counter equals its ServeStats field (when the run
    returned) and the count of its trace instants."""
    seen = instants(events)
    got = {}
    for name, (field, inst) in ROBUST.items():
        v = int(m.value(name))
        if stats is not None:
            require(v == getattr(stats, field), f"{label}: {name} {v} != "
                    f"ServeStats.{field} {getattr(stats, field)}")
        require(v == seen.get(inst, 0), f"{label}: {name} {v} != its "
                f"{seen.get(inst, 0)} '{inst}' instants")
        got[field] = v
    return got


def leak_free(eng, label) -> None:
    sched = eng.scheduler
    require(not sched.active and not sched.queue and sched.prefilling is None
            and sched.free_slots == eng.max_slots, f"{label}: slots left "
            "taken")
    if eng.kv_mode == "paged":
        pages_back(eng, label)


def fault_run(torch, dev, model, label, prompts, new, watch=None,
              windows=None, **kw):
    """One traced run on a fresh engine (``kw``: engine levers, faults and
    the watchdog included): the wrappers' launches counted from 0, every
    request completed, slots and pages back.  ``watch`` (a list) receives
    each (phase, dispatch-to-sync seconds) the watchdog seam sees;
    ``windows`` (a list) each speculative window's (iteration, γ, {uid:
    (first token index, tokens emitted)}, staging extent: the largest
    position + γ + 1).  Returns (output, tokens, launches, trace events,
    engine)."""
    from repro_torch.obs import Tracer
    eng = life_engine(model, Tracer(), **kw)
    if watch is not None:
        observe = eng._watch

        def watched(rs, phase, seconds):
            watch.append((phase, seconds))
            return observe(rs, phase, seconds)
        eng._watch = watched
    if windows is not None:
        bookkeep = eng._spec_bookkeep

        def recorded(rs, cur, gamma, plan_emit, *a, **k):
            act = {s: eng.scheduler.active[s] for s in cur}
            windows.append((rs.disp_idx, gamma, {
                st.req.uid: (len(st.out_tokens), len(plan_emit[s]))
                for s, st in act.items()},
                max(st.pos for st in act.values()) + gamma + 1))
            return bookkeep(rs, cur, gamma, plan_emit, *a, **k)
        eng._spec_bookkeep = recorded
    out, uids, launches, _ = life_run(torch, dev, eng, prompts, new)
    res = [out["results"][u] for u in uids]
    require(all(r.finish_reason == "length" and len(r.tokens) == new
                for r in res), f"{label}: not every request completed")
    leak_free(eng, label)
    return out, [r.tokens for r in res], launches, eng.tracer.events, eng


def fault_matrix(torch, np, dev, model, prompts, total):
    """(a): each of the six loops clean, with 2 dispatch errors, with a
    stall of FAULT_STALL_S under a Watchdog without a hard timeout and,
    paged, with an OOM hiding every free page for one iteration.  Returns
    ({loop: record}, {loop: (clean tokens, clean stats)})."""
    from repro_torch.serve.faults import Fault, Watchdog
    rec, clean = {}, {}
    for loop, kw in FAULT_LOOPS:
        d, s = fault_steps(kw)
        plans = [("clean", []),
                 ("dispatch_error", [Fault("dispatch_error", step=d),
                                     Fault("dispatch_error", step=s)]),
                 ("stall", [Fault("stall", step=d, stall_s=FAULT_STALL_S)])]
        if kw["kv_mode"] == "paged":
            plans.append(("oom", [Fault("oom", step=i, pages=0)
                                  for i in oom_steps(kw)]))
            if kw.get("spec_k"):
                # reported, not held: bf16 rounding follows the windows
                # (fault_steps; (e) holds it in fp32)
                plans.append(("dispatch_error_admitting",
                              [Fault("dispatch_error", step=i)
                               for i in (1, 2)]))
        runs, watch, wins = {}, [], {}
        for kind, faults in plans:
            label = f"fault_{loop}_{kind}"
            out, toks, launches, events, eng = fault_run(
                torch, dev, model, label, prompts, FAULT_NEW, faults=faults,
                watch=watch, watchdog=Watchdog() if kind == "stall" else None,
                windows=wins.setdefault(kind, []) if kw.get("spec_k")
                else None, **kw)
            _add(total, launches)
            st = out["stats"]
            require(not eng.faults.unfired(), f"{label}: faults that never "
                    f"fired: {eng.faults.unfired()}")
            check_counters(out, label)
            counts = robust_counters(out["metrics"], st, events, label)
            require(counts["faults_injected"] == len(faults),
                    f"{label}: {counts['faults_injected']} faults counted, "
                    f"{len(faults)} planned")
            retries = (len(faults) if kind.startswith("dispatch_error")
                       else 0)
            require(st.dispatch_retries == retries, f"{label}: "
                    f"{st.dispatch_retries} retries, want {retries}")
            r = {"dispatch_retries": st.dispatch_retries,
                 "preemptions": st.preemptions,
                 "epoch_shrinks": st.epoch_shrinks, **counts,
                 "decode_dispatches": st.decode_dispatches}
            if kind == "clean":
                clean[loop] = (toks, st, launches)
            else:
                same, first = token_agreement(np, toks, clean[loop][0])
                if kind == "oom":
                    require(st.preemptions >= 1 or st.epoch_shrinks >= 1,
                            f"{label}: the hidden pages forced nothing")
                    r.update(tokens_equal_share=same, first_divergence=first)
                elif kind == "dispatch_error_admitting":
                    r.update(tokens_equal_share=same, first_divergence=first,
                             divergence=spec_divergence(
                                 model, np, toks, clean[loop][0], wins[kind],
                                 wins["clean"]))
                else:
                    require(same == 1.0, f"{label}: tokens differ from the "
                            f"clean run's (first divergence {first})")
                    r["tokens_identical_to_clean"] = True
                    if kw.get("decode_steps", 1) == 1 and not kw.get(
                            "spec_k"):
                        r.update(single_step_launches(
                            model, label, launches, st, *clean[loop][1:]))
            runs[kind] = r
            free_engine(torch, eng)
        runs["longest_sync_s"] = max(t for _, t in watch)
        rec[loop] = runs
    return rec, clean


def spec_divergence(model, np, toks, toks0, wins, wins0):
    """The first token of a run that differs from the clean run's: its
    request and index, and in each run the window that emitted it: γ, the
    verify's rows and their routes (the fused linears', flash's), the
    staging extent and flash's split of it into blocks of keys."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_linear as fl
    from repro_torch.models import layers
    cfg = model.cfg
    for u, (a, b) in enumerate(zip(toks, toks0)):
        if np.array_equal(a, b):
            continue
        i = int(np.argmin(a == b))
        where = {}
        for name, ws in (("faulted", wins), ("clean", wins0)):
            for disp, gamma, em, extent in ws:
                if u in em and em[u][0] <= i < em[u][0] + em[u][1]:
                    C = gamma + 1
                    f = fa.plan(SLOTS * cfg.num_kv_heads,
                                cfg.num_heads // cfg.num_kv_heads * C,
                                extent, cfg.resolved_head_dim,
                                layers.torch_dtype(cfg))
                    where[name] = {
                        "window": disp, "gamma": gamma, "column": i - em[u][0],
                        "verify_rows": SLOTS * C,
                        "fused_linear": fl.plan(SLOTS * C, cfg.d_model,
                                                cfg.d_model, False,
                                                layers.torch_dtype(cfg)).route,
                        "flash": f.route, "staging_extent": extent,
                        "flash_splits": f.splits, "flash_keys_a_block": f.kc}
        return {"request": u, "token": i, "faulted": int(a[i]),
                "clean": int(b[i]), "windows": where}
    return None


def single_step_launches(model, label, launches, st, st0, launches0):
    """A single-step run with a retried dispatch or a stall launches the
    clean run's count on each route, but for whole decode steps: a retry in
    the paged loop, which admits one prompt an iteration, shifts an
    admission by one iteration, and so the decode steps its prompt shares
    with the residents.  Each step it adds or drops counts one decode
    step's launches (``expected_launches``), exactly."""
    extra = st.decode_dispatches - st0.decode_dispatches
    step = expected_launches(model, [], 1, SLOTS, st.kv_mode == "paged")
    want = {k: launches0.get(k, 0) + extra * step.get(k, 0)
            for k in set(launches0) | set(step)}
    nonzero = ({k: v for k, v in d.items() if v} for d in (launches, want))
    got, want = nonzero
    require(got == want, f"{label}: launches {got} != the clean run's with "
            f"{extra} more decode steps {want}")
    return {"launches_identical_to_clean": extra == 0,
            "decode_steps_beyond_clean": extra}


def snapshot_files(d) -> int:
    from repro_torch.serve import snapshot
    step = snapshot.latest_snapshot_step(d)
    path = os.path.join(d, f"{snapshot.SNAP_PREFIX}{step:08d}")
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def kill_and_resume(torch, dev, model, label, prompts, new, n_iter, tmp,
                    log=None, once=False, **kw):
    """(b): a run killed at boundary K = n_iter // 2 (the clean run's
    iterations) after snapshots every K // 2 boundaries (K among them;
    ``once``: at K alone), then a fresh engine over the same model
    ``resume()``s and drains it.  Returns (resumed output, tokens,
    launches, record)."""
    from repro_torch.obs import Tracer
    from repro_torch.serve.errors import SimulatedKill
    from repro_torch.serve.faults import Fault
    K = max(1, n_iter // 2)
    every = K if once else max(1, K // 2)
    K -= K % every                  # a snapshot at the kill's boundary
    d = os.path.join(tmp, label)
    eng = life_engine(model, Tracer(), snapshot_dir=d, snapshot_every=every,
                      faults=[Fault("kill", step=K)], **kw)
    if log is not None:
        watch_engine(eng, log)
    killed = False
    try:
        life_run(torch, dev, eng, prompts, new)
    except SimulatedKill:
        killed = True
    require(killed, f"{label}: the kill at boundary {K} never fired")
    from repro_torch.kernels import ops
    total = ops.kernel_launches()
    m, events = eng.metrics, eng.tracer.events
    robust_counters(m, None, events, f"{label}_killed")
    snaps = span_seconds(events, "snapshot")
    require(m.value("faults_injected_total") == 1 and len(snaps) >= 1,
            f"{label}: killed with {len(snaps)} snapshots")
    nbytes = snapshot_files(d)
    free_engine(torch, eng)
    del eng
    eng = life_engine(model, Tracer(), **kw)
    if log is not None:
        watch_engine(eng, log)
    apply_s, restore = [], eng._apply_resume

    def timed(rs, kv):
        t = time.perf_counter()
        restore(rs, kv)
        torch.cuda.synchronize(dev)
        apply_s.append(time.perf_counter() - t)
    eng._apply_resume = timed
    t = time.perf_counter()
    at = eng.resume(d)
    load_s = time.perf_counter() - t
    require(at == K, f"{label}: resumed at {at}, killed at {K}")
    torch.cuda.synchronize(dev)
    ops.reset_kernel_launches()
    out = eng.run()
    torch.cuda.synchronize(dev)
    _add(total, ops.kernel_launches())
    s = out["stats"]
    robust_counters(out["metrics"], s, eng.tracer.events, label)
    require(s.resumes == 1 and s.snapshots == 0, f"{label}: {s.resumes} "
            f"resumes, {s.snapshots} snapshots after the resume")
    res = [out["results"][u] for u in sorted(out["results"])]
    require(len(res) == len(prompts) and all(
        r.finish_reason == "length" and len(r.tokens) == new for r in res),
        f"{label}: not every request completed after the resume")
    leak_free(eng, label)
    free_engine(torch, eng)
    return out, [r.tokens for r in res], total, {
        "killed_at": K, "snapshot_every": every, "snapshots": len(snaps),
        "snapshot_bytes": nbytes, "snapshot_s": snaps,
        "resume_load_s": load_s, "resume_apply_s": apply_s[0]}


def kill_resume_matrix(torch, np, dev, model, prompts, clean, tmp, total):
    """(b) in the six loops, then fused dense at FUSED_TEMPERATURE: the
    killed and resumed run's tokens equal the uninterrupted run's from the
    same seed (the generator's state restored)."""
    rec = {}
    for loop, kw in FAULT_LOOPS:
        toks0, s0, _ = clean[loop]
        n_iter = s0.spec_windows if kw.get("spec_k") else s0.decode_dispatches
        _, toks, launches, r = kill_and_resume(
            torch, dev, model, f"resume_{loop}", prompts, FAULT_NEW, n_iter,
            tmp, **kw)
        _add(total, launches)
        require(all(np.array_equal(a, b) for a, b in zip(toks, toks0)),
                f"resume_{loop}: tokens differ from the clean run's")
        rec[loop] = dict(r, tokens_identical_to_clean=True)
    kw = dict(kv_mode="dense", decode_steps=FUSED_STEPS,
              temperature=FUSED_TEMPERATURE)
    out, toks0, launches, _, eng = fault_run(
        torch, dev, model, "resume_sampled_clean", prompts, FAULT_NEW, **kw)
    _add(total, launches)
    n_iter = out["stats"].decode_dispatches
    free_engine(torch, eng)
    _, toks, launches, r = kill_and_resume(
        torch, dev, model, "resume_sampled", prompts, FAULT_NEW, n_iter, tmp,
        **kw)
    _add(total, launches)
    require(all(np.array_equal(a, b) for a, b in zip(toks, toks0)),
            "resume_sampled: tokens differ from the uninterrupted run's")
    rec["dense_fused_sampled"] = dict(r, temperature=FUSED_TEMPERATURE,
                                      tokens_identical_to_uninterrupted=True)
    return rec


def launcher(tmp, name, *extra):
    """Start the launcher with PROC_ARGS and ``extra`` as a subprocess, its
    output in ``build/``.  Returns (name, process, log path, start)."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    log = os.path.join(LOG_DIR, f"chip_smoke_proc_{name}.log")
    with open(log, "w") as f:
        p = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", *PROC_ARGS,
             *extra], cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
    return name, p, log, time.perf_counter()


def waited(proc, want, rec) -> str:
    """Wait for a ``launcher`` process; its exit code must be ``want``.
    Returns the end of its output."""
    name, p, log, t = proc
    rc = p.wait(timeout=300)
    with open(log) as f:
        tail = f.read()[-2000:]
    require(rc == want, f"(c) {name}: exit code {rc}, want {want}:\n{tail}")
    rec[f"{name}_s"] = time.perf_counter() - t
    return tail


def spawn_processes(tmp) -> list:
    """(c)'s clean and killed processes, started before (a) so that they
    run beside it (they share no state with this process)."""
    return [launcher(tmp, "clean", "--results-out",
                     os.path.join(tmp, "proc_clean.json")),
            launcher(tmp, "killed", "--snapshot-dir",
                     os.path.join(tmp, "proc_snaps"), "--snapshot-every",
                     str(PROC_SNAPSHOT_EVERY), "--kill-at",
                     str(PROC_KILL_AT))]


def across_processes(tmp, spawned) -> dict:
    """(c): the launcher as three processes at full width (paged bf16,
    fused epochs): clean, killed at boundary PROC_KILL_AT (exit code 3),
    then resumed from the killed one's snapshots; the resumed run's
    per-request tokens and finish reasons equal the clean run's."""
    rec = {"args": list(PROC_ARGS), "kill_at": PROC_KILL_AT}
    clean, killed = spawned
    waited(clean, 0, rec)
    waited(killed, 3, rec)
    tail = waited(launcher(tmp, "resumed", "--snapshot-dir",
                           os.path.join(tmp, "proc_snaps"), "--resume",
                           "--results-out",
                           os.path.join(tmp, "proc_resumed.json")), 0, rec)
    require("resumes 1" in tail, f"(c) resumed: no resume:\n{tail}")
    with open(os.path.join(tmp, "proc_clean.json")) as f:
        a = json.load(f)
    with open(os.path.join(tmp, "proc_resumed.json")) as f:
        b = json.load(f)
    require(a == b, "(c): the resumed process's results differ from the "
            "clean process's")
    rec.update(requests=len(a), results_identical=True)
    return rec


def hung_dispatch(torch, dev, model, prompts, tmp) -> dict:
    """(d): a HUNG_STALL_S stall against ``timeout_s`` HUNG_TIMEOUT_S
    raises ``HungDispatch`` carrying the flushed trace's path; the file
    exists and ``watchdog_timeouts_total`` is 1."""
    from repro_torch.obs import Tracer
    from repro_torch.serve.errors import HungDispatch
    from repro_torch.serve.faults import Fault, Watchdog
    path = os.path.join(tmp, "hung.json")
    eng = life_engine(model, Tracer(path=path), kv_mode="dense",
                      watchdog=Watchdog(timeout_s=HUNG_TIMEOUT_S),
                      faults=[Fault("stall", step=0,
                                    stall_s=HUNG_STALL_S)])
    eng.submit(prompts[0], max_new_tokens=4)
    err = None
    try:
        eng.run()
    except HungDispatch as e:
        err = e
    require(err is not None, "(d): the stall past the timeout did not raise")
    require(err.trace_path == path and os.path.exists(path), "(d): trace "
            f"{err.trace_path} not flushed")
    require(eng.metrics.value("watchdog_timeouts_total") == 1,
            "(d): watchdog_timeouts_total != 1")
    rec = {"phase": err.phase, "elapsed_s": err.elapsed_s,
           "timeout_s": HUNG_TIMEOUT_S, "trace_bytes": os.path.getsize(path)}
    free_engine(torch, eng)
    return rec


def faults_full_width(torch, np, dev, model, prompts):
    """Phase 16's bf16 part on phase 6's weights: (a) the fault matrix, (b)
    kill and resume in-process, (c) across processes (its first two
    started first, beside (a) and (b): each holds its own model, this
    process one), (d) the watchdog's hard timeout.  Returns (record, the
    wrappers' launches)."""
    import shutil
    import tempfile
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    total = {}
    reqs = prompts[:FAULT_REQUESTS]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_snaps_")
    spawned = spawn_processes(tmp)
    try:
        matrix, clean = fault_matrix(torch, np, dev, model, reqs, total)
        t_b = time.perf_counter()
        resume = kill_resume_matrix(torch, np, dev, model, reqs, clean, tmp,
                                    total)
        t_c = time.perf_counter()
        proc = across_processes(tmp, spawned)
        t_d = time.perf_counter()
        hung = hung_dispatch(torch, dev, model, reqs, tmp)
    finally:
        for _, p, _, _ in spawned:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"requests": len(reqs), "new_tokens": FAULT_NEW,
            "matrix": matrix, "kill_resume": resume,
            "across_processes": proc, "hung_dispatch": hung,
            "seconds_a": t_b - t, "seconds_b": t_c - t_b,
            "seconds_c": t_d - t_c,
            "seconds": time.perf_counter() - t}, total


def watch_incarnations(eng, log):
    """``watch_engine`` whose record of a request restarts when its prefill
    completes again (after a preemption): the log holds its last
    incarnation's prompt gate log and decode columns."""
    watch_engine(eng, log)
    gates, finish = log["gates"], eng._finish_prefill

    def fresh(rs, work, *a, **k):
        gates[work.req.uid] = [None, []]
        return finish(rs, work, *a, **k)
    eng._finish_prefill = fresh


def same_logs(np, a, b) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[u][0], b[u][0]) and len(a[u][1]) == len(b[u][1])
        and all(np.array_equal(x, y) for x, y in zip(a[u][1], b[u][1]))
        for u in a)


def faults_witness(torch, np, dev, m32, reqs, new, tokens, logs):
    """(e) on phase 7's fp32 weights: an OOM hiding every free page in fp32
    pages, single-step and in fused epochs (each preempting at least once),
    two dispatch retries amid a paged spec_k 4 run's admissions, and a
    paged fused run killed and resumed: tokens, each request's gate logs
    (its last incarnation's) and KV accounting bit for bit the clean fp32
    run's (single-step and spec: phase 7's; fused: a clean fused run's).
    Returns (record, launches, seconds)."""
    import shutil
    import tempfile
    from repro_torch.serve.faults import Fault
    t, total, rec = time.perf_counter(), {}, {}
    per_req = ("kv_stored", "kv_dense", "finish_reason")
    whole = ("kv_saved_fraction", "attn_keep_frac", "kv_entries_stored",
             "kv_entries_dense", "history_hit_rate", "history_hits_per_layer")

    def observed(out):
        res = [out["results"][u] for u in sorted(out["results"])]
        return ([getattr(r, k) for r in res for k in per_req],
                {k: getattr(out["stats"], k) for k in whole})

    def run(label, log, **kw):
        from repro_torch.obs import Tracer
        eng = life_engine(m32, Tracer(), **kw)
        watch_incarnations(eng, log)
        out, uids, launches, _ = life_run(torch, dev, eng, reqs, new)
        _add(total, launches)
        toks = [out["results"][u].tokens for u in uids]
        leak_free(eng, label)
        free_engine(torch, eng)
        return out, toks

    paged = dict(kv_mode="paged")
    fused = dict(paged, decode_steps=FUSED_STEPS)
    clean_log = {}
    out_c, toks_c = run("fp32_fused_clean", clean_log, **fused)
    require(all(np.array_equal(a, b) for a, b in zip(
        toks_c, tokens["fp32_paged"])), "fp32 fused pages: tokens differ "
        "from the single-step run's")
    refs = {"paged": (tokens["fp32_paged"], logs["fp32_paged"]["log"]
                      ["gates"], None),
            "paged_fused": (toks_c, clean_log["gates"], observed(out_c))}
    # single-step: (a)'s window of hides (``oom_steps``), in which some
    # resident needs a page; fused: the first hide halves the epoch down to
    # the step the prefills reserved, the later ones find no step's
    # headroom left (at 16 layers a prefill's reserve can cover one more
    # epoch: four hides); speculation: two retries amid the admissions,
    # which reshape the windows (fp32 spec ≡ plain)
    for name, loop, kw, faults in (
            ("oom_paged", "paged", paged,
             [Fault("oom", step=i, pages=0) for i in oom_steps(paged)]),
            ("oom_paged_fused", "paged_fused", fused,
             [Fault("oom", step=i, pages=0) for i in range(4)]),
            ("retry_paged_spec", "paged", dict(paged, spec_k=SPEC_K),
             [Fault("dispatch_error", step=i) for i in (1, 2)])):
        log = {}
        out, toks = run(f"fp32_{name}", log, **kw, faults=faults)
        s = out["stats"]
        if name.startswith("oom"):
            require(s.preemptions >= 1, f"fp32_{name}: no preemption")
        require(s.faults_injected == len(faults), f"fp32_{name}: "
                f"{s.faults_injected} of {len(faults)} faults fired")
        want_toks, want_log, _ = refs[loop]
        require(all(np.array_equal(a, b) for a, b in zip(toks, want_toks)),
                f"fp32_{name}: tokens differ from the clean run's")
        require(same_logs(np, log["gates"], want_log),
                f"fp32_{name}: gate logs differ from the clean run's")
        if loop == "paged_fused":
            require(observed(out)[0] == refs[loop][2][0],
                    f"fp32_{name}: per-request KV accounting differs")
        else:
            want = logs["fp32_paged"]["rec"]["kv_saved_fraction"]
            require(s.kv_saved_fraction == want, f"fp32_{name}: KV saved "
                    f"{s.kv_saved_fraction} != the clean run's {want}")
        rec[name] = {"preemptions": s.preemptions,
                     "epoch_shrinks": s.epoch_shrinks,
                     "dispatch_retries": s.dispatch_retries,
                     "identical_to_clean": True}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_snaps_")
    try:
        log = {}
        n_iter = out_c["stats"].decode_dispatches
        out, toks, launches, r = kill_and_resume(
            torch, dev, m32, "fp32_resume_paged_fused", reqs, new, n_iter,
            tmp, log=log, once=True, **fused)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _add(total, launches)
    require(all(np.array_equal(a, b) for a, b in zip(toks, toks_c)),
            "fp32 kill/resume: tokens differ from the clean run's")
    require(same_logs(np, log["gates"], clean_log["gates"]),
            "fp32 kill/resume: gate logs differ from the clean run's")
    require(observed(out) == refs["paged_fused"][2],
            "fp32 kill/resume: KV accounting differs from the clean run's")
    rec["resume_paged_fused"] = dict(r, identical_to_clean=True)
    return rec, total, time.perf_counter() - t


# ---------------------------------------------------------------------------
# Phase 17: gather-mode routing; qwen3-8b (qk-norm, G = 4)
# ---------------------------------------------------------------------------

GATHER_B = 4
GATHER_T = (512, 453)   # (a)'s prompts: C 384 of 512, the ragged 344 of 453
GATHER_MARGIN = 1e-4    # (b): a C-th / (C+1)-th score gap below this is a
#                         near tie, reported instead of failing
GATHER_TURNS = 3        # (c): masked and gather prefills timed in turns
WITNESS_BIAS = 100.0    # (d): router keep bias under which every gate is 1


def with_mode(cfg, mode, keep=None):
    """cfg with routing ``mode`` (and ``keep_prob``)."""
    skip = dataclasses.replace(cfg.skip, mode=mode)
    if keep is not None:
        skip = dataclasses.replace(skip, keep_prob=keep)
    return dataclasses.replace(cfg, skip=skip)


def gather_flash(torch, dev, timer, cfg, floor):
    """Flash attention at a gather prefill's geometry: q of the C =
    ``capacity(T)`` rows a seeded score selects (sorted, with gaps) over
    all T keys, kv_len None as the prefill passes it, B 4, the config's
    heads; T 512 (C 384) and T 453 (C 344).  bf16 on the tensor-core tile
    and fp32 on the SIMT kernel against the plain version (``flash_call``:
    phase 3's tolerances, the mirror, a second launch bit for bit), timed
    beside the plain version, SDPA with a boolean mask of the same keys
    and masked-mode flash over all T rows; bound: q, out and the keys up
    to each sequence's last selected position, 4·dh operations per (row,
    valid key) pair."""
    import torch.nn.functional as Fn
    from repro_torch.core import routing
    from repro_torch.kernels import flash_attention as fa
    B, H, dh, Hkv = GATHER_B, cfg.num_heads, cfg.resolved_head_dim, \
        cfg.num_kv_heads
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(17)
    scale = 1.0 / math.sqrt(dh)
    out = []
    for T in GATHER_T:
        C = routing.capacity(T, cfg.skip.keep_prob)
        score = torch.randn((B, T), generator=g, device=dev)
        qpos = routing.select_topc(score, C).to(torch.int32)
        q = torch.randn((B, C, H, dh), generator=g, device=dev).to(bf)
        k = torch.randn((B, T, Hkv, dh), generator=g, device=dev).to(bf)
        v = torch.randn((B, T, Hkv, dh), generator=g, device=dev).to(bf)
        what = f"flash gathered B={B} C={C} of T={T}"
        errs = {}
        for dt in (bf, torch.float32):
            a = [t.to(dt) for t in (q, k, v)]
            errs[str(dt).split(".")[-1]] = flash_call(
                torch, *a, qpos, None, f"{what} {dt}", scale=scale)
        route = errs["bfloat16"]["route"]
        require(route == "wgmma", f"{what}: route {route}")
        keys = torch.arange(T, device=dev)
        mask = keys[None, None, None, :] <= qpos[:, None, :, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        qm = torch.randn((B, T, H, dh), generator=g, device=dev).to(bf)
        pm = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
        ms_k = timer(lambda: fa.flash_attention_cuda(q, k, v, qpos, None,
                                                     scale=scale))
        ms_p = timer(lambda: fa.flash_attention_plain(q, k, v, qpos, None,
                                                      scale=scale))
        ms_l = timer(lambda: Fn.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        ms_m = timer(lambda: fa.flash_attention_cuda(qm, k, v, pm, None,
                                                     scale=scale))
        pairs = H * int((qpos.long() + 1).sum().item())
        last = int((qpos.long().amax(1) + 1).sum().item())
        nbytes = (2 * B * C * H * dh + 2 * last * Hkv * dh) * 2
        b, by = bound_ms(nbytes, 4.0 * pairs * dh)
        out.append({"shape": f"gathered B={B} C={C} of T={T} H={H} "
                             f"Hkv={Hkv} dh={dh}", "route": route,
                    "ms": ms_k, "plain_ms": ms_p, "library_ms": ms_l,
                    "library": "SDPA, boolean mask of the same keys",
                    "masked_all_rows_ms": ms_m, "bound_ms": b,
                    "bound_by": by, "launch_floor_ms": floor,
                    "errors": errs})
        del q, k, v, qt, kt, vt, qm, mask
    return out


def gather_kernels(torch, np, dev, timer, cfg, qcfg, floor):
    """(a) The kernels at phase 17's new shapes: flash over gathered q
    positions (``gather_flash``), the four llama linears at M = B·C = 1536
    (``linears_at``), and at qwen3-8b's G = 4 flash's tile and split-KV
    walk (``check_flash``: prefill 4 × 512, decode B 4 against 544 rows)
    and paged attention's split walk (``check_paged``: bf16, int8 and int4
    pages, fp32 q on the SIMT kernel)."""
    from repro_torch.core import routing
    g = torch.Generator(device=dev).manual_seed(18)
    M = GATHER_B * routing.capacity(GATHER_T[0], cfg.skip.keep_prob)
    return {"launch_floor_ms": floor,
            "flash_gathered": gather_flash(torch, dev, timer, cfg, floor),
            "fused_linear_gathered": linears_at(torch, dev, timer, cfg, M, g),
            "qwen3_flash": check_flash(torch, dev, timer, qcfg),
            "qwen3_paged": check_paged(torch, np, dev, timer, qcfg)}


class Selections:
    """Records every ``routing.select_topc`` call: the indices (on the
    host) and the gap between the C-th and (C+1)-th score of each row."""

    def __init__(self):
        from repro_torch.core import routing
        self.routing, self.orig = routing, routing.select_topc
        self.idx, self.gaps = [], []

    def __enter__(self):
        def recording(score, cap):
            s = score.sort(dim=-1, descending=True).values
            if cap < score.shape[-1]:
                self.gaps.append((s[:, cap - 1] - s[:, cap]).cpu())
            idx = self.orig(score, cap)
            self.idx.append(idx.cpu())
            return idx
        self.routing.select_topc = recording
        return self

    def __exit__(self, *exc):
        self.routing.select_topc = self.orig

    def near(self):
        """(call, row, gap) of every nonzero gap below GATHER_MARGIN (a
        gap of exactly 0 is two equal rows: a repeated token at the first
        layer, which both devices score alike)."""
        return [(i, r, float(x)) for i, gap in enumerate(self.gaps)
                for r, x in enumerate(gap.tolist()) if 0 < x < GATHER_MARGIN]


def _smoke_model(torch, cfg, dev):
    """The fp32 smoke parameters of phase 4: seeded, neutral router bias,
    routers at unit scale (no gate near its tie)."""
    from repro_torch.core import routing
    from repro_torch.models.model import LanguageModel, init_params
    params = routing.neutral_router_bias(
        init_params(cfg, torch.Generator().manual_seed(PARITY_SEED), "cpu"))
    for blk in params["blocks"]:
        for sub in blk.values():
            sub["router"]["w"] = sub["router"]["w"] * 50.0
    return (LanguageModel(cfg, params, device="cpu"),
            LanguageModel(cfg, params, device=dev))


def gather_parity(torch, np, dev):
    """(b) CPU ≡ CUDA in gather mode, fp32: llama2-7b smoke and qwen3-8b
    smoke with num_kv_heads 2 (G 2), 2 prompts of 32 tokens (C 24) and 3
    teacher-forced steps, then ``ServeEngine.generate`` (exact launch
    counts on the cuda run) and the continuous dense pool (prompts of 9,
    21, 32 and 40 tokens).  Compared in order: selected indices, gate
    logs, logits (≤ 1e-4·max), tokens.  Where the cpu run has a C-th /
    (C+1)-th score pair closer than GATHER_MARGIN, a difference is
    reported with the pair instead of failing."""
    from repro_torch.configs import get_config
    from repro_torch.core import routing
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ContinuousBatchingEngine, ServeEngine
    rec = {"phase": "gather_parity", "margin": GATHER_MARGIN,
           "tol": TOL_LOGITS}
    for arch, kv in (("llama2-7b", None), ("qwen3-8b", 2)):
        cfg = get_config(arch).smoke()
        cfg = with_mode(dataclasses.replace(
            cfg, dtype="float32",
            num_kv_heads=kv or cfg.num_kv_heads), "gather")
        m_cpu, m_gpu = _smoke_model(torch, cfg, dev)
        rng = np.random.default_rng(PARITY_SEED)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 32)))
        forced = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 3)))
        margins, orig = [], routing.gate_from_logits

        def recording(logits):
            margins.append((logits[..., 1] - logits[..., 0]).abs().min()
                           .item())
            return orig(logits)

        routing.gate_from_logits = recording
        try:
            with Selections() as sc:
                lc, gc = _forced_run(m_cpu, toks, forced)
        finally:
            routing.gate_from_logits = orig
        require(min(margins) >= MIN_MARGIN,
                f"{arch}: gate margin {min(margins)} < {MIN_MARGIN}")
        with Selections() as sg:
            lg, gg = _forced_run(m_gpu, toks, forced)
        near = sc.near()
        diffs = []
        require(len(sc.idx) == len(sg.idx) == 2 * cfg.num_layers,
                f"{arch}: {len(sc.idx)} / {len(sg.idx)} selections")
        for i, (a, b) in enumerate(zip(sc.idx, sg.idx)):
            if not torch.equal(a, b):
                diffs.append(f"selection {i}")
        for a, b in zip(gc, gg):
            if not torch.equal(a, b):
                diffs.append("gate log")
        worst = 0.0
        for a, b in zip(lc, lg):
            d = (a - b).abs().max().item() / a.abs().max().item()
            worst = max(worst, d)
            if d > TOL_LOGITS or not torch.equal(a.argmax(-1),
                                                 b.argmax(-1)):
                diffs.append(f"logits {d}")
        require(not diffs or near, f"{arch}: cpu and cuda differ in "
                f"gather mode with no near tie: {diffs}")
        prompts = rng.integers(0, cfg.vocab_size, (2, 32))
        oc = ServeEngine(m_cpu, max_len=40).generate(prompts, 8)
        ops.reset_kernel_launches()
        og = ServeEngine(m_gpu, max_len=40).generate(prompts, 8)
        launches = ops.kernel_launches()
        expected = expected_launches(m_gpu, [prompts.shape], 8, 2)
        require(launches == expected, f"{arch} gather launches {launches} "
                f"!= expected {expected}")
        same = bool(np.array_equal(oc["tokens"], og["tokens"]))
        cont = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
                for n in (9, 21, 32, 40)]
        outs = []
        for m in (m_cpu, m_gpu):
            eng = ContinuousBatchingEngine(m, max_slots=2, max_len=48)
            uids = [eng.submit(p, max_new_tokens=6) for p in cont]
            res = eng.run()["results"]
            outs.append([res[u].tokens for u in uids])
        cont_same = all(np.array_equal(a, b) for a, b in zip(*outs))
        if not (same and cont_same):
            diffs.append("engine tokens")
        require(not diffs or near, f"{arch}: engine tokens differ (cpu/cuda) "
                "with no near tie")
        gates = torch.cat([g.flatten() for g in gc])
        rec[arch] = {"kv_heads": cfg.num_kv_heads,
                     "capacity": routing.capacity(32, cfg.skip.keep_prob),
                     "selections": len(sc.idx),
                     "selections_identical": not any(
                         d.startswith("selection") for d in diffs),
                     "gates_identical": "gate log" not in diffs,
                     "logits_max_rel_diff": worst,
                     "serve_tokens_identical": same,
                     "continuous_tokens_identical": cont_same,
                     "serve_launches": launches,
                     "min_gate_margin": min(margins),
                     "min_selection_gap": min(
                         (float(x) for gap in sc.gaps for x in gap.tolist()
                          if x > 0), default=None),
                     "near_ties": near[:8], "differences": diffs,
                     "gate_ones_frac": gates.mean().item()}
    return rec


def time_prefills(torch, dev, models, toks, turns=GATHER_TURNS):
    """Each model's prefill of ``toks`` (cache room for 32 more) timed on
    the host clock around a synchronize, in turns a b b a ...: the median
    seconds of each."""
    times = [[] for _ in models]
    order = list(range(len(models)))
    for t in range(turns):
        for i in (order if t % 2 == 0 else order[::-1]):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            models[i].prefill(toks, pad_to=toks.shape[1] + 32)
            torch.cuda.synchronize(dev)
            times[i].append(time.perf_counter() - t0)
    return [statistics.median(x) for x in times]


GATHER_REFUSALS = (("paged", dict(kv_mode="paged")),
                   ("chunked", dict(prefill_chunk=CHUNK)),
                   ("bucketed", dict(prefill_buckets=(256, MAX_LEN))),
                   ("speculative", dict(spec_k=SPEC_K)))


def gather_refusals(model):
    """Each lever that needs masked mode raises the reference's error type
    for a gather-mode engine: ValueError (chunked: ``ConfigError``, a
    ValueError, as the port's chunk refusal raises for any stack)."""
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.errors import ConfigError
    out = {}
    for name, kw in GATHER_REFUSALS:
        want = ConfigError if name == "chunked" else ValueError
        try:
            ContinuousBatchingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                                     **kw)
        except ValueError as e:
            require(isinstance(e, want), f"gather {name}: raised "
                    f"{type(e).__name__}, want {want.__name__}")
            out[name] = type(e).__name__
            continue
        raise RuntimeError(f"gather {name}: the engine did not refuse")
    return out


def gather_runs(torch, np, dev, model, prompts, label, fused=True):
    """``model``'s weights in gather mode (shared, not copied): lock-step
    4 × 512 + 32 (``serve_full_width``, exact launches per route), the
    continuous dense pool single-step and, with ``fused``, in fused 8-step
    epochs (``serve_continuous``, exact launches, no host sync in the
    fused run's deferred prefills, the single-step run's tokens); the
    masked and gather prefills of the lock-step batch timed in turns, the
    refusals.  Returns (record, launches, the fused run's derived graph
    launches or {}, the continuous runs' tokens)."""
    from repro_torch.core import routing
    from repro_torch.models.model import LanguageModel
    cfg = model.cfg
    gm = LanguageModel(with_mode(cfg, "gather"), model.params(), device=dev)
    lock, total, lock_toks = serve_full_width(torch, np, dev, gm, 0.0,
                                              phase=f"{label}_lockstep")
    total = dict(total)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (GATHER_B, 512)), device=dev)
    masked_s, gather_s = time_prefills(torch, dev, (model, gm), toks)
    runs, tokens = [lock], {}
    loops = [(f"{label}_dense", dict(kv_mode="dense"))]
    if fused:
        loops.append((f"{label}_fused_dense",
                      dict(kv_mode="dense", decode_steps=FUSED_STEPS)))
    with FiniteLogits(torch, dev) as finite:
        for run, kw in loops:
            rec, tokens[run], launches = serve_continuous(
                torch, dev, gm, finite, run, prompts, 32, trace=False, **kw)
            runs.append(rec)
            _add(total, launches)
    derived = {}
    if fused:
        derived = runs[-1]["graph_launches_derived"]
        require(all(np.array_equal(a, b) for a, b in zip(
            tokens[f"{label}_dense"], tokens[f"{label}_fused_dense"])),
            f"{label}: fused epochs changed the gather dense pool's tokens")
    C = routing.capacity(512, cfg.skip.keep_prob)
    return {"lockstep": lock, "runs": runs[1:],
            "capacity": f"{C} of 512",
            "prefill_s_turns": {"masked": masked_s, "gather": gather_s,
                                "gather_over_masked": gather_s / masked_s,
                                "turns": GATHER_TURNS},
            "refusals": gather_refusals(gm)}, total, derived, tokens


def gather_witness(torch, np, dev, m32):
    """(d) fp32 at full width (phase 5's depth): keep_prob 1.0 (C = T) and
    every router's keep bias raised by WITNESS_BIAS, so every gate is 1
    (asserted); then gather ≡ masked on 2 prompts of 128 tokens and 4
    teacher-forced steps: equal gate logs and argmax tokens, logits ≤
    1e-4·max apart."""
    from repro_torch.models.model import LanguageModel

    def biased(tree):
        if isinstance(tree, dict):
            return {k: (dict(v, b=v["b"] + torch.tensor(
                [0.0, WITNESS_BIAS], device=v["b"].device))
                if k == "router" else biased(v)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [biased(v) for v in tree]
        return tree

    params = biased(m32.params())
    rng = np.random.default_rng(17)
    toks = torch.as_tensor(rng.integers(0, m32.cfg.vocab_size, (2, 128)),
                           device=dev)
    forced = torch.as_tensor(rng.integers(0, m32.cfg.vocab_size, (2, 4)),
                             device=dev)
    t = time.perf_counter()
    runs = {}
    for mode in ("masked", "gather"):
        m = LanguageModel(with_mode(m32.cfg, mode, 1.0), params, device=dev)
        runs[mode] = _forced_run(m, toks, forced)
    (lm, gm_), (lg, gg) = runs["masked"], runs["gather"]
    require(all(bool((g == 1).all()) for g in gm_),
            "witness bias left a gate at 0")
    require(all(torch.equal(a, b) for a, b in zip(gm_, gg)),
            "gather gate logs differ from masked at C = T")
    rel = max((a - b).abs().max().item() / a.abs().max().item()
              for a, b in zip(lm, lg))
    require(rel <= TOL_LOGITS, f"gather logits differ from masked at C = T: "
            f"{rel} > {TOL_LOGITS}")
    require(all(torch.equal(a.argmax(-1), b.argmax(-1))
                for a, b in zip(lm, lg)), "gather tokens differ from masked")
    return {"layers": m32.cfg.num_layers, "prompts": 2, "prompt_len": 128,
            "steps": 4, "keep_prob": 1.0, "router_keep_bias": WITNESS_BIAS,
            "all_gates_one": True, "logits_max_rel_diff": rel,
            "bit_identical": all(torch.equal(a, b) for a, b in zip(lm, lg)),
            "tokens_identical": True, "seconds": time.perf_counter() - t}


def qwen3_full_width(torch, np, dev):
    """(e) qwen3-8b at its published widths in bf16 (36 layers, G = 4,
    qk-norm; seed-0 random weights, neutral router bias): lock-step 4 ×
    512 + 32 masked, the continuous engine on 8 requests of phase 6's
    lengths in the dense pool (single-step, fused 8-step epochs) and in
    bf16 pages, then ``gather_runs`` on the same weights; exact launches
    per route (flash's tile and split-KV walk and paged attention's split
    walk at G 4), pages conserved, finite logits."""
    from repro_torch.configs import get_config
    from repro_torch.core.routing import neutral_router_bias
    from repro_torch.models.model import LanguageModel
    cfg = get_config("qwen3-8b")
    t = time.perf_counter()
    model = LanguageModel(cfg, device=dev, seed=0)
    model = LanguageModel(cfg, neutral_router_bias(model.params()),
                          device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t
    lock, total, _ = serve_full_width(torch, np, dev, model, init_s,
                                      phase="qwen3_lockstep")
    total = dict(total)
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 513, 8)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in lens]
    runs, tokens = [], {}
    with FiniteLogits(torch, dev) as finite:
        for run, kw in (("qwen3_dense", dict(kv_mode="dense")),
                        ("qwen3_fused_dense", dict(
                            kv_mode="dense", decode_steps=FUSED_STEPS)),
                        ("qwen3_paged_bf16", dict(kv_mode="paged"))):
            rec, tokens[run], launches = serve_continuous(
                torch, dev, model, finite, run, prompts, 32, trace=False,
                **kw)
            runs.append(rec)
            _add(total, launches)
    require(all(np.array_equal(a, b) for a, b in zip(
        tokens["qwen3_dense"], tokens["qwen3_fused_dense"])),
        "qwen3: fused epochs changed the dense pool's tokens")
    for k in ("flash_attention_wgmma", "flash_attention_splitkv",
              "paged_attention_split"):
        require(total[k] > 0, f"qwen3: {k} never launched")
    gather, g_launches, g_derived, g_tokens = gather_runs(
        torch, np, dev, model, prompts, "qwen3_gather")
    _add(total, g_launches)
    derived = dict(runs[1]["graph_launches_derived"])
    _add(derived, g_derived)
    same = token_agreement(np, g_tokens["qwen3_gather_dense"],
                           tokens["qwen3_dense"])
    rec = {"config": cfg.name, "layers": cfg.num_layers,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "qk_norm": cfg.qk_norm, "init_s": init_s,
           "weight_bytes": _tree_bytes(model.params()), "lockstep": lock,
           "prompt_lens": lens.tolist(), "runs": runs, "gather": gather,
           "gather_tokens_equal_to_masked": same}
    del model
    torch.cuda.empty_cache()
    return rec, total, derived


# ---------------------------------------------------------------------------
# Phase 18: gemma3-12b (LOCAL ring caches, GeGLU, head dim 256)
# ---------------------------------------------------------------------------

GEMMA_LOCK = (2, 1536, 32)       # (b): lock-step batch, prompt, new tokens
GEMMA_PROMPTS = (1000, 1020, 1536, 300)  # (b): the dense pool's requests
GEMMA_NEW = 64                   # their new tokens: 1000 and 1020 cross t =
#                                  W = 1024 in decode, 1536 starts past it
GEMMA_MAX_LEN = 1536 + GEMMA_NEW
GEMMA_INT4 = (2, 1536, 8)        # (b): int4 lock-step, a few tokens
GEMMA_WITNESS_LAYERS = 6         # (c): one 5:1 pattern, full widths
GEMMA_WITNESS_T = 1100           # (c): the forced prompt (> W: a ring)
GEMMA_WITNESS_STEPS = 4
GEMMA_WITNESS_ENGINE = (1020, 1060)  # (c): a pool crossing the wrap
GEMMA_WITNESS_NEW = 8
GEMMA_REFUSALS = (("paged", dict(kv_mode="paged")),
                  ("chunked", dict(prefill_chunk=CHUNK)),
                  ("bucketed", dict(prefill_buckets=(256, GEMMA_MAX_LEN))),
                  ("speculative", dict(spec_k=SPEC_K)),
                  ("prefix_cache", dict(prefix_cache=True)))


def gemma_linears(torch, dev, timer, cfg):
    """(a) The GELU epilogue on every fused-linear route at gemma3-12b's
    widths: its four linears (wqkv 3840→8192, wo 4096→3840, gu
    3840→2·15360 with GeGLU, down 15360→3840) and gu's up half without
    the GLU under GELU ("gelu_up"), dense bf16 at M 2048 on the tile and
    M 4 on the split-K stream (``fused_linear_call``: TOL_BF16·max, Σy²
    against the operand the route feeds, a second launch bit for bit),
    gu in fp32 on the SIMT kernel at M 4; int4-BFP codes (group 128, pow2
    scales) at M 2048 on the s8 tile and M 4 on the code stream
    (``int4_call``: the plain version in the route's order, one ulp plus
    TOL_GELU·|y| times |up|), gu and gelu_up also in fp32 activations.
    Each bf16 call timed beside its plain version and ``torch.matmul`` (the
    dense route) or the bf16 dense route (int4), with phase 3's bounds; a
    dense GELU call also beside the same call under SiLU."""
    from repro_torch.kernels import fused_linear as fl, ref
    g = torch.Generator(device=dev).manual_seed(31)
    G = cfg.quant.group_size
    shapes = [s + ("gelu" if s[3] else None,) for s in linear_shapes(cfg)]
    up = next(s for s in shapes if s[0] == "gu")
    shapes.append(("gelu_up", up[1], up[2] // 2, False, True, False,
                   "gelu"))
    out = {"wgmma": [], "splitk": [], "simt": [], "tc": [], "stream": []}
    for M in (2048, 4):
        for name, K, N, glu, pro, epi, act in shapes:
            F = N // 2 if glu else N
            codes, scale, w_exact, w = int4_weight(torch, dev, g, K, N, G)
            x, kw = linear_inputs(torch, dev, g, M, K, F, glu, pro, epi,
                                  act=act)
            what = f"gemma fused_linear {name} M={M}"
            rec = fused_linear_call(torch, x, w, kw, f"{what} bf16")
            _, rkw = _cast(torch, kw, torch.bfloat16)
            nbytes = (M * K + K * N + M * F) * 2 + (
                (K * 2 + M * 4) if pro else 0) + (
                (M * F * 2 + M * 8) if epi else 0)
            b, by = bound_ms(nbytes, 2.0 * M * K * N)
            row = {"shape": f"{name} M={M} K={K} N={N} act={act}",
                   "route": rec["route"],
                   "ms": timer(lambda: fl.fused_linear_cuda(x, w, **kw)),
                   "plain_ms": timer(lambda: ref.fused_linear_ref(x, w,
                                                                  **rkw)),
                   "library_ms": timer(lambda: torch.matmul(x, w)),
                   "bound_ms": b, "bound_by": by, "errors": {
                       "bfloat16": rec}}
            if act == "gelu":           # the same call under SiLU
                silu = dict(kw, act="silu")
                row["silu_ms"] = timer(
                    lambda: fl.fused_linear_cuda(x, w, **silu))
            if M == 4 and name == "gu":      # the SIMT kernel, fp32
                f32, _ = _cast(torch, kw, torch.float32)
                xf, wf = x.float(), w.float()
                simt = fused_linear_call(torch, xf, wf, f32, f"{what} fp32")
                b32, by32 = bound_ms((M * K + K * N + M * F) * 4 + K * 4
                                     + M * 4, 2.0 * M * K * N,
                                     FP32_OPS_PER_S)
                out["simt"].append({
                    "shape": row["shape"], "route": simt["route"],
                    "ms": timer(lambda: fl.fused_linear_cuda(xf, wf, **f32)),
                    "plain_ms": None,
                    "library_ms": timer(lambda: torch.matmul(xf, wf)),
                    "bound_ms": b32, "bound_by": by32,
                    "errors": {"float32": simt}})
                del xf, wf
            out[rec["route"]].append(row)
            errs = {}
            dts = ((torch.bfloat16, torch.float32) if name in ("gu",
                   "gelu_up") else (torch.bfloat16,))
            for dt in dts:
                cast, rcast = _cast(torch, kw, dt)
                w4 = f"gemma fused_linear_int4 {name} M={M} {dt}"
                r4, p4 = int4_call(torch, x.to(dt), codes, scale, cast, w4)
                o4, _ = fl.fused_linear_int4_cuda(x.to(dt), codes, scale,
                                                  **cast)
                eo, _ = ref.fused_linear_ref(x.to(dt), w_exact.to(dt),
                                             **rcast)
                torch.cuda.synchronize()
                ee, em = max_err(torch, o4, eo)
                require(ee <= TOL_BFP * em, f"{w4}: {ee} from the exact "
                        f"dequant > {TOL_BFP}·{em}")
                r4.update(exact_dequant_err=ee, exact_dequant_max=em)
                errs[str(dt).split(".")[-1]] = r4
                del o4, eo
            split = p4.group_split or None
            Kw, C = codes.shape[0], scale.shape[0]
            nb4 = (M * K + M * F) * 2 + Kw * N + C * N * 4 + (
                (K * 2 + M * 4) if pro else 0) + (
                (M * F * 2 + M * 8) if epi else 0)
            b4, by4 = bound_ms(nb4, 2.0 * M * Kw * N, INT8_OPS_PER_S)
            out[p4.route].append({
                "shape": f"{name} M={M} K={K} N={N} G={G} act={act}",
                "route": p4.route,
                "ms": timer(lambda: fl.fused_linear_int4_cuda(
                    x, codes, scale, **kw)),
                "plain_ms": timer(lambda: ref.fused_linear_ref(
                    x, w_codes=codes, scale=scale, split_groups=split,
                    **rkw)),
                "library_ms": None, "bf16_dense_ms": row["ms"],
                "bound_ms": b4, "bound_by": by4, "tol": INT4_TOL,
                "errors": errs})
            del x, kw, codes, scale, w_exact, w
    return out


def gemma_flash(torch, dev, timer, cfg):
    """(a) Flash attention at head dim 256, gemma3-12b's 16 heads over 8
    kv heads: prefill 2 × 1536 (causal, an expanded arange, kv_len None)
    at window 0 (a global layer) and at the LOCAL layers' 1024 on the
    tensor-core tile; decode of 4 slots (``flash_call``: phase 3's
    tolerances, the mirror, a second launch bit for bit) over a LOCAL
    layer's ring of 1024 keys with ragged t (2000, 1100, 699, 36: the ring
    read as the ring decode reads it, kv_len min(t + 1, W), two
    below W) and over a global layer's 1600-row cache (kv_len 1600, 1564,
    1000, 300) on the split-KV walk; each in fp32 on the SIMT kernel.
    Timed beside the plain version and SDPA (GQA; ``is_causal`` for the
    window-0 prefill, a boolean mask where the window or kv_len cuts
    keys), the SIMT kernel beside SDPA on the fp32 inputs (TF32 off).
    Bounds: q, out and the keys a
    row reads (bytes), 4·dh operations a (row, valid key) pair."""
    import torch.nn.functional as Fn
    from repro_torch.kernels import flash_attention as fa
    H, Hkv, dh, W = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                     cfg.window_size)
    g = torch.Generator(device=dev).manual_seed(32)
    scale = 1.0 / math.sqrt(dh)
    bf = torch.bfloat16
    B, T = 2, 1536
    cases = []
    for window in (0, W):
        qpos = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(
            B, T)
        cases.append((f"prefill B={B} T={T} window={window}", (B, T, T),
                      qpos, None, window))
    t = torch.tensor([2000, 1100, 699, 36], dtype=torch.int32, device=dev)
    cases.append((f"decode ring B=4 W={W} t=2000,1100,699,36", (4, 1, W),
                  t[:, None], torch.clamp(t + 1, max=W), 0))
    kvl = torch.tensor([1600, 1564, 1000, 300], dtype=torch.int32,
                       device=dev)
    cases.append(("decode global B=4 Tk=1600 kv_len=1600,1564,1000,300",
                  (4, 1, 1600), kvl[:, None] - 1, kvl, 0))
    out = {"wgmma": [], "splitkv": []}
    for label, (b, Tq, Tk), qpos, kv_len, window in cases:
        q = torch.randn((b, Tq, H, dh), generator=g, device=dev).to(bf)
        k = torch.randn((b, Tk, Hkv, dh), generator=g, device=dev).to(bf)
        v = torch.randn((b, Tk, Hkv, dh), generator=g, device=dev).to(bf)
        kw = dict(scale=scale, window=window)
        errs = {}
        for dt in (bf, torch.float32):
            a = [x.to(dt) for x in (q, k, v)]
            errs[str(dt).split(".")[-1]] = flash_call(
                torch, *a, qpos, kv_len, f"gemma flash {label} {dt}", **kw)
        route = errs["bfloat16"]["route"]
        qf, kf, vf = (x.float() for x in (q, k, v))
        ms_s = timer(lambda: fa.flash_attention_cuda(qf, kf, vf, qpos,
                                                     kv_len, **kw))
        keys = torch.arange(Tk, device=dev)[None, None, None, :]
        qp = qpos.long()[:, None, :, None]
        mask = keys <= qp
        if window:
            mask = mask & (keys > qp - window)
        if kv_len is not None:
            mask = mask & (keys < kv_len.long()[:, None, None, None])
        causal = Tq == Tk and not window      # SDPA's own causal kernel
        qft, kft, vft = (x.transpose(1, 2) for x in (qf, kf, vf))
        ms_sl = timer(lambda: Fn.scaled_dot_product_attention(
            qft, kft, vft, attn_mask=None if causal else mask,
            is_causal=causal, enable_gqa=True))
        del qf, kf, vf, qft, kft, vft
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms_l = timer(lambda: Fn.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=None if causal else mask,
            is_causal=causal, enable_gqa=True))
        ms_k = timer(lambda: fa.flash_attention_cuda(q, k, v, qpos, kv_len,
                                                     **kw))
        ms_p = timer(lambda: fa.flash_attention_plain(q, k, v, qpos, kv_len,
                                                      **kw))
        valid = mask.expand(b, 1, Tq, Tk)
        pairs = H * int(valid.sum().item())
        read = int(valid.any(2).sum().item())        # keys a row reads
        nbytes = (2 * b * Tq * H * dh + 2 * read * Hkv * dh) * 2
        bb, by = bound_ms(nbytes, 4.0 * pairs * dh)
        b32, by32 = bound_ms(2 * nbytes, 4.0 * pairs * dh, FP32_OPS_PER_S)
        out[route].append({
            "shape": f"{label} H={H} Hkv={Hkv} dh={dh}", "route": route,
            "plan": dataclasses.asdict(fa.plan(b * Hkv, H // Hkv * Tq, Tk,
                                               dh, bf)),
            "ms": ms_k, "plain_ms": ms_p, "library_ms": ms_l,
            "library": ("SDPA (GQA), is_causal" if causal else
                        "SDPA (GQA), boolean mask of the same keys"),
            "bound_ms": bb, "bound_by": by,
            "tol": f"bf16 {TOL_BF16}·max|ref|, and one bf16 ulp + "
                   f"{TOL_FLASH_MIRROR}·max of the mirror; fp32 "
                   f"{TOL_F32}·max|ref|",
            "errors": {"bfloat16": errs["bfloat16"]}, "simt_f32_ms": ms_s,
            "simt_f32_library_ms": ms_sl,
            "simt_f32_bound_ms": b32, "simt_f32_bound_by": by32,
            "simt_f32_errors": errs["float32"]})
        del q, k, v, qt, kt, vt, mask, valid
    return out


def seeded_model(torch, dev, cfg, int4=False):
    """``cfg`` at its published widths in bf16: seed-0 random weights
    (``int4``: quantized layer by layer as drawn, ``init_params``), router
    biases zeroed so routing skips.  Returns (model, init_s)."""
    from repro_torch.core.routing import neutral_router_bias
    from repro_torch.models.model import LanguageModel
    t = time.perf_counter()
    model = LanguageModel(cfg, device=dev, seed=0, int4=int4)
    model = LanguageModel(cfg, neutral_router_bias(model.params()),
                          device=dev)
    torch.cuda.synchronize(dev)
    return model, time.perf_counter() - t


def gemma_refusals(model):
    """(d) Every mode the reference refuses for gemma3 raises its error:
    a ValueError (paged, bucketed, speculative; the port's chunk refusal
    a ConfigError, itself a ValueError) and ConfigError for the prefix
    cache, each with the reference's message."""
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.errors import ConfigError
    out = {}
    for name, kw in GEMMA_REFUSALS:
        want = (ConfigError if name in ("chunked", "prefix_cache")
                else ValueError)
        try:
            ContinuousBatchingEngine(model, max_slots=SLOTS,
                                     max_len=GEMMA_MAX_LEN, **kw)
        except ValueError as e:
            require(isinstance(e, want), f"gemma {name}: raised "
                    f"{type(e).__name__}, want {want.__name__}")
            out[name] = f"{type(e).__name__}: {e}"
            continue
        raise RuntimeError(f"gemma {name}: the engine did not refuse")
    return out


def gemma_serve(torch, np, dev, cfg):
    """(b) gemma3-12b at full width in bf16: lock-step 2 × 1536 + 32 (the
    prompt longer than W, so each LOCAL layer's cache is a ring), the
    dense pool single-step and in fused 8-step epochs (4 requests of
    GEMMA_PROMPTS tokens + 64: decode crosses the slot wrap at t = 1024 in
    two slots; the same tokens in both loops), then the weights quantized
    on the card (``quantize_params``, group 128, pow2 scales: every linear,
    the tied head stays the embedding's transpose) lock-step 2 × 1536 + 8,
    so GeGLU runs on the s8 tile and the code stream; exact launches per
    route (flash at dh 256 on the tile and the split-KV walk), finite
    logits, prefill_s, tok/s and peak memory; (d) the refusals.  Returns
    (record, launches summed over the runs, the fused run's derived graph
    launches)."""
    from repro_torch.models.model import LanguageModel
    from repro_torch.quant import int4_head, int4_linears, quantize_params
    model, init_s = seeded_model(torch, dev, cfg)
    B, T0, new = GEMMA_LOCK
    lock, total, lock_toks = serve_full_width(
        torch, np, dev, model, init_s, phase="gemma3_lockstep", B=B, T0=T0,
        new=new)
    total = dict(total)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in GEMMA_PROMPTS]
    runs, tokens = [], {}
    with FiniteLogits(torch, dev) as finite:
        for run, kw in (("gemma3_dense", dict(kv_mode="dense")),
                        ("gemma3_fused_dense", dict(
                            kv_mode="dense", decode_steps=FUSED_STEPS))):
            rec, tokens[run], launches = serve_continuous(
                torch, dev, model, finite, run, prompts, GEMMA_NEW,
                trace=False, max_len=GEMMA_MAX_LEN, **kw)
            runs.append(rec)
            _add(total, launches)
    require(all(np.array_equal(a, b) for a, b in zip(
        tokens["gemma3_dense"], tokens["gemma3_fused_dense"])),
        "gemma3: fused epochs changed the dense pool's tokens")
    for k in ("flash_attention_wgmma", "flash_attention_splitkv",
              "fused_linear_wgmma", "fused_linear_splitk"):
        require(total[k] > 0, f"gemma3: {k} never launched")
    refusals = gemma_refusals(model)
    bf16_bytes = _tree_bytes(model.params())
    t = time.perf_counter()
    m4 = LanguageModel(cfg, quantize_params(
        model.params(), cfg.quant.group_size, cfg.quant.pow2_scales),
        device=dev)
    torch.cuda.synchronize(dev)
    quant_s = time.perf_counter() - t
    require(int4_linears(m4.params()) and not int4_head(m4.params()),
            "gemma3 int4: the linears are not int4, or the tied head is")
    B4, T4, new4 = GEMMA_INT4
    int4, launches, toks4 = serve_full_width(
        torch, np, dev, m4, quant_s, phase="gemma3_int4_lockstep", B=B4,
        T0=T4, new=new4)
    _add(total, launches)
    for k in ("fused_linear_int4_tc", "fused_linear_int4_stream"):
        require(launches[k] > 0, f"gemma3 int4: {k} never launched")
    int4.update(weight_bytes=_tree_bytes(m4.params()),
                bf16_weight_bytes=bf16_bytes,
                tokens_equal_to_bf16=token_agreement(
                    np, list(toks4), [r[:new4] for r in lock_toks]))
    derived = runs[1]["graph_launches_derived"]
    rec = {"config": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim,
           "window": cfg.window_size, "pattern": list(cfg.layer_pattern),
           "mlp_act": cfg.mlp_act, "init_s": init_s,
           "weight_bytes": bf16_bytes, "lockstep": lock,
           "prompt_lens": list(GEMMA_PROMPTS), "new_tokens": GEMMA_NEW,
           "max_len": GEMMA_MAX_LEN, "runs": runs, "int4": int4,
           "refusals": refusals}
    del m4, model
    torch.cuda.empty_cache()
    return rec, total, derived


class GateReplay:
    """Every router decision (``routing.gate_from_logits``) through one
    log.  Inside ``record()`` a run keeps each call's decisions and its
    margins |l1 − l0| on the host.  Inside ``replay()`` a second run holds
    its own decisions against the log call by call: one may differ only
    where the recorded margin is below GATHER_MARGIN (a near tie that fp32
    rounding may flip), every other must agree, and the calls must match
    in number and shape.  The run then takes the recorded decisions, so
    its logits and tokens stay comparable past an excused flip and are
    held without exception.  An MoE block's expert choices
    (``moe.top_k_experts``) go through a second log the same way: each
    token's ordered top K, with the smallest gap between neighbours of its
    K + 1 largest probabilities as its margin; a replayed token whose
    choices differ is excused only below GATHER_MARGIN, and the run takes
    the recorded experts (at its own probabilities)."""

    def __init__(self):
        self.log, self.flips, self.calls = [], [], 0
        self.elog, self.eflips, self.ecalls = [], [], 0
        self._replaying = False

    def record(self):
        self._replaying = False
        self.log.clear()
        self.elog.clear()
        return self

    def replay(self):
        self._replaying, self.calls, self.ecalls = True, 0, 0
        return self

    def __enter__(self):
        from repro_torch.core import routing
        from repro_torch.models import moe
        self._orig = routing.gate_from_logits
        self._eorig = moe.top_k_experts
        routing.gate_from_logits = self._gate
        moe.top_k_experts = self._experts
        return self

    def __exit__(self, kind, *_):
        from repro_torch.core import routing
        from repro_torch.models import moe
        routing.gate_from_logits = self._orig
        moe.top_k_experts = self._eorig
        if self._replaying and kind is None:
            require(self.calls == len(self.log), f"replay: {self.calls} "
                    f"gate calls, the record has {len(self.log)}")
            require(self.ecalls == len(self.elog), f"replay: {self.ecalls} "
                    f"expert calls, the record has {len(self.elog)}")

    def _experts(self, probs, k):
        vals, idx = self._eorig(probs, k)
        if not self._replaying:
            top = vals if probs.shape[-1] == k else self._eorig(
                probs, k + 1)[0]
            margin = (top[:, :-1] - top[:, 1:]).min(dim=-1).values
            self.elog.append((idx.cpu(), margin.cpu()))
            return vals, idx
        require(self.ecalls < len(self.elog), "replay: more expert calls "
                "than the record")
        want, rec = self.elog[self.ecalls]
        own = idx.cpu()
        require(own.shape == want.shape, f"expert call {self.ecalls}: "
                f"shape {tuple(own.shape)}, the record {tuple(want.shape)}")
        differs = (own != want).any(dim=-1)
        flipped = rec[differs]
        require(bool((flipped < GATHER_MARGIN).all()),
                f"expert call {self.ecalls}: a choice differs at a recorded "
                f"margin of {flipped.max().item() if flipped.numel() else 0}"
                f" ≥ {GATHER_MARGIN}")
        self.eflips += [(self.ecalls, m) for m in flipped.tolist()]
        self.ecalls += 1
        want = want.to(idx.device)
        return probs.gather(1, want), want

    def _gate(self, logits):
        gate, p_keep = self._orig(logits)
        if not self._replaying:
            margin = (logits[..., 1] - logits[..., 0]).abs()
            self.log.append((gate.cpu(), margin.cpu()))
            return gate, p_keep
        require(self.calls < len(self.log), "replay: more gate calls than "
                "the record")
        want, rec = self.log[self.calls]
        own = gate.cpu()
        require(own.shape == want.shape, f"gate call {self.calls}: shape "
                f"{tuple(own.shape)}, the record {tuple(want.shape)}")
        flipped = rec[own != want]
        require(bool((flipped < GATHER_MARGIN).all()),
                f"gate call {self.calls}: a decision differs at a recorded "
                f"margin of {flipped.max().item() if flipped.numel() else 0}"
                f" ≥ {GATHER_MARGIN}")
        self.flips += [(self.calls, m) for m in flipped.tolist()]
        self.calls += 1
        return want.to(gate.device), p_keep

    def summary(self) -> dict:
        out = {"gate_calls": len(self.log),
               "decisions": sum(g.numel() for g, _ in self.log),
               "min_margin": min(m.min().item() for _, m in self.log),
               "below_margin": sum(int((m < GATHER_MARGIN).sum())
                                   for _, m in self.log),
               "flips_excused": [{"call": c, "margin": m}
                                 for c, m in self.flips]}
        if self.elog:
            out.update(
                expert_calls=len(self.elog),
                expert_choices=sum(e.numel() for e, _ in self.elog),
                expert_min_margin=min(m.min().item() for _, m in self.elog),
                expert_below_margin=sum(int((m < GATHER_MARGIN).sum())
                                        for _, m in self.elog),
                expert_flips_excused=[{"call": c, "margin": m}
                                      for c, m in self.eflips])
        return out


def gemma_witness(torch, np, dev, cfg):
    """(c) CPU ≡ CUDA in fp32 at gemma3-12b's full widths, cut to
    GEMMA_WITNESS_LAYERS layers (5 LOCAL, 1 global) with W kept at 1024:
    a prompt of 1100 tokens (past W: rings) and 4 teacher-forced decode
    steps, then the dense pool (2 slots, max_len 1100, single-step) on
    prompts of 1020 and 1060 tokens + 8 (the first crosses t = W in its
    ring).  The same seeded weights (neutral router bias) on both devices.
    Each cuda run replays the cpu run's router decisions (``GateReplay``:
    every cuda decision equal to the cpu's, or the cpu's margin below
    GATHER_MARGIN), and then its logits are held to ≤ 1e-4·max with equal
    argmax, and the pool's tokens to the cpu's exactly."""
    from repro_torch.core.routing import neutral_router_bias
    from repro_torch.models.model import LanguageModel, init_params
    from repro_torch.serve.engine import ContinuousBatchingEngine
    cfg = dataclasses.replace(cfg, dtype="float32",
                              num_layers=GEMMA_WITNESS_LAYERS)
    t = time.perf_counter()
    params = neutral_router_bias(init_params(
        cfg, torch.Generator().manual_seed(PARITY_SEED), "cpu"))
    m_cpu = LanguageModel(cfg, params, device="cpu")
    m_gpu = LanguageModel(cfg, params, device=dev)
    rng = np.random.default_rng(PARITY_SEED)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (1, GEMMA_WITNESS_T)))
    forced = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (1, GEMMA_WITNESS_STEPS)))
    forced_gates = GateReplay()
    with torch.no_grad():
        with forced_gates.record():
            lc, _ = _forced_run(m_cpu, toks, forced)
        with forced_gates.replay():
            lg, _ = _forced_run(m_gpu, toks.to(dev), forced.to(dev))
    worst = max((a - b).abs().max().item() / a.abs().max().item()
                for a, b in zip(lc, lg))
    require(worst <= TOL_LOGITS, f"gemma3 fp32 witness: logits differ "
            f"(cpu/cuda) by {worst} > {TOL_LOGITS}·max")
    require(all(torch.equal(a.argmax(-1), b.argmax(-1))
                for a, b in zip(lc, lg)),
            "gemma3 fp32 witness: greedy tokens differ (cpu/cuda)")
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in GEMMA_WITNESS_ENGINE]
    engine_gates, outs = GateReplay(), []
    for m, phase in ((m_cpu, engine_gates.record),
                     (m_gpu, engine_gates.replay)):
        eng = ContinuousBatchingEngine(m, max_slots=2,
                                       max_len=GEMMA_WITNESS_T)
        uids = [eng.submit(p, max_new_tokens=GEMMA_WITNESS_NEW)
                for p in prompts]
        with phase():
            res = eng.run()["results"]
        outs.append([res[u].tokens for u in uids])
    require(all(np.array_equal(a, b) for a, b in zip(*outs)),
            "gemma3 fp32 witness: dense pool tokens differ (cpu/cuda)")
    del m_gpu, params
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "window": cfg.window_size,
            "forced": {"prompts": 1, "prompt_len": GEMMA_WITNESS_T,
                       "steps": GEMMA_WITNESS_STEPS,
                       "gates": forced_gates.summary(),
                       "logits_max_rel_diff": worst, "tol": TOL_LOGITS,
                       "argmax_identical": True},
            "engine": {"prompt_lens": list(GEMMA_WITNESS_ENGINE),
                       "new_tokens": GEMMA_WITNESS_NEW, "max_len":
                       GEMMA_WITNESS_T, "gates": engine_gates.summary(),
                       "tokens_identical": True},
            "gather_margin": GATHER_MARGIN,
            "seconds": time.perf_counter() - t}


def gemma_phase(torch, np, dev, timer, floor):
    """Phase 18, gemma3-12b: (a) the kernels (``gemma_linears``,
    ``gemma_flash``), (b) full-width serving and (d) the refusals
    (``gemma_serve``), (c) the fp32 witness (``gemma_witness``).  Returns
    (its line, the launches of its main-path runs)."""
    from repro_torch.configs import get_config
    cfg = get_config("gemma3-12b")
    gc.collect()          # the earlier phases' models, before the peaks
    torch.cuda.empty_cache()
    t = time.perf_counter()
    linears = gemma_linears(torch, dev, timer, cfg)
    flash = gemma_flash(torch, dev, timer, cfg)
    kernels_s = time.perf_counter() - t
    serve, launches, derived = gemma_serve(torch, np, dev, cfg)
    wit = gemma_witness(torch, np, dev, cfg)
    return {"phase": "gemma3", "seconds": time.perf_counter() - t,
            "kernels_seconds": kernels_s, "launch_floor_ms": floor,
            "kernels": {"fused_linear_gelu": linears, "flash_dh256": flash},
            **serve, "witness_fp32": wit, "launches": launches,
            "graph_launches_derived": derived}, launches


# ---------------------------------------------------------------------------
# Phase 19: stablelm-3b (LayerNorm: the unfused path; head dim 80) and
# deepseek-coder-33b (56 query heads over 8 kv heads; ~66.7 GB of bf16)
# ---------------------------------------------------------------------------

# (a)'s ragged flash cases beside phase 3's: (B, Tq, Tk, Hq, Hkv, dh,
# window, kind) as FLASH_RAGGED.  dh 80 on every route (rows of 24, 37
# under window 8, pads, decode, 16 rows on the split-KV walk, 300 and 129
# past a tile); G 7 with 7·T rows ending mid-tile (280, a verify window's
# 35, 133 at dh 80) and 7 / 14 on the split-KV walk.
FLASH_RAGGED_19 = ((2, 24, 24, 4, 4, 80, 0, "prefill"),
                   (1, 37, 37, 4, 4, 80, 8, "prefill"),
                   (2, 40, 70, 8, 8, 80, 0, "tail"),
                   (3, 1, 50, 8, 8, 80, 0, "decode"),
                   (2, 1, 544, 4, 4, 80, 0, "short"),
                   (2, 16, 16, 2, 2, 80, 0, "prefill"),
                   (1, 300, 300, 32, 32, 80, 0, "prefill"),
                   (2, 129, 300, 4, 4, 80, 0, "tail"),
                   (2, 40, 70, 14, 2, 128, 0, "tail"),
                   (3, 1, 50, 14, 2, 128, 0, "decode"),
                   (2, 5, 544, 56, 8, 128, 0, "tail"),
                   (2, 2, 300, 14, 2, 128, 0, "tail"),
                   (1, 19, 19, 7, 1, 80, 0, "prefill"))
# (a)'s ragged paged cases: (B, Hkv, G, dh, ps, J, kind) as PAGED_RAGGED.
# dh 80 in groups of 4 and 2 kv-heads that hold odd heads (whose int4 rows
# of 40 bytes are only 8-byte aligned) and do not divide Hkv, an odd page,
# few and empty histories, G 16 and 32 (SIMT); G 7 alone and in groups.
PAGED_RAGGED_19 = ((16, 6, 1, 80, 16, 512, "random"),
                   (16, 3, 2, 80, 16, 512, "random"),
                   (2, 2, 4, 80, 8, 7, "random"),
                   (2, 2, 4, 80, 4, 3, "empty"),
                   (1, 3, 1, 80, 5, 9, "random"),
                   (1, 2, 1, 80, 16, 128, "few"),
                   (2, 1, 16, 80, 16, 64, "random"),
                   (1, 1, 32, 80, 8, 5, "random"),
                   (2, 2, 7, 128, 16, 64, "random"),
                   (16, 8, 7, 128, 16, 512, "random"),
                   (1, 1, 7, 80, 16, 40, "front"))
STABLE_WITNESS_LAYERS = 4        # (c): full widths, 4 of the 32 layers
STABLE_WITNESS_T = 300           # (c): the forced prompt
STABLE_WITNESS_STEPS = 4
STABLE_WITNESS_ENGINE = (120, 200)  # (c): the pools' prompts
STABLE_WITNESS_NEW = 8


def ragged_19(torch, dev):
    """(a) FLASH_RAGGED_19 and PAGED_RAGGED_19 (``ragged_cases``): every
    bf16 route and the SIMT kernels must be taken."""
    return ragged_cases(torch, dev, FLASH_RAGGED_19, PAGED_RAGGED_19, 34,
                        {("bfloat16", "split"), ("bfloat16", "simt"),
                         ("float32", "simt")}, "dh 80 / G 7")


def ragged_cases(torch, dev, flash_cases, paged_cases, seed, paged_routes,
                 what):
    """Ragged flash cases and paged cases (each in bf16, int8 and int4
    pages) in bf16 and fp32 on the routes their plans pick, against the
    plain versions with phase 3's tolerances (``flash_call``,
    ``ragged_paged``), from one generator seeded ``seed``; not timed.
    Flash must take its two bf16 routes and SIMT, paged attention the
    routes ``paged_routes`` ({(dtype, route)})."""
    g = torch.Generator(device=dev).manual_seed(seed)
    flash, paged_recs, worst = {}, {}, {}
    for dt, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        dname = str(dt).split(".")[-1]
        for case in flash_cases:
            B, Tq, Tk, Hq, Hkv, dh, window, kind = case
            args = flash_ragged_inputs(torch, dev, g, dt, B, Tq, Tk, Hq, Hkv,
                                       dh, kind)
            r = flash_call(torch, *args, f"ragged flash {case} {dname}",
                           window=window, scale=1.0 / math.sqrt(dh))
            worst["flash_attention"] = max(worst.get("flash_attention", 0.0),
                                           r["max_abs_err"] / r["max_ref"])
            flash[f"{kind} B={B} Tq={Tq} Tk={Tk} Hq={Hq} Hkv={Hkv} dh={dh} "
                  f"window={window} {dname}"] = r
        for case in paged_cases:
            for kd in (None, "int8", "int4"):
                r = ragged_paged(torch, dev, g, dt, kd, *case)
                worst["paged_attention"] = max(
                    worst.get("paged_attention", 0.0),
                    r["max_abs_err"] / max(r["max_ref"], 1e-30))
                paged_recs[f"{case} {kd} {dname}"] = r
    torch.cuda.synchronize()
    routes = {(k.split()[-1], r["route"]) for k, r in flash.items()}
    require(routes == {("bfloat16", "wgmma"), ("bfloat16", "splitkv"),
                       ("float32", "simt")},
            f"ragged {what} flash cases took the routes {routes}")
    routes = {(k.split()[-1], r["route"]) for k, r in paged_recs.items()}
    require(routes == paged_routes,
            f"ragged {what} paged cases took the routes {routes}")
    return {"max_err_over_max_ref": worst, "flash_attention": flash,
            "paged_attention": paged_recs}


def stable_int4_matmul(torch, dev, timer, cfg, names=None):
    """(a) The int4 matmul at stablelm-3b's four linears (wqkv 2560→7680,
    wo 2560→2560, gu 2560→13824, down 6912→2560: the unfused path's
    ``linear_apply`` with int4 leaves; or those of ``names``: phase 20's
    arctic-480b residual MLP), M 2048 (lock-step prefill) on the
    s8 tile and M 4 (decode) on the code stream, in bf16 and fp32
    activations (``int4_call``: the plain version in the route's order,
    bit for bit; the exact dequant within TOL_BFP), timed beside the plain
    version and bf16 ``torch.matmul`` of the same shape (not the same
    function: no single call computes the BFP product).  Returns the shape
    records by route."""
    from repro_torch.kernels import int4_matmul as im, ref
    G = cfg.quant.group_size
    g = torch.Generator(device=dev).manual_seed(33)
    shapes = {"tc": [], "stream": []}
    for M in (2048, 4):
        for name, K, N, *_ in linear_shapes(cfg):
            if names is not None and name not in names:
                continue
            codes, scale, w_exact, w = int4_weight(torch, dev, g, K, N, G)
            x = torch.randn((M, K), generator=g, device=dev).to(
                torch.bfloat16)
            errs = {}
            for dt in (torch.bfloat16, torch.float32):
                what = f"int4_matmul {name} M={M} {dt}"
                rec, p = int4_call(torch, x.to(dt), codes, scale, {}, what,
                                   matmul=True)
                out = im.int4_matmul_cuda(x.to(dt), codes, scale)
                eo = ref.int4_matmul_ref(x.to(dt), codes, scale)
                torch.cuda.synchronize()
                ee, em = max_err(torch, out, eo)
                require(ee <= TOL_BFP * em, f"{what}: {ee} from the exact "
                        f"dequant > {TOL_BFP}·{em}")
                rec.update(exact_dequant_err=ee, exact_dequant_max=em)
                errs[str(dt).split(".")[-1]] = rec
                del out, eo
            split = p.group_split or None
            Kw, C = codes.shape[0], scale.shape[0]
            nbytes = (M * K + M * N) * 2 + Kw * N + C * N * 4
            b, by = bound_ms(nbytes, 2.0 * M * Kw * N, INT8_OPS_PER_S)
            shapes[p.route].append({
                "shape": f"{name} M={M} K={K} N={N} G={G}", "route": p.route,
                "plan": dataclasses.asdict(p),
                "ms": timer(lambda: im.int4_matmul_cuda(x, codes, scale)),
                "plain_ms": timer(lambda: ref.bfp_matmul_ref(x, codes, scale,
                                                             split)),
                "library_ms": None,
                "torch_matmul_bf16_ms": timer(lambda: torch.matmul(x, w)),
                "bound_ms": b, "bound_by": by, "bytes": nbytes,
                "tol": INT4_TOL, "errors": errs})
            del x, codes, scale, w_exact, w
    return shapes


def stable_deepseek_kernels(torch, np, dev, timer, cfg, dcfg, floor):
    """(a) The kernels at phase 19's shapes: flash at dh 80 (stablelm-3b's
    32 heads: prefill 4 × 512 on the tile, decode over 544 keys on the
    split-KV walk, fp32 on the SIMT kernel; ``check_flash``) and at a
    chunk's geometry (``chunk_flash``); paged attention at dh 80 over
    512-token histories in bf16, int8 and int4 pages (``check_paged``:
    groups of 4 kv-heads, the odd ones' int4 rows 8-byte aligned);
    deepseek-coder-33b's G 7 on flash (tile and split-KV walk) and paged
    attention (split walk); the ragged cases (``ragged_19``); the int4
    matmul at stablelm's four linears (``stable_int4_matmul``); the fused
    linear's four routes at deepseek's four linears (wqkv 7168→9216, wo
    7168→7168, gu 7168→2·19200, down 19200→7168; ``check_fused_linear``,
    ``check_fused_linear_int4`` at M 2048 and 4).  Phase 3's checks and
    tolerances, timed beside the plain versions and SDPA or
    ``torch.matmul``."""
    return {"flash_dh80": check_flash(torch, dev, timer, cfg),
            "flash_dh80_chunk": chunk_flash(torch, dev, timer, cfg, floor),
            "paged_dh80": check_paged(torch, np, dev, timer, cfg),
            "flash_g7": check_flash(torch, dev, timer, dcfg),
            "paged_g7": check_paged(torch, np, dev, timer, dcfg),
            "ragged": ragged_19(torch, dev),
            "int4_matmul": stable_int4_matmul(torch, dev, timer, cfg),
            "fused_linear": check_fused_linear(torch, dev, timer, dcfg),
            "fused_linear_int4": check_fused_linear_int4(
                torch, dev, timer, dcfg, Ms=(2048, 4))}


def stable_serve(torch, np, dev, cfg):
    """(b) stablelm-3b at full width in bf16 at ``cfg``'s depth (seed-0
    weights, neutral router bias) on the unfused path: lock-step 4 × 512 +
    32;
    phase 6's 8 requests (seeded anew) in the dense pool single-step and
    in fused 8-step epochs (the same tokens), bf16 pages single-step and
    fused (the same tokens), int8 and int4 pages, chunk 128 (dense pool)
    and ``spec_k`` 4 (dense pool); phase 13's traffic with the prefix
    cache on beside off (bf16 pages, ``prefix_pair``); gather mode
    lock-step; the weights quantized on the card (every linear through
    the int4 matmul) lock-step and in fused epochs.  Exact launches per
    route in every run (no router_stats and no fused linear: the plain
    router product and matmuls), finite logits, pages conserved,
    prefill_s, tok/s and peak memory.  Returns (record, launches summed
    over the runs, the fused runs' derived graph launches)."""
    from repro_torch.models.model import LanguageModel
    from repro_torch.quant import int4_head, int4_linears, quantize_params
    model, init_s = seeded_model(torch, dev, cfg)
    lock, total, lock_toks = serve_full_width(
        torch, np, dev, model, init_s, phase="stablelm_lockstep")
    total = dict(total)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.integers(128, 513, 8)]
    runs, tokens, derived = [], {}, {}
    with FiniteLogits(torch, dev) as finite:
        for run, kw in (
                ("dense", dict(kv_mode="dense")),
                ("fused_dense", dict(kv_mode="dense",
                                     decode_steps=FUSED_STEPS)),
                ("paged_bf16", dict(kv_mode="paged")),
                ("fused_paged_bf16", dict(kv_mode="paged",
                                          decode_steps=FUSED_STEPS)),
                ("paged_int8", dict(kv_mode="paged", kv_dtype="int8")),
                ("paged_int4", dict(kv_mode="paged", kv_dtype="int4")),
                (f"chunk{CHUNK}_dense", dict(kv_mode="dense",
                                             prefill_chunk=CHUNK)),
                (f"spec{SPEC_K}_dense", dict(kv_mode="dense",
                                             spec_k=SPEC_K))):
            rec, tokens[run], launches = serve_continuous(
                torch, dev, model, finite, f"stablelm_{run}", prompts, 32,
                trace=False, **kw)
            runs.append(rec)
            _add(total, launches)
            _add(derived, rec.get("graph_launches_derived", {}))
        first, pre = prefix_traffic(np, cfg.vocab_size)
        prefix = prefix_pair(torch, np, dev, model, finite,
                             "stablelm_prefix_bf16", first, pre, {}, total)
    for a, b in (("dense", "fused_dense"), ("paged_bf16", "fused_paged_bf16")):
        require(all(np.array_equal(x, y) for x, y in zip(tokens[a],
                                                           tokens[b])),
                f"stablelm: fused epochs changed the {a} run's tokens")
    for k in ("flash_attention_wgmma", "flash_attention_splitkv",
              "paged_attention_split"):
        require(total[k] > 0, f"stablelm: {k} never launched")
    require(total["router_stats"] == total["fused_linear"] == 0,
            "stablelm: the unfused path launched router_stats or a fused "
            "linear")
    gm = LanguageModel(with_mode(cfg, "gather"), model.params(), device=dev)
    gather, launches, _ = serve_full_width(
        torch, np, dev, gm, 0.0, phase="stablelm_gather_lockstep")
    _add(total, launches)
    del gm
    bf16_bytes = _tree_bytes(model.params())
    t = time.perf_counter()
    m4 = LanguageModel(cfg, quantize_params(
        model.params(), cfg.quant.group_size, cfg.quant.pow2_scales),
        device=dev)
    torch.cuda.synchronize(dev)
    quant_s = time.perf_counter() - t
    del model
    require(int4_linears(m4.params()) and int4_head(m4.params()),
            "stablelm int4: the linears or the head are not int4")
    int4, launches, toks4 = serve_full_width(
        torch, np, dev, m4, quant_s, phase="stablelm_int4_lockstep")
    _add(total, launches)
    with FiniteLogits(torch, dev) as finite:
        rec, _, launches = serve_continuous(
            torch, dev, m4, finite, "stablelm_int4_fused_dense", prompts, 32,
            trace=False, kv_mode="dense", decode_steps=FUSED_STEPS)
    _add(total, launches)
    _add(derived, rec["graph_launches_derived"])
    for k in ("int4_matmul_tc", "int4_matmul_stream"):
        require(launches[k] > 0 or int4["launches"][k] > 0,
                f"stablelm int4: {k} never launched")
    require(int4["launches"]["fused_linear_int4"] == 0,
            "stablelm int4: a fused int4 linear launched")
    int4.update(weight_bytes=_tree_bytes(m4.params()),
                bf16_weight_bytes=bf16_bytes, fused_dense=rec,
                tokens_equal_to_bf16=token_agreement(np, list(toks4),
                                                     list(lock_toks)))
    del m4
    gc.collect()
    torch.cuda.empty_cache()
    return {"config": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "heads": cfg.num_heads,
            "kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim,
            "norm_type": cfg.norm_type, "rotary_pct": cfg.rotary_pct,
            "init_s": init_s, "weight_bytes": bf16_bytes, "lockstep": lock,
            "prompt_lens": [len(p) for p in prompts], "runs": runs,
            "prefix": prefix, "gather_lockstep": gather,
            "int4": int4}, total, derived


def stable_witness(torch, np, dev, cfg):
    """(c) CPU ≡ CUDA in fp32 at stablelm-3b's full widths cut to
    STABLE_WITNESS_LAYERS layers: a prompt of 300 tokens and 4
    teacher-forced decode steps, then the dense pool and fp32 pages (2
    slots, single-step) on prompts of 120 and 200 tokens + 8.  The same
    seeded weights (neutral router bias) on both devices; on the card the
    linears are fp32 ``torch.matmul`` (TF32 off), flash and paged
    attention the SIMT kernels at dh 80.  Each cuda run replays the cpu
    run's router decisions (``GateReplay``), then its logits are held to
    ≤ 1e-4·max with equal argmax, and the pools' tokens to the cpu's
    exactly."""
    from repro_torch.core.routing import neutral_router_bias
    from repro_torch.models.model import LanguageModel, init_params
    from repro_torch.serve.engine import ContinuousBatchingEngine
    cfg = dataclasses.replace(cfg, dtype="float32",
                              num_layers=STABLE_WITNESS_LAYERS)
    t = time.perf_counter()
    params = neutral_router_bias(init_params(
        cfg, torch.Generator().manual_seed(PARITY_SEED), "cpu"))
    m_cpu = LanguageModel(cfg, params, device="cpu")
    m_gpu = LanguageModel(cfg, params, device=dev)
    rng = np.random.default_rng(PARITY_SEED)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (1, STABLE_WITNESS_T)))
    forced = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (1, STABLE_WITNESS_STEPS)))
    forced_gates = GateReplay()
    with torch.no_grad():
        with forced_gates.record():
            lc, _ = _forced_run(m_cpu, toks, forced)
        with forced_gates.replay():
            lg, _ = _forced_run(m_gpu, toks.to(dev), forced.to(dev))
    worst = max((a - b).abs().max().item() / a.abs().max().item()
                for a, b in zip(lc, lg))
    require(worst <= TOL_LOGITS, f"stablelm fp32 witness: logits differ "
            f"(cpu/cuda) by {worst} > {TOL_LOGITS}·max")
    require(all(torch.equal(a.argmax(-1), b.argmax(-1))
                for a, b in zip(lc, lg)),
            "stablelm fp32 witness: greedy tokens differ (cpu/cuda)")
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in STABLE_WITNESS_ENGINE]
    engines = {}
    for kv in ("dense", "paged"):
        gates, outs = GateReplay(), []
        for m, phase in ((m_cpu, gates.record), (m_gpu, gates.replay)):
            eng = ContinuousBatchingEngine(
                m, max_slots=2, max_len=STABLE_WITNESS_T, kv_mode=kv,
                page_size=PAGE)
            uids = [eng.submit(p, max_new_tokens=STABLE_WITNESS_NEW)
                    for p in prompts]
            with phase():
                res = eng.run()["results"]
            outs.append([res[u].tokens for u in uids])
            if kv == "paged":
                eng.allocator.check_conservation()
                require(eng.allocator.free_pages == eng.num_pages,
                        "stablelm fp32 witness: pages in use at the end")
        require(all(np.array_equal(a, b) for a, b in zip(*outs)),
                f"stablelm fp32 witness: {kv} pool tokens differ (cpu/cuda)")
        engines[kv] = {"gates": gates.summary(), "tokens_identical": True}
    del m_gpu, params
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers,
            "forced": {"prompts": 1, "prompt_len": STABLE_WITNESS_T,
                       "steps": STABLE_WITNESS_STEPS,
                       "gates": forced_gates.summary(),
                       "logits_max_rel_diff": worst, "tol": TOL_LOGITS,
                       "argmax_identical": True},
            "engines": {"prompt_lens": list(STABLE_WITNESS_ENGINE),
                        "new_tokens": STABLE_WITNESS_NEW, **engines},
            "gather_margin": GATHER_MARGIN,
            "seconds": time.perf_counter() - t}


def deepseek_serve(torch, np, dev, cfg):
    """(d) deepseek-coder-33b at full width (seed-0 weights, neutral
    router bias): bf16 (~66.7 GB) lock-step 4 × 512 + 32 and phase 6's 8
    requests (seeded anew) in the dense pool single-step and in fused
    8-step epochs (the same tokens); then, the bf16 weights freed, the
    int4 tree built layer by layer as drawn (``init_params(int4=True)``:
    the bf16 and int4 trees together would not fit) lock-step and in
    fused epochs.  Exact launches per route (flash at G 7: 3584 rows a
    prefill on the tile, 7 a decode step on the split-KV walk), finite
    logits, peak memory against the card's.  Returns (record, launches,
    the fused runs' derived graph launches)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.integers(128, 513, 8)]
    total, derived, out = {}, {}, {}
    card = torch.cuda.get_device_properties(dev).total_memory
    for label, int4 in (("bf16", False), ("int4", True)):
        gc.collect()
        torch.cuda.empty_cache()
        model, init_s = seeded_model(torch, dev, cfg, int4=int4)
        lock, launches, _ = serve_full_width(
            torch, np, dev, model, init_s, phase=f"deepseek_{label}_lockstep")
        _add(total, launches)
        runs, tokens = [], {}
        loops = [("fused_dense", dict(decode_steps=FUSED_STEPS))]
        if not int4:
            loops.insert(0, ("dense", {}))
        with FiniteLogits(torch, dev) as finite:
            for run, kw in loops:
                rec, tokens[run], launches = serve_continuous(
                    torch, dev, model, finite, f"deepseek_{label}_{run}",
                    prompts, 32, trace=False, kv_mode="dense", **kw)
                runs.append(rec)
                _add(total, launches)
                _add(derived, rec.get("graph_launches_derived", {}))
        if not int4:
            require(all(np.array_equal(a, b) for a, b in zip(
                tokens["dense"], tokens["fused_dense"])),
                "deepseek: fused epochs changed the dense pool's tokens")
        peak = max([lock["max_memory_allocated"]]
                   + [r["max_memory_allocated"] for r in runs])
        require(peak < card, f"deepseek {label}: peak {peak} of {card}")
        out[label] = {"init_s": init_s, "weight_bytes": _tree_bytes(
            model.params()), "lockstep": lock, "runs": runs,
            "peak_memory_allocated": peak}
        del model
    gc.collect()
    torch.cuda.empty_cache()
    for k in ("flash_attention_wgmma", "flash_attention_splitkv",
              "fused_linear_wgmma", "fused_linear_splitk",
              "fused_linear_int4_tc", "fused_linear_int4_stream"):
        require(total[k] > 0, f"deepseek: {k} never launched")
    return {"config": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "heads": cfg.num_heads,
            "kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim,
            "d_ff": cfg.d_ff, "card_memory": card,
            "prompt_lens": [len(p) for p in prompts], **out}, total, derived


def stable_deepseek_phase(torch, np, dev, timer, floor):
    """Phase 19, stablelm-3b and deepseek-coder-33b: (a) the kernels
    (``stable_deepseek_kernels``), (b) stablelm served (``stable_serve``),
    (c) its fp32 witness (``stable_witness``), (d) deepseek served
    (``deepseek_serve``).  Returns (its line, the launches of its
    main-path runs)."""
    from repro_torch.configs import get_config
    cfg, dcfg = get_config("stablelm-3b"), get_config("deepseek-coder-33b")
    gc.collect()          # the earlier phases' models, before the peaks
    torch.cuda.empty_cache()
    t = time.perf_counter()
    kernels = stable_deepseek_kernels(torch, np, dev, timer, cfg, dcfg,
                                      floor)
    kernels_s = time.perf_counter() - t
    serve, launches, derived = stable_serve(
        torch, np, dev, dataclasses.replace(cfg, num_layers=STABLE_LAYERS))
    serve["published_layers"] = cfg.num_layers
    serve_s = time.perf_counter() - t - kernels_s
    wit = stable_witness(torch, np, dev, cfg)
    deep, more, more_derived = deepseek_serve(torch, np, dev, dcfg)
    _add(launches, more)
    _add(derived, more_derived)
    return {"phase": "stablelm_deepseek", "seconds": time.perf_counter() - t,
            "kernels_seconds": kernels_s, "stablelm_serve_seconds": serve_s,
            "launch_floor_ms": floor, "kernels": kernels, "stablelm": serve,
            "witness_fp32": wit, "deepseek": deep, "launches": launches,
            "graph_launches_derived": derived}, launches


# ---------------------------------------------------------------------------
# Phase 20: grok-1-314b (top-k MoE, GeGLU experts; 48 query heads over 8 kv
# heads: G 6) and arctic-480b (128 experts, SwiGLU, the dense residual MLP;
# G 7), full widths at a cut depth
# ---------------------------------------------------------------------------

# (a)'s ragged flash cases at G 6: (B, Tq, Tk, Hq, Hkv, dh, window, kind)
# as FLASH_RAGGED.  6·T rows ending mid-tile (144, 114, 222 under window
# 8, a verify window's 30, 18 just past the walk), and 6 / 12 rows on the
# split-KV walk (decode, a 2-token tail, decode over 544 keys), dh 64 too.
FLASH_RAGGED_20 = ((2, 24, 24, 6, 1, 128, 0, "prefill"),
                   (1, 19, 19, 6, 1, 128, 0, "prefill"),
                   (1, 37, 37, 12, 2, 128, 8, "prefill"),
                   (2, 40, 70, 12, 2, 128, 0, "tail"),
                   (2, 5, 544, 48, 8, 128, 0, "tail"),
                   (1, 3, 3, 6, 1, 128, 0, "prefill"),
                   (3, 1, 50, 12, 2, 128, 0, "decode"),
                   (2, 2, 300, 12, 2, 128, 0, "tail"),
                   (2, 1, 544, 48, 8, 128, 0, "short"),
                   (2, 2, 33, 6, 1, 64, 0, "tail"))
# (a)'s ragged paged cases: (B, Hkv, G, dh, ps, J, kind) as PAGED_RAGGED.
# G 6 at grok's decode (4 slots, 8 kv-heads), alone and in groups of 2 and
# 4 kv-heads (B 16), an odd page, few, front-loaded and empty histories,
# dh 64; G 7 at arctic's decode shape.
PAGED_RAGGED_20 = ((4, 8, 6, 128, 16, 64, "random"),
                   (2, 2, 6, 128, 16, 64, "random"),
                   (16, 8, 6, 128, 16, 512, "random"),
                   (16, 3, 6, 128, 16, 128, "random"),
                   (1, 1, 6, 128, 16, 40, "front"),
                   (2, 1, 6, 64, 8, 7, "random"),
                   (1, 3, 6, 128, 5, 9, "random"),
                   (2, 2, 6, 128, 4, 3, "empty"),
                   (1, 2, 6, 128, 16, 128, "few"),
                   (4, 8, 7, 128, 16, 64, "random"))


MOE_SERVE = {                    # (b), (c): depth cut, runs
    "grok-1-314b": dict(
        layers=4, runs=(("dense", dict(kv_mode="dense")),
                        ("fused_dense", dict(kv_mode="dense",
                                             decode_steps=FUSED_STEPS)),
                        ("fused_paged_bf16", dict(
                            kv_mode="paged", decode_steps=FUSED_STEPS))),
        same=("dense", "fused_dense"),
        int4_runs=(("int4_fused_dense", dict(kv_mode="dense",
                                             decode_steps=FUSED_STEPS)),)),
    "arctic-480b": dict(
        layers=2, runs=(("fused_dense", dict(kv_mode="dense",
                                             decode_steps=FUSED_STEPS)),
                        ("fused_paged_int8", dict(
                            kv_mode="paged", kv_dtype="int8",
                            decode_steps=FUSED_STEPS))),
        same=None, int4_runs=()),
}
MOE_PAGED_J = 1088    # (a): pages a slot; 64 layers' entries of a 512-token
#                       keep-0.5 history (~32.5 a token, ~16640) pass 1024·16
MOE_WITNESS_LAYERS = {"grok-1-314b": 2, "arctic-480b": 1}   # (d)
MOE_WITNESS_T = 64               # (d): the forced prompts (2 of them)
MOE_WITNESS_STEPS = 4
MOE_WITNESS_ENGINE = (40, 64)    # (d): the dense pool's prompts
MOE_WITNESS_NEW = 8
MOE_HOST_MARGIN = 1.25           # (d): host memory wanted per fp32 byte
DROP_TOL = 1e-6                  # a dropped count over N·K in fp32


class MoeWatch:
    """Every MoE call of a run outside a CUDA graph capture: its choices
    (``moe.positions``' top_e), capacity and ``moe_apply``'s
    ``moe_drop_frac``.  ``check()`` holds each call's drop fraction to the
    host's count from its choices (1 − Σ_e min(n_e, C) / (N·K): the cumsum
    keeps an expert's first C pairs in token order) within DROP_TOL, a
    call of at most 8 rows (a decode step; C ≥ 8) to 0, and returns the
    prefills' drop fractions."""

    def __enter__(self):
        from repro_torch.models import moe
        self.calls, self._pending = [], []
        self._pos, self._apply = moe.positions, moe.moe_apply

        def positions(top_e, n_experts, cap):
            if not self._capturing():
                self._pending.append((top_e, cap))
            return self._pos(top_e, n_experts, cap)

        def moe_apply(params, x, cfg):
            y, aux = self._apply(params, x, cfg)
            if not self._capturing():
                top_e, cap = self._pending.pop()
                self.calls.append((top_e, cap, aux["moe_drop_frac"]))
            return y, aux

        moe.positions, moe.moe_apply = positions, moe_apply
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.positions, moe.moe_apply = self._pos, self._apply

    @staticmethod
    def _capturing():
        import torch
        return torch.cuda.is_available() and \
            torch.cuda.is_current_stream_capturing()

    def check(self, label) -> dict:
        import numpy as np
        require(self.calls and not self._pending,
                f"{label}: no MoE call seen, or a call without its choices")
        worst, prefill, steps = 0.0, [], 0
        for top_e, cap, drop in self.calls:
            te = top_e.cpu().numpy()
            n, k = te.shape
            counts = np.bincount(te.reshape(-1))
            host = 1.0 - np.minimum(counts, cap).sum() / (n * k)
            dev = float(drop)
            worst = max(worst, abs(dev - host))
            require(abs(dev - host) <= DROP_TOL, f"{label}: moe_drop_frac "
                    f"{dev}, the host's count from the choices {host}")
            if n <= 8:
                require(dev == 0.0, f"{label}: a {n}-row call dropped")
                steps += 1
            else:
                prefill.append({"rows": n, "capacity": cap,
                                "drop_frac": dev})
        return {"calls": len(self.calls), "step_calls": steps,
                "prefill_calls": prefill, "max_host_diff": worst,
                "tol": DROP_TOL}


def ragged_20(torch, dev):
    """(a) FLASH_RAGGED_20 and PAGED_RAGGED_20 (``ragged_cases``): both
    bf16 flash routes and SIMT, the paged split walk (every case G ≤ 16)
    and SIMT."""
    return ragged_cases(torch, dev, FLASH_RAGGED_20, PAGED_RAGGED_20, 35,
                        {("bfloat16", "split"), ("float32", "simt")},
                        "G 6 / G 7")


def moe_kernels(torch, np, dev, timer, gcfg, acfg, floor):
    """(a) The kernels at phase 20's shapes: the router at grok-1-314b's D
    6144 and arctic-480b's 7168 (T 2048, 453 and 4; ``check_router``: an
    MoE block leaves no Σy² carry, so every attention block launches it);
    flash at grok's G 6
    (prefill 4 × 512 on the tile, decode over 544 keys on the split-KV
    walk, fp32 on the SIMT kernel, beside SDPA in its GQA mode;
    ``check_flash``); paged attention at G 6 over 512-token histories in
    bf16, int8 and int4 pages (split walk, SIMT on the same inputs, flash's
    split walk over the same rows; ``check_paged``); the ragged cases
    (``ragged_20``); the fused linear's routes at grok's wqkv 6144→8192
    and wo 6144→6144 beside ``torch.matmul`` (``check_fused_linear``), and
    its int4 routes there at M 2048 on the tile and M 4 on the stream
    (``check_fused_linear_int4``: grok's int4 runs); the int4 matmul at
    grok's head (M 4, K 6144, N 131072;
    ``check_int4_matmul``) and at arctic-480b's residual MLP (gu
    7168→2·4864, down 4864→7168, M 2048 on the tile and M 4 on the stream;
    ``stable_int4_matmul``).  Phase 3's checks and tolerances."""
    return {"router": check_router(torch, dev, timer, (gcfg, acfg), floor),
            "flash_g6": check_flash(torch, dev, timer, gcfg),
            "paged_g6": check_paged(torch, np, dev, timer, gcfg,
                                    J=MOE_PAGED_J),
            "ragged": ragged_20(torch, dev),
            "fused_linear": check_fused_linear(torch, dev, timer, gcfg,
                                               names=("wqkv", "wo")),
            "fused_linear_int4": check_fused_linear_int4(
                torch, dev, timer, gcfg, Ms=(2048, 4), names=("wqkv", "wo")),
            "int4_head": check_int4_matmul(torch, dev, timer, gcfg,
                                           Ms=(4,)),
            "int4_residual": stable_int4_matmul(torch, dev, timer, acfg,
                                                names=("gu", "down"))}


def moe_serve(torch, np, dev, cfg):
    """(b) grok-1-314b at 4 layers, (c) arctic-480b at 2, full widths in
    bf16 (seed-0 weights, neutral router bias): lock-step 4 × 512 + 32,
    the runs of MOE_SERVE (phase 6's 8 requests, seeded anew; grok: the
    dense pool single-step and fused, the same tokens, and bf16 pages
    fused; arctic: the dense pool and int8 pages fused, G 7 on the paged
    split walk), then, the bf16 weights freed, the int4 tree built layer
    by layer as drawn (the experts and their router stay bf16) lock-step
    and (grok) fused.  Every run under ``MoeWatch``: exact launches per
    route, finite logits, pages conserved, each MoE call's drop fraction
    beside the host's count, prefill_s, tok/s and peak memory under the
    card's.  Returns (record, launches, the fused runs' derived graph
    launches)."""
    spec = MOE_SERVE[cfg.name]
    cut = dataclasses.replace(cfg, num_layers=spec["layers"])
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.integers(128, 513, 8)]
    card = torch.cuda.get_device_properties(dev).total_memory
    total, derived, out = {}, {}, {}
    short = cfg.name.split("-")[0]
    for label, int4 in (("bf16", False), ("int4", True)):
        gc.collect()
        torch.cuda.empty_cache()
        model, init_s = seeded_model(torch, dev, cut, int4=int4)
        p = model.params()
        if int4:
            from repro_torch.quant import int4_head, int4_linears
            inner = p["blocks"][0]["ffn"]["inner"]
            require(int4_linears(p) and int4_head(p)
                    and inner["w_up"].dtype == torch.bfloat16
                    and inner["gate"].dtype == torch.bfloat16,
                    f"{cfg.name} int4: the linears or the head are not "
                    "int4, or the experts are")
        with MoeWatch() as watch:
            lock, launches, _ = serve_full_width(
                torch, np, dev, model, init_s,
                phase=f"{short}_{label}_lockstep")
        lock["moe"] = watch.check(f"{cfg.name} {label} lock-step")
        _add(total, launches)
        runs, tokens = [], {}
        with FiniteLogits(torch, dev) as finite:
            for run, kw in spec["int4_runs" if int4 else "runs"]:
                with MoeWatch() as watch:
                    rec, tokens[run], launches = serve_continuous(
                        torch, dev, model, finite, f"{short}_{label}_{run}",
                        prompts, 32, trace=False, **kw)
                rec["moe"] = watch.check(f"{cfg.name} {run}")
                runs.append(rec)
                _add(total, launches)
                _add(derived, rec.get("graph_launches_derived", {}))
        if spec["same"] and not int4:
            a, b = spec["same"]
            require(all(np.array_equal(x, y) for x, y in zip(
                tokens[a], tokens[b])), f"{cfg.name}: fused epochs changed "
                "the dense pool's tokens")
        peak = max([lock["max_memory_allocated"]]
                   + [r["max_memory_allocated"] for r in runs])
        require(peak < card, f"{cfg.name} {label}: peak {peak} of {card}")
        out[label] = {"init_s": init_s, "weight_bytes": _tree_bytes(p),
                      "lockstep": lock, "runs": runs,
                      "peak_memory_allocated": peak}
        del model, p
    gc.collect()
    torch.cuda.empty_cache()
    want = ["flash_attention_wgmma", "flash_attention_splitkv",
            "fused_linear_wgmma", "fused_linear_splitk",
            "fused_linear_int4_tc", "fused_linear_int4_stream",
            "int4_matmul_stream", "paged_attention_split", "router_stats"]
    if cfg.dense_residual:
        want.append("int4_matmul_tc")
    for k in want:
        require(total[k] > 0, f"{cfg.name}: {k} never launched")
    return {"config": cfg.name, "layers": cut.num_layers,
            "published_layers": cfg.num_layers, "d_model": cfg.d_model,
            "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
            "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
            "experts": cfg.num_experts, "top_k": cfg.top_k,
            "mlp_act": cfg.mlp_act, "dense_residual": cfg.dense_residual,
            "capacity_factor": cfg.moe_capacity_factor, "card_memory": card,
            "prompt_lens": [len(q) for q in prompts], **out}, total, derived


def _mem_available() -> int:
    """The host's MemAvailable in bytes (``/proc/meminfo``)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def moe_witness(torch, np, dev, cfg):
    """(d) CPU ≡ CUDA in fp32 at full widths, grok-1-314b cut to 2 layers
    (~46 GB) and arctic-480b to 1 (~56 GB): the seeded weights (neutral
    router bias) drawn on the card and copied to the host; 2 prompts of 64
    tokens and 4 teacher-forced decode steps, then the dense pool (2 slots,
    single-step) on prompts of 40 and 64 tokens + 8.  Each cuda run replays
    the cpu run's router decisions and expert choices (``GateReplay``: a
    difference only where the cpu margin is below GATHER_MARGIN, listed),
    then its logits are held to ≤ 1e-4·max with equal argmax, and the
    pool's tokens to the cpu's exactly.  Where the host's MemAvailable
    cannot hold the fp32 weights MOE_HOST_MARGIN times over, the expert
    count is cut (a multiple of 8) and the record says to what; widths
    are never cut."""
    from repro_torch.core.routing import neutral_router_bias
    from repro_torch.models.model import LanguageModel, init_params
    from repro_torch.serve.engine import ContinuousBatchingEngine
    t = time.perf_counter()
    cfg = dataclasses.replace(cfg, dtype="float32",
                              num_layers=MOE_WITNESS_LAYERS[cfg.name])
    avail = _mem_available()
    need = 4 * cfg.param_count()
    published = experts = cfg.num_experts
    while MOE_HOST_MARGIN * 4 * dataclasses.replace(
            cfg, num_experts=experts).param_count() > avail and experts > 8:
        experts -= 8
    cfg = dataclasses.replace(cfg, num_experts=experts)
    params = neutral_router_bias(init_params(
        cfg, torch.Generator(device=dev).manual_seed(PARITY_SEED), dev))
    m_gpu = LanguageModel(cfg, params, device=dev)

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v) for v in tree]
        return tree.cpu()

    m_cpu = LanguageModel(cfg, to_cpu(params), device="cpu")
    load_s = time.perf_counter() - t
    rng = np.random.default_rng(PARITY_SEED)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (2, MOE_WITNESS_T)))
    forced = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (2, MOE_WITNESS_STEPS)))
    forced_gates = GateReplay()
    with torch.no_grad():
        with forced_gates.record():
            lc, _ = _forced_run(m_cpu, toks, forced)
        with forced_gates.replay():
            lg, _ = _forced_run(m_gpu, toks.to(dev), forced.to(dev))
    worst = max((a - b.cpu()).abs().max().item() / a.abs().max().item()
                for a, b in zip(lc, lg))
    require(worst <= TOL_LOGITS, f"{cfg.name} fp32 witness: logits differ "
            f"(cpu/cuda) by {worst} > {TOL_LOGITS}·max")
    require(all(torch.equal(a.argmax(-1), b.argmax(-1).cpu())
                for a, b in zip(lc, lg)),
            f"{cfg.name} fp32 witness: greedy tokens differ (cpu/cuda)")
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in MOE_WITNESS_ENGINE]
    engine_gates, outs = GateReplay(), []
    for m, phase in ((m_cpu, engine_gates.record),
                     (m_gpu, engine_gates.replay)):
        eng = ContinuousBatchingEngine(
            m, max_slots=2, max_len=max(MOE_WITNESS_ENGINE)
            + MOE_WITNESS_NEW)
        uids = [eng.submit(p, max_new_tokens=MOE_WITNESS_NEW)
                for p in prompts]
        with phase():
            res = eng.run()["results"]
        outs.append([res[u].tokens for u in uids])
    require(all(np.array_equal(a, b) for a, b in zip(*outs)),
            f"{cfg.name} fp32 witness: dense pool tokens differ (cpu/cuda)")
    del m_gpu, m_cpu, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "experts": experts,
            "published_experts": published,
            "experts_cut": experts != published,
            "host_mem_available": avail, "fp32_weight_bytes_published": need,
            "fp32_weight_bytes": 4 * cfg.param_count(), "load_s": load_s,
            "forced": {"prompts": 2, "prompt_len": MOE_WITNESS_T,
                       "steps": MOE_WITNESS_STEPS,
                       "gates": forced_gates.summary(),
                       "logits_max_rel_diff": worst, "tol": TOL_LOGITS,
                       "argmax_identical": True},
            "engine": {"prompt_lens": list(MOE_WITNESS_ENGINE),
                       "new_tokens": MOE_WITNESS_NEW,
                       "gates": engine_gates.summary(),
                       "tokens_identical": True},
            "gather_margin": GATHER_MARGIN,
            "seconds": time.perf_counter() - t}


def moe_phase(torch, np, dev, timer, floor):
    """Phase 20, grok-1-314b and arctic-480b: (a) the kernels
    (``moe_kernels``), (b) and (c) served at a cut depth (``moe_serve``),
    (d) the fp32 witnesses (``moe_witness``), one model at a time.
    Returns (its line, the launches of its main-path runs)."""
    from repro_torch.configs import get_config
    gcfg, acfg = get_config("grok-1-314b"), get_config("arctic-480b")
    gc.collect()          # the earlier phases' models, before the peaks
    torch.cuda.empty_cache()
    t = time.perf_counter()
    kernels = moe_kernels(torch, np, dev, timer, gcfg, acfg, floor)
    kernels_s = time.perf_counter() - t
    launches, derived, rec, secs = {}, {}, {}, {}
    for cfg in (gcfg, acfg):
        t0 = time.perf_counter()
        served, more, more_derived = moe_serve(torch, np, dev, cfg)
        _add(launches, more)
        _add(derived, more_derived)
        t1 = time.perf_counter()
        served["witness_fp32"] = moe_witness(torch, np, dev, cfg)
        rec[cfg.name] = served
        secs[cfg.name] = {"serve": t1 - t0,
                          "witness": time.perf_counter() - t1}
    return {"phase": "moe", "seconds": time.perf_counter() - t,
            "kernels_seconds": kernels_s, "seconds_by_model": secs,
            "launch_floor_ms": floor, "kernels": kernels, **rec,
            "launches": launches, "graph_launches_derived": derived}, \
        launches


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from repro_torch.kernels import build
    t = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t
    os.makedirs(LOG_DIR, exist_ok=True)
    with open(os.path.join(LOG_DIR, "chip_smoke_build.log"), "w") as f:
        for n, log in logs.items():
            f.write(f"== {n}\n{log}\n")
    usage = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "built": sorted(logs),
          "ptxas": usage})

    from repro_torch.configs import get_config
    cfg = get_config("llama2-7b")
    timer = Timer(torch, dev)
    floor = launch_floor_ms(torch, timer)
    dense = check_fused_linear(torch, dev, timer, cfg)
    flash = check_flash(torch, dev, timer, cfg)
    int4_lin = check_fused_linear_int4(torch, dev, timer, cfg)
    lm_head = check_int4_matmul(torch, dev, timer, cfg)
    paged = check_paged(torch, np, dev, timer, cfg)
    mamba_cfg = get_config("mamba2-2.7b")
    ssd = check_ssd(torch, dev, timer, mamba_cfg)
    router = check_router(torch, dev, timer, (cfg, mamba_cfg), floor)
    per_kernel = {
        "router_stats": router,
        "fused_linear_wgmma": dense["wgmma"],
        "fused_linear_splitk": dense["splitk"],
        "fused_linear_int4_tc": int4_lin["tc"],
        "fused_linear_int4_stream": int4_lin["stream"],
        "int4_matmul_stream": lm_head["stream"],
        "flash_attention_wgmma": flash["wgmma"],
        "flash_attention_splitkv": flash["splitkv"],
        "paged_attention_split": paged["split"],
        "paged_attention_simt": paged["simt"],
        "ssd_scan_tc": ssd["tc"], "ssd_scan_simt": ssd["simt"]}
    # the lm head's tile (M 2048) is off the main path: recorded, not listed
    emit({"phase": "kernels", "launch_floor_ms": floor,
          "shapes": per_kernel, "int4_matmul_tc": lm_head["tc"]})
    emit(check_ragged(torch, dev))

    emit(parity(torch, np, dev))
    emit(parity(torch, np, dev, int4=True))
    t17 = time.perf_counter()          # phase 17 (a), (b): no weights
    qcfg = get_config("qwen3-8b")
    gather_k = gather_kernels(torch, np, dev, timer, cfg, qcfg, floor)
    gather_par = gather_parity(torch, np, dev)
    gather_s = time.perf_counter() - t17
    model, init_s = full_width_model(torch, dev)
    serve, launches, lock_tokens = serve_full_width(torch, np, dev, model,
                                                    init_s)
    serve.update(layers=LLAMA_LAYERS,
                 published_layers=get_config("llama2-7b").num_layers)
    emit(serve)
    cont, cont_launches, prompts, tokens, (short, tight) = \
        continuous_full_width(torch, np, dev, model)
    emit(cont)
    for k, v in cont_launches.items():
        launches[k] += v
    fused_runs, fused_launches = serve_fused(torch, np, dev, model, [
        ("fused_dense", prompts, tokens["dense"], dict(kv_mode="dense")),
        ("fused_paged_bf16", prompts, tokens["paged_bf16"],
         dict(kv_mode="paged")),
        ("fused_paged_int8", prompts, tokens["paged_int8"],
         dict(kv_mode="paged", kv_dtype="int8")),
        ("fused_short_paged_bf16_tight", short, None,
         dict(kv_mode="paged", num_pages=tight)),
        ("fused_dense_temperature", prompts[:4], None,
         dict(kv_mode="dense", temperature=FUSED_TEMPERATURE))])
    t12 = time.perf_counter()          # phase 12 on the bf16 weights
    chunk_k = chunk_kernels(torch, dev, timer, cfg, floor)
    chunk_runs, chunk_tight, chunk_launches = chunked_full_width(
        torch, np, dev, model, prompts, tokens, short, tight)
    chunk_s = time.perf_counter() - t12
    prefix_rec, prefix_launches = prefix_full_width(torch, np, dev, model)
    t14 = time.perf_counter()          # phase 14 on the bf16 weights
    spec_k = spec_kernels(torch, dev, timer, cfg, floor)
    spec_runs, spec_launches, spec_derived = spec_full_width(
        torch, np, dev, model, prompts,
        {r["run"]: (r, tokens[r["run"]]) for r in cont["runs"]})
    spec_s = time.perf_counter() - t14
    life_rec, life_launches = lifecycle_full_width(
        torch, np, dev, model, prompts, tokens, short, tight)
    fault_rec, fault_launches = faults_full_width(torch, np, dev, model,
                                                  prompts)
    t17 = time.perf_counter()          # phase 17 (c) on the bf16 weights
    gather_bf16, gather_launches, gather_derived, _ = gather_runs(
        torch, np, dev, model, prompts, "gather")
    gather_s += time.perf_counter() - t17
    wit, wit_launches, (wit_chunk, more, wit_chunk_s), \
        (wit_prefix, more_prefix, wit_prefix_s), \
        (wit_spec, more_spec, more_derived, wit_spec_s), \
        (wit_life, more_life), (wit_fault, more_fault, wit_fault_s), \
        wit_gather = witness(torch, np, dev, model, prompts, tokens)
    gather_s += wit_gather["seconds"]
    _add(life_launches, more_life)
    _add(fault_launches, more_fault)
    _add(prefix_launches, more_prefix)
    _add(spec_launches, more_spec)
    _add(spec_derived, more_derived)
    emit(wit)            # its fp32 paged run: the paged SIMT route's launches
    launches["paged_attention_simt"] += wit_launches["paged_attention_simt"]
    _add(chunk_launches, more)
    def int4_gather(m4):               # phase 17 (c) on the int4 weights
        t = time.perf_counter()
        rec, launched, _, _ = gather_runs(torch, np, dev, m4, prompts,
                                          "gather_int4", fused=False)
        return rec, launched, time.perf_counter() - t

    int4, int4_launches, (runs, more), (int4_chunk, int4_chunk_launches), \
        (int4_spec, int4_spec_launches), \
        (gather_int4, more_gather, int4_gather_s) = serve_int4(
            torch, np, dev, model, lock_tokens, tokens, prompts,
            on_weights=int4_gather)
    _add(gather_launches, more_gather)
    gather_s += int4_gather_s
    emit(int4)
    for k, v in int4_launches.items():
        launches[k] += v
    fused_runs += runs
    _add(fused_launches, more)
    _add(chunk_launches, int4_chunk_launches)
    chunk_runs.append(int4_chunk)
    spec_runs.append(int4_spec)
    _add(spec_launches, int4_spec_launches)
    _add(spec_derived, int4_spec["graph_launches_derived"])
    del model
    torch.cuda.empty_cache()
    t17 = time.perf_counter()          # phase 17 (e): qwen3-8b
    qwen3, more_gather, more_derived = qwen3_full_width(torch, np, dev)
    gather_s += time.perf_counter() - t17
    _add(gather_launches, more_gather)
    _add(gather_derived, more_derived)
    gemma, gemma_launches = gemma_phase(torch, np, dev, timer, floor)
    gk = gemma["kernels"]
    for name, rows in (
            ("fused_linear_wgmma", gk["fused_linear_gelu"]["wgmma"]),
            ("fused_linear_splitk", gk["fused_linear_gelu"]["splitk"]),
            ("fused_linear_int4_tc", gk["fused_linear_gelu"]["tc"]),
            ("fused_linear_int4_stream", gk["fused_linear_gelu"]["stream"]),
            ("flash_attention_wgmma", gk["flash_dh256"]["wgmma"]),
            ("flash_attention_splitkv", gk["flash_dh256"]["splitkv"])):
        per_kernel[name] = per_kernel[name] + rows
    stable, stable_launches = stable_deepseek_phase(torch, np, dev, timer,
                                                    floor)
    sk = stable["kernels"]
    per_kernel["int4_matmul_tc"] = sk["int4_matmul"]["tc"]
    for name, rows in (
            ("int4_matmul_stream", sk["int4_matmul"]["stream"]),
            ("flash_attention_wgmma",
             sk["flash_dh80"]["wgmma"] + sk["flash_g7"]["wgmma"]),
            ("flash_attention_splitkv",
             sk["flash_dh80"]["splitkv"] + sk["flash_g7"]["splitkv"]),
            ("paged_attention_split",
             sk["paged_dh80"]["split"] + sk["paged_g7"]["split"]),
            ("paged_attention_simt", sk["paged_dh80"]["simt"]),
            ("fused_linear_wgmma", sk["fused_linear"]["wgmma"]),
            ("fused_linear_splitk", sk["fused_linear"]["splitk"]),
            ("fused_linear_int4_tc", sk["fused_linear_int4"]["tc"]),
            ("fused_linear_int4_stream", sk["fused_linear_int4"]["stream"])):
        per_kernel[name] = per_kernel[name] + rows
    moe, moe_launches = moe_phase(torch, np, dev, timer, floor)
    mk = moe["kernels"]
    for name, rows in (
            ("flash_attention_wgmma", mk["flash_g6"]["wgmma"]),
            ("flash_attention_splitkv", mk["flash_g6"]["splitkv"]),
            ("paged_attention_split", mk["paged_g6"]["split"]),
            ("paged_attention_simt", mk["paged_g6"]["simt"]),
            ("fused_linear_wgmma", mk["fused_linear"]["wgmma"]),
            ("fused_linear_splitk", mk["fused_linear"]["splitk"]),
            ("fused_linear_int4_tc", mk["fused_linear_int4"]["tc"]),
            ("fused_linear_int4_stream", mk["fused_linear_int4"]["stream"]),
            ("router_stats", mk["router"]),
            ("int4_matmul_stream", mk["int4_head"]["stream"]
             + mk["int4_residual"]["stream"]),
            ("int4_matmul_tc", mk["int4_residual"]["tc"])):
        per_kernel[name] = per_kernel[name] + rows

    par, par_launches = parity_mamba(torch, np, dev)
    emit(par)            # fp32: the SSD scan's SIMT route's launches
    launches["ssd_scan_simt"] += par_launches["ssd_scan_simt"]
    mamba, mamba_launches, (runs, more) = serve_mamba(torch, np, dev)
    emit(mamba)
    for k, v in mamba_launches.items():
        launches[k] += v
    fused_runs += runs
    _add(fused_launches, more)
    derived, traced = {}, {}
    for r in fused_runs:
        _add(derived, r["graph_launches_derived"])
        _add(traced, r["traced_epoch"]["device_kernels"])
    emit({"phase": "fused", "steps_per_dispatch": FUSED_STEPS,
          "graphs_captured": sum(r["graphs_captured"] for r in fused_runs),
          "runs": fused_runs, "launches": fused_launches,
          "graph_launches_derived": derived,
          "traced_epochs_device_kernels": traced,
          "short_traces": sum(len(r["traced_epoch"]["short_traces"])
                              for r in fused_runs),
          "trace_seconds": sum(r["traced_epoch"]["seconds"]
                               for r in fused_runs)})
    _add(launches, fused_launches)
    emit({"phase": "chunked", "chunk": CHUNK, "staging_rows": CHUNK_CAP,
          "split_chunk": CHUNK_SPLIT, "split_staging_rows": CHUNK_SPLIT_CAP,
          "seconds": chunk_s + wit_chunk_s + int4_chunk["wall_s"],
          "kernels": chunk_k, "witness_fp32": wit_chunk, "runs": chunk_runs,
          "pressure": chunk_tight, "mamba_chunked_raises": True,
          "launches": chunk_launches})
    _add(launches, chunk_launches)
    emit({"phase": "prefix", **prefix_rec, "witness_fp32": wit_prefix,
          "seconds": prefix_rec["seconds"] + wit_prefix_s,
          "launches": prefix_launches})
    _add(launches, prefix_launches)
    emit({"phase": "speculative", "spec_k": SPEC_K,
          "draft_keep_b": SPEC_KEEP,
          "seconds": spec_s + wit_spec_s + int4_spec["wall_s"],
          "kernels": spec_k, "runs": spec_runs, "witness_fp32": wit_spec,
          "launches": spec_launches,
          "graph_launches_derived": spec_derived})
    _add(launches, spec_launches)
    emit({"phase": "lifecycle", **life_rec, "witness_fp32": wit_life,
          "launches": life_launches})
    _add(launches, life_launches)
    emit({"phase": "faults", **fault_rec, "witness_fp32": wit_fault,
          "seconds": fault_rec["seconds"] + wit_fault_s,
          "witness_seconds": wit_fault_s, "launches": fault_launches})
    _add(launches, fault_launches)
    emit({"phase": "gather", "seconds": gather_s, "kernels": gather_k,
          "parity": gather_par, "llama2_7b_bf16": gather_bf16,
          "llama2_7b_int4": gather_int4, "witness_fp32": wit_gather,
          "qwen3_8b": qwen3, "launches": gather_launches,
          "graph_launches_derived": gather_derived})
    _add(launches, gather_launches)
    emit(gemma)
    _add(launches, gemma_launches)
    emit(stable)
    _add(launches, stable_launches)
    emit(moe)
    _add(launches, moe_launches)
    require(all(launches[k] > 0 for k in TPU_KERNELS),
            f"a kernel of the path never launched: {launches}")

    kernels = []
    for name, shapes in per_kernel.items():
        lib = [s["library_ms"] for s in shapes]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for s in shapes
                               for r in s["errors"].values()),
            "ms": sum(s["ms"] for s in shapes),
            "plain_ms": sum(s["plain_ms"] for s in shapes),
            "bound_ms": sum(s["bound_ms"] for s in shapes),
            "bound_by": max(shapes, key=lambda s: s["bound_ms"])["bound_by"],
            "library_ms": None if None in lib else sum(lib),
            "summed_over": [s["shape"] for s in shapes]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
