PY ?= python
export PYTHONPATH := src$(if $(PYTHONPATH),:$(PYTHONPATH),)

.PHONY: test test-fast test-torch chip-smoke verify lint docs-check \
        bench-quick bench-planner \
        bench-substrate bench-mesh bench-cache bench-beam bench-beam-smoke \
        bench-quant bench-quant-smoke bench-stream bench-stream-smoke \
        bench-build bench-build-smoke bench-wal bench-all bench-full \
        quickstart obs-smoke wal-smoke profile

# tier-1 verify (the command CI runs)
test:
	$(PY) -m pytest -x -q

# alias for the tier-1 command
verify: test

# ruff when available; syntax-check fallback in minimal containers
lint:
	@if $(PY) -c "import ruff" >/dev/null 2>&1; then \
	  $(PY) -m ruff check src tests benchmarks examples; \
	else \
	  echo "[lint] ruff unavailable; falling back to compileall"; \
	  $(PY) -m compileall -q src tests benchmarks examples; \
	fi

# fail on broken intra-repo links in README.md / docs/*.md
docs-check:
	$(PY) tools/docs_check.py

# the PyTorch port's CPU tests (held against the JAX reference)
test-torch:
	$(PY) -m pytest -q tests/test_torch_*.py

# the port on one CUDA card: kernel build + parity, exact regime, 1M build
# and planned search (needs a card; exits non-zero without one)
chip-smoke:
	python3 chip_smoke.py

# skip the slow multidevice subprocess tests
test-fast:
	$(PY) -m pytest -x -q --ignore=tests/test_multidevice.py

bench-quick:
	$(PY) -m benchmarks.run --only qps_recall,kernels

bench-planner:
	$(PY) -m benchmarks.run --only planner

bench-substrate:
	$(PY) -m benchmarks.run --only search_substrate

# mesh-path strategy routing (re-execs itself with 8 forced host devices)
bench-mesh:
	$(PY) -m benchmarks.run --only mesh_auto

# result cache + async local-path dispatch (results/bench/async_cache.csv)
bench-cache:
	$(PY) -m benchmarks.run --only async_cache

# batched beam expansion sweep (results/bench/beam_width.csv + BENCH_beam.json)
bench-beam:
	$(PY) -m benchmarks.run --only beam_width

# tiny-scale CI smoke of the same sweep (interpret-mode kernels on CPU):
# catches kernel/beam regressions fast without meaningful wall numbers
bench-beam-smoke:
	$(PY) -m benchmarks.run --only beam_width --n 1024

# quantized scoring (int8/bf16 + exact f32 rerank) vs the f32 baseline
# (results/bench/quantized.csv + BENCH_quant.json)
bench-quant:
	$(PY) -m benchmarks.run --only quantized

# tiny-scale CI smoke: asserts int8/bf16 scan id parity vs the f32 oracle
# and the beam recall envelope, all in Pallas interpret mode
bench-quant-smoke:
	$(PY) -m benchmarks.run --only quantized --n 1024

# streaming ingest: QPS/recall vs delta fraction {0,1%,5%,20%} + compaction
# pause p99 (results/bench/streaming.csv + BENCH_stream.json)
bench-stream:
	$(PY) -m benchmarks.run --only streaming

# tiny-scale CI smoke of the same trajectory (interpret-mode kernels)
bench-stream-smoke:
	$(PY) -m benchmarks.run --only streaming --n 1024

# sharded construction + persistence: build wall vs shard count (asserting
# bit-identity to the single-host build per point) and save/restore wall vs
# rebuild (results/bench/build.csv + BENCH_build.json); re-execs itself
# under 8 forced host devices
bench-build:
	$(PY) -m benchmarks.run --only build

# tiny-scale CI smoke of the same trajectory: sharded-parity + directory
# save/restore round-trip under the 8-device re-exec
bench-build-smoke:
	$(PY) -m benchmarks.run --only build --n 1024

# WAL durability cost: insert throughput per sync policy (nowal/none/
# batch/always) + recovery replay wall (results/bench/wal.csv +
# BENCH_wal.json)
bench-wal:
	$(PY) -m benchmarks.run --only wal

# smoke-sized perf trajectory: writes BENCH_substrate.json, BENCH_beam.json
# and BENCH_quant.json at the repo root so the numbers are tracked per PR
bench-all:
	$(PY) -m benchmarks.run --only search_substrate,beam_width,quantized \
	    --n 2048

bench-full:
	$(PY) -m benchmarks.run --full

quickstart:
	$(PY) examples/quickstart.py

# short serve with metrics; asserts the JSON + Prometheus exports parse and
# carry the core metric families (CI runs this)
obs-smoke:
	$(PY) tools/obs_smoke.py

# durability smoke: sampled crash-point sweep, checkpoint barrier + GC,
# torn-tail truncation and read-only degradation, bit-compared against a
# never-crashed oracle (CI runs this)
wal-smoke:
	$(PY) tools/wal_smoke.py

# jax.profiler device trace around a small beam run -> results/profiles/
profile:
	$(PY) tools/profile_capture.py
