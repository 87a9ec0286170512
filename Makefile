# fugue-tpu development targets (reference parity: the reference drives its
# workflow through a Makefile with an 80% coverage bar, Makefile:13-14)

PY ?= python

.PHONY: test test-fast bench chip-smoke dryrun coverage examples lint ci clean

test:
	$(PY) -m pytest tests/ -q -n 2

lint:
	$(PY) scripts/lint.py

# the full local CI gate (mirrors .github/workflows/ci.yml)
ci: lint test dryrun examples coverage

test-fast:
	$(PY) -m pytest tests/test_smoke.py tests/test_public_api.py -q

# bench and chip-smoke run on the GPU (one process for the card)
bench:
	$(PY) bench.py

chip-smoke:
	$(PY) chip_smoke.py

dryrun:
	XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
		$(PY) -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

# stdlib sys.monitoring coverage (no pytest-cov needed); enforces the 80%
# bar the reference sets (Makefile:13-14) and writes benchmarks/COVERAGE.json
coverage:
	$(PY) scripts/coverage_tool.py run tests/ -q -n 2

examples:
	@for f in examples/*.py; do \
		echo "== $$f =="; \
		JAX_PLATFORMS=cpu $(PY) -c "import jax; jax.config.update('jax_platforms','cpu'); jax.config.update('jax_enable_x64', True); import runpy; runpy.run_path('$$f', run_name='__main__')" || exit 1; \
	done

clean:
	rm -rf .pytest_cache fugue_tpu/utils/_fugue_host.so
	find . -name __pycache__ -type d -exec rm -rf {} +
