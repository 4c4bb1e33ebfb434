# Convenience targets (the reference drives runs through a makefile too,
# reference makefile:2-7 — mpiexec there, plain python + jax here).
PYTHON ?= python
CASE ?= taylor-green
ARGS ?=

.PHONY: run_case test bench bench-small bench-scaling smoke

# Runs the solver's main path on a GPU and checks it (chip_smoke.py);
# exits non-zero without a GPU. Run after any change to the engine, a
# solver default or a preconditioner: CPU pytest cannot see what the GPU
# compiler or its matmul precision does.
smoke:
	$(PYTHON) chip_smoke.py

run_case:
	$(PYTHON) -m pynama_tpu.run_case -case $(CASE) $(ARGS)

test:
	$(PYTHON) -m pytest tests/ -q

bench:
	$(PYTHON) bench.py

bench-small:
	PYNAMA_BENCH=small $(PYTHON) bench.py

bench-scaling:
	PYNAMA_BENCH=scaling $(PYTHON) bench.py
