"""The benchmark of the PyTorch and CUDA port (`ta3n_tpu_torch`).

Run one cell of ``BENCHMARK.json`` from the root of a checkout:

    python3 bench_port/run.py --workload ucf_hmdb_full.sweep --seed 7 \
        --seconds 30 --trace 0

Everything that belongs to one configuration, one traffic mix, one cell
or one per-layer metric lives in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``cells/<workload>.json`` (the cell's member count and the limits of its
correctness check) and ``metrics/<metric>.py``.  A traffic file names
the driver that runs it (``drivers/<driver>.py``) and a configuration
file its plain reference (``reference/<reference>.py``).

Nothing here imports JAX or the JAX package ``ta3n_tpu``; the reference
imports nothing of the port.
"""
