"""The port's ``parallel/distributed`` on the CPU: two processes joined by
``torch.distributed`` (gloo, through the ``GPY_DLA_*`` environment) each
run their ``host_shard`` of a 4-spectrum survey through ``process_batch``
(the likelihood's plain composition, float64), write ``shard_filename``
catalogs, and the port's ``merge_catalogs`` gives the single-process
catalog bit for bit, as ``tests/test_distributed.py`` holds the JAX
package (reference: slurm/submit_gp_find_lls.sh:7-13,
CDDF_analysis/sbatch_reunion.py:13-63).  The batches' generators are keyed
on the global batch start (``run_bayes_select.batch_generator``), so a
shard draws what the single run draws for it.

Run as a script, this file is the subprocess:
``python tests/test_torch_distributed.py PORT PROCESS_ID NUM_PROCESSES OUTDIR``.
"""

import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = [[0, 1], [2, 3]]
Z_QSOS = [2.9, 3.15, 3.3, 2.8]


def run_batches(batch_ids, outfile):
    """The selection over the given global batches, written as a catalog."""
    import torch

    from gpy_dla_detection_tpu_torch.catalog_io import write_catalog
    from gpy_dla_detection_tpu_torch.data.samples import (
        generate_dla_samples,
        generate_subdla_samples,
    )
    from gpy_dla_detection_tpu_torch.data.spectrum import preprocess
    from gpy_dla_detection_tpu_torch.data.synthetic import (
        synthetic_learned_model,
        synthetic_observation,
        synthetic_prior_catalog,
    )
    from gpy_dla_detection_tpu_torch.models.learned import LearnedModel
    from gpy_dla_detection_tpu_torch.parallel.batch import process_batch
    from gpy_dla_detection_tpu_torch.params import Parameters
    from gpy_dla_detection_tpu_torch.run_bayes_select import batch_generator

    torch.set_num_threads(2)
    params = Parameters(num_dla_samples=40)
    learned = synthetic_learned_model(params)
    specs = []
    for i, z in enumerate(Z_QSOS):
        obs = synthetic_observation(params, learned, z, seed=i,
                                    dlas=[(z - 0.3, 21.2)] if i % 2 else None)
        specs.append(preprocess(*obs, z, params))
    module = LearnedModel.from_numpy(learned, "cpu", torch.float64)
    results, names, zs = [], [], []
    for b in batch_ids:
        idx = BATCHES[b]
        results.extend(process_batch(
            module, [specs[i] for i in idx], generate_dla_samples(params),
            generate_subdla_samples(params), synthetic_prior_catalog(params), params,
            batch_generator(0, idx[0], "cpu"), max_dlas=2, use_kernels=False))
        names.extend(f"spec-{i:04d}" for i in idx)
        zs.extend(Z_QSOS[i] for i in idx)
    write_catalog(outfile, results, params, 2, zs, names)


def _main(port, pid, nprocs, outdir):
    sys.path.insert(0, REPO)
    if int(nprocs) <= 1:
        run_batches([0, 1], os.path.join(outdir, "single.h5"))
        print("single-process reference written")
        return
    import torch.distributed as dist

    from gpy_dla_detection_tpu_torch.parallel import distributed

    os.environ.update(GPY_DLA_NUM_PROCESSES=nprocs, GPY_DLA_PROCESS_ID=pid,
                      GPY_DLA_COORDINATOR=f"localhost:{port}")
    distributed.initialize()
    assert (dist.get_rank(), dist.get_world_size()) == (int(pid), int(nprocs))
    mine = distributed.host_shard([0, 1])
    outfile = distributed.shard_filename(os.path.join(outdir, "processed.h5"))
    run_batches(mine, outfile)
    dist.barrier()
    dist.destroy_process_group()
    print(f"process {pid}: wrote {outfile} (batches {mine})")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_rank_defaults_outside_a_group(monkeypatch):
    """Without a group, the shard functions read rank 0 of 1 (as
    ``jax.process_index()`` gives), and one process is a no-op."""
    import torch.distributed as dist

    from gpy_dla_detection_tpu.parallel import distributed as JD
    from gpy_dla_detection_tpu_torch.parallel import distributed as TD

    monkeypatch.delenv("GPY_DLA_NUM_PROCESSES", raising=False)
    TD.initialize()
    assert not dist.is_initialized()
    items = list(range(10))
    assert TD.host_shard(items) == items
    for pid in range(3):
        assert TD.host_shard(items, pid, 3) == JD.host_shard(items, pid, 3)
        assert TD.shard_filename("out/processed.h5", pid) == \
            JD.shard_filename("out/processed.h5", pid)
    assert TD.shard_filename("processed.h5") == "processed.shard0000.h5"


def test_two_process_shard_merge_equals_single_process(tmp_path):
    import h5py

    from gpy_dla_detection_tpu_torch.analysis.catalog_tools import merge_catalogs

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, __file__, str(port), str(pid), "2", str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for pid in range(2)]
    try:
        outputs = [p.communicate(timeout=300)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out[-3000:]
    shards = [str(tmp_path / f"processed.shard{i:04d}.h5") for i in range(2)]
    merged = str(tmp_path / "merged.h5")
    assert merge_catalogs(shards, merged) == 4

    single = subprocess.run([sys.executable, __file__, "0", "0", "1", str(tmp_path)],
                            env=env, capture_output=True, timeout=300)
    assert single.returncode == 0, single.stdout[-3000:] + single.stderr[-3000:]
    with h5py.File(merged, "r") as fm, h5py.File(tmp_path / "single.h5", "r") as fs:
        assert set(fm.keys()) == set(fs.keys())
        for name in fs.keys():
            a, b = fm[name][()], fs[name][()]
            if a.dtype.kind in "OSU":
                assert list(a) == list(b), name
            else:
                assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), name
        assert list(fm["qso_list"][()].astype(str)) == [f"spec-{i:04d}" for i in range(4)]


if __name__ == "__main__":
    _main(*sys.argv[1:5])
