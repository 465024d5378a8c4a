"""The rank program of the tensor-parallel CPU tests
(``tests/test_torch_tp_explain.py``), in a module of its own so that the
spawned ranks import only torch and the port.

Each rank joins a gloo process group through a ``FileStore``, runs every
entry of the job on the same inputs and saves what it got; a gate that
raises ``NotImplementedError`` or ``ValueError`` is recorded as
``(type name, message)``.
"""

import datetime

import torch
import torch.distributed as dist


def run_rank(rank, k, store_path, job_path, out_pattern):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, k), rank=rank, world_size=k,
        timeout=datetime.timedelta(seconds=60))
    try:
        from transformer_explainability_torch.models.vit import ViTConfig
        from transformer_explainability_torch.parallel import (
            make_sharded_explain_fn, make_tp_explain_fn)
        job = torch.load(job_path, weights_only=False)
        results = {}
        for name, run in job["runs"].items():
            build = (make_sharded_explain_fn if run.get("mesh")
                     else make_tp_explain_fn)
            try:
                fn = build(ViTConfig(**run.get("cfg", job["cfg"])),
                           device="cpu", **run.get("kw", {}))
            except (NotImplementedError, ValueError) as e:
                results[name] = (type(e).__name__, str(e))
                continue
            results[name] = fn(job["params"], job["images"], job["indices"])
        torch.save(results, out_pattern.format(rank))
    finally:
        dist.destroy_process_group()
