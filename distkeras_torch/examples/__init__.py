"""The reference's six example scripts (``examples/``) on the port.

Run each as ``python -m distkeras_torch.examples.<name>``:

- ``mnist_workflow``: MinMax -> Reshape -> OneHot, each named trainer,
  then ModelPredictor -> LabelIndexTransformer -> AccuracyEvaluator;
- ``cifar10_training``: the CIFAR CNN in bf16, samples/sec a trainer;
- ``streaming_inference``: RecordProducer -> socket_source ->
  StreamingPredictor, held against a batch predict;
- ``bigdata_pipeline``: shards in, a streamed DataParallelTrainer,
  prediction shards out, evaluation from them;
- ``lm_training``: the TransformerLM through LMTrainer over dp / sp / tp /
  pp / ep, text mode, sampling, the cosine schedule;
- ``lm_serving``: an LMServer (or a Router over replicas) streaming over
  TCP, every stream checked against ``generate()``.

Each takes the reference script's flags plus ``--device`` (default
``cuda``; without a card it raises unless given ``--device cpu``), prints
the reference's lines, and returns a dict of what it printed from
``main(argv)``. Each is split into stages (data, model, train or serve,
report) so a caller can hand a run its initial weights (``run(args,
params=...)``, a flax-layout tree). A run over several mesh positions
runs one process a position: launch it with
:class:`~distkeras_torch.job_deployment.Job` (``hosts=["local"] * n``).
"""


def launch_hint(module, n):
    """How to start ``module`` as ``n`` processes, for an error message."""
    return (f"launch one process a mesh position: Job(script='-m', "
            f"script_args=['distkeras_torch.examples.{module}', ...], "
            f"hosts=['local'] * {n}).run() "
            f"(distkeras_torch.job_deployment)")


def join_world(device):
    """``(world size, rank)``: the ``torch.distributed`` world this
    process is in, joining the one a :class:`Job` launch describes
    (``DK_TPU_*``, :func:`distkeras_torch.runtime.initialize`) if none is
    up yet. CPU ranks and ranks that share a card (more processes than
    this host has cards) talk over gloo, one card a rank over NCCL."""
    import datetime

    import torch
    import torch.distributed as dist

    from distkeras_torch import runtime

    if not dist.is_initialized():
        cpu = device.type == "cpu"
        ctx = runtime.initialize(init_distributed=False,
                                 device="cpu" if cpu else None)
        if ctx is not None:
            shared = not cpu and ctx.num_processes > torch.cuda.device_count()
            dist.init_process_group(
                "gloo" if cpu or shared else "nccl",
                init_method=f"tcp://{ctx.coordinator}",
                world_size=ctx.num_processes, rank=ctx.process_id,
                timeout=datetime.timedelta(seconds=600))
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0
