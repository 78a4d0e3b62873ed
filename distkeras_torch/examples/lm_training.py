"""Long-context LM training — the flagship multi-axis workload, on the
port (``examples/lm_training.py``).

A TransformerLM trained through the same Trainer API as every dist-keras
algorithm, sharded over whichever mesh axes the flags name. The port runs
one process a mesh position, so a product of axes above 1 runs in a world
of that many processes (``--dp 0``, the default, takes the world over the
other axes), launched with :class:`~distkeras_torch.job_deployment.Job`::

    # one card (or the CPU with --device cpu):
    python -m distkeras_torch.examples.lm_training

    # 8 processes, batch x sequence (ring attention), from Python:
    Job(script="-m", script_args=["distkeras_torch.examples.lm_training",
        "--dp", "4", "--sp", "2"], hosts=["local"] * 8).run()

    # batch x sequence x tensor: --dp 2 --sp 2 --tp 2
    # pipeline x batch x tensor: --pp 2 --dp 2 --tp 2 --microbatches 4

Ranks that share a card (more processes than this host has cards) talk
over gloo, one card each over NCCL, CPU ranks over gloo.

Zero-egress: trains on a synthetic token corpus with learnable structure
(a noisy repeating pattern: a loss well below the uniform floor proves
learning), or on real text with ``--text DIR``. ``--metrics out.jsonl``
writes per-step JSONL.
"""

import argparse
import contextlib

import numpy as np

from distkeras_torch.examples import join_world, launch_hint


def synthetic_corpus(n, T, vocab, seed=0):
    """Noisy periodic token streams (the reference's generator and seed:
    the same tokens): next-token is predictable, so the loss floor is far
    below ln(vocab)."""
    rng = np.random.default_rng(seed)
    period = 8
    base = rng.integers(0, vocab, size=(n, period))
    reps = -(-T // period)
    tokens = np.tile(base, (1, reps))[:, :T]
    noise = rng.random(size=tokens.shape) < 0.05
    tokens[noise] = rng.integers(0, vocab, size=int(noise.sum()))
    return tokens.astype(np.int32)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", type=int, default=0,
                    help="0 = the world over the other axes")
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1,
                    help="GPipe pipeline stages (layers must divide)")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="GPipe M per optimizer step (default 4*pp)")
    ap.add_argument("--moe", action="store_true",
                    help="use the Switch-MoE model (implied by --ep > 1)")
    ap.add_argument("--ep", type=int, default=1,
                    help="expert parallelism for the MoE model")
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--top-k", type=int, default=1,
                    help="1 = Switch, 2 = GShard routing")
    ap.add_argument("--n", type=int, default=512, help="corpus sequences")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3,
                    help="adam learning rate (flagship-size models want "
                         "~3e-4; the small default model is happy hotter)")
    ap.add_argument("--lr-schedule", choices=["constant", "cosine"],
                    default="constant",
                    help="'cosine' = linear warmup + cosine decay to "
                         "lr/100 over the whole run (use it for --text "
                         "runs: constant-lr adam plateaus on small varied "
                         "corpora)")
    ap.add_argument("--metrics", default=None, help="JSONL metrics path")
    ap.add_argument("--sample", type=int, default=0, metavar="N",
                    help="after training, greedy-decode N tokens from a "
                         "corpus prompt via the KV cache and print them")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for --sample (0 = greedy)")
    ap.add_argument("--beam", type=int, default=0, metavar="K",
                    help="use beam search of width K for --sample "
                         "instead of greedy/temperature decoding")
    ap.add_argument("--rope", action="store_true",
                    help="rotary position embeddings instead of the "
                         "sinusoidal table")
    ap.add_argument("--text", default=None, metavar="DIR",
                    help="train on REAL text: byte-tokenize every text "
                         "file under DIR (vocab 256, doc-separated), "
                         "hold out 5%% of rows, report held-out "
                         "perplexity, and print a decoded sample. "
                         "Overrides --n/--vocab.")
    ap.add_argument("--max-mb", type=float, default=8.0,
                    help="with --text: corpus size cap in MB")
    ap.add_argument("--kv-heads", type=int, default=None,
                    help="grouped-query attention: KV heads shared by "
                         "heads/kv_heads query heads each (default MHA)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def mesh_axes(args, world):
    """The reference's axes from the flags, over this world: a product
    that is not the world's size raises, naming the launch."""
    others = args.sp * args.tp * max(args.ep, 1) * args.pp
    if args.dp == 0 and world % others:
        raise ValueError(
            f"lm_training: --sp {args.sp} --tp {args.tp} --ep {args.ep} "
            f"--pp {args.pp} take a multiple of {others} processes; this "
            f"world has {world}: {launch_hint('lm_training', others)}")
    dp = args.dp or max(1, world // others)
    if dp * others != world:
        raise ValueError(
            f"lm_training: the axes take dp {dp} x {others} = "
            f"{dp * others} processes; this world has {world}: "
            f"{launch_hint('lm_training', dp * others)}")
    axes = {"pp": args.pp, "dp": dp, "sp": args.sp, "tp": args.tp,
            "ep": args.ep}
    axes = {k: v for k, v in axes.items() if v > 1} or {"dp": 1}
    if args.pp > 1:
        axes.setdefault("dp", 1)  # the pp path always names dp
    if args.moe or args.ep > 1:
        # the MoE mesh always carries dp and ep, size-1 or not
        axes.setdefault("dp", 1)
        axes.setdefault("ep", args.ep)
    return axes


def model_mesh(axes):
    """The mesh the trainer lays this world out as (a tp or ep model is
    built inside it), or None where the model needs none."""
    from distkeras_torch.parallel.mesh import make_mesh

    if axes.get("pp", 1) > 1:
        return make_mesh({"dp": axes.get("dp", 1), "pp": axes["pp"],
                          "tp": axes.get("tp", 1)})
    if axes.get("ep", 1) > 1:
        return make_mesh(dict(axes))
    if axes.get("tp", 1) > 1:
        return make_mesh({"dp": axes.get("dp", 1), "sp": axes.get("sp", 1),
                          "tp": axes["tp"]})
    return None


def load_data(args):
    """``(train dataset, its tokens, holdout or None)``; ``--text``
    sets ``args.vocab`` to the byte vocabulary."""
    from distkeras_torch.data import PartitionedDataset

    if args.text:
        from distkeras_torch.data.text import VOCAB, text_dataset

        args.vocab = VOCAB
        ds, holdout = text_dataset(args.text, args.seq_len,
                                   max_bytes=int(args.max_mb * 1e6))
        return ds, np.asarray(ds.column("tokens")), holdout
    tokens = synthetic_corpus(args.n, args.seq_len, args.vocab)
    return (PartitionedDataset.from_arrays({"tokens": tokens},
                                           num_partitions=1), tokens, None)


def build_model(args, axes, device, mesh=None, params=None):
    """The reference's model for the flags (inside ``mesh`` when it is
    sharded); ``params`` (a flax-layout tree) replaces its initial
    weights."""
    from distkeras_torch import bridge
    from distkeras_torch.models import get_model

    kw = dict(vocab_size=args.vocab, d_model=args.d_model,
              num_heads=args.heads, num_layers=args.layers,
              max_len=args.seq_len,
              pos_emb="rope" if args.rope else "sinusoidal",
              num_kv_heads=args.kv_heads, device=device, seed=0)
    with mesh if mesh is not None else contextlib.nullcontext():
        if args.moe or args.ep > 1:
            # MoeLM shares the TransformerLM attention stack, so GQA
            # composes with expert routing
            model = get_model("moe_lm", moe_experts=args.experts,
                              moe_top_k=args.top_k, ep_size=args.ep,
                              ep_axis="ep", **kw)
        else:
            model = get_model(
                "transformer_lm",
                attention="ring" if args.sp > 1 else "standard",
                seq_axis="sp", tp_size=args.tp, tp_axis="tp", **kw)
        if params is not None:
            bridge.params_from_jax(params, model)
    return model


def optimizer(args, rows):
    """``adam``, or optax's adam over the warm-up + cosine schedule the
    reference builds for ``--lr-schedule cosine``."""
    from distkeras_torch.utils.losses import (get_optimizer,
                                              warmup_cosine_decay_schedule)

    if args.lr_schedule != "cosine":
        return "adam"
    total = max(1, rows // args.batch_size) * args.epochs
    return get_optimizer("adam", warmup_cosine_decay_schedule(
        0.0, args.lr, min(200, max(1, total // 10)), total, args.lr * 0.01))


def train(args, model, ds, axes, rows):
    """``(trainer, trained Model)``."""
    from distkeras_torch.trainers import LMTrainer

    trainer = LMTrainer(
        model, axes=axes, batch_size=args.batch_size, num_epoch=args.epochs,
        worker_optimizer=optimizer(args, rows), learning_rate=args.lr,
        metrics_path=args.metrics,
        # passed through unconditionally: the trainer's own validation
        # tells the user the flag needs a pp axis
        microbatches=args.microbatches)
    return trainer, trainer.train(ds)


def decode(args, trained, prompt, n_new, mesh=None):
    """``[rows, Tp + n_new]`` tokens: beam search, or sampling at
    ``--temperature`` (greedy at 0). A pipeline rank first gathers every
    stage's blocks back (collective); a tp or ep model decodes inside
    its mesh."""
    if mesh is not None and "pp" in mesh.axis_names:
        from distkeras_torch.parallel.pipeline import sync_blocks

        with mesh:
            sync_blocks(trained.module, mesh)
    with mesh if mesh is not None else contextlib.nullcontext():
        if args.beam:
            return trained.beam_search(prompt, max_new_tokens=n_new,
                                       beam_size=args.beam)
        return trained.generate(prompt, max_new_tokens=n_new,
                                temperature=args.temperature)


def params_digest(tree):
    """sha256 of a flax-layout tree's leaves, by path: equal on ranks
    that hold bit-identical parameters."""
    import hashlib

    h = hashlib.sha256()

    def walk(node, path):
        for k in sorted(node):
            if isinstance(node[k], dict):
                walk(node[k], f"{path}/{k}")
            else:
                h.update(f"{path}/{k}".encode())
                h.update(np.ascontiguousarray(node[k]).tobytes())

    walk(tree, "")
    return h.hexdigest()


def run(args, params=None):
    from distkeras_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    world, rank = join_world(device)
    axes = mesh_axes(args, world)
    say = print if rank == 0 else (lambda *a, **k: None)
    ds, tokens, holdout = load_data(args)
    if args.text:
        say(f"text corpus: {args.text} -> {len(tokens)} train + "
            f"{holdout.num_rows if holdout else 0} holdout sequences "
            f"of {args.seq_len} bytes")
    mesh = model_mesh(axes)
    model = build_model(args, axes, device, mesh, params)
    trainer, trained = train(args, model, ds, axes, len(tokens))
    losses = [float(h["loss"]) for h in trainer.history]
    out = {"axes": axes, "world": world, "rank": rank, "losses": losses,
           "steps": len(losses), "seconds": trainer.get_training_time(),
           "params_sha256": params_digest(trainer.params)}
    out["tokens_per_sec"] = (len(losses) * args.batch_size * args.seq_len
                             / out["seconds"])
    first, last = losses[0], losses[-1]

    if args.text:
        from distkeras_torch.data.text import decode as bytes_text
        from distkeras_torch.evaluators import PerplexityEvaluator

        if holdout is not None:
            ppl = PerplexityEvaluator(
                trained, batch_size=min(args.batch_size, holdout.num_rows)
            ).evaluate(holdout)
            out["perplexity"] = ppl
            say(f"held-out perplexity: {ppl:.2f} (uniform-byte floor 256; "
                f"bits/byte {np.log2(ppl):.2f})")
        # a decoded continuation of real text is the credibility check a
        # token-id dump can't be
        n_new = args.sample or 160
        Tp = min(args.seq_len - n_new, args.seq_len // 2)
        if Tp >= 1:
            prompt = tokens[:1, :Tp]
            cont = decode(args, trained, prompt, n_new, mesh)
            out["continuation"] = bytes_text(cont[0, Tp:])
            say("--- prompt (tail) ---")
            say(bytes_text(prompt[0, -200:]))
            say("--- model continuation ---")
            say(out["continuation"])
        say(f"mesh={axes} loss {first:.3f} -> {last:.3f} "
            f"(uniform-byte floor {np.log(256):.3f}) | "
            f"{out['tokens_per_sec']:,.0f} tokens/sec")
        assert last < first, "loss did not decrease"
        return out

    if args.sample:
        # prompt with the first period of a held-in sequence: a trained
        # model continues the pattern; prompt + new must fit max_len
        Tp = min(16, args.seq_len - args.sample)
        if Tp < 1:
            say(f"--sample {args.sample} leaves no room for a prompt "
                f"inside max_len={args.seq_len}; skipping sampling")
        else:
            prompt = tokens[:2, :Tp]
            rows = decode(args, trained, prompt, args.sample, mesh)
            out["samples"] = [[int(t) for t in row[Tp:]] for row in rows]
            for r, row in enumerate(rows):
                cont = " ".join(str(int(t)) for t in row[Tp:])
                head = " ".join(str(int(t)) for t in prompt[r][:8])
                say(f"sample[{r}]: prompt={head} ... -> {cont}")

    say(f"mesh={axes} loss {first:.3f} -> {last:.3f} "
        f"(uniform floor {np.log(args.vocab):.3f}) | "
        f"{out['tokens_per_sec']:,.0f} tokens/sec over {len(losses)} steps")
    assert last < first, "loss did not decrease"
    return out


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
