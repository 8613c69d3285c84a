"""Which frees inside a CUDA-graph capture invalidate it, on this card.

    python3 tools/capture_frees.py

Each victim (a captured graph never replayed, one replayed, two in a
shared memory pool, one with a registered generator, a recorded event,
a pending event, a tensor used on another stream, a side stream) is made
first, then its last reference is dropped inside a capture of its own on
a side stream; the line says whether that capture and its replay held.
A graph freed inside a capture invalidates it, which is why
``serving/runner.py`` pauses the cycle collector for each capture window.
Needs a CUDA card."""
import torch


def main():
    dev = torch.device("cuda")
    x = torch.arange(8, dtype=torch.float32, device=dev)

    def graph(replay, pool=None):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=pool):
            y = x * 2
        if replay:
            g.replay()
            torch.cuda.synchronize()
        return g, y

    def event(pending):
        s, e = torch.cuda.Stream(), torch.cuda.Event()
        with torch.cuda.stream(s):
            if pending:
                torch.cuda._sleep(100_000_000)
            else:
                _ = x * 3
        e.record(s)
        if not pending:
            torch.cuda.synchronize()
        return e

    def used_on_stream():
        s = torch.cuda.Stream()
        t = torch.empty(1 << 20, device=dev)
        with torch.cuda.stream(s):
            t.add_(1)
        t.record_stream(s)
        torch.cuda.synchronize()
        return t

    def generator_graph():
        gen = torch.Generator(device=dev).manual_seed(1)
        g = torch.cuda.CUDAGraph()
        g.register_generator_state(gen)
        with torch.cuda.graph(g):
            y = torch.rand(8, device=dev, generator=gen)
        g.replay()
        torch.cuda.synchronize()
        return g, gen, y

    pool = torch.cuda.graph_pool_handle()
    victims = [
        ("graph never replayed", lambda: graph(False)),
        ("graph replayed", lambda: graph(True)),
        ("graphs in a shared pool", lambda: (graph(True, pool),
                                             graph(True, pool))),
        ("graph with a registered generator", generator_graph),
        ("event recorded, complete", lambda: event(False)),
        ("event recorded, pending", lambda: event(True)),
        ("tensor used on another stream", used_on_stream),
        ("a side stream", torch.cuda.Stream)]
    for name, make in victims:
        held = [make()]
        g, s = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        try:
            with torch.cuda.graph(g, stream=s):
                held.clear()                 # the victim is freed here
                out = x + 1
            g.replay()
            torch.cuda.synchronize()
            ok = torch.equal(out, x + 1)
            print(f"{name}: capture held, replay {'right' if ok else 'WRONG'}",
                  flush=True)
        except RuntimeError as e:            # torch's CUDA errors
            print(f"{name}: {type(e).__name__}: {str(e).splitlines()[0]}",
                  flush=True)
            torch.cuda.synchronize()


if __name__ == "__main__":
    main()
