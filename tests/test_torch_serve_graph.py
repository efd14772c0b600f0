"""The served forward as captured CUDA graphs (``utils/cuda_graphs``,
``serve.Predictor.heatmaps``).

On the CPU the capture plan's bookkeeping runs with a stand-in graph that
captures nothing and replays nothing, the CPU let in where only CUDA devices
are captured: when a key is captured, what the counters and spans read, how
spans cut the chain, which pool the graphs share, who owns the heatmaps.
The cases marked ``card`` hold the real graphs to the eager forward on a
CUDA card, bit for bit, for the benchmark cells' three models; they skip
elsewhere (on the card: ``python -m pytest --noconftest -m card
tests/test_torch_serve_graph.py``). This file imports nothing of JAX.
"""

import copy
import threading

import pytest
import torch

from litehandnet_tpu_torch.config import config_from_dict, get_config
from litehandnet_tpu_torch.kernels.dw_conv_bias_act import dw_conv_bias_act
from litehandnet_tpu_torch.models.litehrnet import CrossResolutionWeighting
from litehandnet_tpu_torch.serve import Predictor
from litehandnet_tpu_torch.utils import cuda_graphs, profiling
from litehandnet_tpu_torch.utils.cuda_graphs import ForwardGraphs, GraphChain

SIZE = 64
PIPELINE = dict(use_udp=False, kernel=(11, 11), unbiased_encoding=True)
# the benchmark cells' models (perfbench/configs/*.json "experiment")
CELL_EXPERIMENTS = ("litehandnet/freihand_256_dark_h4_ca_r4",
                    "resnet/freihand_256_r50", "litehrnet/freihand_256_d30")
DW_SHAPE = (2, 8, 16, 16, 3, 1, 2)   # a launch the counting model reports


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(name):
    model = (dict(name="litehrnet", depth=18, output_channel=21)
             if name == "litehrnet" else
             dict(name="litehandnet", num_stage=4, num_block=[2, 2, 2],
                  input_channel=32, ca_type="ca", reduction=4,
                  activation="leakyrelu", output_channel=21))
    return config_from_dict(dict(
        MODEL=model, PIPELINE=PIPELINE,
        DATASET=dict(num_joints=21, image_size=[SIZE, SIZE],
                     heatmap_size=[SIZE // 4, SIZE // 4])))


def _images(B=2, seed=0, size=SIZE, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (B, size, size, 3), generator=g,
                         dtype=torch.uint8).to(device)


class StandIn:
    """A graph that captures and replays nothing, and notes its calls."""

    def __init__(self):
        self.ended = False
        self.replays = 0

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.pool, self.mode = pool, capture_error_mode

    def capture_end(self):
        self.ended = True

    def replay(self):
        self.replays += 1


class Counting(torch.nn.Module):
    """The inner model, reporting two ``dw_conv_bias_act`` launches a
    forward as the wrapper counts a launch on the card."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        for _ in range(2):
            dw_conv_bias_act.launches += 1
            dw_conv_bias_act.shapes[DW_SHAPE] += 1
        return self.inner(x)


class Pools:
    """Stands in for ``torch.cuda.graph_pool_handle``: a new pool a call."""

    def __init__(self):
        self.made = []

    def __call__(self):
        self.made.append(object())
        return self.made[-1]


def _stand_in(predictor, monkeypatch):
    """``predictor`` with stand-in graphs and pools, the CPU captured."""
    monkeypatch.setattr(cuda_graphs, "DEVICE_TYPE", "cpu")
    predictor.graphs = ForwardGraphs(StandIn, Pools())
    return predictor


class EagerPredictor(Predictor):
    """Forgets its captures before every call: each forward runs eagerly."""

    def heatmaps(self, images):
        self.graphs.clear()
        return super().heatmaps(images)


def _eager_copy(predictor):
    """A predictor on ``predictor``'s model that never replays a graph."""
    eager = copy.copy(predictor)
    eager.__class__ = EagerPredictor
    eager.graphs = ForwardGraphs()
    return eager


def _counts():
    return (Predictor.batches, Predictor.graph_captures,
            Predictor.graph_replays)


@pytest.fixture(scope="module")
def lhn():
    return Predictor(_cfg("litehandnet"), device="cpu", dtype=torch.float32,
                     seed=1)


@pytest.fixture(scope="module")
def hrnet():
    return Predictor(_cfg("litehrnet"), device="cpu", dtype=torch.float32,
                     seed=2)


def test_a_key_is_captured_on_its_second_sighting_and_replayed_after(lhn, monkeypatch):
    p = _stand_in(lhn, monkeypatch)
    b0, c0, r0 = _counts()
    eager = p.heatmaps(_images(seed=1))
    assert _counts() == (b0 + 1, c0, r0) and not p.graphs.chains
    captured = p.heatmaps(_images(seed=2))
    assert _counts() == (b0 + 2, c0 + 1, r0 + 1)
    (chain,) = p.graphs.chains.values()
    assert chain.output is not None and chain.input is not None
    assert len(chain.graphs) == 1 and chain.graphs[0].ended
    assert chain.graphs[0].mode == "thread_local"
    assert chain.graphs[0].pool is p.graphs.pool is not None
    # the capture's own call ran the stand-in once: nothing was captured,
    # so its output is the capture run's, the eager forward's
    assert chain.graphs[0].replays == 1
    torch.testing.assert_close(captured, p._forward(chain.input),
                               rtol=0, atol=0)
    for i in range(3):
        p.heatmaps(_images(seed=3 + i))
    assert _counts() == (b0 + 5, c0 + 1, r0 + 4)
    assert chain.graphs[0].replays == 4
    # a last partial batch, seen once, runs eagerly
    assert p.heatmaps(_images(B=1)).shape == (1, SIZE // 4, SIZE // 4, 21)
    assert _counts() == (b0 + 6, c0 + 1, r0 + 4) and len(p.graphs.chains) == 1
    assert eager.shape == captured.shape == (2, SIZE // 4, SIZE // 4, 21)


def test_the_cpu_and_the_profiler_never_capture(lhn, monkeypatch):
    lhn.graphs = ForwardGraphs()       # CUDA graphs: nothing on the CPU
    b0, c0, r0 = _counts()
    for i in range(3):
        lhn.heatmaps(_images(seed=i))
    assert _counts() == (b0 + 3, c0, r0) and not lhn.graphs.chains
    assert lhn.graphs.pool is None
    p = _stand_in(lhn, monkeypatch)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(3):
            p.heatmaps(_images(seed=i))
    assert _counts() == (b0 + 6, c0, r0) and not p.graphs.chains
    p.heatmaps(_images(seed=4))        # the first call without it captures
    assert _counts() == (b0 + 7, c0 + 1, r0 + 1)


def test_another_model_object_is_captured_anew(lhn, monkeypatch):
    p = _stand_in(lhn, monkeypatch)
    model = p.model
    for i in range(3):
        p.heatmaps(_images(seed=i))
    (first,) = p.graphs.chains.values()
    c0 = Predictor.graph_captures
    p.model = Counting(model)
    p.heatmaps(_images(seed=5))        # eager: a new model's first sighting
    assert not p.graphs.chains and Predictor.graph_captures == c0
    p.heatmaps(_images(seed=6))
    (second,) = p.graphs.chains.values()
    assert second is not first and Predictor.graph_captures == c0 + 1
    p.model = model


def test_replays_add_what_the_capture_counted(lhn, monkeypatch):
    p = _stand_in(lhn, monkeypatch)
    model = p.model
    p.model = Counting(model)
    b0 = Predictor.batches
    launches, shapes = dw_conv_bias_act.launches, dw_conv_bias_act.shapes[
        DW_SHAPE]
    for i in range(6):
        p.heatmaps(_images(seed=i))
    batches = Predictor.batches - b0
    (chain,) = p.graphs.chains.values()
    assert [c[:2] for c in chain.counts] == [(dw_conv_bias_act, "launches"),
                                             (dw_conv_bias_act, "shapes")]
    assert chain.counts[1][2] == {DW_SHAPE: 2}
    # 1 eager call, 1 capture, 4 replays: two launches a batch each
    assert dw_conv_bias_act.launches - launches == 2 * batches == 12
    assert dw_conv_bias_act.shapes[DW_SHAPE] - shapes == 2 * batches
    p.model = model


def test_the_gate_counter_reads_whole_per_batch(hrnet, monkeypatch):
    p = _stand_in(hrnet, monkeypatch)
    b0, calls = Predictor.batches, CrossResolutionWeighting.calls
    for i in range(5):
        p.heatmaps(_images(seed=i))
    per_batch = (CrossResolutionWeighting.calls - calls) / (
        Predictor.batches - b0)
    assert per_batch == 20       # Lite-HRNet-18: (3 + 4 + 3) modules of 2
    (chain,) = p.graphs.chains.values()
    assert chain.counts == [(CrossResolutionWeighting, "calls", 20)]


def _span_marks(steps):
    return [s for s in steps if isinstance(s, tuple)]


def test_spans_cut_the_chain_and_replay_in_order(hrnet, tmp_path, monkeypatch):
    p = _stand_in(hrnet, monkeypatch)
    x = _images(seed=7)
    # the eager forward's spans, recorded under the profiler
    with profiling.trace(str(tmp_path / "eager")):
        p.heatmaps(x)
    eager = [(s.name, s.parent) for s in profiling.spans()]
    p.heatmaps(x)                      # captured
    p.heatmaps(x)                      # replayed
    (chain,) = p.graphs.chains.values()
    marks = _span_marks(chain.steps)
    inner = [n for n, parent in eager if parent == "lhn.serve.forward"]
    assert [m[1] for m in marks if m[0] == "enter"] == inner
    assert len(marks) == 2 * len(inner) == 2 * 30   # 20 weightings, 10 fuses
    # a graph first, last and between every two marks, all on one pool
    assert chain.steps[0::2] == chain.graphs and chain.steps[1::2] == marks
    assert len(chain.graphs) == len(marks) + 1
    assert all(g.ended for g in chain.graphs)
    assert {id(g.pool) for g in chain.graphs} == {id(p.graphs.pool)}
    with profiling.trace(str(tmp_path / "replayed")):
        p.heatmaps(x)
    replayed = [(s.name, s.parent) for s in profiling.spans()]
    assert replayed == eager
    # the capture's run, the replay before the trace and the traced one
    assert {g.replays for g in chain.graphs} == {3}


def test_the_heatmaps_belong_to_the_caller(lhn, monkeypatch):
    p = _stand_in(lhn, monkeypatch)
    for i in range(2):
        p.heatmaps(_images(seed=i))
    (chain,) = p.graphs.chains.values()
    got = p.heatmaps(_images(seed=3))
    kept = got.clone()
    assert got.data_ptr() != chain.output.data_ptr()
    chain.output.fill_(float("nan"))
    p.heatmaps(_images(seed=4))
    torch.testing.assert_close(got, kept, rtol=0, atol=0)


def test_the_static_input_is_written_in_place(lhn, monkeypatch):
    p = _stand_in(lhn, monkeypatch)
    for i in range(2):
        p.heatmaps(_images(seed=i))
    (chain,) = p.graphs.chains.values()
    where = chain.input.data_ptr()
    x = _images(seed=9)
    p.heatmaps(x)
    assert chain.input.data_ptr() == where
    want = (x.permute(0, 3, 1, 2).float() - p.mean) / p.std
    torch.testing.assert_close(chain.input, want, rtol=0, atol=0)


def test_every_chain_captures_into_one_pool(lhn, monkeypatch):
    p = _stand_in(lhn, monkeypatch)
    pools = p.graphs.new_pool
    for B in (1, 2, 3, 2, 3, 1):
        p.heatmaps(_images(B=B, seed=B))
    assert len(p.graphs.chains) == 3 and len(pools.made) == 1
    graphs = [g for c in p.graphs.chains.values() for g in c.graphs]
    assert {id(g.pool) for g in graphs} == {id(pools.made[0])}
    for B in (4, 4, 5, 5):             # more sizes: more chains, no pool
        p.heatmaps(_images(B=B, seed=B))
    assert len(p.graphs.chains) == 5 and len(pools.made) == 1
    # another model forgets the graphs and their pool
    model = p.model
    p.model = Counting(model)
    for _ in range(2):
        p.heatmaps(_images(B=2))
    assert len(p.graphs.chains) == 1 and len(pools.made) == 2
    (chain,) = p.graphs.chains.values()
    assert chain.graphs[0].pool is pools.made[1]
    p.model = model


def test_counters_name_every_wrapper_count():
    from litehandnet_tpu_torch.kernels import KERNELS

    pairs = cuda_graphs.counters()
    for wrapper in KERNELS.values():
        assert (wrapper, "launches") in pairs
    assert (dw_conv_bias_act, "shapes") in pairs
    assert (CrossResolutionWeighting, "calls") in pairs
    for owner, attr in pairs:
        assert isinstance(getattr(owner, attr), (int, dict))


def test_cut_at_spans_reports_entries_and_exits_on_its_thread():
    marks, elsewhere = [], []
    with profiling.cut_at_spans(marks.append):
        with profiling.span("a", "cpu"):
            with profiling.span("b"):
                pass
        t = threading.Thread(
            target=lambda: elsewhere.append(profiling.span("c")))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with pytest.raises(RuntimeError):
            with profiling.cut_at_spans(marks.append):
                pass
    assert marks == [("enter", "a", "cpu"), ("enter", "b", None), ("exit",),
                     ("exit",)]
    assert elsewhere == [profiling._OFF]
    assert profiling.span("d") is profiling._OFF


def test_a_failed_capture_ends_its_graph_and_raises():
    made = []

    def graph():
        made.append(StandIn())
        return made[-1]

    def broken(x):
        with profiling.span("lhn.test"):
            x = x + 1
        raise RuntimeError("not capturable")

    chain = GraphChain(graph, None, None)
    with pytest.raises(RuntimeError, match="not capturable"):
        chain.capture(broken, torch.zeros(2))
    assert all(g.ended for g in made) and chain.output is None
    assert profiling.span("e") is profiling._OFF


# -- on a CUDA card ---------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _trace_spans():
    from torch.profiler import ProfilerActivity, profile

    profiling.reset()
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@pytest.mark.card
@pytest.mark.parametrize("experiment", CELL_EXPERIMENTS)
def test_graphed_forward_equals_eager_on_the_card(experiment, card):
    dev = torch.device("cuda")
    p = Predictor(get_config(experiment), device=dev, dtype=torch.bfloat16,
                  seed=0)
    eager = _eager_copy(p)             # the same model, never captured
    batches = [_images(B=4, seed=i, size=256, device=dev) for i in range(3)]
    pairs = cuda_graphs.counters()

    def counted(predictor, x):
        before = cuda_graphs.snapshot(pairs)
        out = predictor.heatmaps(x)
        return out, cuda_graphs.moved(pairs, before,
                                      cuda_graphs.snapshot(pairs))

    want = [counted(eager, x) for x in batches]
    c0 = Predictor.graph_captures
    got = [counted(p, x) for x in batches + batches]   # eager, capture, ...
    torch.cuda.synchronize()
    assert Predictor.graph_captures == c0 + 1
    for i, (out, counts) in enumerate(got):
        assert torch.equal(out, want[i % 3][0]), (experiment, i)
        assert counts == want[i % 3][1], (experiment, i)
    # the spans of a replay are the eager forward's
    spans = []
    for predictor in (p, eager):
        with _trace_spans():
            predictor.heatmaps(batches[0])
            torch.cuda.synchronize()
        spans.append([(s.name, s.parent) for s in profiling.spans()])
    assert spans[0] == spans[1]
    assert ("lhn.serve.forward", None) in spans[0]
