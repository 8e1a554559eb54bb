"""draw_ms: mean host milliseconds a fit spends inside the program's
``sampler.draw`` spans (Algorithm 1's samples, Algorithm 2's extra
centers, the k-means++ picks: each a copy of the logits to the host, the
CPU softmax and multinomial or randint, and the ids back)."""
from bench.harness.spans import span_ms


def read(run):
    return span_ms("sampler.draw")
