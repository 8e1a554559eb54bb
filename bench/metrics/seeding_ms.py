"""seeding_ms: mean milliseconds a fit spends in the program's
``kmeans_pp.seed`` span, the second level's weighted k-means++ seeding
(k draws over the gathered records and a distance update after each)."""
from bench.harness.spans import span_ms


def read(run):
    return span_ms("kmeans_pp.seed")
