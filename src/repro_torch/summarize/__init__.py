"""Pluggable summarizer subsystem, ported from ``repro.summarize``.

One protocol (weighted points in, mass-conserving ``WeightedSummary``
out), one ``SummarizerPolicy(name, params)`` threaded through
``simulate_coordinator`` (``summarizer=``), and a registry where each
algorithm lands as one entry: ``paper`` (Algorithm 1/2, the auto default),
``uniform`` (reservoir baseline), ``ball_cover`` (heavy-noise aggregation)
and ``coreset`` (sensitivity sampling, any metric).  See ``base.py`` for
the contract.
"""
from repro_torch.summarize.base import (  # noqa: F401
    SummarizerPolicy, SummarizerSpec, get_default_summarizer,
    get_summarizer, record_bound, reduce_summaries, register_summarizer,
    registered_summarizers, resolve_summarizer, select_summarizer,
    set_default_summarizer, site_summary, summarize, summarizer_policy,
    using_summarizer,
)
