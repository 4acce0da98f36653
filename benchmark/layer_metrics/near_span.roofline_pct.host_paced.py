"""near_span.roofline_pct.host_paced: near_span.roofline_pct (its reader)
in the cells whose steps the host launches at about the rate the card
runs them, which report steps_per_s.host_paced. A bound belongs to a
metric's name, and a per-layer metric's `moves` has to be reported in
every cell it lists, so these cells need an entry of their own."""

from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name("near_span.roofline_pct.py"),
                   "benchmark_metric_near_span_roofline_pct").read
