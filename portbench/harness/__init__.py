"""The benchmark's own machinery: cell lookup, the card, timing, tracing,
weights, the result line.  Nothing here knows a configuration or a traffic
mix by name: those are found under ``portbench/`` by the names that
``BENCHMARK.json`` gives."""
