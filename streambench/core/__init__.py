"""The harness's general code: specs, the feed (source and sink), one run,
the profiler's reduction, the output check and the import guard. Nothing
here names a configuration, a traffic mix or a metric: those are files
under streambench/, found by the names BENCHMARK.json gives."""
