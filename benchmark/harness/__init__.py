"""The benchmark's own machinery: finding cells, configurations, traffic
mixes and metric readers by name; writing a configuration's parameter
files; the measured window; spans; the profiler's reading; the roofline
counts; the result line."""
