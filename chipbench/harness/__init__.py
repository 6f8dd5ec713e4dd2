"""The benchmark's general code: specification, drivers, inputs, judge, bounds, trace."""
