"""The benchmark's machinery: inputs, the loop, the reference, the trace
reduction. Nothing here is part of the program under test."""
