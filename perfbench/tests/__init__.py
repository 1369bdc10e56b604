"""CPU tests of the benchmark: its files found by name, its yardsticks and
references held against the port at small sizes, its isolation, and a
run driven end to end on the CPU with the card's look skipped."""
