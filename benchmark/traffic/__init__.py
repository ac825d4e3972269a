"""Traffic of the benchmark: banner pages drawn from a seed by a frozen copy
of the port's banner grammar, tokenized by a frozen copy of its hash
tokenizer, with the parameters of each mix in ``mixes/<name>.json``."""
