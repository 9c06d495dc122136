"""Frame sources: each module makes a traffic mix's ring of batches
(``make_ring(config, traffic, seed, device)``); a mix names its source
under ``frames``."""
