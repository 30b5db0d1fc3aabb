"""Traffic mixes (``<mix>.json``) and the generator that reads them."""
