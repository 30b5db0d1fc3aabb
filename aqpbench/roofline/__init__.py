"""Published peaks of the card and the work of each kernel call."""
