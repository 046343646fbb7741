"""Training: AdamW and the train step and loop, on one device."""
