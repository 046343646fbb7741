"""Language-model substrate, serving half: layers, attention, Mamba-2
and the decoder stack."""
