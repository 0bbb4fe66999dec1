"""Peaks of one NVIDIA H100 SXM (80 GB HBM3), from NVIDIA's data sheet,
dense rates at the card's full 700 W: the fastest rate for each class of
work the counts use.  A card set below 700 W runs slower under load, so the
harness prints the card's power limit beside every roofline share."""

U8_MACS_PER_S = 1979e12 / 2      # int8 tensor-core operations (1979 T/s), two per multiply-add
HBM_BYTES_PER_S = 3.35e12
