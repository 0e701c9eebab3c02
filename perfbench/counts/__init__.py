"""Operations and bytes of the port's work, worked out from shapes.

`peaks.py` holds the card's published rates; `unet.py` counts the UNet
forward's FLOPs with torch's FlopCounterMode over the plain reference on
the meta device (2 a multiply-add in every matrix product and convolution,
nothing elsewhere), and the self-attention sites that K1 takes and the
temporal sites that K2 takes, each with its bound.
"""
