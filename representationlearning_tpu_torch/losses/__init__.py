"""Losses of the port: the SCD / WSSS losses, the dense energy loss, the RML MI losses,
RSSFormer's CGFL and discriminative losses, and DRFL's Dice / BCE / GAN losses."""
