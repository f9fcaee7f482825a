"""The port's distributed layer: mesh vocabulary and rank layouts
(``sharding``) and the collectives the ring and the pods talk through
(``collectives``), on ``torch.distributed``."""
