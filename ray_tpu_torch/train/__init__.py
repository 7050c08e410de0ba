"""The data-parallel Train gang's step: bucketed DDP and ZeRO
(``train.ddp``)."""
