"""The distribution layer: sharding rules (``sharding``), the roofline
(``roofline``) and the traced step's collectives (``hlo_analysis``)."""
