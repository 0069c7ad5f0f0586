"""Distribution: logical-axis sharding rules over ``DeviceMesh``es and
``DTensor``s (``sharding``), and int8 data-parallel gradient compression
(``compression``)."""
