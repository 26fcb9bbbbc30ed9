"""The paper's packing arithmetic (``packing``, ``correction``,
``addpack``), quantizers, packed serving weights and the linear-layer
funnel."""
