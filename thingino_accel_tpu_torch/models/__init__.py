"""Models: YOLO pre/post-processing (``yolo``), the zoo's YOLOv5 and
NanoDet (``zoo``), the AEC audio model (``aec``) and its front end
(``audio``), the JZDL person detector (``persondet``), and the fixtures
that build test models and files (``*_fixtures``, ``ops_graphs``)."""
