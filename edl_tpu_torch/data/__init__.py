"""Input pipelines: the image records and batches of ``data/images.py``, and
the elastic data service (``data_server``, ``distribute_reader``,
``elastic_input`` and what they use), which feeds a job's trainers records
with dynamic file handout, a masked ragged epoch end and exactly-once
mid-epoch resume; its coordination-store journal (``journal``) and the
standalone elected leader that hosts a journaled service (``leader``)."""
