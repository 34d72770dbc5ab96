"""An in-memory catalog of deployed process definitions.

It stands in for the engine's deployed-process state (the reference's
``ProcessState``) until the engine state is ported (ROADMAP A3). It offers
the two methods ``KernelRegistry``'s call-activity inlining consults,
``get_latest_by_id`` and ``executable``, over the executables it is given,
keyed by definition key and process id. Definitions are numbered in deploy
order from key 1; a later deployment of the same process id becomes its
latest version.
"""

from __future__ import annotations

from zeebe_tpu_torch.models.bpmn import parse_bpmn_xml, transform


class ProcessCatalog:
    def __init__(self) -> None:
        self._by_key: dict[int, object] = {}  # definition key → executable
        self._latest: dict[str, dict] = {}  # process id → metadata
        self.keys: list[int] = []  # definition keys in deploy order

    @classmethod
    def from_xml(cls, resources: list[str | bytes]) -> "ProcessCatalog":
        """Deploy every process of every resource, in order, through this
        package's parser and transform."""
        catalog = cls()
        for xml in resources:
            for model in parse_bpmn_xml(xml):
                catalog.add(transform(model))
        return catalog

    def add(self, exe) -> int:
        """Deploy one executable; returns its definition key."""
        key = len(self.keys) + 1
        prev = self._latest.get(exe.process_id)
        self._by_key[key] = exe
        self._latest[exe.process_id] = {
            "bpmnProcessId": exe.process_id,
            "version": prev["version"] + 1 if prev else 1,
            "processDefinitionKey": key,
        }
        self.keys.append(key)
        return key

    def get_latest_by_id(self, process_id: str, tenant=None) -> dict | None:
        return self._latest.get(process_id)

    def executable(self, key: int):
        return self._by_key.get(key)

    def register(self, registry) -> list:
        """Look every deployed definition up in ``registry``, in deploy
        order; returns each one's ``_DefInfo``, or None where the registry
        declined it."""
        return [registry.lookup(key, self._by_key[key], processes=self)
                for key in self.keys]
