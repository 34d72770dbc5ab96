"""The benchmark workloads' BPMN definitions, for the port's smoke run and tests.

Copies of the builders in the repository's ``bench.py`` (one_task,
exclusive_chain, fork_join, ten_tasks, ten_tasks_io, subprocess_boundary and
the 8-definition mixed_definitions set), on this package's fluent builder.
Each returns a ``ProcessModel``; ``to_xml`` serializes a set of them as the
BPMN resource a deployment carries.
"""

from __future__ import annotations

from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml


def one_task(pid="one_task"):
    return (
        Bpmn.create_executable_process(pid)
        .start_event("start").service_task("task", job_type=f"work_{pid}")
        .end_event("end").done()
    )


def exclusive_chain(pid="excl_chain"):
    """start → 5 exclusive gateways → end (config #2: sequence-flow-only)."""
    b = Bpmn.create_executable_process(pid).start_event("s")
    for i in range(5):
        b = (
            b.exclusive_gateway(f"gw{i}")
            .condition_expression(f"x > {10 * i}")
            .exclusive_gateway(f"m{i}")
            .move_to_element(f"gw{i}")
            .default_flow()
            .connect_to(f"m{i}")
            .move_to_element(f"m{i}")
        )
    return b.end_event("e").done()


def fork_join(pid="fork_join"):
    """Parallel fan-out/fan-in (config #3), service tasks on both branches."""
    return (
        Bpmn.create_executable_process(pid)
        .start_event("s")
        .parallel_gateway("fork")
        .service_task("a", job_type=f"a_{pid}")
        .parallel_gateway("join")
        .end_event("e")
        .move_to_element("fork")
        .service_task("b", job_type=f"b_{pid}")
        .connect_to("join")
        .done()
    )


def ten_tasks(pid="ten_tasks"):
    """10 sequential service tasks (reference fixture:
    benchmarks/project/src/main/resources/bpmn/ten_tasks.bpmn)."""
    b = Bpmn.create_executable_process(pid).start_event("s")
    for i in range(10):
        b = b.service_task(f"t{i}", job_type=f"work_{pid}")
    return b.end_event("e").done()


def ten_tasks_io(pid="ten_tasks_io"):
    """ten_tasks with input+output mappings on every task — the io-mapped
    elements ride the kernel (VERDICT r2 item 5) instead of host-escaping."""
    b = Bpmn.create_executable_process(pid).start_event("s")
    for i in range(10):
        b = (
            b.service_task(f"t{i}", job_type=f"work_{pid}")
            .zeebe_input("= base", f"local{i}")
            .zeebe_output(f"= local{i}", f"result{i}")
        )
    return b.end_event("e").done()


def subprocess_boundary(pid="sub_bnd"):
    """Embedded sub-process + timer-boundary task (kernel scope + boundary
    wait-state paths under load)."""
    return (
        Bpmn.create_executable_process(pid)
        .start_event("s")
        .sub_process("sub")
        .start_event("is_")
        .service_task("inner", job_type=f"inner_{pid}")
        .boundary_timer("tb", attached_to="inner", duration="PT1H")
        .end_event("bnd_e")
        .move_to_element("inner")
        .end_event("ie")
        .sub_process_done()
        .end_event("e")
        .done()
    )


def mixed_definitions():
    """8 ragged definitions (config #5): varying task counts and routing."""
    out = [one_task("mx_one"), exclusive_chain("mx_excl"), fork_join("mx_fj")]
    for n in (2, 3, 4):
        b = Bpmn.create_executable_process(f"mx_chain{n}").start_event("s")
        for i in range(n):
            b = b.service_task(f"t{i}", job_type=f"work_mx_chain{n}")
        out.append(b.end_event("e").done())
    b = (
        Bpmn.create_executable_process("mx_route")
        .start_event("s")
        .exclusive_gateway("gw")
        .condition_expression("x > 10")
        .service_task("big", job_type="work_mx_route")
        .end_event("e1")
        .move_to_element("gw")
        .default_flow()
        .service_task("small", job_type="work_mx_route")
        .end_event("e2")
        .done()
    )
    out.append(b)
    b = (
        Bpmn.create_executable_process("mx_par3")
        .start_event("s")
        .parallel_gateway("f")
        .service_task("p0", job_type="work_mx_par3")
        .parallel_gateway("j")
        .end_event("e")
        .move_to_element("f")
        .service_task("p1", job_type="work_mx_par3")
        .connect_to("j")
        .move_to_element("f")
        .service_task("p2", job_type="work_mx_par3")
        .connect_to("j")
        .done()
    )
    out.append(b)
    return out


def to_xml(models) -> str:
    """BPMN XML resource holding ``models``."""
    return to_bpmn_xml(list(models))
