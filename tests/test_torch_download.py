"""The port's downloader (krakenuniq_tpu_torch.build.download and
cli.download_main) against the JAX package's, offline: both run every case
of tests/test_download.py on its in-memory fetcher and must write the same
files (byte for byte), return the same counts and make the same requests,
except where the port departs from the JAX package to keep KrakenUniq's
defaults (F4): the assembly level defaults to Complete_Genome, and a
refseq/genbank pattern that names no domain fetches nothing."""

import gzip
import os

import pytest

import krakenuniq_tpu.build.download as jax_dl
import krakenuniq_tpu.cli.download_main as jax_cli
import krakenuniq_tpu_torch.build.download as torch_dl
import krakenuniq_tpu_torch.cli.download_main as torch_cli
from tests.test_download import (
    ASSEMBLY_SUMMARY,
    GENOME_FA,
    NT_FASTA,
    NT_MAP_GB,
    NT_MAP_WGS,
    NT_NAMES,
    NT_NODES,
    make_fetcher,
    make_taxdump,
)

ESEARCH = (
    b"<eSearchResult><Count>3</Count><RetMax>0</RetMax>"
    b"<QueryKey>1</QueryKey><WebEnv>WE123</WebEnv></eSearchResult>"
)
ESEARCH_1 = ESEARCH.replace(b"<Count>3</Count>", b"<Count>1</Count>")


def assemblies():
    return {
        "assembly_summary.txt": ASSEMBLY_SUMMARY.encode(),
        "GCF_001_ASM1_genomic.fna.gz": gzip.compress(GENOME_FA),
        "GCF_002_ASM2_genomic.fna.gz": gzip.compress(b">h9606\n" + b"AAAA" * 10 + b"\n"),
    }


def nt_responses():
    return {
        "taxdump.tar.gz": make_taxdump(),
        "nt.gz": gzip.compress(NT_FASTA),
        "nucl_gb.accession2taxid.gz": NT_MAP_GB,
        "nucl_wgs.accession2taxid.gz": NT_MAP_WGS,
    }


def nt_taxonomy(root):
    tax = os.path.join(root, "taxonomy")
    os.makedirs(tax, exist_ok=True)
    with open(os.path.join(tax, "nodes.dmp"), "wb") as f:
        f.write(NT_NODES)
    with open(os.path.join(tax, "names.dmp"), "wb") as f:
        f.write(NT_NAMES)


def tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


# each case: (responses, Downloader kwargs, setup(root) or None, the calls
# made on the Downloader as (method, args, kwargs))
CASES = {
    "taxonomy": ({"taxdump.tar.gz": make_taxdump()}, {}, None,
                 [("download", ("taxonomy",), {}), ("download", ("taxonomy",), {})]),
    "refseq_complete": (assemblies(), {"min_seq_len": 10}, None,
                        [("download_assemblies", ("refseq/bacteria/Complete_Genome",), {})]),
    "column_filters": (
        {"assembly_summary.txt": ASSEMBLY_SUMMARY.encode(),
         "GCF_002_ASM2_genomic.fna.gz": gzip.compress(b">chr1\n" + b"ACGT" * 10 + b"\n")},
        {}, None, [("download_assemblies", ("refseq/vertebrate_mammalian/Any/species_taxid=9606",), {})]),
    "contaminants": ({"UniVec": b">uv1 adapter\nACGTACGTACGT\n", "emvec": gzip.compress(b">ev1\nTTTTGGGG\n")},
                     {}, None, [("download", ("contaminants",), {})]),
    "emvec_embl": ({"UniVec": b">uv1\nACGTACGT\n",
                    "emvec": gzip.compress(b"ID   EV9; SV 1\n     acgtacgt ttgg 12\n//\n")},
                   {}, None, [("download", ("contaminants",), {})]),
    "eutils_search": ({"esearch.fcgi": ESEARCH, "efetch.fcgi": b">v1\nACGT\n>v2\nGGGG\n"}, {}, None,
                      [("download_search", ("viral-neighbors", "viruses[Organism]"), {}),
                       ("download", ("viral-neighbors",), {})]),
    "nt_taxa": (nt_responses(), {"taxa": "bacteria,viral"}, nt_taxonomy,
                [("download_nt", (), {}), ("download_nt", (), {})]),
    "nt_exclude_env": (nt_responses(), {"taxa": "bacteria", "exclude_environmental_taxa": True}, nt_taxonomy,
                       [("download_nt", (), {})]),
    "nt_taxid": (nt_responses(), {"taxa": "taxID562"}, nt_taxonomy, [("download_nt", (), {})]),
    "microbial_nt": (nt_responses(), {"taxa": None}, nt_taxonomy, [("download", ("microbial-nt",), {})]),
    "comma_fanout": (
        {"/genomes/refseq/bacteria/assembly_summary.txt": ASSEMBLY_SUMMARY.encode(),
         "/genomes/refseq/viral/assembly_summary.txt": ASSEMBLY_SUMMARY.replace("bacteria", "viral").encode(),
         **{k: v for k, v in assemblies().items() if k != "assembly_summary.txt"}},
        {}, None, [("download_assemblies", ("refseq/bacteria,viral/Complete_Genome,Scaffold",), {})]),
    "threads": (assemblies(), {"threads": 4}, None, [("download_assemblies", ("refseq/bacteria/Any",), {})]),
    "eutils_targets": ({"esearch.fcgi": ESEARCH_1, "efetch.fcgi": b">NC_5.1 assembly seq\n" + b"ACGT" * 10 + b"\n"},
                       {}, None,
                       [("download_eutils_accessions", ("assembly", ["GCF_0001", "GCF_0002"]), {}),
                        ("download_search", ("genome", "txid2[organism]"), {"db": "genome"}),
                        ("download_accessions", (["NC_5", "NC_6"],), {})]),
    "domain_level_category": (assemblies(), {}, None, [
        ("download_assemblies", ("refseq/bacteria/Any",), {"category": "reference genome"}),
        ("download_assemblies", ("refseq",), {"default_domains": "bacteria", "default_level": "Complete_Genome",
                                              "category": "representative genome"}),
        ("download_assemblies", ("genbank/bacteria/Any",), {"fna_types": "genomic,rna"}),
    ]),
    "overwrite": (assemblies(), {"overwrite": True}, None,
                  [("download_assemblies", ("refseq/bacteria/Any",), {}),
                   ("download_assemblies", ("refseq/bacteria/Any",), {})]),
}


def run_case(mod, name, root):
    responses, kw, setup, calls = CASES[name]
    os.makedirs(root)
    if setup is not None:
        setup(root)
    fetch = make_fetcher(responses)
    dl = mod.Downloader(root, fetch=fetch, verbose=False, **kw)
    results = [getattr(dl, method)(*args, **kwargs) for method, args, kwargs in calls]
    return results, sorted(fetch.calls), tree(root)


@pytest.mark.parametrize("name", sorted(CASES))
def test_downloader_matches_jax(name, tmp_path):
    want = run_case(jax_dl, name, str(tmp_path / "jax"))
    got = run_case(torch_dl, name, str(tmp_path / "torch"))
    assert got == want
    assert got[2]  # every case writes something


@pytest.mark.parametrize("blob,taxid,min_len", [
    (b">kraken:taxid|777|seqA desc\nACGT\n", 1, 0),
    (b">s1 x\nAC\nGT\n>s2\nA\n>kraken:taxid|9|s3\nACGTACGT\n", 5, 3),
    (b"junk\n>s1\n\n>s2\nAAAA\n", 0, 0),
])
def test_filter_fasta_matches_jax(blob, taxid, min_len):
    assert torch_dl.filter_fasta(blob, taxid, min_len) == jax_dl.filter_fasta(blob, taxid, min_len)


@pytest.mark.parametrize("argv", [
    ["bogus-pattern"], ["refseq/not_a_domain"], ["nucleotide"], ["genbank/bacteria/Any/nocolumn"],
])
def test_cli_pattern_errors_match_jax(argv, tmp_path, monkeypatch):
    def offline(url):
        raise OSError(f"offline: {url}")

    monkeypatch.setattr(jax_dl, "_default_fetch", offline)
    monkeypatch.setattr(torch_dl, "_default_fetch", offline)
    rc_j = jax_cli.main(argv + ["-o", str(tmp_path / "jax")])
    rc_t = torch_cli.main(argv + ["-o", str(tmp_path / "torch")])
    assert rc_t == rc_j != 0


def test_cli_runs_patterns_like_jax(tmp_path, monkeypatch):
    """download_main over the offline fetcher with patterns that name their
    domain and level: the same files as the JAX CLI."""
    responses = {**assemblies(), "taxdump.tar.gz": make_taxdump(), "UniVec": b">uv1\nACGTACGTAC\n",
                 "emvec": gzip.compress(b">ev1\nTTTTGGGG\n")}
    trees = []
    for mod, cli in ((jax_dl, jax_cli), (torch_dl, torch_cli)):
        monkeypatch.setattr(mod, "_default_fetch", make_fetcher(responses))
        root = str(tmp_path / mod.__name__.split(".")[0])
        assert cli.main(["--db", root, "taxonomy", "contaminants", "refseq/bacteria/Any",
                         "--min-seq-len", "10", "--threads", "2"]) == 0
        trees.append(tree(root))
    assert trees[0] == trees[1] and len(trees[1]) == 10


def test_cli_flags_reach_the_downloader(tmp_path, monkeypatch, capsys):
    """-d/-a/-c, --force, --taxa, --threads and --exclude-environmental-taxa
    reach the port's Downloader as they reach the JAX package's, the
    reference's dead flags are accepted and --filter-unplaced warns."""
    seen = {}

    def fake(mod):
        class FakeDL:
            def __init__(self, db_dir, **kw):
                seen[mod].update(kw)

            def download(self, pattern):
                seen[mod]["pattern"] = pattern

            def download_assemblies(self, pattern, **kw):
                seen[mod]["pattern"] = pattern
                seen[mod].update(kw)
                return 0
        return FakeDL

    for argv in (
        ["refseq", "-d", "archaea", "-a", "Chromosome", "-c", "reference genome", "--force",
         "-t", "2157", "--nt-fna", "/x/nt.fna", "-l", "--ncbidb", "assembly"],
        ["nt", "--taxa", "viral", "--threads", "3", "--exclude-environmental-taxa", "--filter-unplaced"],
    ):
        for mod, cli in ((jax_dl, jax_cli), (torch_dl, torch_cli)):
            seen[mod] = {}
            monkeypatch.setattr(mod, "Downloader", fake(mod))
            assert cli.main(argv + ["-o", str(tmp_path)]) == 0
        assert seen[torch_dl] == seen[jax_dl]
    assert "--filter-unplaced" in capsys.readouterr().err


# ---- F4: the port keeps KrakenUniq's defaults where the JAX package does not


def test_f4_assembly_level_defaults_to_complete_genome(tmp_path, monkeypatch):
    """KrakenUniq's --assembly-level defaults to Complete_Genome
    (krakenuniq-download:51): `refseq/bacteria` with no level fetches the
    Complete Genome assembly and not the Scaffold one. The JAX package
    defaults to Any and fetches both."""
    trees = {}
    for mod, cli in ((jax_dl, jax_cli), (torch_dl, torch_cli)):
        monkeypatch.setattr(mod, "_default_fetch", make_fetcher(assemblies()))
        root = str(tmp_path / mod.__name__.split(".")[0])
        assert cli.main(["--db", root, "refseq/bacteria"]) == 0
        trees[mod] = sorted(tree(root))
    assert trees[torch_dl] == ["library/bacteria/GCF_001_ASM1_genomic.fna", "library/bacteria/GCF_001_ASM1_genomic.map"]
    assert "library/bacteria/GCF_002_ASM2_genomic.fna" in trees[jax_dl]
    # the Downloader takes the same default, and `-a Any` restores every level
    fetch = make_fetcher(assemblies())
    assert torch_dl.Downloader(str(tmp_path / "api"), fetch=fetch, verbose=False).download(
        "refseq/bacteria") is None
    assert sorted(tree(str(tmp_path / "api"))) == trees[torch_dl]
    monkeypatch.setattr(torch_dl, "_default_fetch", make_fetcher(assemblies()))
    assert torch_cli.main(["--db", str(tmp_path / "any"), "refseq/bacteria", "-a", "Any"]) == 0
    assert sorted(tree(str(tmp_path / "any"))) == sorted(trees[jax_dl])


@pytest.mark.parametrize("pattern", ["refseq", "genbank", "refseq/"])
def test_f4_pattern_without_domain_fetches_nothing(pattern, tmp_path, monkeypatch, capsys):
    """KrakenUniq downloads nothing for a refseq/genbank pattern that names
    no domain when no --domain is given, and the port says so on stderr.
    The JAX package falls back to bacteria."""
    fetch = make_fetcher(assemblies())
    monkeypatch.setattr(torch_dl, "_default_fetch", fetch)
    assert torch_cli.main(["--db", str(tmp_path / "torch"), pattern]) == 0
    assert fetch.calls == [] and not os.path.exists(tmp_path / "torch" / "library")
    assert "no domain given" in capsys.readouterr().err
    dl = torch_dl.Downloader(str(tmp_path / "api"), fetch=fetch, verbose=False)
    assert dl.download_assemblies(pattern) == 0 and fetch.calls == []
    # with --domain the pattern fetches that domain, as in the JAX package
    assert dl.download_assemblies(pattern, default_domains="bacteria", default_level="Any") == 2
    jax_fetch = make_fetcher(assemblies())
    assert jax_dl.Downloader(str(tmp_path / "jax"), fetch=jax_fetch, verbose=False).download_assemblies(
        pattern) == 2
